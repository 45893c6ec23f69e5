"""Batched witness evaluators for the 14 reference circuit templates.

Each model is a function over batched field arrays (shape (16, B) limb
layout from `circuits_tpu.field.fr`) plus (B,)-shaped flag arrays. Models
return their output signals together with an `ok` boolean mask — the
batched form of circom's hard constraint failures: a lane whose inputs
violate a circuit constraint gets ok=False instead of aborting the batch.
"""
