"""Witness engine: batch-builder inputs -> batched device arrays ->
jitted circuit evaluation (the accelerator replacement for the reference's native
witness calculator, tools/helpers/actions.js:98-146)."""

from .witness import pack_rollup_inputs, RollupEngine, WithdrawEngine

__all__ = ["pack_rollup_inputs", "RollupEngine", "WithdrawEngine"]
