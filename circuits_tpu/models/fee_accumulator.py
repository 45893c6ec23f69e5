"""FeeAccumulator — first-match scatter-add of a tx fee into fee slots.

Replicates /root/reference/src/fee-accumulator.circom:56-91. The circuit
is a sequential isSelected carry chain over maxFeeTx steps; the batched form
is a vectorized first-match mask (match & no-earlier-match computed with
an exclusive prefix-OR over the slot axis) — identical semantics, no scan.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..field import fr


def fee_accumulator(token_id, fee2_charge, fee_plan_token_id, acc_fee_in):
    """token_id, fee2_charge: (16, B). fee_plan_token_id, acc_fee_in:
    (F, 16, B) stacked over the maxFeeTx slot axis. Returns acc_fee_out
    (F, 16, B)."""
    nfee = fee_plan_token_id.shape[0]
    matches = jnp.stack(
        [fr.eq(token_id, fee_plan_token_id[i]) for i in range(nfee)])  # (F,B)
    # first match only: match & not any earlier match (:35,:43)
    earlier = jnp.cumsum(matches.astype(jnp.uint32), axis=0) - matches.astype(
        jnp.uint32)
    first_match = matches & (earlier == 0)
    out = []
    for i in range(nfee):
        out.append(fr.select(first_match[i],
                             fr.add(acc_fee_in[i], fee2_charge),
                             acc_fee_in[i]))
    return jnp.stack(out)
