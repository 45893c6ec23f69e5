"""RollupTxStates — the tx-type decision table as a batched kernel.

Replicates /root/reference/src/rollup-tx-states.circom:39-314 (tx-type
table at :41-54, processor-fnc table at :177-183, nullifier table at
:250-258). All logic is elementwise boolean/mux over the tx-lane batch —
pure elementwise work that XLA fuses into neighbouring kernels.

Inputs are canonical field arrays (16, B) (idx / addr / token / amount
signals) — equality and is-zero tests happen in limb space.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..field import fr

ETH_ADDR_ANY = (1 << 160) - 1  # src/rollup-tx-states.circom:131
EXIT_IDX = 1                   # src/rollup-tx-states.circom:141


def rollup_tx_states(
    from_idx, to_idx, to_eth_addr, aux_from_idx, aux_to_idx,
    amount, new_exit, load_amount, new_account, on_chain,
    from_eth_addr, eth_addr1, token_id, token_id1, token_id2,
):
    """Returns (outputs: dict, ok: (B,) bool).

    ok covers the two hard constraints:
      (1-onChain)*isLoadAmount === 0   (:172)
      (1-onChain)*newAccount  === 0    (:175)
    """
    bshape = from_idx.shape[1:]
    on_chain = on_chain.astype(jnp.bool_)
    new_account = new_account.astype(jnp.bool_)
    new_exit = new_exit.astype(jnp.bool_)

    # final sender index: auxFromIdx on L1 account creation (:96-103)
    sel_aux_from = on_chain & new_account
    final_from_idx = fr.select(sel_aux_from, aux_from_idx, from_idx)

    # final receiver index: auxToIdx when L2 tx signs toIdx == 0 (:111-124)
    to_idx_zero = fr.is_zero(to_idx)
    select_aux_to_idx = (~on_chain) & to_idx_zero
    final_to_idx = fr.select(select_aux_to_idx, aux_to_idx, to_idx)

    is_to_eth_addr_any = fr.eq(
        to_eth_addr,
        jnp.broadcast_to(fr.const(ETH_ADDR_ANY, bshape), to_eth_addr.shape))

    # exit tx: signed toIdx resolves to EXIT_IDX (:137-147)
    is_exit = fr.eq(
        final_to_idx,
        jnp.broadcast_to(fr.const(EXIT_IDX, bshape), final_to_idx.shape))

    final_from_zero = fr.is_zero(final_from_idx)
    is_final_from_idx = ~final_from_zero

    is_load_amount = ~fr.is_zero(load_amount)
    is_amount = ~fr.is_zero(amount)

    # hard constraints (:172,:175)
    ok = ~((~on_chain) & is_load_amount)
    ok = ok & ~((~on_chain) & new_account)

    # processor 1 (:185-200)
    is_p1_insert = on_chain & new_account
    p1_fnc0 = is_p1_insert & is_final_from_idx
    p1_fnc1 = (~is_p1_insert) & is_final_from_idx
    # key1 = 0 if NOP else finalFromIdx (:192-200)
    key1 = fr.select(p1_fnc0 | p1_fnc1, final_from_idx, fr.zeros(bshape))

    # processor 2 (:202-217)
    is_p2_insert = is_exit & new_exit
    p2_fnc0 = is_p2_insert & is_final_from_idx
    p2_fnc1 = (~is_p2_insert) & is_final_from_idx
    # key2 mux: s = [isAmount, isExit] → {0: 0, 1: finalToIdx, 2: 0, 3: finalFromIdx}
    key2 = fr.select(
        is_exit,
        fr.select(is_amount, final_from_idx, fr.zeros(bshape)),
        fr.select(is_amount, final_to_idx, fr.zeros(bshape)))

    verify_sign_enabled = (~on_chain) & is_final_from_idx
    nop = final_from_zero

    # receiver checks for transferToEthAddr / transferToBjj (:234-241)
    tmp_check_to_eth = (~is_to_eth_addr_any) & select_aux_to_idx
    tmp_check_to_bjj = is_to_eth_addr_any & select_aux_to_idx
    check_to_eth_addr = tmp_check_to_eth & ~nop
    check_to_bjj = tmp_check_to_bjj & ~nop

    # nullifier decision table (:250-313)
    on_chain_not_create = (~new_account) & on_chain
    should_check_eth = on_chain_not_create & is_amount
    from_eth_match = fr.eq(from_eth_addr, eth_addr1)
    apply_null_eth = should_check_eth & ~from_eth_match

    token1_match = fr.eq(token_id, token_id1)
    apply_null_tok1 = on_chain_not_create & ~token1_match

    should_check_tok2 = on_chain & is_amount & ~is_p2_insert
    token2_match = fr.eq(token_id, token_id2)
    apply_null_tok2 = should_check_tok2 & ~token2_match

    nullify_load_amount = apply_null_tok1 & is_load_amount
    apply_tok1_to_amount = apply_null_tok1 & is_amount
    nullify_amount_0 = apply_null_eth | apply_null_tok2
    nullify_amount = nullify_amount_0 | apply_tok1_to_amount

    outputs = dict(
        is_p1_insert=is_p1_insert,
        is_p2_insert=is_p2_insert,
        key1=key1,
        key2=key2,
        p1_fnc0=p1_fnc0,
        p1_fnc1=p1_fnc1,
        p2_fnc0=p2_fnc0,
        p2_fnc1=p2_fnc1,
        is_exit=is_exit,
        verify_sign_enabled=verify_sign_enabled,
        nop=nop,
        check_to_eth_addr=check_to_eth_addr,
        check_to_bjj=check_to_bjj,
        nullify_load_amount=nullify_load_amount,
        nullify_amount=nullify_amount,
        # extra internal signals other phases reuse
        final_from_idx=final_from_idx,
        final_to_idx=final_to_idx,
        is_amount=is_amount,
    )
    return outputs, ok
