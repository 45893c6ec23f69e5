"""Batched SMT processor / verifier (circomlib smtprocessor.circom semantics).

The single hottest gadget of the rollup: two SMTProcessor(nLevels+1)
instances per RollupTx + one per FeeTx (reference:
/root/reference/src/rollup-tx.circom:537-570, src/fee-tx.circom:97-111).

Data-dependent tree topology (NOP / UPDATE / INSERT / DELETE, variable
proof depth) is handled exactly the way the circuit does it algebraically:
a fixed nLevels iteration with per-lane state masks (no divergent
control flow; everything is a masked scan over levels, batched over the
tx lanes).

State machine (top-down), mirroring circomlib SMTProcessorSM:
  top   — above the action level, proof hashes with the given sibling
  old0  — INSERT into an empty slot (isOld0)
  bot   — INSERT push-down region: old/new keys still agree on this bit
  new1  — INSERT branch level: new leaf and pushed-down old leaf pair up
  upd   — UPDATE leaf level
  na    — below any action
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..field import fr
from .poseidon import poseidon


def smt_hash0(l, r):
    return poseidon([l, r])


def smt_hash1(k, v):
    one = jnp.broadcast_to(fr.const(1, k.shape[1:]), k.shape)
    return poseidon([k, v, one])


def _lev_ins(siblings):
    """siblings: (n, 16, B) canonical. Returns levIns (n, B) bool:
    levIns[i] = all siblings j >= i are zero AND (i == 0 or sibling[i-1] != 0)."""
    n = siblings.shape[0]
    isz = jnp.stack([fr.is_zero(siblings[i]) for i in range(n)])  # (n, B)
    suffix_all_zero = jnp.flip(jnp.cumprod(
        jnp.flip(isz.astype(jnp.uint32), axis=0), axis=0), axis=0).astype(bool)
    prev_nonzero = jnp.concatenate(
        [jnp.ones((1,) + isz.shape[1:], dtype=bool), ~isz[:-1]], axis=0)
    return suffix_all_zero & prev_nonzero


def processor_chains(siblings, old_key, old_value, is_old0,
                     new_key, new_value, fnc0, fnc1):
    """The root-independent 90% of SMTProcessor(n): state machine +
    bottom-up hash chains. Returns (computed_old, computed_new,
    enabled) — the caller checks computed_old against its
    old_root and muxes the output. Split out so independent processor
    instances (the two per RollupTx) can run as ONE wider batch: the chains read only the proof data, never the root."""
    n = siblings.shape[0]
    bshape = old_key.shape[1:]
    fnc0 = fnc0.astype(jnp.bool_)
    fnc1 = fnc1.astype(jnp.bool_)
    is0 = is_old0.astype(jnp.bool_)
    enabled = fnc0 | fnc1
    f_insert = fnc0 & ~fnc1
    f_update = ~fnc0 & fnc1
    f_delete = fnc0 & fnc1
    # DELETE is the mirror of INSERT: run the SM in insert mode with
    # (del_key/del_value as "new", remaining leaf as "old") and swap the
    # resulting roots — exactly circomlib's topSwitcher.
    f_ins_like = f_insert | f_delete

    lev_ins = _lev_ins(siblings)  # (n, B)
    old_bits = fr.bits_le(old_key, n)  # (n, B)
    new_bits = fr.bits_le(new_key, n)
    xors = (old_bits ^ new_bits).astype(jnp.bool_)

    # --- state machine, top-down (python loop over levels: states are
    # cheap (B,) boolean ops; hashing happens in the scan below) ---
    st_top = []
    st_old0 = []
    st_bot = []
    st_new1 = []
    st_upd = []
    prev_top = jnp.ones(bshape, dtype=bool)
    prev_bot = jnp.zeros(bshape, dtype=bool)
    for i in range(n):
        li = lev_ins[i]
        top = prev_top & ~li
        old0 = prev_top & li & is0 & f_ins_like
        bot = (prev_top & li & ~is0 & f_ins_like & ~xors[i]) | (prev_bot & ~xors[i])
        new1 = (prev_top & li & ~is0 & f_ins_like & xors[i]) | (prev_bot & xors[i])
        upd = prev_top & li & f_update
        st_top.append(top)
        st_old0.append(old0)
        st_bot.append(bot)
        st_new1.append(new1)
        st_upd.append(upd)
        prev_top, prev_bot = top, bot

    # both leaf hashes in one 2x-batched poseidon call
    nl_ = old_key.shape[0]
    bs_ = 1
    for d in bshape:
        bs_ *= d
    leaf_pair = smt_hash1(
        jnp.concatenate([old_key.reshape(nl_, bs_),
                         new_key.reshape(nl_, bs_)], axis=-1),
        jnp.concatenate([old_value.reshape(nl_, bs_),
                         new_value.reshape(nl_, bs_)], axis=-1))
    old1leaf = leaf_pair[:, :bs_].reshape(old_key.shape)
    new1leaf = leaf_pair[:, bs_:].reshape(new_key.shape)
    zero = fr.zeros(bshape)

    # the new1 state (INSERT branch level: new leaf and pushed-down old
    # leaf pair up) holds at MOST ONE level per lane, so its pair hash
    # hoists out of the level chain as ONE batched call — the in-chain
    # hash fold drops from 4 instances per level to 3 (-25% Poseidon
    # mass in the hottest kernel)
    new1_any = jnp.zeros(bshape, dtype=bool)
    bit_new1 = jnp.zeros(bshape, dtype=jnp.uint32)
    for i in range(n):
        bit_i = new_bits[i].astype(jnp.uint32)
        bit_new1 = jnp.where(st_new1[i], bit_i, bit_new1)
        new1_any = new1_any | st_new1[i]
    b1 = bit_new1.astype(bool)
    new1h = smt_hash0(fr.select(b1, old1leaf, new1leaf),
                      fr.select(b1, new1leaf, old1leaf))

    # --- bottom-up hashing chains (lax.scan over levels). The four hash0
    # instances of one level (old chain, new chain, new1 pair, bot pair)
    # run as ONE poseidon call on a wider batch — fewer nested scans to
    # compile, more lanes per launch. ---
    nlimb = old_key.shape[0]
    bsz = 1
    for d in bshape:
        bsz *= d

    def level_body(carry, xs):
        old_child, new_child = carry
        sib, bit, top, old0, bot, new1, upd = xs
        # left/right operand stacks for the 3 in-chain hash0 instances
        # (the new1 pair hash is precomputed, see new1h above)
        ol = fr.select(bit, sib, old_child)
        orr = fr.select(bit, old_child, sib)
        nl = fr.select(bit, sib, new_child)
        nr = fr.select(bit, new_child, sib)
        bl = fr.select(bit, zero, new_child)
        br = fr.select(bit, new_child, zero)
        ls = jnp.concatenate(
            [x.reshape(nlimb, bsz) for x in (ol, nl, bl)], axis=-1)
        rs = jnp.concatenate(
            [x.reshape(nlimb, bsz) for x in (orr, nr, br)], axis=-1)
        hs = smt_hash0(ls, rs)  # (16, 3*bsz)
        old_top_hash = hs[:, 0 * bsz:1 * bsz].reshape(old_child.shape)
        new_top_hash = hs[:, 1 * bsz:2 * bsz].reshape(old_child.shape)
        bot_hash = hs[:, 2 * bsz:3 * bsz].reshape(old_child.shape)
        # old chain
        old_up = fr.select(top, old_top_hash, zero)
        old_up = fr.select(bot | new1 | upd, old1leaf, old_up)
        # new chain
        new_up = fr.select(top, new_top_hash, zero)
        new_up = fr.select(bot, bot_hash, new_up)
        new_up = fr.select(new1, new1h, new_up)
        new_up = fr.select(old0 | upd, new1leaf, new_up)
        return (old_up, new_up), None

    # levels processed bottom-up: reverse all per-level arrays
    xs = (jnp.flip(siblings, axis=0),
          jnp.flip(new_bits, axis=0).astype(jnp.uint32),
          jnp.flip(jnp.stack(st_top), axis=0),
          jnp.flip(jnp.stack(st_old0), axis=0),
          jnp.flip(jnp.stack(st_bot), axis=0),
          jnp.flip(jnp.stack(st_new1), axis=0),
          jnp.flip(jnp.stack(st_upd), axis=0))
    (old_child, new_child), _ = jax.lax.scan(level_body, (zero, zero), xs)

    computed_old = fr.select(f_delete, new_child, old_child)
    computed_new = fr.select(f_delete, old_child, new_child)
    return computed_old, computed_new, enabled


def processor_check(old_root, computed_old, computed_new, enabled,
                    top_sibling):
    """Root check + output mux (the old_root-dependent tail of
    SMTProcessor). top_sibling: siblings[n-1] of this instance."""
    ok = ~enabled | fr.eq(computed_old, old_root)
    # top sibling must be zero when enabled (circomlib SMTLevIns check)
    ok = ok & (~enabled | fr.is_zero(top_sibling))
    new_root = fr.select(enabled, computed_new, old_root)
    return new_root, ok


def processor(old_root, siblings, old_key, old_value, is_old0,
              new_key, new_value, fnc0, fnc1):
    """Batched SMTProcessor(n) where n = siblings.shape[0].

    All field args canonical (16, B); is_old0/fnc0/fnc1 are (B,) 0/1.
    Returns (new_root, ok): ok False marks lanes whose proof does not match
    old_root (the circuit's hard constraint failure)."""
    computed_old, computed_new, enabled = processor_chains(
        siblings, old_key, old_value, is_old0, new_key, new_value,
        fnc0, fnc1)
    return processor_check(old_root, computed_old, computed_new, enabled,
                           siblings[siblings.shape[0] - 1])


def verifier(enabled, root, siblings, old_key, old_value, is_old0,
             key, value, fnc):
    """Batched SMTVerifier(n) (circomlib smtverifier.circom):
    fnc=0 inclusion proof, fnc=1 exclusion proof.
    Returns ok (B,) bool (True where disabled)."""
    n = siblings.shape[0]
    bshape = root.shape[1:]
    enabled = enabled.astype(jnp.bool_)
    fnc = fnc.astype(jnp.bool_)
    is0 = is_old0.astype(jnp.bool_)

    lev_ins = _lev_ins(siblings)
    bits = fr.bits_le(key, n)
    leaf_incl = smt_hash1(key, value)
    leaf_excl = smt_hash1(old_key, old_value)
    # exclusion with empty slot: subtree 0; else the other leaf
    leaf = fr.select(fnc & is0, fr.zeros(bshape),
                     fr.select(fnc, leaf_excl, leaf_incl))
    zero = fr.zeros(bshape)

    # state: top until lev_ins, then the leaf level, then na
    prev_top = jnp.ones(bshape, dtype=bool)
    sts = []
    for i in range(n):
        li = lev_ins[i]
        sts.append((prev_top & ~li, prev_top & li))
        prev_top = sts[-1][0]

    def level_body(child, xs):
        sib, bit, top, at = xs
        l = fr.select(bit, sib, child)
        r = fr.select(bit, child, sib)
        h = smt_hash0(l, r)
        up = fr.select(top, h, zero)
        up = fr.select(at, leaf, up)
        return up, None

    xs = (jnp.flip(siblings, axis=0),
          jnp.flip(bits, axis=0).astype(jnp.uint32),
          jnp.flip(jnp.stack([s[0] for s in sts]), axis=0),
          jnp.flip(jnp.stack([s[1] for s in sts]), axis=0))
    child, _ = jax.lax.scan(level_body, zero, xs)

    ok = fr.eq(child, root)
    # exclusion extra: old_key != key when not isOld0
    neq = ~fr.eq(old_key, key)
    ok = ok & (~fnc | is0 | neq)
    return ok | ~enabled
