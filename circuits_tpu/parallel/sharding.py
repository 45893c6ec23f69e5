"""Tx-lane sharding of RollupMain over a 1-D device mesh via shard_map.

Design (replacement for the reference's pthread witness parallelism,
tools/helpers/actions.js:41 + circom_runtime threads):

  * mesh axis "tx": each device evaluates a contiguous slice of tx lanes —
    decode, EdDSA, balance update, both SMT processors — with zero
    communication (the im chains arrive as per-lane inputs, the
    reference's own parallelization contract,
    src/rollup-main.circom:93-99).
  * Cross-lane reads are EXPLICIT collectives, not GSPMD inference:
      - rq-link neighbour windows (±3/±4 lanes): all_gather of the three
        small per-tx arrays, windows sliced per shard;
      - constraint verdict: psum of per-shard failure counts
        (SURVEY §2.4 "im-signal integrity = chip-local equality check,
        all-reduce a verdict");
      - the global tail (fee txs + SHA256 of the public inputs) reads
        every lane's DA bitstring: all_gather, then replicated compute.
    Manual SPMD (shard_map) keeps the per-shard program identical to the
    single-device one, so the native FFI field kernels on the CPU backend
    and the GPU kernels both partition trivially. A 1-D mesh suits
    NVLink's all-to-all links: no torus to map onto.
  * im chains of length T-1 are padded host-side to per-lane length-T
    prev/expected arrays (models.rollup_main.build_chains) so every
    sharded array has the lane axis divisible by the mesh.

Use `make_sharded_rollup_main(mesh, ...)` then call with packed inputs.
nTx must be divisible by the mesh size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..field import fr
from ..models import rollup_main as rm

AXIS = "tx"

# input key -> which dim is the tx-lane dim (None = replicated)
_LANE_DIM = {
    # per-tx field arrays (16, T)
    "tx_compressed_data": 1, "amount_f": 1, "tx_compressed_data_v2": 1,
    "from_idx": 1, "aux_from_idx": 1, "to_idx": 1, "aux_to_idx": 1,
    "to_bjj_ay": 1, "to_eth_addr": 1, "max_num_batch": 1,
    "rq_tx_compressed_data_v2": 1, "rq_to_eth_addr": 1, "rq_to_bjj_ay": 1,
    "s": 1, "r8x": 1, "r8y": 1, "load_amount_f": 1, "from_eth_addr": 1,
    "token_id1": 1, "nonce1": 1, "balance1": 1, "ay1": 1, "eth_addr1": 1,
    "old_key1": 1, "old_value1": 1,
    "token_id2": 1, "nonce2": 1, "balance2": 1, "ay2": 1, "eth_addr2": 1,
    "old_key2": 1, "old_value2": 1,
    # per-tx flags (T,)
    "on_chain": 0, "new_account": 0, "new_exit": 0, "is_old0_1": 0,
    "is_old0_2": 0, "sign1": 0, "sign2": 0, "rq_offset": 0,
    # bits (256, T)
    "from_bjj_compressed": 1,
    # siblings (L+1, 16, T)
    "siblings1": 2, "siblings2": 2,
    # scalars / fee-slot arrays / im chains: replicated (im chains are
    # consumed through build_chains on the host side of the jit
    # boundary, see make_sharded_rollup_main)
}

# chain arrays produced by build_chains: lane dim index
_CHAIN_LANE_DIM = {
    "prev_on_chain": 0, "im_oc_next": 0, "in_idx": 1, "old_state_root": 1,
    "old_exit_root": 1, "acc_fee_in": 2, "expected_out_idx": 1,
    "expected_state_root": 1, "expected_exit_root": 1,
    "expected_acc_fee": 2,
}


def make_tx_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (AXIS,))


def _spec(dim: int | None, ndim: int) -> P:
    if dim is None:
        return P()
    parts = [None] * ndim
    parts[dim] = AXIS
    return P(*parts)


def tx_shardings(mesh: Mesh, inp: dict) -> dict:
    """NamedSharding pytree matching a packed input dict: lane axes
    sharded over the mesh, everything else replicated."""
    return {k: NamedSharding(mesh, _spec(_LANE_DIM.get(k), v.ndim))
            for k, v in inp.items()}


def _sharded_step(inp, chains, n_tx, t_loc, n_levels, max_l1_tx,
                  max_fee_tx):
    """Per-shard body (runs under shard_map): lane phases on the local
    slice, explicit collectives for the cross-lane reads."""
    start = jax.lax.axis_index(AXIS) * t_loc

    # rq-link halos: gather the 3 small per-tx arrays, slice this
    # shard's ±3/±4 windows (src/rollup-main.circom:287-309)
    zero1 = fr.zeros((1,))
    loc = lambda a: jax.lax.dynamic_slice_in_dim(a, start, t_loc, axis=-1)
    neighbors = []
    for key in ("tx_compressed_data_v2", "to_eth_addr", "to_bjj_ay"):
        full = jax.lax.all_gather(inp[key], AXIS, axis=1, tiled=True)
        fut, past = rm._neighbors(full, zero1)
        neighbors += [loc(fut), loc(past)]

    last_mask = (start + jnp.arange(t_loc)) == n_tx - 1
    lanes, lane_ok = rm.rollup_main_lanes(
        inp, chains, t_loc, n_levels, max_fee_tx,
        neighbors=tuple(neighbors), last_mask=last_mask)

    # verdict all-reduce: psum of per-shard failure counts
    n_bad = jax.lax.psum(jnp.sum((~lane_ok).astype(jnp.uint32)), AXIS)
    ok_all = (n_bad == 0) & jnp.all(inp["im_on_chain"] <= 1)

    # global tail inputs: gather the lane outputs the fee/SHA phases read
    gather = partial(jax.lax.all_gather, axis_name=AXIS, tiled=True)
    full_lanes = dict(
        l1_tx_full_data=gather(lanes["l1_tx_full_data"], axis=1),
        l1l2_tx_data=gather(lanes["l1l2_tx_data"], axis=1),
        is_amount_nullified=gather(lanes["is_amount_nullified"], axis=0),
        out_idx=gather(lanes["out_idx"], axis=1),
        new_exit_root=gather(lanes["new_exit_root"], axis=1),
        acc_fee_out=gather(lanes["acc_fee_out"], axis=2),
    )
    # fee txs + global SHA256: replicated compute over gathered data
    out, tail_ok = rm.global_tail(inp, full_lanes, n_tx, n_levels,
                                  max_l1_tx, max_fee_tx)
    return out, ok_all & tail_ok


def make_sharded_rollup_main(mesh: Mesh, n_tx: int, n_levels: int,
                             max_l1_tx: int, max_fee_tx: int):
    """Returns run(packed_inputs) -> (outputs, ok) with the tx axis
    sharded over `mesh` via shard_map. build_chains runs unsharded
    (host-cheap concat) so the device arrays all carry a length-T lane
    axis."""
    n_dev = mesh.devices.size
    assert n_tx % n_dev == 0, \
        f"nTx={n_tx} must divide over {n_dev} devices"
    t_loc = n_tx // n_dev

    fn = partial(_sharded_step, n_tx=n_tx, t_loc=t_loc, n_levels=n_levels,
                 max_l1_tx=max_l1_tx, max_fee_tx=max_fee_tx)
    out_specs = (dict(
        hash_global_inputs=P(), new_state_root=P(), new_exit_root=P(),
        new_last_idx=P(), acc_fee_out=P()), P())

    @jax.jit
    def step(packed: dict, chains: dict):
        in_specs = (
            {k: _spec(_LANE_DIM.get(k), v.ndim)
             for k, v in packed.items()},
            {k: _spec(_CHAIN_LANE_DIM[k], v.ndim)
             for k, v in chains.items()},
        )
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)(
            packed, chains)

    def run(packed: dict):
        chains = rm.build_chains(packed, n_tx, max_fee_tx)
        placed = {k: jax.device_put(
            v, NamedSharding(mesh, _spec(_LANE_DIM.get(k), v.ndim)))
            for k, v in packed.items()}
        chains_placed = {k: jax.device_put(
            v, NamedSharding(mesh, _spec(_CHAIN_LANE_DIM[k], v.ndim)))
            for k, v in chains.items()}
        return step(placed, chains_placed)

    return run
