"""AOT trace serialization — warm-start without re-tracing.

The reference compiles once into a reusable native binary
(/root/reference/tools/helpers/actions.js:98-130); this engine's
monomorphization is a jit specialization, which a fresh process would
re-trace (Python -> jaxpr -> StableHLO, tens of seconds for the
production graph) before the persistent XLA cache can even be consulted.

This module serializes the traced+lowered computation with `jax.export`:
`export_rollup_main` writes a self-contained StableHLO artifact for the
monomorphized RollupMain; `load_rollup_main` rehydrates it in a fresh
process with zero Python tracing — XLA compile then hits the persistent
compilation cache, so warm start = deserialize + cache-load.

Artifacts live next to the circuit config (`rollup-N-L-ML-MF/aot.bin`,
the `circuit-*.cpp` binary analogue).
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp


def rollup_input_shapes(n_tx: int, n_levels: int, max_l1_tx: int,
                        max_fee_tx: int) -> dict:
    """ShapeDtypeStructs of the packed RollupMain input dict (the shapes
    pack_rollup_inputs produces)."""
    T, F, L = n_tx, max_fee_tx, n_levels + 1

    def u32(*s):
        return jax.ShapeDtypeStruct(s, jnp.uint32)

    shapes = {}
    for k in ("old_last_idx", "old_state_root", "global_chain_id",
              "current_num_batch", "im_init_state_root_fee"):
        shapes[k] = u32(16, 1)
    per_tx = (
        "tx_compressed_data", "amount_f", "tx_compressed_data_v2",
        "from_idx", "aux_from_idx", "to_idx", "aux_to_idx", "to_bjj_ay",
        "to_eth_addr", "max_num_batch", "rq_tx_compressed_data_v2",
        "rq_to_eth_addr", "rq_to_bjj_ay", "s", "r8x", "r8y",
        "load_amount_f", "from_eth_addr",
        "token_id1", "nonce1", "balance1", "ay1", "eth_addr1",
        "old_key1", "old_value1",
        "token_id2", "nonce2", "balance2", "ay2", "eth_addr2",
        "old_key2", "old_value2")
    for k in per_tx:
        shapes[k] = u32(16, T)
    for k in ("on_chain", "new_account", "new_exit", "is_old0_1",
              "is_old0_2", "sign1", "sign2", "rq_offset"):
        shapes[k] = u32(T)
    for k in ("fee_plan_tokens", "fee_idxs", "im_final_acc_fee",
              "token_id3", "nonce3", "balance3", "ay3", "eth_addr3"):
        shapes[k] = u32(16, F)
    shapes["sign3"] = u32(F)
    shapes["from_bjj_compressed"] = u32(256, T)
    shapes["siblings1"] = u32(L, 16, T)
    shapes["siblings2"] = u32(L, 16, T)
    shapes["siblings3"] = u32(L, 16, F)
    shapes["im_on_chain"] = u32(T - 1)
    shapes["im_out_idx"] = u32(16, T - 1)
    shapes["im_state_root"] = u32(16, T - 1)
    shapes["im_exit_root"] = u32(16, T - 1)
    shapes["im_state_root_fee"] = u32(16, F - 1)
    shapes["im_acc_fee_out"] = u32(F, 16, T - 1)
    return shapes


def aot_path(n_tx, n_levels, max_l1_tx, max_fee_tx,
             base: str | Path = ".") -> Path:
    d = Path(base) / f"rollup-{n_tx}-{n_levels}-{max_l1_tx}-{max_fee_tx}"
    return d / "aot.bin"


def export_rollup_main(n_tx: int, n_levels: int, max_l1_tx: int,
                       max_fee_tx: int, path: str | Path | None = None
                       ) -> Path:
    """Trace+lower the monomorphized RollupMain for the CURRENT backend
    and serialize the artifact. Returns the written path."""
    from jax import export as jex
    from ..models.rollup_main import rollup_main

    fn = jax.jit(partial(rollup_main, n_tx=n_tx, n_levels=n_levels,
                         max_l1_tx=max_l1_tx, max_fee_tx=max_fee_tx))
    shapes = rollup_input_shapes(n_tx, n_levels, max_l1_tx, max_fee_tx)
    # on CPU the compute path lowers to the fr_ffi custom calls — this
    # package's own kernels, so replaying them is safe by construction
    checks = [jex.DisabledSafetyCheck.custom_call(t)
              for t in ("fr_mont_mul", "fr_add", "fr_sub", "fr_pow",
                        "fr_poseidon", "sha256_blocks", "Sharding")]
    exp = jex.export(fn, disabled_checks=checks)(shapes)
    blob = exp.serialize()
    p = Path(path) if path else aot_path(n_tx, n_levels, max_l1_tx,
                                         max_fee_tx)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(blob)
    return p


def load_rollup_main(path: str | Path):
    """Rehydrate an exported RollupMain: returns a jitted callable
    packed_inputs -> (outputs, ok) with NO Python tracing of the model."""
    from jax import export as jex

    exp = jex.deserialize(Path(path).read_bytes())
    return jax.jit(exp.call)
