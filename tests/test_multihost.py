"""2-process DCN-style run on this machine (BASELINE.md "N>=2 hosts").

Spawns two jax.distributed processes (4 virtual CPU devices each) that
form one 8-device tx-lane mesh and run the sharded witness step; the
verdict psum and rq-link all_gathers cross the process boundary. Both
processes must agree on the hash and it must equal the single-host
builder oracle.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh():
    # bounded by communicate(timeout=390) below (pytest-timeout absent)
    port = _free_port()
    # both processes stay on the CPU: never two processes on one card
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, "-u", str(ROOT / "scripts/multihost_worker.py"),
         str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=390)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    hashes = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith("MULTIHOST_OK")][0]
        hashes.append(int(line.split()[2]))
    assert hashes[0] == hashes[1]

    # oracle: single-host builder hash for the same batch
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _build_packed  # noqa: F401  (same inputs)
    from circuits_tpu.builder.rollup_db import RollupDB
    from circuits_tpu.builder.account import HermezAccount
    from circuits_tpu.builder import float40

    a1, a2 = HermezAccount(1), HermezAccount(2)
    db = RollupDB()
    bb = db.build_batch(8, 16, 2, 2)
    for acc, amt in [(a1, 1000), (a2, 2000)]:
        bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amt),
                       tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                       fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    bb.build()
    db.consolidate(bb)
    bb2 = db.build_batch(8, 16, 2, 2)
    bb2.add_token(1)
    bb2.add_fee_idx(257)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=100, userFee=126,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    assert hashes[0] == bb2.get_hash_inputs()
