"""Ready-made batches for full-size runs of the engine."""

from __future__ import annotations

from . import float40
from .account import HermezAccount
from .rollup_db import BatchBuilder, RollupDB


def transfer_batch(n_tx: int, n_levels: int, max_l1_tx: int,
                   max_fee_tx: int) -> BatchBuilder:
    """A built batch of n_tx signed L2 transfers in a ring over n_tx
    accounts, fees to the first account. The accounts are first created
    by L1 deposit batches of max_l1_tx each (the populateDB step of the
    reference's input generator). Deterministic."""
    n_acc = max(n_tx, 2)
    accounts = [HermezAccount(i + 1) for i in range(n_acc)]
    db = RollupDB()
    for start in range(0, n_acc, max_l1_tx):
        bb = db.build_batch(n_tx, n_levels, max_l1_tx, max_fee_tx)
        for acc in accounts[start:start + max_l1_tx]:
            bb.add_tx(dict(fromIdx=0,
                           loadAmountF=float40.fix2float(10_000_000),
                           tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                           fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
        bb.build()
        db.consolidate(bb)
    bb = db.build_batch(n_tx, n_levels, max_l1_tx, max_fee_tx)
    bb.add_token(1)
    bb.add_fee_idx(256)
    for i in range(n_tx):
        tx = dict(fromIdx=256 + i, toIdx=256 + (i + 1) % n_acc, tokenID=1,
                  amount=1000, userFee=126, nonce=0, onChain=0)
        accounts[i].sign_tx(tx)
        bb.add_tx(tx)
    bb.build()
    return bb
