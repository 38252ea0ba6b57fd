"""MVReg dominance filter as a tensor program.

The port's counterpart of ``crdt_enc_tpu/ops/mvreg.py`` (an XLA program
there, plain PyTorch here, on tensors of any device).  Given V candidate
values with dense clocks ``(V, R)``, keep each value whose clock is not
strictly dominated by another candidate's clock — the CvRDT merge rule of
models/mvreg.py, O(V²R) pairwise.  Production caller:
``TorchAccelerator._mvreg_antichain`` collapses a batch of MVReg
snapshots or write ops to the global anti-chain in one call.

Eager PyTorch materializes each broadcast comparison: the whole
``clocks[:, None, :] >= clocks[None, :, :]`` would hold V·V·R booleans
(42 GB at V = 2,048, R = 10,000).  The filter therefore walks the
dominating axis in blocks of ``block`` rows, so at most ``block·V·R``
booleans live at once.  The clocks stay int64: a clock entry past
2^31 − 1 compares as the host loop compares it.
"""

from __future__ import annotations

import torch

# booleans a block's comparison may hold (two such tensors live at once)
BLOCK_CELLS = 1 << 27


def dominance_block(V: int, R: int) -> int:
    """Rows of the dominating axis per block: as many as keep a block's
    ``block·V·R`` comparison within ``BLOCK_CELLS``, at least one."""
    return max(1, min(V, BLOCK_CELLS // max(V * R, 1)))


def mvreg_dominance_keep(clocks: torch.Tensor, valid: torch.Tensor | None = None,
                         *, block: int | None = None) -> torch.Tensor:
    """``clocks``: (V, R) integer; ``valid``: (V,) bool mask of real rows
    (all rows when None).  Returns (V,) bool — rows that survive the
    dominance filter.

    Caller contract: rows are distinct (clock, value) pairs — dedup of
    identical pairs happens host-side (models/mvreg.py _canonicalize),
    since value identity is not visible here.  Identical clocks with
    different values are concurrent and both survive."""
    V, R = clocks.shape
    if valid is None:
        valid = torch.ones(V, dtype=torch.bool, device=clocks.device)
    if block is None:
        block = dominance_block(V, R)
    dominated = torch.zeros(V, dtype=torch.bool, device=clocks.device)
    for lo in range(0, V, block):
        cj = clocks[lo : lo + block, None, :]  # dominating candidates
        ge = (cj >= clocks[None, :, :]).all(dim=-1)
        gt = (cj > clocks[None, :, :]).any(dim=-1)
        dominates = ge & gt & valid[lo : lo + block, None]  # [j, i]
        dominated |= dominates.any(dim=0)
    return valid & ~dominated
