"""Plain PyTorch versions of the port's kernels.

They state each kernel's contract: the CPU path runs them, the tests hold
them against the JAX package's ``kernels/ref.py``, and ``chip_smoke.py``
holds each hand-written kernel against them on the card.
"""
from __future__ import annotations

import torch

RING_INVALID = -(10**8)   # uclock values below this mark empty ring slots
RING_EMPTY = -(10**9)     # initial uclock fill (no clock stored yet)
# Both sentinels are int32 and part of the Trace-producer contract: the
# kernels compare uclock/cview in int32 against them.


def ring_view(base, uring, uclock, cview):
    """Materialize per-reader parameter views from the update ring.

    base [d], uring [W,P,d] (slot, producer, dim), uclock [W] int32 (clock
    stored in each slot; < RING_INVALID when empty), cview [P,P] int32
    (reader, producer) visibility clocks.  Returns views [P,d]:

        view[r] = base + Σ_{w,q : uclock[w] <= cview[r,q], slot valid} uring[w,q]
    """
    valid = uclock > RING_INVALID
    vis = (uclock[None, :, None] <= cview[:, None, :]) & valid[None, :, None]
    return base[None, :] + torch.einsum("rwq,wqd->rd", vis.to(uring.dtype),
                                        uring)


def ring_view_tolerance(base, uring) -> float:
    """Largest difference allowed between two ``ring_view`` results that
    add the same terms in different orders: each float32 sum of ``n =
    W·P + 1`` terms is within ``n·eps·Σ|terms|`` of the exact sum, so two
    orders differ by at most twice that, taken at the worst column."""
    W, P, _ = uring.shape
    mag = base.abs() + uring.abs().sum(dim=(0, 1))
    eps = torch.finfo(torch.float32).eps
    return float(2 * (W * P + 1) * eps * mag.max())


def vap_suffix_norms(uring, uclock, c: int):
    """Inf-norms of per-producer suffix aggregates of the newest k clocks.

    Returns norms [W+1, P] with norms[k, q] = || Σ_{j=1..k} u_q(c-j) ||_inf
    (norms[0] = 0: the empty suffix).  This is the quantity VAP bounds by
    v_t, and the one-gather source of the in-transit metric in `core.ps`.
    The suffix is a float32 running sum over k, one ring row per step, as
    in the TPU and CUDA kernels (so all three agree exactly; torch's CPU
    ``cumsum`` would accumulate in float64).
    """
    W, P, d = uring.shape
    suffix = uring.new_zeros((P, d))
    norms = [uring.new_zeros((P,))]
    for k in range(1, W + 1):
        sel = (uclock == c - k).to(uring.dtype)                     # [W]
        suffix = suffix + torch.einsum("w,wqd->qd", sel, uring)     # one row
        norms.append(suffix.abs().amax(dim=-1))
    return torch.stack(norms)
