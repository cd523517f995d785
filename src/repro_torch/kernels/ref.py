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


def delta_pack(delta, thresh, scale, quant: str = "f32"):
    """Error-feedback compression pack of per-producer delta rows.

    ``delta [P, d]`` aggregated deltas, ``thresh [P]`` per-row magnitude
    threshold (the k-th largest ``|delta|``, ``comm.substrate.row_threshold``),
    ``scale [P]`` int8 dequant scale (absmax / 127; read only when
    ``quant == "int8"``).  Returns ``(wire [P, d], residual [P, d])``::

        mask     = |delta| >= thresh
        wire     = mask ? Q(delta) : 0
        residual = mask ? delta - Q(delta) : delta     (f32: mask ? 0 : delta)

    Bit-equal to the JAX package's reference as XLA compiles it inside the
    simulator's scan (and to its Pallas body):

    - f32: the residual is the masked complement, never ``delta - delta``,
      so ``wire + residual == delta`` exactly;
    - bf16: ``Q`` rounds to the nearest even bf16; ``delta - Q(delta)`` is
      exact in float32;
    - int8: ``r = clamp(round_half_even(delta / s), ±127)`` with a true
      division, the wire is ``float32(r·s)``, and the residual is ``delta
      - r·s`` rounded once, as the fused multiply-add that XLA contracts
      it into (``r·s`` is exact in float64, so is the difference, and the
      cast rounds once).
    """
    mask = delta.abs() >= thresh[:, None]
    zero = delta.new_zeros(())
    if quant == "f32":
        return torch.where(mask, delta, zero), torch.where(mask, zero, delta)
    if quant == "bf16":
        q = delta.to(torch.bfloat16).to(torch.float32)
        return (torch.where(mask, q, zero),
                torch.where(mask, delta - q, delta))
    if quant == "int8":
        s = scale[:, None]
        r = torch.clamp(torch.round(delta / s), -127.0, 127.0)
        exact = delta.double() - r.double() * s.double()
        return (torch.where(mask, r * s, zero),
                torch.where(mask, exact.to(torch.float32), delta))
    raise ValueError(f"unknown quant {quant!r}")


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
