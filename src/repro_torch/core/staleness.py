"""Staleness (clock-differential) measurement — paper Fig 1 (left).

The port's copy of ``repro/core/staleness.py``, numpy only: pass a trace
whose fields are numpy arrays (``repro_torch.convert.trace_to_numpy``).
The clock differential of a read is the clock of the parameter copy read
minus the reader's own clock: always −1 under BSP, ≈ uniform over
[−s−1, −1] under lazy SSP, concentrated at −1 under ESSP (claim C1).
"""
from __future__ import annotations

import numpy as np


def clock_differentials(trace, exclude_self: bool = True,
                        skip_warmup: bool = False) -> np.ndarray:
    """Flatten per-read clock differentials ``cview[r,q] − c`` from a
    trace.  Self-channels (r == q) are excluded by default (read-my-writes
    pins them at −1).  ``skip_warmup`` drops the leading clocks where every
    off-diagonal ``cview`` is still the initial −1."""
    st = np.asarray(trace.staleness)               # [T, P, P]
    P = st.shape[-1]
    off = ~np.eye(P, dtype=bool)
    if skip_warmup and st.shape[0]:
        cview = st + np.arange(st.shape[0])[:, None, None]
        warm = (cview[:, off] == -1).all(axis=1)    # [T]
        n_warm = int(np.argmin(warm)) if not warm.all() else st.shape[0]
        st = st[n_warm:]
    if exclude_self:
        return st[:, off].ravel()
    return st.ravel()


def histogram(trace, lo: int | None = None, hi: int = 0,
              exclude_self: bool = True, skip_warmup: bool = False):
    """Normalized histogram of clock differentials: ``(bin_values,
    probabilities)`` with bins ``lo..hi`` inclusive."""
    diffs = clock_differentials(trace, exclude_self, skip_warmup)
    if lo is None:
        lo = int(diffs.min()) if diffs.size else -1
    bins = np.arange(lo, hi + 2) - 0.5
    counts, _ = np.histogram(diffs, bins=bins)
    total = max(1, counts.sum())
    return np.arange(lo, hi + 1), counts / total


def summary(trace, exclude_self: bool = True) -> dict:
    """Moments of the staleness distribution, warm-up clocks skipped
    (the whole trace is used when it is all warm-up)."""
    diffs = clock_differentials(trace, exclude_self,
                                skip_warmup=True).astype(np.float64)
    if diffs.size == 0:
        diffs = clock_differentials(trace, exclude_self).astype(np.float64)
    return {
        "mean": float(diffs.mean()),
        "std": float(diffs.std()),
        "min": int(diffs.min()),
        "max": int(diffs.max()),
        "frac_fresh": float((diffs >= -1).mean()),
    }
