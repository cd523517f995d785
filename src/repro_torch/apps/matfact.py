"""Low-rank matrix factorization via SGD on the parameter server.

The port of ``repro/apps/matfact.py``: the paper's primary SGD benchmark
(Netflix, rank 100) with its exact update equations::

    L_i*  <- L_i* + γ (e_ij R_*j^T − λ L_i*)
    R_*j  <- R_*j + γ (e_ij L_i*^T − λ R_*j)      e_ij = D_ij − L_i* R_*j

Both factor matrices live on the PS (packed into the flat vector); the
observed ratings are partitioned by row blocks across workers.  Each clock
a worker draws a minibatch of its own ratings and INCs the additive
deltas.  The synthetic data is drawn from :mod:`repro_torch.rng`, so the
observed indices equal the JAX app's and the values agree to float
rounding.

The worker update runs all ``P`` workers in one batched call.  The
scatter of duplicate indices (the JAX app's ``.at[i].add``) is
``index_put_(..., accumulate=True)`` over a flattened ``(worker, row)``
index: sequential in index order on the CPU; on CUDA PyTorch sums
duplicates after a stable sort of the indices, so the order is fixed
there too, though not the CPU's.  Both are held to the ulp budget of
``psrun.validate``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import rng as jrng
from ..core.consistency import bsp
from ..core.ps import PSApp, simulate
from ..core.timemodel import TimeModel
from ..device import resolve_device


def mf_time_model(**kw) -> TimeModel:
    """Paper-class wall-clock constants for the MF/SGD app: the 1 GbE
    defaults of `TimeModel` (50 ms SGD clocks, ~4 MB of factor rows per
    producer), the one place the Fig 2 time axis takes them from."""
    return TimeModel(**kw)


# Ratings per chunk of the loss (bounds its [chunk, K] gather temporaries
# at full width; the small configs fit in one chunk).
_LOSS_CHUNK = 1 << 20


@dataclass(frozen=True)
class MFConfig:
    n_rows: int = 240
    n_cols: int = 240
    rank: int = 24           # K
    true_rank: int = 12
    density: float = 0.18    # fraction of observed entries
    noise: float = 0.01
    n_workers: int = 8
    batch: int = 128         # ratings per worker per clock
    lr: float = 0.7          # γ
    lr_decay: bool = True    # γ_t = γ / sqrt(1 + t)
    lam: float = 1e-4        # λ
    init_scale: float = 0.1
    seed: int = 0


def _f32(x, device) -> torch.Tensor:
    # filled on the device: torch.tensor(x, device=cuda) copies from the
    # host and synchronizes the stream
    return torch.full((), x, dtype=torch.float32, device=device)


def mf_data(cfg: MFConfig, device=None):
    """The synthetic problem, drawn as the JAX app draws it.

    Returns ``(x0 [d], ii [P, n_obs], jj [P, n_obs], vv [P, n_obs])``."""
    dev = resolve_device(device)
    n, m, k, P = cfg.n_rows, cfg.n_cols, cfg.rank, cfg.n_workers
    if n % P:
        raise ValueError("n_rows must divide by n_workers")
    key = jrng.PRNGKey(cfg.seed, dev)
    k_t, k_o, k_n, k_i = jrng.split(key, 4).unbind(0)

    kL, kR = jrng.split(k_t).unbind(0)
    sqrt_tr = torch.sqrt(_f32(float(cfg.true_rank), dev))
    Lstar = jrng.normal(kL, (n, cfg.true_rank)) / sqrt_tr
    Rstar = jrng.normal(kR, (cfg.true_rank, m)) / sqrt_tr

    rows_per = n // P
    n_obs_per = int(rows_per * m * cfg.density)
    keys = jrng.split(k_o, P)                                 # [P, 2]
    kij = jrng.split(keys)                                    # [P, 2, 2]
    offs = torch.arange(P, dtype=torch.int32, device=dev)[:, None] * rows_per
    ii = jrng.randint(kij[:, 0], (n_obs_per,), 0, rows_per) + offs
    jj = jrng.randint(kij[:, 1], (n_obs_per,), 0, m)

    # D = L*R* + noise·N(0,1), read only at the observed entries; the dense
    # n×m noise draw keeps the key stream's counters (row-major over n×m).
    noise = jrng.normal(k_n, (n, m))
    D = torch.matmul(Lstar, Rstar)
    D += _f32(cfg.noise, dev) * noise
    del noise
    vv = D[ii.long(), jj.long()]
    del D

    kLi, kRi = jrng.split(k_i).unbind(0)
    scale = _f32(cfg.init_scale, dev)
    L0 = scale * jrng.normal(kLi, (n, k))
    R0 = scale * jrng.normal(kRi, (k, m))
    x0 = torch.cat([L0.reshape(-1), R0.reshape(-1)])
    return x0, ii, jj, vv


def mf_app(cfg: MFConfig, x0, ii, jj, vv) -> PSApp:
    """The MF app over given data (``x0 [d]``; ``ii``/``jj`` int32 and
    ``vv`` float32, each ``[P, n_obs]``), on the device of ``x0``."""
    n, m, k, P = cfg.n_rows, cfg.n_cols, cfg.rank, cfg.n_workers
    dev = x0.device
    n_obs_per = ii.shape[1]
    lr, lam = _f32(cfg.lr, dev), _f32(cfg.lam, dev)
    pidx = torch.arange(P, device=dev)[:, None]
    ks = torch.arange(k, device=dev)

    def unpack(x):                              # [d] -> L [n, k], R [k, m]
        return x[: n * k].reshape(n, k), x[n * k:].reshape(k, m)

    def worker_update(views, local, _wids, clock: int, keys):
        if cfg.lr_decay:
            gamma = lr / torch.sqrt(_f32(1.0 + clock, dev))
        else:
            gamma = lr
        idx = jrng.randint(keys, (cfg.batch,), 0, n_obs_per).long()
        i = torch.gather(local["ii"], 1, idx).long()
        j = torch.gather(local["jj"], 1, idx).long()
        v = torch.gather(local["vv"], 1, idx)
        # rows L[i] and columns R[:, j] of each worker's view, gathered
        # from the packed vector: L[i, :] at i*k + ks, R[:, j] at n*k + ks*m + j
        pb = pidx[..., None]
        Li = views[pb, i[..., None] * k + ks]                 # [P, B, k]
        Rj = views[pb, n * k + ks * m + j[..., None]]         # [P, B, k]
        e = v - torch.sum(Li * Rj, dim=-1)
        gL = gamma * (e[..., None] * Rj - lam * Li)
        gR = gamma * (e[..., None] * Li - lam * Rj)
        dL = torch.zeros((P * n, k), dtype=torch.float32, device=dev)
        dL.index_put_(((pidx * n + i).reshape(-1),), gL.reshape(-1, k),
                      accumulate=True)
        dRt = torch.zeros((P * m, k), dtype=torch.float32, device=dev)
        dRt.index_put_(((pidx * m + j).reshape(-1),), gR.reshape(-1, k),
                       accumulate=True)
        dR = dRt.reshape(P, m, k).transpose(1, 2)
        return torch.cat([dL.reshape(P, n * k), dR.reshape(P, k * m)],
                         dim=1), local

    all_i = ii.reshape(-1).long()
    all_j = jj.reshape(-1).long()
    all_v = vv.reshape(-1)

    def loss(x, _locals):
        L, R = unpack(x)
        Rt = R.t().contiguous()        # rows of R^T: gathers read whole rows
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(0, all_i.numel(), _LOSS_CHUNK):
            sl = slice(s, s + _LOSS_CHUNK)
            pred = torch.sum(L[all_i[sl]] * Rt[all_j[sl]], dim=-1)
            total = total + torch.sum(torch.square(all_v[sl] - pred))
        # a tensor divisor: a CUDA tensor divided by a Python scalar is a
        # multiply by its reciprocal, not the true division of the CPU
        return total / _f32(float(all_i.numel()), dev)

    local0 = {"ii": ii, "jj": jj, "vv": vv}
    return PSApp(name="matfact", dim=(n + m) * k, n_workers=P, x0=x0,
                 local0=local0, worker_update=worker_update, loss=loss)


def make_mf_app(cfg: MFConfig, device=None) -> PSApp:
    """The MF app with its synthetic data, on ``device`` (default cuda)."""
    return mf_app(cfg, *mf_data(cfg, device))


def sequential_baseline(cfg: MFConfig, n_clocks: int, device=None):
    """Single-worker (strongly consistent) reference: the same app with
    P=1 doing P*batch ratings per clock."""
    c1 = dataclasses.replace(cfg, n_workers=1,
                             batch=cfg.batch * cfg.n_workers)
    return simulate(make_mf_app(c1, device), bsp(), n_clocks)

