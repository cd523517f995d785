"""Network-delay / straggler models for the PS simulator.

The port's copy of the flat and two-tier parts of ``repro/core/delays.py``
(fleet churn waits for a later slice).  Delivery is a per-channel
Bernoulli trial each clock (geometric delays): a push crosses its network
tier within one clock with probability ``push_prob x producer_rate /
max(t_tier, 1)`` unless the channel is congested that clock
(``straggler_prob``).  With ``n_pods > 1`` the ``P`` workers form
contiguous pod blocks and cross-pod channels ride the slower tier
(``t_net_xpod``).  The draws replay ``jax.random`` through
:mod:`repro_torch.rng`, so the delivery matrices equal the JAX package's.
"""
from __future__ import annotations

import torch

from .. import rng as jrng
from .consistency import ConsistencyConfig


def _f32(x, device) -> torch.Tensor:
    # filled on the device: torch.tensor(x, device=cuda) copies from the
    # host and synchronizes the stream
    return torch.full((), x, dtype=torch.float32, device=device)


def pod_of(P: int, n_pods: int, device=None) -> torch.Tensor:
    """Pod id of each worker: ``n_pods`` contiguous equal blocks ([P] i32)."""
    if P % n_pods:
        raise ValueError(f"n_workers={P} must divide by n_pods={n_pods}")
    return (torch.arange(P, dtype=torch.int32, device=device)
            // (P // n_pods)).to(torch.int32)


def same_pod_mask(P: int, n_pods: int, device=None) -> torch.Tensor:
    """[reader, producer] bool: True where the channel stays intra-pod."""
    pod = pod_of(P, n_pods, device)
    return pod[:, None] == pod[None, :]


def staleness_bound_matrix(cfg: ConsistencyConfig, reader_ids, P: int,
                           retry_budget: int = 0, device=None) -> torch.Tensor:
    """Per-channel SSP/ESSP staleness bound [readers, P(producer)], int32.

    ``cfg.staleness`` on intra-pod channels, ``+ s_xpod`` across pods (and,
    under the comm substrate, ``+ agg_clocks - 1 + retry_budget``)."""
    pods = pod_of(P, cfg.n_pods, device)
    reader_ids = torch.as_tensor(reader_ids, device=pods.device).long()
    same = pods[reader_ids][:, None] == pods[None, :]
    xpod_bound = cfg.staleness + cfg.s_xpod
    if cfg.comm_active:
        xpod_bound = xpod_bound + (cfg.agg_clocks - 1) + retry_budget
    return torch.where(same, cfg.staleness, xpod_bound).to(torch.int32)


def worker_rates(cfg: ConsistencyConfig, P: int, device=None) -> torch.Tensor:
    """Per-producer delivery-rate multipliers in (0, 1] (float32)."""
    ids = torch.arange(P, device=device)
    return torch.where(ids < cfg.straggler_workers,
                       _f32(cfg.straggler_rate, device), _f32(1.0, device))


def channel_push_prob(cfg: ConsistencyConfig, P: int, rates=None,
                      device=None) -> torch.Tensor:
    """Per-channel one-clock delivery probability [reader, producer]."""
    if rates is None:
        rates = worker_rates(cfg, P, device)
    device = rates.device
    p = _f32(cfg.push_prob, device) * rates[None, :]
    one = _f32(1.0, device)
    tier_i = one / torch.maximum(_f32(cfg.t_net_intra, device), one)
    tier_x = one / torch.maximum(_f32(cfg.t_net_xpod, device), one)
    same = same_pod_mask(P, cfg.n_pods, device)
    return p * torch.where(same, tier_i, tier_x)


def delivery_matrix(key, cfg: ConsistencyConfig, P: int,
                    rates=None) -> torch.Tensor:
    """Sample the end-of-clock delivery matrix [P(reader), P(producer)]:
    the push crosses its tier and the channel is not congested."""
    k1, k2 = jrng.split(key)
    p = channel_push_prob(cfg, P, rates, device=key.device)
    pushed = jrng.uniform(k1, (P, P)) < p
    congested = jrng.bernoulli(k2, cfg.straggler_prob, (P, P))
    return pushed & ~congested


def expected_delay(cfg: ConsistencyConfig, P: int,
                   device=None) -> torch.Tensor:
    """Analytic mean delivery delay per channel (geometric): 1/p clocks."""
    p = channel_push_prob(cfg, P, device=device) * _f32(
        1.0 - cfg.straggler_prob, device)
    return _f32(1.0, device) / torch.clamp(p, min=1e-6)
