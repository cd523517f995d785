"""Parameter-server consistency models (the paper's core abstraction).

The port's copy of ``repro/core/consistency.py``.  A *consistency model*
governs which producers' updates a reader's cached view contains at each
clock:

- ``bsp``    Bulk Synchronous Parallel: a full barrier every clock; a read at
             clock ``c`` sees *all* updates through ``c-1``.
- ``ssp``    Stale Synchronous Parallel (SSPTable): the cache refreshes
             *lazily*, only when its clock would violate the bound ``s``.
- ``essp``   Eager SSP (ESSPTable, this paper): SSP's guarantee, but the
             server pushes updated rows every clock, so the empirical
             staleness concentrates near -1.
- ``async``  No bound (Hogwild-style); delivery purely delay-driven.
- ``vap``    Value-bounded Asynchronous Parallel: in-transit updates of a
             producer are forced out whenever their inf-norm would exceed
             ``v_t = v0/sqrt(t+1)`` (eq. 1 of the paper).

The config is a plain frozen dataclass: torch runs eagerly, so every knob
is a concrete Python value (the JAX package's pytree registration, which
let sweeps trace the numeric knobs, has no counterpart here).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

MODELS = ("bsp", "ssp", "essp", "async", "vap")

# Wire-value formats of the comm substrate, in bits.
QUANT_BITS = {"f32": 32, "bf16": 16, "int8": 8}

# Physically meaningful ranges of the numeric knobs ((lo, hi), None = open).
KNOB_BOUNDS = {
    "staleness": (0, None),
    "v0": (1e-3, None),
    "push_prob": (0.05, 1.0),
    "straggler_prob": (0.0, 0.95),
    "straggler_workers": (0, None),
    "straggler_rate": (0.01, 1.0),
    "s_xpod": (0, None),
    "t_net_intra": (1.0, None),
    "t_net_xpod": (1.0, None),
    "agg_clocks": (1, None),
    "topk_frac": (0.01, 1.0),
}
# The numeric knobs that take integer values (the tuner rounds them).
INT_KNOBS = ("staleness", "straggler_workers", "s_xpod", "agg_clocks")


@dataclass(frozen=True)
class ConsistencyConfig:
    """Configuration of a PS consistency model.

    The fields and their meaning are those of the JAX package's
    ``ConsistencyConfig``: ``staleness`` (SSP/ESSP bound ``s``), ``v0``
    (VAP bound ``v_t = v0 / sqrt(t+1)``), ``push_prob`` (one-clock
    delivery probability of a push), ``straggler_prob`` (per-channel
    congestion probability), ``straggler_workers``/``straggler_rate``
    (persistently slow producers and their rate multiplier),
    ``read_my_writes``, ``window`` (ring-buffer override),
    ``max_extra_delay`` (window slack of the unbounded models), and the
    two-tier knobs ``n_pods``, ``s_xpod``, ``t_net_intra``,
    ``t_net_xpod``.  ``agg_clocks``, ``topk_frac``, ``quant`` and ``wire``
    select the comm substrate (:mod:`repro_torch.comm.substrate`).
    """

    model: str = "essp"
    staleness: int = 3
    v0: float = 0.0
    push_prob: float = 0.9
    straggler_prob: float = 0.05
    straggler_workers: int = 0
    straggler_rate: float = 0.25
    read_my_writes: bool = True
    window: int | None = None
    max_extra_delay: int = 6
    n_pods: int = 1
    s_xpod: int = 0
    t_net_intra: float = 1.0
    t_net_xpod: float = 1.0
    agg_clocks: int = 1
    topk_frac: float = 1.0
    quant: str = "f32"
    wire: bool | None = None

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"unknown consistency model {self.model!r}; "
                             f"expected one of {MODELS}")
        if self.staleness < 0:
            raise ValueError("staleness must be >= 0")
        if self.model == "vap" and self.v0 <= 0:
            raise ValueError("vap requires v0 > 0")
        if self.n_pods < 1:
            raise ValueError("n_pods must be >= 1")
        if self.s_xpod < 0:
            raise ValueError("s_xpod must be >= 0")
        if self.quant not in QUANT_BITS:
            raise ValueError(f"unknown quant {self.quant!r}; expected one "
                             f"of {tuple(QUANT_BITS)}")
        if self.agg_clocks < 1:
            raise ValueError("agg_clocks must be >= 1")
        if not (0.0 < self.topk_frac <= 1.0):
            raise ValueError("topk_frac must be in (0, 1]")
        if self.comm_active:
            if self.model in ("bsp", "vap"):
                raise ValueError(
                    f"the comm substrate does not apply to {self.model!r}: "
                    "bsp's barrier is a full-state sync and vap's value "
                    "bound needs a synchronous full-precision channel — "
                    "use ssp/essp/async")
            if self.n_pods < 2:
                raise ValueError("the comm substrate compresses the "
                                 "cross-pod wire; it requires n_pods >= 2")

    @property
    def comm_active(self) -> bool:
        """Does this config route cross-pod shipment through the comm
        substrate?  ``wire`` overrides; otherwise any non-default comm
        knob turns it on."""
        if self.wire is not None:
            return bool(self.wire)
        return (self.quant != "f32" or self.agg_clocks > 1
                or self.topk_frac < 1.0)

    @property
    def effective_window(self) -> int:
        """Size of the update ring buffer (clocks kept before folding)."""
        if self.window is not None:
            return self.window
        agg = self.agg_clocks - 1 if self.comm_active else 0
        if self.model == "bsp":
            return 2
        if self.model in ("async", "vap"):
            return (self.staleness + self.s_xpod + agg
                    + self.max_extra_delay + 2)
        return self.staleness + self.s_xpod + agg + 2

    @property
    def family(self) -> tuple:
        """Static structure shared by configs that the JAX sweep engine
        compiles together; the port's `sweep` groups by it and harmonizes
        each group's window."""
        key = (self.model, bool(self.read_my_writes),
               int(self.max_extra_delay), int(self.n_pods),
               self.comm_active)
        if self.comm_active:
            key += (self.quant,)
        if self.model in ("async", "vap"):
            key += (self.effective_window,)
        return key

    def replace(self, **kw) -> "ConsistencyConfig":
        return dataclasses.replace(self, **kw)


def bsp(**kw) -> ConsistencyConfig:
    return ConsistencyConfig(model="bsp", staleness=0, **kw)


def ssp(staleness: int, **kw) -> ConsistencyConfig:
    return ConsistencyConfig(model="ssp", staleness=staleness, **kw)


def essp(staleness: int, **kw) -> ConsistencyConfig:
    return ConsistencyConfig(model="essp", staleness=staleness, **kw)


def vap(v0: float, **kw) -> ConsistencyConfig:
    return ConsistencyConfig(model="vap", v0=v0, **kw)


def podded(cfg: ConsistencyConfig, n_pods: int, s_xpod: int = 0,
           t_net_xpod: float | None = None,
           t_net_intra: float | None = None) -> ConsistencyConfig:
    """Lift a flat config onto ``n_pods`` pods with a second network tier
    (``s_xpod`` extra cross-pod staleness; ``t_net_*`` mean delivery
    delays in clocks, 1.0 when not given)."""
    kw = dict(n_pods=n_pods, s_xpod=s_xpod)
    if t_net_xpod is not None:
        kw["t_net_xpod"] = t_net_xpod
    if t_net_intra is not None:
        kw["t_net_intra"] = t_net_intra
    return cfg.replace(**kw)


def compressed(cfg: ConsistencyConfig, agg_clocks: int = 1,
               topk_frac: float = 1.0,
               quant: str = "f32") -> ConsistencyConfig:
    """Route ``cfg``'s cross-pod shipment through the comm substrate:
    one aggregated shipment every ``agg_clocks`` clocks, of the
    ``topk_frac`` largest coordinates, in ``quant`` wire values."""
    return cfg.replace(agg_clocks=agg_clocks, topk_frac=topk_frac,
                       quant=quant, wire=True)
