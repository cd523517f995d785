"""Mixture-of-Experts layer: top-k routing with per-sequence capacity.

The JAX package's ``models/moe.py`` on tensors.  Each sequence is a block
of ``S·top_k`` assignments; an assignment takes the next free slot of its
expert's ``C`` slots in position order (the earliest tokens win capacity,
GShard's rule), or is dropped; the tokens are scattered into
``[B, E·C (+1 drop row), d]``, run through every expert's swiglu as three
batched products, gathered back and weighted by their renormalised gates.
``C = ceil(S·top_k/E · capacity_factor)`` (rounded up to a multiple of 4)
is a Python int of the static ``S``, as in JAX, and the dispatch makes no
host sync (no ``nonzero``, boolean-mask indexing or ``.item()``), so a
decode step on the card runs without one.  At ``S = 1`` (decode) ``C`` is
1 and every expert runs on every sequence, as JAX's layer does.

The router is float32, as in JAX.  ``lax.top_k`` picks the lower expert
first among equal probabilities; a stable descending sort does the same
(``torch.topk`` does not promise it).  `recording` collects each layer's
routing, `routing_agreement` compares two runs' routings and `forcing`
makes a run take another's, for the parity checks: a router near tie is
a rounding decision that may flip between two correct runs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..kernels.ref import acc_dtype
from .params import spec

# The list `recording` fills with each moe_forward's routing, or None.
_TAP: list | None = None
# The routings `forcing` makes moe_forward take, in call order, or None.
_FORCE: list | None = None


def moe_spec(cfg: MoEConfig, d_model: int, dtype=torch.float32):
    E, ff = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": spec((d_model, E), ("embed", "experts"), scale=0.02,
                       dtype=torch.float32),   # router kept in f32
        "wi_gate": spec((E, d_model, ff), ("experts", "embed", "mlp"),
                        dtype=dtype),
        "wi_up": spec((E, d_model, ff), ("experts", "embed", "mlp"),
                      dtype=dtype),
        "wo": spec((E, ff, d_model), ("experts", "mlp", "embed"),
                   dtype=dtype),
    }
    if cfg.n_shared:
        sff = ff * cfg.n_shared
        p["shared_wi_gate"] = spec((d_model, sff), ("embed", "mlp"),
                                   dtype=dtype)
        p["shared_wi_up"] = spec((d_model, sff), ("embed", "mlp"),
                                 dtype=dtype)
        p["shared_wo"] = spec((sff, d_model), ("mlp", "embed"), dtype=dtype)
    return p


def _capacity(S: int, cfg: MoEConfig) -> int:
    c = int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    c = -(-c // 4) * 4 if c > 4 else c      # round up to multiple of 4
    return min(max(c, 1), S)


def top_k(probs, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch_slots(eidx, E: int, C: int):
    """Per-sequence dispatch slots of ``eidx [B, S, K]``, flattened in
    position order (an assignment takes the next free slot of its expert,
    so the earliest tokens win capacity): ``(slot [B, S·K], keep [B,
    S·K])``, ``slot`` in ``[0, E·C)`` where kept and ``E·C`` (the drop row)
    where the expert's ``C`` slots are taken."""
    B = eidx.shape[0]
    e_flat = eidx.reshape(B, -1)                             # [B, N]
    # the one-hot [B, E, N]: the running count along its last, contiguous
    # axis (a scan along a strided axis is several times slower on CUDA)
    oh = (torch.arange(E, device=eidx.device)[:, None]
          == e_flat[:, None, :]).to(torch.int32)
    pos_in_e = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh
    slot_pos = torch.gather(pos_in_e, 1, e_flat[:, None, :])[:, 0]
    keep = slot_pos < C
    return torch.where(keep, e_flat * C + slot_pos, E * C), keep


def moe_forward(p, cfg: MoEConfig, x):
    """x [B, S, d] -> (y [B, S, d], aux_loss float32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(S, cfg)
    cdt = x.dtype
    rt = acc_dtype(cdt)
    logits = x.to(rt) @ p["router"].to(rt)                    # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, K)                              # [B,S,K]
    if _TAP is not None:
        _TAP.append(_record(p, x, logits, eidx))
    if _FORCE is not None:
        eidx = _FORCE.pop(0)["eidx"].to(x.device)
        gate = torch.gather(probs, -1, eidx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # ---- load-balance auxiliary loss (Switch-style) ----------------------
    me = probs.mean(dim=(0, 1))                              # mean router prob
    top1 = eidx[..., 0, None] == torch.arange(E, device=x.device)
    ce = top1.float().mean(dim=(0, 1))                       # expert load
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    # ---- per-block dispatch slots, in position order ----------------------
    slot, keep = dispatch_slots(eidx, E, C)                  # [B, N]
    g_flat = gate.reshape(B, S * K).to(cdt)

    # ---- dispatch: scatter tokens into [B, E*C(+1), d] --------------------
    tok = x.repeat_interleave(K, dim=1)                      # [B, N, d]
    idx = slot[..., None].expand(B, S * K, d)
    xe = torch.zeros((B, E * C + 1, d), dtype=cdt, device=x.device)
    xe.scatter_(1, idx, tok)
    xe = xe[:, :E * C].reshape(B, E, C, d)

    # ---- expert computation ----------------------------------------------
    h_g = torch.einsum("becd,edf->becf", xe, p["wi_gate"].to(cdt))
    h_u = torch.einsum("becd,edf->becf", xe, p["wi_up"].to(cdt))
    h = F.silu(h_g) * h_u
    ye = torch.einsum("becf,efd->becd", h, p["wo"].to(cdt))

    # ---- combine: gather back and weight by gate --------------------------
    ye_flat = torch.cat([ye.reshape(B, E * C, d),
                         torch.zeros((B, 1, d), dtype=cdt, device=x.device)],
                        dim=1)
    back = torch.gather(ye_flat, 1, idx)                     # [B, N, d]
    back = back * (g_flat * keep.to(cdt))[..., None]
    y = back.reshape(B, S, K, d).sum(dim=2)

    # ---- shared experts (DeepSeek-style, always on) -----------------------
    if "shared_wi_gate" in p:
        sg = x @ p["shared_wi_gate"].to(cdt)
        su = x @ p["shared_wi_up"].to(cdt)
        y = y + (F.silu(sg) * su) @ p["shared_wo"].to(cdt)
    return y, aux


def _record(p, x, logits, eidx):
    """One layer's routing: ``eidx [B,S,K]``, the router ``logits`` and
    ``bound [B,S]``, the largest ``|x| @ |W_router|`` of each token (what a
    relative change of the router input can move a logit by, per unit)."""
    bound = (x.float().abs() @ p["router"].float().abs()).amax(-1)
    return {"eidx": eidx, "logits": logits, "bound": bound}


@contextlib.contextmanager
def recording():
    """Collect the routing of every `moe_forward` call in the block, in
    call order (each a dict of ``eidx``, ``logits``, ``bound``)."""
    global _TAP
    outer, _TAP = _TAP, []
    try:
        yield _TAP
    finally:
        _TAP = outer


@contextlib.contextmanager
def forcing(routes):
    """Make the `moe_forward` calls in the block take the experts of
    ``routes`` (another run's `recording` entries, one per call, in call
    order) in place of their own top-k, each gate its own probability of
    the expert taken, renormalised; `recording` still records the call's
    own choice.  ``None`` forces nothing.  For the parity checks: a
    router near tie is a rounding decision, and one run forced to
    another's routing computes the same function as it, so every
    sequence can be held."""
    global _FORCE
    outer, _FORCE = _FORCE, None if routes is None else list(routes)
    try:
        yield
        if _FORCE:
            raise ValueError(f"{len(_FORCE)} forced routings were not taken")
    finally:
        _FORCE = outer


def routing_agreement(got, want, rel_budget: float):
    """Compare two runs' routings of the same layers (lists of `recording`
    entries, one per layer, on the same tokens).

    Returns ``(same [B] bool, flips)``: ``same[b]`` is True where every
    token of sequence b took the same experts in the same order in every
    layer; ``flips`` lists each token that did not, as ``(layer, b, s,
    margin, budget)``: the ``want`` run's logit margin between its j-th and
    (j+1)-th choices at the first rank j where the two differ, and
    ``rel_budget`` times that token's ``bound`` (how far a relative error
    of ``rel_budget`` in the router input can move a logit).  A flip with
    ``margin > budget`` is not a near tie."""
    B = want[0]["eidx"].shape[0]
    same = torch.ones(B, dtype=torch.bool)
    flips = []
    for layer, (g, w) in enumerate(zip(got, want, strict=True)):
        ge, we = g["eidx"].cpu(), w["eidx"].cpu()
        diff = ge != we                                      # [B,S,K]
        same &= ~diff.flatten(1).any(1)
        if not bool(diff.any()):
            continue
        logits = w["logits"].float().cpu()
        ranked = torch.sort(logits, dim=-1, descending=True, stable=True)
        bound = w["bound"].float().cpu()
        for b, s in {(int(b), int(s)) for b, s, _ in diff.nonzero()}:
            j = int(diff[b, s].int().argmax())
            margin = float(ranked.values[b, s, j] - ranked.values[b, s, j + 1])
            flips.append((layer, b, s, margin,
                          rel_budget * float(bound[b, s])))
    return same, sorted(flips)
