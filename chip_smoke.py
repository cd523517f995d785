#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; never
JAX or the JAX package).  Six phases, one JSON line each (or more):

1. device and build: the card's name and power limit, then ``nvcc``
   builds the kernels from ``src/repro_torch/kernels/csrc``;
2. every hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes, with its time, the
   plain version's time, a one-call library yardstick where there is one
   and the least time the card could take for the bytes these inputs need
   (over the H100 SXM data-sheet rates).  ``delta_pack`` must be
   bit-equal for f32, bf16 and int8; the comm substrate's threshold
   selection is timed beside the other exact selections;
   ``flash_attention`` (at the models' prefill shape, beside one
   ``scaled_dot_product_attention`` call as the library yardstick) and
   ``ssd`` (at mamba2-130m's prefill shape) are held to their plain
   versions at the main path's shapes and at edge shapes (each record
   naming the kernel that ran, ``variant``; at ``main`` the kernel's ptxas
   lines, which must show no spills for ``ssd``, the wgmma attention
   kernel's tile classes, and planted faults the limits must fail: two
   for attention, two for ssd's y at ``main`` and ``carry``, two for its
   state), and at the shapes of the JAX package's ``kernels`` suite;
   ``mf_sgd_block`` (``check_mf_sgd``) is driven through
   ``ops.mf_sgd_block`` at the dense block of the full-width MF data
   (``main``, NaN at every unobserved rating) and at the ``kernels``
   suite's shape, with the launch counts set to 0 just before and read
   just after, then held to its plain version within
   ``ref.mf_sgd_tolerance`` (which must fail four planted faults at
   ``main``), bit-equal across two calls, at edge shapes and the mask
   compaction's cases too; at ``main`` each of its kernels' device time
   from a profiled call and their ptxas lines (no spills);
3. the main path at full width: MF-SGD at the paper's Netflix rank and
   item count through ``simulate`` under ``essp(3)`` and ``vap(0.5)``,
   and through the comm substrate under two-pod ``essp(2)`` with int8
   top-k shipments every 2 clocks; each kernel must be launched as often
   as its path needs (``ring_view`` and ``vap_suffix_norms`` once per
   clock, on the wired path ``ring_view`` twice and ``delta_pack`` once
   per shipping clock), the clock loop must not synchronize with the
   host, the traces must be finite, the loss falling and the (widened)
   staleness bound kept; a profiled run gives the per-clock device time
   of the kernels, of the threshold selection and of the rest, and the
   device's idle share in that same run;
4. the default MF config on the card against the same run on the CPU,
   dense and wired: integer Trace fields and ``ship_floats`` equal, float
   fields within the ulp budget.  A wired run's float fields are held to
   the budget up to the first shipment whose wire values differ between
   the two runs: a quantized value is a rounding decision, and one that
   flips on float drift within the budget (checked) moves the run by a
   whole quantization step, as a flipped VAP decision would;
5. the serving path at full width and depth (``serve_path``): qwen3-0.6b
   and mamba2-130m with random weights from a seed, batch 8, a 2048-token
   prompt from ``token_batch`` and 32 new tokens, through
   ``repro_torch.launch.serve``: prefill and decode times and rates, peak
   memory, the kernels' launches per prefill (``flash_attention`` once
   per qwen3 layer, ``ssd`` once per mamba2 layer), no host sync in the
   decode loop, and the device's idle share and each kernel's device ms
   per prefill from profiled runs;
6. both models' smoke configs on the card against the CPU
   (``serve_card_vs_cpu``): prefill and teacher-forced decode logits within
   the stated tolerance, greedy tokens equal wherever the CPU's top-2
   margin exceeds it.

Then the ``kernels`` summary line, the card's ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a GPU, or without the repository beside it, the script
exits non-zero before printing any result.  Everything it prints also goes
to ``chiprun_out/chip_smoke.jsonl``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.jsonl"

# Full-width MF-SGD: the paper's Netflix setting (rank K=100, 17,770
# movies, 100.5 M ratings over 480,189 x 17,770 -> density 0.0118), with
# the users cut to 32,768 because the synthetic app builds the dense
# ratings matrix (480,189 x 17,770 floats would be 34 GB).  d = (32,768 +
# 17,770) * 100 = 5,053,800 (d % 128 = 104: ragged).  lr stays 0.7: it
# converges at this batch/row ratio.
FULL_MF = dict(n_rows=32768, n_cols=17770, rank=100, density=0.0118,
               n_workers=8, batch=8192)
FULL_CLOCKS = 30
FULL_VAP_V0 = 0.5
SMALL_CLOCKS = 20
SMALL_VAP_V0 = 0.3
# The wired main path: a point of benchmarks/comm_bench.py's grid (equal
# total cross-pod staleness of 6: s = 2, s_xpod = 3, agg_clocks - 1 = 1),
# int8 values of the top 1/16 of each aggregated row.
WIRED_TOPK = 0.0625


def wired_cfg(cc):
    return cc.compressed(cc.podded(cc.essp(2), 2, s_xpod=3, t_net_xpod=8.0),
                         agg_clocks=2, topk_frac=WIRED_TOPK, quant="int8")


def small_wired_cfgs(cc):
    return {"essp3_wired_int8": cc.compressed(
                cc.podded(cc.essp(3), 2, s_xpod=2), 2, 0.25, "int8"),
            "ssp2_wired_bf16": cc.compressed(
                cc.podded(cc.ssp(2), 2, s_xpod=2), 3, 0.5, "bf16")}

# The card the port runs on, as torch names it, with its data-sheet peak
# memory rate (bytes/s), float32 rate outside the tensor cores and dense
# bf16 tensor-core rate (FLOP/s): NVIDIA H100 SXM, at its full 700 W power
# limit.
CARD = ("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 989e12)

# flash_attention's phase shapes: (B, Sq, Sk, H, Hkv, Dk, Dv, causal,
# window, dtype, positions).  "main" is qwen3-0.6b's prefill (batch 8,
# 2048-token prompt, bf16); then float32, a window, Dv != Dk, a padded Sk,
# rows that see no key ("late_keys"), masked keys ("holes") and keys at a
# random permutation of their slots ("shuffled").  The "bf16_d*" cases
# test the wgmma kernel's tile classes (skip, full, partial): holes,
# shuffled keys, a window of 100 cutting through its 128-key tiles, a
# short query block over long keys, ragged Sq = Sk = 333.
ATTN_SHAPES = {
    "main": (8, 2048, 2048, 16, 8, 128, 128, True, None, "bf16", "arange"),
    "f32": (2, 128, 128, 4, 2, 32, 32, True, None, "f32", "arange"),
    "f32_d128_window": (2, 300, 300, 16, 8, 128, 128, True, 64, "f32",
                        "arange"),
    "mqa_dv16": (2, 64, 256, 4, 1, 32, 16, True, None, "f32", "arange"),
    "bf16_padded_sk": (2, 100, 157, 16, 8, 128, 128, True, None, "bf16",
                       "arange"),
    "bf16_window": (2, 512, 512, 16, 8, 128, 128, True, 128, "bf16",
                    "arange"),
    "no_visible_key": (2, 64, 64, 4, 2, 32, 32, True, None, "bf16",
                       "late_keys"),
    "holes": (2, 96, 96, 4, 2, 64, 64, False, None, "f32", "holes"),
    "bf16_d128_holes": (2, 256, 256, 4, 2, 128, 128, True, None, "bf16",
                        "holes"),
    "bf16_d128_noncausal": (2, 200, 300, 4, 2, 128, 128, False, None,
                            "bf16", "arange"),
    "bf16_d128_window100": (2, 384, 384, 4, 2, 128, 128, True, 100, "bf16",
                            "arange"),
    "bf16_d128_shuffled": (2, 256, 384, 4, 2, 128, 128, True, None, "bf16",
                           "shuffled"),
    "bf16_d64_late_keys": (2, 200, 200, 4, 2, 64, 64, True, None, "bf16",
                           "late_keys"),
    "bf16_d128_sq64_sk2048": (1, 64, 2048, 4, 2, 128, 128, True, None,
                              "bf16", "arange"),
    "bf16_d128_ragged333": (1, 333, 333, 4, 2, 128, 128, True, None, "bf16",
                            "arange"),
    # the shape of the JAX package's kernels suite (benchmarks/kernels_bench)
    "kernels_bench": (1, 512, 512, 8, 4, 64, 64, True, None, "f32",
                      "arange"),
}
ATTN_TILE = 128     # the wgmma kernel's query block and KV tile
# ssd's phase shapes: (b, s, h, p, g, n, chunk, dtype, dt).  "main" is
# mamba2-130m's prefill (batch 8, 2048 tokens, h 24, headdim 64, 3 groups,
# d_state 128, chunk 128, bf16); then a ragged s, float32, and dt in
# mamba2's init range ("mamba"), where the state carries across chunks (at
# dt = softplus(N(0, 1)) a 128-long chunk decays it by about e^-100).
SSD_SHAPES = {
    "main": (8, 2048, 24, 64, 3, 128, 128, "bf16", "softplus"),
    "carry": (2, 2048, 24, 64, 3, 128, 128, "bf16", "mamba"),
    "ragged": (2, 2000, 24, 64, 3, 128, 128, "bf16", "softplus"),
    "f32_ragged": (2, 300, 24, 64, 3, 128, 128, "f32", "softplus"),
    "smoke_ragged": (4, 100, 16, 32, 2, 32, 32, "bf16", "softplus"),
    # the shape of the JAX package's kernels suite (benchmarks/kernels_bench)
    "kernels_bench": (1, 1024, 8, 64, 1, 64, 128, "f32", "softplus"),
}
# the cases at which ssd's y limit must fail its two planted faults
SSD_Y_FAULT_CASES = ("main", "carry")
# mf_sgd_block's phase cases: (N, M, K, density, gamma, lam, pattern),
# inputs N(0, 1) from a seed with NaN at every unobserved rating.  "main"
# is the dense block of the full-width MF data (FULL_MF, built by
# `mf_block`), "kernels_bench" the JAX package's kernels suite's shape;
# then the JAX kernel test's shapes, ragged N and M, the smallest block, K
# past 128 and at the kernel's limit of 256, an empty and a full block;
# then the cases of the mask's compaction (`mf_mask`): the Netflix density
# at K = 100 over a few 2048-column batches, M odd (rows start at every
# byte offset), one 64 x 64 block fully observed among empty ones, one
# row fully observed among sparse ones, and one entry at the last row and
# column of a ragged block.
MF_CASES = {
    "kernels_bench": (512, 512, 32, 0.2, 0.1, 1e-3, "random"),
    "jax_256_256_16": (256, 256, 16, 0.3, 0.1, 1e-3, "random"),
    "jax_128_384_32": (128, 384, 32, 0.3, 0.1, 1e-3, "random"),
    "jax_128_128_8": (128, 128, 8, 0.3, 0.1, 1e-3, "random"),
    "ragged": (100, 300, 12, 0.3, 0.1, 1e-3, "random"),
    "one": (1, 1, 1, 1.0, 0.1, 1e-3, "random"),
    "k130": (70, 150, 130, 0.3, 0.1, 1e-3, "random"),
    "k256": (200, 300, 256, 0.3, 0.1, 1e-3, "random"),
    "empty": (100, 300, 12, 0.0, 0.1, 1e-3, "random"),
    "full": (130, 270, 20, 1.0, 0.1, 1e-3, "random"),
    "netflix_density": (1024, 2048 * 3 + 100, 100, 0.0118, 0.7, 1e-4,
                        "random"),
    "odd_m": (300, 1001, 100, 0.05, 0.1, 1e-3, "random"),
    "one_block": (256, 600, 32, 0.0, 0.1, 1e-3, "block"),
    "one_row": (200, 3000, 64, 0.01, 0.1, 1e-3, "row"),
    "last_entry": (130, 333, 16, 0.0, 0.1, 1e-3, "last"),
}
MF_TILE = 128       # the columns planted fault (b) leaves out

# The serving path: both ported families at full width and depth.
SERVE_ARCHS = ("qwen3-0.6b", "mamba2-130m")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
# Card against CPU on the smoke configs: logits within this share of their
# largest magnitude.  float32: the products run in full float32 on both
# (no TF32), in other orders.  bfloat16: both round every product to
# bfloat16, at the same points, but a sum taken in another order can land
# one bfloat16 step away, and two layers carry it on (the port against the
# JAX package on the CPU stays within 0.6 %).
SERVE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 4, 100, 8

_lines: list[str] = []


def emit(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s, bf16 tensor FLOP/s) of the card."""
    if name != CARD[0]:
        raise RuntimeError(f"no data-sheet rates for {name!r}; the bounds "
                           f"are stated for {CARD[0]}")
    return CARD[1], CARD[2], CARD[3]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0].strip()


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the entry
    function (mangled name), its registers and its spills."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ring_inputs(W, P, d, n_empty, seed, device, c=1000):
    """A ring whose slots hold clocks c-1..c-W (n_empty of them empty),
    random updates and random visibility clocks, made from a seed."""
    import torch
    from repro_torch.kernels.ref import RING_EMPTY
    gd = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(d, generator=gd, device=device)
    uring = 0.01 * torch.randn((W, P, d), generator=gd, device=device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    uclock = c - 1 - torch.randperm(W, generator=g).to(torch.int32)
    uclock[torch.randperm(W, generator=g)[:n_empty]] = RING_EMPTY
    cview = torch.randint(c - W - 2, c, (P, P), generator=g,
                          dtype=torch.int32)
    return base, uring, uclock.to(device), cview.to(device), c


def visibility(uclock, cview):
    """[reader, slot, producer] float32: 1 where reader r sees ring row
    (w, q), as ring_view's contract defines it."""
    import torch
    from repro_torch.kernels.ref import RING_INVALID
    return (((uclock[None, :, None] <= cview[:, None, :])
             & (uclock > RING_INVALID)[None, :, None]).to(torch.float32))


def kernel_bounds(uclock, cview, c, P, d, rates):
    """Least time (ms) for each kernel's work on these inputs: each input
    byte it needs read once, each output written once, over the memory
    rate; its float operations over the float32 rate; the larger bounds it.

    The work depends on the data: ``ring_view`` reads only the ring rows
    that some reader sees and adds each into every reader that sees it;
    ``vap_suffix_norms`` reads only the slots that hold clocks c-W..c-1."""
    bw, flops, _ = rates
    W = uclock.numel()
    vis = visibility(uclock, cview)
    rows_seen = int(vis.amax(dim=0).sum().item())        # (w, q) rows read
    adds = int(vis.sum().item())                         # (r, w, q) adds
    slots = int(((uclock >= c - W) & (uclock <= c - 1)).sum().item())
    rv_bytes = (rows_seen * d + P * d + d) * 4 + (W + P * P) * 4
    vs_bytes = slots * P * d * 4 + W * 4 + (W + 1) * P * 4
    # vap: one add per slot read, one abs-and-max per k, per column
    rv_ops, vs_ops = adds * d, (slots + 2 * W) * P * d
    out = {}
    for name, nbytes, ops in (("ring_view", rv_bytes, rv_ops),
                              ("vap_suffix_norms", vs_bytes, vs_ops)):
        t_b, t_o = nbytes / bw * 1e3, ops / flops * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def check_kernels(shape, device, rates, timed: bool):
    """Both kernels against their plain versions on one ring shape."""
    import torch
    from repro_torch.kernels import ps_view, ref
    W, P, d, n_empty = shape
    base, uring, uclock, cview, c = ring_inputs(W, P, d, n_empty,
                                                seed=W * 1000 + P, device=device)
    got = ps_view.ring_view(base, uring, uclock, cview)
    want = ref.ring_view(base, uring, uclock, cview)
    torch.cuda.synchronize()
    rv_err = (got - want).abs().max().item()
    rv_tol = ref.ring_view_tolerance(base, uring)
    got_n = ps_view.vap_suffix_norms(uring, uclock, c)
    want_n = ref.vap_suffix_norms(uring, uclock, c)
    torch.cuda.synchronize()
    vs_err = (got_n - want_n).abs().max().item()
    del got, want, got_n, want_n
    rec = {"phase": "kernels", "W": W, "P": P, "d": d, "empty_slots": n_empty,
           "ring_view": {"max_abs_err": rv_err, "tol": rv_tol},
           "vap_suffix_norms": {"max_abs_err": vs_err, "tol": 0.0}}
    if rv_err > rv_tol or vs_err > 0.0:
        emit(rec)
        raise AssertionError(f"kernel disagrees with its plain version at "
                             f"W={W} P={P} d={d}: {rec}")
    if timed:
        vis = visibility(uclock, cview)
        bounds = kernel_bounds(uclock, cview, c, P, d, rates)
        rec["ring_rows_read"] = int(vis.amax(dim=0).sum().item())
        rec["ring_view"].update(
            ms=time_ms(lambda: ps_view.ring_view(base, uring, uclock, cview),
                       20),
            plain_ms=time_ms(lambda: ref.ring_view(base, uring, uclock,
                                                   cview), 5),
            library_ms=time_ms(lambda: torch.einsum("rwq,wqd->rd", vis,
                                                    uring), 20),
            bound_ms=bounds["ring_view"][0], bound_by=bounds["ring_view"][1])
        rec["vap_suffix_norms"].update(
            ms=time_ms(lambda: ps_view.vap_suffix_norms(uring, uclock, c), 20),
            plain_ms=time_ms(lambda: ref.vap_suffix_norms(uring, uclock, c),
                             3),
            library_ms=None,
            bound_ms=bounds["vap_suffix_norms"][0],
            bound_by=bounds["vap_suffix_norms"][1])
    emit(rec)
    return rec


def pack_inputs(P, d, topk_frac, kind, quant, seed, device):
    """``(delta, thresh, scale)`` on the card for one ``delta_pack`` case,
    made from a seed; thresh and scale as the comm substrate computes
    them.  ``kind``: ``normal``, ``ties`` (many |delta| equal to the
    threshold), ``above`` (a threshold above every value), ``zeros`` (a
    row of zeros: the int8 scale's 1e-12 clamp), ``halves`` (int8
    quotients at exactly n + 1/2) or ``unaligned`` (a row start that is
    not 16-byte aligned: the scalar path)."""
    import torch
    from repro_torch.comm import substrate
    gd = torch.Generator(device=device).manual_seed(seed)
    delta = 2.0 * torch.randn((P, d), generator=gd, device=device)
    if kind == "ties":
        delta = torch.round(delta * 2) / torch.full((), 2.0, device=device)
    elif kind == "zeros":
        delta[0] = 0.0
    elif kind == "halves":          # scale 1/8 exactly, delta/s = n + 1/2
        n = torch.randint(-127, 127, (P, d), generator=gd, device=device)
        delta = (n + 0.5) * 0.125
        delta[:, 0] = 127 * 0.125
    elif kind == "unaligned":
        buf = torch.empty(P * d + 1, device=device)
        buf[1:] = delta.reshape(-1)
        delta = buf[1:].view(P, d)
    thresh = substrate.row_threshold(delta, topk_frac)
    if kind == "above":
        thresh = delta.abs().amax(dim=-1) * 2 + 1
    return delta, thresh, substrate.quant_scale(delta, quant)


def check_delta_pack(P, d, topk_frac, kind, device, rates, timed: bool):
    """``delta_pack`` against its plain version for f32, bf16 and int8,
    bit for bit (tolerance 0); timed at the main path's shape."""
    import torch
    from repro_torch.kernels import delta_pack as dp
    from repro_torch.kernels import ref
    rec = {"phase": "kernels", "kernel": "delta_pack", "P": P, "d": d,
           "topk_frac": topk_frac, "case": kind}
    for quant in ("f32", "bf16", "int8"):
        delta, thresh, scale = pack_inputs(P, d, topk_frac, kind, quant,
                                           seed=d + P, device=device)
        got = dp.delta_pack(delta, thresh, scale, quant)
        want = ref.delta_pack(delta, thresh, scale, quant)
        torch.cuda.synchronize()
        diff = [int((g.view(torch.int32) != w.view(torch.int32)).sum())
                for g, w in zip(got, want, strict=True)]
        err = max((g - w).abs().max().item()
                  for g, w in zip(got, want, strict=True))
        q = {"bits_differ": diff, "max_abs_err": err, "tol": 0.0}
        if quant == "f32":
            q["mass_exact"] = bool(torch.equal(got[0] + got[1], delta))
        del got, want
        rec[quant] = q
        if any(diff) or q.get("mass_exact") is False:
            emit(rec)
            raise AssertionError(f"delta_pack disagrees with its plain "
                                 f"version ({quant}, P={P}, d={d}, {kind})")
        if timed:
            bw, flops, _ = rates
            # delta read once, wire and residual written once, thresh and
            # scale read once; about six operations per element
            t_b = (3 * P * d * 4 + 2 * P * 4) / bw * 1e3
            t_o = 6 * P * d / flops * 1e3
            q.update(
                ms=time_ms(lambda: dp.delta_pack(delta, thresh, scale,
                                                 quant), 20),
                plain_ms=time_ms(lambda: ref.delta_pack(delta, thresh, scale,
                                                        quant), 5),
                library_ms=None, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")
        del delta, thresh, scale
    emit(rec)
    return rec


def time_selection(P, d, topk_frac, device):
    """The comm substrate's threshold selection (``row_threshold``, a
    ``torch.topk``) on a full ``[P, d]`` row block, beside the other exact
    selections of the k-th largest ``|delta|``: each must give the same
    floats; their times."""
    import torch
    from repro_torch.comm import substrate
    gd = torch.Generator(device=device).manual_seed(7)
    delta = 0.01 * torch.randn((P, d), generator=gd, device=device)
    k = substrate.topk_count(topk_frac, d)
    others = {
        "sort": lambda m: torch.sort(m, dim=-1).values[:, d - k],
        "kthvalue": lambda m: torch.kthvalue(m, d - k + 1, dim=-1).values}
    want = substrate.row_threshold(delta, topk_frac)
    rec = {"phase": "threshold_selection", "P": P, "d": d,
           "topk_frac": topk_frac, "k": k, "ms": {"topk": time_ms(
               lambda: substrate.row_threshold(delta, topk_frac), 5)}}
    for name, fn in others.items():
        if not torch.equal(fn(delta.abs()), want):
            emit(rec)
            raise AssertionError(f"threshold selection {name!r} disagrees "
                                 f"with row_threshold")
        rec["ms"][name] = time_ms(lambda f=fn: f(delta.abs()), 5)
    rec["quant_scale_ms"] = time_ms(
        lambda: substrate.quant_scale(delta, "int8"), 10)
    rec["selected_count_ms"] = time_ms(
        lambda: substrate.selected_count(delta, want), 10)
    emit(rec)
    return rec


def assert_finite(trace, what):
    import torch
    for f in ("loss_ref", "loss_view", "u_l2", "intransit_inf", "ship_floats",
              "x_final"):
        if not torch.isfinite(getattr(trace, f)).all():
            raise AssertionError(f"{what}: Trace.{f} is not finite")


KERNEL_NAMES = ("ring_view_kernel", "vap_suffix_norms_kernel",
                "delta_pack_vec4", "delta_pack_scalar")
# the aten op of the comm substrate's threshold selection, whose device
# time (its kernels included) the profiled run reports apart
SELECTION_OP = "aten::topk"


def expected_launches(cfg, n_clocks):
    """Launches per kernel in ``n_clocks`` of ``simulate`` under ``cfg``:
    the wired path views two rings per clock and packs once per shipping
    clock."""
    from repro_torch.comm import substrate
    if not cfg.comm_active:
        return {"ring_view": n_clocks, "vap_suffix_norms": n_clocks,
                "delta_pack": 0, "flash_attention": 0, "ssd": 0,
                "mf_sgd_block": 0}
    ships = sum(substrate.ship_now(c, cfg.agg_clocks)
                for c in range(n_clocks))
    return {"ring_view": 2 * n_clocks, "vap_suffix_norms": n_clocks,
            "delta_pack": ships, "flash_attention": 0, "ssd": 0,
            "mf_sgd_block": 0}


def device_split(app, cfg, n_clocks):
    """Device time per clock from a profiled run: all kernels, the port's
    kernels, the comm substrate's threshold selection, and the five ops
    that take the most of it; the host time per clock of the same run, and
    the share of it the device was idle.  The profiler's own host cost is
    inside that host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ps.simulate(app, cfg, n_clocks, seed=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_clocks
    busy = ours = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            if any(k in e.name for k in KERNEL_NAMES):
                ours += e.self_device_time_total
    if busy == 0.0:      # the profiler saw no device time: say so
        return {"profiled_ms_per_clock": wall_ms,
                "device_ms_per_clock": None, "kernel_ms_per_clock": None}
    averages = prof.key_averages()
    ops = sorted((e for e in averages if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:5]
    sel = sum(e.device_time_total for e in averages if e.key == SELECTION_OP)
    busy_ms = busy / 1e3 / n_clocks
    ours_ms, sel_ms = ours / 1e3 / n_clocks, sel / 1e3 / n_clocks
    return {"profiled_ms_per_clock": wall_ms,
            "device_ms_per_clock": busy_ms,
            "kernel_ms_per_clock": ours_ms,
            "selection_ms_per_clock": sel_ms,
            "rest_device_ms_per_clock": busy_ms - ours_ms - sel_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_ops_ms_per_clock": {
                e.key: e.self_device_time_total / 1e3 / n_clocks
                for e in ops}}


@contextlib.contextmanager
def watch_syncs():
    """Run the body under ``torch.cuda.set_sync_debug_mode("warn")``; yields
    a list that gets one ``(call site, function names)`` per operation that
    made the host wait for the device (a copy from the host, ``.item()``).
    An explicit ``torch.cuda.synchronize()`` is not one of them."""
    import warnings
    import torch
    found = []

    def on_warning(message, *_):
        if "synchroniz" in str(message):      # where the op was called
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            found.append((" <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                                      for f in frames[:-6:-1]),
                          [f.name for f in frames]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # set first: turning the mode on warns once about the mode itself
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = on_warning
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode("default")


def run_main_path(app, cfg, name, n_clocks):
    """One simulate run through the entry point, with the kernel counters
    set to 0 just before and read just after (after a 2-clock warm-up run
    that loads PyTorch's kernels), then a profiled run of as many clocks
    for the per-clock device split.  Each kernel must have been launched
    as often as :func:`expected_launches` says.

    The counted run also runs under ``torch.cuda.set_sync_debug_mode``:
    each operation that makes the host wait for the device (a copy from
    the host, ``.item()``) is recorded with its call site, and the phase
    fails after both configs if there was one."""
    import torch
    from repro_torch.convert import trace_to_numpy
    from repro_torch.core import ps, staleness
    from repro_torch.kernels import launch
    from repro_torch.pods import reconcile
    from repro_torch.psrun import validate
    ps.simulate(app, cfg, 2, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    t0 = time.perf_counter()
    with watch_syncs() as found:
        trace = ps.simulate(app, cfg, n_clocks, seed=0)
    syncs = [site for site, _ in found]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(launch.launches)
    if launches != expected_launches(cfg, n_clocks):
        raise AssertionError(f"{name}: launches {launches} in {n_clocks} "
                             f"clocks, expected "
                             f"{expected_launches(cfg, n_clocks)}")
    assert_finite(trace, name)
    tr = trace_to_numpy(trace)
    if not tr.loss_ref[-1] < tr.loss_ref[0]:
        raise AssertionError(f"{name}: loss_ref did not fall "
                             f"({tr.loss_ref[0]} -> {tr.loss_ref[-1]})")
    rec = {"phase": "main_path", "config": name, "clocks": n_clocks,
           "d": app.dim, "W": cfg.effective_window, "P": app.n_workers,
           "seconds": secs, "clocks_per_s": n_clocks / secs,
           "ms_per_clock": secs / n_clocks * 1e3, "launches": launches,
           "host_syncs": len(syncs), "host_sync_sites": sorted(set(syncs)),
           "loss_ref_first": float(tr.loss_ref[0]),
           "loss_ref_last": float(tr.loss_ref[-1]),
           "forced": int(tr.forced.sum()),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if cfg.model in ("ssp", "essp"):
        chk = validate.check_staleness_bound(tr, cfg)
        if chk["violations"]:
            raise AssertionError(f"{name}: staleness bound broken: {chk}")
        bins, probs = staleness.histogram(tr)
        rec["staleness_violations"] = chk["violations"]
        rec["staleness_hist"] = {int(b): float(p)
                                 for b, p in zip(bins, probs, strict=True)}
    if cfg.comm_active:
        div = reconcile.replica_divergence(tr, cfg)
        if not div["ok"]:
            raise AssertionError(f"{name}: replica divergence {div['max']} "
                                 f"over its bound {div['bound']}")
        stats = reconcile.reconcile_stats(tr, cfg, dim=app.dim)
        rec["replica_divergence"] = {"max": div["max"],
                                     "bound": div["bound"]}
        rec["reconcile"] = {k: stats[k] for k in (
            "eager_deliveries", "gated_pulls", "wire_floats",
            "dense_floats", "wire_compression")}
        rec["ship_floats_per_shipment"] = float(
            tr.ship_floats[tr.ship_floats > 0].mean())
    split = device_split(app, cfg, n_clocks)
    rec.update(split)
    if split["device_ms_per_clock"] is not None:
        # the profiler's host cost inflates the same-run share; this one
        # sets the profiled run's device time against the counted run's
        # host time (device time agrees within ~2 % between runs)
        rec["device_idle_share_cross_run"] = (
            1.0 - split["device_ms_per_clock"] / rec["ms_per_clock"])
    return rec


def simulate_recording_shipments(app, cfg, n_clocks):
    """``simulate`` through the entry point, keeping each shipment's
    ``(delta, wire)`` on the host (``substrate.pack`` is wrapped for the
    run)."""
    from repro_torch.comm import substrate
    from repro_torch.core import ps
    shipments, pack = [], substrate.pack

    def recording(delta, topk_frac, quant):
        out = pack(delta, topk_frac, quant)
        shipments.append((delta.cpu(), out[0].cpu()))
        return out

    substrate.pack = recording
    try:
        trace = ps.simulate(app, cfg, n_clocks)
    finally:
        substrate.pack = pack
    return trace, shipments


def first_wire_flip(got, want, budget_ulp):
    """The first shipment whose wire values differ between two runs, as
    ``{"shipment", "wire_values_differ", "max_delta_drift_ulp"}``, or None
    if every shipment is bit-equal.  The pack is a function of each delta
    row (bit-equal on the card and the CPU, phase 2), so a row whose wire
    differs must have a delta row that drifted, by at most the budget
    (ulp of the delta's scale): anything else raises."""
    import numpy as np
    import torch
    for i, ((dg, wg), (dw, ww)) in enumerate(zip(got, want, strict=True)):
        differ = wg.view(torch.int32) != ww.view(torch.int32)
        if not differ.any():
            continue
        rows = differ.any(dim=1)
        drift = (dg - dw).abs().amax(dim=1)[rows]
        spacing = float(np.spacing(np.float32(dw.abs().max())))
        if not ((drift > 0).all() and (drift <= budget_ulp * spacing).all()):
            raise AssertionError(f"shipment {i}: wire values differ on rows "
                                 f"whose delta drift {drift.tolist()} is 0 "
                                 f"or over the budget")
        return {"shipment": i, "wire_values_differ": int(differ.sum()),
                "max_delta_drift_ulp": float(drift.max()) / spacing}
    return None


def ulps_through(got, want, last_clock):
    """``trace_max_ulp`` of the per-clock fields over clocks
    0..``last_clock`` (``x_final``, of the end of the run, left out)."""
    import dataclasses
    from repro_torch.psrun import validate
    head = [dataclasses.replace(
        t, x_final=want.x_final,
        **{f: getattr(t, f)[:last_clock + 1]
           for f in validate.TRACE_FIELDS if f != "x_final"})
        for t in (got, want)]
    out = validate.trace_max_ulp(*head)
    del out["x_final"]
    return out


def attn_inputs(shape, seed, device):
    """``(q, k, v, q_pos, kv_pos)`` on the card for one attention shape,
    made from a seed; positions as `ATTN_SHAPES` names them."""
    import torch
    B, Sq, Sk, H, Hkv, Dk, Dv, _, _, dt, kind = shape
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gd = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gd, device=device).to(dtype)
               for s in ((B, Sq, H, Dk), (B, Sk, Hkv, Dk), (B, Sk, Hkv, Dv)))
    qp = (torch.arange(Sq, dtype=torch.int32, device=device)
          + (Sk - Sq)).expand(B, Sq).contiguous()
    kp = torch.arange(Sk, dtype=torch.int32, device=device).expand(
        B, Sk).contiguous()
    if kind == "late_keys":            # the first 5 queries see no key
        kp = kp + (5 + Sk - Sq)
    elif kind == "holes":              # a quarter of the keys masked
        holes = torch.randperm(Sk, generator=gd, device=device)[:Sk // 4]
        kp[:, holes] = -1
    elif kind == "shuffled":           # each batch row's keys permuted
        kp = torch.stack([torch.randperm(Sk, generator=gd, device=device)
                          for _ in range(B)]).to(torch.int32)
    return q, k, v, qp, kp


def attention_bound(q, k, v, qp, kp, causal, window, rates):
    """Least time (ms) for attention on these inputs: the products of the
    visible (query, key) pairs, 2·(Dk + Dv) FLOP each per head, over the
    tensor-core (bf16) or float32 rate, against q, k, v, the positions and
    the output read or written once over the memory rate."""
    import torch
    from repro_torch.kernels import ref
    bw, f32, bf16 = rates
    H, Dk, Dv = q.shape[2], q.shape[3], v.shape[3]
    pairs = int(ref._block_mask(qp, kp, causal, window).sum().item())
    ops = 2 * (Dk + Dv) * H * pairs
    nbytes = (q.numel() + q.numel() // Dk * Dv + k.numel() + v.numel()) \
        * q.element_size() + 4 * (qp.numel() + kp.numel())
    t_b = nbytes / bw * 1e3
    t_o = ops / (bf16 if q.dtype == torch.bfloat16 else f32) * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", pairs


def kernel_ptxas(source: str, entry: str) -> list[str]:
    """The ptxas lines (registers, shared memory, spills) of the kernels
    of ``csrc/<source>.cu`` whose name holds ``entry``, from the build's
    log."""
    from repro_torch.kernels import build
    log = (build._build_dir() / f"{source}.log").read_text()
    return [ln for ln in ptxas_report(log) if entry in ln]


def planted_attention_faults(q, k, v, qp, kp, kw, want, atol, rtol):
    """Max error of two faults made with the plain version, each of which
    the limit must fail: (a) one key tile dropped (keys 0-63 masked for
    the second half of the queries, rows that see over a thousand keys);
    (b) a partial tile treated as full (every query's position rounded up
    to the end of its 128-block, so it sees the whole diagonal tile)."""
    from repro_torch.kernels import ref
    h = q.shape[1] // 2
    kp_drop = kp.clone()
    kp_drop[:, :64] = -1
    faults = {
        "planted_fault_dropped_tile_err": (
            ref.attention(q[:, h:], k, v, **dict(kw, q_pos=qp[:, h:],
                                                 kv_pos=kp_drop)),
            want[:, h:]),
        "planted_fault_partial_as_full_err": (
            ref.attention(q, k, v, **dict(
                kw, q_pos=qp // ATTN_TILE * ATTN_TILE + ATTN_TILE - 1)),
            want)}
    errs, missed = {}, []
    for key, (bad, ref_out) in faults.items():
        fdiff = (bad.float() - ref_out.float()).abs()
        errs[key] = fdiff.max().item()
        if not bool((fdiff > atol + rtol * ref_out.float().abs()).any()):
            missed.append(key)
        del bad, fdiff
    return errs, missed


def check_flash_attention(name, device, rates, timed: bool):
    """``flash_attention`` against its plain version on one shape of
    `ATTN_SHAPES`, within ``ref.attention_tolerance``, with the kernel
    that ran (``variant``); timed at the main path's shape beside one
    ``scaled_dot_product_attention`` call, where the limit must also fail
    two planted faults (one key tile dropped, a partial tile treated as
    full) and the wgmma kernel's tile classes and ptxas line are
    recorded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    shape = ATTN_SHAPES[name]
    causal, window, dt, kind = shape[7:]
    q, k, v, qp, kp = attn_inputs(shape, seed=sum(shape[:7]), device=device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(scale=scale, q_pos=qp, kv_pos=kp, causal=causal, window=window)
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = ref.attention_tolerance(q.dtype)
    diff = (got.float() - want.float()).abs()
    rec = {"phase": "kernels", "kernel": "flash_attention", "case": name,
           "shape": dict(zip(("B", "Sq", "Sk", "H", "Hkv", "Dk", "Dv"),
                             shape[:7], strict=True)),
           "causal": causal, "window": window, "dtype": dt,
           "variant": fa.last_variant,
           "max_abs_err": diff.max().item(), "atol": atol, "rtol": rtol}
    bad = bool((diff > atol + rtol * want.float().abs()).any())
    if kind == "late_keys":
        rec["unseeing_rows_zero"] = not bool(got[:, :5].any())
        bad = bad or not rec["unseeing_rows_zero"]
    del got, diff
    if timed and not bad:
        errs, missed = planted_attention_faults(q, k, v, qp, kp, kw, want,
                                                atol, rtol)
        rec.update(errs)
        if missed:
            emit(rec)
            raise AssertionError(f"flash_attention's limit passes planted "
                                 f"faults {missed} ({name}): {rec}")
    del want
    if bad:
        emit(rec)
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version ({name}): {rec}")
    if timed:
        bound, by, pairs = attention_bound(q, k, v, qp, kp, causal, window,
                                           rates)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rec.update(
            ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20),
            plain_ms=time_ms(lambda: ref.attention(q, k, v, **kw), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale,
                enable_gqa=True), 20),
            bound_ms=bound, bound_by=by, visible_pairs=pairs)
        cls = ref.attention_tile_classes(qp, kp, causal, window, ATTN_TILE,
                                         ATTN_TILE)
        rec["tile_classes_per_head"] = {
            n: int((cls == c).sum()) for n, c in (
                ("skip", ref.TILE_SKIP), ("full", ref.TILE_FULL),
                ("partial", ref.TILE_PARTIAL))}
        rec["ptxas"] = kernel_ptxas("flash_attention", "fa_wgmma_kernel")
    emit(rec)
    return rec


def ssd_inputs(shape, seed, device):
    """``(x, dt, A, B, C)`` on the card for one SSD shape, made from a
    seed: dt softplus'd (or log-uniform in mamba2's dt init range [1e-3,
    1e-1]) and A negative, as the mamba2 block gives them."""
    import torch
    b, s, h, p, g, n, _, dt_, dt_kind = shape
    dtype = torch.bfloat16 if dt_ == "bf16" else torch.float32
    gd = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gd, device=device).to(dtype)
    if dt_kind == "mamba":
        dt = torch.exp(math.log(1e-3) + math.log(1e2) * torch.rand(
            (b, s, h), generator=gd, device=device))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=gd, device=device))
    A = -torch.exp(0.3 * torch.randn((h,), generator=gd, device=device))
    B, C = (torch.randn((b, s, g, n), generator=gd, device=device).to(dtype)
            for _ in range(2))
    return x, dt, A, B, C


def ssd_bound(shape, rates):
    """Least time (ms) for the SSD scan: per chunk of length L, the causal
    scores 2·n·L(L+1)/2 (bf16 on the tensor cores for bf16 inputs), then in
    float32 the causal w·x̄ 2·p·L(L+1)/2, C·stateᵀ 2·L·p·n and the state
    update 2·L·p·n, per (b, h); against x, dt, A, B, C, y and the state
    read or written once.  Tensor cores and CUDA cores may overlap, so the
    operation time is the larger of the bf16 and the float32 time (their
    sum in float32 inputs, which run both on the CUDA cores)."""
    b, s, h, p, g, n, chunk, dt_, _ = shape
    bw, f32, bf16 = rates
    elem = 2 if dt_ == "bf16" else 4
    tri = sum(L * (L + 1) // 2
              for L in (min(chunk, s - c) for c in range(0, s, chunk)))
    score_ops = 2 * n * tri * b * h
    f32_ops = (2 * p * tri + 4 * p * n * s) * b * h
    if elem == 2:
        t_o = max(score_ops / bf16, f32_ops / f32) * 1e3
    else:
        t_o = (score_ops + f32_ops) / f32 * 1e3
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * elem \
        + 4 * (b * s * h + h + b * h * p * n)
    t_b = nbytes / bw * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def check_ssd(name, device, rates, timed: bool):
    """``ssd`` against its plain version on one shape of `SSD_SHAPES`: y
    within ``ref.ssd_tolerance``, which must fail two planted faults at
    `SSD_Y_FAULT_CASES` (``ref.ssd_chunked_y_fault``: each chunk scanned
    alone, the state one chunk late), the final state within
    ``ref.ssd_state_tolerance``, which must fail two (the state rounded
    to bf16; with dt in mamba2's range, the state carried into the last
    chunk dropped); timed at the main path's shape."""
    import torch
    from repro_torch.kernels import ref, ssd_scan
    shape = SSD_SHAPES[name]
    chunk = shape[6]
    x, dt, A, B, C = ssd_inputs(shape, seed=sum(shape[:7]), device=device)
    y, st = ssd_scan.ssd(x, dt, A, B, C, chunk=chunk)
    y_want, st_want = ref.ssd_chunked(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    tol = ref.ssd_tolerance(y_want, x.dtype)
    tol_st = ref.ssd_state_tolerance(st_want)
    err_y = (y.float() - y_want.float()).abs().max().item()
    err_st = (st - st_want).abs().max().item()
    faults = {"bf16_state": (st_want.bfloat16().float() - st_want)
              .abs().max().item()}
    if shape[8] == "mamba":
        last = slice(-((shape[1] - 1) % chunk + 1), None)
        alone = ref.ssd_chunked(x[:, last], dt[:, last], A, B[:, last],
                                C[:, last], chunk)[1]
        faults["no_carry"] = (alone - st_want).abs().max().item()
    y_faults = {f: (ref.ssd_chunked_y_fault(x, dt, A, B, C, chunk, f)
                    .float() - y_want.float()).abs().max().item()
                for f in ("chunks_alone", "state_late")
                if name in SSD_Y_FAULT_CASES}
    rec = {"phase": "kernels", "kernel": "ssd", "case": name,
           "variant": ssd_scan.last_variant,
           "shape": dict(zip(("b", "s", "h", "p", "g", "n", "chunk"),
                             shape[:7], strict=True)), "dtype": shape[7],
           "dt": shape[8], "max_abs_err": max(err_y, err_st),
           "max_abs_err_y": err_y, "max_abs_err_state": err_st, "tol": tol,
           "planted_fault_y_err": y_faults,
           "state_scale": st_want.abs().max().item(), "tol_state": tol_st,
           "planted_fault_state_err": faults}
    del y, st, y_want, st_want
    if not (err_y <= tol and err_st <= tol_st):
        emit(rec)
        raise AssertionError(f"ssd disagrees with its plain version "
                             f"({name}): {rec}")
    if y_faults and min(y_faults.values()) <= tol:
        emit(rec)
        raise AssertionError(f"ssd's y limit passes a planted fault "
                             f"({name}): {rec}")
    if min(faults.values()) <= tol_st:
        emit(rec)
        raise AssertionError(f"ssd's state limit passes a planted fault "
                             f"({name}): {rec}")
    if timed:
        bound, by = ssd_bound(shape, rates)
        rec.update(
            ms=time_ms(lambda: ssd_scan.ssd(x, dt, A, B, C, chunk=chunk), 10),
            plain_ms=time_ms(lambda: ref.ssd_chunked(x, dt, A, B, C, chunk),
                             3),
            library_ms=None, bound_ms=bound, bound_by=by,
            ptxas=kernel_ptxas("ssd_scan", "split_kernel"))
        if not rec["ptxas"] or any(
                ", 0 bytes spill stores, 0 bytes spill loads" not in ln
                for ln in rec["ptxas"]):
            emit(rec)
            raise AssertionError(f"ssd's kernel spills or has no ptxas "
                                 f"report: {rec['ptxas']}")
    emit(rec)
    return rec


def mf_block(device):
    """The dense block of the full-width MF app's own data (`FULL_MF`):
    ``L`` and ``R`` unpacked from ``x0``, ``mask[ii, jj]`` set,
    ``D[ii, jj] = vv`` and NaN at every unobserved rating; the app's
    ``lr`` and ``lam`` as gamma and lam."""
    import torch
    from repro_torch.apps import matfact
    cfg = matfact.MFConfig(**FULL_MF)
    n, m, k = cfg.n_rows, cfg.n_cols, cfg.rank
    x0, ii, jj, vv = matfact.mf_data(cfg, device=device)
    i, j = ii.reshape(-1).long(), jj.reshape(-1).long()
    D = torch.full((n, m), float("nan"), device=device)
    mask = torch.zeros((n, m), dtype=torch.bool, device=device)
    mask[i, j] = True
    D[i, j] = vv.reshape(-1)
    L = x0[:n * k].reshape(n, k).clone()
    R = x0[n * k:].reshape(k, m).clone()
    return (L, R, D, mask), cfg.lr, cfg.lam


def mf_mask(N, M, density, pattern, gd, device):
    """The observed entries of one case: uniform at ``density``, plus for
    ``block`` the 64 x 64 block at rows 64-127 and columns 128-191, for
    ``row`` all of row 5, for ``last`` the entry at the last row and
    column."""
    import torch
    mask = torch.rand((N, M), generator=gd, device=device) < density
    if pattern == "block":
        mask[64:128, 128:192] = True
    elif pattern == "row":
        mask[5] = True
    elif pattern == "last":
        mask[-1, -1] = True
    return mask


def mf_inputs(case, device):
    """``((L, R, D, mask), gamma, lam)`` on the card for one case of
    `MF_CASES`, made from a seed, or `mf_block` for ``main``."""
    import torch
    if case == "main":
        return mf_block(device)
    N, M, K, density, gamma, lam, pattern = MF_CASES[case]
    gd = torch.Generator(device=device).manual_seed(N * M + K)
    L = torch.randn((N, K), generator=gd, device=device)
    R = torch.randn((K, M), generator=gd, device=device)
    mask = mf_mask(N, M, density, pattern, gd, device)
    D = torch.where(mask, torch.randn((N, M), generator=gd, device=device),
                    float("nan"))
    return (L, R, D, mask), gamma, lam


def mf_bounds(L, R, mask, rates):
    """Least time (ms) for `mf_sgd_block` on these inputs, and the bound of
    a dense-product design.  Only observed entries carry work: the mask is
    read whole, D only where observed, L and R once, dL, dR and the loss
    written once, against 6·K·nnz FLOP (one product for each residual,
    then its share of E Rᵀ and Lᵀ E) over the float32 rate.  The dense
    bound counts 6·K·N·M FLOP and all of D."""
    bw, f32, _ = rates
    N, K = L.shape
    M = R.shape[1]
    nnz = int(mask.sum().item())
    factors = 4 * 2 * (N * K + K * M) + 4      # L, R in; dL, dR, loss out
    out = {}
    for name, nbytes, ops in (
            ("data", N * M + 4 * nnz + factors, 6 * K * nnz),
            ("dense", 5 * N * M + factors, 6 * K * N * M)):
        t_b, t_o = nbytes / bw * 1e3, ops / f32 * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out, nnz


# mf_sgd_block's kernels: a label each, and the names its device events
# carry
MF_KERNELS = {n: (n,) for n in ("mf_pack", "mf_transpose", "mf_rows",
                                "mf_cols", "mf_loss")}


def mf_kernel_ms(call, kernels=MF_KERNELS):
    """Device ms of each of ``kernels`` (label -> names) in one profiled
    ``call``, summed over its launches (``mf_transpose`` runs twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    got = dict.fromkeys(kernels, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for label, names in kernels.items():
                if any(n in e.name for n in names):
                    got[label] += e.self_device_time_total / 1e3
    return got


def check_mf_sgd(case, device, rates, timed: bool):
    """``mf_sgd_block`` through ``ops.mf_sgd_block`` on one case, with the
    launch counts set to 0 just before and read just after (one launch,
    of this kernel only), then against its plain version: each output
    within ``ref.mf_sgd_tolerance``, finite, bit-equal across two calls.
    On ``main`` the limit must also fail four planted faults made with
    the plain version: (a) the mask ignored, unobserved ratings read as
    0; (b) the first `MF_TILE` columns of E left out of both products;
    (c) the λ term dropped; (d) one observed entry left out (the first in
    row-major order: its E set to 0, the counts unchanged).  Timed on
    ``main`` and ``kernels_bench``, beside the plain version and the three
    ``torch.matmul`` products alone; at ``main`` also each of the call's
    kernels' device time from a profiled call and their ptxas lines (no
    spills allowed), and beside the bound the
    mask's own floors: read twice (once a pass), and read once with its
    two bit copies written and read back."""
    import torch
    from repro_torch.kernels import launch, mf_sgd, ops, ref
    (L, R, D, mask), gamma, lam = mf_inputs(case, device)
    torch.cuda.synchronize()
    launch.reset_launches()
    got = ops.mf_sgd_block(L, R, D, mask, gamma, lam)
    torch.cuda.synchronize()
    launches = dict(launch.launches)
    again = mf_sgd.mf_sgd_block(L, R, D, mask, gamma, lam)
    want = ref.mf_sgd_block(L, R, D, mask, gamma, lam)
    tol = ref.mf_sgd_tolerance(L, R, D, mask, gamma, lam)
    torch.cuda.synchronize()
    names = ("dL", "dR", "loss")
    err = {n: (g - w).abs().max().item()
           for n, g, w in zip(names, got, want, strict=True)}
    N, K = L.shape
    rec = {"phase": "kernels", "kernel": "mf_sgd_block", "case": case,
           "shape": {"N": N, "M": R.shape[1], "K": K}, "gamma": gamma,
           "lam": lam, "observed": int(mask.sum().item()),
           "launches": launches,
           "max_abs_err": max(err["dL"], err["dR"]),
           "loss_err": err["loss"], "err": err,
           "tol": dict(zip(names, tol, strict=True)),
           "loss": want[2].item(),
           "bit_equal_twice": all(torch.equal(g, a) for g, a in
                                  zip(got, again, strict=True)),
           "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    want_launches = {k: 0 for k in launches}
    want_launches["mf_sgd_block"] = 1
    bad = (launches != want_launches or not rec["bit_equal_twice"]
           or not rec["finite"]
           or any(err[n] > t for n, t in zip(names, tol, strict=True)))
    del got, again
    if case == "main" and not bad:
        E = ref.mf_residual(L, R, D, mask)
        E[:, :MF_TILE] = 0.0
        faults = {
            "mask_ignored": lambda: ref.mf_sgd_block(
                L, R, torch.where(mask, D, 0.0), torch.ones_like(mask),
                gamma, lam),
            "tile_dropped": lambda: ref.mf_update(L, R, E, mask, gamma, lam),
            "no_lambda": lambda: ref.mf_sgd_block(L, R, D, mask, gamma, 0.0),
            "entry_dropped": lambda: ref.mf_update(
                L, R, ref.mf_drop_first_entry(
                    ref.mf_residual(L, R, D, mask), mask), mask, gamma,
                lam)}
        rec["planted_fault_err_over_tol"] = {}
        for name, fault in faults.items():
            f = fault()
            rec["planted_fault_err_over_tol"][name] = max(
                (a - b).abs().max().item() / t
                for a, b, t in zip(f[:2], want[:2], tol[:2], strict=True))
            del f
        del E
        if min(rec["planted_fault_err_over_tol"].values()) <= 1.0:
            emit(rec)
            raise AssertionError(f"mf_sgd_block's limit passes a planted "
                                 f"fault: {rec}")
    del want
    if bad:
        emit(rec)
        raise AssertionError(f"mf_sgd_block disagrees with its plain "
                             f"version ({case}): {rec}")
    if timed:
        bounds, nnz = mf_bounds(L, R, mask, rates)
        E = ref.mf_residual(L, R, D, mask)
        reps = 5 if case == "main" else 50
        rec.update(
            ms=time_ms(lambda: ops.mf_sgd_block(L, R, D, mask, gamma, lam),
                       reps),
            plain_ms=time_ms(lambda: ref.mf_sgd_block(L, R, D, mask, gamma,
                                                      lam), reps),
            matmul_ms=time_ms(lambda: (L @ R, E @ R.t(), L.t() @ E), reps),
            library_ms=None, bound_ms=bounds["data"][0],
            bound_by=bounds["data"][1], dense_bound_ms=bounds["dense"][0],
            dense_bound_by=bounds["dense"][1],
            mask_two_reads_ms=2 * N * R.shape[1] / rates[0] * 1e3,
            mask_once_floor_ms=1.5 * N * R.shape[1] / rates[0] * 1e3)
        del E
        if case == "main":
            rec["kernel_device_ms"] = mf_kernel_ms(
                lambda: ops.mf_sgd_block(L, R, D, mask, gamma, lam))
            rec["ptxas"] = kernel_ptxas("mf_sgd", "mf_")
            if not rec["ptxas"] or any(
                    ", 0 bytes spill stores, 0 bytes spill loads" not in ln
                    for ln in rec["ptxas"]):
                emit(rec)
                raise AssertionError(f"mf_sgd_block's kernels spill or have "
                                     f"no ptxas report: {rec['ptxas']}")
    emit(rec)
    del L, R, D, mask
    torch.cuda.empty_cache()
    return rec


# The port's kernels on the serving path, by the name each kernel's
# device events carry (demangled, or mangled).
SERVE_KERNELS = {"flash_attention": ("fa_wgmma_kernel", "fa_bf16_kernel",
                                     "fa_f32_kernel"),
                 "ssd": ("split::split_kernel", "5split12split_kernel",
                         "ssd_kernel")}


def profiled_run(model, prompts, new):
    """Host ms and device-busy ms of one ``serve.run`` under the profiler,
    with the port's kernels' share (in all and per kernel) and the five
    ops that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run(model, prompts, new)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    per_kernel = dict.fromkeys(SERVE_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            for name, fns in SERVE_KERNELS.items():
                if any(fn in e.name for fn in fns):
                    per_kernel[name] += e.self_device_time_total
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall_ms, "device_ms": busy / 1e3,
            "kernel_ms": sum(per_kernel.values()) / 1e3,
            "kernel_ms_by_name": {k: v / 1e3 for k, v in per_kernel.items()},
            "top_ops_ms": {e.key: e.self_device_time_total / 1e3
                           for e in ops}}


def serve_path(arch, device):
    """The serving path at full width and depth through
    ``repro_torch.launch.serve``: a warm-up run, then one counted run
    (launch counts set to 0 just before and read just after; the whole run
    under the sync watch), then two profiled runs (prefill alone, and
    prefill with the decode loop) for the device's idle share."""
    import torch
    from repro_torch.kernels import launch
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    model = serve.make_model(arch, full=True, seed=0, device=device)
    prompts = serve.make_prompts(model, SERVE_BATCH, SERVE_PROMPT, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = model.cfg
    serve.run(model, prompts, 2)      # cuBLAS, and the allocator at full size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    with watch_syncs() as found:
        res = serve.run(model, prompts, SERVE_NEW)
    torch.cuda.synchronize()
    launches = dict(launch.launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want["ssd" if cfg.family == "ssm" else "flash_attention"] = cfg.n_layers
    decode_syncs = [site for site, names in found if "decode_loop" in names]
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    tok, logits = res["tokens"], res["logits"]
    rec = {"phase": "serve_path", "arch": arch, "n_params": model.n_params,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "compute_dtype": cfg.compute_dtype,
           "batch": B, "prompt": S, "new": new, "setup_s": setup_s,
           "prefill_ms": res["prefill_s"] * 1e3,
           "prefill_tokens_per_s": B * S / res["prefill_s"],
           "decode_ms_per_step": res["decode_s"] * 1e3 / (new - 1),
           "decode_tokens_per_s": B * (new - 1) / res["decode_s"],
           "max_memory_allocated_bytes": peak,
           "launches_per_prefill": launches,
           "decode_host_syncs": len(decode_syncs),
           "host_sync_sites": sorted({site for site, _ in found}),
           "sample": tok[0, :8].tolist()}
    ok = (tuple(tok.shape) == (B, new) and bool((tok >= 0).all())
          and bool((tok < cfg.vocab_size).all())
          and bool(torch.isfinite(logits.float()).all()))
    if launches != want or decode_syncs or not ok:
        emit(rec)
        raise AssertionError(f"serve_path {arch}: launches {launches} "
                             f"(expected {want}), decode-loop syncs "
                             f"{decode_syncs}, tokens/logits ok: {ok}")
    pre = profiled_run(model, prompts, 1)
    full = profiled_run(model, prompts, new)
    dec_wall = full["wall_ms"] - pre["wall_ms"]
    dec_dev = full["device_ms"] - pre["device_ms"]
    rec["profiled"] = {
        "prefill_wall_ms": pre["wall_ms"], "prefill_device_ms":
        pre["device_ms"], "prefill_kernel_ms": pre["kernel_ms"],
        "prefill_kernel_ms_by_name": pre["kernel_ms_by_name"],
        "prefill_device_idle_share": 1.0 - pre["device_ms"] / pre["wall_ms"],
        "prefill_top_ops_ms": pre["top_ops_ms"],
        "decode_wall_ms_per_step": dec_wall / (new - 1),
        "decode_device_ms_per_step": dec_dev / (new - 1),
        "decode_device_idle_share": 1.0 - dec_dev / dec_wall,
        "run_device_idle_share": 1.0 - full["device_ms"] / full["wall_ms"]}
    unseen = [k for k, n in want.items()
              if n and not pre["kernel_ms_by_name"].get(k)]
    emit(rec)
    if unseen:  # SERVE_KERNELS must name every kernel the path launches
        raise AssertionError(f"serve_path {arch}: the profiler saw no device "
                             f"time for {unseen}")
    del model, prompts, res
    torch.cuda.empty_cache()
    return rec


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def serve_card_vs_cpu(arch, compute, device):
    """The smoke config of ``arch`` (compute dtype ``compute``), with the
    same weights on the card and on the CPU: prefill logits and
    ``SMOKE_NEW - 1`` teacher-forced decode steps (both fed the CPU run's
    greedy tokens) within ``SERVE_TOL`` of the logits' scale, greedy tokens
    equal wherever the CPU's top-2 margin is wider than that, and
    ``generate_scan`` through ``launch.serve.run`` on both."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import Model, build_model
    from repro_torch.serve import decode
    cfg = get_smoke_config(arch).replace(compute_dtype=compute)
    cpu = build_model(cfg, seed=0, device="cpu")
    card = Model(cfg, _to(cpu.params, device))
    prompts = serve.make_prompts(cpu, SMOKE_BATCH, SMOKE_PROMPT, seed=0)
    tol = SERVE_TOL[compute]
    steps = []
    caches = {m: m.init_cache(SMOKE_BATCH, SMOKE_PROMPT + SMOKE_NEW)
              for m in (cpu, card)}
    lg_h, caches[cpu] = cpu.prefill(prompts, caches[cpu])
    lg_c, caches[card] = card.prefill(prompts.to(device), caches[card])
    for i in range(SMOKE_NEW):
        want, got = lg_h[:, -1].float(), lg_c[:, -1].float().cpu()
        scale = want.abs().max().item()
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol * scale
        same = decode.greedy_sample(lg_h) == decode.greedy_sample(lg_c).cpu()
        steps.append({"rel_err": (got - want).abs().max().item() / scale,
                      "clear_margins": int(clear.sum()),
                      "tokens_differ_where_clear": int((clear & ~same)
                                                       .sum())})
        if i + 1 == SMOKE_NEW:
            break
        tok = decode.greedy_sample(lg_h)[:, None]
        lg_h, caches[cpu] = cpu.decode_step(tok, caches[cpu])
        lg_c, caches[card] = card.decode_step(tok.to(device), caches[card])
    gen_h = serve.run(cpu, prompts, SMOKE_NEW)["tokens"]
    gen_c = serve.run(card, prompts.to(device), SMOKE_NEW)["tokens"].cpu()
    rec = {"phase": "serve_card_vs_cpu", "arch": arch, "compute": compute,
           "batch": SMOKE_BATCH, "prompt": SMOKE_PROMPT, "tol": tol,
           "max_rel_err": max(s["rel_err"] for s in steps),
           "tokens_differ_where_clear": sum(s["tokens_differ_where_clear"]
                                            for s in steps),
           "clear_margins": sum(s["clear_margins"] for s in steps),
           "steps": len(steps),
           "generate_tokens_equal": float((gen_h == gen_c).float().mean())}
    emit(rec)
    if rec["max_rel_err"] > tol or rec["tokens_differ_where_clear"]:
        raise AssertionError(f"serve card vs CPU ({arch}, {compute}): {rec}")
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps import matfact
    from repro_torch.core import consistency as cc
    from repro_torch.core import ps
    from repro_torch.kernels import build
    from repro_torch.psrun import validate

    # float32 products in full precision everywhere (the data generation's
    # matmul, the library yardstick); stated and set, not assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- 1. device and build ---------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    rates = card_rates(kind)
    build_s = build.build()
    ptxas = [line for log in sorted(build._build_dir().glob("*.log"))
             for line in ptxas_report(log.read_text())]
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "bandwidth_Bps": rates[0],
          "build_s": build_s, "ptxas": ptxas})

    # --- 2. kernels against their plain versions ----------------------------
    d_full = (FULL_MF["n_rows"] + FULL_MF["n_cols"]) * FULL_MF["rank"]
    main_shapes = {"essp": (cc.essp(3).effective_window, 8, d_full, 0),
                   "vap": (cc.vap(FULL_VAP_V0).effective_window, 8, d_full,
                           0)}
    timed = {k: check_kernels(s, dev, rates, timed=True)
             for k, s in main_shapes.items()}
    for shape in ((5, 1, 10_000, 1), (5, 16, 100_003, 0), (11, 8, 2000, 2),
                  (5, 4, 16, 1), (11, 8, 50_001, 4), (64, 64, 333, 5)):
        check_kernels(shape, dev, rates, timed=False)
    wcfg = wired_cfg(cc)
    pack_main = check_delta_pack(8, d_full, WIRED_TOPK, "normal", dev, rates,
                                 timed=True)
    for P, d, topk, case in ((1, 10_000, 0.3, "normal"),
                             (4, 16, 0.25, "normal"),
                             (8, 2000, 0.1, "normal"),
                             (8, 100_003, WIRED_TOPK, "normal"),
                             (4, 4096, 1.0, "normal"),
                             (8, 100_000, WIRED_TOPK, "unaligned"),
                             (4, 4096, 0.3, "ties"),
                             (4, 4096, 0.3, "above"),
                             (4, 4096, 0.5, "zeros"),
                             (4, 4096, 0.5, "halves")):
        check_delta_pack(P, d, topk, case, dev, rates, timed=False)
    selection = time_selection(8, d_full, WIRED_TOPK, dev)
    attn_main = check_flash_attention("main", dev, rates, timed=True)
    for name in ATTN_SHAPES:
        if name != "main":
            check_flash_attention(name, dev, rates, timed=False)
    ssd_main = check_ssd("main", dev, rates, timed=True)
    for name in SSD_SHAPES:
        if name != "main":
            check_ssd(name, dev, rates, timed=False)
    mf_main = check_mf_sgd("main", dev, rates, timed=True)
    for name in MF_CASES:
        check_mf_sgd(name, dev, rates, timed=name == "kernels_bench")

    # --- 3. main path at full width -----------------------------------------
    t0 = time.perf_counter()
    app = matfact.make_mf_app(matfact.MFConfig(**FULL_MF), device=dev)
    torch.cuda.synchronize()
    emit({"phase": "main_path_setup", "config": FULL_MF, "d": app.dim,
          "make_mf_app_s": time.perf_counter() - t0})
    main_launches, main_syncs = {}, {}
    for name, cfg in (("essp3", cc.essp(3)), ("vap", cc.vap(FULL_VAP_V0)),
                      ("essp2_wired_int8", wcfg)):
        rec = run_main_path(app, cfg, name, FULL_CLOCKS)
        emit(rec)
        main_launches[name] = rec["launches"]
        main_syncs[name] = rec["host_sync_sites"]
    if any(main_syncs.values()):
        raise AssertionError(f"the clock loop synchronized with the host: "
                             f"{main_syncs}")
    del app
    torch.cuda.empty_cache()

    # --- 4. card against CPU ------------------------------------------------
    small = matfact.MFConfig()
    budget = validate.VAP_ULP_BUDGET
    for name, cfg in (("essp3", cc.essp(3)), ("vap", cc.vap(SMALL_VAP_V0)),
                      *small_wired_cfgs(cc).items()):
        got, got_ships = simulate_recording_shipments(
            matfact.make_mf_app(small, device=dev), cfg, SMALL_CLOCKS)
        want, want_ships = simulate_recording_shipments(
            matfact.make_mf_app(small, device="cpu"), cfg, SMALL_CLOCKS)
        diffs = validate.trace_max_diff(got, want)
        ulps = validate.trace_max_ulp(got, want)
        exact = validate.INT_FIELDS + ("ship_floats",)
        flip = first_wire_flip(got_ships, want_ships, budget)
        rec = {"phase": "card_vs_cpu", "config": name, "clocks": SMALL_CLOCKS,
               "int_fields_equal": all(diffs[f] == 0.0 for f in exact),
               "loss_ref_bit_equal": diffs["loss_ref"] == 0.0,
               "shipments": len(got_ships), "first_wire_flip": flip,
               "max_ulp": ulps, "ulp_budget": budget}
        if not rec["int_fields_equal"]:
            emit(rec)
            raise AssertionError(f"card vs CPU ({name}): integer fields or "
                                 f"ship_floats differ: {diffs}")
        if flip is not None:
            # the flipped wire enters the views from the next clock on
            flip["clock"] = (flip["shipment"] + 1) * cfg.agg_clocks - 1
            ulps = ulps_through(got, want, flip["clock"])
            rec["max_ulp_through_flip"] = ulps
        bad = {f: u for f, u in ulps.items() if f in validate.FLOAT_FIELDS
               and u > budget}
        emit(rec)
        if bad:
            raise AssertionError(f"card vs CPU ({name}): {bad}")

    # --- 5. serving path at full width ---------------------------------------
    served = {arch: serve_path(arch, dev) for arch in SERVE_ARCHS}

    # --- 6. serving, card against CPU -----------------------------------------
    for arch in SERVE_ARCHS:
        for compute in ("bfloat16", "float32"):
            serve_card_vs_cpu(arch, compute, dev)

    # --- summary ------------------------------------------------------------
    essp = timed["essp"]
    source = "src/repro_torch/kernels/csrc/ps_view.cu"
    kernels = []
    for name, replaces in (
            ("ring_view", "src/repro/kernels/ps_view.py:53"),
            ("vap_suffix_norms", "src/repro/kernels/ps_view.py:93")):
        k = essp[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches["essp3"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    pk = pack_main[wcfg.quant]
    kernels.append({
        "name": "delta_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_pack.cu",
        "replaces": "src/repro/kernels/delta_pack.py:56",
        "launches": main_launches["essp2_wired_int8"]["delta_pack"],
        "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
        "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
        "bound_by": pk["bound_by"], "library_ms": pk["library_ms"]})
    for name, rec, src, replaces, arch in (
            ("flash_attention", attn_main, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:93", "qwen3-0.6b"),
            ("ssd", ssd_main, "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:79", "mamba2-130m")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": served[arch]["launches_per_prefill"][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if "variant" in rec:
            kernels[-1]["variant"] = rec["variant"]
    kernels.append({
        "name": "mf_sgd_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mf_sgd.cu",
        "replaces": "src/repro/kernels/mf_sgd.py:87",
        "launches": mf_main["launches"]["mf_sgd_block"],
        "max_abs_err": mf_main["max_abs_err"], "ms": mf_main["ms"],
        "plain_ms": mf_main["plain_ms"], "bound_ms": mf_main["bound_ms"],
        "bound_by": mf_main["bound_by"], "library_ms": mf_main["library_ms"]})
    emit({"total_s": time.perf_counter() - t_start,
          "serve_prefill": {a: {
              "prefill_ms": r["prefill_ms"],
              "prefill_tokens_per_s": r["prefill_tokens_per_s"],
              "profiled_kernel_ms": r["profiled"]["prefill_kernel_ms_by_name"]}
              for a, r in served.items()},
          "main_path_launches": main_launches,
          "serve_launches_per_prefill": {
              a: r["launches_per_prefill"] for a, r in served.items()},
          "threshold_selection_ms": selection["ms"]})
    emit({"kernels": kernels})
    emit(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if _lines:
            OUT.parent.mkdir(parents=True, exist_ok=True)
            OUT.write_text("\n".join(_lines) + "\n")
    sys.exit(rc)
