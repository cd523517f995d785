#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; never
JAX or the JAX package).  Thirteen phases, one JSON line each (or more):

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
   ``ring_view`` and ``vap_suffix_norms`` are also timed at the fault
   path's rings (W = 22, P = 8, d = 5,053,800), ``path: "fault"``, with
   ``vap_suffix_norms``'s ptxas lines (no spills); ``vap_suffix_norms``
   is held exactly to its plain version on spiked rings
   (``check_spiked``) at the fault path's and LDA's rings and at ragged
   shapes, where each of ``ref.VAP_FAULTS`` (the last, the first or the
   seam columns dropped, the oldest slot skipped) must differ from it;
   ``mf_sgd_block`` (``check_mf_sgd``) is driven through
   ``ops.mf_sgd_block`` at the dense block of the full-width MF data
   (``main``, NaN at every unobserved rating) and at the ``kernels``
   suite's shape, with the launch counts set to 0 just before and read
   just after, then held to its plain version within
   ``ref.mf_sgd_tolerance`` (which must fail four planted faults at
   ``main``), bit-equal across two calls, at edge shapes and the mask
   compaction's cases too; at ``main`` each of its kernels' device time
   from a profiled call and their ptxas lines (no spills); ``ring_view``
   and ``vap_suffix_norms`` also at the LDA path's rings (phases 7 and
   8: W = 2, 5, 7 at d = 10,266,000), untimed; ``ring_view`` on readers
   4-7 of 8 (``check_reader_block``, the launch of a shard of the
   sharded runtime) at W = 5 and 22, d = 5,053,800, bit-equal to those
   rows of the full launch, where the rows shifted by one reader (a
   planted fault) must differ;
3. the main path at full width: MF-SGD at the paper's Netflix rank and
   item count through ``simulate`` under ``essp(3)`` and ``vap(0.5)``,
   and through the comm substrate under two-pod ``essp(2)`` with int8
   top-k shipments every 2 clocks; each kernel must be launched as often
   as its path needs (``ring_view`` and ``vap_suffix_norms`` once per
   clock, on the wired path ``ring_view`` twice and ``delta_pack`` once
   per shipping clock), the clock loop must not synchronize with the
   host, the traces must be finite, the loss falling and the (widened)
   staleness bound kept; a profiled run gives the per-clock device time
   of the kernels (each by name: a launched kernel the profiler saw no
   time for fails), of the threshold selection and of the rest, and the
   device's idle share in that same run;
4. the default MF config on the card against the same run on the CPU,
   dense and wired: integer Trace fields and ``ship_floats`` equal, float
   fields within the ulp budget.  A wired run's float fields are held to
   the budget up to the first shipment whose quantized levels differ
   between the two runs (int8: each run's wire over its own row scale;
   bf16: the rounded values): a quantized value is a rounding decision,
   and one that flips on float drift within the budget (checked) moves
   the run by a whole quantization step, as a flipped VAP decision
   would.  At the
   first shipment whose top-k selection differs, every coordinate
   selected in one run only must lie within the budget of its row's
   threshold in both (a near tie); the integer fields and
   ``ship_floats`` are held exactly up to the clock before it;
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
   margin exceeds it;
7. LDA at full width (``FULL_LDA``: K = 100, the NYTimes vocabulary,
   d = 10,266,000) through ``simulate`` under ``ssp(3)`` and ``essp(3)``,
   with the MF main path's checks (one ``ring_view`` and one
   ``vap_suffix_norms`` per clock, no host sync, finite traces, the NLL
   falling, the staleness bound kept, a profiled run's device time and
   idle share) and the corpus's set-up seconds;
8. the C2-LDA figure (``bsp``, ``ssp(5)``, ``essp(5)``) through ``sweep``
   on that app (``lda_sweep_phase``): a ``post`` of the LDA time model's
   breakdown, one config re-run through ``simulate`` bit-equal, a second
   sweep with ``keep_traces=False``, runs per second;
9. ``LDAConfig()`` on the card against the CPU (``lda_card_vs_cpu``)
   under ``ssp(3)``, ``essp(3)`` and the figure's sweep: integer Trace
   fields equal, float fields within the ulp budget up to the first
   sampled ``z`` that differs, and every differing draw a near tie;
10. the fault path at full width (``fault_path``): ``FULL_MF`` under the
   faults bench's two-pod int8 top-k config at ``wire.required_window``
   (22), with the bench's burst faults and robustness's pod outage, each
   run with ``obs=ObsSpec()``: (a) the neutral twin (``no_faults``), which
   must be bit-equal to ``faults=None``, (b) the faults, (c) the faults
   and the outage.  ``ring_view`` twice, ``vap_suffix_norms`` once per
   clock and ``delta_pack`` once per boundary clock; no host sync;
   finite traces, the loss falling; the staleness bound widened by the
   retry budget kept by the live readers; a dead worker's ``u_l2`` and
   ``ship_floats`` 0; the obs accumulators equal to the trace's sums; the
   ARQ counters; each run's event stream valid (``retry_budget`` stamped
   on (b) and (c)); the recovery controller, with the faults bench's wire
   SLO (3 % over (a)'s floats per clock), acting on (b) and (c) and not
   on (a); profiled runs of (b) and (c) for the device time, the kernels'
   share and the idle share; peak memory;
11. ``MFConfig()`` under that config with drops, duplicates, delays of up
   to 2 clocks, a burst and a worker outage that drops its in-flight mass
   (``fault_card_vs_cpu``), card against CPU: phase 4's holding, and
   ``live``, the ARQ counters and the integer accumulators exact;
12. the tuner (``tuner_phase``): ``tune.frontier`` over ``ssp(3)``,
   ``essp(3)`` x three ``push_prob`` at full width, in runs per second;
   at ``MFConfig()`` its frontier and ``grad_knobs`` card against CPU.
   Phases 10-12 take about a minute together;
13. the flat sharded runtime (``psrun.PSRuntime``) as a world of one NCCL
   rank at full width (``runtime_phase``): 30 clocks each of ``essp(3)``,
   ``vap(0.5)`` and the fault path's config at W = 22 with the burst
   faults and ``obs=ObsSpec()``, each counted and watched as phase 3's
   runs (launches as ``expected_launches``, no host sync), held to
   ``psrun.validate.contract`` against ``simulate`` on the card (essp and
   the faulted run bit-identical, vap within the budget with exact
   decisions; the obs accumulators equal), the clocks/s of the runtime
   and of ``simulate`` in turns, peak memory; the ``essp(3)`` run's
   checkpoint at clock 15 written to a temporary directory, restored,
   resumed bit for bit and deleted (bytes, seconds); the faulted run's
   event stream through ``obs.perfetto`` and ``obs.promtext`` (sizes).

Then the ``kernels`` summary line (the ``ps_view`` and ``delta_pack``
rows carry the runtime's launches too), the card's ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
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

# Full-width LDA: the paper's NYTimes run (K = 100 topics) over the
# vocabulary of the UCI bag-of-words NYTimes corpus (V = 102,660), 8
# workers, α 0.5, β 0.1, concentration 0.05, half the tokens resampled per
# clock: d = K·V = 10,266,000 (d % 128 = 16: ragged), a 1.64 GB ring at
# W = 5.  Tokens are cut to 512 documents of 128 (65,536), because drawing
# the corpus hashes tokens × V = 6.7e9 Gumbel counters.
FULL_LDA = dict(n_docs=512, doc_len=128, vocab=102_660, n_topics=100,
                true_topics=100, n_workers=8, alpha=0.5, beta=0.1,
                concentration=0.05, minibatch_frac=0.5)
LDA_CLOCKS = 30
# A sampled topic may differ between the card and the CPU only where its
# top-2 margin of logits + gumbel is within this many ulp of the noisy
# values' scale (the sampler's float steps are replayed bit for bit, so
# none is expected).
LDA_TIE_ULP = 4.0

# The fault path (phases 10-12): benchmarks/faults_bench.py's compressed
# eager family (two pods, s = 2, s_xpod = 3, int8 values of the top quarter
# of each aggregated row every 2 clocks) under that bench's "burst" loss
# (15 % i.i.d. drops, 90 % for clocks 12-15 of 30, three retries) and
# benchmarks/robustness.py's pod outage (pod 1 down for clocks 9-17); the
# ring window is wire.required_window of the config and the faults (22).
FAULT_CLOCKS = 30
FAULT_BURST = dict(seed=14, drop_rate=0.15, bursts=((12, 16, 0.9),),
                   max_retries=3, heal=True)
FAULT_POD_OUTAGE = dict(n_pods=2, pod_outages=((1, 9, 18),))
# The faults bench's wire SLO: 3 % above the floats per clock of the
# neutral twin (its retransmit floor is ~5.5 % extra, the twin sits at 1.0).
WIRE_SLO_MARGIN = 1.03
# Phase 11 (card against CPU at MFConfig()): every kind of fault, and a
# worker outage that drops its in-flight mass.
SMALL_FAULTS = dict(seed=21, drop_rate=0.2, dup_rate=0.2, delay_rate=0.3,
                    max_delay=2, bursts=((6, 9, 0.9),), max_retries=3)
SMALL_OUTAGE = dict(worker_outages=((3, 5, 11),), drop_inflight=True)
# Phase 12: the tuner's grid at full width.
TUNE_PUSH_PROBS = (0.25, 0.5, 1.0)
# Phase 13: the flat sharded runtime as one NCCL rank, and the clock of
# its essp(3) checkpoint.
RUNTIME_CLOCKS = 30
RUNTIME_CKPT_CLOCK = 15
# ring_view on a shard's reader rows (phase 2): readers 4-7 of 8.
READER_ROWS = (4, 4)


def fault_cfg(cc):
    """The fault path's config (before its window is set)."""
    return cc.compressed(cc.podded(cc.essp(2), 2, s_xpod=3, t_net_xpod=8.0),
                         agg_clocks=2, topk_frac=0.25, quant="int8")


def fault_window(cc, wire):
    """The fault path's ring window, ``wire.required_window``."""
    return wire.required_window(fault_cfg(cc), wire.make_faults(
        FAULT_CLOCKS, 8, **FAULT_BURST))

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


def check_kernels(shape, device, rates, timed: bool, path=None):
    """Both kernels against their plain versions on one ring shape
    (``path`` names the main path whose shape it is, in the record)."""
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
    if path is not None:
        rec["path"] = path
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


def check_spiked(shape, device, path=None):
    """``vap_suffix_norms`` on a spiked ring (``ref.vap_spiked_ring``: each
    producer's largest |suffix| in its first or last column or beside a
    seam of the kernel's ``VAP_TILE``), exactly equal to its plain
    version, while each of ``ref.VAP_FAULTS`` made with the plain version
    must differ from it on the same inputs."""
    import torch
    from repro_torch.kernels import ps_view, ref
    W, P, d = shape
    uring, uclock, c, spikes = ref.vap_spiked_ring(
        W, P, d, ps_view.VAP_TILE, seed=W * 1000 + P + 7, device=device)
    want = ref.vap_suffix_norms(uring, uclock, c)
    got = ps_view.vap_suffix_norms(uring, uclock, c)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    faults = {f: (ref.vap_suffix_norms_fault(uring, uclock, c, f,
                                             ps_view.VAP_TILE)
                  - want).abs().max().item() for f in ref.VAP_FAULTS}
    rec = {"phase": "kernels_spiked", "W": W, "P": P, "d": d,
           "spike_columns": sorted(set(spikes)),
           "vap_suffix_norms": {"max_abs_err": err, "tol": 0.0},
           "planted_fault_err": faults}
    if path is not None:
        rec["path"] = path
    emit(rec)
    missed = [f for f, e in faults.items() if not e > 0.0]
    if err > 0.0 or missed:
        raise AssertionError(f"spiked ring W={W} P={P} d={d}: kernel error "
                             f"{err}, planted faults the check cannot see: "
                             f"{missed}")
    del uring, got, want
    return rec


def check_reader_block(W, P, d, device, path=None):
    """``ring_view`` on a shard's reader rows (``READER_ROWS``: readers 4-7
    of P = 8), as the sharded runtime launches it: bit-equal to the same
    rows of the R = P launch, while the rows shifted by one reader (a
    planted fault) must differ from them.  Both launches are timed."""
    import torch
    from repro_torch.kernels import ps_view
    r0, R = READER_ROWS
    base, uring, uclock, cview, _ = ring_inputs(W, P, d, 0, seed=W * 100 + 3,
                                                device=device)
    full = ps_view.ring_view(base, uring, uclock, cview)
    got = ps_view.ring_view(base, uring, uclock,
                            cview[r0:r0 + R].contiguous())
    shifted = ps_view.ring_view(base, uring, uclock,
                                cview[r0 - 1:r0 - 1 + R].contiguous())
    torch.cuda.synchronize()
    want = full[r0:r0 + R]
    rec = {"phase": "kernels_reader_block", "W": W, "P": P, "d": d,
           "readers": [r0, r0 + R - 1],
           "ring_view": {"max_abs_err": (got - want).abs().max().item(),
                         "tol": 0.0},
           "bit_equal": bool(torch.equal(got, want)),
           "planted_fault_err": (shifted - want).abs().max().item()}
    rows = cview[r0:r0 + R].contiguous()
    rec["ring_view"].update(
        ms=time_ms(lambda: ps_view.ring_view(base, uring, uclock, rows), 10),
        all_readers_ms=time_ms(
            lambda: ps_view.ring_view(base, uring, uclock, cview), 10))
    if path is not None:
        rec["path"] = path
    emit(rec)
    if not rec["bit_equal"] or not rec["planted_fault_err"] > 0.0:
        raise AssertionError(f"ring_view on readers {r0}-{r0 + R - 1} of "
                             f"{P} at W={W}: {rec}")
    del base, uring, full, got, shifted
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


# the simulator's kernels by their launch counters' names, each with the
# names its device events carry (csrc/ps_view.cu, csrc/delta_pack.cu)
PS_KERNELS = {"ring_view": ("ring_view_kernel",),
              "vap_suffix_norms": ("vap_norms_bulk", "vap_norms_regs"),
              "delta_pack": ("delta_pack_vec4", "delta_pack_scalar")}
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


def device_split(app, cfg, n_clocks, **sim_kw):
    """Device time per clock from a profiled run: all kernels, the port's
    kernels, the comm substrate's threshold selection, and the five ops
    that take the most of it; the host time per clock of the same run, and
    the share of it the device was idle.  The profiler's own host cost is
    inside that host time.  It fails if a kernel of ``PS_KERNELS`` was
    launched in that run but the profiler saw no device time for it (a
    name the table lacks), once the profiler sees device time at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ps
    from repro_torch.kernels import launch
    before = dict(launch.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ps.simulate(app, cfg, n_clocks, seed=0, **sim_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_clocks
    launched = [k for k in PS_KERNELS if launch.launches[k] > before[k]]
    busy = 0.0
    by_name = dict.fromkeys(PS_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            for k, names in PS_KERNELS.items():
                if any(n in e.name for n in names):
                    by_name[k] += e.self_device_time_total
    if busy == 0.0:      # the profiler saw no device time: say so
        return {"profiled_ms_per_clock": wall_ms,
                "device_ms_per_clock": None, "kernel_ms_per_clock": None}
    unseen = [k for k in launched if by_name[k] == 0.0]
    if unseen:           # PS_KERNELS must name every kernel the path runs
        raise AssertionError(f"{cfg.model}: the profiler saw no device time "
                             f"for the launched kernels {unseen}")
    ours = sum(by_name.values())
    averages = prof.key_averages()
    ops = sorted((e for e in averages if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:5]
    sel = sum(e.device_time_total for e in averages if e.key == SELECTION_OP)
    busy_ms = busy / 1e3 / n_clocks
    ours_ms, sel_ms = ours / 1e3 / n_clocks, sel / 1e3 / n_clocks
    return {"profiled_ms_per_clock": wall_ms,
            "device_ms_per_clock": busy_ms,
            "kernel_ms_per_clock": ours_ms,
            "kernel_ms_per_clock_by_name": {
                k: v / 1e3 / n_clocks for k, v in by_name.items()},
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


def simulate_recording_shipments(app, cfg, n_clocks, **sim_kw):
    """``simulate`` through the entry point, keeping each shipment's
    ``(delta, wire)`` on the host (``substrate.pack`` is wrapped for the
    run).  Returns the trace, the shipments and the final comm state."""
    from repro_torch.comm import substrate
    from repro_torch.core import ps
    shipments, pack = [], substrate.pack

    def recording(delta, topk_frac, quant):
        out = pack(delta, topk_frac, quant)
        shipments.append((delta.cpu(), out[0].cpu()))
        return out

    substrate.pack = recording
    try:
        trace, cst = ps.simulate_with_state(app, cfg, n_clocks, **sim_kw)
    finally:
        substrate.pack = pack
    return trace, shipments, cst


def first_wire_flip(got, want, budget_ulp, quant):
    """The first shipment whose wire rounding decisions differ between two
    runs, as ``{"shipment", "wire_values_differ", "max_delta_drift_ulp"}``,
    or None.  The decisions are the quantized levels: for int8 each run's
    wire over its own row scale (a scale that drifted by an ulp moves
    every value by an ulp, which is drift, not a flip), for bf16 the
    rounded values; f32 carries each selected value unrounded, so only its
    selection can flip (:func:`first_selection_flip`).  The pack is a
    function of each delta row (bit-equal on the card and the CPU, phase
    2), so a row whose levels differ must have a delta row that drifted,
    by at most the budget (ulp of the delta's scale): anything else
    raises."""
    import numpy as np
    import torch
    from repro_torch.comm import substrate
    if quant == "f32":
        return None

    def levels(delta, wire):
        if quant == "int8":
            return torch.round(wire / substrate.quant_scale(delta, quant)
                               [:, None])
        return wire

    for i, ((dg, wg), (dw, ww)) in enumerate(zip(got, want, strict=True)):
        differ = levels(dg, wg) != levels(dw, ww)
        if not differ.any():
            continue
        rows = differ.any(dim=1)
        drift = (dg - dw).abs().amax(dim=1)[rows]
        spacing = float(np.spacing(np.float32(dw.abs().max())))
        if not ((drift > 0).all() and (drift <= budget_ulp * spacing).all()):
            raise AssertionError(f"shipment {i}: wire levels differ on rows "
                                 f"whose delta drift {drift.tolist()} is 0 "
                                 f"or over the budget")
        return {"shipment": i, "wire_values_differ": int(differ.sum()),
                "max_delta_drift_ulp": float(drift.max()) / spacing}
    return None


def first_selection_flip(got, want, budget_ulp, topk_frac):
    """The first shipment whose top-k selection differs between two runs,
    as ``{"shipment", "selection_differs", "max_selection_margin_ulp"}``,
    or None.  A coordinate selected in one run only must lie within the
    budget (ulp of the delta's scale) of its row's threshold in both runs,
    a near tie that float drift may turn: anything else raises."""
    import numpy as np
    from repro_torch.comm import substrate
    for i, ((dg, _), (dw, _)) in enumerate(zip(got, want, strict=True)):
        sel, gaps = [], []
        for d in (dg, dw):
            thresh = substrate.row_threshold(d, topk_frac)[:, None]
            sel.append(d.abs() >= thresh)
            gaps.append((d.abs() - thresh).abs())
        flipped = sel[0] != sel[1]
        if not flipped.any():
            continue
        spacing = float(np.spacing(np.float32(dw.abs().max())))
        margin = max(float(g[flipped].max()) for g in gaps) / spacing
        if margin > budget_ulp:
            raise AssertionError(f"shipment {i}: {int(flipped.sum())} "
                                 f"coordinates selected in one run only, up "
                                 f"to {margin} ulp from their row's "
                                 f"threshold, over the {budget_ulp} ulp of "
                                 f"a near tie")
        return {"shipment": i, "selection_differs": int(flipped.sum()),
                "max_selection_margin_ulp": margin}
    return None


def trace_head(trace, last_clock):
    """``trace`` with its per-clock fields cut to clocks
    0..``last_clock`` (``x_final``, of the end of the run, kept)."""
    import dataclasses
    from repro_torch.psrun import validate
    return dataclasses.replace(
        trace, **{f: getattr(trace, f)[:last_clock + 1]
                  for f in validate.TRACE_FIELDS if f != "x_final"})


def ulps_through(got, want, last_clock):
    """``trace_max_ulp`` of the per-clock fields over clocks
    0..``last_clock`` (``x_final``, of the end of the run, left out)."""
    from repro_torch.psrun import validate
    out = validate.trace_max_ulp(trace_head(got, last_clock),
                                 trace_head(want, last_clock))
    del out["x_final"]
    return out


def hold_card_to_cpu(name, cfg, got, want, got_ships, want_ships,
                     phase="card_vs_cpu"):
    """Phase 4's comparison of a card run with the same run on the CPU:
    integer Trace fields and ``ship_floats`` exact, float fields within
    the ulp budget, both up to the first wire or selection flip (see the
    module doc).  Returns the record; raises on a failure."""
    from repro_torch.psrun import validate
    budget = validate.VAP_ULP_BUDGET
    n_clocks = got.loss_ref.shape[0]
    ulps = validate.trace_max_ulp(got, want)
    exact = validate.INT_FIELDS + ("ship_floats",)
    flip = first_wire_flip(got_ships, want_ships, budget, cfg.quant)
    sel = first_selection_flip(got_ships, want_ships, budget, cfg.topk_frac)
    exact_through = float_through = n_clocks - 1
    if flip is not None:
        # the flipped wire enters the views from the next clock on
        flip["clock"] = float_through = (
            (flip["shipment"] + 1) * cfg.agg_clocks - 1)
    if sel is not None:
        # a near tie selected otherwise moves that shipment's count and,
        # from the next clock on, what is delivered
        sel["clock"] = (sel["shipment"] + 1) * cfg.agg_clocks - 1
        exact_through = sel["clock"] - 1
        float_through = min(float_through, exact_through)
    diffs = validate.trace_max_diff(trace_head(got, exact_through),
                                    trace_head(want, exact_through))
    rec = {"phase": phase, "config": name, "clocks": n_clocks,
           "int_fields_equal": all(diffs[f] == 0.0 for f in exact),
           "int_fields_exact_through": exact_through,
           "loss_ref_bit_equal": diffs["loss_ref"] == 0.0,
           "shipments": len(got_ships), "first_wire_flip": flip,
           "first_selection_flip": sel, "max_ulp": ulps,
           "ulp_budget": budget}
    if not rec["int_fields_equal"]:
        emit(rec)
        raise AssertionError(f"{phase} ({name}): integer fields or "
                             f"ship_floats differ through clock "
                             f"{exact_through}: {diffs}")
    if flip is not None or sel is not None:
        ulps = ulps_through(got, want, float_through)
        rec["max_ulp_through_flip"] = ulps
    bad = {f: u for f, u in ulps.items() if f in validate.FLOAT_FIELDS
           and u > budget}
    if bad:
        emit(rec)
        raise AssertionError(f"{phase} ({name}): {bad}")
    rec["float_fields_held_through"] = float_through
    return rec


def check_obs_sums(tr, cfg):
    """The obs accumulators of a numpy trace against the same sums taken
    over its Trace fields (integers exact; the per-producer wire floats
    as the same float32 running sum)."""
    import numpy as np
    from repro_torch.core import delays
    o = {k: np.asarray(v) for k, v in tr.obs.items()}
    T, P, _ = tr.staleness.shape
    lag = -1 - tr.staleness.astype(np.int64)
    rows = np.broadcast_to(tr.live[:, :, None], lag.shape)
    nb = o["lag_hist"].shape[0]
    in_pod = delays.same_pod_mask(P, cfg.n_pods).numpy()
    f = tr.forced & tr.live[:, :, None]
    want = {"clocks": T,
            "lag_hist": np.bincount(np.clip(lag, 0, nb - 1)[rows],
                                    minlength=nb),
            "lag_max": np.where(rows, lag, 0).max(initial=0),
            "forced_intra": (f & in_pod).sum(),
            "forced_xpod": (f & ~in_pod).sum(),
            "delivered": (tr.delivered & tr.live[:, :, None]).sum(),
            "dead_worker_clocks": (~tr.live).sum(),
            "ship_floats": np.cumsum(tr.ship_floats.astype(np.float32),
                                     axis=0, dtype=np.float32)[-1]}
    bad = [k for k, v in want.items() if not np.array_equal(o[k], v)]
    if bad:
        raise AssertionError(f"obs accumulators differ from the trace's "
                             f"sums in {bad}")
    return {k: (o[k].tolist() if o[k].ndim else o[k].item()) for k in o}


def fault_run(app, cfg, name, n_clocks, retry_budget, **sim_kw):
    """One faulted (and churned) ``simulate_with_state`` at full width,
    counted and watched as phase 3's runs are (after a 2-clock warm-up):
    launches as ``expected_launches`` says, no host sync, finite traces,
    the loss falling, the staleness bound widened by ``retry_budget``
    kept by the live readers, a dead worker's ``u_l2`` and
    ``ship_floats`` 0, and the obs accumulators equal to the trace's
    sums.  Returns ``(record, trace)``."""
    import torch
    from repro_torch.convert import trace_to_numpy
    from repro_torch.core import ps
    from repro_torch.kernels import launch
    from repro_torch.psrun import validate
    ps.simulate(app, cfg, 2, seed=1, **sim_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    t0 = time.perf_counter()
    with watch_syncs() as found:
        trace, cst = ps.simulate_with_state(app, cfg, n_clocks, seed=0,
                                            **sim_kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(launch.launches)
    rec = {"phase": "fault_path", "config": name, "clocks": n_clocks,
           "d": app.dim, "W": cfg.effective_window, "P": app.n_workers,
           "seconds": secs, "clocks_per_s": n_clocks / secs,
           "ms_per_clock": secs / n_clocks * 1e3, "launches": launches,
           "host_syncs": len(found),
           "host_sync_sites": sorted({site for site, _ in found}),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if launches != expected_launches(cfg, n_clocks) or found:
        emit(rec)
        raise AssertionError(f"{name}: launches {launches} (expected "
                             f"{expected_launches(cfg, n_clocks)}), host "
                             f"syncs at {rec['host_sync_sites']}")
    assert_finite(trace, name)
    tr = trace_to_numpy(trace)
    if not tr.loss_ref[-1] < tr.loss_ref[0]:
        raise AssertionError(f"{name}: loss_ref did not fall "
                             f"({tr.loss_ref[0]} -> {tr.loss_ref[-1]})")
    chk = validate.check_staleness_bound(tr, cfg, retry_budget=retry_budget)
    if chk["violations"]:
        raise AssertionError(f"{name}: widened staleness bound broken: "
                             f"{chk}")
    dead = ~tr.live
    if (tr.u_l2[dead] != 0.0).any() or (tr.ship_floats[dead] != 0.0).any():
        raise AssertionError(f"{name}: a dead worker pushed or shipped")
    rec.update(
        loss_ref_first=float(tr.loss_ref[0]),
        loss_ref_last=float(tr.loss_ref[-1]),
        staleness={k: chk[k] for k in ("violations", "min", "bound",
                                       "live_frac")},
        retry_budget=retry_budget, dead_worker_clocks=int(dead.sum()),
        ship_floats_total=float(tr.ship_floats.sum(dtype="float64")),
        wire_counters={k: int(cst[k].sum()) for k in (
            "n_retx", "n_giveup", "n_duprej")},
        obs=check_obs_sums(tr, cfg))
    return rec, trace


def fault_path(device):
    """Phase 10: the fault path at full width (``FULL_MF``, the faults
    bench's config at its required window).  Three runs, each with
    ``obs=ObsSpec()`` (:func:`fault_run`): (a) the neutral twin
    (``wire.no_faults``), bit-equal in every Trace field and accumulator
    to ``faults=None``; (b) the burst faults; (c) the faults and the pod
    outage.  Each run's event stream must validate (``retry_budget``
    stamped on (b) and (c)); the recovery controller, with the faults
    bench's wire SLO over (a)'s floats per clock, must act on (b) and (c)
    and not on (a).  Profiled runs of (b) and (c) give the device time
    per clock, the kernels' share and the idle share."""
    import torch
    from repro_torch.apps import matfact
    from repro_torch.comm import wire
    from repro_torch.core import consistency as cc
    from repro_torch.core import delays, ps, timemodel
    from repro_torch.ctrl import recover
    from repro_torch.obs import ObsSpec, events, monitor
    from repro_torch.psrun import validate
    t0 = time.perf_counter()
    app = matfact.make_mf_app(matfact.MFConfig(**FULL_MF), device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    T, P, d = FAULT_CLOCKS, app.n_workers, app.dim
    faults = wire.make_faults(T, P, device=device, **FAULT_BURST)
    churn = delays.make_churn(T, P, device=device, **FAULT_POD_OUTAGE)
    cfg = fault_cfg(cc)
    cfg = cfg.replace(window=wire.required_window(cfg, faults))
    obs = ObsSpec()
    cases = (("neutral", dict(faults=wire.no_faults(T, P, device)), 0),
             ("faults", dict(faults=faults), faults.retry_budget),
             ("faults_churn", dict(faults=faults, schedule=churn),
              faults.retry_budget))
    recs, traces = {}, {}
    for name, kw, rb in cases:
        recs[name], traces[name] = fault_run(app, cfg, name, T, rb, obs=obs,
                                             **kw)
    plain = ps.simulate(app, cfg, T, seed=0, obs=obs)
    neutral = traces["neutral"]
    unequal = [f for f in validate.TRACE_FIELDS
               if not torch.equal(getattr(neutral, f), getattr(plain, f))]
    unequal += [f"obs.{k}" for k in plain.obs
                if not torch.equal(neutral.obs[k], plain.obs[k])]
    if unequal:
        raise AssertionError(f"fault path: the neutral twin differs from "
                             f"faults=None in {unequal}")
    del plain
    # the faults bench's wire-bound time model: a dense clock's shipments
    # take 3x the mean compute on the cross-pod tier
    t_comp = matfact.mf_time_model().t_comp
    tm = timemodel.TimeModel(t_comp=t_comp, bytes_per_channel=4.0 * d,
                             bandwidth_xpod=4.0 * P * d / (3.0 * t_comp))
    floats0 = float(neutral.ship_floats.sum()) / T
    slo = monitor.SLOParams(window=8,
                            max_floats_per_clock=WIRE_SLO_MARGIN * floats0)
    for name, kw, rb in cases:
        ev = events.collect_events(traces[name], cfg, tm,
                                   schedule=kw.get("schedule"),
                                   faults=kw["faults"], run=name)
        events.validate_events(ev)
        if ev[0].get("retry_budget", 0) != rb:
            raise AssertionError(f"{name}: run_start.retry_budget "
                                 f"{ev[0].get('retry_budget')} != {rb}")
        actions, res = recover.plan_recovery(ev, slo=slo)
        recs[name]["events"] = len(ev)
        recs[name]["controller"] = {
            "actions": [a["action"] for a in actions],
            "verdicts": len(res.verdicts),
            "violations_by_slo": res.health["violations_by_slo"],
            "degraded_config": {
                k: getattr(recover.apply_actions(cfg, actions), k)
                for k in ("quant", "agg_clocks")}}
        if (len(actions) > 0) != (name != "neutral"):
            emit(recs[name])
            raise AssertionError(f"{name}: the controller gave "
                                 f"{len(actions)} actions (neutral: none; "
                                 f"faulted: at least one)")
    for name, kw, _ in cases[1:]:
        split = device_split(app, cfg, T, obs=obs, **kw)
        recs[name].update(split)
        if split["device_ms_per_clock"] is not None:
            recs[name]["device_idle_share_cross_run"] = (
                1.0 - split["device_ms_per_clock"]
                / recs[name]["ms_per_clock"])
    recs["neutral"]["bit_equal_to_no_faults"] = True
    recs["neutral"]["make_mf_app_s"] = setup_s
    recs["neutral"]["wire_slo_floats_per_clock"] = slo.max_floats_per_clock
    del traces, neutral, app
    torch.cuda.empty_cache()
    return recs


def fault_card_vs_cpu(device):
    """Phase 11: ``MFConfig()`` under the fault path's config at its
    window, with every kind of fault (``SMALL_FAULTS``), a worker outage
    that drops its in-flight mass and ``obs``, on the card against the
    CPU: :func:`hold_card_to_cpu`, and the liveness, the wire counters and
    the integer accumulators exact."""
    import numpy as np
    from repro_torch.apps import matfact
    from repro_torch.comm import wire
    from repro_torch.core import consistency as cc
    from repro_torch.core import delays
    from repro_torch.obs import ObsSpec
    small, T = matfact.MFConfig(), SMALL_CLOCKS
    P = small.n_workers
    cfg = fault_cfg(cc)
    runs = []
    for dev in (device, "cpu"):
        faults = wire.make_faults(T, P, device=dev, **SMALL_FAULTS)
        run_cfg = cfg.replace(window=wire.required_window(cfg, faults))
        runs.append(simulate_recording_shipments(
            matfact.make_mf_app(small, device=dev), run_cfg, T,
            faults=faults, obs=ObsSpec(),
            schedule=delays.make_churn(T, P, device=dev, **SMALL_OUTAGE)))
    (got, gs, gcst), (want, ws, wcst) = runs
    rec = hold_card_to_cpu("fault_small", run_cfg, got, want, gs, ws,
                           phase="fault_card_vs_cpu")
    exact = {"live": bool((got.live.cpu() == want.live).all())}
    for k in ("n_retx", "n_giveup", "n_duprej", "recv_seq", "wire_tip"):
        exact[k] = bool((gcst[k].cpu() == wcst[k]).all())
    for k, v in got.obs.items():
        if k != "ship_floats":
            exact[f"obs.{k}"] = bool(np.array_equal(v.cpu().numpy(),
                                                    want.obs[k].numpy()))
    rec["exact"] = exact
    rec["wire_counters"] = {k: int(wcst[k].sum()) for k in (
        "n_retx", "n_giveup", "n_duprej")}
    emit(rec)
    if not all(exact.values()):
        raise AssertionError(f"fault card vs CPU: {exact}")
    return rec


def tuner_phase(device):
    """Phase 12: ``tune.frontier`` over (``ssp(3)``, ``essp(3)``) x
    ``push_prob`` in ``TUNE_PUSH_PROBS`` at full width, one seed, 30
    clocks, in runs per second (``ring_view`` and ``vap_suffix_norms``
    launched once per clock of every run); then at ``MFConfig()`` the
    frontier and ``grad_knobs`` on the card against the CPU: the same
    frontier, each point's losses and wall seconds within the ulp budget,
    the config knobs' gradients 0.0 on both, ``t_comp``'s within the
    budget."""
    import math
    import numpy as np
    import torch
    from repro_torch.apps import matfact
    from repro_torch.core import consistency as cc
    from repro_torch.core import tune
    from repro_torch.kernels import launch
    from repro_torch.psrun import validate
    budget = validate.VAP_ULP_BUDGET
    bases, grid = (cc.ssp(3), cc.essp(3)), {"push_prob": TUNE_PUSH_PROBS}
    tm = matfact.mf_time_model()
    app = matfact.make_mf_app(matfact.MFConfig(**FULL_MF), device=device)
    tune.frontier(app, bases, grid, time_model=tm, n_clocks=2, seeds=[0])
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    fr = tune.frontier(app, bases, grid, time_model=tm,
                       n_clocks=FULL_CLOCKS, seeds=[0])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(launch.launches)
    n_runs = len(fr.points)
    want = {"ring_view": n_runs * FULL_CLOCKS,
            "vap_suffix_norms": n_runs * FULL_CLOCKS}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"tuner: launches {launches}, expected {want}")
    if not all(math.isfinite(p["final_loss"]) for p in fr.points):
        raise AssertionError("tuner: a point's final loss is not finite")
    rec = {"phase": "tuner", "clocks": FULL_CLOCKS, "d": app.dim,
           "runs": n_runs, "seconds": secs, "runs_per_s": n_runs / secs,
           "launches": launches, "summary": fr.summary()}
    del app
    torch.cuda.empty_cache()

    def ulp(a, b, scale):
        return abs(a - b) / float(np.spacing(np.float32(abs(scale))))

    small = matfact.MFConfig()
    apps = [matfact.make_mf_app(small, device=dv) for dv in (device, "cpu")]
    got, want = (tune.frontier(a, bases, grid, time_model=tm,
                               n_clocks=SMALL_CLOCKS, seeds=[0])
                 for a in apps)
    worst = {"final_loss": 0.0, "wall_to_threshold": 0.0}
    for g, w in zip(got.points, want.points, strict=True):
        worst["final_loss"] = max(worst["final_loss"], ulp(
            g["final_loss"], w["final_loss"], w["final_loss"]))
        gw, ww = g["wall_to_threshold"], w["wall_to_threshold"]
        if math.isinf(gw) or math.isinf(ww):
            if gw != ww:
                raise AssertionError(f"tuner card vs CPU: {gw} vs {ww}")
        else:
            worst["wall_to_threshold"] = max(
                worst["wall_to_threshold"], ulp(gw, ww, w["wall_total"]))
    grads = [tune.grad_knobs(a, cc.essp(3), SMALL_CLOCKS, tm, budget=0.5,
                             knobs=("push_prob",), tm_knobs=("t_comp",))
             for a in apps]
    g_ulp = ulp(grads[0]["grads"]["t_comp"], grads[1]["grads"]["t_comp"],
                grads[1]["grads"]["t_comp"])
    v_ulp = ulp(grads[0]["value"], grads[1]["value"], grads[1]["value"])
    rec["card_vs_cpu"] = {
        "frontier_idx": got.frontier_idx, "max_ulp": worst,
        "grad_knobs": grads, "t_comp_grad_ulp": g_ulp, "value_ulp": v_ulp,
        "ulp_budget": budget}
    ok = (got.frontier_idx == want.frontier_idx
          and max(worst.values()) <= budget and g_ulp <= budget
          and v_ulp <= budget
          and grads[0]["grads"]["push_prob"] == 0.0
          and grads[1]["grads"]["push_prob"] == 0.0
          and grads[0]["grads"]["t_comp"] != 0.0)
    emit(rec)
    if not ok:
        raise AssertionError(f"tuner card vs CPU: {rec['card_vs_cpu']}")
    return rec


def runtime_run(rt, app, cfg, name, n_clocks, **kw):
    """Phase 13's run of one config: the flat runtime (``rt``, one NCCL
    rank) counted and watched as phase 3's runs are, after a 2-clock
    warm-up of both engines; then ``simulate`` on the card, the runtime
    again and ``simulate`` again, in turns, for clocks/s.  The runtime's
    trace must keep ``validate.contract`` against the simulator's (bsp,
    ssp, essp bit-identical; vap within the budget with exact decisions),
    and its ``obs``, when collected, must equal the simulator's.  Returns
    ``(record, runtime trace)``."""
    import torch
    from repro_torch.core import ps
    from repro_torch.kernels import launch
    from repro_torch.psrun import validate
    rt.run(app, cfg, 2, seed=1, **kw)     # communicators, PyTorch kernels
    ps.simulate(app, cfg, 2, seed=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    t0 = time.perf_counter()
    with watch_syncs() as found:
        trace = rt.run(app, cfg, n_clocks, seed=0, **kw)
    torch.cuda.synchronize()
    rt_s = [time.perf_counter() - t0]
    launches = dict(launch.launches)
    peak = torch.cuda.max_memory_allocated()
    def timed(run):
        t0 = time.perf_counter()
        out = run(app, cfg, n_clocks, seed=0, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    want, t_sim1 = timed(ps.simulate)       # the oracle; then in turns
    rt_s.append(timed(rt.run)[1])
    sim_s = [t_sim1, timed(ps.simulate)[1]]
    res = validate.contract(trace, want, cfg, faults=kw.get("faults"))
    rec = {"phase": "runtime", "config": name, "clocks": n_clocks,
           "world": 1, "backend": "nccl", "d": app.dim,
           "W": cfg.effective_window, "P": app.n_workers,
           "runtime_seconds": rt_s,
           "runtime_clocks_per_s": [n_clocks / t for t in rt_s],
           "simulate_seconds": sim_s,
           "simulate_clocks_per_s": [n_clocks / t for t in sim_s],
           "launches": launches, "host_syncs": len(found),
           "host_sync_sites": sorted({site for site, _ in found}),
           "max_memory_allocated_bytes": peak,
           "contract": {k: v for k, v in res.items()
                        if k in ("ok", "max_diff", "max_ulp",
                                 "decisions_exact", "violations")}}
    if trace.obs is not None:
        rec["obs_equal"] = all(torch.equal(trace.obs[k], want.obs[k])
                               for k in want.obs)
    if (launches != expected_launches(cfg, n_clocks) or found
            or not res["ok"] or not rec.get("obs_equal", True)):
        emit(rec)
        raise AssertionError(f"runtime {name}: launches {launches} "
                             f"(expected {expected_launches(cfg, n_clocks)})"
                             f", host syncs {rec['host_sync_sites']}, "
                             f"contract {rec['contract']}")
    assert_finite(trace, f"runtime {name}")
    del want
    return rec, trace


def runtime_checkpoint(rt, app, cfg, full, n_clocks, cut):
    """Save the runtime's state at clock ``cut`` to a temporary directory,
    restore it, resume: the stitched trace must equal the uninterrupted
    one (``full``) in every field; the file's bytes and the seconds of
    the save and the restore are recorded, and the directory deleted."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.psrun import validate
    from repro_torch.utils.tree import named_leaves
    tr1, mid = rt.run_from(app, cfg, cut, rt.init_state(app, cfg, seed=0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(tmp, f"clock{cut}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_runtime(path, mid)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = ckpt.restore_runtime(path, rt.init_state(app, cfg))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    leaves = all(a == b if isinstance(a, int) else torch.equal(a, b)
                 for (_, a), (_, b) in zip(named_leaves(mid),
                                           named_leaves(restored),
                                           strict=True))
    del mid
    tr2, _ = rt.run_from(app, cfg, n_clocks - cut, restored)
    unequal = [f for f in validate.TRACE_FIELDS if not torch.equal(
        getattr(full, f), getattr(tr2, f) if f == "x_final" else torch.cat(
            [getattr(tr1, f), getattr(tr2, f)]))]
    rec = {"phase": "runtime_checkpoint", "config": cfg.model, "clock": cut,
           "bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
           "leaves_equal": leaves, "resume_unequal_fields": unequal}
    if not leaves or unequal:
        emit(rec)
        raise AssertionError(f"runtime checkpoint at clock {cut}: {rec}")
    return rec


def runtime_phase(device):
    """Phase 13: the flat sharded runtime (``psrun.PSRuntime``) as a world
    of one NCCL rank at full width (``FULL_MF``), 30 clocks each of
    essp(3), vap(0.5) and the fault path's config at its window (22) with
    the burst faults and ``obs=ObsSpec()`` (:func:`runtime_run`); the
    essp(3) run's checkpoint at clock 15 (:func:`runtime_checkpoint`);
    the fault run's event stream through ``perfetto`` and ``promtext``,
    with their sizes."""
    import torch
    from repro_torch.apps import matfact
    from repro_torch.comm import wire
    from repro_torch.core import consistency as cc
    from repro_torch.core import timemodel
    from repro_torch.obs import MetricsRegistry, ObsSpec, drain_device, \
        events, perfetto, promtext
    from repro_torch.psrun import PSRuntime
    t0 = time.perf_counter()
    rt = PSRuntime(device=device)
    mesh_s = time.perf_counter() - t0
    app = matfact.make_mf_app(matfact.MFConfig(**FULL_MF), device=device)
    T, P, d = RUNTIME_CLOCKS, app.n_workers, app.dim
    faults = wire.make_faults(FAULT_CLOCKS, P, device=device, **FAULT_BURST)
    fcfg = fault_cfg(cc)
    fcfg = fcfg.replace(window=wire.required_window(fcfg, faults))
    recs, traces = {}, {}
    for name, cfg, kw in (("essp3", cc.essp(3), {}),
                          ("vap", cc.vap(FULL_VAP_V0), {}),
                          ("fault_burst", fcfg,
                           dict(faults=faults, obs=ObsSpec()))):
        recs[name], traces[name] = runtime_run(rt, app, cfg, name, T, **kw)
    recs["essp3"]["mesh_setup_s"] = mesh_s
    recs["essp3"]["checkpoint"] = runtime_checkpoint(
        rt, app, cc.essp(3), traces["essp3"], T, RUNTIME_CKPT_CLOCK)
    t_comp = matfact.mf_time_model().t_comp
    tm = timemodel.TimeModel(t_comp=t_comp, bytes_per_channel=4.0 * d,
                             bandwidth_xpod=4.0 * P * d / (3.0 * t_comp))
    reg = MetricsRegistry()
    drain_device(reg, traces["fault_burst"].obs)
    ev = events.collect_events(traces["fault_burst"], fcfg, tm,
                               faults=faults, run="runtime_faults",
                               registry=reg)
    events.validate_events(ev)
    trace_json = json.dumps(perfetto.from_events(ev), sort_keys=True,
                            separators=(",", ":"))
    recs["fault_burst"]["exporters"] = {
        "events": len(ev), "perfetto_bytes": len(trace_json.encode()),
        "promtext_bytes": len(promtext.render(reg).encode())}
    del traces, app, rt
    torch.cuda.empty_cache()
    # the runtime made this process's world of one NCCL rank: take it down
    torch.distributed.destroy_process_group()
    return recs


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
def lda_figure_cfgs(cc):
    """The C2-LDA figure's configs (``benchmarks/lda_convergence.py``)."""
    return [cc.bsp(), cc.ssp(5), cc.essp(5)]


def lda_breakdown_post(tm):
    """A sweep ``post``: the LDA time model's comm/comp split, folded over
    (config index, seed), computed on the trace's device."""
    def post(trace, cfg, seed, cfg_idx):
        return tm.breakdown_traced(trace, cfg.model, fold=(cfg_idx, seed))
    return post


def lda_sweep_phase(app):
    """The C2-LDA figure through ``sweep`` on the full-width app: one
    seed, a ``post`` of the LDA time model's breakdown.  One config is
    re-run through ``simulate`` at its harmonized window and must be
    bit-equal; a second sweep with ``keep_traces=False`` and ``timeit``
    returns posts only, bit-equal to the first's.  Each config's NLL must
    fall and its traces be finite; the counted first sweep must launch
    ``ring_view`` and ``vap_suffix_norms`` once per clock of every run."""
    import torch
    from repro_torch.apps import lda
    from repro_torch.core import consistency as cc
    from repro_torch.core import ps, sweep
    from repro_torch.kernels import launch
    from repro_torch.psrun import validate
    cfgs = lda_figure_cfgs(cc)
    post = lda_breakdown_post(lda.lda_time_model())
    launch.reset_launches()
    res = sweep.sweep(app, cfgs, LDA_CLOCKS, seeds=[0], post=post)
    launches = dict(launch.launches)
    runs = len(cfgs) * LDA_CLOCKS
    want = {"ring_view": runs, "vap_suffix_norms": runs}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"lda sweep: launches {launches}, expected "
                             f"{want} of the path's kernels")
    curves = {}
    for i, cfg in enumerate(cfgs):
        tr = res.trace(i, 0)
        assert_finite(tr, f"lda sweep {cfg.model}")
        lr = tr.loss_ref.cpu()
        if not lr[-1] < lr[0]:
            raise AssertionError(f"lda sweep {cfg.model}: NLL did not fall "
                                 f"({float(lr[0])} -> {float(lr[-1])})")
        curves[f"{cfg.model}({cfg.staleness})"] = {
            "window": res.harmonized[i].effective_window,
            "nll_first": float(lr[0]), "nll_last": float(lr[-1]),
            "breakdown": {k: float(v[0]) for k, v in res.post(i).items()}}
    rerun = ps.simulate(app, res.harmonized[2], LDA_CLOCKS, seed=0)
    got = res.trace(2, 0)
    unequal = [f for f in validate.TRACE_FIELDS
               if not torch.equal(getattr(got, f), getattr(rerun, f))]
    if not torch.equal(got.locals_final["z"], rerun.locals_final["z"]):
        unequal.append("locals_final.z")
    if unequal:
        raise AssertionError(f"lda sweep: trace(2, 0) differs from simulate "
                             f"at the harmonized window in {unequal}")
    lean = sweep.sweep(app, cfgs, LDA_CLOCKS, seeds=[0], post=post,
                       keep_traces=False, timeit=True)
    if lean.traces != [None] * len(cfgs):
        raise AssertionError("lda sweep: keep_traces=False kept traces")
    for i in range(len(cfgs)):
        for k, v in lean.post(i).items():
            if not torch.equal(v, res.post(i)[k]):
                raise AssertionError(f"lda sweep: post {k} of config {i} "
                                     f"differs between the two sweeps")
    n = len(cfgs) * len(res.seeds)
    return {"phase": "lda_sweep", "clocks": LDA_CLOCKS, "seeds": [0],
            "configs": curves, "launches": launches,
            "families": len(res.families), "runs": n,
            "t_first_s": res.t_first_s, "runs_per_s": n / res.t_first_s,
            "lean_t_first_s": lean.t_first_s, "lean_t_exec_s": lean.t_exec_s,
            "lean_runs_per_s": n / lean.t_exec_s,
            "rerun_bit_equal": True, "lean_posts_bit_equal": True}


@contextlib.contextmanager
def recording_draws():
    """Run the body with ``rng.categorical`` wrapped: each batched draw of
    the LDA sampler (one per clock) appends ``(z, logits + gumbel)`` on
    the host, the noise recomputed from the same keys."""
    from repro_torch import rng
    categorical, calls = rng.categorical, []

    def recording(key, logits, *args, **kw):
        out = categorical(key, logits, *args, **kw)
        if key.dim() == 2 and not args and not kw:
            noisy = logits + rng.gumbel(key, logits.shape[1:], logits.dtype)
            calls.append((out.cpu(), noisy.float().cpu()))
        return out

    rng.categorical = recording
    try:
        yield calls
    finally:
        rng.categorical = categorical


def first_draw_flip(got, want, limit_ulp):
    """The first clock whose sampled ``z`` differs between two runs'
    recorded draws, as ``{"clock", "draws_differ", "max_margin_ulp"}``, or
    None if every draw is equal.  A draw may only differ where its top-2
    margin of ``logits + gumbel`` is within ``limit_ulp`` ulp of the noisy
    values' scale on both devices: anything else raises."""
    import numpy as np
    for c, ((zg, ng), (zw, nw)) in enumerate(zip(got, want, strict=True)):
        differ = zg != zw
        if not differ.any():
            continue
        worst = 0.0
        for noisy in (ng, nw):
            top = noisy[differ].topk(2, dim=-1).values
            spacing = float(np.spacing(np.float32(noisy.abs().max())))
            margin = (top[:, 0] - top[:, 1]) / spacing
            if (margin > limit_ulp).any():
                raise AssertionError(
                    f"clock {c}: {int(differ.sum())} draws differ, with "
                    f"top-2 margins {margin.tolist()} ulp, over the "
                    f"{limit_ulp} ulp of a near tie")
            worst = max(worst, float(margin.max()))
        return {"clock": c, "draws_differ": int(differ.sum()),
                "max_margin_ulp": worst}
    return None


def lda_card_vs_cpu(device):
    """``LDAConfig()`` on the card against the CPU, from the CPU's corpus
    and counts, under ``ssp(3)`` and ``essp(3)`` through ``simulate`` and
    under the C2-LDA configs through ``sweep``: integer Trace fields equal;
    the float fields within the ulp budget up to the clock before the
    first one whose sampled ``z`` differs (a flipped draw moves whole
    counts), where every differing draw must be a near tie.  The corpus
    the card draws itself is compared with the CPU's and reported."""
    import torch
    from repro_torch.apps import lda
    from repro_torch.core import consistency as cc
    from repro_torch.core import ps, sweep
    from repro_torch.psrun import validate
    small = lda.LDAConfig()
    cpu_app = lda.make_lda_app(small, device="cpu")
    card_corpus = lda.lda_corpus(small, device)
    corpus_differ = {k: int((card_corpus[k].cpu() != cpu_app.local0[k])
                            .sum()) for k in ("words", "docid", "z")}
    card_app = lda.lda_app(small, cpu_app.x0.to(device),
                           {k: v.to(device) for k, v in
                            cpu_app.local0.items()})
    runs = []
    for name, cfg in (("ssp3", cc.ssp(3)), ("essp3", cc.essp(3))):
        with recording_draws() as gd:
            got = ps.simulate(card_app, cfg, SMALL_CLOCKS)
        with recording_draws() as wd:
            want = ps.simulate(cpu_app, cfg, SMALL_CLOCKS)
        runs.append((name, got, want, gd, wd))
    cfgs = lda_figure_cfgs(cc)
    with recording_draws() as gd:
        gs = sweep.sweep(card_app, cfgs, SMALL_CLOCKS)
    with recording_draws() as wd:
        ws = sweep.sweep(cpu_app, cfgs, SMALL_CLOCKS)
    for i, cfg in enumerate(cfgs):
        sl = slice(i * SMALL_CLOCKS, (i + 1) * SMALL_CLOCKS)
        runs.append((f"sweep_{cfg.model}{cfg.staleness}", gs.trace(i, 0),
                     ws.trace(i, 0), gd[sl], wd[sl]))
    budget = validate.VAP_ULP_BUDGET
    recs = []
    for name, got, want, gd, wd in runs:
        if not len(gd) == len(wd) == SMALL_CLOCKS:
            raise AssertionError(f"lda card vs CPU ({name}): {len(gd)} and "
                                 f"{len(wd)} sampler draws recorded, not "
                                 f"one per clock ({SMALL_CLOCKS})")
        diffs = validate.trace_max_diff(got, want)
        flip = first_draw_flip(gd, wd, LDA_TIE_ULP)
        ulps = validate.trace_max_ulp(got, want)
        if flip is not None:
            # a flip at clock 0 leaves only the integer fields to hold
            ulps = ulps_through(got, want, flip["clock"] - 1)
        rec = {"phase": "lda_card_vs_cpu", "config": name,
               "clocks": SMALL_CLOCKS, "draws_compared": len(gd),
               "int_fields_equal": all(diffs[f] == 0.0
                                       for f in validate.INT_FIELDS),
               "z_final_equal": bool(torch.equal(
                   got.locals_final["z"].cpu(), want.locals_final["z"])),
               "first_draw_flip": flip, "max_ulp": ulps,
               "ulp_budget": budget, "tie_limit_ulp": LDA_TIE_ULP,
               "card_corpus_differs": corpus_differ}
        emit(rec)
        if not rec["int_fields_equal"]:
            raise AssertionError(f"lda card vs CPU ({name}): integer fields "
                                 f"differ: {diffs}")
        if flip is None and not rec["z_final_equal"]:
            raise AssertionError(f"lda card vs CPU ({name}): every recorded "
                                 f"draw is equal but the final z differs")
        bad = {f: u for f, u in ulps.items() if u > budget}
        if bad:
            raise AssertionError(f"lda card vs CPU ({name}): {bad}")
        recs.append(rec)
    return recs


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
    from repro_torch.apps import lda, matfact
    from repro_torch.core import consistency as cc
    from repro_torch.core import sweep
    from repro_torch.kernels import build

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
    # the LDA path's rings at its ragged d: phase 7's ssp(3)/essp(3) window
    # and the windows phase 8's sweep harmonizes its families to
    d_lda = FULL_LDA["n_topics"] * FULL_LDA["vocab"]
    families = {}
    for c in lda_figure_cfgs(cc):
        families.setdefault(c.family, []).append(c)
    for W in sorted({cc.ssp(3).effective_window, cc.essp(3).effective_window,
                     *map(sweep.family_window, families.values())}):
        check_kernels((W, FULL_LDA["n_workers"], d_lda, 0), dev, rates,
                      timed=False, path="lda")
    # the fault path's rings (phases 10 and 12's window, W = 22), timed
    from repro_torch.comm import wire
    W_fault = fault_window(cc, wire)
    fault_ring = check_kernels((W_fault, 8, d_full, 0), dev, rates,
                               timed=True, path="fault")
    # ring_view on a shard's reader rows, as the sharded runtime (phase 13)
    # launches it, at the essp and fault-path windows
    reader_blocks = {W: check_reader_block(W, 8, d_full, dev, path=p)
                     for W, p in ((cc.essp(3).effective_window, None),
                                  (W_fault, "fault"))}
    # vap_suffix_norms on spiked rings, where a dropped first, last or seam
    # column, or a skipped oldest slot, shows: the fault path's ring, LDA's,
    # the ragged shapes above (its register instance) and both instances
    # at W = 64 and W = 33 across two seams
    for shape, path in (((W_fault, 8, d_full), "fault"),
                        ((cc.essp(3).effective_window, 8, d_lda), "lda"),
                        ((5, 16, 100_003), None), ((11, 8, 50_001), None),
                        ((64, 8, 4100), None), ((33, 4, 6147), None)):
        check_spiked(shape, dev, path=path)
    # the ptxas lines of vap_suffix_norms's kernels: no spills
    vap_ptxas = kernel_ptxas("ps_view", "vap_norms")
    fault_ring["vap_suffix_norms"]["ptxas"] = vap_ptxas
    if len(vap_ptxas) < 5 or any(
            ", 0 bytes spill stores, 0 bytes spill loads" not in ln
            for ln in vap_ptxas):
        raise AssertionError(f"vap_suffix_norms's kernels spill or have no "
                             f"ptxas lines: {vap_ptxas}")
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
    for name, cfg in (("essp3", cc.essp(3)), ("vap", cc.vap(SMALL_VAP_V0)),
                      *small_wired_cfgs(cc).items()):
        got, got_ships, _ = simulate_recording_shipments(
            matfact.make_mf_app(small, device=dev), cfg, SMALL_CLOCKS)
        want, want_ships, _ = simulate_recording_shipments(
            matfact.make_mf_app(small, device="cpu"), cfg, SMALL_CLOCKS)
        emit(hold_card_to_cpu(name, cfg, got, want, got_ships, want_ships))

    # --- 5. serving path at full width ---------------------------------------
    served = {arch: serve_path(arch, dev) for arch in SERVE_ARCHS}

    # --- 6. serving, card against CPU -----------------------------------------
    for arch in SERVE_ARCHS:
        for compute in ("bfloat16", "float32"):
            serve_card_vs_cpu(arch, compute, dev)

    # --- 7. LDA at full width -----------------------------------------------
    t0 = time.perf_counter()
    lda_app = lda.make_lda_app(lda.LDAConfig(**FULL_LDA), device=dev)
    torch.cuda.synchronize()
    emit({"phase": "lda_setup", "config": FULL_LDA, "d": lda_app.dim,
          "tokens": FULL_LDA["n_docs"] * FULL_LDA["doc_len"],
          "make_lda_app_s": time.perf_counter() - t0})
    lda_launches, lda_syncs = {}, {}
    for name, cfg in (("lda_ssp3", cc.ssp(3)), ("lda_essp3", cc.essp(3))):
        rec = run_main_path(lda_app, cfg, name, LDA_CLOCKS)
        rec["phase"] = "lda_main_path"
        emit(rec)
        lda_launches[name] = rec["launches"]
        lda_syncs[name] = rec["host_sync_sites"]
    if any(lda_syncs.values()):
        raise AssertionError(f"the LDA clock loop synchronized with the "
                             f"host: {lda_syncs}")

    # --- 8. the C2-LDA figure through sweep ----------------------------------
    lda_sweep = lda_sweep_phase(lda_app)
    emit(lda_sweep)
    del lda_app
    torch.cuda.empty_cache()

    # --- 9. LDA, card against CPU --------------------------------------------
    lda_card_vs_cpu(dev)

    # --- 10. the fault path at full width ------------------------------------
    faulted = fault_path(dev)
    for rec in faulted.values():
        emit(rec)

    # --- 11. the fault path, card against CPU -----------------------------------
    fault_card_vs_cpu(dev)

    # --- 12. the tuner ------------------------------------------------------------
    tuned = tuner_phase(dev)

    # --- 13. the sharded runtime as one NCCL rank ------------------------------
    runtime = runtime_phase(dev)
    for rec in runtime.values():
        emit(rec)
    runtime_launches = {n: r["launches"] for n, r in runtime.items()}

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
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            # the fault path's ring, where this kernel was redesigned
            f"W{fault_ring['W']}": {f: fault_ring[name][f] for f in (
                "ms", "plain_ms", "bound_ms", "max_abs_err")},
            # the sharded runtime's launches (phase 13)
            "runtime_launches": {n: r[name]
                                 for n, r in runtime_launches.items()}})
        if name == "ring_view":
            kernels[-1]["reader_block"] = {
                f"W{W}": {"bit_equal": r["bit_equal"],
                          "planted_fault_err": r["planted_fault_err"]}
                for W, r in reader_blocks.items()}
    pk = pack_main[wcfg.quant]
    kernels.append({
        "name": "delta_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_pack.cu",
        "replaces": "src/repro/kernels/delta_pack.py:56",
        "launches": main_launches["essp2_wired_int8"]["delta_pack"],
        "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
        "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
        "bound_by": pk["bound_by"], "library_ms": pk["library_ms"],
        "runtime_launches": {n: r["delta_pack"]
                             for n, r in runtime_launches.items()}})
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
          "lda_main_path_launches": lda_launches,
          "lda_sweep_launches": lda_sweep["launches"],
          "lda_sweep_runs_per_s": lda_sweep["runs_per_s"],
          "serve_launches_per_prefill": {
              a: r["launches_per_prefill"] for a, r in served.items()},
          "threshold_selection_ms": selection["ms"],
          "fault_ring_W22": {k: {f: fault_ring[k][f] for f in (
              "ms", "plain_ms", "bound_ms", "library_ms")}
              for k in ("ring_view", "vap_suffix_norms")},
          "fault_path": {n: {k: r.get(k) for k in (
              "clocks_per_s", "launches", "device_ms_per_clock",
              "kernel_ms_per_clock", "device_idle_share",
              "max_memory_allocated_bytes", "wire_counters")}
              for n, r in faulted.items()},
          "fault_controller_actions": {
              n: len(r["controller"]["actions"]) for n, r in faulted.items()},
          "tuner_runs_per_s": tuned["runs_per_s"],
          "runtime": {n: {k: r[k] for k in (
              "runtime_clocks_per_s", "simulate_clocks_per_s",
              "max_memory_allocated_bytes", "host_syncs")}
              for n, r in runtime.items()},
          "runtime_checkpoint": {k: runtime["essp3"]["checkpoint"][k]
                                 for k in ("bytes", "save_s",
                                           "restore_s")}})
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
