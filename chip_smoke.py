#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; never
JAX or the JAX package).  Sixteen phases, one JSON line each (or more):

1. device and build: the card's name and power limit, then ``nvcc``
   builds the kernels from ``src/repro_torch/kernels/csrc``;
2. every hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes, with its time, the
   plain version's time, a one-call library yardstick where there is one
   and the least time the card could take for the bytes these inputs need
   (over the H100 SXM data-sheet rates).  ``delta_pack`` must be
   bit-equal for f32, bf16 and int8; the comm substrate's threshold
   selection is timed beside the other exact selections;
   ``flash_attention_bwd`` (``check_flash_attention_bwd``, `BWD_SHAPES`:
   qwen3-0.6b's training step ``train_main``, deepseek-v2-lite's
   ``mla_train`` (Dk 576, Dv 512, V K's prefix) and stablelm-3b's
   ``stablelm_train`` (80, 80), each timed beside its bound, its plain
   version and the backward of one ``scaled_dot_product_attention``
   call, with its kernels' ptxas lines, no spills, and the bf16 kernels'
   stages, shared bytes and registers; head size 64, float32, rep 1, 4
   and 8, a window, masked keys, ragged Sq and Sk, rows that see no key;
   MLA's edge cases; deepseek's smoke config's (80, 64); (32, 16) and
   (32, 32), bf16 and float32) within ``ref.attention_bwd_tolerance`` of
   its plain version (with V as K's prefix, dK holding dV), where D taken
   as 0, a dropped key tile and, with V as K's prefix, dV left out of dK
   must fail, two calls bit-equal, and the forward with ``lse``
   bit-equal to the forward without;
   ``flash_attention`` (at the models' prefill shape, at MLA's,
   ``mla_main``: deepseek-v2-lite's Dk 576, Dv 512, one KV head, at
   whisper-medium's encoder, ``whisper_enc``, at llama-3.2-vision's
   prefill cross-attention, ``vlm_cross``, and at jamba-1.5-large's
   prefill, ``jamba_attn``: 8 query heads a KV head, each beside one
   ``scaled_dot_product_attention`` call as the library yardstick, with
   the backend it ran; also at every other shape of the two memory
   models' prefills, at MLA's and head size 80's edge shapes, bf16 and
   float32) and
   ``ssd`` (at mamba2-130m's prefill shape and at jamba-1.5-large's, 256
   heads in 32 groups, both timed and both required to run the
   ``p_split`` kernel) are held to their plain
   versions at the main path's shapes and at edge shapes (each record
   naming the kernel that ran, ``variant``; at ``main`` the kernel's ptxas
   lines, which must show no spills for ``ssd`` and the timed attention
   kernels (wgmma, MLA), their tile classes, and planted faults the
   limits must fail: two for attention at each timed shape (at a
   non-causal one the ragged last key tile dropped in place of a partial
   tile taken as full), two for ssd's
   y at ``main``, ``carry`` and ``jamba``, two for its
   state), and at the shapes of the JAX package's ``kernels`` suite;
   ``ssd_bwd`` (``check_ssd_bwd``: at mamba2-130m's and jamba's training
   shapes, timed beside its plain version and its bound (the products
   with a float32 operand at three bf16 tensor-core passes), each of its
   kernels' device ms, with its kernels' ptxas lines, no spills, the bf16
   kernels on the tensor cores among them; at the smoke configs' shape in
   bf16
   and float32, a ragged s, dt in mamba2's range and ties, with and
   without a cotangent of the final state) within
   ``ref.ssd_bwd_tolerance`` of ``ref.ssd_bwd``, two calls bit-equal,
   where a chunk given the next chunk's state gradient, a head left out
   of dB and, at the ties, the tie rule dropped must fail;
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
5. the serving path at full width and depth (``serve_path``):
   qwen3-0.6b, mamba2-130m, deepseek-v2-lite-16b (MLA, 64 routed + 2
   shared experts, top-6; bf16 weights), qwen3-moe-30b-a3b (128
   experts, top-8), whisper-medium (24 + 24 layers, float32 weights,
   bf16 compute, 1500 stub frames, a 416-token prompt: with 32 new tokens
   its 448-token text context) and llama-3.2-vision-11b (8 groups of 4
   self blocks and a gated cross block over 1601 stub image tokens, bf16
   weights, gates at ``VLM_GATE``), at their published widths and depth
   but for two cuts of depth (``SERVE_CUTS``: qwen3-moe-30b-a3b at 8 of
   48 layers, deepseek-v2-lite-16b at 6 of 27, so that the script keeps
   within its time limit), and jamba-1.5-large-398b at its published
   widths cut to fit one card (1 of its 9 groups, each expert's hidden
   size 4096 in place of 24576); the record lists each cut under
   ``"reduced"``, with
   random weights from a seed, batch 8, a 2048-token prompt (but
   whisper's) from ``token_batch`` and 32 new tokens, through
   ``repro_torch.launch.serve``, one model freed before the next is
   built: set-up (the weights' and the stub's draw) seconds, prefill and
   decode times and rates, peak memory, the kernels' launches per
   prefill (``flash_attention`` once per attention layer: whisper's
   encoder layers and its decoder's self and cross, 72; llama-vision's
   32 self and 8 cross, 40; ``ssd`` once per mamba2 layer; jamba's 7
   ``ssd`` and 1 ``flash_attention``), no host sync
   in the decode loop, and the device's idle share and each kernel's
   device ms per prefill from profiled runs;
6. every served arch's smoke config (the seven above and llama3-8b,
   qwen3-4b, stablelm-3b) on the card against the CPU, in bf16 and
   float32 (``serve_card_vs_cpu``): the prefill and each decode step held
   on the same inputs (the CPU runs the step again from a copy of the
   card's cache): the card's cache within the stated tolerance at every
   step, its logits within the tolerance plus twice what the step makes
   of its own rounding (the CPU's distance from its run of the step one
   precision up, bf16 in float32 and float32 in float64), and greedy
   tokens equal wherever the CPU's top-2 margin exceeds that; the card no
   farther from the run one precision up than the CPU plus the
   tolerance; the free-running distance within the bound plus what the
   caches' difference makes of the step; for the moe archs (and the
   hybrid arch, whose MoE sublayers are every other one) each layer's
   routing on both devices, the CPU's same-input runs on the card's
   routing (``moe.forcing``) so every sequence is held, every flip a near
   tie, at most an eighth of the routing decisions flipped; the audio
   and vlm archs with their
   stub, the memory's K/V held as every cache tensor, the VLM's gates at
   ``VLM_GATE``; the audio, vlm and hybrid archs' q/k/v projections at
   ``1/sqrt(d)`` (``condition_projections``); the hybrid arch's mamba
   conv windows and SSM states held as every cache tensor;
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
   event stream through ``obs.perfetto`` and ``obs.promtext`` (sizes);
14. the sweep sharded over a mesh (``sharded_sweep_phase``): the C2-LDA
   figure at full width with two seeds through ``sweep(...,
   mesh=make_batch_mesh())`` on a world of one NCCL rank and through the
   unsharded sweep, in turns: bit-equal traces and posts, one
   ``ring_view`` and one ``vap_suffix_norms`` per clock of every run, no
   host sync in a run's clock loop, runs per second of both, peak
   memory, the gathered bytes; ``tune.frontier(..., devices=[the card])``
   at ``MFConfig()`` equal to the unsharded frontier; ``python -m
   repro_torch.analysis src/repro_torch --strict`` as a subprocess (exit
   0, 0 findings, its seconds);
15. training at full width (``train_path``): qwen3-0.6b through
   ``python -m repro_torch.launch.train --arch qwen3-0.6b --full --batch 8
   --seq 2048 --steps 6`` (its ``main``; AdamW with the cosine schedule,
   BSP, remat on): ``flash_attention`` 56 and ``flash_attention_bwd`` 28
   launches a step and no other kernel; then the same steps from the
   launcher's pieces, each timed (ms a step, tokens/s, the warm-up step
   apart), peak memory, one profiled step (device ms, idle share, the
   kernels' and the top ops' device ms); every loss and ``grad_norm``
   finite and the last step's loss below step 1's and below the initial
   weights' loss on the same batch (each step draws a new batch, whose
   losses at the initial weights differ by ~10 %); SSP with a FIFO of
   2 for 4 steps: ``apply_scale`` 0, 0, 1, 1; then mamba2-130m and
   deepseek-v2-lite-16b the same way (``train_arch_path``: ``--arch
   mamba2-130m --full --batch 8 --seq 2048 --steps 6``: ``ssd`` 48 and
   ``ssd_bwd`` 24 launches a step; ``--arch deepseek-v2-lite-16b --full
   --layers 4``, its `TRAIN_CUTS` depth: ``flash_attention`` 8 (MLA's,
   with ``lse``) and ``flash_attention_bwd`` 4 (the MLA ``wgmma``
   kernels at (576, 512)); no other kernel), ms a step, tokens/s, peak
   memory, a profiled step, a finite loss that falls;
16. training on the card against the CPU (``train_card_vs_cpu``): the
   smoke configs of qwen3-0.6b, mamba2-130m, jamba-1.5-large-398b and
   deepseek-v2-lite-16b (MLA at (80, 64), V K's prefix) in bf16 and
   float32, 3 SGD steps from the same parameters and batches (mamba2's,
   Jamba's and deepseek's CPU steps from the card's parameters, then
   going on from their own; Jamba's and deepseek's on the card's MoE
   routing, recorded and forced under autograd): the loss,
   ``grad_norm``, every gradient leaf and every moved parameter within
   ``SERVE_TOL`` plus twice the step's own rounding (the CPU's run one
   precision up); AdamW's updates on identical gradients; a float32
   gradient through attention at (576, 512), which has no kernel yet,
   raises ``NotImplementedError`` naming ROADMAP 16.4f on the card.

Then the ``kernels`` summary line (the ``ps_view`` and ``delta_pack``
rows carry the runtime's launches too, the ``ps_view`` rows phase 14's), the card's ``nvidia-smi`` line,
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
# The C2-LDA figure through the sharded sweep (phase 14): two seeds.
SHARDED_SEEDS = (0, 1)
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
    # MLA's latent heads (Dk 576 = 512 + 64, Dv 512, V the first 512
    # columns of K, one KV head): "mla_main" is deepseek-v2-lite's prefill
    # (batch 8, 2048 tokens, 16 heads, bf16), timed; then ragged Sq = Sk =
    # 333, a window of 100 cutting through the MLA kernel's 64-key tiles,
    # masked keys, rows that see no key, non-causal Sq != Sk, 4 heads a KV
    # head at Hkv = 2 (Q and O by TMA in (64, 4, 16) boxes), 3 heads a KV
    # head (64-row items that are no box of q: Q by cp.async, O by plain
    # stores), float32; then the head size 80 of the MLA smoke config
    # (80, 64) and of stablelm-3b (80, 80)
    "mla_main": (8, 2048, 2048, 16, 1, 576, 512, True, None, "bf16",
                 "arange"),
    "mla_ragged333": (1, 333, 333, 16, 1, 576, 512, True, None, "bf16",
                      "arange"),
    "mla_window100": (2, 384, 384, 16, 1, 576, 512, True, 100, "bf16",
                      "arange"),
    "mla_holes": (2, 256, 256, 16, 1, 576, 512, True, None, "bf16",
                  "holes"),
    "mla_late_keys": (2, 200, 200, 16, 1, 576, 512, True, None, "bf16",
                      "late_keys"),
    "mla_noncausal": (2, 200, 300, 16, 1, 576, 512, False, None, "bf16",
                      "arange"),
    "mla_rep4": (2, 300, 300, 8, 2, 576, 512, True, None, "bf16",
                 "shuffled"),
    "mla_rep3": (2, 250, 250, 6, 2, 576, 512, True, None, "bf16", "holes"),
    "mla_f32": (1, 200, 200, 16, 1, 576, 512, True, None, "f32", "arange"),
    "bf16_d80_64": (2, 300, 300, 16, 16, 80, 64, True, None, "bf16",
                    "arange"),
    "f32_d80_64": (2, 300, 300, 16, 16, 80, 64, True, None, "f32",
                   "arange"),
    "bf16_d80_80": (2, 300, 300, 32, 32, 80, 80, True, None, "bf16",
                    "arange"),
    "f32_d80_80": (2, 300, 300, 32, 32, 80, 80, True, None, "f32",
                   "arange"),
    # the memory models' attention: whisper-medium's encoder (batch 8,
    # 1500 frames, 16 heads of 64, one head a KV head, non-causal: Sk is no
    # multiple of the 128-key tile) and llama-3.2-vision-11b's prefill
    # cross-attention (2048 queries over 1601 image tokens, 32 heads over 8
    # KV heads of 128, non-causal), both timed; then rep 1, non-causal,
    # head size 64 with a short ragged query block over whisper's frames;
    # then the other launches of those two prefills, untimed:
    # llama-3.2-vision's causal self-attention (32 heads over 8, rep 4),
    # whisper's causal decoder self-attention over its 416-token prompt
    # and its decoder cross-attention, 416 queries over 1500 frames
    "whisper_enc": (8, 1500, 1500, 16, 16, 64, 64, False, None, "bf16",
                    "arange"),
    "vlm_cross": (8, 2048, 1601, 32, 8, 128, 128, False, None, "bf16",
                  "arange"),
    "bf16_d64_rep1_noncausal": (2, 333, 1500, 4, 4, 64, 64, False, None,
                                "bf16", "arange"),
    "vlm_self": (8, 2048, 2048, 32, 8, 128, 128, True, None, "bf16",
                 "arange"),
    "whisper_dec_self": (8, 416, 416, 16, 16, 64, 64, True, None, "bf16",
                         "arange"),
    "whisper_dec_cross": (8, 416, 1500, 16, 16, 64, 64, False, None, "bf16",
                          "arange"),
    # jamba-1.5-large-398b's prefill attention (batch 8, 2048 tokens, 64
    # heads over 8 KV heads of 128: 8 heads a KV head), timed
    "jamba_attn": (8, 2048, 2048, 64, 8, 128, 128, True, None, "bf16",
                   "arange"),
}
# the timed cases and the kernel each runs
ATTN_TIMED = {"main": "fa_wgmma_kernel", "mla_main": "fa_mla_wgmma_kernel",
              "whisper_enc": "fa_wgmma_kernel",
              "vlm_cross": "fa_wgmma_kernel",
              "jamba_attn": "fa_wgmma_kernel"}
ATTN_TILE = 128     # the wgmma kernel's query block and KV tile
MLA_TILE = 64       # the MLA kernel's KV tile
MLA_ROWS = 64       # the MLA kernel's (query, head) rows a block
# ssd's phase shapes: (b, s, h, p, g, n, chunk, dtype, dt).  "main" is
# mamba2-130m's prefill (batch 8, 2048 tokens, h 24, headdim 64, 3 groups,
# d_state 128, chunk 128, bf16), "jamba" jamba-1.5-large-398b's (d_inner
# 16384 in 256 heads of 64, 32 groups: b·s·h·p = 2^28); then a ragged s,
# float32, and dt in mamba2's init range ("mamba"), where the state
# carries across chunks (at dt = softplus(N(0, 1)) a 128-long chunk decays
# it by about e^-100).
SSD_SHAPES = {
    "main": (8, 2048, 24, 64, 3, 128, 128, "bf16", "softplus"),
    "jamba": (8, 2048, 256, 64, 32, 128, 128, "bf16", "softplus"),
    "carry": (2, 2048, 24, 64, 3, 128, 128, "bf16", "mamba"),
    "ragged": (2, 2000, 24, 64, 3, 128, 128, "bf16", "softplus"),
    "f32_ragged": (2, 300, 24, 64, 3, 128, 128, "f32", "softplus"),
    "smoke_ragged": (4, 100, 16, 32, 2, 32, 32, "bf16", "softplus"),
    # the shape of the JAX package's kernels suite (benchmarks/kernels_bench)
    "kernels_bench": (1, 1024, 8, 64, 1, 64, 128, "f32", "softplus"),
}
# the timed cases (each must run the "p_split" kernel)
SSD_TIMED = ("main", "jamba")
# the cases at which ssd's y limit must fail its two planted faults
SSD_Y_FAULT_CASES = ("main", "carry", "jamba")
# ssd_bwd's phase cases: (an SSD_SHAPES-style shape, whether the final
# state takes a cotangent).  "main" and "jamba" are the training shapes
# of mamba2-130m and of jamba's mamba sublayers (8 x 2048 tokens, no
# cotangent of the state: the mamba block drops it), timed; then the
# smoke configs' shape (mamba2-130m's and Jamba's: h 16, p 32, g 2, n 32,
# chunk 32, phase 16's batch 4 x 64) in bf16 and float32, a ragged s, dt
# in mamba2's range, and ties ("ties": dt = 0 on spans of rows, where
# cum_i == cum_j and only JAX's tie rule holds).
SSD_BWD_SHAPES = {
    "main": (SSD_SHAPES["main"], False),
    "jamba": (SSD_SHAPES["jamba"], False),
    "smoke": ((4, 64, 16, 32, 2, 32, 32, "bf16", "softplus"), True),
    "smoke_f32": ((4, 64, 16, 32, 2, 32, 32, "f32", "softplus"), True),
    "ragged": (SSD_SHAPES["ragged"], True),
    "smoke_ragged": (SSD_SHAPES["smoke_ragged"], False),
    "carry": (SSD_SHAPES["carry"], True),
    "ties": ((2, 2048, 24, 64, 3, 128, 128, "bf16", "ties"), False),
    "ties_f32": ((2, 300, 8, 64, 2, 64, 128, "f32", "ties"), True),
}
SSD_BWD_TIMED = ("main", "jamba")
# the backward's kernels (csrc/ssd_scan_bwd.cu), for ptxas and the profiler:
# each name is the float32 kernel's and, with "_tc", the bf16 kernel's (both
# match it as a substring)
SSD_BWD_KERNELS = ("ssd_bwd_states", "ssd_bwd_dstates", "ssd_bwd_chunk")
# The split's diagnostic at these cases: ddt's error over its scale
# against ``ref.ssd_bwd`` (float32, its cumsum rounded as the kernel's).
# ``ref.ssd_bwd_tolerance`` (1e-4 of scale) also passes the kernel with
# the lo pass of every split product dropped (``ssd_bwd_ablation.py``'s
# ``no_lo``); this limit, between the sound kernel's readings and that
# copy's, does not.  Against the float64 gradient the two read alike:
# the float32 cumsum, which the contract fixes, dominates there; dA, a
# float32 sum over every row, does not tell them apart either.
SSD_BWD_SPLIT_CASES = ("main",)
SSD_BWD_SPLIT_LIMIT = 1e-6
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

# The serving path: the dense, ssm, audio and vlm families at full width
# and depth, the moe family at full width and a cut depth (the script's
# time), the hybrid family cut to fit one card (SERVE_CUTS); phase 6 runs
# the smoke config of every served arch.
SERVE_ARCHS = ("qwen3-0.6b", "mamba2-130m", "deepseek-v2-lite-16b",
               "qwen3-moe-30b-a3b", "whisper-medium", "llama-3.2-vision-11b",
               "jamba-1.5-large-398b")
SMOKE_ARCHS = ("qwen3-0.6b", "mamba2-130m", "llama3-8b", "qwen3-4b",
               "stablelm-3b", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
               "whisper-medium", "llama-3.2-vision-11b",
               "jamba-1.5-large-398b")
# jamba-1.5-large-398b has 401.8 B parameters; one group of its 8
# sublayers holds ~44.6 B, ~89 GB in bf16, more than the card's 80 GB, so
# no cut of depth alone fits one card.  Phase 5 serves 1 of its 9 groups
# (8 layers) with each expert's hidden size cut from 24576 to 4096.  Every
# width the kernels see (d_model, the heads, the mamba sublayers), the
# dense MLP, the router, the 16 experts and top-2 stay published.  The
# MoE archs whose weights' draw cost most of the script's time limit
# (qwen3-moe-30b-a3b 70.9 s at 48 layers, jamba 59.8 s at 2 groups,
# deepseek-v2-lite 38.5 s at 27 layers) are served at a cut depth, every
# width kept: their kernels run the same shapes once a layer.  A key "a.b"
# is field b of the config's sub-config a.
SERVE_CUTS = {"jamba-1.5-large-398b": {"n_layers": 8,
                                       "moe.d_ff_expert": 4096},
              "qwen3-moe-30b-a3b": {"n_layers": 8},
              "deepseek-v2-lite-16b": {"n_layers": 6}}
_DEPTH_WHY = ("the script's time limit: the weights' draw of every "
              "layer dominated phase 5; a layer's kernels and shapes do "
              "not change with depth")
SERVE_CUT_WHY = {
    "jamba-1.5-large-398b": "one group of 8 sublayers is ~89 GB in bf16 "
                            "against one 80 GB card; no expert-parallel "
                            "layer on one card; one group: " + _DEPTH_WHY,
    "qwen3-moe-30b-a3b": _DEPTH_WHY, "deepseek-v2-lite-16b": _DEPTH_WHY}
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
# whisper's text context is 448 tokens (arXiv:2212.04356): a 416-token
# prompt and 32 new tokens fill it
SERVE_PROMPTS = {"whisper-medium": 416}
# The VLM's cross-attention gates start at 0 (tanh(0) = 0 keeps the image
# path from the logits); phases 5 and 6 run them at this value.
VLM_GATE = 0.5
# The families whose smoke configs phase 6 runs with their q/k/v
# projections at 1/sqrt(d) (`condition_projections`), as the CPU tests do.
CONDITIONED = ("audio", "vlm", "hybrid")
# The profiled run that splits decode from prefill takes this many tokens
# (the profiler's events of 31 steps at 48 MoE layers took minutes to
# collect and read).
PROFILE_NEW = 8
# Card against CPU on the smoke configs: logits within this share of their
# largest magnitude.  float32: the products run in full float32 on both
# (no TF32), in other orders.  bfloat16: both round every product to
# bfloat16, at the same points, but a sum taken in another order can land
# one bfloat16 step away, and two layers carry it on (the port against the
# JAX package on the CPU stays within 0.6 %).
SERVE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 4, 100, 8
# A router near tie is a rounding decision: phase 6 compares each MoE
# layer's routing on the card and the CPU at every step on the same
# inputs, runs the CPU's step on the card's routing (`moe.forcing`) so
# that every sequence is held, and fails if a flip's CPU margin is wider
# than SERVE_TOL of the token's |x| @ |W_router| or if more than this
# share of the routing decisions (token and layer) flipped.  The moe
# archs' smoke configs flipped at most one token of one sequence; jamba's
# (4 MoE sublayers behind 7 bf16 mamba sublayers) 33–42 of its prefill's
# 1,600 decisions on an H100, in all 4 sequences: holding only the
# sequences whose routing agreed would hold none of its prefills.
FLIP_SHARE = 1 / 8

_lines: list[str] = []
T0 = time.perf_counter()


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - T0)
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
                "delta_pack": 0, "flash_attention": 0,
                "flash_attention_bwd": 0, "ssd": 0, "ssd_bwd": 0,
                "mf_sgd_block": 0}
    ships = sum(substrate.ship_now(c, cfg.agg_clocks)
                for c in range(n_clocks))
    return {"ring_view": 2 * n_clocks, "vap_suffix_norms": n_clocks,
            "delta_pack": ships, "flash_attention": 0,
            "flash_attention_bwd": 0, "ssd": 0, "ssd_bwd": 0,
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


def tree_equal(a, b) -> bool:
    """Exact equality (dtype included) of two trees of tensors: dicts,
    `Trace`s, None."""
    import dataclasses
    import torch
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    if dataclasses.is_dataclass(a):
        return all(tree_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a.dtype == b.dtype and torch.equal(a, b)


def tree_bytes(tree) -> int:
    import dataclasses
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return tree.numel() * tree.element_size()


def sharded_sweep_phase(device):
    """Phase 14: (a) the C2-LDA figure (``bsp``, ``ssp(5)``, ``essp(5)``)
    at full width (``FULL_LDA``), two seeds, with phase 8's ``post``,
    through ``sweep(..., mesh=make_batch_mesh())`` on a world of one NCCL
    rank and through the unsharded sweep, in turns (sharded, unsharded,
    sharded, unsharded): every trace and post of the sharded runs
    bit-equal to the unsharded ones; one ``ring_view`` and one
    ``vap_suffix_norms`` per clock of every run in each sweep; no host
    sync inside a run's clock loop (the gather after the runs may
    synchronize); runs per second of both and peak memory (each turn's
    own, above what it started with), after a 2-clock warm-up of both.  (b)
    ``tune.frontier(..., devices=[the card])`` at ``MFConfig()`` equal to
    the unsharded frontier point for point.  (c) ``python -m
    repro_torch.analysis src/repro_torch --strict`` in a subprocess:
    exit 0, 0 findings, its seconds."""
    import os
    import torch
    from repro_torch.apps import lda, matfact
    from repro_torch.core import consistency as cc
    from repro_torch.core import sweep, tune
    from repro_torch.kernels import launch
    from repro_torch.launch.mesh import make_batch_mesh
    rec = {"phase": "sharded_sweep", "clocks": LDA_CLOCKS,
           "seeds": list(SHARDED_SEEDS)}
    t0 = time.perf_counter()
    app = lda.make_lda_app(lda.LDAConfig(**FULL_LDA), device=device)
    torch.cuda.synchronize()
    rec["make_lda_app_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_batch_mesh()
    rec["mesh_setup_s"] = time.perf_counter() - t0
    rec["mesh"] = {"shape": list(mesh.shape),
                   "dims": list(mesh.mesh_dim_names),
                   "backend": torch.distributed.get_backend()}
    cfgs = lda_figure_cfgs(cc)
    post = lda_breakdown_post(lda.lda_time_model())
    runs = len(cfgs) * len(SHARDED_SEEDS)
    want = {"ring_view": runs * LDA_CLOCKS,
            "vap_suffix_norms": runs * LDA_CLOCKS}

    def counted(name, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        launch.reset_launches()
        with watch_syncs() as found:
            t = time.perf_counter()
            res = sweep.sweep(app, cfgs, LDA_CLOCKS, seeds=SHARDED_SEEDS,
                              post=post, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        launches = dict(launch.launches)
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"sharded sweep ({name}): launches "
                                 f"{launches}, expected {want}")
        in_loop = sorted({site for site, names in found
                          if "simulate_with_state" in names})
        return res, {"seconds": secs, "runs_per_s": runs / secs,
                     "t_first_s": res.t_first_s, "n_runs": res.n_runs,
                     "launches": launches, "host_syncs": len(found),
                     "clock_loop_syncs": in_loop,
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated(),
                     # the turn's own peak (earlier turns' results are held)
                     "peak_above_start_bytes":
                         torch.cuda.max_memory_allocated() - start}

    # a 2-clock warm-up of both paths (the NCCL communicator, PyTorch's
    # kernels and allocator), then the counted turns
    for kw in (dict(mesh=mesh), {}):
        sweep.sweep(app, cfgs, 2, seeds=SHARDED_SEEDS, post=post, **kw)
    turns = []
    for name, kw in (("sharded", dict(mesh=mesh)), ("unsharded", {}),
                     ("sharded", dict(mesh=mesh)), ("unsharded", {})):
        res, stats = counted(name, **kw)
        turns.append((name, res, stats))
    shard, flat = turns[0][1], turns[1][1]
    unequal = [i for i in range(len(cfgs))
               if not (tree_equal(shard.traces[i], flat.traces[i])
                       and tree_equal(shard.posts[i], flat.posts[i]))]
    again = [i for i in range(len(cfgs))
             if not tree_equal(turns[2][1].traces[i], shard.traces[i])]
    syncs = {f"{n}{k}": s["clock_loop_syncs"]
             for k, (n, _, s) in enumerate(turns) if s["clock_loop_syncs"]}
    rec["turns"] = [{"sweep": n, **s} for n, _, s in turns]
    rec["runs"] = runs
    rec["gather_bytes"] = sum(tree_bytes(t) + tree_bytes(p)
                              for t, p in zip(shard.traces, shard.posts,
                                              strict=True))
    rec["sharded_runs_per_s"] = [s["runs_per_s"] for n, _, s in turns
                                 if n == "sharded"]
    rec["unsharded_runs_per_s"] = [s["runs_per_s"] for n, _, s in turns
                                   if n == "unsharded"]
    rec["sharded_over_unsharded"] = [
        a / b for a, b in zip(rec["sharded_runs_per_s"],
                              rec["unsharded_runs_per_s"], strict=True)]
    rec["bit_equal"] = not unequal and not again
    rec["launches"] = turns[0][2]["launches"]
    for i, cfg in enumerate(cfgs):
        assert_finite(shard.trace(i, 0), f"sharded sweep {cfg.model}")
    del turns, shard, flat, app
    torch.cuda.empty_cache()
    if unequal or again:
        raise AssertionError(f"sharded sweep: configs {unequal} differ from "
                             f"the unsharded sweep, {again} between turns")
    if syncs:
        raise AssertionError(f"sharded sweep: host syncs in a run's clock "
                             f"loop: {syncs}")

    # (b) the tuner through the sharded path, at MFConfig()
    bases, grid = (cc.ssp(3), cc.essp(3)), {"push_prob": TUNE_PUSH_PROBS}
    tm = matfact.mf_time_model()
    small = matfact.make_mf_app(matfact.MFConfig(), device=device)
    fronts = [tune.frontier(small, bases, grid, time_model=tm,
                            n_clocks=SMALL_CLOCKS, seeds=[0], devices=dv)
              for dv in ([torch.device(device)], None)]

    def points(fr):
        return [(p["config"].model, float(p["config"].push_prob),
                 p["final_loss"], p["wall_to_threshold"],
                 p["final_loss_per_seed"], p["wall_to_threshold_per_seed"])
                for p in fr.points]
    tuner_equal = (points(fronts[0]) == points(fronts[1])
                   and fronts[0].frontier_idx == fronts[1].frontier_idx
                   and fronts[0].threshold == fronts[1].threshold)
    rec["tuner"] = {"points": len(fronts[0].points),
                    "frontier_idx": fronts[0].frontier_idx,
                    "equal_to_unsharded": tuner_equal}
    del small
    torch.cuda.empty_cache()
    # the sweep made this process's world of one NCCL rank: take it down
    torch.distributed.destroy_process_group()
    if not tuner_equal:
        raise AssertionError("sharded tuner: the frontier differs from the "
                             "unsharded one")

    # (c) the static checker, on this machine (no JAX here)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "src/repro_torch", "--strict"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    last = (out.stdout.strip().splitlines() or [""])[-1]
    rec["analysis"] = {"seconds": time.perf_counter() - t0,
                       "returncode": out.returncode, "summary": last}
    if out.returncode != 0 or not last.endswith("(strict): 0 findings"):
        raise AssertionError(f"repro_torch.analysis: rc {out.returncode}, "
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    return rec


def attn_inputs(shape, seed, device, v_prefix=False):
    """``(q, k, v, q_pos, kv_pos)`` on the card for one attention shape,
    made from a seed; positions as `ATTN_SHAPES` names them.  At MLA's
    (576, 512), and with ``v_prefix``, ``v`` is ``k[..., :Dv]``, as the
    model passes it."""
    import torch
    B, Sq, Sk, H, Hkv, Dk, Dv, _, _, dt, kind = shape
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gd = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gd, device=device).to(dtype)
               for s in ((B, Sq, H, Dk), (B, Sk, Hkv, Dk), (B, Sk, Hkv, Dv)))
    if (Dk, Dv) == (576, 512) or v_prefix:
        v = k[..., :Dv]
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
    the output read or written once over the memory rate (v not again
    where it is a view of k)."""
    import torch
    from repro_torch.kernels import ref
    bw, f32, bf16 = rates
    H, Dk, Dv = q.shape[2], q.shape[3], v.shape[3]
    # the mask broadcasts over the queries where nothing depends on them
    # (non-causal, no window): count it at its full [B, Sq, Sk] size
    pairs = int(ref._block_mask(qp, kp, causal, window).expand(
        qp.shape[0], qp.shape[1], kp.shape[1]).sum().item())
    ops = 2 * (Dk + Dv) * H * pairs
    v_bytes = 0 if v.data_ptr() == k.data_ptr() else v.numel()
    nbytes = (q.numel() + q.numel() // Dk * Dv + k.numel() + v_bytes) \
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


def planted_attention_faults(q, k, v, qp, kp, kw, want, atol, rtol,
                             tile=ATTN_TILE):
    """Max error of two faults made with the plain version, each of which
    the limit must fail: (a) one key tile dropped (keys 0-63 masked for
    the second half of the queries, rows that see over a thousand keys);
    (b) causal: a partial tile treated as full (every query's position
    rounded up to the end of its ``tile``-block, so it sees the whole
    diagonal tile); non-causal (every tile full but the ragged last one):
    the ragged last key tile dropped (keys from the last multiple of
    ``tile`` on masked)."""
    from repro_torch.kernels import ref
    h = q.shape[1] // 2
    kp_drop = kp.clone()
    kp_drop[:, :64] = -1
    faults = {
        "planted_fault_dropped_tile_err": (
            ref.attention(q[:, h:], k, v, **dict(kw, q_pos=qp[:, h:],
                                                 kv_pos=kp_drop)),
            want[:, h:])}
    if kw["causal"]:
        faults["planted_fault_partial_as_full_err"] = (
            ref.attention(q, k, v, **dict(
                kw, q_pos=qp // tile * tile + tile - 1)), want)
    else:
        Sk = k.shape[1]
        kp_tail = kp.clone()
        kp_tail[:, (Sk - 1) // tile * tile:] = -1
        faults["planted_fault_ragged_tile_dropped_err"] = (
            ref.attention(q, k, v, **dict(kw, kv_pos=kp_tail)), want)
    errs, missed = {}, []
    for key, (bad, ref_out) in faults.items():
        fdiff = (bad.float() - ref_out.float()).abs()
        errs[key] = fdiff.max().item()
        if not bool((fdiff > atol + rtol * ref_out.float().abs()).any()):
            missed.append(key)
        del bad, fdiff
    return errs, missed


def sdpa_call(q, k, v, causal, scale):
    """One ``scaled_dot_product_attention`` call on the port's layout, the
    library yardstick, with the backend PyTorch's dispatch picks for it
    (``torch._fused_sdp_choice``): with ``enable_gqa`` where K and V share
    q's head size, else with K and V expanded to q's heads (a view), which
    the efficient kernel takes at Dk != Dv.  ``(None, "none")`` if no
    backend takes the inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = q.shape[-1] == v.shape[-1]
    if not gqa:
        H = q.shape[2]
        kt, vt = kt.expand(-1, H, -1, -1), vt.expand(-1, H, -1, -1)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale, enable_gqa=gqa)
    try:
        call()
    except RuntimeError:
        return None, "none"
    choice = torch._fused_sdp_choice(qt, kt, vt, None, 0.0, causal,
                                     scale=scale, enable_gqa=gqa)
    return call, SDPBackend(choice).name.lower()


def check_flash_attention(name, device, rates, timed: bool):
    """``flash_attention`` against its plain version on one shape of
    `ATTN_SHAPES`, within ``ref.attention_tolerance``, with the kernel
    that ran (``variant``); timed at the main path's shapes (``main``,
    ``mla_main``) beside one ``scaled_dot_product_attention`` call (and
    the backend it ran), where the limit must also fail two planted faults
    (one key tile dropped, a partial tile of the kernel treated as full)
    and the kernel's tile classes and ptxas line (no spills) are
    recorded."""
    import torch
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
    mla = shape[5:7] == (576, 512)
    tile = MLA_TILE if mla else ATTN_TILE
    if timed and not bad:
        errs, missed = planted_attention_faults(q, k, v, qp, kp, kw, want,
                                                atol, rtol, tile)
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
        library, backend = sdpa_call(q, k, v, causal, scale)
        rec.update(
            ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20),
            plain_ms=time_ms(lambda: ref.attention(q, k, v, **kw), 3),
            library_ms=None if library is None else time_ms(library, 20),
            library_backend=backend, bound_ms=bound, bound_by=by,
            visible_pairs=pairs)
        # the kernel's blocks: 128 queries (wgmma), or 64 (query, head)
        # rows of one KV head (MLA: 64 / rep queries) over 64-key tiles
        rep = q.shape[2] // k.shape[2]
        bq = max(1, MLA_ROWS // rep) if mla else ATTN_TILE
        cls = ref.attention_tile_classes(qp, kp, causal, window, bq, tile)
        rec["tile_classes_per_head"] = {
            n: int((cls == c).sum()) for n, c in (
                ("skip", ref.TILE_SKIP), ("full", ref.TILE_FULL),
                ("partial", ref.TILE_PARTIAL))}
        rec["ptxas"] = kernel_ptxas("flash_attention", ATTN_TIMED[name])
        if not rec["ptxas"] or any(
                ", 0 bytes spill stores, 0 bytes spill loads" not in ln
                for ln in rec["ptxas"]):
            emit(rec)
            raise AssertionError(f"{ATTN_TIMED[name]} spills or has no "
                                 f"ptxas line: {rec['ptxas']}")
    emit(rec)
    return rec


def ssd_inputs(shape, seed, device):
    """``(x, dt, A, B, C)`` on the card for one SSD shape, made from a
    seed: dt softplus'd (or log-uniform in mamba2's dt init range [1e-3,
    1e-1]; or, for "ties", softplus'd and 0 on three spans of rows) and A
    negative, as the mamba2 block gives them."""
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
    if dt_kind == "ties":
        last = (s - 1) // shape[6] * shape[6]
        for lo, hi in ((3, 7), (40, 48), (last, last + 20)):
            dt[:, lo:hi] = 0.0
    A = -torch.exp(0.3 * torch.randn((h,), generator=gd, device=device))
    B, C = (torch.randn((b, s, g, n), generator=gd, device=device).to(dtype)
            for _ in range(2))
    return x, dt, A, B, C


def ssd_bound(shape, rates):
    """Least time (ms) for the SSD scan: per chunk of length L, the causal
    scores 2·n·L(L+1)/2, then the causal w·x̄ 2·p·L(L+1)/2, C·stateᵀ
    2·L·p·n and the state update 2·L·p·n, per (b, h); against x, dt, A,
    B, C, y and the state read or written once.  For bf16 inputs the
    scores take one bf16 pass on the tensor cores and each of the other
    three products three: each has an operand that is exactly bf16 (x̄ =
    dt·x with w's columns scaled by dt, C, B), and its float32 operand
    splits exactly into three bf16 pieces (hi, mid, lo: 24 significand
    bits in three of 8, ``ref.bf16_split3``), each partial product exact.
    For float32 inputs every product runs on the CUDA cores."""
    b, s, h, p, g, n, chunk, dt_, _ = shape
    elem = 2 if dt_ == "bf16" else 4
    tri = sum(L * (L + 1) // 2
              for L in (min(chunk, s - c) for c in range(0, s, chunk)))
    score_ops = 2 * n * tri * b * h
    f32_ops = (2 * p * tri + 4 * p * n * s) * b * h
    return _ops_bound(score_ops, f32_ops, elem, rates,
                      (2 * b * s * h * p + 2 * b * s * g * n) * elem
                      + 4 * (b * s * h + h + b * h * p * n))


def _ops_bound(score_ops, f32_ops, elem, rates, nbytes):
    """``(ms, "bytes" or "operations")`` of `ssd_bound` and
    `ssd_bwd_bound`: bf16 scores one pass and the products with a float32
    operand three passes on the tensor cores, float32 inputs all on the
    CUDA cores; against ``nbytes`` at the memory rate."""
    bw, f32, bf16 = rates
    if elem == 4:
        t_o = (score_ops + f32_ops) / f32 * 1e3
    else:
        t_o = (score_ops + 3 * f32_ops) / bf16 * 1e3
    t_b = nbytes / bw * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def check_ssd(name, device, rates, timed: bool):
    """``ssd`` against its plain version on one shape of `SSD_SHAPES`: y
    within ``ref.ssd_tolerance``, which must fail two planted faults at
    `SSD_Y_FAULT_CASES` (``ref.ssd_chunked_y_fault``: each chunk scanned
    alone, the state one chunk late), the final state within
    ``ref.ssd_state_tolerance``, which must fail two (the state rounded
    to bf16; with dt in mamba2's range, the state carried into the last
    chunk dropped); timed at the models' prefill shapes (`SSD_TIMED`),
    where the kernel that ran must be the models' ``"p_split"``."""
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
    if timed and rec["variant"] != "p_split":
        emit(rec)
        raise AssertionError(f"ssd ran {rec['variant']!r}, not the models' "
                             f"p_split kernel ({name})")
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


def ssd_bwd_bound(shape, rates):
    """Least time (ms) for the SSD backward: per chunk of length L and
    (b, h), the causal scores C·Bᵀ 2·n·L(L+1)/2 and the causal dy·xᵀ
    2·p·L(L+1)/2 (dy·x̄ᵀ with column j scaled by dt_j afterwards: both
    operands are inputs), then Wᵀ·dy 2·p·L(L+1)/2, DS·B and DSᵀ·C
    2·n·L(L+1)/2 each, and five [L, p, n] products of 2·L·p·n each (the
    states entering each chunk, their gradients, and the state terms of
    dx̄, dB and dC); against x, dy, dt, A, B, C read and dx, ddt, dA, dB,
    dC written once.  Each of those products has an operand that is
    exactly bf16 for bf16 inputs (dy, B, C, x, B, dy, B, C), so as in
    `ssd_bound` the scores take one bf16 pass on the tensor cores and the
    products three (the exact split of the float32 operand); float32
    inputs run everything on the CUDA cores."""
    b, s, h, p, g, n, chunk, dt_, _ = shape
    elem = 2 if dt_ == "bf16" else 4
    tri = sum(L * (L + 1) // 2
              for L in (min(chunk, s - c) for c in range(0, s, chunk)))
    score_ops = (2 * n + 2 * p) * tri * b * h
    f32_ops = (2 * p * tri + 4 * n * tri + 10 * p * n * s) * b * h
    return _ops_bound(score_ops, f32_ops, elem, rates,
                      (3 * b * s * h * p + 4 * b * s * g * n) * elem
                      + 4 * (2 * b * s * h + 2 * h))


def check_ssd_bwd(name, device, rates, timed: bool):
    """``ssd_bwd`` against ``ref.ssd_bwd`` on one case of `SSD_BWD_SHAPES`:
    every gradient within ``ref.ssd_bwd_tolerance`` (``ref.ssd_bwd_within``),
    which must fail the planted faults (``ref.ssd_bwd_fault``: a chunk
    given the state gradient of the next, a head of each group left out
    of dB, and at the "ties" cases the tie rule dropped); two calls
    bit-equal (no atomics).  At `SSD_BWD_SPLIT_CASES` ddt within
    `SSD_BWD_SPLIT_LIMIT` of its scale, which a kernel whose split lost
    its lo piece misses.  Timed at the training shapes
    (`SSD_BWD_TIMED`) beside the plain version and the bound, with the
    kernels' ptxas lines (no spills); no PyTorch call computes this
    gradient (``library_ms`` None)."""
    import torch
    from repro_torch.kernels import ref, ssd_scan
    shape, with_ds = SSD_BWD_SHAPES[name]
    b, s, h, p, g, n, chunk = shape[:7]
    x, dt, A, B, C = ssd_inputs(shape, seed=sum(shape[:7]) + 3,
                                device=device)
    gd = torch.Generator(device=device).manual_seed(sum(shape[:7]) + 4)
    dy = torch.randn(x.shape, generator=gd, device=device).to(x.dtype)
    ds = (torch.randn((b, h, p, n), generator=gd, device=device)
          if with_ds else None)
    got = ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    again = ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    torch.cuda.synchronize()
    variant = ssd_scan.last_variant
    want = ref.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    names = ("dx", "ddt", "dA", "dB", "dC")
    rec = {"phase": "kernels", "kernel": "ssd_bwd", "case": name,
           "variant": variant,
           "shape": dict(zip(("b", "s", "h", "p", "g", "n", "chunk"),
                             shape[:7], strict=True)), "dtype": shape[7],
           "dt": shape[8], "dstate": with_ds,
           "repeat_bit_equal": all(
               torch.equal(u.view(torch.int16 if u.dtype == torch.bfloat16
                                  else torch.int32),
                           v.view(torch.int16 if v.dtype == torch.bfloat16
                                  else torch.int32))
               for u, v in zip(got, again, strict=True)),
           "finite": all(bool(torch.isfinite(t).all()) for t in got),
           "max_abs_err": max((u.float() - w.float()).abs().max().item()
                              for u, w in zip(got, want, strict=True)),
           "err_over_scale_by_output": {
               k: ((u.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
               for k, u, w in zip(names, got, want, strict=True)},
           "scale_by_output": {k: w.float().abs().max().item()
                               for k, w in zip(names, want, strict=True)},
           "tol": {str(t).split(".")[-1]: ref.ssd_bwd_tolerance(t)
                   for t in (x.dtype, torch.float32)},
           "within": ref.ssd_bwd_within(got, want)}
    del again
    if name in SSD_BWD_SPLIT_CASES:
        rec["split_limit_ddt"] = SSD_BWD_SPLIT_LIMIT
    faults = [f for f in ref.SSD_BWD_FAULTS
              if f != "no_tie_rule" or shape[8] == "ties"]
    missed = []
    for fault in faults:
        wrong = ref.ssd_bwd_fault(x, dt, A, B, C, dy, ds, chunk, fault)
        rec[f"planted_fault_{fault}_err_over_scale"] = max(
            ((u.float() - w.float()).abs().max() / w.float().abs().max())
            .item() for u, w in zip(wrong, want, strict=True))
        if ref.ssd_bwd_within(wrong, want):
            missed.append(fault)
        del wrong
    del got, want
    if not (rec["within"] and rec["repeat_bit_equal"] and rec["finite"]):
        emit(rec)
        raise AssertionError(f"ssd_bwd disagrees with its plain version "
                             f"({name}): {rec}")
    if missed:
        emit(rec)
        raise AssertionError(f"ssd_bwd's limit passes planted faults "
                             f"{missed} ({name}): {rec}")
    if (name in SSD_BWD_SPLIT_CASES and rec["err_over_scale_by_output"][
            "ddt"] > SSD_BWD_SPLIT_LIMIT):
        emit(rec)
        raise AssertionError(f"ssd_bwd's ddt is past the split's limit "
                             f"({name}): {rec}")
    if timed:
        bound, by = ssd_bwd_bound(shape, rates)
        rec.update(
            ms=time_ms(lambda: ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds,
                                                chunk), 10),
            forward_ms=time_ms(lambda: ssd_scan.ssd(x, dt, A, B, C,
                                                    chunk=chunk), 10),
            plain_ms=time_ms(lambda: ref.ssd_bwd(x, dt, A, B, C, dy, ds,
                                                 chunk), 2, warmup=1),
            library_ms=None, bound_ms=bound, bound_by=by,
            smem_bytes=ssd_scan.bwd_smem_bytes(p, n, chunk,
                                               shape[7] == "bf16"),
            # each kernel's device ms in one profiled call, and the
            # wrapper's sums over the groups' heads and casts
            kernel_ms=mf_kernel_ms(
                lambda: ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk),
                {k: (k,) for k in SSD_BWD_KERNELS}
                | {"sums_and_casts": ("reduce_kernel",
                                      "elementwise_kernel")}),
            ptxas=[ln for e in SSD_BWD_KERNELS
                   for ln in kernel_ptxas("ssd_scan_bwd", e)])
        if len(rec["ptxas"]) < 8 or any(k + "_tc" not in "".join(rec["ptxas"])
                                         for k in SSD_BWD_KERNELS) or any(
                ", 0 bytes spill stores, 0 bytes spill loads" not in ln
                for ln in rec["ptxas"]):
            emit(rec)
            raise AssertionError(f"ssd_bwd's kernels spill or have no "
                                 f"ptxas lines: {rec['ptxas']}")
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
                                     "fa_mla_wgmma_kernel", "fa_f32_kernel"),
                 "ssd": ("split::split_kernel", "5split12split_kernel",
                         "ssd_kernel")}


def profiled_run(model, prompts, new, stub):
    """Host ms and device-busy ms of one ``serve.run`` under the profiler,
    with the port's kernels' share (in all and per kernel) and the eight
    ops that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run(model, prompts, new, stub)
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
                 key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": busy / 1e3,
            "kernel_ms": sum(per_kernel.values()) / 1e3,
            "kernel_ms_by_name": {k: v / 1e3 for k, v in per_kernel.items()},
            "top_ops_ms": {e.key: e.self_device_time_total / 1e3
                           for e in ops}}


def prefill_launches(cfg) -> dict:
    """The kernels' launches of one prefill: ``flash_attention`` once per
    attention layer (an audio model's encoder layers, and its decoder
    layers twice, self and cross; a VLM's layers, its cross blocks
    included; a hybrid model's one a group), ``ssd`` once per mamba layer
    (the ssm family's layers, a hybrid group's ``attn_every - 1``)."""
    if cfg.family == "ssm":
        return {"ssd": cfg.n_layers}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        return {"ssd": groups * (cfg.attn_every - 1),
                "flash_attention": groups}
    if cfg.family == "audio":
        return {"flash_attention": cfg.encoder.n_layers + 2 * cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


def serve_config(arch, cuts=None, why=None, used="served"):
    """``(config, reduced)``: the published config of ``arch`` with its
    `SERVE_CUTS` (or ``cuts``) applied, and the record of each key cut
    (its published and ``used`` values, and why: `SERVE_CUT_WHY` or
    ``why``), ``None`` for an arch run whole."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cuts = (SERVE_CUTS if cuts is None else cuts).get(arch)
    if not cuts:
        return cfg, None
    reduced = {}
    for key, value in cuts.items():
        sub, _, field = key.rpartition(".")
        part = getattr(cfg, sub) if sub else cfg
        reduced[key] = {"published": getattr(part, field), used: value}
        part = dataclasses.replace(part, **{field: value})
        cfg = cfg.replace(**{sub: part}) if sub else part
    reduced["why"] = (SERVE_CUT_WHY if why is None else why)[arch]
    return cfg, reduced


def serve_path(arch, device):
    """The serving path at full width and depth through
    ``repro_torch.launch.serve``: a warm-up run, then one counted run
    (launch counts set to 0 just before and read just after; the whole run
    under the sync watch), then two profiled runs (prefill alone, and
    prefill with the decode loop) for the device's idle share.  The depth
    is the published one, but for the archs of `SERVE_CUTS` (the record
    lists each cut under ``"reduced"``); the audio and vlm families take
    their modality stub (drawn in the set-up), the VLM's gates are set to
    ``VLM_GATE``."""
    import torch
    from repro_torch.data.synthetic import modality_stub
    from repro_torch.kernels import launch
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model
    B, S, new = SERVE_BATCH, SERVE_PROMPTS.get(arch, SERVE_PROMPT), SERVE_NEW
    t0 = time.perf_counter()
    cfg, reduced = serve_config(arch)
    model = build_model(cfg, seed=0, device=device)
    prompts = serve.make_prompts(model, B, S, seed=0)
    stub = modality_stub(cfg, B, device=model.device)
    if cfg.family == "vlm":
        model.blocks.cross.gate.fill_(VLM_GATE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    serve.run(model, prompts, 2, stub)  # cuBLAS, the allocator at full size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    with watch_syncs() as found:
        res = serve.run(model, prompts, new, stub)
    torch.cuda.synchronize()
    launches = dict(launch.launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want.update(prefill_launches(cfg))
    decode_syncs = [site for site, names in found if "decode_loop" in names]
    tok, logits = res["tokens"], res["logits"]
    rec = {"phase": "serve_path", "arch": arch, "n_params": model.n_params,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "reduced": reduced,
           "param_dtype": cfg.param_dtype,
           "total_memory_bytes": torch.cuda.get_device_properties(
               device).total_memory,
           "vocab": cfg.vocab_size, "compute_dtype": cfg.compute_dtype,
           "batch": B, "prompt": S, "new": new, "setup_s": setup_s,
           "prefill_ms": res["prefill_s"] * 1e3,
           "prefill_tokens_per_s": B * S / res["prefill_s"],
           "decode_ms_per_step": res["decode_s"] * 1e3 / (new - 1),
           "decode_tokens_per_s": B * (new - 1) / res["decode_s"],
           "max_memory_allocated_bytes": peak,
           "stub": {k: list(v.shape) for k, v in stub.items()},
           "vlm_gate": VLM_GATE if cfg.family == "vlm" else None,
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
    pre = profiled_run(model, prompts, 1, stub)
    full = profiled_run(model, prompts, PROFILE_NEW, stub)
    dec_wall = (full["wall_ms"] - pre["wall_ms"]) / (PROFILE_NEW - 1)
    dec_dev = (full["device_ms"] - pre["device_ms"]) / (PROFILE_NEW - 1)
    rec["profiled"] = {
        "prefill_wall_ms": pre["wall_ms"], "prefill_device_ms":
        pre["device_ms"], "prefill_kernel_ms": pre["kernel_ms"],
        "prefill_kernel_ms_by_name": pre["kernel_ms_by_name"],
        "prefill_device_idle_share": 1.0 - pre["device_ms"] / pre["wall_ms"],
        "prefill_top_ops_ms": pre["top_ops_ms"],
        "decode_wall_ms_per_step": dec_wall,
        "decode_device_ms_per_step": dec_dev,
        "decode_device_idle_share": 1.0 - dec_dev / dec_wall,
        "decode_profiled_steps": PROFILE_NEW - 1,
        "decode_top_ops_ms_per_step": {
            k: (v - pre["top_ops_ms"].get(k, 0.0)) / (PROFILE_NEW - 1)
            for k, v in full["top_ops_ms"].items()},
        "run_device_idle_share": 1.0 - full["device_ms"] / full["wall_ms"]}
    unseen = [k for k, n in want.items()
              if n and not pre["kernel_ms_by_name"].get(k)]
    emit(rec)
    if unseen:  # SERVE_KERNELS must name every kernel the path launches
        raise AssertionError(f"serve_path {arch}: the profiler saw no device "
                             f"time for {unseen}")
    del model, prompts, stub, res
    torch.cuda.empty_cache()
    return rec


def _to(tree, device, dtype=None):
    """A copy of a (nested) tensor tree on ``device``, its floats in
    ``dtype`` when one is given."""
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    t = tree.detach().to(device, copy=True)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def cache_rows(cache, prefix=""):
    """The leaves of a (nested) cache by path, each with its leading
    layers axes flattened into one, so the batch is axis 1.  A dict's
    ``pos`` is ``[*layers, batch]`` and says how many there are (a VLM's
    ``self`` caches have two: groups, then self blocks); a leaf beside no
    ``pos`` has one."""
    lead = cache["pos"].dim() - 1 if "pos" in cache else 1
    out = {}
    for k, v in cache.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(cache_rows(v, f"{path}/"))
        else:
            out[path] = v.flatten(0, lead - 1)
    return out


def condition_projections(model):
    """Scale every ``[..., d, heads, head_dim]`` projection (``wq``,
    ``wk``, ``wv``) by ``sqrt(heads / d)``, in place: at the init's
    ``1/sqrt(heads)`` (its fan-in is the last-but-one axis) the smoke
    models' attention logits run to the hundreds and their softmax is near
    one-hot, so a one-ulp move of a logit moves the output by a whole
    weight; at ``1/sqrt(d)`` the logits are of order 1."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv") and p.dim() >= 4:
            p.data.mul_(math.sqrt(p.shape[-2] / p.shape[-3]))


def serve_card_vs_cpu(arch, compute, device):
    """The smoke config of ``arch`` (compute dtype ``compute``), with the
    same weights on the card and on the CPU: the prefill and
    ``SMOKE_NEW - 1`` greedy decode steps, each held on the same inputs.
    The prefill is; each decode step runs on the CPU a second time from a
    copy of the card's cache, fed the token of the CPU's free-running run.
    At every step the card's updated cache lies within ``SERVE_TOL`` of
    that run's (of each cache tensor's largest magnitude), its logits
    within ``bound`` of the logits' scale, and its greedy token is the
    CPU's wherever the CPU's top-2 margin is wider than ``bound``.

    ``bound`` is ``SERVE_TOL`` plus twice ``d``, what the step makes of its
    own rounding: the CPU also runs each step one precision up on the same
    inputs (bfloat16 in float32, float32 in float64), and ``d`` is the
    CPU's distance from that run.  The card runs the same code as the CPU
    and rounds at the same points, so its own distance from that run must
    stay within ``d`` plus ``SERVE_TOL`` (then the two lie within ``2 d``
    plus ``SERVE_TOL`` of each other).  ``d`` is far under ``SERVE_TOL``
    but in the archs without qk-norm (llama3-8b, stablelm-3b) and
    deepseek-v2-lite's smoke config, whose steps amplify a rounding at
    random init.

    The free-running distance (each device on its own cache) is held
    within ``bound`` plus the distance between the CPU's two runs, what
    the caches' difference makes of the step.  For an arch with MoE
    layers each layer's routing is recorded (``moe.recording``): the
    CPU's same-input run and the run one precision up take the card's
    routing (``moe.forcing``; a router near tie is a rounding decision,
    and a flipped one would move a sequence by a whole expert), so every
    sequence is held at every step, while each layer's own choice is
    recorded and compared with the card's: every flip must be a near tie
    (the CPU's margin within ``SERVE_TOL`` of the token's ``|x| @
    |W_router|``), and at most ``FLIP_SHARE`` of the routing decisions
    (token and layer) may flip.  Last, ``generate_scan`` through
    ``launch.serve.run`` on both (the share of equal tokens is
    recorded).

    The audio and vlm archs take their modality stub (the same on both
    devices) and keep the memory's K/V in their caches; the VLM's gates
    are set to ``VLM_GATE``.  The families of `CONDITIONED` have their
    q/k/v projections scaled to ``1/sqrt(d)`` (`condition_projections`;
    the audio and vlm smoke configs stack 4 and 10 attention layers whose
    near one-hot softmax would make every comparison one of tie-breaking),
    as the CPU tests do.  The hybrid arch's caches hold its mamba
    sublayers' conv windows and SSM states beside the attention's K/V."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import modality_stub
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.registry import Model, build_model
    cfg = get_smoke_config(arch).replace(compute_dtype=compute)
    cpu = build_model(cfg, seed=0, device="cpu")
    if cfg.family in CONDITIONED:
        condition_projections(cpu)
    if cfg.family == "vlm":
        cpu.blocks.cross.gate.data.fill_(VLM_GATE)
    card = Model(cfg, _to(cpu.params, device))
    up = {"bfloat16": "float32", "float32": "float64"}[compute]
    hi = Model(cfg.replace(compute_dtype=up), cpu.params)
    prompts = serve.make_prompts(cpu, SMOKE_BATCH, SMOKE_PROMPT, seed=0)
    stub = modality_stub(cpu.cfg, SMOKE_BATCH, device=cpu.device)
    tol = SERVE_TOL[compute]
    B, n = SMOKE_BATCH, SMOKE_PROMPT + SMOKE_NEW
    flips, steps, flipped, decisions = [], [], 0, 0

    def step(model, tokens, cache, force=None):
        """``model``'s prefill (a ``None`` cache) or decode step, on the
        routing ``force`` where one is given: last logits on the CPU
        (float64), the cache, the routing it chose."""
        dev = "cpu" if model is not card else device
        with moe.recording() as route, moe.forcing(force):
            if cache is None:
                lg, cache = model.prefill(tokens.to(dev),
                                          model.init_cache(B, n),
                                          **_to(stub, dev))
            else:
                lg, cache = model.decode_step(tokens.to(dev), cache)
        return lg[:, -1].double().cpu(), cache, route

    def rows(a, b, scale):
        return (a - b).abs().amax(-1) / scale

    def peak(t):
        """The largest magnitude of ``t`` (a tiny one when it is empty)."""
        return float(t.double().abs().max()) if t.numel() else 1e-30

    got, card_cache, route = step(card, prompts, None)
    free, cpu_cache, want_route = step(cpu, prompts, None)
    same, same_cache = free, cpu_cache
    if route:
        same, same_cache, want_route = step(cpu, prompts, None, route)
    exact, _, _ = step(hi, prompts, None, route or None)
    for i in range(SMOKE_NEW):
        if route:
            seqs, fl = moe.routing_agreement(route, want_route, tol)
            flips.extend((i, *f) for f in fl)
            flipped += int((~seqs).sum())
            decisions += sum(r["eidx"][..., 0].numel() for r in route)
        card_rows = cache_rows(card_cache)
        same_rows = cache_rows(same_cache)
        cache_err = max((peak(card_rows[k].cpu().double() - w.double())
                         / peak(w) for k, w in same_rows.items()
                         if w.is_floating_point()), default=0.0)
        ints_equal = all(torch.equal(card_rows[k].cpu(), w)
                         for k, w in same_rows.items()
                         if not w.is_floating_point())
        scale = peak(same)
        d, own = rows(same, exact, scale), rows(got, exact, scale)
        bound = tol + 2 * d
        err = rows(got, same, scale)
        moved = rows(free, same, scale)
        free_err = rows(got, free, scale)
        top2 = torch.topk(same, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > bound * scale
        steps.append({
            "rel_err": [float(e) for e in err],
            "bound": [float(b) for b in bound],
            "d": [float(x) for x in d], "own": [float(x) for x in own],
            "free_rel_err": [float(e) for e in free_err],
            "moved": [float(e) for e in moved],
            "cache_rel_err": cache_err, "cache_ints_equal": ints_equal,
            "over_bound": int((err > bound).sum()),
            "free_over_bound": int((free_err > bound + moved).sum()),
            "far_from_exact": int((own > d + tol).sum()),
            "clear_margins": int(clear.sum()),
            "tokens_differ_where_clear": int(
                (clear & (same.argmax(-1) != got.argmax(-1))).sum())})
        if i + 1 == SMOKE_NEW:
            break
        tok = free.argmax(-1)[:, None]
        snap = _to(card_cache, "cpu")
        got, card_cache, route = step(card, tok, card_cache)
        force = route or None
        exact, _, _ = step(hi, tok, _to(snap, "cpu", hi.cfg.cdtype), force)
        free, cpu_cache, _ = step(cpu, tok, cpu_cache)
        same, same_cache, want_route = step(cpu, tok, snap, force)
    gen_h = serve.run(cpu, prompts, SMOKE_NEW, stub)["tokens"]
    gen_c = serve.run(card, prompts.to(device), SMOKE_NEW,
                      _to(stub, device))["tokens"].cpu()
    pairs = [(e, b, x) for s in steps
             for e, b, x in zip(s["rel_err"], s["bound"], s["d"])]
    rec = {"phase": "serve_card_vs_cpu", "arch": arch, "compute": compute,
           "batch": B, "prompt": SMOKE_PROMPT, "tol": tol, "up": up,
           "stub": {k: list(v.shape) for k, v in stub.items()},
           "vlm_gate": VLM_GATE if cfg.family == "vlm" else None,
           "projections_conditioned": cfg.family in CONDITIONED,
           "max_rel_err": max(e for e, _, _ in pairs),
           "max_err_over_bound": max(e / b for e, b, _ in pairs),
           "max_d": max(x for *_, x in pairs),
           "pairs_d_over_tol": sum(x > tol for *_, x in pairs),
           "max_cache_rel_err": max(s["cache_rel_err"] for s in steps),
           "over_bound": sum(s["over_bound"] + s["free_over_bound"]
                             for s in steps),
           "cache_over_bound": sum(s["cache_rel_err"] > tol
                                   or not s["cache_ints_equal"]
                                   for s in steps),
           "far_from_exact": sum(s["far_from_exact"] for s in steps),
           "tokens_differ_where_clear": sum(s["tokens_differ_where_clear"]
                                            for s in steps),
           "clear_margins": sum(s["clear_margins"] for s in steps),
           "pairs": B * SMOKE_NEW, "steps": steps,
           "generate_tokens_equal": float((gen_h == gen_c).float().mean())}
    if cfg.moe is not None:
        rec["routing_flips"] = {
            "tokens": len(flips), "decisions": decisions,
            "pairs_with_a_flip": flipped,
            "max_margin_over_budget": max(
                (m / b for *_, m, b in flips), default=0.0),
            "first": [dict(zip(("step", "layer", "seq", "pos", "margin",
                                "budget"), f, strict=True))
                      for f in flips[:4]]}
    emit(rec)
    wide = [f for f in flips if f[4] > f[5]]
    if (rec["over_bound"] or rec["cache_over_bound"] or rec["far_from_exact"]
            or rec["tokens_differ_where_clear"] or wide
            or len(flips) > FLIP_SHARE * decisions):
        raise AssertionError(f"serve card vs CPU ({arch}, {compute}): {rec}; "
                             f"flips wider than their budget: {wide}")
    return rec


# flash_attention_bwd's phase shapes (ATTN_SHAPES's layout).  "train_main"
# is qwen3-0.6b's training step (batch 8 x 2048 tokens, 16 heads over 8 KV
# heads of 128, causal, bf16), timed; then head size 64, float32, rep 1,
# 4 and 8, a window, masked keys (kv_pos < 0), ragged Sq and Sk (not
# multiples of the kernels' tiles), rows that see no key.
BWD_SHAPES = {
    "train_main": (8, 2048, 2048, 16, 8, 128, 128, True, None, "bf16",
                   "arange"),
    "bf16_d64": (2, 512, 512, 16, 8, 64, 64, True, None, "bf16", "arange"),
    "f32_d128": (1, 300, 300, 8, 4, 128, 128, True, None, "f32", "arange"),
    "f32_d64_holes": (2, 200, 200, 4, 2, 64, 64, True, None, "f32",
                      "holes"),
    "bf16_rep1_noncausal": (2, 300, 450, 8, 8, 128, 128, False, None,
                            "bf16", "arange"),
    "bf16_rep4": (2, 384, 384, 16, 4, 128, 128, True, None, "bf16",
                  "arange"),
    "bf16_rep8_window": (1, 512, 512, 16, 2, 128, 128, True, 100, "bf16",
                         "arange"),
    "bf16_holes": (2, 256, 256, 8, 4, 128, 128, True, None, "bf16",
                   "holes"),
    "bf16_ragged333": (1, 333, 333, 8, 4, 128, 128, True, None, "bf16",
                       "arange"),
    "bf16_d64_sq77_sk300": (1, 77, 300, 4, 2, 64, 64, True, None, "bf16",
                            "arange"),
    "bf16_late_keys": (2, 200, 200, 4, 2, 128, 128, True, None, "bf16",
                       "late_keys"),
    # MLA's latent heads, V the first 512 columns of K (the gradient folds
    # dV into dK): "mla_train" is deepseek-v2-lite's training step (batch
    # 8 x 2048, 16 heads over one KV head), timed; then the forward's MLA
    # cases: ragged 333, windows of 50 and 80 cutting through the 64-key
    # resident tiles and 32-row units, masked keys, rows that see no key,
    # non-causal Sq != Sk, 4 heads a KV head at Hkv 2, 3 heads a KV head
    "mla_train": (8, 2048, 2048, 16, 1, 576, 512, True, None, "bf16",
                  "arange"),
    "mla_ragged333": (1, 333, 333, 16, 1, 576, 512, True, None, "bf16",
                      "arange"),
    "mla_window50": (1, 384, 384, 16, 1, 576, 512, True, 50, "bf16",
                     "arange"),
    "mla_window80": (2, 200, 200, 16, 1, 576, 512, True, 80, "bf16",
                     "shuffled"),
    "mla_holes": (2, 256, 256, 16, 1, 576, 512, True, None, "bf16",
                  "holes"),
    "mla_late_keys": (2, 200, 200, 16, 1, 576, 512, True, None, "bf16",
                      "late_keys"),
    "mla_noncausal": (2, 200, 300, 16, 1, 576, 512, False, None, "bf16",
                      "arange"),
    "mla_rep4": (2, 300, 300, 8, 2, 576, 512, True, None, "bf16",
                 "shuffled"),
    "mla_rep3": (2, 250, 250, 6, 2, 576, 512, True, None, "bf16", "holes"),
    # deepseek's smoke config (Dk 80 = 64 + 16, Dv 64, V K's prefix, 4
    # heads over one KV head) at phase 16's batch 4 x 64, bf16 and float32,
    # and (80, 64) with a separate V
    "mla_smoke_bf16": (4, 64, 64, 4, 1, 80, 64, True, None, "bf16",
                       "arange"),
    "mla_smoke_f32": (4, 64, 64, 4, 1, 80, 64, True, None, "f32", "arange"),
    "bf16_d80_64": (2, 150, 170, 8, 2, 80, 64, True, None, "bf16", "holes"),
    # stablelm-3b's training step (batch 8 x 2048, 32 heads of 80, MHA),
    # timed; (80, 80) in float32
    "stablelm_train": (8, 2048, 2048, 32, 32, 80, 80, True, None, "bf16",
                       "arange"),
    "f32_d80_80": (1, 200, 200, 4, 2, 80, 80, True, 60, "f32", "arange"),
    # the narrow test sizes, bf16 and float32, (32, 16) also with V as K's
    # prefix
    "bf16_d32_16": (2, 100, 130, 4, 2, 32, 16, True, None, "bf16", "holes"),
    "f32_d32_16": (2, 100, 130, 4, 2, 32, 16, True, None, "f32", "holes"),
    "bf16_d32_16_prefix": (2, 96, 96, 4, 1, 32, 16, False, None, "bf16",
                           "arange"),
    "f32_d32_16_prefix": (2, 96, 96, 4, 1, 32, 16, True, 40, "f32",
                          "arange"),
    "bf16_d32_32": (2, 77, 77, 8, 4, 32, 32, True, 30, "bf16", "arange"),
    "f32_d32_32": (2, 77, 77, 8, 4, 32, 32, True, None, "f32", "late_keys"),
}
# the timed cases, and those whose V is K's prefix below (576, 512)
BWD_TIMED = ("train_main", "mla_train", "stablelm_train")
BWD_V_PREFIX = ("mla_smoke_bf16", "mla_smoke_f32", "bf16_d32_16_prefix",
                "f32_d32_16_prefix")
# the backward's kernels (csrc/flash_attention_bwd.cu), for the ptxas lines
# and the profiler: D, the bf16 wgmma kernels ((64, 64), (80, 80), (128,
# 128)), the MLA ones, the mma.sync ones (the smoke sizes), the float32
# ones
BWD_KERNELS = ("fa_bwd_delta", "fa_bwd_dkdv_wgmma", "fa_bwd_dq_wgmma",
               "fa_bwd_dkdv_mla", "fa_bwd_dq_mla", "fa_bwd_dkdv_mma",
               "fa_bwd_dq_mma", "fa_bwd_dkdv_f32", "fa_bwd_dq_f32")
# Training at full width (phase 15): qwen3-0.6b through
# repro_torch.launch.train at the serving cells' batch, 8 x 2048 tokens,
# with the launcher's AdamW and cosine schedule, BSP; step 1 is the
# warm-up.  Then SSP with a FIFO of 2 for SSP_STEPS steps.
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 2048, 6, 3e-3
SSP_STEPS = 4
# the kernels of a training step, by profiler name
TRAIN_KERNELS = {"flash_attention": ("fa_wgmma_kernel", "fa_f32_kernel"),
                 "flash_attention_bwd": BWD_KERNELS}
# Then mamba2-130m and deepseek-v2-lite-16b at their published widths
# through the same launcher (`train_arch_path`): batch 8 x 2048, AdamW and
# the cosine schedule, BSP; the kernels of a step are the forward's (twice
# a layer: remat) and its gradient's, by profiler name, the forward's
# counter first.
TRAIN_ARCH_STEPS = 6
TRAIN_SSM_ARCH = "mamba2-130m"
TRAIN_SSM_KERNELS = {"ssd": ("split::split_kernel", "5split12split_kernel",
                             "ssd_kernel"),
                     "ssd_bwd": SSD_BWD_KERNELS}
TRAIN_MLA_ARCH = "deepseek-v2-lite-16b"
TRAIN_MLA_KERNELS = {"flash_attention": ("fa_mla_wgmma_kernel",),
                     "flash_attention_bwd": ("fa_bwd_delta",
                                             "fa_bwd_dkdv_mla",
                                             "fa_bwd_dq_mla")}
# deepseek-v2-lite-16b's training state does not fit one card at 27
# layers: bf16 parameters and gradients, AdamW's float32 m and v (updated
# in place) and its float32 updates are 16 bytes a parameter, ~0.585 B
# parameters a layer (64 experts of 3 x 2048 x 1408, 2 shared, MLA) and
# ~0.42 B of embeddings: 259.5 GB at 27 layers.  At L layers the state is
# (0.585 L + 0.42) x 16 GB, beside the float32 logits [8, 2048, 102400]
# (6.7 GB) and their gradient, one layer's activations under remat and
# AdamW's float32 temporaries of the largest leaf (the experts' [L, 64,
# 2048, 1408], 3.7 GB a copy at L = 5).  Phase 15 trains the largest
# depth up to SERVE_CUTS' 6 whose peak stays under ~70 GB in this script,
# every width kept.  On an H100, 5 layers peaked at 67.7 GB in a process
# of their own, but ran out of memory after the earlier phases (55.7 GB
# allocated, 21.3 GB cached in blocks too small for a 3.4 GB leaf); 4
# layers hold ~9.4 GB less.  A key "a.b" is field b of the config's
# sub-config a.
TRAIN_CUTS = {"deepseek-v2-lite-16b": {"n_layers": 4}}
TRAIN_CUT_WHY = {
    "deepseek-v2-lite-16b": "bf16 parameters and gradients, AdamW's "
                            "float32 m and v and its float32 updates of "
                            "27 layers are ~260 GB against one 80 GB "
                            "card; the largest depth up to the served 6 "
                            "whose peak stays under ~70 GB after the "
                            "script's earlier phases (5 layers peaked at "
                            "67.7 GB alone on an H100 but ran out of "
                            "memory here); a layer's kernels and shapes "
                            "do not change with depth"}
# Phase 16 (training, card against CPU): the smoke configs of these archs,
# batch 4 x 64, 3 SGD steps at this rate.
TRAIN_SMALL = dict(batch=4, seq=64, steps=3, lr=0.05)
TRAIN_VS_CPU_ARCHS = ("qwen3-0.6b", "mamba2-130m", "jamba-1.5-large-398b",
                      "deepseek-v2-lite-16b")
# The archs whose CPU run starts each step from the card's parameters
# (each step held on the same inputs, as phase 6 holds serving steps).
# Going on from their own parameters, mamba2's bf16 runs drift further
# apart than one step's rounding d allows: at step 3 the card's embedding
# gradient lay 0.048 or 0.081 of scale from the CPU's (two versions of
# ssd_bwd) where d was ~0.01, and bf16 rounding carried over the steps
# moves it that far: the CPU's own run lies ~0.13 from its run one
# precision up.  So their going-on runs are held as well, within
# SERVE_TOL plus twice the larger of d and that carried rounding, beside a
# witness that is recorded only: the CPU's run against itself with ddt
# one float32 rounding off.
TRAIN_SAME_INPUTS = ("mamba2-130m", "jamba-1.5-large-398b",
                     "deepseek-v2-lite-16b")


def bwd_within(got, want, dtype) -> bool:
    """``got`` within ``ref.attention_bwd_tolerance`` of ``want``."""
    from repro_torch.kernels import ref
    atol, rtol = ref.attention_bwd_tolerance(dtype)
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol * w.abs().max() + rtol * w.abs()
                 ).all())


def attention_bwd_bound(q, k, v, qp, kp, causal, window, rates):
    """Least time (ms) for attention's backward on these inputs: 2 (3 Dk +
    2 Dv) FLOP for each visible (query, key, head) triple (S, dP, dV, dQ,
    dK) over the tensor-core (bf16) or float32 rate, against q, k, v,
    out, dout, lse and the positions read and dq, dk, dv written once
    over the memory rate."""
    import torch
    from repro_torch.kernels import ref
    bw, f32, bf16 = rates
    H, Dk, Dv = q.shape[2], q.shape[3], v.shape[3]
    pairs = int(ref._block_mask(qp, kp, causal, window).expand(
        qp.shape[0], qp.shape[1], kp.shape[1]).sum().item())
    ops = 2 * (3 * Dk + 2 * Dv) * H * pairs
    rows = q.numel() // Dk                      # (batch, query, head) rows
    # v and dv not again where v is K's prefix (dK holds dV)
    v_elems = 0 if ref.v_is_k_prefix(k, v) else v.numel()
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v_elems
              + 2 * rows * Dv) * q.element_size() + 4 * rows \
        + 4 * (qp.numel() + kp.numel())
    t_b = nbytes / bw * 1e3
    t_o = ops / (bf16 if q.dtype == torch.bfloat16 else f32) * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", H * pairs


def sdpa_bwd_call(q, k, v, dout, causal, scale):
    """The backward of one ``scaled_dot_product_attention`` call on the
    port's inputs, the library yardstick (K and V at their heads with
    ``enable_gqa`` where they share q's head size, else expanded to q's
    heads, as `sdpa_call`): a closure that takes the gradient of a kept
    forward, and the backend PyTorch's dispatch picks (``(None, "none")``
    if none takes the inputs)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gt = dout.transpose(1, 2).contiguous()
    gqa = q.shape[-1] == v.shape[-1]
    ke, ve = kt, vt
    if not gqa:
        H = q.shape[2]
        ke, ve = kt.expand(-1, H, -1, -1), vt.expand(-1, H, -1, -1)
    try:
        out = F.scaled_dot_product_attention(qt, ke, ve, is_causal=causal,
                                             scale=scale, enable_gqa=gqa)
    except RuntimeError:
        return None, "none"

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
    call()
    choice = torch._fused_sdp_choice(qt, ke, ve, None, 0.0, causal,
                                     scale=scale, enable_gqa=gqa)
    return call, SDPBackend(choice).name.lower()


def check_flash_attention_bwd(name, device, rates, timed: bool):
    """``flash_attention_bwd`` against ``ref.attention_bwd`` on one shape
    of `BWD_SHAPES`, within ``ref.attention_bwd_tolerance`` (each of dq,
    dk and dv; with V as K's prefix, dq and the folded dk), where the
    planted faults (D taken as 0, a key tile dropped for the later half
    of the queries, and with V as K's prefix dV left out of dK) must
    fail; two calls bit-equal (no atomics); the forward with ``lse``
    bit-equal to ``flash_attention``'s output and its ``lse`` against
    ``ref.attention_lse``'s; the kernel that ran (``bwd_variant``).  Timed
    at `BWD_TIMED` beside the plain version, the backward of one
    ``scaled_dot_product_attention`` call (and its backend) and the
    bound, with the kernels' ptxas lines (no spills) and the bf16
    kernels' stages, shared bytes and registers
    (``flash_attention.bwd_kernel_info``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    shape = BWD_SHAPES[name]
    causal, window, dt, kind = shape[7:]
    q, k, v, qp, kp = attn_inputs(shape, seed=sum(shape[:7]) + 1,
                                  device=device,
                                  v_prefix=name in BWD_V_PREFIX)
    fold = ref.v_is_k_prefix(k, v)
    gd = torch.Generator(device=device).manual_seed(sum(shape[:7]) + 2)
    dout = torch.randn((*q.shape[:3], v.shape[-1]), generator=gd,
                       device=device).to(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(scale=scale, q_pos=qp, kv_pos=kp, causal=causal, window=window)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    served = fa.flash_attention(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    _, want_lse = ref.attention_lse(q, k, v, **kw)
    seen = torch.isfinite(want_lse)
    lse_err = (lse[seen] - want_lse[seen]).abs()
    want = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    names = ("dq", "dk") if fold else ("dq", "dk", "dv")
    atol, rtol = ref.attention_bwd_tolerance(q.dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention_bwd", "case": name,
           "shape": dict(zip(("B", "Sq", "Sk", "H", "Hkv", "Dk", "Dv"),
                             shape[:7], strict=True)),
           "causal": causal, "window": window, "dtype": dt,
           "v_is_k_prefix": fold, "variant": fa.last_bwd_variant,
           "forward_variant": fa.last_variant,
           "forward_bit_equal_with_lse": torch.equal(out.view(bits),
                                                     served.view(bits)),
           "no_dv_where_folded": (got[2] is None) == fold == (want[2] is None),
           "repeat_bit_equal": all(
               torch.equal(a.view(bits), b.view(bits))
               for a, b in zip(got[:len(names)], again[:len(names)],
                               strict=True)),
           "lse_unseeing_rows_equal": torch.equal(seen, torch.isfinite(lse)),
           "lse_max_abs_err": lse_err.max().item(),
           "max_abs_err": max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got[:len(names)],
                                              want[:len(names)],
                                              strict=True)),
           "max_abs_err_by_output": {
               n: (g.float() - w.float()).abs().max().item()
               for n, g, w in zip(names, got, want, strict=False)},
           "scale_by_output": {n: w.float().abs().max().item() for n, w in
                               zip(names, want, strict=False)},
           "atol_of_scale": atol, "rtol": rtol}
    del again
    bad = not (rec["forward_bit_equal_with_lse"]
               and rec["no_dv_where_folded"]
               and rec["repeat_bit_equal"]
               and rec["lse_unseeing_rows_equal"]
               and bool((lse_err <= 1e-4 + 1e-5 * want_lse[seen].abs()
                         ).all())
               and all(bwd_within(g, w, q.dtype)
                       for g, w in zip(got[:len(names)], want[:len(names)],
                                       strict=True)))
    if kind == "late_keys":
        rec["unseeing_rows_zero_grad"] = not bool(got[0][:, :5].any())
        bad = bad or not rec["unseeing_rows_zero_grad"]
    del served, lse_err
    if not bad:
        missed = []
        faults = ("d_zero", "dropped_tile") + (("unfolded_dv",) if fold
                                               else ())
        for fault in faults:
            wrong = ref.attention_bwd_fault(q, k, v, out, lse, dout,
                                            fault=fault, **kw)
            rec[f"planted_fault_{fault}_err"] = max(
                (b.float() - w.float()).abs().max().item()
                for b, w in zip(wrong[:len(names)], want[:len(names)],
                                strict=True))
            if all(bwd_within(b, w, q.dtype)
                   for b, w in zip(wrong[:len(names)], want[:len(names)],
                                   strict=True)):
                missed.append(fault)
            del wrong
        if missed:
            emit(rec)
            raise AssertionError(f"flash_attention_bwd's limit passes "
                                 f"planted faults {missed} ({name}): {rec}")
    del want, got
    if bad:
        emit(rec)
        raise AssertionError(f"flash_attention_bwd disagrees with its "
                             f"plain version ({name}): {rec}")
    if timed:
        bound, by, triples = attention_bwd_bound(q, k, v, qp, kp, causal,
                                                 window, rates)
        library, backend = sdpa_bwd_call(q, k, v, dout, causal, scale)
        rec.update(
            ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                      dout, **kw), 20),
            forward_lse_ms=time_ms(lambda: fa.flash_attention_fwd_lse(
                q, k, v, **kw), 20),
            forward_ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw),
                               20),
            plain_ms=time_ms(lambda: ref.attention_bwd(
                q, k, v, out, lse, dout, **kw), 2, warmup=1),
            library_ms=None if library is None else time_ms(
                library, 3 if backend == "math" else 20),
            library_backend=backend, bound_ms=bound, bound_by=by,
            visible_triples=triples)
        del library
        lines = {entry: kernel_ptxas("flash_attention_bwd", entry)
                 for entry in BWD_KERNELS}
        rec["ptxas"] = [ln for entry in BWD_KERNELS for ln in lines[entry]]
        rec["bwd_kernels"] = fa.bwd_kernel_info(q.shape[-1], v.shape[-1])
        if not all(lines.values()) or any(
                ", 0 bytes spill stores, 0 bytes spill loads" not in ln
                for ln in rec["ptxas"]) or any(
                info["local_bytes"] for info in rec["bwd_kernels"].values()):
            emit(rec)
            raise AssertionError(f"flash_attention_bwd's kernels spill or "
                                 f"have no ptxas lines: {rec['ptxas']}, "
                                 f"{rec['bwd_kernels']}")
    emit(rec)
    return rec


def profiled_train_step(step_fn, state, batch, kernels=None):
    """One train step under the profiler: ``(state, record)`` with the host
    ms (ending in a synchronize; the profiler's own host cost inside), the
    device-busy ms, the idle share, the training kernels' device ms by
    name (``kernels``, by default `TRAIN_KERNELS`) and the eight ops that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = TRAIN_KERNELS if kernels is None else kernels
    busy = 0.0
    per_kernel = dict.fromkeys(kernels, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            for name, fns in kernels.items():
                if any(fn in e.name for fn in fns):
                    per_kernel[name] += e.self_device_time_total
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:8]
    rec = {"wall_ms": wall_ms, "device_ms": busy / 1e3,
           "device_idle_share": None if busy == 0.0
           else 1.0 - busy / 1e3 / wall_ms,
           "kernel_ms_by_name": {k: v / 1e3 for k, v in per_kernel.items()},
           "top_ops_ms": {e.key: e.self_device_time_total / 1e3
                          for e in ops}, "loss": float(m["loss"])}
    if busy and any(v == 0.0 for v in per_kernel.values()):
        raise AssertionError(f"the profiler saw no device time for a "
                             f"training kernel: {rec['kernel_ms_by_name']}")
    return state, rec


def train_path(device):
    """Phase 15: qwen3-0.6b trained at its published widths on the card.

    (a) ``repro_torch.launch.train.main`` (the user's entry point) for
    `TRAIN_STEPS` steps of batch 8 x 2048 with the launcher's AdamW and
    cosine schedule under BSP, the launch counts set to 0 just before and
    read just after: ``flash_attention`` 56 and ``flash_attention_bwd`` 28
    a step (28 layers, remat: each block's forward runs again in the
    backward), and no other kernel; (b) the same model, optimizer and
    batches built from the launcher's pieces, each step timed (host clock
    ending in a synchronize; step 1, the warm-up, apart), tokens/s, peak
    memory, one more step profiled; (c) SSP with a FIFO of 2 for
    `SSP_STEPS` steps: ``apply_scale`` 0, 0, 1, 1 and the parameters
    untouched by the first two.  Every loss and ``grad_norm`` finite; the
    last step's loss below step 1's (in both runs) and below the initial
    weights' loss on the last step's batch; the loss on step 1's batch
    after training is recorded."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import (TokenGenConfig, token_batch,
                                            token_batches)
    from repro_torch.kernels import launch
    from repro_torch.launch import train as launcher
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizers import adamw, cosine_schedule
    from repro_torch.psdist.grad_sync import GradSync
    from repro_torch.train.state import (init_state, make_loss_fn,
                                         make_train_step)
    argv = ["--arch", TRAIN_ARCH, "--full", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
            "--lr", str(TRAIN_LR), "--log-every", "1"]
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    hist = launcher.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(launch.launches)
    cfg = get_config(TRAIN_ARCH)
    want = {k: 0 for k in launches}
    want.update(flash_attention=2 * cfg.n_layers * TRAIN_STEPS,
                flash_attention_bwd=cfg.n_layers * TRAIN_STEPS)
    rec = {"phase": "train_path", "arch": TRAIN_ARCH, "argv": argv,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "remat": cfg.remat,
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "consistency": "bsp",
           "launcher_s": main_s, "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items() if v},
           "launcher_loss": [h["loss"] for h in hist],
           "launcher_grad_norm": [h["grad_norm"] for h in hist]}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device=device)
    opt = adamw(cosine_schedule(TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS))
    state = init_state(model, opt, GradSync())
    step_fn = make_train_step(model, opt, GradSync())
    dcfg = TokenGenConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          batch=TRAIN_BATCH, seed=0)
    batches = list(token_batches(dcfg, TRAIN_STEPS, device=device))
    with torch.no_grad():
        rec["loss_last_batch_before"] = float(make_loss_fn(model)(
            model.params, batches[-1]))
    torch.cuda.synchronize()
    rec.update(n_params=model.n_params, setup_s=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, gnorms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    steady = step_ms[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec.update(step_ms=step_ms, warmup_step_ms=step_ms[0],
               ms_per_step=sum(steady) / len(steady),
               tokens_per_step=tokens,
               tokens_per_s=tokens * len(steady) / (sum(steady) / 1e3),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               loss=losses, grad_norm=gnorms)
    state, rec["profiled_step"] = profiled_train_step(
        step_fn, state, {"tokens": token_batch(dcfg, TRAIN_STEPS,
                                               device=device)})
    with torch.no_grad():
        rec["loss_batch1_after"] = float(make_loss_fn(model)(
            model.params, batches[0]))
    finite = all(math.isfinite(x) for x in losses + gnorms
                 + rec["launcher_loss"] + rec["launcher_grad_norm"]
                 + [rec["loss_batch1_after"], rec["loss_last_batch_before"]])
    rec["finite"] = finite
    # each step draws a new batch, whose loss at the initial weights varies
    # by ~10 % (a CPU run of the published widths at 2 layers: 129-157 over
    # the first six batches), so the last step's loss is also held to the
    # initial weights' loss on the same batch
    rec["loss_falls"] = (losses[-1] < losses[0]
                         and rec["launcher_loss"][-1]
                         < rec["launcher_loss"][0]
                         and losses[-1] < rec["loss_last_batch_before"])
    del state, step_fn
    torch.cuda.empty_cache()

    # SSP: a FIFO of 2 gradients, nothing applied for two steps
    sync = GradSync("ssp", 2)
    state = init_state(model, opt, sync)
    step_fn = make_train_step(model, opt, sync)
    probe = model.final_norm.scale
    scales, ssp_loss, ssp_ms, untouched = [], [], [], []
    for i in range(SSP_STEPS):
        before = probe.detach().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        ssp_ms.append((time.perf_counter() - t0) * 1e3)
        scales.append(float(m["apply_scale"]))
        ssp_loss.append(float(m["loss"]))
        untouched.append(bool(torch.equal(before, probe)))
    rec["ssp"] = {"staleness": 2, "apply_scale": scales, "loss": ssp_loss,
                  "step_ms": ssp_ms, "params_untouched": untouched,
                  "max_memory_allocated_bytes":
                      torch.cuda.max_memory_allocated()}
    del state, step_fn, model, batches
    torch.cuda.empty_cache()
    emit(rec)
    bad = []
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if not finite:
        bad.append("a loss or grad_norm is not finite")
    if not rec["loss_falls"]:
        bad.append("the loss did not fall from step 1 to the last, or "
                   "not below the initial weights' on the last batch")
    if scales != [0.0, 0.0, 1.0, 1.0] or untouched != [True, True, False,
                                                       False]:
        bad.append(f"SSP applied {scales}, untouched {untouched}")
    if not all(math.isfinite(x) for x in ssp_loss):
        bad.append("an SSP loss is not finite")
    if bad:
        raise AssertionError(f"train_path: {bad}")
    return rec


def train_arch_path(device, arch, kernels, cut=False):
    """Phase 15, after qwen3-0.6b: ``arch`` trained at its published
    widths on the card, with its `TRAIN_CUTS` depth where ``cut`` (every
    width kept).  (a) ``repro_torch.launch.train.main`` for
    `TRAIN_ARCH_STEPS` steps of batch 8 x 2048 with the launcher's AdamW
    and cosine schedule under BSP, the launch counts set to 0 just before
    and read just after: the forward's kernel (``kernels``' first
    counter) twice a layer (remat: each block's forward runs again in the
    backward) and its gradient's once a layer a step, and no other
    kernel; (b) the same model, optimizer and batches from the launcher's
    pieces, each step timed (host clock ending in a synchronize; step 1,
    the warm-up, apart), tokens/s, peak memory, one more step profiled
    (``kernels``: the device ms of each counter's kernels by profiler
    name).  Every loss and ``grad_norm`` finite; the last step's loss
    below step 1's (in both runs) and below the initial weights' loss on
    the last step's batch."""
    import torch
    from repro_torch.data.synthetic import (TokenGenConfig, token_batch,
                                            token_batches)
    from repro_torch.kernels import launch
    from repro_torch.launch import train as launcher
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizers import adamw, cosine_schedule
    from repro_torch.psdist.grad_sync import GradSync
    from repro_torch.train.state import (init_state, make_loss_fn,
                                         make_train_step)
    steps = TRAIN_ARCH_STEPS
    fwd, bwd = kernels
    cfg, reduced = (serve_config(arch, TRAIN_CUTS, TRAIN_CUT_WHY, "trained")
                    if cut else serve_config(arch, {}))
    argv = ["--arch", arch, "--full", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(steps), "--lr", str(TRAIN_LR),
            "--log-every", "1"]
    if cut:
        argv += ["--layers", str(cfg.n_layers)]
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    hist = launcher.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(launch.launches)
    want = {k: 0 for k in launches}
    want.update({fwd: (2 if cfg.remat else 1) * cfg.n_layers * steps,
                 bwd: cfg.n_layers * steps})
    rec = {"phase": "train_arch_path", "arch": arch, "argv": argv,
           "layers": cfg.n_layers, "reduced": reduced,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "remat": cfg.remat, "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "consistency": "bsp",
           "launcher_s": main_s, "launches": launches,
           "launches_per_step": {k: v / steps
                                 for k, v in launches.items() if v},
           "launcher_loss": [h["loss"] for h in hist],
           "launcher_grad_norm": [h["grad_norm"] for h in hist]}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device=device)
    opt = adamw(cosine_schedule(TRAIN_LR, steps // 10, steps))
    state = init_state(model, opt, GradSync())
    step_fn = make_train_step(model, opt, GradSync())
    dcfg = TokenGenConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          batch=TRAIN_BATCH, seed=0)
    batches = list(token_batches(dcfg, steps, device=device))
    with torch.no_grad():
        rec["loss_last_batch_before"] = float(make_loss_fn(model)(
            model.params, batches[-1]))
    torch.cuda.synchronize()
    rec.update(n_params=model.n_params, setup_s=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, gnorms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    steady = step_ms[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec.update(step_ms=step_ms, warmup_step_ms=step_ms[0],
               ms_per_step=sum(steady) / len(steady),
               tokens_per_step=tokens,
               tokens_per_s=tokens * len(steady) / (sum(steady) / 1e3),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               loss=losses, grad_norm=gnorms)
    state, rec["profiled_step"] = profiled_train_step(
        step_fn, state, {"tokens": token_batch(dcfg, steps, device=device)},
        kernels=kernels)
    rec["finite"] = all(math.isfinite(x) for x in losses + gnorms
                        + rec["launcher_loss"] + rec["launcher_grad_norm"]
                        + [rec["loss_last_batch_before"]])
    rec["loss_falls"] = (losses[-1] < losses[0]
                         and rec["launcher_loss"][-1]
                         < rec["launcher_loss"][0]
                         and losses[-1] < rec["loss_last_batch_before"])
    del state, step_fn, model, batches
    torch.cuda.empty_cache()
    emit(rec)
    bad = []
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if not rec["finite"]:
        bad.append("a loss or grad_norm is not finite")
    if not rec["loss_falls"]:
        bad.append("the loss did not fall from step 1 to the last, or "
                   "not below the initial weights' on the last batch")
    if bad:
        raise AssertionError(f"train_arch_path ({arch}): {bad}")
    return rec


def _flat_grads(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_grads(v, f"{prefix}/{k}"))
        return out
    # a copy: the train step updates the parameters in place
    return {prefix: tree.detach().float().cpu().clone()}


def _share(a, b) -> float:
    """``max|a - b|`` over ``max|b|``."""
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


@contextlib.contextmanager
def ssd_ddt_rounded():
    """The CPU's ``ssd`` gradient with ddt scaled by 1 + 2^-23 (one float32
    rounding of every element) in the block: the witness of how far bf16
    training carries a float32-level difference of the backward."""
    from repro_torch.kernels import ops
    plain = ops._ssd_bwd

    def rounded(*args):
        dx, ddt, dA, dB, dC = plain(*args)
        return dx, ddt * (1 + 2 ** -23), dA, dB, dC

    ops._ssd_bwd = rounded
    try:
        yield
    finally:
        ops._ssd_bwd = plain


def train_card_vs_cpu_arch(arch, compute, device, same: bool,
                           witness: bool = False):
    """One arch's smoke config trained on the card and on the CPU from the
    same parameters and batches (`TRAIN_SMALL`: 3 SGD steps) in compute
    dtype ``compute``; with ``same`` the CPU starts each step from the
    card's parameters.  With ``witness`` (going on, ``same`` False) two
    more runs on the CPU go on from their own parameters: one precision
    up (``up``), whose distance from the CPU's run is the rounding the
    run has carried (the limits take the larger of it and ``d``), and one
    with its ``ssd`` gradient's ddt one float32 rounding off
    (`ssd_ddt_rounded`; recorded only); see `train_card_vs_cpu`."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import TokenGenConfig, token_batch
    from repro_torch.models import moe
    from repro_torch.models.registry import Model, build_model
    from repro_torch.optim.optimizers import sgd, tree_map
    from repro_torch.train.state import (grad_norm, init_state,
                                         make_loss_fn, make_train_step,
                                         value_and_grad)
    up = {"bfloat16": "float32", "float32": "float64"}
    cfg = get_smoke_config(arch).replace(compute_dtype=compute)
    card = build_model(cfg, seed=1, device=device)
    if cfg.family in CONDITIONED:
        condition_projections(card)
    cpu = Model(cfg, tree_map(lambda p: p.detach().cpu().clone(),
                              card.params))
    twin = Model(cfg.replace(compute_dtype=up[compute]), cpu.params)
    models = {"card": card, "cpu": cpu, "twin": twin}
    runs = ("card", "cpu")
    if witness:
        models["pert"] = Model(cfg, tree_map(lambda p: p.clone(),
                                             cpu.params))
        models["up"] = Model(twin.cfg, tree_map(lambda p: p.clone(),
                                                cpu.params))
        runs += ("pert", "up")

    def rounded(n):
        return ssd_ddt_rounded() if n == "pert" else contextlib.nullcontext()

    init = _flat_grads(cpu.params)
    fns = {n: make_loss_fn(m) for n, m in models.items()}
    steps = {n: make_train_step(models[n], sgd(TRAIN_SMALL["lr"]))
             for n in runs}
    states = {n: init_state(models[n], sgd(TRAIN_SMALL["lr"])) for n in runs}
    tol = SERVE_TOL[compute]
    worst, rows, forced = {}, [], []
    start = init
    for i in range(TRAIN_SMALL["steps"]):
        if same and i:  # the CPU (and its twin) from the card's parameters
            tree_map(lambda a, b: a.copy_(b.detach().cpu()), cpu.params,
                     card.params)
            start = _flat_grads(cpu.params)
        toks = token_batch(TokenGenConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SMALL["seq"],
            batch=TRAIN_SMALL["batch"], seed=3), i, device="cpu")
        bat = {n: {"tokens": toks.to(device) if n == "card" else toks}
               for n in models}
        # the CPU's runs take the card's routing (an arch with MoE layers)
        out = {}
        with moe.recording() as route:
            out["card"] = value_and_grad(fns["card"], card.params,
                                         bat["card"])
        forced.append(len(route))
        for n in models:
            if n != "card":
                with moe.forcing(route or None), rounded(n):
                    out[n] = value_and_grad(fns[n], models[n].params,
                                            bat[n])
        g = {n: _flat_grads(o[1]) for n, o in out.items()}
        norms = {n: float(grad_norm(o[1])) for n, o in out.items()}
        loss = {n: float(o[0]) for n, o in out.items()}
        row = {"step": i + 1, "loss": loss, "grad_norm": norms,
               "leaves": {}}
        # the rounding a limit allows: the step's own, d (the CPU against
        # its twin, one precision up, on the same parameters); with the
        # witness, the larger of d and the rounding the run has carried
        # (against "up", one precision up, going on from its own
        # parameters)
        ref_up = "up" if witness else "twin"
        for path in g["cpu"]:
            d = _share(g["cpu"][path], g["twin"][path])
            r = max(d, _share(g["cpu"][path], g[ref_up][path]))
            err = _share(g["card"][path], g["cpu"][path])
            row["leaves"][path] = (err, d, r)
            if err > tol + 2 * r:
                worst[f"step{i+1}{path}"] = (err, tol + 2 * r)
        if witness:
            row["ddt_rounded"] = max(_share(g["pert"][k], g["cpu"][k])
                                     for k in g["cpu"])
        for name, vals in (("loss", loss), ("grad_norm", norms)):
            r = max(abs(vals["cpu"] - vals[u]) / abs(vals[u])
                    for u in {"twin", ref_up})
            err = abs(vals["card"] - vals["cpu"]) / abs(vals["cpu"])
            if err > tol + 2 * r:
                worst[f"step{i+1}/{name}"] = (err, tol + 2 * r)
        with moe.recording() as route:
            states["card"], _ = steps["card"](states["card"], bat["card"])
        for n in runs[1:]:
            with moe.forcing(route or None), rounded(n):
                states[n], _ = steps[n](states[n], bat[n])
        moved = {n: {k: v - start[k] for k, v in _flat_grads(
            states[n].params).items()} for n in ("card", "cpu")}
        for path, want in moved["cpu"].items():
            r = row["leaves"][path][2]
            floor = (1 if same else i + 1) * 2 ** -23 * float(
                start[path].abs().max())
            err = float((moved["card"][path] - want).abs().max())
            if err > (tol + 2 * r) * float(want.abs().max()) + floor:
                worst[f"step{i+1}{path}/moved"] = (err, floor)
        rows.append(row)
    rec = {"phase": ("train_card_vs_cpu_going_on" if witness
                     else "train_card_vs_cpu"),
           "arch": arch, "compute": compute,
           "config": TRAIN_SMALL, "tol": tol, "same_inputs": same,
           "projections_conditioned": cfg.family in CONDITIONED,
           "forced_moe_calls_per_step": forced,
           "steps": [{"step": r["step"], "loss": r["loss"],
                      "grad_norm": r["grad_norm"],
                      "max_leaf_err": max(v[0] for v in
                                          r["leaves"].values()),
                      "max_leaf_d": max(v[1] for v in
                                        r["leaves"].values()),
                      **({"max_leaf_carried": max(
                          v[2] for v in r["leaves"].values()),
                          "max_leaf_ddt_rounded": r["ddt_rounded"]}
                         if witness else {})}
                     for r in rows],
           "failures": worst}
    emit(rec)
    if cfg.moe is not None and not all(forced):
        raise AssertionError(f"{arch}: no MoE routing was recorded under "
                             f"autograd: {forced}")
    if worst:
        raise AssertionError(f"training on the card disagrees with the "
                             f"CPU ({arch}, {compute}): {worst}")
    return rec


def train_card_vs_cpu(device):
    """Phase 16: the smoke configs of `TRAIN_VS_CPU_ARCHS` trained on the
    card and on the CPU from the same parameters and batches, in bf16 and
    float32 compute (`TRAIN_SMALL`: 3 SGD steps;
    `train_card_vs_cpu_arch`).  Each step holds the loss, ``grad_norm``
    and every gradient leaf of the card within ``SERVE_TOL`` (of each
    leaf's largest magnitude) plus twice the step's own rounding ``d``:
    the CPU's distance from its run of the step one precision up (bf16 in
    float32, float32 in float64; the same parameters), as phase 6 holds
    the logits; then the train step on both and the moved parameters
    likewise.  qwen3-0.6b's runs go on from their own parameters; the
    archs of `TRAIN_SAME_INPUTS` start each step on the CPU from the
    card's parameters, and their moves are held from there.  Those archs'
    runs going on from their own parameters are then held too
    (``train_card_vs_cpu_going_on``), with the larger of ``d`` and the
    rounding the CPU's run has carried: its distance from its own run
    one precision up, each going on from its own parameters (at step 1
    it is ``d``); beside it each step records a witness, the CPU going on
    against itself with its ``ssd`` gradient's ddt one float32 rounding
    off.  An arch with
    MoE layers (Jamba's, deepseek-v2-lite-16b's) records the card's
    routing under autograd (``moe.recording``) and runs the CPU's
    gradients and step on it (``moe.forcing``, which fails unless every
    forced routing was taken); the families of `CONDITIONED` have their
    q/k/v projections scaled as in phase 6.  AdamW is held on identical
    gradients (its normalised update turns a rounding difference of a
    near-zero gradient into a step of up to lr).  Last, a float32
    gradient through attention at MLA's (576, 512), which has no kernel
    yet, raises ``NotImplementedError`` naming ROADMAP 16.4f on the
    card."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizers import adamw, cosine_schedule, tree_map
    recs = [train_card_vs_cpu_arch(arch, compute, device,
                                   same=arch in TRAIN_SAME_INPUTS)
            for arch in TRAIN_VS_CPU_ARCHS
            for compute in ("bfloat16", "float32")]
    recs += [train_card_vs_cpu_arch(arch, compute, device, same=False,
                                    witness=True)
             for arch in TRAIN_SAME_INPUTS
             for compute in ("bfloat16", "float32")]
    # AdamW on identical gradients: three updates of the same params
    cfg = get_smoke_config(TRAIN_ARCH).replace(compute_dtype="float32")
    cpu = build_model(cfg, seed=2, device="cpu")
    params = {"cpu": cpu.params,
              "card": tree_map(lambda p: p.detach().to(device), cpu.params)}
    opts = {n: adamw(cosine_schedule(3e-3, 1, 3)) for n in params}
    st = {n: opts[n].init(params[n]) for n in params}
    gen = torch.Generator().manual_seed(5)
    adam_err = 0.0
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen),
                         params["cpu"])
        ups = {}
        for n in params:
            g = grads if n == "cpu" else tree_map(lambda x: x.to(device),
                                                  grads)
            ups[n], st[n] = opts[n].update(g, st[n], params[n])
        a, b = _flat_grads(ups["card"]), _flat_grads(ups["cpu"])
        adam_err = max(adam_err, max(_share(a[k], b[k]) for k in b))
    adam = {"phase": "train_adamw_card_vs_cpu", "max_update_err": adam_err,
            "tol": SERVE_TOL["float32"]}
    emit(adam)
    if adam_err > SERVE_TOL["float32"]:
        raise AssertionError(f"AdamW on the card disagrees: {adam}")
    # a float32 gradient through attention at MLA's (576, 512) has no
    # kernel yet and raises on the card; without a gradient it runs
    gd = torch.Generator(device=device).manual_seed(6)
    q = torch.randn((1, 64, 4, 576), generator=gd, device=device)
    k = torch.randn((1, 64, 1, 576), generator=gd, device=device)
    pos = torch.arange(64, dtype=torch.int32, device=device)[None]
    kw = dict(scale=1 / math.sqrt(192), q_pos=pos, kv_pos=pos)
    raised = {}
    try:
        ops.attention(q.requires_grad_(), k, k[..., :512], **kw)
    except NotImplementedError as e:
        raised["float32 (576, 512)"] = str(e)
        if "16.4f" not in str(e):
            raise AssertionError(f"{e} names no 16.4f") from e
    else:
        raise AssertionError("a float32 gradient at (576, 512) ran on the "
                             "card")
    with torch.no_grad():
        ops.attention(q, k, k[..., :512], **kw)
    emit({"phase": "train_no_backward_raises", "raised": raised})
    return recs


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
    attn_timed = {name: check_flash_attention(name, dev, rates, timed=True)
                  for name in ATTN_TIMED}
    for name in ATTN_SHAPES:
        if name not in ATTN_TIMED:
            check_flash_attention(name, dev, rates, timed=False)
    bwd_timed = {name: check_flash_attention_bwd(name, dev, rates,
                                                 timed=True)
                 for name in BWD_TIMED}
    for name in BWD_SHAPES:
        if name not in BWD_TIMED:
            check_flash_attention_bwd(name, dev, rates, timed=False)
    ssd_timed = {name: check_ssd(name, dev, rates, timed=True)
                 for name in SSD_TIMED}
    for name in SSD_SHAPES:
        if name not in SSD_TIMED:
            check_ssd(name, dev, rates, timed=False)
    ssd_bwd_timed = {name: check_ssd_bwd(name, dev, rates, timed=True)
                     for name in SSD_BWD_TIMED}
    for name in SSD_BWD_SHAPES:
        if name not in SSD_BWD_TIMED:
            check_ssd_bwd(name, dev, rates, timed=False)
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
    for arch in SMOKE_ARCHS:
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

    # --- 14. the sharded sweep, the sharded tuner, the static checker ------
    sharded = sharded_sweep_phase(dev)
    sharded["nvidia_smi"] = smi
    emit(sharded)

    # --- 15. training at full width ------------------------------------------
    trained = train_path(dev)
    trained_ssm = train_arch_path(dev, TRAIN_SSM_ARCH, TRAIN_SSM_KERNELS)
    trained_mla = train_arch_path(dev, TRAIN_MLA_ARCH, TRAIN_MLA_KERNELS,
                                  cut=True)

    # --- 16. training, card against CPU ------------------------------------
    train_card_vs_cpu(dev)

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
                                 for n, r in runtime_launches.items()},
            # the first sharded C2-LDA sweep's launches (phase 14)
            "sharded_sweep_launches": sharded["launches"][name]})
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
    # flash_attention's rows: the wgmma kernel at qwen3-0.6b's prefill
    # (launched once a layer by qwen3-0.6b and qwen3-moe-30b-a3b), the MLA
    # kernel at deepseek-v2-lite's
    for name, rec, src, replaces, archs in (
            ("flash_attention", attn_timed["main"], "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:93",
             ("qwen3-0.6b", "qwen3-moe-30b-a3b")),
            ("flash_attention[mla_wgmma]", attn_timed["mla_main"],
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:93",
             ("deepseek-v2-lite-16b",)),
            # the wgmma kernel at whisper-medium's encoder (its decoder's
            # self and cross launches in the same count) and at
            # llama-3.2-vision's prefill cross-attention
            ("flash_attention[whisper_enc]", attn_timed["whisper_enc"],
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:93",
             ("whisper-medium",)),
            ("flash_attention[vlm_cross]", attn_timed["vlm_cross"],
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:93",
             ("llama-3.2-vision-11b",)),
            # the wgmma kernel at 8 heads a KV head, and ssd at 256 heads:
            # jamba-1.5-large-398b's prefill (its reduced cell)
            ("flash_attention[jamba_attn]", attn_timed["jamba_attn"],
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:93",
             ("jamba-1.5-large-398b",)),
            ("ssd", ssd_timed["main"], "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:79", ("mamba2-130m",)),
            ("ssd[jamba]", ssd_timed["jamba"], "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:79", ("jamba-1.5-large-398b",))):
        counter = name.split("[")[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": served[archs[0]]["launches_per_prefill"][counter],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if "variant" in rec:
            kernels[-1]["variant"] = rec["variant"]
        kernels[-1]["launches_per_prefill_by_arch"] = {
            a: served[a]["launches_per_prefill"][counter] for a in archs}
        if counter == "flash_attention":
            kernels[-1]["library_backend"] = rec["library_backend"]
        if name == "ssd":  # mamba2-130m's training step (phase 15)
            kernels[-1]["train_launches_per_step"] = trained_ssm[
                "launches_per_step"]["ssd"]
        if archs == (TRAIN_MLA_ARCH,):  # and deepseek-v2-lite's, with lse
            kernels[-1]["train_launches_per_step"] = trained_mla[
                "launches_per_step"]["flash_attention"]
    # the backward of attention: no pallas_call stands behind it (the TPU's
    # train step differentiates the blocked reference attention with XLA)
    # qwen3-0.6b's step through the wgmma kernels, deepseek-v2-lite's
    # through the MLA wgmma kernels at (576, 512); stablelm-3b's training
    # shape (80, 80) (the wgmma kernels), which no phase trains, beside
    # the latter
    for name, rec, run in (("flash_attention_bwd", bwd_timed["train_main"],
                            trained),
                           ("flash_attention_bwd[mla]",
                            bwd_timed["mla_train"], trained_mla)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/train/state.py:52",
            "replaces_what": "jax.value_and_grad through "
                             "src/repro/kernels/ref.py:52 (XLA autodiff; no "
                             "pallas_call)",
            "launches": run["launches"]["flash_attention_bwd"],
            "launches_per_step": run["launches_per_step"][
                "flash_attention_bwd"],
            "train_arch": run["arch"], "variant": rec["variant"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_backend": rec["library_backend"],
            "forward_lse_ms": rec["forward_lse_ms"],
            "forward_ms": rec["forward_ms"],
            "bwd_kernels": rec["bwd_kernels"],
            "repeat_bit_equal": rec["repeat_bit_equal"]})
    kernels[-1]["stablelm_train"] = {
        k: bwd_timed["stablelm_train"][k] for k in (
            "variant", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "max_abs_err", "bwd_kernels")}
    # the backward of the SSD scan: no pallas_call stands behind it either
    # (the TPU's train step differentiates the reference scan with XLA)
    rec = ssd_bwd_timed["main"]
    kernels.append({
        "name": "ssd_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/train/state.py:52",
        "replaces_what": "jax.value_and_grad through "
                         "src/repro/models/mamba2.py:91, "
                         "src/repro/kernels/ops.py:116 and "
                         "src/repro/kernels/ref.py:247 (XLA autodiff; no "
                         "pallas_call)",
        "launches": trained_ssm["launches"]["ssd_bwd"],
        "launches_per_step": trained_ssm["launches_per_step"]["ssd_bwd"],
        "max_abs_err": rec["max_abs_err"],
        "err_over_scale_by_output": rec["err_over_scale_by_output"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"], "variant": rec["variant"],
        "forward_ms": rec["forward_ms"], "kernel_ms": rec["kernel_ms"],
        "repeat_bit_equal": rec["repeat_bit_equal"],
        # jamba's mamba sublayers' shape (256 heads), timed in phase 2
        "jamba": {k: ssd_bwd_timed["jamba"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "forward_ms", "kernel_ms")}})
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
              "decode_ms_per_step": r["decode_ms_per_step"],
              "setup_s": r["setup_s"], "layers": r["layers"],
              "max_memory_allocated_bytes": r["max_memory_allocated_bytes"],
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
                                           "restore_s")},
          "sharded_sweep": {k: sharded[k] for k in (
              "sharded_runs_per_s", "unsharded_runs_per_s",
              "sharded_over_unsharded", "gather_bytes", "bit_equal")},
          "sharded_sweep_peak_above_start_bytes": [
              t["peak_above_start_bytes"] for t in sharded["turns"]],
          "sharded_tuner_equal": sharded["tuner"]["equal_to_unsharded"],
          "analysis_s": sharded["analysis"]["seconds"],
          "train": {k: trained[k] for k in (
              "ms_per_step", "warmup_step_ms", "tokens_per_s",
              "max_memory_allocated_bytes", "launches_per_step", "loss",
              "grad_norm")},
          "train_profiled_step": trained["profiled_step"],
          "train_ssm": {k: trained_ssm[k] for k in (
              "ms_per_step", "warmup_step_ms", "tokens_per_s",
              "max_memory_allocated_bytes", "launches_per_step", "loss",
              "grad_norm")},
          "train_ssm_profiled_step": trained_ssm["profiled_step"],
          "train_mla": {k: trained_mla[k] for k in (
              "layers", "ms_per_step", "warmup_step_ms", "tokens_per_s",
              "max_memory_allocated_bytes", "launches_per_step", "loss",
              "grad_norm")},
          "train_mla_profiled_step": trained_mla["profiled_step"],
          "train_ssp_apply_scale": trained["ssp"]["apply_scale"]})
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
