#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; never
JAX or the JAX package).  Four phases, one JSON line each (or more):

1. device and build: the card's name and power limit, then ``nvcc``
   builds the kernels from ``src/repro_torch/kernels/csrc``;
2. every hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes, with its time, the
   plain version's time, a one-call library yardstick where there is one
   and the least time the card could take for the bytes these inputs need
   (over the H100 SXM data-sheet memory rate).  ``delta_pack`` must be
   bit-equal for f32, bf16 and int8; the comm substrate's threshold
   selection is timed beside the other exact selections;
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
   whole quantization step, as a flipped VAP decision would.

Then the ``kernels`` summary line, the card's ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a GPU, or without the repository beside it, the script
exits non-zero before printing any result.  Everything it prints also goes
to ``chiprun_out/chip_smoke.jsonl``.
"""
from __future__ import annotations

import json
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
# memory rate (bytes/s) and float32 rate outside the tensor cores (FLOP/s):
# NVIDIA H100 SXM, at its full 700 W power limit.
CARD = ("NVIDIA H100 80GB HBM3", 3.35e12, 67e12)

_lines: list[str] = []


def emit(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def card_rates(name: str):
    if name != CARD[0]:
        raise RuntimeError(f"no data-sheet rates for {name!r}; the bounds "
                           f"are stated for {CARD[0]}")
    return CARD[1], CARD[2]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0].strip()


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
    bw, flops = rates
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
            bw, flops = rates
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
                "delta_pack": 0}
    ships = sum(substrate.ship_now(c, cfg.agg_clocks)
                for c in range(n_clocks))
    return {"ring_view": 2 * n_clocks, "vap_suffix_norms": n_clocks,
            "delta_pack": ships}


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
    import warnings
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
    syncs = []

    def on_warning(message, *_):
        if "synchroniz" in str(message):      # where the op was called
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            syncs.append(" <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                                     for f in frames[:-6:-1]))

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # set first: turning the mode on warns once about the mode itself
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = on_warning
        try:
            trace = ps.simulate(app, cfg, n_clocks, seed=0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
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
    ptxas = []
    for log in sorted(build._build_dir().glob("*.log")):
        ptxas += [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
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
    emit({"total_s": time.perf_counter() - t_start,
          "main_path_launches": main_launches,
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
