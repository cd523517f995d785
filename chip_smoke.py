#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; never
JAX or the JAX package).  Four phases, one JSON line each (or more):

1. device and build: the card's name and power limit, then ``nvcc``
   builds the kernels from ``src/repro_torch/kernels/csrc``;
2. every hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes, with its time, the
   plain version's time, a one-call library yardstick and the least time
   the card could take for the bytes these inputs need (over the H100 SXM
   data-sheet memory rate);
3. the main path at full width: MF-SGD at the paper's Netflix rank and
   item count through ``simulate`` under ``essp(3)`` and ``vap(0.5)``;
   both kernels must be launched once per clock, the clock loop must not
   synchronize with the host, the traces must be finite, the loss falling
   and the ESSP staleness bound kept; a profiled run gives the per-clock
   device time of the kernels and of the rest, and the device's idle share
   in that same run;
4. the default MF config on the card against the same run on the CPU:
   integer Trace fields equal, float fields within the ulp budget.

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


def assert_finite(trace, what):
    import torch
    for f in ("loss_ref", "loss_view", "u_l2", "intransit_inf", "ship_floats",
              "x_final"):
        if not torch.isfinite(getattr(trace, f)).all():
            raise AssertionError(f"{what}: Trace.{f} is not finite")


KERNEL_NAMES = ("ring_view_kernel", "vap_suffix_norms_kernel")


def device_split(app, cfg, n_clocks):
    """Device time per clock from a profiled run: all kernels, the port's
    two kernels, and the five ops that take the most of it; the host time
    per clock of the same run, and the share of it the device was idle.
    The profiler's own host cost is inside that host time."""
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
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:5]
    busy_ms = busy / 1e3 / n_clocks
    return {"profiled_ms_per_clock": wall_ms,
            "device_ms_per_clock": busy_ms,
            "kernel_ms_per_clock": ours / 1e3 / n_clocks,
            "rest_device_ms_per_clock": busy_ms - ours / 1e3 / n_clocks,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_ops_ms_per_clock": {
                e.key: e.self_device_time_total / 1e3 / n_clocks
                for e in ops}}


def run_main_path(app, cfg, name, n_clocks):
    """One simulate run through the entry point, with the kernel counters
    set to 0 just before and read just after (after a 2-clock warm-up run
    that loads PyTorch's kernels), then a profiled run of as many clocks
    for the per-clock device split.

    The counted run also runs under ``torch.cuda.set_sync_debug_mode``:
    each operation that makes the host wait for the device (a copy from
    the host, ``.item()``) is recorded with its call site, and the phase
    fails after both configs if there was one."""
    import warnings
    import torch
    from repro_torch.convert import trace_to_numpy
    from repro_torch.core import ps, staleness
    from repro_torch.kernels import ps_view
    from repro_torch.psrun import validate
    ps.simulate(app, cfg, 2, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ps_view.reset_launches()
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
    launches = dict(ps_view.launches)
    for k, n in launches.items():
        if n != n_clocks:
            raise AssertionError(f"{name}: {k} launched {n} times in "
                                 f"{n_clocks} clocks")
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
    split = device_split(app, cfg, n_clocks)
    rec.update(split)
    if split["device_ms_per_clock"] is not None:
        # the profiler's host cost inflates the same-run share; this one
        # sets the profiled run's device time against the counted run's
        # host time (device time agrees within ~2 % between runs)
        rec["device_idle_share_cross_run"] = (
            1.0 - split["device_ms_per_clock"] / rec["ms_per_clock"])
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
    from repro_torch.kernels import build, ps_view
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

    # --- 3. main path at full width -----------------------------------------
    t0 = time.perf_counter()
    app = matfact.make_mf_app(matfact.MFConfig(**FULL_MF), device=dev)
    torch.cuda.synchronize()
    emit({"phase": "main_path_setup", "config": FULL_MF, "d": app.dim,
          "make_mf_app_s": time.perf_counter() - t0})
    main_launches, main_syncs = {}, {}
    for name, cfg in (("essp3", cc.essp(3)), ("vap", cc.vap(FULL_VAP_V0))):
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
    for name, cfg in (("essp3", cc.essp(3)), ("vap", cc.vap(SMALL_VAP_V0))):
        got = ps.simulate(matfact.make_mf_app(small, device=dev), cfg,
                          SMALL_CLOCKS)
        want = ps.simulate(matfact.make_mf_app(small, device="cpu"), cfg,
                           SMALL_CLOCKS)
        diffs = validate.trace_max_diff(got, want)
        ulps = validate.trace_max_ulp(got, want)
        rec = {"phase": "card_vs_cpu", "config": name, "clocks": SMALL_CLOCKS,
               "int_fields_equal": all(diffs[f] == 0.0
                                       for f in validate.INT_FIELDS),
               "max_ulp": ulps, "ulp_budget": validate.VAP_ULP_BUDGET}
        emit(rec)
        if not rec["int_fields_equal"]:
            raise AssertionError(f"card vs CPU ({name}): integer fields "
                                 f"differ: {diffs}")
        bad = {f: u for f, u in ulps.items() if f in validate.FLOAT_FIELDS
               and u > validate.VAP_ULP_BUDGET}
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
    emit({"total_s": time.perf_counter() - t_start,
          "main_path_launches": main_launches})
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
