#!/usr/bin/env python3
"""Time the sweep sharded over a mesh of one NCCL rank against the
unsharded sweep, in turns, and split each turn's host time.

    python3 sweep_turns.py [--turns 8] [--clocks 30]

Run from the root of a checkout on a machine with a GPU (it imports
``src/repro_torch``, never JAX).  The workload is ``chip_smoke.py``'s
phase 14: the C2-LDA figure (``bsp``, ``ssp(5)``, ``essp(5)``) on the
full-width LDA app (``FULL_LDA``), two seeds, with the LDA time model's
breakdown as the ``post``.  After a 2-clock warm-up of both paths the
turns alternate in the order sharded, unsharded, unsharded, sharded, ...
Each turn ends in a synchronize and reports its wall seconds, runs per
second, and the host seconds spent in ``simulate``, in the ``post``, in
the gather (``_gather_leaf``) and in the barriers; the rest is the
sweep's own code.  One JSON line per turn, then a summary line with the
card's name and power limit; the lines also go to
``chiprun_out/sweep_turns.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "sweep_turns.jsonl"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--clocks", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.apps import lda
    from repro_torch.core import consistency as cc
    from repro_torch.core import sweep
    from repro_torch.launch.mesh import make_batch_mesh

    lines = []

    def emit(obj):
        line = json.dumps(obj)
        lines.append(line)
        print(line, flush=True)

    app = lda.make_lda_app(lda.LDAConfig(**cs.FULL_LDA), device="cuda")
    mesh = make_batch_mesh()
    cfgs = cs.lda_figure_cfgs(cc)
    seeds = cs.SHARDED_SEEDS
    runs = len(cfgs) * len(seeds)
    spent = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return wrapper

    breakdown = cs.lda_breakdown_post(lda.lda_time_model())
    post = timed("post", breakdown)
    sweep.simulate = timed("simulate", sweep.simulate)
    sweep._gather_leaf = timed("gather", sweep._gather_leaf)
    dist.barrier = timed("barrier", dist.barrier)
    for kw in (dict(mesh=mesh), {}):
        sweep.sweep(app, cfgs, 2, seeds=seeds, post=post, **kw)
    torch.cuda.synchronize()
    order = ["sharded", "unsharded", "unsharded", "sharded"]
    rates = {"sharded": [], "unsharded": []}
    for k in range(args.turns):
        name = order[k % 4]
        spent.clear()
        t = time.perf_counter()
        sweep.sweep(app, cfgs, args.clocks, seeds=seeds, post=post,
                    **(dict(mesh=mesh) if name == "sharded" else {}))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        rates[name].append(runs / secs)
        emit({"turn": k, "sweep": name, "seconds": secs,
              "runs_per_s": runs / secs,
              "host_s": dict(spent),
              "rest_s": secs - sum(spent.values())})
    smi = cs.nvidia_smi()
    emit({"summary": "sweep_turns", "runs": runs, "clocks": args.clocks,
          "sharded_runs_per_s": rates["sharded"],
          "unsharded_runs_per_s": rates["unsharded"],
          "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    dist.destroy_process_group()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
