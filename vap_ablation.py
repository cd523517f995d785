#!/usr/bin/env python3
"""Time the ``vap_suffix_norms`` kernel against copies of itself with one
part changed or taken out, and against another checkout's kernel, on one
NVIDIA GPU.

    python3 vap_ablation.py [--parent DIR] [--only NAME,...]

Run from the root of a checkout.  Each copy is a textual change to
``src/repro_torch/kernels/csrc/ps_view.cu``: half the ring's stages
(``half_stages``), twice as many (``double_stages``), one or three CTAs
an SM (``ctas1``, ``ctas3``), tiles of 1024 or 4096 columns
(``tile1024``, ``tile4096``), every ring sent to the
register instance, which issues all W loads of a column before the adds
(``register``), the consumers' reads and adds taken out so that only the
bulk copies and the barriers are left (``no_compute``, wrong results),
and the copies taken out so that only the consumers and the barriers are
left (``no_loads``, wrong results).  With ``--parent DIR``, the
``ps_view.cu`` of the checkout at DIR (for example a ``git archive`` of
the parent commit unpacked under ``build/``) is built too, as ``parent``.
Every copy is built with the port's ``nvcc`` flags into
``build/vap_ablation/`` and called through its C entry point on the same
inputs, in turns (all copies, then all in reverse, then all again), each
call zeroing its output first as the wrapper does: at W = 5, 11 and 22
(the MF paths' essp(3) and vap(0.5) windows and the fault path's) over
P = 8, d = 5,053,800, and at W = 5 over LDA's d = 10,266,000.  One JSON
line per copy and shape on standard output with its times (ms, one per
turn), the bound (``chip_smoke.kernel_bounds``), its largest difference
from the plain version and, at the first shape, the ptxas lines of its
``vap`` kernels; the last line is the card's ``nvidia-smi`` name and
power limit.  The same lines go to ``chiprun_out/vap_ablation.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import ablation_kit  # noqa: E402
import chip_smoke  # noqa: E402

OUT = ROOT / "chiprun_out" / "vap_ablation.jsonl"
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "ps_view.cu"

ABLATIONS = {
    "as_built": [],
    "half_stages": [("constexpr int VAP_STAGES = 4;",
                     "constexpr int VAP_STAGES = 2;")],
    "double_stages": [("constexpr int VAP_STAGES = 4;",
                       "constexpr int VAP_STAGES = 8;")],
    "ctas1": [("constexpr int VAP_CTAS_PER_SM = 2;",
               "constexpr int VAP_CTAS_PER_SM = 1;")],
    "ctas3": [("constexpr int VAP_CTAS_PER_SM = 2;",
               "constexpr int VAP_CTAS_PER_SM = 3;")],
    "tile1024": [("constexpr int VAP_TILE = 2048;",
                  "constexpr int VAP_TILE = 1024;")],
    "tile4096": [("constexpr int VAP_TILE = 2048;",
                  "constexpr int VAP_TILE = 4096;")],
    "register": [("if (d % 4 == 0 && reinterpret_cast<uintptr_t>(uring) % 16"
                  " == 0) {", "if (false) {")],
    "no_compute": [("          if (live[i]) {", "          if (false) {")],
    "no_loads": [("          mbar_expect_tx(VAP_FULL(s), bytes);\n"
                  "          bulk_load(smem_u32(stage + s * VAP_TILE), "
                  "src + w * slot_stride,\n"
                  "                    bytes, VAP_FULL(s));",
                  "          mbar_arrive(VAP_FULL(s));")],
}
P = 8
D_MF = (chip_smoke.FULL_MF["n_rows"] + chip_smoke.FULL_MF["n_cols"]) \
    * chip_smoke.FULL_MF["rank"]
D_LDA = chip_smoke.FULL_LDA["n_topics"] * chip_smoke.FULL_LDA["vocab"]
SHAPES = ((22, D_MF), (5, D_MF), (11, D_MF), (5, D_LDA))


def make_call(torch, name, lib, uring, uclock, c):
    """A closure that zeroes this copy's output and runs its kernel into
    it; returns (call, output)."""
    W, P, d = uring.shape
    out = torch.zeros((W + 1, P), dtype=torch.float32, device=uring.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        out.zero_()
        e = lib.ps_vap_suffix_norms(uring.data_ptr(), uclock.data_ptr(), c,
                                    out.data_ptr(), W, P, d, stream)
        if e:
            raise RuntimeError(f"{name}: ps_vap_suffix_norms cudaError {e}")
    return call, out


def emit(obj) -> None:
    """One line to standard output and to chiprun_out/vap_ablation.jsonl."""
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose ps_view.cu is timed as 'parent'")
    ap.add_argument("--only", default="",
                    help="comma-separated copies to build (default all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("vap_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    rates = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    only = {s for s in args.only.split(",") if s}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    texts = ablation_kit.sources(SRC, ABLATIONS, parent=args.parent,
                                 only=only)
    for name, (lib, log) in ablation_kit.build("vap_ablation",
                                               texts).items():
        lib.ps_vap_suffix_norms.argtypes = [vp, vp, i, vp, i, i,
                                            ctypes.c_longlong, vp]
        lib.ps_vap_suffix_norms.restype = i
        libs[name] = (lib, [ln for ln in chip_smoke.ptxas_report(log)
                            if "vap" in ln])
    dev = torch.device("cuda")
    for n, (W, d) in enumerate(SHAPES):
        _, uring, uclock, cview, c = chip_smoke.ring_inputs(
            W, P, d, 0, seed=W * 1000 + P, device=dev)
        want = ref.vap_suffix_norms(uring, uclock, c)
        bound = chip_smoke.kernel_bounds(uclock, cview, c, P, d,
                                         rates)["vap_suffix_norms"]
        calls = {name: make_call(torch, name, lib, uring, uclock, c)
                 for name, (lib, _) in libs.items()}
        ms = ablation_kit.in_turns(
            {name: c[0] for name, c in calls.items()}, reps=20)
        for name, (_, ptxas) in libs.items():
            call, out = calls[name]
            call()
            torch.cuda.synchronize()
            emit({"W": W, "P": P, "d": d, "copy": name, "ms": ms[name],
                  "bound_ms": bound[0], "bound_by": bound[1],
                  "max_abs_err": (out - want).abs().max().item(),
                  "ptxas": ptxas if n == 0 else None})
        del calls, uring, want
        torch.cuda.empty_cache()
    emit(ablation_kit.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
