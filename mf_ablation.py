#!/usr/bin/env python3
"""Time the MF-SGD block kernel against copies of itself with one part
taken out, and against another checkout's kernel, on one NVIDIA GPU.

    python3 mf_ablation.py [--parent DIR] [--only NAME,...]

Run from the root of a checkout.  Each ablation is a textual change to
``src/repro_torch/kernels/csrc/mf_sgd.cu`` (wrong results, the time
without that part): the per-entry work skipped (``no_entries``: what is
left is the mask's packing, the words' walk and the epilogues), the
ratings never read (``no_d``), and three forms of the mask's packing:
eight rows' loads in flight a warp instead of four (``pack_unroll8``),
the read-only cache path instead of the streaming one (``pack_ldg``),
128 rows a CTA instead of 256 (``pack_rows128``).  With
``--parent DIR``, the ``mf_sgd.cu`` of the checkout at DIR (for example
a ``git archive`` of the parent commit, whose kernel computes the dense
products) is built too, as ``parent``.  Every copy is built with the
port's ``nvcc`` flags into ``build/mf_ablation/`` and called through its
C entry points on the same inputs, in turns (all copies, then all in
reverse, then all again): at ``main``, the dense block of the full-width
MF data (``chip_smoke.FULL_MF``: N 32,768, M 17,770, K 100, 1.17 %
observed), and at the JAX package's ``kernels`` suite's shape (512 x 512
x 32, density 0.2).  One JSON line per copy and shape on standard output
with its times, the device time of each of its kernels (the mask's
packing, R's transpose, ROWS pass, COLS pass, finalize) from a profiled
call, its error against the plain
version and the ptxas lines of the instance it ran; the last line is the
card's ``nvidia-smi`` name and power limit.  The same lines go to
``chiprun_out/mf_ablation.jsonl``.
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

OUT = ROOT / "chiprun_out" / "mf_ablation.jsonl"
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "mf_sgd.cu"

ABLATIONS = {
    "as_built": [],
    "no_entries": [("    for (int r0 = 0; r0 < total; r0 += 32) {",
                    "    for (int r0 = 0; r0 < 0; r0 += 32) {")],
    "no_d": [("const float dv = lane < nr ? __ldcs(D + dof + x * dx) : 0.f;",
              "const float dv = 0.f;")],
    "pack_unroll8": [("#pragma unroll 4\n  for (int i = w; i < PR; i += WARPS)",
                      "#pragma unroll 8\n  for (int i = w; i < PR; i += WARPS)")],
    "pack_ldg": [("__ldcs(base + lane)", "__ldg(base + lane)"),
                 ("__ldcs(base + 32)", "__ldg(base + 32)")],
    "pack_rows128": [("constexpr int PR = 256, PC = 512;",
                      "constexpr int PR = 128, PC = 512;"),
                     ("(N + 255) / 256), 256, 0, a.stream>>>(",
                      "(N + 127) / 128), 256, 0, a.stream>>>(")],
}
# the kernels of one call, by the names their device events carry
# (demangled or mangled; the parent's two passes are one template)
KERNELS = {"pack": ("mf_pack",), "transpose": ("mf_transpose",),
           "rows": ("mf_rows", "mf_pass<0", "mf_passILi0"),
           "cols": ("mf_cols", "mf_pass<1", "mf_passILi1"),
           "finalize": ("mf_finalize", "mf_loss")}


def make_call(torch, name, lib, L, R, D, mask, gamma, lam):
    """A closure that runs one ``mf_sgd_block`` of this copy into its own
    outputs; returns (call, outputs)."""
    N, K = L.shape
    M = R.shape[1]
    dev = L.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    if name == "parent":
        # (split_rows, split_cols, tile, loss partials): the dense-product
        # kernel's scratch of split partial sums
        out = (ctypes.c_int * 4)()
        err = lib.mf_plan(N, M, K, ctypes.addressof(out))
        if err:
            raise RuntimeError(f"{name}: mf_plan cudaError {err}")
        split_r, split_c = out[0], out[1]
        bufs = [torch.empty((split_r, N, K), **f32),
                torch.empty((split_r, N), **i32),
                torch.empty((out[3],), **f32),
                torch.empty((split_c, K, M), **f32),
                torch.empty((split_c, M), **i32)]
        ints = (N, M, K, split_r, split_c)
    else:
        bufs = [torch.empty((M, K), **f32),
                torch.empty((N, (M + 63) // 64), **i64),
                torch.empty((M, (N + 63) // 64), **i64),
                torch.empty((M, K), **f32),
                torch.empty((N,), **f32), torch.empty((N,), **i32),
                torch.empty((M,), **i32)]
        ints = (N, M, K)
    outs = (torch.empty((N, K), **f32), torch.empty((K, M), **f32),
            torch.empty((), **f32))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        e = lib.mf_sgd_block(L.data_ptr(), R.data_ptr(), D.data_ptr(),
                             mask.data_ptr(),
                             *(b.data_ptr() for b in bufs),
                             *(o.data_ptr() for o in outs), *ints,
                             float(gamma), float(lam), stream)
        if e:
            raise RuntimeError(f"{name}: mf_sgd_block cudaError {e}")
    return call, outs


def emit(obj) -> None:
    """One line to standard output and to chiprun_out/mf_ablation.jsonl."""
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose mf_sgd.cu is timed as 'parent'")
    ap.add_argument("--only", default="",
                    help="comma-separated ablations to build (default all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mf_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    only = {s for s in args.only.split(",") if s}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    texts = ablation_kit.sources(SRC, ABLATIONS, parent=args.parent,
                                 only=only)
    for name, (lib, log) in ablation_kit.build("mf_ablation",
                                               texts).items():
        # the parent's entry point takes five scratch buffers and the
        # split counts of its plan
        n_ptr, n_int = (12, 5) if name == "parent" else (14, 3)
        if name == "parent":
            lib.mf_plan.argtypes = [i, i, i, vp]
            lib.mf_plan.restype = i
        lib.mf_sgd_block.argtypes = [vp] * n_ptr + [i] * n_int + [f, f, vp]
        lib.mf_sgd_block.restype = i
        libs[name] = (lib, chip_smoke.ptxas_report(log))
    dev = torch.device("cuda")
    for case, reps in (("main", 5), ("kernels_bench", 50)):
        (L, R, D, mask), gamma, lam = chip_smoke.mf_inputs(case, dev)
        want = ref.mf_sgd_block(L, R, D, mask, gamma, lam)
        tol = ref.mf_sgd_tolerance(L, R, D, mask, gamma, lam)
        calls = {name: make_call(torch, name, lib, L, R, D, mask, gamma,
                                 lam) for name, (lib, _) in libs.items()}
        ms = ablation_kit.in_turns(
            {name: c[0] for name, c in calls.items()}, reps=reps)
        # the ptxas lines of the instance this shape runs
        used = f"ILi{(L.shape[1] + 31) // 32}E"
        for name, (_, ptxas) in libs.items():
            call, outs = calls[name]
            call()
            torch.cuda.synchronize()
            err = [(g - w).abs().max().item()
                   for g, w in zip(outs, want, strict=True)]
            emit({
                "case": case, "shape": {"N": L.shape[0], "M": R.shape[1],
                                        "K": L.shape[1]},
                "copy": name, "ms": ms[name],
                "kernel_ms": chip_smoke.mf_kernel_ms(call, KERNELS),
                "err": dict(zip(("dL", "dR", "loss"), err, strict=True)),
                "tol": dict(zip(("dL", "dR", "loss"), tol, strict=True)),
                "ptxas": [ln for ln in ptxas if used in ln]
                if case == "main" else None})
        del calls, L, R, D, mask, want
        torch.cuda.empty_cache()
    emit(ablation_kit.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
