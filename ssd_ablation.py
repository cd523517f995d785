#!/usr/bin/env python3
"""Time the SSD scan kernel against copies of itself with one part taken
out, and against another checkout's kernel, on one NVIDIA GPU.

    python3 ssd_ablation.py [--parent DIR]

Run from the root of a checkout.  Each ablation is a textual change to
``src/repro_torch/kernels/csrc/ssd_scan.cu``: the scores' ``mma.sync``
products removed (``no_scores``: wrong results, the time without the
tensor-core work), chunk c+1's loads waited for as soon as they are
issued (``no_overlap``: they no longer overlap chunk c's products), the
state update run after C state^T instead of interleaved with it
(``apart``), and the generic instance run at n = chunk = 128 in place of
the compile-time one (``generic``).  With ``--parent DIR``, the
``ssd_scan.cu`` of the checkout at DIR (for example a ``git archive`` of
the parent commit) is built too, as ``parent``.  Every copy is built
with the port's ``nvcc`` flags into ``build/ssd_ablation/``
(``ablation_kit``) and called
through the same C entry point on the same inputs, at mamba2-130m's
prefill shape (b 8, s 2048, h 24, p 64, g 3, n 128, chunk 128, bf16), in
turns (all copies, then all in reverse, then all again).  One JSON line
per copy on standard output, with its times, its error against the plain
version and its ptxas lines; the last line is the card's ``nvidia-smi``
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import ablation_kit

ROOT = Path(__file__).resolve().parent
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
SHAPE = (8, 2048, 24, 64, 3, 128, 128)     # b, s, h, p, g, n, chunk

ABLATIONS = {
    "as_built": [],
    "no_scores": [("      mma_bf16(sc[ks & 1], af[ks], ld32(br + 16 * ks),\n"
                   "               ld32(br + 16 * ks + 8));", "      ;")],
    "no_overlap": [("                 hi, p0, d);\n",
                    "                 hi, p0, d);\n"
                    '    asm volatile("cp.async.wait_group 0;\\n" ::: '
                    '"memory");\n')],
    "apart": [("const bool fused = N && L && L == N;",
               "const bool fused = false;"),
              ("if (warp < nk && !(N && L && L == N)) {", "if (warp < nk) {")],
    "generic": [("if (d.n == 128 && d.l == 128)", "if (false)")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose ssd_scan.cu is timed as 'parent'")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    libs = ablation_kit.build("ssd_ablation", ablation_kit.sources(
        SRC, ABLATIONS, parent=args.parent))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        lib.ssd_forward.argtypes = [vp] * 7 + [i] * 9 + [vp]
        lib.ssd_forward.restype = i
    dev = torch.device("cuda")
    b, s, h, p, g, n, chunk = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, g, n), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    y = torch.empty_like(x)
    st = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        # rb = chunk: the per-head kernel keeps the whole score block here
        err = lib.ssd_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              B.data_ptr(), C.data_ptr(), y.data_ptr(),
                              st.data_ptr(), b, s, h, p, g, n, chunk, chunk,
                              1, stream)
        if err:
            raise RuntimeError(f"ssd_forward: cudaError {err}")

    y_want, st_want = ref.ssd_chunked(x, dt, A, B, C, chunk)
    ms = ablation_kit.in_turns(
        {name: (lambda lib=lib: call(lib)) for name, (lib, _) in
         libs.items()}, reps=20, warmup=3)
    for name, (lib, log) in libs.items():
        call(lib)
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": dict(zip(("b", "s", "h", "p", "g", "n", "chunk"), SHAPE,
                              strict=True)),
            "copy": name, "ms": ms[name],
            "max_abs_err_y": (y.float() - y_want.float()).abs().max().item(),
            "tol_y": ref.ssd_tolerance(y_want, x.dtype),
            "max_abs_err_state": (st - st_want).abs().max().item(),
            "tol_state": ref.ssd_state_tolerance(st_want),
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]}), flush=True)
    print(ablation_kit.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
