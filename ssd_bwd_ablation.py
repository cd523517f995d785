#!/usr/bin/env python3
"""Time the SSD backward (``ssd_bwd``) against copies of its kernels with
one part changed or taken out, on one NVIDIA GPU.

    python3 ssd_bwd_ablation.py

Run from the root of a checkout.  Each copy is a textual change to
``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``:

- ``row_tiles``: the pair products (C·Bᵀ and dy·x̄ᵀ) with each lane's four
  rows contiguous, so a warp's lanes read rows four apart (the 4 x 4
  output tile's layout, which the kernel had before its pair products
  took rows eight apart a lane): right results, more bank conflicts;
- ``unroll2``: the products' k loops unrolled by two;
- ``no_pairs``: the two pair products not computed (wrong results: the
  time without them);
- ``no_walks``: the two walks over the chunks not launched (wrong
  results);
- ``no_chunk``: the in-chunk kernel not launched (wrong results).

Every copy is built with the port's ``nvcc`` flags into
``build/ssd_bwd_ablation/`` (``ablation_kit``) and called through its C
entry point, ``ssd_backward``, into the same buffers, on the same inputs,
at mamba2-130m's training shape (b 8, s 2048, h 24, p 64, g 3, n 128,
chunk 128, bf16, no cotangent of the final state), in turns (all copies,
then all in reverse, then all again): the three kernels, not the
wrapper's allocations or its sums over a group's heads.  One JSON line
per copy on standard output, with its times, whether it is within
``ref.ssd_bwd_tolerance`` of the plain version (the group sums made
here, as ``ssd_scan.ssd_bwd`` makes them) and its ptxas lines; the last
line is the card's ``nvidia-smi`` name and power limit.  The parent
commit of the kernel has no backward, so there is no ``--parent``.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import ablation_kit

ROOT = Path(__file__).resolve().parent
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "ssd_scan_bwd.cu"
SHAPE = (8, 2048, 24, 64, 3, 128, 128)     # b, s, h, p, g, n, chunk

_LOOPS = ("  for (int k = k0; k < k1; k += 4) {\n    float a[4][4], bm[4][4];",
          "  for (int k = 0; k < k1; k += 4) {\n    float a[4][4], bt[4][4];",
          "  for (int k = k0; k < k1; ++k) {\n    float a[4], bm[4];")
ABLATIONS = {
    "as_built": [],
    "row_tiles": [
        ("const int r0 = 32 * rb + rl, j0", "const int r0 = 32 * rb + 4 * rl, j0"),
        ("ra[a] = min(r0 + 8 * a, L - 1);", "ra[a] = min(r0 + a, L - 1);"),
        ("const int i = r0 + 8 * a;", "const int i = r0 + a;"),
        ("if (cq == 0 && r0 + 8 * a < L) rowp[cb * L + r0 + 8 * a] = v;",
         "if (cq == 0 && r0 + a < L) rowp[cb * L + r0 + a] = v;")],
    "unroll2": [(loop, "#pragma unroll 2\n" + loop) for loop in _LOOPS],
    "no_pairs": [("    mm_nt(acc, c_s, ns, ra, b_s, ns, j0, N);", ""),
                 ("    mm_nt(dw, dy_s, ps, ra, x_s, ps, j0, P);", "")],
    "no_walks": [("  ssd_bwd_states<T><<<", "  if (false) ssd_bwd_states<T><<<"),
                 ("  ssd_bwd_dstates<T><<<",
                  "  if (false) ssd_bwd_dstates<T><<<")],
    "no_chunk": [("  ssd_bwd_chunk<T, XT><<<",
                  "  if (false) ssd_bwd_chunk<T, XT><<<")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref, ssd_scan
    built = ablation_kit.build("ssd_bwd_ablation",
                               ablation_kit.sources(SRC, ABLATIONS))
    for lib, _ in built.values():
        for fn, args in ssd_scan._BWD_ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    b, s, h, p, g, n, chunk = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    x, dy = (torch.randn((b, s, h, p), generator=gen, device=dev).bfloat16()
             for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, g, n), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    nc = -(-s // chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    states, gstates = (torch.empty((b, h, nc, p, n), **f32)
                       for _ in range(2))
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), **f32)
    dBp, dCp = (torch.empty((b, s, h, n), **f32) for _ in range(2))
    dAp = torch.empty((b, nc, h), **f32)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.ssd_backward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), None, states.data_ptr(),
            gstates.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), b, s, h, p, g,
            n, chunk, 1, stream)
        if err:
            raise RuntimeError(f"ssd_backward: cudaError {err}")

    want = ref.ssd_bwd(x, dt, A, B, C, dy, None, chunk)
    ms = ablation_kit.in_turns(
        {name: (lambda lib=lib: call(lib)) for name, (lib, _) in
         built.items()})
    for name, (lib, log) in built.items():
        # a copy that leaves an output unwritten reads as not within
        for t in (states, gstates, dx, ddt, dBp, dCp, dAp):
            t.fill_(float("nan"))
        call(lib)
        got = (dx, ddt, dAp.sum((0, 1)),
               dBp.view(b, s, g, h // g, n).sum(3).bfloat16(),
               dCp.view(b, s, g, h // g, n).sum(3).bfloat16())
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": dict(zip(("b", "s", "h", "p", "g", "n", "chunk"), SHAPE,
                              strict=True)),
            "copy": name, "ms": ms[name],
            "within": ref.ssd_bwd_within(got, want),
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]}), flush=True)
    print(ablation_kit.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
