#!/usr/bin/env python3
"""Time the SSD backward (``ssd_bwd``) against copies of its kernels with
one part changed or taken out, and against another checkout's, on one
NVIDIA GPU.

    python3 ssd_bwd_ablation.py [--parent DIR]

Run from the root of a checkout.  Each copy is a textual change to the
bf16 path (``tc::``) of ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``:

- ``no_lo``: the lo pass of every split product dropped (two bf16 passes
  in place of three: hi + mid carry 16 of a float32 operand's 24
  significand bits; its results are held to the limit too);
- ``fast_exp``: the pair decays e^{min(cum_i - cum_j, 0)} taken with the
  approximate ``__expf`` in place of ``expf``;
- ``g_with_first``: G_c's planes waited for with the chunk's other inputs
  (no overlap of their load with the dC pass);
- ``walk_two_ctas``: the walks at two CTAs an SM in place of three;
- ``walk_no_store``: the walks' stores of the split states taken out
  (wrong results);
- ``walk_no_cum``: the walks' one-thread cumsum taken out (wrong
  results);
- ``walk_no_update``: the walks' state update (their products) taken out
  (wrong results);
- ``no_walks``: the two walks over the chunks not launched (wrong
  results);
- ``no_chunk``: the in-chunk kernel not launched (wrong results);
- ``chunk_no_state``: the chunk kernel's three state products taken out
  (wrong results);
- ``chunk_no_pairs``: the chunk kernel's pair loops taken out (the scores
  and the split products; wrong results);
- ``chunk_loads_only``: both taken out: the loads, the cumsum, the
  stores and the barriers alone;
- ``chunk_no_loads``: the chunk kernel's copies of x, dy, S_c and G_c
  taken out (B and C stay): its products, sums and barriers on whatever
  shared memory holds;
- ``chunk_no_rmw``: the group sums stored without reading back the heads
  before (wrong dB and dC);
- ``chunk_no_tail``: ddt's stores at the end of each head taken out
  (wrong ddt);
- ``chunk_no_sg``: <S_c, G_c> taken out (wrong ddt and dA).

``--parent DIR`` adds DIR's ``ssd_scan_bwd.cu`` (e.g. a ``git archive``
of the parent commit unpacked under ``build/``) as ``parent``; its C
entry point ``ssd_backward`` takes the same arguments (its state scratch
is float32, 4 of the 6 bytes an element given).  Every copy is built with
the port's ``nvcc`` flags into ``build/ssd_bwd_ablation/``
(``ablation_kit``) and called through that entry point, into the same
buffers, on the same inputs, at mamba2-130m's training shape (b 8, s 2048,
h 24, p 64, g 3, n 128, chunk 128, bf16, no cotangent of the final state),
in turns (all copies, then all in reverse, then all again): the three
kernels, not the wrapper's allocations or its casts (or, for the parent,
its sums over a group's heads).  Then ``as_built`` and ``parent`` in
turns at jamba's mamba sublayers' shape (h 256, g 32).  One JSON line per
copy and shape on standard output, also written to
``chiprun_out/ssd_bwd_ablation.jsonl``, with its times, each kernel's
device ms from one profiled call, whether it is within
``ref.ssd_bwd_tolerance`` of the plain version (dB and dC cast here, and
the parent's summed over each group's heads, as ``ssd_scan.ssd_bwd``
does) with each gradient's error over its scale (at mamba2-130m's shape
also whether ddt's is within ``chip_smoke.SSD_BWD_SPLIT_LIMIT``, the
split's diagnostic; then the same for ``SPLIT_COPIES`` on the inputs
drawn from each of ``SPLIT_SEEDS``, a line each), the bound
(``chip_smoke.ssd_bwd_bound``, and its CUDA-core figure),
the SM clock and power sampled while timing, and its ptxas lines; the
last line is the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import ablation_kit

ROOT = Path(__file__).resolve().parent
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "ssd_scan_bwd.cu"
OUT = ROOT / "chiprun_out" / "ssd_bwd_ablation.jsonl"
SHAPES = {"main": (8, 2048, 24, 64, 3, 128, 128),     # b, s, h, p, g, n, chunk
          "jamba": (8, 2048, 256, 64, 32, 128, 128)}
# the copies timed at jamba's shape too
JAMBA = ("as_built", "parent")
# the copies held to the plain version (the others are wrong by design)
EXACT = ("as_built", "no_lo", "fast_exp", "g_with_first", "walk_two_ctas",
         "parent")
# the copies whose errors are read again at mamba2-130m's shape on the
# inputs drawn from each of SPLIT_SEEDS (seed 0 is every copy's)
SPLIT_COPIES = ("as_built", "no_lo", "fast_exp", "parent")
SPLIT_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)
# each kernel's profiler name, a substring of the bf16 kernel's and of the
# parent's templates'
KERNELS = {k: (k,)
           for k in ("ssd_bwd_states", "ssd_bwd_dstates", "ssd_bwd_chunk")}

STATE_PRODUCT = "    state_product<"
ABLATIONS = {
    "as_built": [],
    "no_lo": [("      mma(acc[2 * np], fl, fb[np][0], fb[np][1]);\n", ""),
              ("      mma(acc[2 * np + 1], fl, fb[np][2], fb[np][3]);\n", ""),
              ("    for (int q = 0; q < 3; ++q) {\n      uint32_t fb[MAXT / 2][4];",
               "    for (int q = 0; q < 2; ++q) {\n      uint32_t fb[MAXT / 2][4];"),
              ("        for (int q = 0; q < 3; ++q) {\n          uint32_t fa[4];",
               "        for (int q = 0; q < 2; ++q) {\n          uint32_t fa[4];")],
    "fast_exp": [("              const float E = j <= i ? expf(fminf(dd, 0.f)) : 0.f;",
                  "              const float E = j <= i ? __expf(fminf(dd, 0.f)) : 0.f;"),
                 ("i >= j ? s1[tn][e] * expf(fminf(ci - cjr[r], 0.f)) : 0.f;",
                  "i >= j ? s1[tn][e] * __expf(fminf(ci - cjr[r], 0.f)) : 0.f;"),
                 ("              const float E = i >= j ? expf(fminf(dd, 0.f)) : 0.f;",
                  "              const float E = i >= j ? __expf(fminf(dd, 0.f)) : 0.f;")],
    "g_with_first": [("    cp_wait<1>();\n    __syncthreads();  // the first group",
                      "    cp_wait<0>();\n    __syncthreads();  // the first group")],
    "walk_two_ctas": [("__launch_bounds__(THREADS, 3)",
                       "__launch_bounds__(THREADS, 2)")],
    "walk_no_store": [("    if (p0 + row < d.p)\n      *reinterpret_cast<uint4*>(o +",
                       "    if (false)\n      *reinterpret_cast<uint4*>(o +")],
    "walk_no_cum": [("    chunk_cum(cum, dts, Ah, L);\n    __syncthreads();\n"
                     "    // the chunk's rows, weighted",
                     "    __syncthreads();\n    // the chunk's rows, weighted")],
    "walk_no_update": [("    if ((warp >> 1) < ncb) {\n      for (int ks = 0; ks < L; ks += 16) {",
                        "    if (false) {\n      for (int ks = 0; ks < L; ks += 16) {")],
    "no_walks": [("  ssd_bwd_states_tc<<<", "  if (false) ssd_bwd_states_tc<<<"),
                 ("  ssd_bwd_dstates_tc<<<",
                  "  if (false) ssd_bwd_dstates_tc<<<")],
    "no_chunk": [("  ssd_bwd_chunk_tc<<<", "  if (false) ssd_bwd_chunk_tc<<<")],
    "chunk_no_state": [(STATE_PRODUCT, "    if (false) state_product<")],
    "chunk_no_pairs": [("for (int jb = 0; jb <= rb; ++jb)",
                        "for (int jb = 0; jb < 0; ++jb)"),
                       ("for (int ib = rb; 16 * ib < L; ++ib)",
                        "for (int ib = L; 16 * ib < L; ++ib)")],
    "chunk_no_loads": [
        ("        cp16(x_s + i * XS + 8 * q, x + src, i < nv);\n"
         "        cp16(dy_s + i * XS + 8 * q, dy + src, i < nv);\n", ""),
        ("      cp16(g3 + (r / d.p) * plane", "      if (false) cp16(g3 + (r / d.p) * plane"),
        ("        cp16(s3 + (r / d.p) * plane", "        if (false) cp16(s3 + (r / d.p) * plane")],
    "chunk_no_rmw": [("    if (hh && t < nt) {", "    if (false) {")],
    "chunk_no_tail": [("        if (i < nv) ddt[(row0 + i) * d.h + hi] = fmaf(acc, Ah, xd[i]);",
                       "")],
    "chunk_no_sg": [("      for (int e = tid; e < d.p * nq; e += THREADS) {\n"
                     "        const int at = (e / nq) * NS + 8 * (e % nq);",
                     "      for (int e = tid; e < 0; e += THREADS) {\n"
                     "        const int at = (e / nq) * NS + 8 * (e % nq);")],
    "chunk_loads_only": [(STATE_PRODUCT, "    if (false) state_product<"),
                         ("for (int jb = 0; jb <= rb; ++jb)",
                          "for (int jb = 0; jb < 0; ++jb)"),
                         ("for (int ib = rb; 16 * ib < L; ++ib)",
                          "for (int ib = L; 16 * ib < L; ++ib)")],
}


def over_scale(got, want):
    """Each gradient's largest error over its scale."""
    return {k: ((u.float() - w.float()).abs().max()
                / w.float().abs().max()).item()
            for k, u, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                               strict=True)}


def draw(shape, seed, dev):
    """x, dt, A, B, C, dy at ``shape`` from ``seed``: bf16 x, dy, B, C
    N(0, 1), dt softplus of N(0, 1), A = -e^{0.3 N(0, 1)}."""
    import torch
    b, s, h, p, g, n, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, dy = (torch.randn((b, s, h, p), generator=gen, device=dev).bfloat16()
             for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, g, n), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    return x, dt, A, B, C, dy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import ref, ssd_scan
    built = ablation_kit.build(
        "ssd_bwd_ablation",
        ablation_kit.sources(SRC, ABLATIONS, parent=args.parent))
    for lib, _ in built.values():
        for fn in ("ssd_backward", "ssd_bwd_smem_bytes"):
            getattr(lib, fn).argtypes = ssd_scan._BWD_ARGTYPES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    rates = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    OUT.parent.mkdir(exist_ok=True)
    out = open(OUT, "w")  # noqa: SIM115
    for shape_name, shape in SHAPES.items():
        b, s, h, p, g, n, chunk = shape
        x, dt, A, B, C, dy = draw(shape, 0, dev)
        nc = -(-s // chunk)
        f32 = dict(dtype=torch.float32, device=dev)
        # the state scratch: 6 bytes an element (the three bf16 planes;
        # the parent's float32 states take the first 4)
        states, gstates = (torch.empty((b, h, nc, 3, p, n),
                                       dtype=torch.bfloat16, device=dev)
                           for _ in range(2))
        dx = torch.empty_like(x)
        ddt = torch.empty((b, s, h), **f32)
        # dB, dC: per head for the parent, the group sums [b, s, g, n] in
        # the first b s g n elements for this checkout's kernel
        dBp, dCp = (torch.empty((b, s, h, n), **f32) for _ in range(2))
        dAp = torch.empty((b, nc, h), **f32)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib, x=x, dt=dt, A=A, B=B, C=C, dy=dy, states=states,
                 gstates=gstates, dx=dx, ddt=ddt, dBp=dBp, dCp=dCp, dAp=dAp,
                 shape=shape):
            b, s, h, p, g, n, chunk = shape
            err = lib.ssd_backward(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), dy.data_ptr(), None, states.data_ptr(),
                gstates.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), b, s, h, p,
                g, n, chunk, 1, stream)
            if err:
                raise RuntimeError(f"ssd_backward: cudaError {err}")

        want = ref.ssd_bwd(x, dt, A, B, C, dy, None, chunk)
        names = [k for k in built if shape_name == "main" or k in JAMBA]
        clock = ablation_kit.ClockSampler()
        clock.start()
        ms = ablation_kit.in_turns(
            {k: (lambda lib=built[k][0]: call(lib)) for k in names})
        clocks = clock.stop()
        full = (*shape, "bf16", "softplus")
        bound = chip_smoke.ssd_bwd_bound(full, rates)
        def gradients(name, shape=shape, call=call, dx=dx, ddt=ddt, dBp=dBp,
                      dCp=dCp, dAp=dAp, scratch=(states, gstates)):
            b, s, h, p, g, n, chunk = shape
            # a copy that leaves an output unwritten reads as not within
            for t in (*scratch, dx, ddt, dBp, dCp, dAp):
                t.fill_(float("nan"))
            call(built[name][0])
            if name == "parent":    # dB, dC per head
                sums = [t.view(b, s, g, h // g, n).sum(3) for t in (dBp, dCp)]
            else:                   # the group sums, [b, s, g, n]
                sums = [t.view(-1)[:b * s * g * n].view(b, s, g, n)
                        for t in (dBp, dCp)]
            got = (dx, ddt, dAp.sum((0, 1)), *(t.bfloat16() for t in sums))
            torch.cuda.synchronize()
            return got

        for name in names:
            lib, log = built[name]
            got = gradients(name)
            errs = over_scale(got, want)
            line = {
                "shape": dict(zip(("b", "s", "h", "p", "g", "n", "chunk"),
                                  shape, strict=True)),
                "copy": name, "ms": ms[name],
                "kernel_ms": chip_smoke.mf_kernel_ms(lambda: call(lib),
                                                     KERNELS),
                "within": ref.ssd_bwd_within(got, want),
                "held_to_limit": name in EXACT,
                "err_over_scale_by_output": errs,
                "within_split_limit": errs["ddt"]
                <= chip_smoke.SSD_BWD_SPLIT_LIMIT
                if shape_name == "main" else None,
                "bound_ms": bound[0], "bound_by": bound[1],
                "clocks_while_timing": clocks,
                "ptxas": ablation_kit.entry_ptxas(
                    log, ("ssd_bwd_states", "ssd_bwd_dstates",
                          "ssd_bwd_chunk"))}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
        # the split's diagnostic on more draws of the inputs
        for seed in SPLIT_SEEDS if shape_name == "main" else ():
            for t, v in zip((x, dt, A, B, C, dy), draw(shape, seed, dev),
                            strict=True):
                t.copy_(v)
            want = ref.ssd_bwd(x, dt, A, B, C, dy, None, chunk)
            for name in (k for k in SPLIT_COPIES if k in built):
                got = gradients(name)
                errs = over_scale(got, want)
                line = {"shape": dict(zip(("b", "s", "h", "p", "g", "n",
                                           "chunk"), shape, strict=True)),
                        "copy": name, "seed": seed,
                        "within": ref.ssd_bwd_within(got, want),
                        "err_over_scale_by_output": errs,
                        "within_split_limit": errs["ddt"]
                        <= chip_smoke.SSD_BWD_SPLIT_LIMIT}
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
        del states, gstates, want
        torch.cuda.empty_cache()
    out.close()
    print(ablation_kit.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
