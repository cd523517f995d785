#!/usr/bin/env python3
"""Time the MLA attention kernel (``fa_mla_kernel``) against copies of
itself with one part taken out, and against another checkout's, on one
NVIDIA GPU.

    python3 mla_ablation.py [--parent DIR]

Run from the root of a checkout.  Each ablation is a textual change to
``src/repro_torch/kernels/csrc/flash_attention.cu``: the K/V tile loads
taken out (``no_kv_loads``: wrong results, the time without moving K and
V), the S = Q K^T products taken out (``no_qk``), the O += P V products
taken out (``no_pv``), and both (``no_products``: the loads, the mask,
the softmax and the barriers alone).  ``--parent DIR`` adds DIR's
``flash_attention.cu`` (e.g. a ``git archive`` of the parent commit
unpacked under ``build/``) as ``parent``.  Every copy is built with the
port's ``nvcc`` flags into ``build/mla_ablation/`` and timed on the same
inputs, in turns (all copies, then all in reverse, then all again), at
deepseek-v2-lite's prefill shape (B 8, S 2048, H 16, Hkv 1, Dk 576,
Dv 512, bf16), causal and non-causal.  One JSON line per (shape, copy)
on standard output, also written to ``chiprun_out/mla_ablation.jsonl``;
the last line is the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "chiprun_out" / "mla_ablation.jsonl"
SHAPE = (8, 2048, 16, 1, 576, 512)    # B, S, H, Hkv, Dk, Dv
QK = """      mma_bf16(s[0], a, bb[0], bb[1]);
      mma_bf16(s[1], a, bb[2], bb[3]);
      mma_bf16(s2[0], a2, bb2[0], bb2[1]);
      mma_bf16(s2[1], a2, bb2[2], bb2[3]);"""
PV = """        mma_bf16(o[2 * np], pa[kk], bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], pa[kk], bb[2], bb[3]);"""
LOAD = "  auto load_kv = [&](int t, int buf) {"

ABLATIONS = {
    "as_built": [],
    "no_kv_loads": [(LOAD, LOAD + "\n    if (t >= 0) return;")],
    "no_qk": [(QK, "")],
    "no_pv": [(PV, "")],
    "no_products": [(QK, ""), (PV, "")],
}


def build_all(parent: Path | None):
    """Every copy built at once; name -> loaded library."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    src = SRC.read_text()
    out_dir = ROOT / "build" / "mla_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, subs in ABLATIONS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        texts[name] = text
    if parent is not None:
        texts["parent"] = (parent / "src" / "repro_torch" / "kernels" / "csrc"
                           / "flash_attention.cu").read_text()
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        at = [n for n, ln in enumerate(lines) if "fa_mla_kernel" in ln]
        ptxas[name] = [ln.strip() for ln in lines[at[0]:at[0] + 3]] if at \
            else []
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.fa_forward.argtypes = [vp] * 6 + [i] * 8 + [ctypes.c_float, i, i,
                                                        vp]
        lib.fa_forward.restype = i
        libs[name] = lib
    return libs, ptxas


def time_ms(torch, fn, reps=10, warmup=2) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mla_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    libs, ptxas = build_all(args.parent)
    dev = torch.device("cuda")
    B, S, H, Hkv, Dk, Dv = SHAPE
    scale = 1.0 / math.sqrt(192)          # MLA's 128 + 64 query dims
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((B, S, H, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv)))
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = pos.contiguous()
    out = torch.empty((B, S, H, Dv), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for causal in (True, False):
        def call(lib, causal=causal):
            err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 pos.data_ptr(), pos.data_ptr(),
                                 out.data_ptr(), B, S, S, H, Hkv, Dk, Dv, 1,
                                 scale, int(causal), -1, stream)
            if err:
                raise RuntimeError(f"fa_forward: cudaError {err}")
        want = ref.attention(q, k, v, scale=scale, q_pos=pos, kv_pos=pos,
                             causal=causal)
        ms = {name: [] for name in libs}
        for turn in range(3):
            names = list(libs) if turn % 2 == 0 else list(libs)[::-1]
            for name in names:
                ms[name].append(time_ms(torch, lambda n=name: call(libs[n])))
        for name, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lines.append(json.dumps({
                "shape": dict(zip(("B", "S", "H", "Hkv", "Dk", "Dv"), SHAPE,
                                  strict=True)),
                "causal": causal, "copy": name, "ms": ms[name],
                "max_abs_err": err, "ptxas": ptxas[name]}))
            print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines.append(smi)
    print(smi)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
