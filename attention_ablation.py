#!/usr/bin/env python3
"""Time the wgmma attention kernel against copies of itself with one part
taken out, on one NVIDIA GPU.

    python3 attention_ablation.py

Run from the root of a checkout.  Each ablation is a textual change to
``src/repro_torch/kernels/csrc/flash_attention.cu``: the two consumer
warpgroups' turns at the tensor cores removed (``no_pingpong``), the K/V
TMA loads replaced by bare barrier arrivals (``no_kv_loads``: wrong
results, the time without device-memory traffic for K and V), the
softmax replaced by a rescale of 1 (``no_softmax``: wrong results, the
time of the products and the loads alone), three K/V stages with one
Q buffer in place of two and two (``three_stages``), and one CTA per
work item in place of one per SM (``cta_per_item``: the grid is not
persistent).  Every copy is built with the port's ``nvcc`` flags into
``build/attention_ablation/`` and timed on the same inputs, in turns
(all copies, then all in reverse, then all again), at qwen3-0.6b's
prefill shape causal and non-causal.  One
JSON line per (shape, copy) on standard output; the last line is the
card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

import ablation_kit

ROOT = Path(__file__).resolve().parent
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
SHAPE = (8, 2048, 16, 8, 128)      # B, S, H, Hkv, D: qwen3-0.6b's prefill

ABLATIONS = {
    "as_built": [],
    "no_pingpong": [
        ('asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + w) : "memory");', ""),
        ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(3 + to) : "memory");',
         "")],
    "no_kv_loads": [
        ("""            mbar_expect_tx(FULL_K(s), L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              tma_load_4d(sk + c * L::BOX, &tm_k, FULL_K(s), c * 64, hk,
                          t * BK, b);""", "            mbar_arrive(FULL_K(s));"),
        ("""            mbar_expect_tx(FULL_V(s), L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              tma_load_4d(sv + c * L::BOX, &tm_v, FULL_V(s), c * 64, hk,
                          t * BK, b);""", "            mbar_arrive(FULL_V(s));")],
    "no_softmax": [("softmax_tile(s, part, vis, sl, m, l, corr);",
                    "corr[0] = corr[1] = 1.f;")],
    "three_stages": [("STAGES = D == 128 ? 2 : 4, QBUF = 2;",
                      "STAGES = D == 128 ? 3 : 4, QBUF = D == 128 ? 1 : 2;")],
    "cta_per_item": [("items < sms ? items : sms", "items")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    libs = {name: lib for name, (lib, _) in ablation_kit.build(
        "attention_ablation", ablation_kit.sources(SRC, ABLATIONS)).items()}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.fa_forward.argtypes = [vp] * 6 + [i] * 8 + [ctypes.c_float, i, i,
                                                        vp]
        lib.fa_forward.restype = i
    dev = torch.device("cuda")
    B, S, H, Hkv, D = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = pos.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for causal in (True, False):
        def call(lib, causal=causal):
            err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 pos.data_ptr(), pos.data_ptr(),
                                 out.data_ptr(), B, S, S, H, Hkv, D, D, 1,
                                 1.0 / math.sqrt(D), int(causal), -1, stream)
            if err:
                raise RuntimeError(f"fa_forward: cudaError {err}")
        want = ref.attention(q, k, v, scale=1.0 / math.sqrt(D), q_pos=pos,
                             kv_pos=pos, causal=causal)
        ms = ablation_kit.in_turns(
            {name: (lambda lib=lib: call(lib)) for name, lib in libs.items()},
            reps=20, warmup=3)
        for name, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            print(json.dumps({
                "shape": dict(zip(("B", "S", "H", "Hkv", "D"), SHAPE,
                                  strict=True)),
                "causal": causal, "ablation": name, "ms": ms[name],
                "max_abs_err": err}), flush=True)
    print(ablation_kit.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
