#!/usr/bin/env python3
"""Time the MLA attention kernel (``fa_mla_wgmma_kernel``) against copies
of itself with one part taken out, and against another checkout's, on one
NVIDIA GPU.

    python3 mla_ablation.py [--parent DIR]

Run from the root of a checkout.  Each ablation is a textual change to
``src/repro_torch/kernels/csrc/flash_attention.cu``: the producer's TMA
copies of the K tiles taken out (``no_kv_loads``: the ring still turns,
Q still loads; wrong results, the time without the K stream), the S =
Q K^T products taken out (``no_qk``: S = 0), the O += P V products taken
out (``no_pv``), both (``no_products``: the K stream, the mask, the
softmax and the barriers alone), and the named barrier a tile at which
the second consumer waits for the first's P (``no_exchange``: wrong
results).  ``--parent DIR`` adds DIR's ``flash_attention.cu`` (e.g. a
``git archive`` of the parent commit unpacked under ``build/``) as
``parent``; its kernel is called with V as a separate contiguous copy of
K's first 512 columns, the copies of this one with V as that view of K
(the same values).  Every copy is built with the port's ``nvcc`` flags
into ``build/mla_ablation/`` (``ablation_kit``) and timed on the same
inputs, in turns (all copies, then all in reverse, then all again), at
deepseek-v2-lite's
prefill shape (B 8, S 2048, H 16, Hkv 1, Dk 576, Dv 512, bf16), causal
and non-causal.  Each line also gives the bytes of K tiles and Q the
kernel copies from L2 or memory (64-key tiles some pair of a 64-row item
sees, ``ref.attention_tile_classes``) and that stream's rate at the
copy's time.  One JSON line per (shape, copy) on standard output, also
written to ``chiprun_out/mla_ablation.jsonl``; the last line is the
card's ``nvidia-smi`` name and power limit.  While the copies are timed,
``nvidia-smi`` samples the SM clock and the power draw every 0.2 s; each
line gives the range seen during that shape's timing (the card may sit
at its power limit and clock down under this load).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import ablation_kit

ROOT = Path(__file__).resolve().parent
SRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "chiprun_out" / "mla_ablation.jsonl"
SHAPE = (8, 2048, 16, 1, 576, 512)    # B, S, H, Hkv, Dk, Dv
ROWS, TILE = 64, 64                   # the kernel's item rows and K tile
LOAD = "const bool load_k = t < n_kb;  // the tile's TMA copies"
QK = "        mla_qk(s, base, kst);\n"
PV = "      mla_pv<NB>(o, pbox, kst + B0 * BOX);\n"
P_READY = "mla_bar_arrive(MLA_BAR_P + st);"
P_WAIT = "mla_bar_sync(MLA_BAR_P + st);"
NO_S = "        for (int e = 0; e < 32; ++e) s[e] = 0.f;\n"

ABLATIONS = {
    "as_built": [],
    "no_kv_loads": [(LOAD, "const bool load_k = false;")],
    "no_qk": [(QK, NO_S)],
    "no_pv": [(PV, "")],
    "no_products": [(QK, NO_S), (PV, "")],
    "no_exchange": [(P_READY, ""), (P_WAIT, "")],
}
# the kernel's entry function in this source and in the parent's
ENTRIES = ("fa_mla_wgmma_kernel", "fa_mla_kernel")


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
    built = ablation_kit.build("mla_ablation", ablation_kit.sources(
        SRC, ABLATIONS, parent=args.parent))
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs, ptxas = {}, {}
    for name, (lib, log) in built.items():
        lib.fa_forward.argtypes = [vp] * 6 + [i] * 8 + [ctypes.c_float, i, i,
                                                        vp]
        lib.fa_forward.restype = i
        libs[name] = lib
        # the first instance of the kernel (four lines)
        ptxas[name] = ablation_kit.entry_ptxas(log, ENTRIES)[:4]
    dev = torch.device("cuda")
    B, S, H, Hkv, Dk, Dv = SHAPE
    scale = 1.0 / math.sqrt(192)          # MLA's 128 + 64 query dims
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
            for s in ((B, S, H, Dk), (B, S, Hkv, Dk)))
    v = k[..., :Dv]                       # MLA's values: K's latent columns
    v_sep = v.contiguous()                # the parent's separate V
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = pos.contiguous()
    out = torch.empty((B, S, H, Dv), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for causal in (True, False):
        def call(name, causal=causal):
            vp = v_sep.data_ptr() if name == "parent" else k.data_ptr()
            err = libs[name].fa_forward(
                q.data_ptr(), k.data_ptr(), vp, pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), B, S, S, H, Hkv, Dk, Dv, 1,
                scale, int(causal), -1, stream)
            if err:
                raise RuntimeError(f"fa_forward ({name}): cudaError {err}")
        want = ref.attention(q, k, v, scale=scale, q_pos=pos, kv_pos=pos,
                             causal=causal)
        # the K tiles and Q the kernel copies: (batch, item) pairs' visible
        # 64-key tiles of 576 bf16 columns, and each item's 64 rows of Q
        cls = ref.attention_tile_classes(pos, pos, causal, None,
                                         ROWS // (H // Hkv), TILE)
        stream_bytes = (int((cls != ref.TILE_SKIP).sum()) * Hkv * TILE
                        + B * S * H) * Dk * 2
        clocks = ablation_kit.ClockSampler()
        clocks.start()
        ms = ablation_kit.in_turns({name: (lambda n=name: call(n))
                                    for name in libs})
        card = clocks.stop()
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lines.append(json.dumps({
                "shape": dict(zip(("B", "S", "H", "Hkv", "Dk", "Dv"), SHAPE,
                                  strict=True)),
                "causal": causal, "copy": name, "ms": ms[name],
                "max_abs_err": err, "stream_gb": stream_bytes / 1e9,
                "stream_tb_s": [stream_bytes / (t * 1e-3) / 1e12
                                for t in ms[name]], "card": card,
                "ptxas": ptxas[name]}))
            print(lines[-1], flush=True)
    smi = ablation_kit.smi()
    lines.append(smi)
    print(smi)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
