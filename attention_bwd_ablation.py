#!/usr/bin/env python3
"""Time the backward of attention (``flash_attention_bwd``) against copies
of itself with one part taken out, against another checkout's, and
against SDPA's backward, on one NVIDIA GPU.

    python3 attention_bwd_ablation.py [--parent DIR] [--shapes A,B,...]
                                      [--only C,D,...]

Run from the root of a checkout.  Each ablation is a textual change to
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``; ``--shapes``
(default ``train_main``) picks the training shapes, each with its own
copies (`COPIES`; ``--only`` keeps those named), all built at once and
timed shape by shape.  At
``train_main`` and ``stablelm_train`` (the wgmma kernels), of the whole
backward: the dQ kernel not launched (``dkdv_only``: D and dK/dV alone),
the dK/dV kernel not launched (``dq_only``: D and dQ alone), the dK/dV
kernel's dV and dK products taken out (``no_dkdv_products``: its S^T and
dP^T products, the exp2s, the ring and the stores alone; wrong dK and
dV), the dQ kernel's dQ product taken out (``no_dq_products``), the
dK/dV kernel with one K/V buffer and three ring stages in place of two
and two (``dkdv_one_kv_buffer``: the next item's K and V wait for this
one's stores), and each kernel's two consumer warpgroups taking turns
at issuing their S and dP products, as the forward's do (``turns``).  Of
each kernel alone (the other not launched; wrong results): its
elementwise work taken out (``*_no_elementwise``: P = S, dS = dP times
P), its S and dP products (``*_no_ss``), its dV and dK or dQ products
(``*_no_rs``), or everything its consumers do but take the ring's tiles
(``*_ring_only``: the producer, the TMA copies and the barriers alone),
and D alone (``delta_only``).  At ``mla_train`` (the MLA kernels, V as
K's first 512 columns): the dQ kernel or the dK kernel not launched
(``mla_dkdv_only``, ``mla_dq_only``), and of each kernel alone (the
other not launched; wrong results) its S and dP products taken out
(``*_no_ss``), its dK or dQ products (``*_no_rs``), everything its
consumers do but take the ring's units (``*_ring_only``: the producer,
the TMA copies of the units and of each item's resident tile, the
barriers and the stores), and D alone (``mla_delta_only``).  ``--parent
DIR`` adds DIR's ``flash_attention_bwd.cu`` (e.g. a ``git archive`` of
the parent commit unpacked under ``build/``) as ``parent`` at every
shape.  Every copy is built with the port's ``nvcc`` flags into
``build/attention_bwd_ablation/`` and timed on the same inputs, in turns
(all copies, then all in reverse, then all again), beside the backward
of one ``scaled_dot_product_attention`` call (``sdpa``, the library
yardstick; never called by the port), at qwen3-0.6b's training shape
(``train_main``: B 8, S 2048, H 16, Hkv 8, D 128, causal, bf16),
stablelm-3b's (``stablelm_train``: 32 heads of 80, MHA) or
deepseek-v2-lite's (``mla_train``: 16 heads over one KV head, (576,
512)).  ``as_built``, ``turns`` and ``parent`` are held to
``ref.attention_bwd`` within ``ref.attention_bwd_tolerance``.  One JSON
line per copy and shape on standard output, also written to
``chiprun_out/attention_bwd_ablation.jsonl``, with the bound
(``chip_smoke.attention_bwd_bound``), the SM clock and power draw
sampled while timing (the card may sit at its power limit and clock
down under this load: compare copies within one call only), and each
copy's ptxas lines; then each shape's bf16 kernels' ring stages, shared
bytes and registers; the last line is the card's ``nvidia-smi`` name
and power limit.
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
SRC = (Path("src") / "repro_torch" / "kernels" / "csrc"
       / "flash_attention_bwd.cu")
OUT = ROOT / "chiprun_out" / "attention_bwd_ablation.jsonl"
# B, S, H, Hkv, Dk, Dv of each training shape (chip_smoke.BWD_SHAPES)
SHAPES = {"train_main": (8, 2048, 16, 8, 128, 128),
          "stablelm_train": (8, 2048, 32, 32, 80, 80),
          "mla_train": (8, 2048, 16, 1, 576, 512)}
DQ_LAUNCH = "  const long long q_items =\n"
DKDV_LAUNCH = "  fa_bwd_dkdv_wgmma<D><<<grid, 384, KL::BYTES, a.stream>>>("
DKDV_PRODUCTS = ("      rs_64xD<D>(dv, pf, sdo, L::Q_BOX);\n"
                 "      rs_64xD<D>(dk, sf, sq, L::Q_BOX);\n")
DQ_PRODUCT = "      rs_64xD<D>(dq, sf, sk, L::K_BOX);\n"
KV_BUFFERS = "STAGES = NB == 2 ? 2 : 4, KVBUF = 2;"
DKDV_OFF = [(DKDV_LAUNCH, "  if (false) " + DKDV_LAUNCH.lstrip())]
DQ_OFF = [(DQ_LAUNCH, "  return cudaGetLastError();\n" + DQ_LAUNCH)]
# the consumers' S and dP products, elementwise work and ring wait
DKDV_SS = ("      ss_64x64<D>(s, ka, L::KV_BOX, sq, L::Q_BOX);\n"
           "      wgmma_commit();\n"
           "      ss_64x64<D>(dp, va, L::KV_BOX, sdo, L::Q_BOX);\n"
           "      wgmma_commit();\n")
DQ_SS = ("      ss_64x64<D>(s, qa, L::Q_BOX, sk, L::K_BOX);\n"
         "      wgmma_commit();\n"
         "      ss_64x64<D>(dp, da, L::Q_BOX, sv, L::K_BOX);\n"
         "      wgmma_commit();\n")
NO_SS = "      wgmma_commit();\n      wgmma_commit();\n"
DKDV_P = ("        const float p = ex2(fmaf(s[e], sl, -rs[acc_col(e, tq)]));\n"
          "        s[e] = (vis >> e) & 1u ? p : 0.f;")
DKDV_DS = "        dp[e] = s[e] * (dp[e] - rs[BQ + acc_col(e, tq)]);"
DQ_P = ("        const float p = ex2(fmaf(s[e], sl, -((e & 2) ? ls1 : ls0)));\n"
        "        s[e] = (vis >> e) & 1u ? p : 0.f;")
DQ_DS = "        dp[e] = s[e] * (dp[e] - ((e & 2) ? dd1 : dd0));"
DKDV_STEP = "      const uint32_t sq = Q_STAGE(st), sdo = sq + L::QT_BYTES;"
DQ_STEP = "      const uint32_t sk = K_STAGE(st), sv = sk + L::KV_BYTES;"
RING_ONLY = "      if (tile.x >= 0) {\n        mbar_arrive(EMPTY(st));\n" \
            "        ++ring;\n        continue;\n      }\n"
# turns: named barriers 3 + w, as the forward's consumers take them; one
# pass before the first item, one wait after the last, so every turn is
# taken
WG_SYNC = ("__device__ __forceinline__ void wg_sync(int w) {\n"
           "  asm volatile(\"bar.sync %0, 128;\\n\" ::\"r\"(1 + w) : "
           "\"memory\");\n}\n")
TURN_FNS = WG_SYNC + (
    "__device__ __forceinline__ void turn_wait(int w) {\n"
    "  asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(3 + w) : \"memory\");\n"
    "}\n__device__ __forceinline__ void turn_pass(int to) {\n"
    "  asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(3 + to) : "
    "\"memory\");\n}\n")
CONSUMERS = "  int ring = 0;  // stages consumed\n  for (int n = 0;; ++n) {\n"
# the MLA kernels
MLA_DKDV_LAUNCH = "  fa_bwd_dkdv_mla<<<grid, 384, KL::BYTES, a.stream>>>("
MLA_DQ_LAUNCH = "  fa_bwd_dq_mla<<<grid, 384, QL::BYTES, a.stream>>>("
MLA_DKDV_OFF = [(MLA_DKDV_LAUNCH, "  if (false) " + MLA_DKDV_LAUNCH.lstrip())]
MLA_DQ_OFF = [(MLA_DQ_LAUNCH, "  if (false) " + MLA_DQ_LAUNCH.lstrip())]
MLA_DKDV_SS = [("          ss_64x32<L::NBK>(s, ka, L::K_BOX, sq, L::U_BOX);\n",
                ""),
               ("          ss_64x32<L::NBV>(s, ka, L::K_BOX, sdo, L::U_BOX);\n",
                "")]
MLA_DKDV_RS = [("          rs_mla<0>(dk, pf, sdo, L::U_BOX, false);\n", ""),
               ("          rs_mla<0>(dk, sf, sq, L::U_BOX, true);\n", ""),
               ("          rs_mla<1>(dk, pf, sdo, L::U_BOX, false);\n"
                "          rs_mla<1>(dk, sf, sq, L::U_BOX, true);\n", "")]
MLA_DQ_SS = [("          ss_64x32<L::NBK>(s, qa, L::Q_BOX, sk, L::K_BOX);\n",
              ""),
             ("          ss_64x32<L::NBV>(s, qa + L::Q_BYTES, L::Q_BOX, sk, "
              "L::K_BOX);\n", "")]
MLA_DQ_RS = [("        rs_mla<W>(dqa, sf, sk, L::K_BOX, true);\n", "")]
MLA_DKDV_STEP = ("        const uint32_t sq = U_STAGE(st), "
                 "sdo = sq + L::Q_BYTES;\n")
MLA_DQ_STEP = "        const uint32_t sk = K_STAGE(st);\n"
MLA_RING_ONLY = ("        if (tile.x >= 0) {\n          mbar_arrive(EMPTY(st));"
                 "\n          ++ring;\n          continue;\n        }\n")


def turns(ss, first, after):
    """The substitutions that make one kernel's consumers take turns."""
    return [(ss, "      turn_wait(w);\n" + ss
             + "      turn_pass(1 - w);\n"),
            (CONSUMERS + first, "  if (w == 1) turn_pass(0);\n" + CONSUMERS
             + first),
            ("  }\n" + after, "  }\n  if (w == 0) turn_wait(0);\n" + after)]


ABLATIONS = {
    "as_built": [],
    "dkdv_only": DQ_OFF,
    "dq_only": DKDV_OFF,
    "no_dkdv_products": [(DKDV_PRODUCTS, "")],
    "no_dq_products": [(DQ_PRODUCT, "")],
    "dkdv_one_kv_buffer": [(KV_BUFFERS,
                            "STAGES = D == 128 ? 3 : 4, KVBUF = 1;")],
    "turns": [(WG_SYNC, TURN_FNS)]
    + turns(DKDV_SS, "    const int kb = n % KB;\n", "#undef FULL_KV\n")
    + turns(DQ_SS, "    const int q = n % QB;\n", "#undef Q_BUF\n"),
    "dkdv_no_elementwise": DQ_OFF + [(DKDV_P, "        s[e] = s[e] * vis;"),
                                     (DKDV_DS, "        dp[e] = dp[e] * s[e];")],
    "dkdv_no_ss": DQ_OFF + [(DKDV_SS, NO_SS)],
    "dkdv_no_rs": DQ_OFF + [(DKDV_PRODUCTS, "")],
    "dkdv_ring_only": DQ_OFF + [(DKDV_STEP, RING_ONLY + DKDV_STEP)],
    "dq_no_elementwise": DKDV_OFF + [(DQ_P, "        s[e] = s[e] * vis;"),
                                     (DQ_DS, "        dp[e] = dp[e] * s[e];")],
    "dq_no_ss": DKDV_OFF + [(DQ_SS, NO_SS)],
    "dq_no_rs": DKDV_OFF + [(DQ_PRODUCT, "")],
    "dq_ring_only": DKDV_OFF + [(DQ_STEP, RING_ONLY + DQ_STEP)],
    "delta_only": DQ_OFF + DKDV_OFF,
    "mla_dkdv_only": MLA_DQ_OFF,
    "mla_dq_only": MLA_DKDV_OFF,
    "mla_dkdv_no_ss": MLA_DQ_OFF + MLA_DKDV_SS,
    "mla_dkdv_no_rs": MLA_DQ_OFF + MLA_DKDV_RS,
    "mla_dkdv_ring_only": MLA_DQ_OFF + [(MLA_DKDV_STEP,
                                         MLA_RING_ONLY + MLA_DKDV_STEP)],
    "mla_dq_no_ss": MLA_DKDV_OFF + MLA_DQ_SS,
    "mla_dq_no_rs": MLA_DKDV_OFF + MLA_DQ_RS,
    "mla_dq_ring_only": MLA_DKDV_OFF + [(MLA_DQ_STEP,
                                         MLA_RING_ONLY + MLA_DQ_STEP)],
    "mla_delta_only": MLA_DQ_OFF + MLA_DKDV_OFF,
}
# the copies timed at each shape (and "parent" with --parent)
WGMMA_COPIES = [n for n in ABLATIONS if not n.startswith("mla_")]
COPIES = {"train_main": WGMMA_COPIES,
          "stablelm_train": ["as_built", "dkdv_only", "dq_only",
                             "no_dkdv_products", "no_dq_products",
                             "dkdv_ring_only", "dq_ring_only",
                             "delta_only"],
          "mla_train": ["as_built"] + [n for n in ABLATIONS
                                       if n.startswith("mla_")]}
# the copies held to the plain version (the others are wrong by design)
EXACT = ("as_built", "turns", "parent")
# the entry functions whose ptxas lines each line gives, by shape (the
# parent's kernels at (80, 80) and (576, 512) were the mma.sync ones)
ENTRIES = {"train_main": ("fa_bwd_dkdv_wgmmaILi128", "fa_bwd_dq_wgmmaILi128",
                          "fa_bwd_dkdv_bf16ILi128", "fa_bwd_dq_bf16ILi128"),
           "stablelm_train": ("fa_bwd_dkdv_wgmmaILi80", "fa_bwd_dq_wgmmaILi80",
                              "fa_bwd_dkdv_mmaILi80ELi80",
                              "fa_bwd_dq_mmaILi80ELi80"),
           "mla_train": ("fa_bwd_dkdv_mla", "fa_bwd_dq_mla",
                         "fa_bwd_dkdv_mmaILi576", "fa_bwd_dq_mmaILi576")}


def time_shape(shape, libs, chip_smoke, fa, ref):
    """The JSON lines of one training shape: each of its copies (and
    ``sdpa``) timed in turns, then its bf16 kernels' stages, shared bytes
    and registers."""
    import torch
    dev = torch.device("cuda")
    B, S, H, Hkv, Dk, Dv = SHAPES[shape]
    scale = 1.0 / math.sqrt(Dk)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16) for s in ((B, S, H, Dk), (B, S, Hkv, Dk),
                                  (B, S, Hkv, Dv), (B, S, H, Dv)))
    fold = Dv < Dk    # MLA: V is K's first Dv columns, dK takes dV
    if fold:
        v = k[..., :Dv]
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = pos.contiguous()
    kw = dict(scale=scale, q_pos=pos, kv_pos=pos, causal=True, window=None)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    grads = [torch.empty_like(t) for t in ((q, k) if fold else (q, k, v))]
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n in COPIES[shape] or n == "parent"]

    def call(name):
        err = libs[name][0].fa_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), pos.data_ptr(), pos.data_ptr(),
            grads[0].data_ptr(), grads[1].data_ptr(),
            None if fold else grads[2].data_ptr(), delta.data_ptr(), B, S,
            S, H, Hkv, Dk, Dv, 1, scale, 1, -1, stream)
        if err:
            raise RuntimeError(f"fa_backward ({name}, {shape}): cudaError "
                               f"{err}")

    library, backend = chip_smoke.sdpa_bwd_call(q, k, v, dout, True, scale)
    rates = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    bound, by, triples = chip_smoke.attention_bwd_bound(
        q, k, v, pos, pos, True, None, rates)
    want = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    calls = {name: (lambda n=name: call(n)) for name in names}
    if library is not None:
        calls["sdpa"] = library
    clocks = ablation_kit.ClockSampler()
    clocks.start()
    ms = ablation_kit.in_turns(calls, reps=20)
    card = clocks.stop()
    lines = []
    for name in calls:
        rec = {"shape": dict(zip(("B", "S", "H", "Hkv", "Dk", "Dv"),
                                 SHAPES[shape], strict=True)),
               "case": shape, "causal": True, "copy": name,
               "ms": ms[name], "bound_ms": bound, "bound_by": by,
               "visible_triples": triples,
               "share_of_bound": [bound / t for t in ms[name]],
               "card": card}
        if name == "sdpa":
            rec["backend"] = backend
        else:
            rec["ptxas"] = ablation_kit.entry_ptxas(libs[name][1],
                                                    ENTRIES[shape])
        if name in EXACT:
            call(name)
            torch.cuda.synchronize()
            rec["max_abs_err"] = max(
                (g.float() - w.float()).abs().max().item()
                for g, w in zip(grads, want, strict=False))
            rec["within_tolerance"] = all(
                chip_smoke.bwd_within(g, w, q.dtype)
                for g, w in zip(grads, want, strict=False))
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"case": shape,
                             "bwd_kernel_info": fa.bwd_kernel_info(Dk, Dv)}))
    print(lines[-1], flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--shapes", default="train_main",
                    help=f"comma-separated, of {sorted(SHAPES)}")
    ap.add_argument("--only", default="",
                    help="comma-separated copies to build and time (and "
                         "parent with --parent); default: every copy of "
                         "the shapes")
    args = ap.parse_args()
    shapes = args.shapes.split(",")
    if not set(shapes) <= set(SHAPES):
        ap.error(f"--shapes takes {sorted(SHAPES)}")
    keep = set(args.only.split(",")) - {""}
    if not keep <= set(ABLATIONS) | {"parent"}:
        ap.error(f"--only takes copies of {sorted(ABLATIONS)}")
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    only = {n for s in shapes for n in COPIES[s] if not keep or n in keep}
    if not only:
        ap.error("--only names no copy of these shapes")
    built = ablation_kit.build(
        "attention_bwd_ablation",
        ablation_kit.sources(SRC, ABLATIONS, parent=args.parent, only=only,
                             once=True))
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (lib, log) in built.items():
        lib.fa_backward.argtypes = [vp] * 12 + [i] * 8 + [ctypes.c_float, i,
                                                          i, vp]
        lib.fa_backward.restype = i
        libs[name] = (lib, log)
    lines = []
    for shape in shapes:
        lines += time_shape(shape, libs, chip_smoke, fa, ref)
    smi = ablation_kit.smi()
    lines.append(smi)
    print(smi)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
