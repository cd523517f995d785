"""Serving launcher: batched prefill + greedy decode on synthetic prompts.

``python -m repro_torch.launch.serve --arch mamba2-130m --batch 4 --new 32``
``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full``
``python -m repro_torch.launch.serve --arch whisper-medium --full
--prompt-len 416``

The JAX package's ``launch/serve.py`` on one card: random weights from
``--seed``, prompts from ``data.synthetic.token_batch`` and the audio and
vlm families' modality stub from ``data.synthetic.modality_stub``.  It
runs on ``cuda`` unless ``--device cpu`` is given; without a GPU the
default raises.  `run` times the prefill and the decode loop apart (host
clock around work that ends in a device synchronize).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..data.synthetic import TokenGenConfig, modality_stub, token_batch
from ..device import resolve_device
from ..models.registry import Model, build_model
from ..serve import decode


def make_model(arch: str, full: bool, seed: int, device=None) -> Model:
    cfg = get_config(arch) if full else get_smoke_config(arch)
    return build_model(cfg, seed=seed, device=device)


def make_prompts(model: Model, batch: int, prompt_len: int, seed: int):
    """The prompt tokens ``[batch, prompt_len]`` (the audio and vlm
    families also take ``data.synthetic.modality_stub``)."""
    return token_batch(TokenGenConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=prompt_len, batch=batch,
                                      seed=seed), 0, device=model.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(model: Model, prompts, new: int, extra_inputs: dict | None = None
        ) -> dict:
    """`decode.generate_scan` split in its prefill and its decode loop,
    each timed: ``{"tokens" [B, new] int32, "logits" [B, 1, V] of the
    prefill, "prefill_s", "decode_s"}``.  ``extra_inputs`` is the audio
    and vlm families' modality stub (``modality_stub``)."""
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = decode.prefill(model, prompts, prompts.shape[1] + new,
                                   extra_inputs)
    tok = decode.greedy_sample(logits)
    _sync(dev)
    t1 = time.perf_counter()
    rest = decode.decode_loop(model, tok, cache, new - 1)
    _sync(dev)
    t2 = time.perf_counter()
    tokens = torch.cat([tok[:, None], rest], dim=1).to(torch.int32)
    return {"tokens": tokens, "logits": logits, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = make_model(args.arch, args.full, args.seed, dev)
    print(f"serving {model.cfg.name} ({model.n_params/1e6:.1f}M params) on "
          f"{dev}, batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new}")
    prompts = make_prompts(model, args.batch, args.prompt_len, args.seed)
    extra = modality_stub(model.cfg, args.batch, device=model.device)
    for name, t in extra.items():
        print(f"{name} stub {tuple(t.shape)} {t.dtype}")
    res = run(model, prompts, args.new, extra)
    B = args.batch
    # one cold run: the prefill includes building the kernels (on the
    # card) and PyTorch's warm-up, as the JAX launcher's time includes
    # compiling
    print(f"prefill {res['prefill_s']*1e3:.1f} ms "
          f"({B * args.prompt_len / res['prefill_s']:.1f} tok/s, incl. "
          f"build and warm-up), decode "
          f"{res['decode_s']*1e3 / max(1, args.new - 1):.2f} ms/step "
          f"({B * (args.new - 1) / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("sample:", res["tokens"][0, :16].tolist())
    return res["tokens"]


if __name__ == "__main__":
    main()
