"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The JAX package's ``launch/train.py``, flag for flag, on one card: the
smoke config of the arch by default, ``--full`` its published widths;
``adamw(cosine_schedule(lr, steps // 10, steps))``; the paper's
technique as ``--consistency bsp|ssp|essp`` with ``--staleness`` and
``--buckets`` (`psdist.grad_sync.GradSync`); batches from
``data.synthetic.token_batches`` (and the family's modality stub);
weights drawn from ``--seed``; ``--layers N`` cuts the config's depth to
N layers, every width kept (a config whose training state does not fit
one card).  It runs on ``cuda`` unless ``--device cpu`` is given; without
a GPU the default raises.  On the card the dense and moe families train
through ``flash_attention`` and its backward (deepseek's MLA at its
published (576, 512) latent heads and its smoke config's (80, 64), V as
K's prefix), the ssm family (mamba2-130m, full or smoke) and the hybrid
one (Jamba's smoke config: its published widths do not fit one card)
through ``ssd`` and ``ssd_bwd``.  Only a float32 gradient through
attention at (576, 512) raises ``NotImplementedError`` (ROADMAP 16.4f).

    python -m repro_torch.launch.train --arch qwen3-0.6b --full \\
        --batch 8 --seq 2048 --steps 6
    python -m repro_torch.launch.train --arch mamba2-130m --full \\
        --batch 8 --seq 2048 --steps 6
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \\
        --full --layers 4 --batch 8 --seq 2048 --steps 6
"""
from __future__ import annotations

import argparse
import json
import os

from ..checkpoint.io import save
from ..configs import get_config, get_smoke_config
from ..data.synthetic import TokenGenConfig, modality_stub, token_batches
from ..device import resolve_device
from ..models.registry import build_model
from ..optim.optimizers import adamw, cosine_schedule
from ..psdist.grad_sync import GradSync
from ..train.loop import train
from ..train.state import init_state, make_accum_train_step, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (published widths)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--consistency", default="bsp",
                    choices=["bsp", "ssp", "essp"])
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--buckets", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers, every width "
                         "kept")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers}")
        cfg = cfg.replace(n_layers=args.layers)
    model = build_model(cfg, seed=args.seed, device=dev)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model.n_params/1e6:.1f}M "
          f"consistency={args.consistency}(s={args.staleness})")

    opt = adamw(cosine_schedule(args.lr, args.steps // 10, args.steps))
    sync = GradSync(args.consistency, args.staleness, args.buckets)
    state = init_state(model, opt, sync)

    if args.accum > 1:
        step = make_accum_train_step(model, opt, sync, accum=args.accum)
    else:
        step = make_train_step(model, opt, sync)

    dcfg = TokenGenConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          batch=args.batch * args.accum, seed=args.seed)
    extra = modality_stub(cfg, args.batch * args.accum, device=dev)

    def reshape(b):
        if args.accum > 1:
            return {k: v.reshape(args.accum, -1, *v.shape[1:])
                    for k, v in b.items()}
        return b

    batches = (reshape(b) for b in token_batches(dcfg, args.steps,
                                                 extra=extra, device=dev))

    ckpt_fn = None
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)

        def ckpt_fn(state, step_no):
            save(os.path.join(args.checkpoint_dir, f"step{step_no}.npz"),
                 state.params)

    state, history = train(step, state, batches, args.steps,
                           log_every=args.log_every,
                           checkpoint_fn=ckpt_fn, checkpoint_every=50)
    if args.checkpoint_dir:
        save(os.path.join(args.checkpoint_dir, "final.npz"), state.params)
        with open(os.path.join(args.checkpoint_dir, "history.json"),
                  "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
