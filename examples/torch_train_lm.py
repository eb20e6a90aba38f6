"""End-to-end training on the port: train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py --arch codeqwen1.5-7b --steps 200 \
        [--device cpu]

Mirrors ``examples/train_lm.py`` with ``repro_torch``: --arch picks a
ported architecture's *smoke-scaled* config widened to ~100M parameters,
the synthetic token pipeline (deterministic per (seed, step), so a restart
never replays data), AdamW with warmup-cosine, atomic checkpoints every
--ckpt-every steps, and automatic resume from the latest checkpoint.  The
loss is expected to drop well below the uniform baseline ln(vocab) within a
few hundred steps.  Runs on the CUDA card unless ``--device cpu`` is given;
on the card every layer's attention forward is the flash kernel, its
gradient the plain function's.
"""

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import smoke_config
from repro_torch.data.synthetic import step_generator, token_batch
from repro_torch.device import resolve_device
from repro_torch.models import steps as steps_mod
from repro_torch.models.config import count_params
from repro_torch.optim.adamw import AdamWConfig


def widen(cfg, d_model=512, n_layers=8, vocab=8192):
    """Scale a smoke config up to ~100M params for a real training demo."""
    heads = max(4, d_model // 128)
    return dataclasses.replace(
        cfg,
        d_model=d_model,
        n_layers=n_layers,
        n_heads=heads,
        n_kv_heads=heads if cfg.n_kv_heads == cfg.n_heads else max(1, heads // 4),
        d_ff=(0 if cfg.d_ff == 0 else d_model * 4),
        vocab=vocab,
        head_dim=0,
        loss_chunk=128,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="artifacts/torch_train_lm_ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = widen(smoke_config(args.arch))
    print(f"arch={cfg.name}  params~{count_params(cfg)['total']/1e6:.0f}M "
          f"vocab={cfg.vocab}  ln(V)={math.log(cfg.vocab):.2f}  device={device}")

    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=20, total_steps=args.steps)
    train_step = steps_mod.make_train_step(cfg, opt_cfg)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = steps_mod.init_train_state(gen, cfg, opt_cfg, device=device)
    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        start, state = ckpt.restore(args.ckpt_dir, latest, state)
        print(f"resumed from checkpoint step {start}")

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        tokens = token_batch(step_generator(args.seed, step, 0), args.batch, args.seq,
                             cfg.vocab, device=device)
        state, metrics = train_step(state, {"tokens": tokens})
        if (step + 1) % 20 == 0:
            toks = args.batch * args.seq * (step + 1 - start)
            losses.append(float(metrics["loss"]))
            print(f"step {step+1:4d}  loss {losses[-1]:.3f}  "
                  f"acc {float(metrics['acc']):.3f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"tok/s {toks/(time.time()-t0):.0f}")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state)
    print("done")
    return dict(state=state, start=start, losses=losses)


if __name__ == "__main__":
    main()
