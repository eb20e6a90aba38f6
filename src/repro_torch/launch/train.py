"""Training launcher: an LM trained on the card with checkpoint/restart.

    python -m repro_torch.launch.train --arch minitron-4b --smoke \
        --steps 100 --batch 16 --seq 256

Port of ``repro/launch/train.py`` on one device (``--mesh host`` with
``--model-parallel 1``).  The parameters are drawn from ``--seed`` on the
device, and each step's batch from a generator seeded by ``(seed, step,
host)`` (:func:`repro_torch.data.synthetic.step_generator`), so a run
resumed from its latest checkpoint in ``--ckpt-dir`` consumes exactly the
batches it missed.  A progress line every 10 steps, a checkpoint every
``--ckpt-every`` steps.  Everything runs on the CUDA card unless ``--device
cpu`` is given.  The production meshes (``--mesh single|multipod``) and
tensor parallelism (``--model-parallel`` > 1) raise
``NotImplementedError``: they wait for ROADMAP.md Queue 1 item 11.7
(``dist/sharding.py``, ``launch/{partition,mesh}.py``).  The batches hold
tokens alone, as the reference's do, so an encoder-decoder (whisper-large-v3)
or a VLM (pixtral-12b) config raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ckpt import checkpoint as ckpt
from ..configs.registry import full_config, smoke_config
from ..data.synthetic import step_generator, token_batch
from ..device import resolve_device
from ..models import steps as steps_mod
from ..optim.adamw import AdamWConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multipod"])
    ap.add_argument("--model-parallel", type=int, default=1, help="host mesh TP size")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/torch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' to opt out)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh != "host" or args.model_parallel != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh} --model-parallel {args.model_parallel}: the sharded launcher "
            "is not ported yet (ROADMAP.md Queue 1 item 11.7: dist/sharding.py, "
            "launch/{partition,mesh}.py); the port trains on one device (--mesh host "
            "--model-parallel 1)")
    cfg = smoke_config(args.arch) if args.smoke else full_config(args.arch)
    if cfg.is_encdec or cfg.n_img_tokens:
        need = "frames (B, S_enc, d_model)" if cfg.is_encdec else "img_embeds (B, N, d_model)"
        raise ValueError(f"--arch {args.arch}: the launcher's batches hold tokens alone, and "
                         f"{cfg.name}'s loss needs {need} too (steps.loss_fn)")
    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = steps_mod.init_train_state(gen, cfg, opt_cfg, device=device)
    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        start, state = ckpt.restore(args.ckpt_dir, latest, state)
        print(f"resumed from step {start}")
    train_step = steps_mod.make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    t0 = time.time()
    for step in range(start, args.steps):
        tokens = token_batch(step_generator(args.seed, step, 0), args.batch, args.seq,
                             cfg.vocab, device=device)
        state, metrics = train_step(state, {"tokens": tokens})
        if (step + 1) % 10 == 0:
            print(
                f"step {step+1:5d}  loss {float(metrics['loss']):.3f}  "
                f"acc {float(metrics['acc']):.3f}  "
                f"gnorm {float(metrics['grad_norm']):.2f}  "
                f"({(step+1-start)*args.batch*args.seq/(time.time()-t0):.0f} tok/s)",
                flush=True,
            )
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state)
    print("done")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
