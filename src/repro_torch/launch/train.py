"""Training launcher: an LM trained on the card with checkpoint/restart.

    python -m repro_torch.launch.train --arch minitron-4b --smoke \
        --steps 100 --batch 16 --seq 256

Port of ``repro/launch/train.py``.  ``--mesh host --model-parallel M``
trains over a (world // M, M) ("data", "model") mesh of the ranks in the
process group (:func:`repro_torch.launch.mesh.make_host_mesh`): one rank
when the process was started alone, every rank when it runs in each rank
of ``torchrun`` (NCCL, one card a rank) or of ``spawn_fake_devices``
(gloo).  Each rank holds its blocks of the parameters and moments by the
reference's partition specs (:mod:`repro_torch.launch.partition`) and the
rules of :func:`repro_torch.dist.sharding.rules_for_arch`, and trains on
its data rows of the global batch.  ``--mesh single|multipod`` asks for
the production meshes, (16, 16) and (2, 16, 16), and raises ``ValueError``
on a world without their 256 or 512 ranks.  Every family the CLI trains
shards: the dense and MoE stacks, MLA (deepseek-v3), the Mamba-2 hybrid
(zamba2) and xLSTM.

The parameters are drawn from ``--seed`` on the device, and each step's
global batch from a generator seeded by ``(seed, step, host)``
(:func:`repro_torch.data.synthetic.step_generator`), so a run resumed
from its latest checkpoint in ``--ckpt-dir`` consumes exactly the batches
it missed, on any mesh: the checkpoint holds the global state (rank 0
writes it), and a resume cuts each rank's blocks from it.  A progress
line every 10 steps (rank 0), a checkpoint every ``--ckpt-every`` steps.
Everything runs on the CUDA card unless ``--device cpu`` is given.  The
batches hold tokens alone, as the reference's do, so an encoder-decoder
(whisper-large-v3) or a VLM (pixtral-12b) config raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed

from ..ckpt import checkpoint as ckpt
from ..configs.registry import full_config, smoke_config
from ..data.synthetic import step_generator, token_batch
from ..device import resolve_device
from ..dist.compat import world_size
from ..dist.sharding import activate_rules, rules_for_arch
from ..models import steps as steps_mod
from ..optim.adamw import AdamWConfig
from . import partition
from .mesh import make_host_mesh, make_production_mesh


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


def _mesh(args):
    """The run's mesh, or ``None`` for a process alone on a one-rank mesh
    (no process group is joined then: the step is the unsharded one)."""
    if args.mesh == "host":
        if world_size() == 1 and args.model_parallel == 1:
            return None
        return make_host_mesh(args.model_parallel, device=args.device)
    return make_production_mesh(multi_pod=args.mesh == "multipod", device=args.device)


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else full_config(args.arch)
    if cfg.is_encdec or cfg.n_img_tokens:
        need = "frames (B, S_enc, d_model)" if cfg.is_encdec else "img_embeds (B, N, d_model)"
        raise ValueError(f"--arch {args.arch}: the launcher's batches hold tokens alone, and "
                         f"{cfg.name}'s loss needs {need} too (steps.loss_fn)")
    mesh = _mesh(args)
    # raises without CUDA unless --device cpu; a rank's device is its mesh's
    device = resolve_device(args.device) if mesh is None else mesh.device
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if mesh is None:
        state = steps_mod.init_train_state(gen, cfg, opt_cfg, device=device)
        return _train(args, cfg, opt_cfg, state, device)
    rules = rules_for_arch(cfg, mesh)
    with activate_rules(rules, mesh):
        state = partition.init_sharded_train_state(gen, cfg, opt_cfg, mesh, rules,
                                                   device=device)
        layout = partition.ShardedLayout(mesh,
                                         partition.train_state_shardings(mesh, state, rules))
        return _train(args, cfg, opt_cfg, state, device, mesh, rules, layout)


def _train(args, cfg, opt_cfg, state, device, mesh=None, rules=None, layout=None):
    """Resume from ``--ckpt-dir``'s latest checkpoint, then train to
    ``--steps``; on a mesh ``state`` holds this rank's blocks (``layout``,
    the checkpoints' ``plan``) and rank 0 alone prints."""
    lead = mesh is None or torch.distributed.get_rank() == 0
    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        start, state = ckpt.restore(args.ckpt_dir, latest, state, plan=layout)
        if lead:
            where = "" if mesh is None else \
                f" (re-sharded onto {'x'.join(map(str, mesh.axis_sizes))})"
            print(f"resumed from step {start}{where}")
    train_step = steps_mod.make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {"tokens": token_batch(step_generator(args.seed, step, 0), args.batch,
                                       args.seq, cfg.vocab, device=device)}
        if mesh is not None:
            batch = partition.data_rows(batch, mesh, rules, args.microbatches)
        state, metrics = train_step(state, batch)
        if lead and (step + 1) % 10 == 0:
            print(
                f"step {step+1:5d}  loss {float(metrics['loss']):.3f}  "
                f"acc {float(metrics['acc']):.3f}  "
                f"gnorm {float(metrics['grad_norm']):.2f}  "
                f"({(step+1-start)*args.batch*args.seq/(time.time()-t0):.0f} tok/s)",
                flush=True,
            )
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state, plan=layout)
    if lead:
        print("done")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
