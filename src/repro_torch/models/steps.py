"""Train, eval, prefill and decode step builders, and greedy generation.

Port of ``repro/models/steps.py``.  ``make_train_step`` closes over the
model and optimizer configs and returns ``(state, batch) -> (state,
metrics)``: the loss (:func:`loss_fn`: ``lm.forward``, which casts the
float32 parameters to the compute dtype on every call, then the chunked
cross-entropy plus ``1e-2 * aux``), its gradient by autograd, and one AdamW
step (:mod:`repro_torch.optim.adamw`) that updates the state's tensors in
place.  ``microbatches > 1`` splits the batch along dim 0 and accumulates
float32 gradients divided by the count, as the reference's scan does.

Under active sharding rules over a mesh of more than one rank
(:mod:`repro_torch.dist.sharding`, the launcher's ``--model-parallel``)
the state holds this rank's blocks (:mod:`repro_torch.dist.blocks`) and
the batch its data rows (``launch.partition.data_rows``): the loss is its share of the
global batch's mean, each gradient leaf not split over ``data`` is summed
over the batch's ranks (``data``, or (pod, data) on the multi-pod mesh)
before the update (an FSDP leaf's already is over ``data``, in its
gather's backward, and is summed over the pods), the metrics ``loss`` /
``acc`` / ``aux`` likewise, and
the clip reads the global norm, so every rank steps as the one-rank run.

The serving steps cast the parameters to the compute dtype once and hand
the cast copy to ``lm.forward_precast`` / ``lm.decode_step_precast``, which
do not cast again: the reference casts at every call, which on the card
would re-read every float32 weight once per token for the same numbers.
The copy is made again when a call brings other tensors or a tensor changed
in place (its ``_version``; a write through ``.data`` is not seen).  The
training loss never uses that copy: it has no path back to the float32
leaves.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist import blocks, sharding
from ..optim import adamw as opt_mod
from . import lm
from .config import ModelConfig
from .losses import chunked_cross_entropy


class TrainState(NamedTuple):
    params: dict
    opt: opt_mod.AdamWState
    step: torch.Tensor  # int32 scalar


def init_train_state(gen: torch.Generator, cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig,
                     device=None) -> TrainState:
    """Parameters drawn from ``gen`` (on its device) and placed on
    ``device``, zero moments, step 0."""
    params = lm.init_params(gen, cfg, device=device)
    return TrainState(params=params, opt=opt_mod.init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=resolve_device(device)))


def loss_fn(params: dict, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
    """-> (NLL + 1e-2 * aux, {"loss", "acc", "aux"}) on ``batch["tokens"]``
    (B, S + 1): the first S tokens in, the last S the targets.  A VLM config
    (``n_img_tokens``) needs ``batch["img_embeds"]`` and loses its first
    ``n_img_tokens`` hidden positions before the loss, as the reference
    does (which, given no image, fails on a shape mismatch instead: the port
    raises ``ValueError``); an encoder-decoder needs ``batch["frames"]``."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.n_img_tokens and batch.get("img_embeds") is None:
        raise ValueError(f"{cfg.name} puts {cfg.n_img_tokens} image positions before the text: "
                         "loss_fn needs batch['img_embeds'] (B, n_img_tokens, d_model)")
    hidden, aux = lm.forward(params, cfg, inputs, img_embeds=batch.get("img_embeds"),
                             frames=batch.get("frames"))
    if cfg.n_img_tokens:
        hidden = hidden[:, cfg.n_img_tokens:]  # the loss on the text stream alone
    nll, acc = chunked_cross_entropy(params, cfg, hidden, targets)
    return nll + 1e-2 * aux, {"loss": nll, "acc": acc, "aux": aux}


def grads_of(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """-> (metrics, gradient leaves in ``lm.tree_leaves`` order): ``None``
    for a leaf the loss does not reach.  The parameters are differentiated
    through detached aliases, so the state's tensors keep their
    ``requires_grad``."""
    leaves = list(lm.tree_leaves(params))
    it = iter([leaf.detach().requires_grad_(True) for leaf in leaves])
    aliases = lm.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        total, metrics = loss_fn(aliases, cfg, batch)
        grads = torch.autograd.grad(total, list(lm.tree_leaves(aliases)), allow_unused=True)
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig, microbatches: int = 1):
    """``(state, batch) -> (state, metrics)``; the returned state holds the
    given state's tensors, updated in place, and a new step counter.
    Metrics: ``loss``, ``acc``, ``aux`` (the mean over microbatches),
    ``grad_norm``, ``lr``, ``step``.  The step is its two halves, which it
    carries as attributes so that a caller can time each:
    ``train_step.gradient(state, batch) -> (metrics, grads)`` and
    ``train_step.apply(state, metrics, grads) -> (state, metrics)``.  On a
    mesh, ``gradient`` includes the sums over the data axis."""

    def local_gradient(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            metrics, grads = grads_of(state.params, cfg, batch)
        else:
            micro = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                     for k, v in batch.items()}
            grads, per_micro = None, []
            for i in range(microbatches):
                m, g = grads_of(state.params, cfg, {k: v[i] for k, v in micro.items()})
                per_micro.append(m)
                g = [None if a is None else a.float() / microbatches for a in g]
                # a leaf the loss does not reach is None in every microbatch
                grads = g if grads is None else [None if b is None else b + a
                                                 for a, b in zip(g, grads)]
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        return metrics, grads

    memo: dict = {}

    def mesh_specs(params):
        """(mesh, the partition spec of every leaf of ``params``) under the
        active rules, derived once for each set of rules."""
        rules, mesh = sharding.current_rules()
        key = (tuple(mesh.axis_names), tuple(mesh.axis_sizes), tuple(sorted(rules.items())))
        if key not in memo:
            memo[key] = blocks.leaf_specs(mesh, params, rules)
        return mesh, memo[key]

    def gradient_on_mesh(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grads = local_gradient(state, batch)
        if not sharding.is_sharded_run():
            return metrics, grads
        mesh, specs = mesh_specs(state.params)
        dp = sharding.batch_axes()
        if sharding.extent(mesh, dp) == 1:
            return metrics, grads
        group = mesh.group(dp)
        # the multi-pod batch's pods: a leaf split over data (FSDP) is
        # summed over its data ranks in its gather's backward, over the pods here
        pods = tuple(a for a in (dp if isinstance(dp, tuple) else (dp,)) if a != "data")
        grads = [g if g is None else g.contiguous() for g in grads]
        for g, spec in zip(grads, specs):
            if g is None:
                continue
            if "data" not in blocks.spec_axes(spec):
                dist.all_reduce(g, group=group)
            for a in pods:
                if "data" in blocks.spec_axes(spec) and mesh.size(a) > 1:
                    dist.all_reduce(g, group=mesh.group(a))
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(vec, group=group)
        return dict(zip(keys, vec.unbind())), grads

    def apply(state: TrainState, metrics: dict, grads):
        it = iter(grads)
        grad_tree = lm.tree_map(lambda _: next(it), state.params)
        mesh, specs = mesh_specs(state.params) if sharding.is_sharded_run() else (None, None)
        params, opt, opt_metrics = opt_mod.update(state.params, grad_tree, state.opt, opt_cfg,
                                                  specs, mesh)
        step = state.step + 1
        return TrainState(params=params, opt=opt, step=step), dict(metrics, **opt_metrics,
                                                                    step=step)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return apply(state, *gradient_on_mesh(state, batch))

    train_step.gradient, train_step.apply = gradient_on_mesh, apply
    return train_step


def make_eval_step(cfg: ModelConfig):
    """``(params, batch) -> {"loss", "acc", "aux"}``, without a gradient."""

    @torch.no_grad()
    def eval_step(params: dict, batch: Dict[str, torch.Tensor]) -> dict:
        return loss_fn(params, cfg, batch)[1]

    return eval_step


def _cast_once(cfg: ModelConfig) -> Callable[[dict], dict]:
    """params -> their compute-dtype copy, cast at the first call and reused
    while the calls bring the same tensors, unchanged."""
    held: Dict[str, object] = {}

    def cast(params: dict) -> dict:
        leaves = list(lm.tree_leaves(params))
        stamp = [(id(t), t._version) for t in leaves]
        if held.get("stamp") != stamp:
            held.clear()  # the old copy goes before the new one is made
            # the leaves are held so that their ids stay theirs
            held.update(leaves=leaves, stamp=stamp, cast=lm.cast_params(params, cfg))
        return held["cast"]

    return cast


def make_prefill_step(cfg: ModelConfig):
    """(params, {"tokens": (B, S)}) -> last-position logits (B, vocab_padded);
    the batch may also hold ``img_embeds`` (B, N, D) and, for an
    encoder-decoder, must hold ``frames`` (B, S_enc, D) (:func:`lm.forward`)."""
    cast = _cast_once(cfg)

    @torch.no_grad()
    def prefill_step(params: dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        p = cast(params)
        hidden, _ = lm.forward_precast(p, cfg, batch["tokens"],
                                       img_embeds=batch.get("img_embeds"),
                                       frames=batch.get("frames"))
        return lm.logits_for(p, cfg, hidden[:, -1:])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, tokens (B, 1), DecodeState) -> (logits (B, vocab_padded), DecodeState)."""
    cast = _cast_once(cfg)

    @torch.no_grad()
    def decode_step(params: dict, tokens: torch.Tensor, state: lm.DecodeState):
        return lm.decode_step_precast(cast(params), cfg, tokens, state)

    return decode_step


def greedy_generate(params: dict, cfg: ModelConfig, prompt: torch.Tensor, steps: int,
                    max_len: int) -> torch.Tensor:
    """Host-driven greedy decoding: the prompt fed token by token, then
    ``steps`` argmax tokens (over the unpadded vocabulary), (B, steps).  An
    encoder-decoder config raises ``ValueError``: the state is built without
    an encoder output, as the reference's is."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: greedy_generate has no frames; "
                         "decode it with init_decode_state(..., cross_kv=encoder_forward(params, "
                         "cfg, frames)) and make_decode_step")
    b = prompt.shape[0]
    state = lm.init_decode_state(cfg, b, max_len, device=prompt.device)
    decode = make_decode_step(cfg)
    for i in range(prompt.shape[1]):
        logits, state = decode(params, prompt[:, i:i + 1], state)
    out = [torch.argmax(logits[:, :cfg.vocab], dim=-1)]
    for _ in range(steps - 1):
        logits, state = decode(params, out[-1][:, None], state)
        out.append(torch.argmax(logits[:, :cfg.vocab], dim=-1))
    return torch.stack(out, dim=1)
