"""Prefill and decode step builders, and greedy generation.

Port of the serving half of ``repro/models/steps.py``.  Each step function
casts the parameters to the compute dtype once and hands the cast copy to
``lm.forward_precast`` / ``lm.decode_step_precast``, which do not cast
again: the reference casts at every call (``lm.forward`` and
``lm.decode_step``), which on the card would re-read every float32 weight
once per token for the same numbers.  The copy is made again when a call
brings other tensors or a tensor changed in place (its ``_version``; a
write through ``.data`` is not seen).  ``TrainState``, ``loss_fn`` and
``make_train_step`` wait for the training slice (ROADMAP.md Queue 1 item
11).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import lm
from .config import ModelConfig


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
    """(params, {"tokens": (B, S)}) -> last-position logits (B, vocab_padded)."""
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
    ``steps`` argmax tokens (over the unpadded vocabulary), (B, steps)."""
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
