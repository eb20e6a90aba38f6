"""Shape stand-ins for every (arch x shape) cell of the dry run.

Port of ``repro/launch/specs.py``: ``meta`` tensors take the place of the
reference's ``ShapeDtypeStruct``, in the reference's dtypes (int32 tokens,
bf16 frames and image embeddings, the parameters in ``cfg.param_dtype``).
Nothing is drawn and nothing is allocated: the parameter and train-state
trees are built by the port's own initialisers with a
:class:`~repro_torch.models.layers.ShapeGenerator`, whose every draw is a
``meta`` tensor, as the reference's ``jax.eval_shape`` traces its init
without running it.  The trees are global; :mod:`repro_torch.launch.dryrun`
cuts a rank's blocks from them.  The modality frontends are stubs, as in the
reference: whisper gets post-conv frame embeddings, pixtral patch
embeddings, both as inputs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.registry import SHAPES
from ..models import lm, steps
from ..models.config import ModelConfig
from ..models.layers import ShapeGenerator
from ..optim.adamw import AdamWConfig

META = torch.device("meta")

WHISPER_TEXT_LEN = 448  # whisper's decoder horizon (teacher forcing)
WHISPER_CROSS_LEN = 4096  # encoder memory length carried into decode cells


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def opt_config() -> AdamWConfig:
    return AdamWConfig()


def train_batch_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    if cfg.is_encdec:
        return {
            "tokens": _spec((batch, WHISPER_TEXT_LEN + 1), torch.int32),
            "frames": _spec((batch, seq_len, cfg.d_model), torch.bfloat16),
        }
    if cfg.n_img_tokens:
        text = seq_len - cfg.n_img_tokens
        return {
            "tokens": _spec((batch, text + 1), torch.int32),
            "img_embeds": _spec((batch, cfg.n_img_tokens, cfg.d_model), torch.bfloat16),
        }
    return {"tokens": _spec((batch, seq_len + 1), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    if cfg.is_encdec:
        return {
            "tokens": _spec((batch, WHISPER_TEXT_LEN), torch.int32),
            "frames": _spec((batch, seq_len, cfg.d_model), torch.bfloat16),
        }
    if cfg.n_img_tokens:
        return {
            "tokens": _spec((batch, seq_len - cfg.n_img_tokens), torch.int32),
            "img_embeds": _spec((batch, cfg.n_img_tokens, cfg.d_model), torch.bfloat16),
        }
    return {"tokens": _spec((batch, seq_len), torch.int32)}


def train_state_specs(cfg: ModelConfig) -> steps.TrainState:
    return steps.init_train_state(ShapeGenerator(), cfg, opt_config(), device=META)


def params_specs(cfg: ModelConfig) -> dict:
    return lm.init_params(ShapeGenerator(), cfg, device=META)


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int) -> lm.DecodeState:
    cross = (_spec((batch, WHISPER_CROSS_LEN, cfg.d_model), torch.bfloat16)
             if cfg.is_encdec else None)
    return lm.init_decode_state(cfg, batch, max_len, cross_kv=cross, device=META)


def cell_specs(cfg: ModelConfig, shape_name: str) -> Tuple[str, Callable, Tuple]:
    """-> (step kind, step function, its argument specs), global shapes."""
    seq_len, batch, kind = SHAPES[shape_name]
    if kind == "train":
        fn = steps.make_train_step(cfg, opt_config())
        return "train", fn, (train_state_specs(cfg), train_batch_specs(cfg, seq_len, batch))
    if kind == "prefill":
        fn = steps.make_prefill_step(cfg)
        return "prefill", fn, (params_specs(cfg), prefill_batch_specs(cfg, seq_len, batch))
    # decode: one token against a seq_len-deep cache
    fn = steps.make_decode_step(cfg)
    return "decode", fn, (params_specs(cfg), _spec((batch, 1), torch.int32),
                          decode_state_specs(cfg, batch, max_len=seq_len))
