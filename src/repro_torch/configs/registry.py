"""--arch registry: full (assigned) configs and reduced smoke configs.

Port of ``repro/configs/registry.py``: the four dense decoder-only
transformers, moonshot-v1-16b-a3b (MoE over GQA), deepseek-v3-671b (MoE over
MLA), zamba2-1.2b (Mamba-2 with a shared attention block), pixtral-12b (an
image prefix before the text), xlstm-350m (mLSTM and sLSTM) and
whisper-large-v3 (encoder-decoder); and the dry run's shape cells.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "codeqwen15_7b",
    "granite_34b",
    "minitron_4b",
    "gemma_7b",
    "deepseek_v3_671b",
    "moonshot_v1_16b_a3b",
    "zamba2_1p2b",
    "pixtral_12b",
    "xlstm_350m",
    "whisper_large_v3",
]

# external ids (assignment spelling) -> module names
ALIASES: Dict[str, str] = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "granite-34b": "granite_34b",
    "minitron-4b": "minitron_4b",
    "gemma-7b": "gemma_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "pixtral-12b": "pixtral_12b",
    "xlstm-350m": "xlstm_350m",
    "whisper-large-v3": "whisper_large_v3",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"{__package__}.{name}")


def full_config(arch: str) -> ModelConfig:
    return _module(arch).FULL.validate()


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE.validate()


def all_arch_ids() -> List[str]:
    return list(ARCH_IDS)


# Shape cells (assignment): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic (SSM/hybrid) archs per the assignment.
LONG_CONTEXT_ARCHS = {"zamba2_1p2b", "xlstm_350m"}


def cells_for(arch: str):
    """The shape names assigned to ``arch``: every shape but ``long_500k``,
    which only the sub-quadratic archs run."""
    name = ALIASES.get(arch, arch)
    return [shape for shape in SHAPES
            if shape != "long_500k" or name in LONG_CONTEXT_ARCHS]
