"""The train step of the five families after minitron and moonshot, against the reference.

deepseek-v3 (MLA over MoE), zamba2-1.2b (Mamba-2 with a shared attention
block), xlstm-350m (mLSTM and sLSTM), whisper-large-v3 (encoder-decoder,
``frames`` in the batch) and pixtral-12b (an image prefix,
``img_embeds`` in the batch): three ``make_train_step`` steps at SMOKE in
float32 from the reference's initial state, carried across by
``repro_torch.interop.train_state_from_numpy``, each against the
reference's ``jax.jit(make_train_step(...))`` on the same batches, made with
numpy from a seed.  ``microbatches=1`` for all five, 2 as well for whisper
and pixtral, whose extra batch keys the split must cut along dim 0.

Limits, as ``tests/test_torch_train.py::test_train_steps_match_reference``
holds minitron and moonshot: the schedule's ``lr`` at 1e-6 relative, each
step's loss at 1e-4 relative (three updates compound the gradient's 1e-4)
and its ``grad_norm`` at 1e-4.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import steps as port_steps
from repro_torch.optim import adamw as port_adamw

B, S, S_ENC, STEPS = 4, 24, 24, 3
CASES = [("deepseek-v3-671b", 1), ("zamba2-1.2b", 1), ("xlstm-350m", 1),
         ("whisper-large-v3", 1), ("whisper-large-v3", 2), ("pixtral-12b", 1),
         ("pixtral-12b", 2)]


@pytest.fixture(scope="module")
def ref():
    """The reference's training stack, loaded in a fixture so that the file
    imports on a card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import steps
    from repro.optim import adamw

    return types.SimpleNamespace(jax=jax, registry=registry, steps=steps, adamw=adamw)


OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def initial(ref):
    """arch -> the reference's float32 SMOKE config and its initial
    TrainState as numpy, drawn once per module (jitted: one compile is
    quicker than the draws op by op)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = dataclasses.replace(ref.registry.smoke_config(arch), dtype="float32")
            init = ref.jax.jit(lambda key: ref.steps.init_train_state(
                key, cfg, ref.adamw.AdamWConfig(**OPT)))
            built[arch] = cfg, ref.jax.tree.map(np.asarray, init(ref.jax.random.PRNGKey(0)))
        return built[arch]

    return get


def batches(cfg, seed=7) -> list:
    """STEPS numpy batches: tokens (B, S + 1), and ``frames`` (B, S_ENC,
    d_model) for an encoder-decoder or ``img_embeds`` (B, n_img_tokens,
    d_model) for a VLM, N(0, 0.02^2) as the stubbed front ends give."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
        if cfg.is_encdec:
            b["frames"] = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.02).astype(np.float32)
        if cfg.n_img_tokens:
            b["img_embeds"] = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
                               * 0.02).astype(np.float32)
        out.append(b)
    return out


def to_port(batch: dict) -> dict:
    return {k: torch.as_tensor(v).long() if k == "tokens" else torch.as_tensor(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch,micro", CASES)
def test_train_steps_match_reference(ref, initial, arch, micro):
    """Three steps from the reference's initial state: each step's loss,
    gradient norm and lr against the reference's with as many microbatches;
    the step counters advance on both sides."""
    cfg, tree = initial(arch)
    pcfg = dataclasses.replace(port_registry.smoke_config(arch), dtype="float32")
    rcfg, ocfg = ref.adamw.AdamWConfig(**OPT), port_adamw.AdamWConfig(**OPT)
    rstate = ref.jax.tree.map(ref.jax.numpy.asarray, tree)
    state = train_state_from_numpy(tree, pcfg, "cpu")
    rstep = ref.jax.jit(ref.steps.make_train_step(cfg, rcfg, microbatches=micro))
    step = port_steps.make_train_step(pcfg, ocfg, microbatches=micro)
    for i, batch in enumerate(batches(cfg)):
        rstate, want = rstep(rstate, batch)
        state, got = step(state, to_port(batch))
        want = {k: float(v) for k, v in want.items()}
        got = {k: float(v) for k, v in got.items()}
        assert got["step"] == want["step"] == i + 1
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]), (i, got, want)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4), (i, got, want)
        assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
    assert int(state.step) == STEPS and int(state.opt.count) == STEPS
