"""The training launcher (``python -m repro_torch.launch.train``) and TrainState checkpoints.

The launcher runs in this process with ``--device cpu`` at smoke size.  A
run interrupted after its step-2 checkpoint and resumed must end bit for
bit where an uninterrupted run ends: each step's batch depends on (seed,
step, host) alone and the checkpoint holds the whole TrainState.  A
TrainState crosses between the packages' checkpoints both ways, with
``opt.count`` and ``step`` int32 on both sides.  The sharded launcher's
meshes raise in a process alone, whose world has one rank; whisper-large-v3 and
pixtral-12b raise ``ValueError`` (their batches need frames or image
embeddings, which the launcher does not draw).
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry as port_registry
from repro_torch.data.synthetic import step_generator, token_batch
from repro_torch.launch import train
from repro_torch.models import steps as port_steps
from repro_torch.optim.adamw import AdamWConfig


def _leaves(tree):
    return [leaf for _, leaf in ckpt._leaf_paths(tree)]


def _assert_states_equal(got, want):
    assert [k for k, _ in ckpt._leaf_paths(got)] == [k for k, _ in ckpt._leaf_paths(want)]
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("arch,micro", [("minitron-4b", 1), ("moonshot-v1-16b-a3b", 2)])
def test_resumed_run_is_bit_equal_to_uninterrupted(tmp_path, capsys, arch, micro):
    args = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
            "--ckpt-every", "2", "--microbatches", str(micro), "--device", "cpu"]
    whole = train.main(args + ["--ckpt-dir", str(tmp_path / "whole")])
    cut = tmp_path / "cut"
    train.main(args + ["--ckpt-dir", str(cut)])
    shutil.rmtree(cut / f"step_{4:010d}")  # preempted after the step-2 checkpoint
    capsys.readouterr()
    resumed = train.main(args + ["--ckpt-dir", str(cut)])
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(resumed.step) == int(whole.step) == 4
    assert resumed.step.dtype == resumed.opt.count.dtype == torch.int32
    _assert_states_equal(resumed, whole)


def test_progress_lines_and_checkpoints(tmp_path, capsys):
    state = train.main(["--arch", "minitron-4b", "--smoke", "--steps", "20", "--batch", "2",
                        "--seq", "16", "--ckpt-every", "10", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out if ln.startswith("step")] == [["step", "10"],
                                                                      ["step", "20"]]
    assert out[-1] == "done" and ckpt.latest_step(str(tmp_path)) == 20
    assert all(np.isfinite(float(ln.split()[3])) for ln in out if ln.startswith("step"))
    assert int(state.opt.count) == 20


def test_batches_depend_on_seed_step_and_host_alone():
    draw = lambda *key: token_batch(step_generator(*key), 2, 8, 512, device="cpu")
    assert torch.equal(draw(0, 5, 0), draw(0, 5, 0))
    assert not torch.equal(draw(0, 5, 0), draw(0, 6, 0))
    assert not torch.equal(draw(0, 5, 0), draw(1, 5, 0))
    assert not torch.equal(draw(0, 5, 0), draw(0, 5, 1))


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "single"], "needs 256 ranks, but the world has 1"),
    (["--mesh", "multipod"], "needs 512 ranks, but the world has 1"),
    (["--model-parallel", "2"], "--model-parallel 2 does not divide the world of 1 rank"),
], ids=["single", "multipod", "model-parallel"])
def test_sharded_flags_raise(flags, match, tmp_path):
    """In a process alone (a world of one rank, no process group joined):
    the production meshes need 256 and 512 ranks, and a model axis of 2
    does not divide 1 (the reference asserts it).  Sharded runs on gloo
    ranks are in test_torch_sharded_train.py."""
    with pytest.raises(ValueError, match=match):
        train.main(["--arch", "minitron-4b", "--smoke", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), *flags])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_encoder_decoder_and_vlm_archs_raise(arch, tmp_path):
    """The launcher's batches hold tokens alone, as the reference's do: an
    encoder-decoder needs frames and a VLM image embeddings (the
    reference's launcher fails on both, with an assert and a broadcast
    error)."""
    with pytest.raises(ValueError, match="frames" if "whisper" in arch else "img_embeds"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "minitron-4b", "--smoke", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("arch", ["minitron-4b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_train_state_checkpoints_cross_between_packages(tmp_path, arch):
    jax = pytest.importorskip("jax")
    from repro.ckpt import checkpoint as ref_ckpt
    from repro.configs import registry as ref_registry
    from repro.models import steps as ref_steps
    from repro.optim import adamw as ref_adamw

    cfg, pcfg = ref_registry.smoke_config(arch), port_registry.smoke_config(arch)
    rstate = ref_steps.init_train_state(jax.random.PRNGKey(0), cfg, ref_adamw.AdamWConfig())
    ref_ckpt.save(str(tmp_path / "ref"), 3, rstate)
    like = port_steps.init_train_state(torch.Generator().manual_seed(1), pcfg, AdamWConfig(),
                                       device="cpu")
    step, got = ckpt.restore(str(tmp_path / "ref"), None, like)
    assert step == 3 and type(got) is port_steps.TrainState
    assert got.step.dtype == got.opt.count.dtype == torch.int32
    want = dict(ref_ckpt._flatten(rstate))
    for key, leaf in ckpt._leaf_paths(got):
        assert leaf.dtype == getattr(torch, str(want[key].dtype))
        np.testing.assert_array_equal(leaf.numpy(), want[key])
    assert sorted(want) == sorted(k for k, _ in ckpt._leaf_paths(got))

    ckpt.save(str(tmp_path / "port"), 5, like)
    step, back = ref_ckpt.restore(str(tmp_path / "port"), None, rstate)
    assert step == 5 and type(back) is ref_steps.TrainState
    assert back.step.dtype == back.opt.count.dtype == np.int32
    ours = {k: leaf.numpy() for k, leaf in ckpt._leaf_paths(like)}
    for key, leaf in ref_ckpt._flatten(back).items():
        np.testing.assert_array_equal(leaf, ours[key])
