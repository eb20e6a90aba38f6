"""The port's recovery launcher (``python -m repro_torch.launch.recover``).

In-process calls of ``main`` at tiny sizes on the CPU (``--device cpu``),
mirroring the local cases of ``tests/test_recover_cli.py``: the
checkpointed resume, the tolerance mode, the deblur workload, the priors
and the method errors; and ``--tune`` / ``--tune measure`` on a one-rank
gloo mesh, whose second run reports the plan store's hit.
"""

import pytest
import torch

from repro_torch.launch import recover


def test_checkpointed_mode_resumes(tmp_path, capsys):
    args = [
        "--n", "512", "--batch", "2", "--method", "cpadmm", "--iters", "60",
        "--chunk", "30", "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu",
    ]
    recover.main(args)
    first = capsys.readouterr().out
    assert "per-signal MSE" in first and "resumed" not in first
    assert "device=cpu" in first
    recover.main(args)  # latest checkpoint (iter 60) is picked up
    assert "resumed from iteration 60" in capsys.readouterr().out


def test_resume_continues_to_the_same_result(tmp_path, capsys):
    """An ISTA run stopped at 40 iterations and resumed to 80 ends where an
    uninterrupted 80-iteration run ends."""
    base = ["--n", "512", "--batch", "2", "--method", "ista", "--chunk", "20",
            "--device", "cpu"]
    recover.main(base + ["--iters", "40", "--ckpt-dir", str(tmp_path / "a")])
    recover.main(base + ["--iters", "80", "--ckpt-dir", str(tmp_path / "a")])
    resumed = capsys.readouterr().out.splitlines()
    recover.main(base + ["--iters", "80", "--ckpt-dir", str(tmp_path / "b")])
    whole = capsys.readouterr().out.splitlines()
    assert "resumed from iteration 40" in resumed
    mse_line = lambda lines: [ln for ln in lines if "per-signal MSE" in ln][-1].split(";")[1]
    assert mse_line(resumed) == mse_line(whole)


def test_default_checkpoint_dir_is_the_ports_own(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    recover.main(["--n", "256", "--batch", "1", "--iters", "20", "--chunk", "20",
                  "--device", "cpu"])
    assert (tmp_path / "artifacts" / "torch_recover_ckpt" / "step_0000000020").is_dir()
    assert not (tmp_path / "artifacts" / "recover_ckpt").exists()


def test_local_tol_mode(capsys):
    recover.main([
        "--n", "512", "--batch", "1", "--method", "ista", "--iters", "40",
        "--tol", "1e-2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "plan API" not in out and "per-signal iterations" in out
    assert "per-signal MSE" in out


def test_deblur_workload_tol_mode_local(capsys):
    recover.main([
        "--deblur", "--batch", "1", "--size", "16", "--iters", "40",
        "--tol", "1e-2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "per-signal iterations" in out and "PSNR" in out


def test_deblur_workload_checkpointed(tmp_path, capsys):
    recover.main([
        "--deblur", "--batch", "2", "--size", "16", "--blur-order", "3",
        "--iters", "40", "--chunk", "20", "--ckpt-dir", str(tmp_path / "ck"),
        "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "deblurring batch=2 frames of 16x16" in out
    assert out.count("PSNR") == 2 and "normalized MSE" in out


def test_make_prior():
    from repro_torch.ops.prox import NonNegL1Prox, TVProx, WaveletProx

    assert recover.make_prior("l1", 256) is None
    assert isinstance(recover.make_prior("nonneg-l1", 256), NonNegL1Prox)
    assert isinstance(recover.make_prior("wavelet", 256), WaveletProx)
    assert recover.make_prior("tv", 256) == TVProx(shape=(16, 16))
    assert recover.make_prior("tv", 0, size=8) == TVProx(shape=(8, 8))
    with pytest.raises(SystemExit, match="square"):
        recover.make_prior("tv", 200)


@pytest.mark.parametrize("prior", ["nonneg-l1", "wavelet", "tv"])
def test_prior_flag_local_sparse_recovery(prior, capsys):
    recover.main(["--n", "256", "--batch", "1", "--method", "ista", "--iters", "40",
                  "--tol", "1e-2", "--prior", prior, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"prior={prior}" in out and "per-signal" in out and "tail=plain" in out


def test_tv_prior_needs_a_square_frame(tmp_path):
    with pytest.raises(SystemExit, match="square"):
        recover.main(["--n", "200", "--prior", "tv", "--device", "cpu", "--fake-devices", "2",
                      "--mesh", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_deblur_tv_prior_with_mesh_plan(capfd, tmp_path):
    """--prior tv builds a TVProx on the frame grid and threads it through
    build_deblur_plan onto the mesh path (two gloo ranks here)."""
    recover.main(["--deblur", "--batch", "2", "--size", "16", "--blur-kind", "gaussian",
                  "--blur-order", "1.0", "--prior", "tv", "--iters", "40", "--chunk", "20",
                  "--mesh", "1x2", "--fake-devices", "2", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "ck")])
    out = capfd.readouterr().out
    assert "prior=tv" in out and out.count("PSNR") == 2


def test_method_error_lists_valid_methods(capsys):
    with pytest.raises(SystemExit):
        recover.main(["--method", "newton", "--n", "512", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "cpadmm" in err and "ista" in err and "fista" in err


@pytest.mark.parametrize("flags,item", [
    (["--tune"], "model"),
    (["--tune", "measure"], "measure"),
])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item, tmp_path, capfd,
                                                      monkeypatch):
    """``--tune`` and ``--tune measure`` run (they exited naming the tuner's
    ROADMAP item before it was ported): on a one-rank mesh the first run
    tunes and stores the plan, the second reports the cache hit and the
    same plan, and both recover."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plan_cache.json"))
    reports = []
    for run in ("first", "second"):
        recover.main(["--n", "256", "--iters", "40", "--chunk", "20", "--device", "cpu",
                      "--mesh", "1", "--fake-devices", "1",
                      "--ckpt-dir", str(tmp_path / run), *flags])
        out = capfd.readouterr().out
        assert "per-signal MSE" in out
        reports += [ln for ln in out.splitlines() if ln.startswith(f"tuned plan [{item}]: ")]
    assert len(reports) == 2 and reports[0].endswith("(tuned, stored)")
    assert reports[1] == reports[0].replace("(tuned, stored)", "(cache hit)")


def test_tune_pins_only_the_flags_given(tmp_path, capfd, monkeypatch):
    """Under ``--tune`` an explicit flag is a pin and a default is not: a
    deblur run with ``--rfft --wire-dtype bf16`` keeps both, and a local run
    takes its flags as the plan."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plan_cache.json"))
    recover.main(["--deblur", "--size", "16", "--batch", "2", "--iters", "20", "--chunk", "20",
                  "--mesh", "1", "--fake-devices", "1", "--rfft", "--wire-dtype", "bf16",
                  "--tune", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    out = capfd.readouterr().out
    tuned = next(ln for ln in out.splitlines() if ln.startswith("tuned plan [model]: "))
    assert "rfft=on" in tuned and "wire=bf16" in tuned and out.count("PSNR") == 2
    recover.main(["--n", "256", "--iters", "20", "--chunk", "20", "--tune", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "local")])
    assert "tuned plan [model]: n1xn2=auto rfft=off overlap=1 tail=plain\n" in \
        capfd.readouterr().out


@pytest.mark.parametrize("flags,error,match", [
    (["--rfft"], ValueError, "distributed-backend knobs"),
    (["--overlap", "2"], ValueError, "distributed-backend knobs"),
    (["--wire-dtype", "bf16"], ValueError, "no wire to compress"),
    (["--fake-devices", "4"], SystemExit, "--mesh"),
    (["--mesh", "2x2x2", "--fake-devices", "8"], ValueError, "'M' or 'DxM'"),
])
def test_mesh_flags_without_a_mesh_raise(flags, error, match, tmp_path):
    """The distributed knobs need a mesh (the plan layer's single validation
    site, as in the reference); none of these starts a rank."""
    with pytest.raises(error, match=match):
        recover.main(["--n", "256", "--iters", "10", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "ck"), *flags])
    assert not (tmp_path / "ck").exists()


def test_runs_on_the_card_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recover.main(["--n", "256", "--iters", "10", "--ckpt-dir", str(tmp_path / "ck")])


def test_cli_reports_the_plain_step_on_the_cpu(capsys):
    recover.main(["--n", "256", "--batch", "1", "--iters", "10", "--chunk", "10",
                  "--device", "cpu", "--tol", "1e-2"])
    assert "tail=plain" in capsys.readouterr().out


@pytest.mark.gpu
def test_cli_runs_the_kernels_on_the_card(tmp_path, capsys):
    """No flag asks for them: on the card the plan's tail resolves to the
    kernel step, one spectral_pointwise and one cpadmm_tail launch an
    iteration, and the deblur workload takes them too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.spectral_pointwise.ops import spectral_update

    spectral_update.launches = fused_cpadmm_tail.launches = 0
    recover.main(["--n", "16384", "--batch", "2", "--iters", "40", "--chunk", "20",
                  "--ckpt-dir", str(tmp_path / "ck")])
    assert "tail=kernel" in capsys.readouterr().out
    assert spectral_update.launches == fused_cpadmm_tail.launches == 40
    recover.main(["--deblur", "--size", "64", "--batch", "2", "--iters", "30", "--chunk", "30",
                  "--ckpt-dir", str(tmp_path / "deblur")])
    assert fused_cpadmm_tail.launches == 70 > 0
