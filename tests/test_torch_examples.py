"""The port's examples (``examples/torch_*.py``) on the CPU at small sizes.

Each example's ``main`` runs with ``--device cpu`` in a scratch working
directory (its renders and checkpoints land there); the mesh examples run
on gloo ranks through ``--fake-devices``.  The quickstart must reach the
paper's MSE <= 1e-4 with both methods; the single-frame deblur and the
map-making examples are held against the reference's solve of the same
problem, carried to the reference through numpy: the deblurred frame
within 1e-4, the maps within 1e-5 and their PSNR table within 0.01 dB.
"""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def examples(monkeypatch, tmp_path):
    """Import an example by name, run from a scratch directory; spawned
    ranks find the module on the inherited ``sys.path``."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    monkeypatch.chdir(tmp_path)
    return importlib.import_module


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _ref_deblur(p):
    """The port's DeblurProblem as the reference's, its arrays as given."""
    from repro.core.circulant import Circulant, PartialCirculant
    from repro.core.deblur import DeblurProblem

    a = lambda t: jnp.asarray(t.numpy())
    circ = Circulant(col=a(p.op.circ.col), spec=a(p.op.circ.spec))
    return DeblurProblem(op=PartialCirculant(circ, a(p.op.omega).astype(jnp.int32)),
                         blur=Circulant(col=a(p.blur.col), spec=a(p.blur.spec)),
                         y=a(p.y), image=a(p.image))


def test_quickstart_reaches_the_paper_target(examples, capsys):
    out = examples("torch_quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.count("-> recovered") == 2
    for method in ("cpadmm", "fista"):
        assert out[method]["mse"][-1] <= 1e-4, (method, out[method]["mse"])


def test_deblur_astronomy_matches_reference(examples, capsys, tmp_path):
    from repro.core import RecoveryProblem, solve

    out = examples("torch_deblur_astronomy").main(
        ["--device", "cpu", "--size", "32", "--iters", "120", "--out", "renders"])
    assert "abs err / mean int." in capsys.readouterr().out
    ref = _ref_deblur(out["problem"])
    x_ref, _ = solve(RecoveryProblem(ref.op, ref.y, ref.image.reshape(-1)), "cpadmm", iters=120,
                     record_every=20, alpha=1e-3, rho=0.01, sigma=0.01)
    assert _rel(out["x_hat"].numpy(), x_ref) <= 1e-4
    assert sorted(p.name for p in (tmp_path / "renders").iterdir()) == [
        "blurred.pgm", "original.pgm", "recovered.pgm"]


@pytest.mark.parametrize("flags", [[], ["--mesh", "2x2", "--fake-devices", "4", "--rfft"]],
                         ids=["local", "mesh-2x2"])
def test_deblur_multiframe_restarts_bit_identical(flags, examples, capfd):
    out = examples("torch_deblur_multiframe").main(
        ["--device", "cpu", "--size", "16", "--iters", "100", "--chunk", "50", *flags])
    text = capfd.readouterr().out
    assert out["identical"] and "bit-identical: True" in text
    assert text.count("PSNR") == 4 and bool(torch.isfinite(out["metrics"]["psnr_db"]).all())


@pytest.mark.parametrize("fake", ["2", "4"])
def test_distributed_recovery_restarts_bit_identical(fake, examples, capfd):
    out = examples("torch_distributed_recovery").main(
        ["--device", "cpu", "--fake-devices", fake, "--n1", "32", "--n2", "32"])
    text = capfd.readouterr().out
    assert out["identical"] and "bit-identical: True" in text
    assert out["mse"] < 1e-4 and "final MSE" in text and "(OK)" in text


def test_mapmaking_example_gives_the_reference_table(examples, capsys):
    from repro.core.mapmaking import MapMakingProblem as RefProblem
    from repro.core.mapmaking import build_mapmaking_plan as ref_plan
    from repro.core.mapmaking import solve_mapmaking as ref_solve

    out = examples("torch_mapmaking_herschel").main(["--device", "cpu", "--size", "16"])
    text = capsys.readouterr().out
    assert "map PSNR" in text
    p = out["problem"]
    ref = RefProblem(deblur=_ref_deblur(p.deblur), sky=jnp.asarray(p.sky.numpy()),
                     shifts=p.shifts)
    for prior, prox in (("tv", "tv"), ("l1", None)):
        z, m = out["results"][prior]
        z_ref, m_ref = ref_solve(ref, plan=ref_plan(ref, prox=prox), iters=400, alpha=1e-4)
        assert _rel(m["map"].numpy(), m_ref["map"]) <= 1e-5, prior
        assert abs(float(m["psnr_db"]) - float(m_ref["psnr_db"])) <= 0.01, prior
        assert f"{float(m_ref['psnr_db']):>8.1f} dB" in text
    assert float(out["results"]["tv"][1]["psnr_db"]) > float(out["results"]["l1"][1]["psnr_db"])


def test_mapmaking_example_on_a_mesh(examples, capfd):
    out = examples("torch_mapmaking_herschel").main(
        ["--device", "cpu", "--size", "16", "--iters", "100", "--prior", "tv", "--mesh", "2",
         "--fake-devices", "2"])
    assert "prox=tv[16x16,it10]" in capfd.readouterr().out
    assert bool(torch.isfinite(out["results"]["tv"][1]["map"]).all())
