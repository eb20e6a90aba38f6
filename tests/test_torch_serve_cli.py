"""``repro_torch.launch.serve``: the serving launcher's flags, in-process at tiny sizes.

Mirrors ``tests/test_serve_cli.py`` on the CPU (``--device cpu``): local
engines with the static comparison, and a one-rank mesh (gloo) with
deadlines and priorities.  The launcher's output lines are the reference's;
``--tune`` plans the mesh bucket with the autotuner, a warm second run
reporting its cache hit; the launcher needs a card unless told ``--device
cpu``.
"""

import pytest
import torch

from repro_torch.launch import serve


def test_serve_local_with_static_comparison(capsys):
    serve.main([
        "--n", "256", "--requests", "5", "--slots", "2", "--rate", "500",
        "--max-iters", "300", "--compare-static", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "serving 5 requests, n=256" in out
    assert "continuous:" in out and "signals/s" in out
    assert "recycled" in out
    assert "static baseline:" in out
    assert "continuous vs static:" in out


def test_serve_mesh_plan_with_deadlines(capfd):
    serve.main([
        "--n", "256", "--requests", "3", "--slots", "2", "--rate", "500",
        "--max-iters", "200", "--mesh", "1", "--rfft", "--fake-devices", "1",
        "--deadline-slack", "60", "--priorities", "0", "1", "--device", "cpu",
    ])
    out = capfd.readouterr().out  # the rank prints from its own process
    assert "mesh=1 (plan API)" in out
    assert "expired 0" in out  # 60 s of slack: nothing expires at this size
    assert "buckets 1" in out


def test_serve_tune_names_the_tuner_item(capfd, monkeypatch, tmp_path):
    """``--tune`` runs (it exited naming the tuner's ROADMAP item before the
    tuner was ported): the first run tunes and stores, the second hits."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plan_cache.json"))
    args = ["--n", "256", "--requests", "3", "--slots", "2", "--rate", "500", "--max-iters",
            "200", "--mesh", "1", "--fake-devices", "1", "--device", "cpu", "--tune"]
    serve.main(args)
    first = capfd.readouterr().out
    serve.main(args)
    second = capfd.readouterr().out
    tuned = [ln for ln in first.splitlines() if ln.startswith("tuned plan [model]: ")]
    assert len(tuned) == 1 and tuned[0].endswith("(tuned, stored)")
    assert tuned[0].replace("(tuned, stored)", "(cache hit)") in second
    assert "continuous:" in second and "buckets 1" in second


def test_serve_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n", "256", "--requests", "2"])
