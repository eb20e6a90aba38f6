"""Mesh recovery of the port against the reference's single-device solve.

Mirrors ``tests/test_dist_equiv.py`` and the distributed half of
``tests/test_plan.py``: ``solve(..., plan=plan(op, mesh))`` on gloo ranks in
child processes (``spawn_fake_devices``, the CPU) is held against
``repro.core.solvers.solve`` on one device at the reference's 1e-5
relative contract, on a 2-rank model axis and on a 2x2 (data x model) mesh
with the batch of 4 signals on the data axis.  The reference's problem and
answers are computed here (JAX) and reach the ranks through numpy; all the
cases of one mesh run in one spawn.

FISTA is compared at convergence (800 iterations): its momentum amplifies
fp32 FFT rounding mid-trajectory (ROADMAP Queue 3), as the reference's own
``test_dist_plan_solve_matches_core`` does.  A bf16-wire solve is held
within the plan's guard bound of the fp32-wire solve.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch.dist.compat import make_mesh, spawn_fake_devices
from repro_torch.ops.plan import PlanConfig, plan

N1, N2 = 32, 16
N = N1 * N2
B = 4
ALPHA, RHO, SIGMA = 1e-4, 0.01, 0.01
KW = dict(alpha=ALPHA, rho=RHO, sigma=SIGMA)
ITERS, FISTA_ITERS, TOL = 300, 800, 1e-5
CPADMM_VARIANTS = [(fused, rfft) for fused in (True, False) for rfft in (False, True)]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _mesh_program(a, shape, dirs):
    """Every case on one mesh; rank 0 returns the gathered results."""
    import repro_torch.ops.plan as plan_mod
    from repro_torch import interop
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.deblur import build_deblur_plan, build_multiframe_deblur_problem
    from repro_torch.core.solvers import (
        RecoveryProblem,
        make_stepper,
        solve,
        solve_checkpointed,
        solve_until,
    )
    from repro_torch.data.synthetic import starfield

    names = ("model",) if len(shape) == 1 else ("data", "model")
    batch_axis = None if len(shape) == 1 else "data"
    mesh = make_mesh(shape, names)
    op = interop.partial_circulant_from_numpy(a["col"], a["spec"], a["omega"], device="cpu")
    prob = RecoveryProblem(op=op, y=torch.from_numpy(a["y"]), x_true=torch.from_numpy(a["x_true"]))
    mk = lambda **k: plan(op, mesh, n1=N1, n2=N2, batch_axis=batch_axis, **k)
    out = {}

    def run(name, method, iters, **knobs):
        pl = mk(**knobs)
        x, tr = solve(prob, method, iters=iters, plan=pl, **KW)
        out[name] = pl.gather_batch(x)
        out[name + "/finite"] = bool(torch.isfinite(tr.objective).all() and
                                     torch.isfinite(tr.mse).all())
        return pl

    variants = CPADMM_VARIANTS if len(shape) == 1 else [(True, True), (False, False)]
    for fused, rfft in variants:
        run(f"cpadmm/{fused}/{rfft}", "cpadmm", ITERS, fused=fused, rfft=rfft)
    run("cpadmm/overlap3/kernel-tail", "cpadmm", ITERS, rfft=True, overlap=3, tail="kernel")
    run("ista", "ista", ITERS, rfft=True)
    if len(shape) == 1:
        run("fista", "fista", FISTA_ITERS, rfft=True)
    out["bf16/wire"] = run("cpadmm/bf16", "cpadmm", ITERS, rfft=True, wire_dtype="bf16").wire_dtype

    pl = mk(rfft=True)
    x, used = solve_until(prob, "cpadmm", tol=TOL, max_iters=3000, plan=pl, **KW)
    out["until"], out["until/used"] = pl.gather_batch(x), pl.gather_batch(used)

    # the wire guard: a bound below bf16's error, and an fp16 overflow
    bound = plan_mod.WIRE_ERROR_BOUND
    plan_mod.WIRE_ERROR_BOUND = 1e-9
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["guard/wire"] = mk(rfft=True, wire_dtype="bf16").wire_dtype
    plan_mod.WIRE_ERROR_BOUND = bound
    big = interop.partial_circulant_from_numpy(a["col"] * 1e9, a["spec"] * 1e9, a["omega"],
                                               device="cpu")
    with warnings.catch_warnings(record=True) as caught_big:
        warnings.simplefilter("always")
        out["overflow/wire"] = plan(big, mesh, n1=N1, n2=N2, wire_dtype="fp16").wire_dtype
    out["guard/warned"] = [str(w.message) for w in caught + caught_big
                           if issubclass(w.category, RuntimeWarning)]

    # checkpoints: the port's own resume, and a resume from the reference's file
    pl = mk(rfft=True)
    save = lambda d: (lambda s, st: ckpt.save(d, s, st, plan=pl))
    x_full, _ = solve_checkpointed(prob, "cpadmm", iters=200, chunk=100, save_cb=save(dirs["port"]),
                                   plan=pl, **KW)
    like = make_stepper(prob, "cpadmm", plan=pl, **KW).init()
    step, st = ckpt.restore(dirs["port"], 100, like, plan=pl)
    x_res, _ = solve_checkpointed(prob, "cpadmm", iters=200, chunk=100, restore=(step, st),
                                  plan=pl, **KW)
    out["ckpt/resumed-equal"] = torch.equal(x_res, x_full)
    out["ckpt/global100"] = pl.global_state(st)._asdict()
    step, s_ref = ckpt.restore(dirs["ref"], None, like, plan=pl)
    x_a, _ = solve_checkpointed(prob, "cpadmm", iters=200, chunk=100, restore=(step, s_ref),
                                plan=pl, **KW)
    ckpt.save(dirs["port2"], step, s_ref, plan=pl)
    step2, s2 = ckpt.restore(dirs["port2"], None, like, plan=pl)
    x_b, _ = solve_checkpointed(prob, "cpadmm", iters=200, chunk=100, restore=(step2, s2),
                                plan=pl, **KW)
    out["ckpt/ref-resume"] = pl.gather_batch(x_a)
    out["ckpt/ref-resume-equal"] = step == step2 == 100 and torch.equal(x_a, x_b)
    # the same state carried by interop instead of a file
    s_num = interop.dist_cpadmm_state_from_numpy(*a["state100"], pl, device="cpu")
    x_c, _ = solve_checkpointed(prob, "cpadmm", iters=200, chunk=100, restore=(100, s_num),
                                plan=pl, **KW)
    out["interop/state-resume-equal"] = torch.equal(x_c, x_a)

    # a plan from the reference's global spectrum and mask, cut by interop
    spec, mask = interop.plan_parts_from_numpy(a["spec2d"], a["mask2d"], mesh, device="cpu")
    parts = plan_mod.plan_from_parts(mesh, spec, mask, n1=N1, n2=N2, rfft=True,
                                     batch_axis=batch_axis)
    x, _ = solve(prob, "cpadmm", iters=ITERS, plan=parts, **KW)
    out["parts"] = parts.gather_batch(x)

    # deblur-aware plan defaults: the frame's own grid, frames on the data axis
    g = torch.Generator().manual_seed(5)
    frames = torch.stack([starfield(g, 16, 32, device="cpu") for _ in range(B)])
    dp = build_multiframe_deblur_problem(g, frames, blur_order=3, sensing="romberg")
    dprob = RecoveryProblem(op=dp.op, y=dp.y, x_true=frames.reshape(B, -1))
    dpl = build_deblur_plan(dp, mesh, rfft=True)
    x_mesh, _ = solve(dprob, "cpadmm", iters=100, plan=dpl, **KW)
    x_loc, _ = solve(dprob, "cpadmm", iters=100, record_every=100, plan=plan(dp.op), **KW)
    out["deblur/layout"] = (dpl.n1, dpl.n2, dpl.batch_axis)
    out["deblur/rel"] = _rel(dpl.gather_batch(x_mesh), x_loc)

    try:
        make_mesh((3,) + shape, ("x",) + names)
    except ValueError as e:
        out["mismatch"] = str(e)
    return out if torch.distributed.get_rank() == 0 else None


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference problem (B = 4 signals), its single-device answers, and
    a reference-written checkpoint of the mesh state at iteration 100."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.ckpt import checkpoint as ref_ckpt
    from repro.core import RecoveryProblem, solve, solve_checkpointed, solve_until
    from repro.core.circulant import PartialCirculant, gaussian_circulant
    from repro.data.synthetic import paper_regime, sparse_signal
    from repro.dist.fft import layout_2d
    from repro.dist.recovery import DistCpadmmState
    from repro.ops.spectral import spectrum_layout_2d

    x_true = sparse_signal(jax.random.PRNGKey(0), N, paper_regime(N)[1], batch=(B,))
    C = gaussian_circulant(jax.random.PRNGKey(1), N, normalize=True)
    omega = jnp.sort(jax.random.permutation(jax.random.PRNGKey(2), N)[:paper_regime(N)[0]])
    op = PartialCirculant(C, omega.astype(jnp.int32))
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    solved = lambda m, it: np.asarray(solve(prob, m, iters=it, record_every=it, **KW)[0])
    x_until, used = solve_until(prob, "cpadmm", tol=TOL, max_iters=3000, **KW)
    saved = {}
    x200, _ = solve_checkpointed(prob, "cpadmm", iters=200, chunk=100,
                                 save_cb=lambda s, st: saved.__setitem__(s, st), **KW)
    root = tmp_path_factory.mktemp("dist_ckpt")
    state100 = DistCpadmmState(*(layout_2d(leaf, N1, N2) for leaf in saved[100]))
    ref_ckpt.save(str(root / "ref"), 100, jax.device_get(state100))
    mask = jnp.zeros((N,), jnp.float32).at[omega].set(1.0)
    return dict(
        arrays=dict(col=np.asarray(C.col), spec=np.asarray(C.spec), omega=np.asarray(omega),
                    y=np.asarray(prob.y), x_true=np.asarray(x_true),
                    state100=[np.asarray(leaf) for leaf in state100],
                    spec2d=np.asarray(spectrum_layout_2d(C.spec, N1, N2, rfft=True, p=2)),
                    mask2d=np.asarray(layout_2d(mask, N1, N2))),
        cpadmm=solved("cpadmm", ITERS), ista=solved("ista", ITERS),
        fista=solved("fista", FISTA_ITERS), until=np.asarray(x_until),
        until_used=np.asarray(used), x200=np.asarray(x200), root=root,
        ref_ckpt=ref_ckpt, state_type=DistCpadmmState,
    )


MESHES = {"2": (2,), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def runs(ref):
    out = {}
    for key, shape in MESHES.items():
        dirs = {d: str(ref["root"] / f"{key}-{d}") for d in ("port", "port2")}
        dirs["ref"] = str(ref["root"] / "ref")
        out[key] = spawn_fake_devices(int(np.prod(shape)), _mesh_program,
                                      ref["arrays"], shape, dirs)[0]
        out[key]["dirs"] = dirs
    return out


@pytest.mark.parametrize("fused,rfft", CPADMM_VARIANTS)
def test_mesh_cpadmm_matches_single_device_reference(fused, rfft, runs, ref):
    r = runs["2"]
    assert _rel(r[f"cpadmm/{fused}/{rfft}"], ref["cpadmm"]) <= 1e-5
    assert r[f"cpadmm/{fused}/{rfft}/finite"]


@pytest.mark.parametrize("fused,rfft", [(True, True), (False, False)])
def test_2x2_mesh_with_batch_on_data_axis_matches_reference(fused, rfft, runs, ref):
    r = runs["2x2"]
    assert r[f"cpadmm/{fused}/{rfft}"].shape == (B, N)
    assert _rel(r[f"cpadmm/{fused}/{rfft}"], ref["cpadmm"]) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_overlap_and_kernel_tail_match_reference(mesh, runs, ref):
    assert _rel(runs[mesh]["cpadmm/overlap3/kernel-tail"], ref["cpadmm"]) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_cpista_matches_reference(mesh, runs, ref):
    assert _rel(runs[mesh]["ista"], ref["ista"]) <= 1e-5


def test_mesh_fista_matches_reference_at_convergence(runs, ref):
    assert _rel(runs["2"]["fista"], ref["fista"]) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_solve_until_gives_the_reference_counts(mesh, runs, ref):
    r = runs[mesh]
    np.testing.assert_array_equal(np.asarray(r["until/used"]), ref["until_used"])
    assert _rel(r["until"], ref["until"]) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bf16_wire_solve_is_within_the_guard_bound(mesh, runs):
    from repro_torch.ops.plan import WIRE_ERROR_BOUND

    r = runs[mesh]
    assert r["bf16/wire"] == "bf16"
    assert 0.0 < _rel(r["cpadmm/bf16"], r["cpadmm/True/True"]) <= WIRE_ERROR_BOUND


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_wire_guard_falls_back_to_fp32_with_a_warning(mesh, runs):
    r = runs[mesh]
    assert r["guard/wire"] == "fp32" and r["overflow/wire"] == "fp32"
    assert len(r["guard/warned"]) == 2
    assert all("failed the precision guard" in m for m in r["guard/warned"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_checkpoint_resumes_bit_equal(mesh, runs):
    assert runs[mesh]["ckpt/resumed-equal"]
    assert runs[mesh]["ckpt/ref-resume-equal"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_interop_carries_the_reference_state_and_plan_parts(mesh, runs, ref):
    """A global state of the reference reaches each rank's blocks through
    interop and resumes as the same file would; a plan from the reference's
    global spectrum and mask (``plan_from_parts``) solves as ``plan`` does."""
    r = runs[mesh]
    assert r["interop/state-resume-equal"]
    assert _rel(r["parts"], ref["cpadmm"]) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_checkpoints_cross_between_the_packages(mesh, runs, ref):
    """The port writes the global (B, n1, n2) state in the reference's npz
    format: the reference restores it bit for bit; and the port, resumed
    from the reference's own checkpoint, finishes the reference's run."""
    r = runs[mesh]
    like = ref["state_type"](*(np.zeros((B, N1, N2), np.float32) for _ in range(5)))
    step, state = ref["ref_ckpt"].restore(r["dirs"]["port"], 100, like)
    assert step == 100
    for key, leaf in state._asdict().items():
        np.testing.assert_array_equal(np.asarray(leaf), r["ckpt/global100"][key].numpy())
    assert _rel(r["ckpt/ref-resume"], ref["x200"]) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_deblur_plan_takes_the_frame_grid_and_the_data_axis(mesh, runs):
    r = runs[mesh]
    assert r["deblur/layout"] == (16, 32, None if mesh == "2" else "data")
    assert r["deblur/rel"] <= 1e-5


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_world_size_that_does_not_match_the_mesh_raises(mesh, runs):
    assert "ranks, but the world has" in runs[mesh]["mismatch"]


@pytest.mark.parametrize("config,ref_config", [
    (dict(tail="pallas"), dict(tail="kernel")),  # each package's tail names
    (dict(overlap=0), dict(overlap=0)),
    (dict(overlap=1.5), dict(overlap=1.5)),
    (dict(wire_dtype="int8"), dict(wire_dtype="int8")),
    (dict(wire_dtype="bf16"), dict(wire_dtype="bf16")),
    (dict(rfft=True), dict(rfft=True)),
    (dict(overlap=2), dict(overlap=2)),
    (dict(batch_axis="data"), dict(batch_axis="data")),
    (dict(n1=0), dict(n1=0)),
    (dict(prox=object()), dict(prox=object())),
])
def test_plan_config_validate_raises_where_the_reference_raises(config, ref_config):
    pytest.importorskip("jax")
    from repro.ops import PlanConfig as RefPlanConfig

    with pytest.raises(ValueError):
        RefPlanConfig(**ref_config).validate(distributed=False)
    with pytest.raises(ValueError):
        PlanConfig(**config).validate(distributed=False)


def test_plan_config_takes_the_reference_distributed_knobs():
    pytest.importorskip("jax")
    from repro.ops import PlanConfig as RefPlanConfig

    knobs = dict(rfft=True, overlap=3, fused=False, batch_axis="data", n1=N1, n2=N2,
                 wire_dtype="fp16")
    assert PlanConfig(**knobs).validate(distributed=True)
    assert RefPlanConfig(**knobs).validate(distributed=True)


def test_mesh_needs_a_card_unless_told_cpu(monkeypatch):
    """With no launcher and no ``device="cpu"``, joining a mesh needs CUDA:
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if torch.distributed.is_initialized():
        pytest.skip("this process already joined a process group")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1,), ("model",))
    assert not torch.distributed.is_initialized()
    assert "RANK" not in os.environ


def _cli(capfd, *args) -> str:
    from repro_torch.launch import recover

    recover.main(["--device", "cpu", *args])
    return capfd.readouterr().out


def _after(text: str, marker: str) -> str:
    return text.split(marker)[-1].splitlines()[0]


def test_cli_mesh_run_resumes_and_matches_the_local_run(capfd, tmp_path):
    """``recover --mesh 2 --fake-devices 2 --device cpu`` runs, resumes from its
    (global) checkpoint, and reports what the one-device run reports."""
    common = ["--n", "1024", "--batch", "4", "--chunk", "30"]
    first = _cli(capfd, *common, "--iters", "60", "--mesh", "2", "--fake-devices", "2",
                 "--ckpt-dir", str(tmp_path / "mesh"))
    second = _cli(capfd, *common, "--iters", "90", "--mesh", "2", "--fake-devices", "2",
                  "--ckpt-dir", str(tmp_path / "mesh"))
    local = _cli(capfd, *common, "--iters", "90", "--ckpt-dir", str(tmp_path / "local"))
    assert "mesh=2" in first and "resumed" not in first
    assert "resumed from iteration 60" in second
    assert _after(second, "per-signal MSE:") == _after(local, "per-signal MSE:")


def test_cli_2x2_deblur_runs_and_resumes(capfd, tmp_path):
    args = ["--deblur", "--size", "32", "--batch", "4", "--mesh", "2x2", "--fake-devices", "4",
            "--rfft", "--wire-dtype", "bf16", "--iters", "100", "--chunk", "50",
            "--ckpt-dir", str(tmp_path / "ck")]
    first, second = _cli(capfd, *args), _cli(capfd, *args)
    assert "mesh=2x2" in first and "resumed" not in first
    assert "resumed from iteration 100" in second
    psnr = [float(ln.split("PSNR")[1].split()[0]) for ln in second.splitlines() if "PSNR" in ln]
    assert len(psnr) == 4 and all(v > 30.0 for v in psnr), psnr


def test_cli_mesh_tolerance_mode_gives_the_local_counts(capfd, tmp_path):
    args = ["--n", "1024", "--batch", "4", "--tol", "1e-5", "--iters", "2000"]
    mesh = _cli(capfd, *args, "--mesh", "2", "--fake-devices", "2")
    local = _cli(capfd, *args)
    assert _after(mesh, "per-signal iterations:") == _after(local, "per-signal iterations:")


@pytest.mark.parametrize("fake", [[], ["--fake-devices", "2"]])
def test_cli_mesh_without_a_card_raises_unless_told_cpu(fake, monkeypatch, tmp_path):
    from repro_torch.launch import recover

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recover.main(["--n", "256", "--iters", "10", "--mesh", "2", *fake,
                      "--ckpt-dir", str(tmp_path / "ck")])
    assert not torch.distributed.is_initialized()
