#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each unguarded (any failure ends the run with a non-zero code and
no result line):

0. the card's name and power limit, torch / CUDA / Triton versions;
1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time kernel, plain version, the
   library yardstick where one exists, against the kernel's bound;
3. Path A — paper Sec. 7 at the paper's frame size: 4 starfield frames of
   1024x1024 (n = 2^20), order-5 moving-average blur, romberg sensing,
   m = n/2, 600 CPADMM iterations, once on the kernels (tail='kernel') and
   once on the plain step (tail='plain');
4. Path B — paper Sec. 6 below the direct-matvec crossover: n = 16384,
   8 signals, m = n/2, k = n/10, 400 CPADMM iterations, once on the kernels
   and once on the plain step; every signal must reach MSE <= 1e-4 and the
   two x-hats must agree;
5. Path C — CPISTA (paper Alg. 1 with Algs. 7-8) in the same Sec. 6 regime:
   n = 16384, 8 signals, 400 ISTA iterations on the kernels (both direct
   matvecs and the fused soft threshold) and on the plain step; the two
   x-hats must agree and every signal's LASSO objective must fall;
6. the recovery CLI (``python -m repro_torch.launch.recover``) as a user
   runs it: a checkpointed CPADMM run at its default n = 65536, B = 4, run
   a second time to resume from the checkpoint, then a Sec. 7 deblur run of
   two 512x512 frames in tolerance mode;
7. one JSON line with every kernel's launches, error and times, then the
   device line ``{"ok": true, "device": {...}}`` last.

Launch counters are zeroed just before each driven path and read just
after; the comparison launches of phase 2 do not count.  Two kernels have
no caller on any path (the reference calls them only from its tests): the
ADMM soft threshold and the banded blur, held against their plain
versions in phase 2 only.  Exits non-zero
when CUDA is unavailable or the port's sources are not beside this file.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores

# Tolerances, norm-relative (max |kernel - plain| / max |plain|):
#  * elementwise kernels: fp32, same operations, but the compiler may fuse a
#    multiply-add into one rounding -> a few ulps (2^-24 ~ 6e-8 each).
#  * direct matvec: a sum of n = 16384 fp32 products in another order than
#    cuBLAS's; rounding grows like sqrt(n) * 2^-24 ~ 8e-6 typically.
#  * banded blur: a sum of L <= 17 products, fused multiply-adds against the
#    plain version's separate roundings, and the FFT route's O(log n) ulps.
TOL_ELEMENTWISE = 1e-6
TOL_MATVEC = 5e-5
TOL_BLUR = 1e-5
TOL_PATHS = 1e-4  # kernel-step vs plain-step solves, relative in x-hat
PAPER_TARGET_MSE = 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


SPIN_CYCLES = 400_000_000  # ~0.2 s of device spin at H100 clocks


def timed(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``, over ``iters`` calls.

    A device spin is queued first, so the host enqueues every call before
    the first one runs: the CUDA events then time the device alone, back to
    back, and the host clock times the launch path alone (wrapper checks,
    Triton / ctypes launch, torch dispatch).  Fails if the host took longer
    than the spin, which would let host gaps into the device time; keep
    ``iters`` x launches per call well under the CUDA launch queue's depth, or
    the host blocks on the full queue until the spin ends.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= 0.9 * spin.elapsed_time(start):
        fail(f"host enqueue ({host_ms:.1f} ms) outlasted the device spin; raise SPIN_CYCLES")
    return start.elapsed_time(end) / iters, host_ms / iters


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, norm-relative error) of ``got`` against ``want``."""
    diff = (got - want).abs().max().item()
    return diff, diff / max(want.abs().max().item(), 1e-30)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_shape(name, label, kern, plain, tol, nbytes, flops, library=None, plain_iters=20):
    """One kernel at one shape: error against its plain version, and times."""
    import torch

    got, want = kern(), plain()
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    err = max((rel_err(g, w) for g, w in zip(got, want)), key=lambda e: e[1])
    r = dict(shape=label, err=err, tol=tol, ms=timed(kern),
             plain_ms=timed(plain, iters=plain_iters),
             library_ms=None if library is None else timed(library),
             bound=bound(nbytes, flops))
    lib = "none" if r["library_ms"] is None else f"{r['library_ms'][0]:.4f}"
    print(f"{name} [{label}]: max abs err {err[0]:.3e}, norm-rel {err[1]:.3e} "
          f"(tol {tol:.0e}); device ms: kernel {r['ms'][0]:.4f}, plain "
          f"{r['plain_ms'][0]:.4f}, library {lib}, bound {r['bound'][0]:.4f} "
          f"({r['bound'][1]}); host ms per call: kernel {r['ms'][1]:.4f}, plain "
          f"{r['plain_ms'][1]:.4f}")
    if not err[1] <= tol:
        fail(f"{name} [{label}] disagrees with its plain version: {err}")
    return r


def check_kernels(dev, gen) -> dict:
    """Phase 2: every kernel against its plain version at the shapes that
    Paths A-C and the CLI give it (and, for the two kernels no path calls, at
    the Sec. 6 and Sec. 7 sizes); per kernel, a list of per-shape results."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.circulant import moving_average_blur
    from repro_torch.kernels.banded_conv.ops import blur_apply
    from repro_torch.kernels.banded_conv.ref import banded_circulant_matvec_ref
    from repro_torch.kernels.circulant_matvec.ops import circulant_matvec_direct
    from repro_torch.kernels.circulant_matvec.ref import (
        circulant_matvec_fft,
        circulant_matvec_ref,
    )
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.cpadmm_tail.ref import cpadmm_tail_ref
    from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
    from repro_torch.kernels.soft_threshold.ref import (
        admm_threshold_dual_update_ref,
        ista_threshold_update_ref,
    )
    from repro_torch.kernels.spectral_pointwise.ops import spectral_update
    from repro_torch.kernels.spectral_pointwise.ref import cpadmm_spectral_update_ref

    rnd = lambda *shape, dtype=torch.float32: torch.randn(
        *shape, generator=gen, device=dev, dtype=dtype
    )
    results = {name: [] for name in KERNEL_SOURCES}

    # spectral_pointwise over the half spectrum: Path A nf = 2^19 + 1 (B = 4
    # frames), Path B nf = 8193 (B = 8 signals); both ragged against any block
    for path, nf, B in (("A", 2**19 + 1, 4), ("B", 8193, 8)):
        c = rnd(nf, dtype=torch.complex64)
        vm, zn = rnd(B, nf, dtype=torch.complex64), rnd(B, nf, dtype=torch.complex64)
        args = (c, torch.rand(nf, generator=gen, device=dev), vm, zn, 0.01, 0.01)
        results["spectral_pointwise"].append(check_shape(
            "spectral_pointwise", f"path {path}: nf={nf} B={B}",
            lambda a=args: spectral_update(*a), lambda a=args: cpadmm_spectral_update_ref(*a),
            TOL_ELEMENTWISE, 8 * nf + 4 * nf + B * 24 * nf, B * nf * 12,
        ))

    # cpadmm_tail: Path A L = 2^20 (B = 4), Path B L = 16384 (B = 8); both
    # paths give it a per-signal pty; the shared layout is checked at Path A
    scal = (0.01, 0.1, 1.0, 1.0)
    for path, L, B, layout in (("A", 2**20, 4, "batched"), ("A", 2**20, 4, "shared"),
                               ("B", 16384, 8, "batched")):
        pty = rnd(B, L) if layout == "batched" else rnd(L)
        args = (*(rnd(B, L) for _ in range(2)), torch.rand(L, generator=gen, device=dev),
                pty, *(rnd(B, L) for _ in range(2)), *scal)
        results["cpadmm_tail"].append(check_shape(
            "cpadmm_tail", f"path {path}: L={L} B={B} pty={layout}",
            lambda a=args: fused_cpadmm_tail(*a), lambda a=args: cpadmm_tail_ref(*a),
            TOL_ELEMENTWISE, 4 * L + 4 * pty.numel() + 32 * B * L, B * L * 12,
        ))

    # circulant_matvec at Path B's shape, n = 16384, B = 8 (Path A's n = 2^20
    # takes the FFT branch); forward is the main path's, transpose checked too
    n, B = 16384, 8
    col, xs = rnd(n), rnd(B, n)
    for transpose in (False, True):
        results["circulant_matvec"].append(check_shape(
            "circulant_matvec", f"path B: n={n} B={B} transpose={transpose}",
            lambda t=transpose: circulant_matvec_direct(col, xs, transpose=t),
            lambda t=transpose: circulant_matvec_ref(col, xs, transpose=t),
            TOL_MATVEC, 4 * n + 8 * B * n, 2 * B * n * n,
            library=lambda t=transpose: circulant_matvec_fft(col, xs, transpose=t),
            plain_iters=5,
        ))
    # where the direct kernel and the FFT path cross on this card (the
    # dispatch's FFT_CROSSOVER = 2^15 was chosen for the TPU)
    for n_s in (1024, 2048, 4096, 8192):
        col_s, xs_s = rnd(n_s), rnd(B, n_s)
        print(f"crossover n={n_s} B={B}: device ms direct "
              f"{timed(lambda: circulant_matvec_direct(col_s, xs_s))[0]:.4f}, fft path "
              f"{timed(lambda: circulant_matvec_fft(col_s, xs_s))[0]:.4f}")

    # the soft-threshold kernels: Path C's shape (n = 16384, B = 8), the
    # CLI's default (n = 65536, B = 4) and a ragged length; the threshold is
    # a one-element tensor on the card, as CPISTA passes alpha * tau (a Python
    # number would add a one-element fill launch to each call)
    gamma, tau2 = torch.tensor(0.05, device=dev), torch.tensor(1.0, device=dev)
    for label, n, B in (("path C", 16384, 8), ("CLI default", 65536, 4), ("ragged", 16383, 3)):
        x, other = rnd(B, n), rnd(B, n)
        results["soft_threshold_ista"].append(check_shape(
            "soft_threshold_ista", f"{label}: n={n} B={B}",
            lambda a=(x, other): fused_ista_update(*a, gamma),
            lambda a=(x, other): ista_threshold_update_ref(*a, gamma),
            TOL_ELEMENTWISE, 12 * B * n, 3 * B * n,
            # no one PyTorch call computes eta(x + delta): an add, then softshrink
            library=lambda a=(x, other): F.softshrink(a[0] + a[1], 0.05),
        ))
        results["soft_threshold_admm"].append(check_shape(
            "soft_threshold_admm", f"{label}: n={n} B={B}",
            lambda a=(x, other): fused_admm_update(*a, gamma, tau2),
            lambda a=(x, other): admm_threshold_dual_update_ref(*a, gamma, tau2),
            TOL_ELEMENTWISE, 16 * B * n, 6 * B * n,
        ))

    # the banded blur: the Sec. 7 frame (n = 2^20, B = 4, order-5 moving
    # average), random order-17 taps at n = 16384, B = 8, and a ragged n
    for label, n, B, L in (("Sec. 7 frame, moving average", 2**20, 4, 5),
                           ("random taps", 16384, 8, 17), ("ragged", 1000, 2, 5)):
        taps = torch.full((L,), 1.0 / L, device=dev) if L == 5 else rnd(L)
        x = rnd(B, n)
        results["banded_conv"].append(check_shape(
            "banded_conv", f"{label}: n={n} B={B} L={L}",
            lambda a=(taps, x, L): blur_apply(a[0], a[1], order=a[2]),
            lambda a=(taps, x, L): banded_circulant_matvec_ref(a[0], a[1], order=a[2]),
            TOL_BLUR, 8 * B * n + 4 * L, 2 * L * B * n,
            # a correlation, like the kernel: circular right pad, then conv1d
            library=lambda a=(taps, x, L): F.conv1d(
                F.pad(a[1][:, None], (0, a[2] - 1), mode="circular"), a[0][None, None])[:, 0],
            plain_iters=5,  # the plain version issues 3L + 1 launches per call
        ))
        if L == 5:  # the same blur by its circulant's FFT route
            err = rel_err(blur_apply(taps, x, order=L), moving_average_blur(n, L).matvec(x))
            print(f"banded_conv [{label}] vs moving_average_blur(n, 5).matvec: max abs err "
                  f"{err[0]:.3e}, norm-rel {err[1]:.3e} (tol {TOL_BLUR:.0e})")
            if not err[1] <= TOL_BLUR:
                fail(f"banded_conv disagrees with moving_average_blur at n={n}: {err}")
    return results


def _wrappers() -> dict:
    from repro_torch.kernels.banded_conv.ops import blur_apply
    from repro_torch.kernels.circulant_matvec.ops import circulant_matvec_direct
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
    from repro_torch.kernels.spectral_pointwise.ops import spectral_update

    return {
        "spectral_pointwise": spectral_update,
        "cpadmm_tail": fused_cpadmm_tail,
        "circulant_matvec": circulant_matvec_direct,
        "soft_threshold_ista": fused_ista_update,
        "soft_threshold_admm": fused_admm_update,
        "banded_conv": blur_apply,
    }


def zero_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def timed_solve(prob, plan, iters, record_every, method="cpadmm", **kw):
    """The solve a user calls, timed by the host clock to a synchronize."""
    import torch

    from repro_torch.core.solvers import solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, trace = solve(prob, method, iters=iters, record_every=record_every, plan=plan, **kw)
    torch.cuda.synchronize()
    return x, trace, (time.perf_counter() - t0) * 1e3 / iters


def step_times(prob, plan, method="cpadmm", **kw) -> tuple[float, float]:
    """(device ms, host ms) of one solver step in steady state: how long the
    card is busy per iteration, and how long the host takes to issue it."""
    from repro_torch.core.solvers import make_stepper

    stepper = make_stepper(prob, method, plan=plan, **kw)
    state = [stepper.init()]

    def one():
        state[0] = stepper.step(state[0])

    return timed(one, iters=5)  # a plain step issues ~25 launches


def path_a(dev, gen, size=1024, frames=4, iters=600) -> dict:
    """Paper Sec. 7 deblurring at the Abell-2744 frame size."""
    import torch

    from repro_torch.core.deblur import (
        blurred_observation,
        build_deblur_plan,
        build_multiframe_deblur_problem,
        deblur_metrics,
    )
    from repro_torch.core.solvers import RecoveryProblem
    from repro_torch.data.synthetic import starfield

    images = torch.stack([starfield(gen, size, size, device=dev) for _ in range(frames)])
    p = build_multiframe_deblur_problem(gen, images, blur_order=5, sensing="romberg")
    prob = RecoveryProblem(op=p.op, y=p.y, x_true=images.reshape(frames, -1))
    kw = dict(alpha=1e-3, rho=0.01, sigma=0.01)
    out = {}
    for tail in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        x, trace, ms_iter = timed_solve(prob, build_deblur_plan(p, tail=tail), iters, iters, **kw)
        counts = read_counts()
        out[tail] = dict(x=x, ms_iter=ms_iter, counts=counts,
                         psnr=deblur_metrics(p, x)["psnr_db"].tolist(),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        dev_ms, host_ms = step_times(prob, build_deblur_plan(p, tail=tail), **kw)
        print(f"Path A tail={tail}: {size}x{size} x {frames} frames, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock), per step device {dev_ms:.4f} ms / "
              f"host issue {host_ms:.4f} ms, peak memory {out[tail]['peak_gib']:.3f} GiB, "
              f"launches {counts}, PSNR dB {out[tail]['psnr']}")
    blurred = deblur_metrics(p, blurred_observation(p).reshape(frames, -1))["psnr_db"].tolist()
    xk, xp = out["kernel"]["x"], out["plain"]["x"]
    diff = ((xk - xp).norm() / xp.norm()).item()
    print(f"Path A: kernel vs plain x-hat norm-rel diff {diff:.3e} (tol {TOL_PATHS:.0e}); "
          f"blurred-observation PSNR dB {blurred}")
    if xk.shape != (frames, size * size) or not bool(torch.isfinite(xk).all()):
        fail(f"Path A result has shape {tuple(xk.shape)} or non-finite values")
    if not diff <= TOL_PATHS:
        fail(f"Path A kernel and plain solves disagree: {diff}")
    if not all(r > b for r, b in zip(out["kernel"]["psnr"], blurred)):
        fail("Path A recovery is no sharper than the blurred observation")
    want = dict.fromkeys(out["kernel"]["counts"], 0)
    want.update(spectral_pointwise=iters, cpadmm_tail=iters)
    if out["kernel"]["counts"] != want or any(out["plain"]["counts"].values()):
        fail(f"Path A launch counts {out['kernel']['counts']} (kernel) / "
             f"{out['plain']['counts']} (plain); expected {want} / none")
    return out


def path_b(dev, gen, n=16384, batch=8, iters=400) -> dict:
    """Paper Sec. 6 recovery below the direct-matvec crossover."""
    import torch

    from repro_torch.core.circulant import partial_gaussian_circulant
    from repro_torch.core.solvers import RecoveryProblem
    from repro_torch.data.synthetic import paper_regime, sparse_signal
    from repro_torch.ops.plan import plan

    m, k = paper_regime(n)
    x_true = sparse_signal(gen, n, k, batch=(batch,), device=dev)
    op = partial_gaussian_circulant(gen, n, m, normalize=True, device=dev)
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    kw = dict(alpha=1e-4, rho=0.01, sigma=0.01)
    out = {}
    for tail in ("kernel", "plain"):
        zero_counts()
        x, trace, ms_iter = timed_solve(prob, plan(op, tail=tail), iters, iters, **kw)
        counts = read_counts()
        mse = trace.mse[-1].tolist()
        out[tail] = dict(x=x, ms_iter=ms_iter, counts=counts, mse=mse)
        dev_ms, host_ms = step_times(prob, plan(op, tail=tail), **kw)
        print(f"Path B tail={tail}: n={n} B={batch} m={m} k={k}, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock), per step device {dev_ms:.4f} ms / "
              f"host issue {host_ms:.4f} ms, launches {counts}, MSE per signal {mse}")
        if x.shape != (batch, n) or not bool(torch.isfinite(x).all()):
            fail(f"Path B ({tail}) result has shape {tuple(x.shape)} or non-finite values")
        if not all(v <= PAPER_TARGET_MSE for v in mse):
            fail(f"Path B ({tail}): a signal misses MSE <= {PAPER_TARGET_MSE}: {mse}")
    xk, xp = out["kernel"]["x"], out["plain"]["x"]
    diff = ((xk - xp).norm() / xp.norm()).item()
    print(f"Path B: kernel vs plain x-hat norm-rel diff {diff:.3e} (tol {TOL_PATHS:.0e})")
    if not diff <= TOL_PATHS:
        fail(f"Path B kernel and plain solves disagree: {diff}")
    want = dict.fromkeys(out["kernel"]["counts"], 0)
    want.update(spectral_pointwise=iters, cpadmm_tail=iters, circulant_matvec=iters)
    if out["kernel"]["counts"] != want or any(out["plain"]["counts"].values()):
        fail(f"Path B launch counts {out['kernel']['counts']} (kernel) / "
             f"{out['plain']['counts']} (plain); expected {want} / none")
    return out


def path_c(dev, gen, n=16384, batch=8, iters=400) -> dict:
    """CPISTA (paper Alg. 1, Algs. 7-8) in the Sec. 6 regime, on both tails."""
    import torch

    from repro_torch.core.circulant import partial_gaussian_circulant
    from repro_torch.core.ista import lasso_objective
    from repro_torch.core.solvers import RecoveryProblem
    from repro_torch.data.synthetic import paper_regime, sparse_signal
    from repro_torch.ops.plan import plan

    m, k = paper_regime(n)
    x_true = sparse_signal(gen, n, k, batch=(batch,), device=dev)
    op = partial_gaussian_circulant(gen, n, m, normalize=True, device=dev)
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    kw = dict(method="ista", alpha=1e-4)  # tau: default_tau(op), 0.99 / ||A||^2
    obj0 = lasso_objective(op, prob.y, torch.zeros_like(x_true), kw["alpha"]).tolist()
    out = {}
    for tail in ("kernel", "plain"):
        zero_counts()
        x, trace, ms_iter = timed_solve(prob, plan(op, tail=tail), iters, iters, **kw)
        counts = read_counts()
        obj, mse = trace.objective[-1].tolist(), trace.mse[-1].tolist()
        out[tail] = dict(x=x, ms_iter=ms_iter, counts=counts, mse=mse)
        dev_ms, host_ms = step_times(prob, plan(op, tail=tail), **kw)
        print(f"Path C tail={tail}: CPISTA n={n} B={batch} m={m} k={k}, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock), per step device {dev_ms:.4f} ms / "
              f"host issue {host_ms:.4f} ms, launches {counts}, MSE per signal {mse}, "
              f"LASSO objective per signal {obj} (at x = 0: {obj0})")
        if x.shape != (batch, n) or not bool(torch.isfinite(x).all()):
            fail(f"Path C ({tail}) result has shape {tuple(x.shape)} or non-finite values")
        if not all(o < o0 for o, o0 in zip(obj, obj0)):
            fail(f"Path C ({tail}): a signal's LASSO objective did not fall: {obj} vs {obj0}")
    xk, xp = out["kernel"]["x"], out["plain"]["x"]
    diff = ((xk - xp).norm() / xp.norm()).item()
    print(f"Path C: kernel vs plain x-hat norm-rel diff {diff:.3e} (tol {TOL_PATHS:.0e})")
    if not diff <= TOL_PATHS:
        fail(f"Path C kernel and plain solves disagree: {diff}")
    want = dict.fromkeys(out["kernel"]["counts"], 0)
    want.update(circulant_matvec=2 * iters, soft_threshold_ista=iters)
    if out["kernel"]["counts"] != want or any(out["plain"]["counts"].values()):
        fail(f"Path C launch counts {out['kernel']['counts']} (kernel) / "
             f"{out['plain']['counts']} (plain); expected {want} / none")
    return out


def run_cli(args: list) -> str:
    """``python -m repro_torch.launch.recover *args`` in this process; its
    standard output, echoed."""
    from repro_torch.launch import recover

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        recover.main(args)
    out = buf.getvalue()
    print(f"$ python -m repro_torch.launch.recover {' '.join(args)}   "
          f"[{time.perf_counter() - t0:.2f} s]\n{out.rstrip()}")
    return out


def _floats(text: str) -> list:
    return [float(v) for v in re.findall(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|inf|nan)", text)]


def cli_phase() -> dict:
    """The recovery CLI as a user runs it, on the card: a checkpointed run,
    a resume from its checkpoint, and a Sec. 7 deblur run."""
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    zero_counts()
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
        args = ["--n", "65536", "--batch", "4", "--method", "cpadmm", "--iters", "200",
                "--chunk", "100", "--ckpt-dir", ckpt_dir]
        first, second = run_cli(args), run_cli(args)
    deblur = run_cli(["--deblur", "--size", "512", "--batch", "2", "--tol", "1e-4",
                      "--iters", "400"])
    counts = read_counts()
    if "resumed" in first or "resumed from iteration 200" not in second:
        fail("CLI: the second checkpointed run did not resume from iteration 200")
    mse = _floats(second.split("per-signal MSE:")[-1])
    if len(mse) != 4 or not all(math.isfinite(v) for v in mse):
        fail(f"CLI: per-signal MSE after the resume is {mse}")
    psnr = [_floats(ln.split("PSNR")[1])[0] for ln in deblur.splitlines() if "PSNR" in ln]
    if len(psnr) != 2 or not all(math.isfinite(v) and v > 0 for v in psnr):
        fail(f"CLI: per-frame PSNR of the deblur run is {psnr}")
    # the CLI builds plan(op) with the default tail, the plain step
    if any(counts.values()):
        fail(f"CLI: kernel launches {counts} on the plain step")
    return dict(counts=counts, mse=mse, psnr=psnr)


KERNEL_SOURCES = {
    "spectral_pointwise": ("triton", "src/repro_torch/kernels/spectral_pointwise/kernel.py",
                           "src/repro/kernels/spectral_pointwise/kernel.py:50"),
    "cpadmm_tail": ("triton", "src/repro_torch/kernels/cpadmm_tail/kernel.py",
                    "src/repro/kernels/cpadmm_tail/kernel.py:55"),
    "circulant_matvec": ("cuda", "src/repro_torch/csrc/circulant_matvec.cu",
                         "src/repro/kernels/circulant_matvec/kernel.py:111"),
    "soft_threshold_ista": ("triton", "src/repro_torch/kernels/soft_threshold/kernel.py",
                            "src/repro/kernels/soft_threshold/kernel.py:41"),
    "soft_threshold_admm": ("triton", "src/repro_torch/kernels/soft_threshold/kernel.py",
                            "src/repro/kernels/soft_threshold/kernel.py:68"),
    "banded_conv": ("cuda", "src/repro_torch/csrc/banded_conv.cu",
                    "src/repro/kernels/banded_conv/kernel.py:40"),
}
# the PyTorch call timed as each kernel's library_ms (never used by the port)
LIBRARY_CALLS = {
    "spectral_pointwise": None,
    "cpadmm_tail": None,
    "circulant_matvec": "torch.fft path (rfft, product, irfft)",
    "soft_threshold_ista": "F.softshrink(x + delta, gamma): two launches, no one call fuses it",
    "soft_threshold_admm": None,
    "banded_conv": "F.conv1d on a circular right pad (a correlation, like the kernel)",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    triton = build.import_triton()

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain matvec is full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        print(Path(f"{lib}.log").read_text().strip())

    gen = torch.Generator(device=dev).manual_seed(0)
    checks = check_kernels(dev, gen)
    a = path_a(dev, torch.Generator().manual_seed(1))
    b = path_b(dev, torch.Generator().manual_seed(2))
    c = path_c(dev, torch.Generator().manual_seed(3))
    cli = cli_phase()
    by_path = {"A": a["kernel"]["counts"], "B": b["kernel"]["counts"],
               "C": c["kernel"]["counts"], "CLI": cli["counts"]}

    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        head = checks[name][0]  # the main path's largest shape for this kernel
        launches = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches.values()),
            "max_abs_err": max(r["err"][0] for r in checks[name]),
            "max_rel_err": max(r["err"][1] for r in checks[name]), "tol": head["tol"],
            "ms": head["ms"][0], "plain_ms": head["plain_ms"][0],
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "library_ms": None if head["library_ms"] is None else head["library_ms"][0],
            "library": LIBRARY_CALLS[name], "host_ms": head["ms"][1], "shape": head["shape"],
            "launches_by_path": launches,
            "shapes": [{
                "shape": r["shape"], "max_abs_err": r["err"][0], "max_rel_err": r["err"][1],
                "ms": r["ms"][0], "plain_ms": r["plain_ms"][0], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1],
                "library_ms": None if r["library_ms"] is None else r["library_ms"][0],
            } for r in checks[name]],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
