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
6. Path D1 — Path A's problem on a mesh of one rank (NCCL, world size 1):
   ``build_deblur_plan(p, make_mesh((1,), ("model",)), rfft=True,
   tail="kernel")``, 600 fused iterations with fp32 and with bf16 wires,
   held against Path A's kernel-step x-hat (the bf16 wire runs both
   ``wire_pack`` kernels around every transpose);
7. Path D2 — four gloo ranks sharing the card
   (``spawn_fake_devices(4, ..., device="cuda:0")``) on a 2x2 (data x
   model) mesh, the same problem at 200 iterations with ``overlap=2``, fp32
   and bf16 wires, held against a local kernel-step solve;
8. the recovery CLI (``python -m repro_torch.launch.recover``) as a user
   runs it: a checkpointed CPADMM run at its default n = 65536, B = 4, run
   a second time to resume from the checkpoint, a Sec. 7 deblur run of
   two 512x512 frames in tolerance mode, and a 2x2-mesh deblur run of four
   512x512 frames on four ranks sharing the card with bf16 wires, run twice
   to resume;
9. one JSON line with every kernel's launches, error and times, then the
   device line ``{"ok": true, "device": {...}}`` last.

Launch counters are zeroed just before each driven path and read just
after (inside each rank for Path D2); the comparison launches of phase 2
do not count.  Two kernels have
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
# a bf16-wire solve against its fp32 twin: the plan layer's own guard bound
# (repro_torch.ops.plan.WIRE_ERROR_BOUND), as the reference's
WIRE_ERROR_BOUND = 1e-2
SEC7_KW = dict(alpha=1e-3, rho=0.01, sigma=0.01)  # examples/deblur_astronomy.py


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
    check_wire(dev, gen, results)
    return results


def _special_values(z):
    """Overwrite a few entries with values the casts must round alike: infinities,
    fp16 overflow (65520 ties up to inf, 7e4, 1e30), fp16 subnormals, float32
    subnormals, and an underflow to zero."""
    import torch

    flat = torch.view_as_real(z).reshape(-1)
    vals = torch.tensor([float("inf"), -float("inf"), 65520.0, -7e4, 1e30, 6e-6, -3e-7,
                         1e-40, -2.5e-39, 1e-9, 65504.0, 0.0], device=z.device)
    flat[: vals.numel()] = vals
    return z


def check_wire(dev, gen, results) -> None:
    """pack_wire / unpack_wire against their plain versions, bit-exact, for the
    three wire dtypes, at the exchanges the mesh paths make and a ragged L =
    1000 holding special values.

    Path D1 (one rank) sends its stacked (2, 4, 1024, 513) payload whole.  A
    Path D2 rank (2 frames, 512 of the 1024 rows, 514 padded half-spectrum
    columns, model axis of 2, overlap 2) packs (2, 2, 256, 514) cut along its
    columns and unpacks the received chunks joined along the rows (forward
    transpose), and packs (2, 2, 1024, 129) cut along its rows, a ragged
    129-column chunk of its 257, and unpacks them joined along the columns
    (inverse transpose)."""
    import torch

    from repro_torch.kernels.wire_pack.ops import WIRE_DTYPES, pack_wire, unpack_wire
    from repro_torch.kernels.wire_pack.ref import pack_wire_ref, unpack_wire_ref

    # (label, payload shape, groups, pack axis, unpack axis)
    cases = (("path D1: (2, 4, 1024, 513), 1 rank", (2, 4, 1024, 513), 1, -1, -2),
             ("path D2 forward: (2, 2, 256, 514), 2 ranks", (2, 2, 256, 514), 2, -1, -2),
             ("path D2 inverse: (2, 2, 1024, 129), 2 ranks", (2, 2, 1024, 129), 2, -2, -1),
             ("ragged L=1000, special values", (1000,), None, -1, -1))
    for label, shape, groups, p_axis, u_axis in cases:
        z = torch.randn(*shape, generator=gen, device=dev, dtype=torch.complex64)
        if shape == (1000,):
            z = _special_values(z)
        n = z.numel()
        for wire in ("bf16", "fp16", "fp32"):  # the main path's wire first
            dt = WIRE_DTYPES[wire]
            pk = lambda z=z, w=wire: pack_wire(z, w, groups=groups, axis=p_axis)
            pr = lambda z=z, w=wire: pack_wire_ref(z, w, groups=groups, axis=p_axis)
            w_in = pr()
            uk = lambda w=w_in: unpack_wire(w, grouped=groups is not None, axis=u_axis)
            ur = lambda w=w_in: unpack_wire_ref(w, grouped=groups is not None, axis=u_axis)
            wire_bytes = 2 * n * dt.itemsize
            for name, kern, plain, lib in (
                ("pack_wire", pk, pr, lambda z=z, d=dt: torch.view_as_real(z).movedim(-1, 0).to(
                    d, memory_format=torch.contiguous_format, copy=True)),
                # the same bytes in the ungrouped layout: planes last, then complex
                ("unpack_wire", uk, ur, lambda w=w_in, a=int(groups is not None):
                    torch.view_as_complex(w.movedim(a, -1).to(
                        torch.float32, memory_format=torch.contiguous_format, copy=True))),
            ):
                got, want = kern(), plain()
                exact = torch.equal(got, want)
                r = dict(shape=f"{label}, {wire}", err=(0.0, 0.0) if exact else (math.inf,) * 2,
                         tol=0.0, ms=timed(kern), plain_ms=timed(plain),
                         library_ms=timed(lib),
                         bound=bound(8 * n + wire_bytes, 0.0))
                print(f"{name} [{r['shape']}]: bit-exact {exact}; device ms: kernel "
                      f"{r['ms'][0]:.4f}, plain {r['plain_ms'][0]:.4f}, library {r['library_ms'][0]:.4f}, "
                      f"bound {r['bound'][0]:.4f} ({r['bound'][1]}); host ms per call: kernel "
                      f"{r['ms'][1]:.4f}")
                if not exact:
                    fail(f"{name} [{r['shape']}] is not bit-equal to its plain version")
                results[name].append(r)


def flash_attention_bound() -> None:
    """The least time for the one unported TPU kernel, causal flash attention,
    at the shapes of tests/test_flash_attention.py: BH = 4, S = 768, D = 64,
    float32.  No run: the kernel waits for the LM substrate."""
    bh, s_len, d = 4, 768, 64
    nbytes = 4 * bh * s_len * d * 4  # q, k, v read once, o written once
    flops = 2 * 2 * bh * s_len * s_len * d / 2  # QK^T and PV, half the tiles causal
    t, by = bound(nbytes, flops)
    print(f"flash_attention (not ported) bound at BH={bh} S={s_len} D={d} causal fp32: "
          f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP -> {t:.4f} ms ({by})")


def _wrappers() -> dict:
    from repro_torch.kernels.banded_conv.ops import blur_apply
    from repro_torch.kernels.circulant_matvec.ops import circulant_matvec_direct
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
    from repro_torch.kernels.spectral_pointwise.ops import spectral_update
    from repro_torch.kernels.wire_pack.ops import pack_wire, unpack_wire

    return {
        "spectral_pointwise": spectral_update,
        "cpadmm_tail": fused_cpadmm_tail,
        "circulant_matvec": circulant_matvec_direct,
        "soft_threshold_ista": fused_ista_update,
        "soft_threshold_admm": fused_admm_update,
        "banded_conv": blur_apply,
        "pack_wire": pack_wire,
        "unpack_wire": unpack_wire,
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


def sec7_problem(dev, seed, size, frames):
    """Paper Sec. 7 at ``frames`` starfield frames of ``size`` x ``size``: an
    order-5 moving-average blur, romberg sensing, m = n/2; drawn from a CPU
    generator seeded ``seed``, so every rank builds the same problem."""
    import torch

    from repro_torch.core.deblur import build_multiframe_deblur_problem
    from repro_torch.core.solvers import RecoveryProblem
    from repro_torch.data.synthetic import starfield

    gen = torch.Generator().manual_seed(seed)
    images = torch.stack([starfield(gen, size, size, device=dev) for _ in range(frames)])
    p = build_multiframe_deblur_problem(gen, images, blur_order=5, sensing="romberg")
    return RecoveryProblem(op=p.op, y=p.y, x_true=images.reshape(frames, -1)), p


def path_a(dev, seed, size=1024, frames=4, iters=600) -> dict:
    """Paper Sec. 7 deblurring at the Abell-2744 frame size."""
    import torch

    from repro_torch.core.deblur import blurred_observation, build_deblur_plan, deblur_metrics

    prob, p = sec7_problem(dev, seed, size, frames)
    kw = SEC7_KW
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


def profile_steps(prob, plan, label, steps=5, **kw) -> None:
    """``torch.profiler`` over a few steady solver steps: the device's busy
    share of the window, device time by kernel name and the host ops that
    cost most, per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.solvers import make_stepper

    stepper = make_stepper(prob, "cpadmm", plan=plan, **kw)
    state = stepper.init()
    for _ in range(3):
        state = stepper.step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = stepper.step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device time from the kernel and copy records alone (an operator's record
    # repeats the time of the kernels it launched)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {label}: {steps} steps in {wall_ms / steps:.4f} ms/step (host clock), device "
          f"busy {busy / steps:.4f} ms/step ({100 * busy / wall_ms:.1f}% of the window)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  device {e.self_device_time_total / 1e3 / steps:.4f} ms/step  "
              f"x{e.count / steps:g}  {e.key[:90]}")
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host {e.self_cpu_time_total / 1e3 / steps:.4f} ms/step  x{e.count / steps:g}  "
              f"{e.key[:90]}")


def path_d1(dev, seed, x_a, size=1024, frames=4, iters=600) -> dict:
    """Path A's problem on a one-rank mesh over NCCL, fp32 and bf16 wires."""
    import torch

    from repro_torch.core.deblur import build_deblur_plan, deblur_metrics
    from repro_torch.dist.compat import make_mesh

    prob, p = sec7_problem(dev, seed, size, frames)
    mesh = make_mesh((1,), ("model",), device=dev)
    out = {}
    for wire in ("fp32", "bf16"):
        pl = build_deblur_plan(p, mesh, rfft=True, tail="kernel", wire_dtype=wire)
        if pl.wire_dtype != wire:
            fail(f"Path D1: the {wire} wire fell back to {pl.wire_dtype} in the plan's guard")
        zero_counts()
        x, _, ms_iter = timed_solve(prob, pl, iters, iters, **SEC7_KW)
        counts = read_counts()
        dev_ms, host_ms = step_times(prob, pl, **SEC7_KW)
        profile_steps(prob, pl, f"Path D1 wire={wire}", **SEC7_KW)
        diff = ((x - x_a).norm() / x_a.norm()).item()
        psnr = deblur_metrics(p, x)["psnr_db"].tolist()
        out[wire] = dict(x=x, ms_iter=ms_iter, counts=counts, diff=diff, psnr=psnr)
        print(f"Path D1 wire={wire}: mesh 1 (NCCL), n1 x n2 = {pl.n1} x {pl.n2}, rfft, fused, "
              f"{iters} iters, {ms_iter:.4f} ms/iter (solve, host clock), per step device "
              f"{dev_ms:.4f} ms / host issue {host_ms:.4f} ms, launches {counts}, PSNR dB "
              f"{psnr}, x-hat vs Path A kernel step norm-rel {diff:.3e}")
        if x.shape != x_a.shape or not bool(torch.isfinite(x).all()):
            fail(f"Path D1 ({wire}) result has shape {tuple(x.shape)} or non-finite values")
        tol = TOL_PATHS if wire == "fp32" else WIRE_ERROR_BOUND
        if not diff <= tol:
            fail(f"Path D1 ({wire}) disagrees with Path A: {diff} > {tol}")
        # 2 transposes per fused iteration, and 2 for the one metric record
        n_pack = 2 * iters + 2 if wire != "fp32" else 0
        want = dict.fromkeys(counts, 0)
        want.update(cpadmm_tail=iters, pack_wire=n_pack, unpack_wire=n_pack)
        if counts != want:
            fail(f"Path D1 ({wire}) launch counts {counts}; expected {want}")
    return out


def _d2_rank(seed, size, frames, iters):
    """One rank of Path D2: the 2x2 mesh solve at fp32 and bf16 wires; the
    gathered x-hat, this rank's launch counts and host ms per iteration."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.deblur import build_deblur_plan
    from repro_torch.dist.compat import make_mesh, rank_device

    dev = rank_device()
    prob, p = sec7_problem(dev, seed, size, frames)
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for wire in ("fp32", "bf16"):
        pl = build_deblur_plan(p, mesh, rfft=True, overlap=2, tail="kernel", wire_dtype=wire)
        zero_counts()
        dist.barrier()
        x, _, ms_iter = timed_solve(prob, pl, iters, iters, **SEC7_KW)
        out[wire] = dict(x=pl.gather_batch(x), counts=read_counts(), ms_iter=ms_iter,
                         wire=pl.wire_dtype, layout=(pl.n1, pl.n2, pl.batch_axis))
    return out


def path_d2(dev, seed, size=1024, frames=4, iters=200) -> dict:
    """Four gloo ranks sharing the card, against a local kernel-step solve."""
    import torch

    from repro_torch.core.deblur import build_deblur_plan
    from repro_torch.dist.compat import spawn_fake_devices

    prob, p = sec7_problem(dev, seed, size, frames)
    x_local, _, _ = timed_solve(prob, build_deblur_plan(p, tail="kernel"), iters, iters,
                                **SEC7_KW)
    t0 = time.perf_counter()
    ranks = spawn_fake_devices(4, _d2_rank, seed, size, frames, iters, device=str(dev))
    wall = time.perf_counter() - t0
    out = {"counts": {}}
    for wire in ("fp32", "bf16"):
        r0 = ranks[0][wire]
        x = r0["x"].to(dev)
        counts = {k: sum(r[wire]["counts"][k] for r in ranks) for k in r0["counts"]}
        diff = ((x - x_local).norm() / x_local.norm()).item()
        print(f"Path D2 wire={wire}: 4 gloo ranks on one card, mesh 2x2 (n1, n2, batch axis "
              f"{r0['layout']}), rfft, overlap 2, {iters} iters, {r0['ms_iter']:.4f} ms/iter on "
              f"rank 0 (host clock; gloo stages every exchange through the host), launches "
              f"summed over ranks {counts}, x-hat vs local kernel step norm-rel {diff:.3e}")
        if r0["wire"] != wire:
            fail(f"Path D2: the {wire} wire fell back to {r0['wire']} in the plan's guard")
        if x.shape != x_local.shape or not bool(torch.isfinite(x).all()):
            fail(f"Path D2 ({wire}) result has shape {tuple(x.shape)} or non-finite values")
        tol = TOL_PATHS if wire == "fp32" else WIRE_ERROR_BOUND
        if not diff <= tol:
            fail(f"Path D2 ({wire}) disagrees with the local solve: {diff} > {tol}")
        # per rank and iteration: 2 transposes of 2 overlap chunks; 4 more for the record
        n_pack = 4 * (4 * iters + 4) if wire != "fp32" else 0
        want = dict.fromkeys(counts, 0)
        want.update(cpadmm_tail=4 * iters, pack_wire=n_pack, unpack_wire=n_pack)
        if counts != want:
            fail(f"Path D2 ({wire}) launch counts {counts}; expected {want}")
        for k, v in counts.items():
            out["counts"][k] = out["counts"].get(k, 0) + v
    print(f"Path D2: four ranks started, ran both solves and stopped in {wall:.2f} s")
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


def run_cli_process(args: list) -> str:
    """``python -m repro_torch.launch.recover *args`` as its own process (its
    ranks print from child processes); its standard output, echoed."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.recover", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    print(f"$ python -m repro_torch.launch.recover {' '.join(args)}   "
          f"[{time.perf_counter() - t0:.2f} s, exit {proc.returncode}]\n{proc.stdout.rstrip()}")
    if proc.returncode != 0:
        fail(f"CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


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
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
        args = ["--deblur", "--size", "512", "--batch", "4", "--mesh", "2x2", "--fake-devices",
                "4", "--rfft", "--wire-dtype", "bf16", "--iters", "200", "--chunk", "100",
                "--ckpt-dir", ckpt_dir]
        mesh_first, mesh_second = run_cli_process(args), run_cli_process(args)
    if "resumed" in mesh_first or "resumed from iteration 200" not in mesh_second:
        fail("CLI: the second 2x2-mesh run did not resume from iteration 200")
    mesh_psnr = [_floats(ln.split("PSNR")[1])[0] for ln in mesh_second.splitlines()
                 if "PSNR" in ln]
    if len(mesh_psnr) != 4 or not all(math.isfinite(v) and v > 0 for v in mesh_psnr):
        fail(f"CLI: per-frame PSNR of the 2x2-mesh deblur run is {mesh_psnr}")
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
    "pack_wire": ("triton", "src/repro_torch/kernels/wire_pack/kernel.py",
                  "src/repro/kernels/wire_pack/kernel.py:45"),
    "unpack_wire": ("triton", "src/repro_torch/kernels/wire_pack/kernel.py",
                    "src/repro/kernels/wire_pack/kernel.py:73"),
}
# the PyTorch call timed as each kernel's library_ms (never used by the port)
LIBRARY_CALLS = {
    "spectral_pointwise": None,
    "cpadmm_tail": None,
    "circulant_matvec": "torch.fft path (rfft, product, irfft)",
    "soft_threshold_ista": "F.softshrink(x + delta, gamma): two launches, no one call fuses it",
    "soft_threshold_admm": None,
    "banded_conv": "F.conv1d on a circular right pad (a correlation, like the kernel)",
    "pack_wire": "view_as_real(z).movedim(-1, 0).to(wire dtype, contiguous, copy=True)",
    "unpack_wire": "view_as_complex(w.movedim(0, -1).to(float32, contiguous, copy=True))",
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
    flash_attention_bound()
    a = path_a(dev, 1)
    b = path_b(dev, torch.Generator().manual_seed(2))
    c = path_c(dev, torch.Generator().manual_seed(3))
    d1 = path_d1(dev, 1, a["kernel"]["x"])
    d2 = path_d2(dev, 1)
    cli = cli_phase()
    d1_counts = {k: d1["fp32"]["counts"][k] + d1["bf16"]["counts"][k] for k in d1["fp32"]["counts"]}
    by_path = {"A": a["kernel"]["counts"], "B": b["kernel"]["counts"],
               "C": c["kernel"]["counts"], "D1": d1_counts, "D2": d2["counts"],
               "CLI": cli["counts"]}

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
    torch.distributed.destroy_process_group()  # Path D1's world of one
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
