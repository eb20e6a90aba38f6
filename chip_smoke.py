#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each unguarded (any failure ends the run with a non-zero code and
no result line):

0. the card's name and power limit, torch / CUDA / Triton versions;
1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. time an empty kernel by each route (Triton, CUDA C++ through ctypes),
   the floor under every kernel's time; hold every kernel against its
   plain PyTorch version on the card, at the shapes the main path gives
   it, and time kernel, plain version, the library yardstick where one
   exists, against the kernel's bound and floor (flash attention: the bf16
   tensor-core kernel and the float32 SIMT kernel, also at the reference
   tests' shapes, a ragged S and D = 256; the soft-threshold pair as CPISTA
   and dense ADMM call them, and at the grid settings swept beside the
   committed one); sweep the direct matvec against the FFT path, n = 1024
   ... 32768 at B = 8 and 1, beside the dispatch's FFT_CROSSOVER;
3. Path A — paper Sec. 7 at the paper's frame size: 4 starfield frames of
   1024x1024 (n = 2^20), order-5 moving-average blur, romberg sensing,
   m = n/2, 600 CPADMM iterations, once on the kernels (tail='kernel') and
   once on the plain step (tail='plain');
4. Path B — paper Sec. 6 at the quickstart's size: n = 16384, 8 signals,
   m = n/2, k = n/10, 400 CPADMM iterations, once on the kernels and once on
   the plain step; every signal must reach MSE <= 1e-4 and the two x-hats
   must agree; n = 16384 is above FFT_CROSSOVER (2^13), so C x takes the
   FFT branch and the direct kernel is not launched; then the same problem
   at n = 4096, the largest swept n below the crossover, where the kernel
   step launches the direct kernel once a step (Path B4096);
5. Path C — CPISTA (paper Alg. 1 with Algs. 7-8) in the same Sec. 6 regime:
   n = 16384, 8 signals, 400 ISTA iterations on the kernels (the two
   products on Path B's branch, the fused soft threshold) and on the plain
   step; the two x-hats must agree and every signal's LASSO objective must
   fall; then again at n = 4096 (Path C4096: the direct kernel twice a
   step); each step's device operations are counted by torch.profiler;
5b. Path F — PADMM (dense ADMM, paper Alg. 2) against CPADMM: the dense
   setup (A^T A + rho I and its float32 inverse) at n = 4096 ... 32768
   against CPADMM's FFT setup, with its peak memory and the inverse's
   residual, then Path B's problem densified at n = 16384, 400 iterations
   on the plain step and on the kernel step (the soft-threshold ADMM kernel
   once a step), held together and against MSE <= 1e-4, beside Path B's
   CPADMM step;
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
   runs it, with no flag for the step (on the card the plan resolves to
   the kernel step): a checkpointed CPADMM run at its default n = 65536,
   B = 4, run a second time to resume from the checkpoint, a Sec. 7 deblur
   run of two 512x512 frames in tolerance mode (one spectral_pointwise and
   one cpadmm_tail launch an iteration, counted), and a 2x2-mesh deblur run
   of four 512x512 frames on four ranks sharing the card with bf16 wires,
   run twice to resume;
9. Path E1 — minitron-4b FULL (32 layers, d_model 3072, GQA 24/8, head_dim
   128, vocab 256000; float32 parameters, bf16 compute) initialised on the
   card from a seed, prefilling 4 prompts of 2048 tokens through
   ``make_prefill_step``: the bf16 tensor-core flash attention kernel in
   every layer (32 launches); device and host ms, tokens/s, peak memory,
   the attention's share of a profiled prefill;
10. Path E2 — the same prompts cut to 512 tokens through
   ``make_decode_step`` one token at a time (the reference's cache
   attention, no kernel), the last steps profiled, held against a prefill
   of the same prompts (5e-2 norm-relative);
11. Path E4 — ``greedy_generate``: 4 prompts of 32 tokens, 32 new tokens;
12. Path E3 — minitron-4b's width cut to 2 layers in float32, initialised
   once on the CPU: a prefill on the CPU (plain attention) against the same
   prefill on the card (the float32 SIMT kernel), 1e-4 norm-relative;
13. one JSON line with every kernel's launches, error, times, bound and
   floor, then the device line ``{"ok": true, "device": {...}}`` last.

Launch counters are zeroed just before each driven path and read just
after (inside each rank for Path D2); the comparison launches of phase 2
do not count.  One kernel has no caller on any path (the reference calls
it only from its tests): the banded blur, held against its plain version
in phase 2 only.  Exits non-zero
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense

# Tolerances, norm-relative (max |kernel - plain| / max |plain|):
#  * elementwise kernels: fp32, same operations, but the compiler may fuse a
#    multiply-add into one rounding -> a few ulps (2^-24 ~ 6e-8 each).
#  * direct matvec: bf16 hi + lo operands (16 bits each), three tensor-core
#    products a term (the lo * lo term, ~2^-18, dropped), fp32 sums: ~5e-6
#    on random data, against the dense fp32 plain version.
#  * banded blur: a sum of L <= 17 products, fused multiply-adds against the
#    plain version's separate roundings, and the FFT route's O(log n) ulps.
TOL_ELEMENTWISE = 1e-6
TOL_MATVEC = 5e-5
TOL_BLUR = 1e-5
TOL_PATHS = 1e-4  # kernel-step vs plain-step solves, relative in x-hat
#  * Path F's dense inverse B = (A^T A + rho I)^{-1} in float32 (cuSOLVER's
#    LU): max |(A^T A + rho I) B - I| <= cond * n * 2^-24, cond <= (1 + rho)
#    / rho ~ 101 for Path B's unit-norm operator (an unnormalised Gaussian,
#    ||C||^2 ~ n, would push cond to ~1e6 at n = 16384).
DENSE_RHO = 0.01  # benchmarks/bench_admm_recovery.py's alpha = 1e-4, rho = 0.01


def inverse_residual_bound(n: int) -> float:
    return (1 + DENSE_RHO) / DENSE_RHO * n * 2.0**-24
#  * flash attention, held against the plain version computed in float32
#    (in bf16 too: q, k and v upcast exactly, the plain version's last
#    rounding left out), over the whole output and row by row (each query
#    row's error over its own largest |value|: a late row averages ~n keys
#    and is ~30x smaller than row 0, so a global ratio alone would let a
#    wrong late row through).  float32: scores, softmax and P.V summed in
#    another order, ~2^-24 * sqrt(n) of sum(p |v|), which is ~6x a long
#    row's largest value: 2e-5 over the output, 1e-4 row by row.  bf16: the
#    kernel's output rounded to nearest moves each value by at most 2^-8 of
#    itself, so 2^-8 of its row's largest, plus the float32 row bound.
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2**-8 + 1e-4}
TOL_FLASH_ROW = {"float32": 1e-4, "bfloat16": 2**-8 + 1e-4}
# Path E2: the prefill (kernel) against token-by-token decode (the cache
# attention, no kernel) through 32 layers in bf16; the decode side also
# rounds q * scale to bf16 before the upcast (the reference's
# _attend_chunked), the kernel does not.
TOL_PREFILL_DECODE = 5e-2
# Path E3: float32 on the card (kernel, cuBLAS with TF32 off) against float32
# on the CPU (plain attention), 2 layers at full width.
TOL_CARD_CPU = 1e-4
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


# the empty kernel's back-to-back time by each route (phase 2 measures it
# first): what one more kernel costs the stream, the floor under any kernel
FLOORS: dict = {}


def launch_floors(dev) -> dict:
    """Time an empty kernel by each route with :func:`timed` (one program /
    block, and one for each SM), as every kernel is timed."""
    import torch

    from repro_torch.kernels.floor import cuda_empty, triton_empty

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for route, empty in (("triton", triton_empty), ("cuda", cuda_empty)):
        one, per_sm = timed(lambda: empty(dev)), timed(lambda: empty(dev, sms))
        FLOORS[route] = one[0]
        print(f"launch floor [{route}]: an empty kernel back to back, device ms {one[0]:.4f} "
              f"(1 program), {per_sm[0]:.4f} ({sms} programs); host ms per launch "
              f"{one[1]:.4f}")
    return dict(FLOORS)


def floor_of(name: str) -> float:
    return FLOORS[KERNEL_SOURCES[name][0]]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, norm-relative error) of ``got`` against ``want``."""
    diff = (got - want).abs().max().item()
    return diff, diff / max(want.abs().max().item(), 1e-30)


def row_rel_err(got, want) -> float:
    """The largest per-query-row norm-relative error of attention outputs
    (B, S, H, D): each row's max |got - want| over its own max |want|."""
    diff = (got.float() - want.float()).abs().flatten(2).amax(-1)
    scale = want.float().abs().flatten(2).amax(-1).clamp_min(1e-30)
    return (diff / scale).max().item()


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_shape(name, label, kern, plain, tol, nbytes, flops, library=None, plain_iters=20,
                flops_per_s=FP32_FLOPS_PER_S, want=None, row_tol=None):
    """One kernel at one shape: error against its plain version, and times.

    ``want`` computes what the kernel is held against where that is not
    ``plain``'s result; ``row_tol`` also holds an attention output row by row
    (:func:`row_rel_err`)."""
    import torch

    got, want = kern(), (want or plain)()
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    err = max((rel_err(g, w) for g, w in zip(got, want)), key=lambda e: e[1])
    row_err = None if row_tol is None else row_rel_err(got[0], want[0])
    r = dict(shape=label, err=err, tol=tol, row_err=row_err, row_tol=row_tol, ms=timed(kern),
             plain_ms=timed(plain, iters=plain_iters),
             library_ms=None if library is None else timed(library),
             bound=bound(nbytes, flops, flops_per_s))
    lib = "none" if r["library_ms"] is None else f"{r['library_ms'][0]:.4f}"
    rows = "" if row_tol is None else f", row by row {row_err:.3e} (tol {row_tol:.1e})"
    print(f"{name} [{label}]: max abs err {err[0]:.3e}, norm-rel {err[1]:.3e} "
          f"(tol {tol:.1e}){rows}; device ms: kernel {r['ms'][0]:.4f}, plain "
          f"{r['plain_ms'][0]:.4f}, library {lib}, bound {r['bound'][0]:.4f} "
          f"({r['bound'][1]}), floor {floor_of(name):.4f}; host ms per call: kernel "
          f"{r['ms'][1]:.4f}, plain {r['plain_ms'][1]:.4f}")
    if not err[1] <= tol or (row_tol is not None and not row_err <= row_tol):
        fail(f"{name} [{label}] disagrees with its plain version: {err}, row by row {row_err}")
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

    # circulant_matvec: first, both ways, the shape that reaches it on a
    # path, Paths B4096 and C4096 (n below FFT_CROSSOVER, B = 8); then Paths
    # B and C's own n = 16384 (the FFT branch there, Path A's 2^20 too) at
    # B = 8 and one padded 8-signal slice (B = 1, 3).  Bound: the design's
    # three bf16 products a term on the tensor cores, the fastest rate that
    # meets TOL_MATVEC; the fp32 CUDA-core bound is printed beside it
    below = below_crossover()
    for n, B, label in ((below, 8, f"paths B{below}, C{below}"),
                        (16384, 8, "paths B, C's n (FFT branch there)"),
                        (16384, 1, "padded slice"), (16384, 3, "padded slice")):
        col, xs = rnd(n), rnd(B, n)
        for transpose in (False, True):
            shape = f"{label}: n={n} B={B} transpose={transpose}"
            results["circulant_matvec"].append(check_shape(
                "circulant_matvec", shape,
                lambda a=(col, xs, transpose): circulant_matvec_direct(a[0], a[1], transpose=a[2]),
                lambda a=(col, xs, transpose): circulant_matvec_ref(a[0], a[1], transpose=a[2]),
                TOL_MATVEC, 4 * n + 8 * B * n, 3 * 2 * B * n * n,
                library=lambda a=(col, xs, transpose): circulant_matvec_fft(
                    a[0], a[1], transpose=a[2]),
                plain_iters=5, flops_per_s=BF16_FLOPS_PER_S,
            ))
            print(f"circulant_matvec [{shape}]: beside the bound, 2Bn^2 in fp32 on the "
                  f"CUDA cores: {bound(4 * n + 8 * B * n, 2 * B * n * n)[0]:.4f} ms")
    crossover_sweep(rnd)

    check_thresholds(dev, gen, rnd, results)

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
    check_flash(dev, gen, results)
    return results


# the soft-threshold pair's shapes: Path C's (and Path F's) n = 16384, B = 8,
# the CLI's default n = 65536, B = 4, and a ragged length
THRESHOLD_SHAPES = (("path C, F", 16384, 8), ("CLI default", 65536, 4), ("ragged", 16383, 3))


def check_thresholds(dev, gen, rnd, results) -> None:
    """The soft-threshold pair against their plain versions, and a sweep of
    the grid settings (``kernel.SWEEP``) beside the committed ``CONFIG``.

    soft_threshold_ista: first as CPISTA calls it (Paths C, C4096), from the
    raw gradient with tau a one-element tensor on the card and alpha a
    number, then as the TPU kernel's eta_gamma(x + delta) with gamma on the
    card.  soft_threshold_admm: as the dense ADMM step calls it (Path F:
    gamma = alpha / rho and tau2 = 1 as numbers), then with device scalars.
    Both are built to be bit-equal to their plain versions (no fused
    multiply-add); whether they are is printed, the gate is
    TOL_ELEMENTWISE."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.soft_threshold import kernel as st_kernel
    from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
    from repro_torch.kernels.soft_threshold.ref import (
        admm_threshold_dual_update_ref,
        ista_step_update_ref,
        ista_threshold_update_ref,
    )

    gamma, tau2 = torch.tensor(0.05, device=dev), torch.tensor(1.0, device=dev)
    tau, alpha = torch.tensor(0.99, device=dev), 1e-4
    operands = {}
    for label, n, B in THRESHOLD_SHAPES:
        x, other = rnd(B, n), rnd(B, n)
        operands[label] = (x, other)
        cases = (
            ("soft_threshold_ista", f"{label}, CPISTA's folded call: n={n} B={B}",
             lambda a=(x, other): fused_ista_update(*a, alpha, tau=tau),
             lambda a=(x, other): ista_step_update_ref(a[0], a[1], tau, alpha),
             12 * B * n, 4 * B * n,
             # no one PyTorch call computes it: a multiply-add, then softshrink
             lambda a=(x, other): F.softshrink(torch.addcmul(a[0], tau, a[1]), 0.99e-4)),
            ("soft_threshold_ista", f"{label}, eta_gamma(x + delta): n={n} B={B}",
             lambda a=(x, other): fused_ista_update(*a, gamma),
             lambda a=(x, other): ista_threshold_update_ref(*a, gamma),
             12 * B * n, 3 * B * n, lambda a=(x, other): F.softshrink(a[0] + a[1], 0.05)),
            ("soft_threshold_admm", f"{label}, dense ADMM's call: n={n} B={B}",
             lambda a=(x, other): fused_admm_update(*a, alpha / DENSE_RHO, 1.0),
             lambda a=(x, other): admm_threshold_dual_update_ref(*a, alpha / DENSE_RHO, 1.0),
             16 * B * n, 6 * B * n, None),
            ("soft_threshold_admm", f"{label}, device scalars: n={n} B={B}",
             lambda a=(x, other): fused_admm_update(*a, gamma, tau2),
             lambda a=(x, other): admm_threshold_dual_update_ref(*a, gamma, tau2),
             16 * B * n, 6 * B * n, None),
        )
        for name, shape, kern, plain, nbytes, flops, library in cases:
            r = check_shape(name, shape, kern, plain, TOL_ELEMENTWISE, nbytes, flops,
                            library=library)
            tensors = lambda out: (out,) if isinstance(out, torch.Tensor) else out
            r["bit_exact"] = all(torch.equal(g, w) for g, w in zip(tensors(kern()),
                                                                   tensors(plain())))
            print(f"  {name} [{shape}]: bit-equal to the plain version: {r['bit_exact']}")
            results[name].append(r)
    # the grid settings, each at the three shapes; the committed one first
    totals = {}
    for config in st_kernel.SWEEP:
        row = []
        for label, n, B in THRESHOLD_SHAPES:
            x, other = operands[label]
            ista = timed(lambda: st_kernel.ista_update(x, other, alpha, tau.reshape(1),
                                                       config=config))[0]
            admm = timed(lambda: st_kernel.admm_update(x, other, alpha / DENSE_RHO, 1.0,
                                                       config=config))[0]
            totals[config] = totals.get(config, 0.0) + ista + admm
            row.append(f"{label} ista {ista:.4f} admm {admm:.4f}")
        block, warps, per_sm = config
        print(f"soft-threshold grid sweep BLOCK={block} num_warps={warps} programs/SM="
              f"{per_sm}: device ms " + "; ".join(row))
    best = min(totals, key=totals.get)
    print(f"soft-threshold grid sweep: fastest over the three shapes {best} "
          f"({totals[best]:.4f} ms summed), committed CONFIG {st_kernel.CONFIG} "
          f"({totals[st_kernel.CONFIG]:.4f} ms summed)")


CROSSOVER_SWEEP = (1024, 2048, 4096, 8192, 16384, 32768)


def below_crossover() -> int:
    """The largest swept n below FFT_CROSSOVER: Paths B and C are driven a
    second time at this n, where their products take the direct kernel."""
    from repro_torch.kernels.circulant_matvec.ops import FFT_CROSSOVER

    return max(n for n in CROSSOVER_SWEEP if n < FFT_CROSSOVER)


def crossover_sweep(rnd) -> None:
    """The direct kernel against the FFT path, both directions, at B = 8
    (Paths B and C) and B = 1, n = 1024 ... 32768; prints where the FFT
    path first wins, beside the dispatch's FFT_CROSSOVER."""
    from repro_torch.kernels.circulant_matvec.ops import FFT_CROSSOVER, circulant_matvec_direct
    from repro_torch.kernels.circulant_matvec.ref import circulant_matvec_fft

    for B in (8, 1):
        first_fft = {}
        for n in CROSSOVER_SWEEP:
            col, xs = rnd(n), rnd(B, n)
            row = []
            for transpose in (False, True):
                direct = timed(lambda: circulant_matvec_direct(col, xs, transpose=transpose))[0]
                fft = timed(lambda: circulant_matvec_fft(col, xs, transpose=transpose))[0]
                row.append(f"{'C^T' if transpose else 'C'} direct {direct:.4f} fft {fft:.4f}")
                if fft < direct:
                    first_fft.setdefault(transpose, n)
            print(f"crossover sweep B={B} n={n}: device ms " + "; ".join(row))
        print(f"crossover sweep B={B}: the FFT path first wins at n = "
              f"{first_fft.get(False)} (C), {first_fft.get(True)} (C^T); "
              f"FFT_CROSSOVER = {FFT_CROSSOVER}")


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
                      f"bound {r['bound'][0]:.4f} ({r['bound'][1]}), floor "
                      f"{floor_of(name):.4f}; host ms per call: kernel {r['ms'][1]:.4f}")
                if not exact:
                    fail(f"{name} [{r['shape']}] is not bit-equal to its plain version")
                results[name].append(r)


def check_flash(dev, gen, results) -> None:
    """flash_attention against its plain version, through the public wrapper,
    which routes bf16 at D in SM90_HEAD_DIMS to the tensor-core kernel and
    the rest to the SIMT kernel; the routed kernel's counter must move.

    The tensor-core kernel: Path E1's prefill shape first (minitron-4b: bf16,
    B = 4, S = 2048, H = 24 over KH = 8, D = 128, causal), then D = 64, a
    ragged GQA (8, 1) S = 1000, a full (non-causal) S = 300 and D = 256
    (gemma-7b's head).  The SIMT kernel: E1's shape in float32 first, then
    tests/test_flash_attention.py's float32 shapes, its GQA mappings, a
    ragged causal S = 1000 and D = 256.  Each is held against the plain
    version in float32 (TOL_FLASH, TOL_FLASH_ROW) and timed against the plain
    version in its own dtype.  The library yardstick is
    scaled_dot_product_attention on (B, H, S, D) views with enable_gqa (never
    called by the port); its own error against the same float32 plain
    version is printed beside the kernel's, a finding and no gate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # (label, dtype, B, S, H, KH, D, causal)
    cases = [("path E1: minitron-4b prefill", torch.bfloat16, 4, 2048, 24, 8, 128, True),
             ("D=64", torch.bfloat16, 2, 512, 4, 2, 64, True),
             ("ragged GQA", torch.bfloat16, 2, 1000, 8, 1, 128, True),
             ("full", torch.bfloat16, 1, 300, 4, 4, 128, False),
             ("D=256", torch.bfloat16, 2, 512, 4, 2, 256, True),
             ("path E1's shape", torch.float32, 4, 2048, 24, 8, 128, True)]
    cases += [("tests' shape", torch.float32, 2, s, 2, 2, 64, c)
              for s in (256, 512, 768) for c in (True, False)]
    cases += [("GQA", torch.float32, 2, 512, h, kh, 32, True) for h, kh in ((4, 2), (8, 1))]
    cases += [("ragged", torch.float32, 2, 1000, 4, 2, 64, True),
              ("D=256", torch.float32, 2, 512, 4, 2, 256, True)]
    for label, dt, b, s, h, kh, d, causal in cases:
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev).to(dt) for n in (h, kh, kh))
        flops = 4 * b * h * s * s * d / (2 if causal else 1)  # Q.K^T and P.V
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        name = str(dt).removeprefix("torch.")
        kernel = f"flash_attention_{ops.kernel_for(dt, d)}"
        wrapper = getattr(ops, kernel)
        before = wrapper.launches
        want = lambda a=(q, k, v, causal): flash_attention_ref(
            *(t.float() for t in a[:3]), causal=a[3])
        library = lambda a=(q, k, v, causal): F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a[:3]), is_causal=a[3], enable_gqa=True)
        label = f"{label}: {name} B={b} S={s} H={h} KH={kh} D={d} causal={causal}"
        results[kernel].append(check_shape(
            kernel, label,
            lambda a=(q, k, v, causal): ops.flash_attention(*a[:3], causal=a[3]),
            lambda a=(q, k, v, causal): flash_attention_ref(*a[:3], causal=a[3]),
            TOL_FLASH[name], nbytes, flops, want=want, row_tol=TOL_FLASH_ROW[name],
            library=library, plain_iters=5 if s >= 2048 else 20,
            flops_per_s=BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S,
        ))
        if wrapper.launches == before:
            fail(f"{kernel} [{label}]: the wrapper routed the call elsewhere")
        lib_out, ref_out = library().transpose(1, 2), want()
        print(f"  library [{label}] vs the float32 plain version: norm-rel "
              f"{rel_err(lib_out.float(), ref_out)[1]:.3e}, row by row "
              f"{row_rel_err(lib_out, ref_out):.3e} (a finding, not a gate)")


def _wrappers() -> dict:
    from repro_torch.kernels.banded_conv.ops import blur_apply
    from repro_torch.kernels.circulant_matvec.ops import circulant_matvec_direct
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.flash_attention.ops import flash_attention_simt, flash_attention_sm90
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
        "flash_attention_sm90": flash_attention_sm90,
        "flash_attention_simt": flash_attention_simt,
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


def direct_matvecs(n: int, per_iter: int, iters: int) -> int:
    """Direct-kernel launches of ``iters`` kernel steps with ``per_iter``
    products C x / C^T r each: all of them below FFT_CROSSOVER, none at or
    above it (the FFT branch)."""
    from repro_torch.kernels.circulant_matvec.ops import FFT_CROSSOVER

    return per_iter * iters if n < FFT_CROSSOVER else 0


def path_b(dev, gen, n=16384, batch=8, iters=400, name="B") -> dict:
    """Paper Sec. 6 recovery at the quickstart's size, n = 16384: at or above
    FFT_CROSSOVER (2^13 on the H100) its C x takes the FFT branch, below it
    (Path B4096) the direct kernel."""
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
        dev_ms, host_ms = step_times(prob, plan(op, tail=tail), **kw)
        out[tail] = dict(x=x, ms_iter=ms_iter, counts=counts, mse=mse, dev_ms=dev_ms)
        print(f"Path {name} tail={tail}: n={n} B={batch} m={m} k={k}, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock), per step device {dev_ms:.4f} ms / "
              f"host issue {host_ms:.4f} ms, launches {counts}, MSE per signal {mse}")
        if x.shape != (batch, n) or not bool(torch.isfinite(x).all()):
            fail(f"Path {name} ({tail}) result has shape {tuple(x.shape)} or non-finite values")
        if not all(v <= PAPER_TARGET_MSE for v in mse):
            fail(f"Path {name} ({tail}): a signal misses MSE <= {PAPER_TARGET_MSE}: {mse}")
    xk, xp = out["kernel"]["x"], out["plain"]["x"]
    diff = ((xk - xp).norm() / xp.norm()).item()
    print(f"Path {name}: kernel vs plain x-hat norm-rel diff {diff:.3e} (tol {TOL_PATHS:.0e}); "
          f"kernel step / plain step device ms "
          f"{out['kernel']['dev_ms'] / out['plain']['dev_ms']:.3f}")
    if not diff <= TOL_PATHS:
        fail(f"Path {name} kernel and plain solves disagree: {diff}")
    want = dict.fromkeys(out["kernel"]["counts"], 0)
    want.update(spectral_pointwise=iters, cpadmm_tail=iters,
                circulant_matvec=direct_matvecs(n, 1, iters))
    if out["kernel"]["counts"] != want or any(out["plain"]["counts"].values()):
        fail(f"Path {name} launch counts {out['kernel']['counts']} (kernel) / "
             f"{out['plain']['counts']} (plain); expected {want} / none")
    return out


def path_c(dev, gen, n=16384, batch=8, iters=400, name="C") -> dict:
    """CPISTA (paper Alg. 1, Algs. 7-8) in the Sec. 6 regime, on both tails;
    its two products a step take the branch Path B's does."""
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
        dev_ms, host_ms = step_times(prob, plan(op, tail=tail), **kw)
        ops = profile_steps(prob, plan(op, tail=tail), f"Path {name} tail={tail}", **kw)
        out[tail] = dict(x=x, ms_iter=ms_iter, counts=counts, mse=mse, dev_ms=dev_ms,
                         ops=ops["launches"])
        print(f"Path {name} tail={tail}: CPISTA n={n} B={batch} m={m} k={k}, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock), per step device {dev_ms:.4f} ms / "
              f"host issue {host_ms:.4f} ms / {ops['launches']:g} device operations, "
              f"launches {counts}, MSE per signal {mse}, LASSO objective per signal {obj} "
              f"(at x = 0: {obj0})")
        if x.shape != (batch, n) or not bool(torch.isfinite(x).all()):
            fail(f"Path {name} ({tail}) result has shape {tuple(x.shape)} or non-finite values")
        if not all(o < o0 for o, o0 in zip(obj, obj0)):
            fail(f"Path {name} ({tail}): a signal's LASSO objective did not fall: {obj} vs {obj0}")
    xk, xp = out["kernel"]["x"], out["plain"]["x"]
    diff = ((xk - xp).norm() / xp.norm()).item()
    print(f"Path {name}: kernel vs plain x-hat norm-rel diff {diff:.3e} (tol {TOL_PATHS:.0e}); "
          f"kernel step / plain step device ms "
          f"{out['kernel']['dev_ms'] / out['plain']['dev_ms']:.3f}, device operations a step "
          f"{out['kernel']['ops']:g} / {out['plain']['ops']:g}")
    if not diff <= TOL_PATHS:
        fail(f"Path {name} kernel and plain solves disagree: {diff}")
    want = dict.fromkeys(out["kernel"]["counts"], 0)
    want.update(circulant_matvec=direct_matvecs(n, 2, iters), soft_threshold_ista=iters)
    if out["kernel"]["counts"] != want or any(out["plain"]["counts"].values()):
        fail(f"Path {name} launch counts {out['kernel']['counts']} (kernel) / "
             f"{out['plain']['counts']} (plain); expected {want} / none")
    return out


DENSE_SETUP_NS = (4096, 8192, 16384, 32768)


def one_call(fn) -> tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``: CUDA events around it (host
    gaps included) and the host clock from a synchronize to a synchronize."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def dense_problem(dev, n, batch=8):
    """Path B's problem (its generator seed) at ``n``: the normalised partial
    Gaussian circulant, m = n/2, k = n/10, and its dense matrix."""
    import torch

    from repro_torch.core.circulant import densify, partial_gaussian_circulant
    from repro_torch.core.solvers import RecoveryProblem
    from repro_torch.data.synthetic import paper_regime, sparse_signal

    gen = torch.Generator().manual_seed(2)
    m, k = paper_regime(n)
    x_true = sparse_signal(gen, n, k, batch=(batch,), device=dev)
    op = partial_gaussian_circulant(gen, n, m, normalize=True, device=dev)
    y = op.matvec(x_true)
    return RecoveryProblem(op, y, x_true), RecoveryProblem(densify(op), y, x_true)


def path_f(dev, b, n=16384, batch=8, iters=400) -> dict:
    """PADMM (dense ADMM, paper Alg. 2) against CPADMM (Alg. 3) on the card:
    the O(n^3) inversion against the FFT setup at n = 4096 ... 32768, then
    400 iterations of Path B's problem densified, on the plain step and on
    the kernel step (the n x n product, then the soft-threshold ADMM kernel)."""
    import torch

    from repro_torch.core.admm import CpadmmParams, cpadmm_setup, dense_admm_setup
    from repro_torch.ops.plan import plan

    kw = dict(alpha=1e-4, rho=DENSE_RHO)
    dense_admm_setup(dense_problem(dev, 1024, 1)[1].op, torch.zeros(1, 512, device=dev),
                     DENSE_RHO)  # cuSOLVER's and cuBLAS's handles, once
    setups = {}
    for n_s in DENSE_SETUP_NS:
        circ, dense = dense_problem(dev, n_s, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        consts = []
        dev_ms, host_ms = one_call(lambda: consts.append(dense_admm_setup(dense.op, dense.y,
                                                                          DENSE_RHO)))
        const, peak = consts.pop(), torch.cuda.max_memory_allocated() / 2**30
        A = dense.op.mat
        gram = A.mT @ A
        gram.diagonal().add_(DENSE_RHO)
        resid = gram @ const.B
        resid.diagonal().sub_(1.0)
        residual = resid.abs().max().item()
        del gram, resid, const
        p = CpadmmParams(alpha=kw["alpha"], rho=DENSE_RHO, sigma=DENSE_RHO, tau1=1.0, tau2=1.0)
        cpadmm_setup(circ.op, circ.y, p)  # warm
        circ_ms = one_call(lambda: cpadmm_setup(circ.op, circ.y, p))
        setups[n_s] = dict(dense_ms=dev_ms, host_ms=host_ms, peak_gib=peak, residual=residual,
                           circ_ms=circ_ms[0])
        print(f"Path F setup n={n_s} B={batch} (one call each, CUDA events and the host "
              f"clock to a synchronize): dense_admm_setup (A^T A + rho I and its float32 "
              f"inverse) device {dev_ms:.3f} ms / host clock {host_ms:.3f} ms, peak "
              f"memory {peak:.3f} GiB (the {A.shape[0]}x{n_s} matrix included), inverse "
              f"residual max|(A^T A + rho I) B - I| {residual:.3e} (bound "
              f"{inverse_residual_bound(n_s):.3e}); cpadmm_setup device {circ_ms[0]:.4f} ms / "
              f"host {circ_ms[1]:.4f} ms; inversion dense / circulant "
              f"{dev_ms / circ_ms[0]:.1f}x")
        if not residual <= inverse_residual_bound(n_s):
            fail(f"Path F: the dense inverse at n={n_s} has residual {residual}")
        del circ, dense, A
        torch.cuda.empty_cache()

    circ, prob = dense_problem(dev, n, batch)
    out = {}
    for tail in ("kernel", "plain"):
        zero_counts()
        x, trace, ms_iter = timed_solve(prob, plan(prob.op, tail=tail), iters, iters,
                                        method="admm", **kw)
        counts = read_counts()
        mse = trace.mse[-1].tolist()
        dev_ms, host_ms = step_times(prob, plan(prob.op, tail=tail), method="admm", **kw)
        out[tail] = dict(x=x, ms_iter=ms_iter, counts=counts, mse=mse, dev_ms=dev_ms,
                         host_ms=host_ms)
        print(f"Path F tail={tail}: PADMM n={n} B={batch} m={n // 2}, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock, the setup included), per step device "
              f"{dev_ms:.4f} ms / host issue {host_ms:.4f} ms, launches {counts}, MSE per "
              f"signal {mse}")
        if x.shape != (batch, n) or not bool(torch.isfinite(x).all()):
            fail(f"Path F ({tail}) result has shape {tuple(x.shape)} or non-finite values")
        if not all(v <= PAPER_TARGET_MSE for v in mse):
            fail(f"Path F ({tail}): a signal misses MSE <= {PAPER_TARGET_MSE}: {mse}")
    xk, xp = out["kernel"]["x"], out["plain"]["x"]
    diff = ((xk - xp).norm() / xp.norm()).item()
    x_b = b["kernel"]["x"]
    vs_b = ((xk - x_b).norm() / x_b.norm()).item()
    # the per-step product reads the n x n inverse once: its byte bound
    gemm_bound = bound(4 * n * n + 8 * batch * n, 2 * batch * n * n)
    k, bk = out["kernel"], b["kernel"]
    print(f"Path F: kernel vs plain x-hat norm-rel diff {diff:.3e} (tol {TOL_PATHS:.0e}); vs "
          f"Path B's CPADMM x-hat {vs_b:.3e}; the step's n x n product bound "
          f"{gemm_bound[0]:.4f} ms ({gemm_bound[1]}); PADMM / CPADMM (Path B, kernel steps): "
          f"device ms a step {k['dev_ms']:.4f} / {bk['dev_ms']:.4f} = "
          f"{k['dev_ms'] / bk['dev_ms']:.2f}x, solve ms/iter {k['ms_iter']:.4f} / "
          f"{bk['ms_iter']:.4f} = {k['ms_iter'] / bk['ms_iter']:.2f}x; inversion at n={n} "
          f"{setups[n]['dense_ms']:.3f} / {setups[n]['circ_ms']:.4f} ms = "
          f"{setups[n]['dense_ms'] / setups[n]['circ_ms']:.0f}x")
    if not diff <= TOL_PATHS:
        fail(f"Path F kernel and plain solves disagree: {diff}")
    want = dict.fromkeys(k["counts"], 0)
    want.update(soft_threshold_admm=iters)
    if k["counts"] != want or any(out["plain"]["counts"].values()):
        fail(f"Path F launch counts {k['counts']} (kernel) / {out['plain']['counts']} "
             f"(plain); expected {want} / none")
    del prob, circ
    torch.cuda.empty_cache()
    return dict(out, setups=setups)


def profile_steps(prob, plan, label, steps=5, method="cpadmm", **kw) -> dict:
    """:func:`profile_window` over a few steady solver steps."""
    from repro_torch.core.solvers import make_stepper

    stepper = make_stepper(prob, method, plan=plan, **kw)
    state = [stepper.init()]

    def one():
        state[0] = stepper.step(state[0])

    for _ in range(3):
        one()
    return profile_window(one, label, steps)


def profile_window(fn, label, steps=5) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``fn``: prints the device's
    busy share of the window, device time by kernel name and the host ops
    that cost most, per call; returns {"wall_ms", "busy_ms", "kernels":
    {name: device ms}, "launches": device operations} per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    # device time from the kernel and copy records alone (an operator's record
    # repeats the time of the kernels it launched)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"profile {label}: {steps} calls, {wall_ms:.4f} ms each (host clock), device busy "
          f"{busy:.4f} ms ({100 * busy / wall_ms:.1f}% of the window), {launches:g} device "
          f"operations (kernels and copies) each")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  device {e.self_device_time_total / 1e3 / steps:.4f} ms  "
              f"x{e.count / steps:g}  {e.key[:90]}")
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host {e.self_cpu_time_total / 1e3 / steps:.4f} ms  x{e.count / steps:g}  "
              f"{e.key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, launches=launches,
                kernels={e.key: e.self_device_time_total / 1e3 / steps for e in kernels})


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


def timed_calls(fn, iters: int) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``, for calls too long to queue
    behind :func:`timed`'s device spin (a prefill issues ~1000 launches, more
    than the launch queue holds): CUDA events around ``iters`` calls, and
    the host clock to a synchronize.  The device stays busy while the host
    issues (each layer's attention runs for milliseconds), so the events
    time the device."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, (time.perf_counter() - t0) * 1e3 / iters


def minitron(n_layers=None, dtype=None):
    import dataclasses

    from repro_torch.configs.registry import full_config

    cfg = full_config("minitron-4b")
    cut = {k: v for k, v in (("n_layers", n_layers), ("dtype", dtype)) if v is not None}
    return dataclasses.replace(cfg, **cut) if cut else cfg


def path_e1(dev, seed, batch=4, seq=2048) -> dict:
    """minitron-4b FULL (32 layers, d_model 3072, 24 query heads over 8 KV
    heads, head_dim 128, vocab 256000; bf16 compute over float32 parameters,
    as the reference) prefilling 4 prompts of 2048 tokens: the kernel in
    every layer's attention."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.config import count_params
    from repro_torch.models.lm import init_params, tree_leaves
    from repro_torch.models.steps import make_prefill_step

    cfg = minitron()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    counted = count_params(cfg)["total"] + (2 * cfg.n_layers + 1) * cfg.d_model  # + norm scales
    if n_params != counted:
        fail(f"Path E1: {n_params} parameters; count_params and the norms say {counted}")
    tokens = token_batch(gen, batch, seq - 1, cfg.vocab, device=dev)
    prefill = make_prefill_step(cfg)
    batch_in = {"tokens": tokens}
    prefill(params, batch_in)  # the one cast of the weights to bf16, and warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    logits = prefill(params, batch_in)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, host_ms = timed_calls(lambda: prefill(params, batch_in), iters=3)
    prof = profile_window(lambda: prefill(params, batch_in), "Path E1 prefill", steps=1)
    attn_ms = sum(ms for name, ms in prof["kernels"].items() if "flash_fwd" in name)
    busy_ms = prof["busy_ms"]
    tok_s = batch * seq / (host_ms / 1e3)
    print(f"Path E1: minitron-4b FULL, {n_params / 1e9:.3f} B parameters (float32 "
          f"{4 * n_params / 1e9:.2f} GB, bf16 copy {2 * n_params / 1e9:.2f} GB), init + cast + "
          f"warm-up {setup_s:.2f} s; prefill B={batch} S={seq}: device {dev_ms:.2f} ms, host "
          f"clock {host_ms:.2f} ms, {tok_s:.0f} tokens/s, peak memory {peak_gib:.2f} GiB; "
          f"profiled prefill: flash_attention {attn_ms:.2f} of {busy_ms:.2f} device ms "
          f"({100 * attn_ms / busy_ms:.1f}%); launches {counts}")
    if logits.shape != (batch, cfg.vocab_padded) or not bool(torch.isfinite(logits).all()):
        fail(f"Path E1 logits have shape {tuple(logits.shape)} or non-finite values")
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention_sm90=cfg.n_layers)
    if counts != want:
        fail(f"Path E1 launch counts {counts}; expected {want} (one per layer)")
    return dict(cfg=cfg, params=params, tokens=tokens, prefill=prefill, counts=counts,
                dev_ms=dev_ms, host_ms=host_ms, tok_s=tok_s, peak_gib=peak_gib,
                attn_ms=attn_ms, busy_ms=busy_ms)


PROFILED_STEPS = 5  # Path E2's last decode steps, run under torch.profiler


def path_e2(e1, seq=512) -> dict:
    """The same prompts cut to 512 tokens through make_decode_step one token
    at a time (the reference's cache attention, no kernel), against a
    prefill (the kernel) of the same prompts."""
    import torch

    from repro_torch.models.lm import init_decode_state
    from repro_torch.models.steps import make_decode_step

    cfg, params = e1["cfg"], e1["params"]
    tokens = e1["tokens"][:, :seq].contiguous()
    batch = tokens.shape[0]
    decode = make_decode_step(cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_decode_state(cfg, batch, seq, device=tokens.device)
    for i in range(seq - PROFILED_STEPS):
        logits, state = decode(params, tokens[:, i:i + 1], state)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    last = [seq - PROFILED_STEPS, None, state]

    def one():  # the next decode step
        i = last[0]
        last[1], last[2] = decode(params, tokens[:, i:i + 1], last[2])
        last[0] = i + 1

    prof = profile_window(one, f"Path E2 decode steps {seq - PROFILED_STEPS}-{seq - 1}",
                          steps=PROFILED_STEPS)
    logits = last[1]
    decode_counts = read_counts()
    want_logits = e1["prefill"](params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = read_counts()
    err = rel_err(logits.float(), want_logits.float())
    agree = (logits.argmax(-1) == want_logits.argmax(-1)).tolist()
    n_timed = seq - PROFILED_STEPS
    print(f"Path E2: {batch} prompts of {seq} tokens decoded one token at a time: the first "
          f"{n_timed} steps in {decode_s:.2f} s ({1e3 * decode_s / n_timed:.2f} ms per step, host "
          f"clock, the one cast of the weights included), the last {PROFILED_STEPS} "
          f"{prof['wall_ms']:.2f} ms per step with the device busy {prof['busy_ms']:.2f} ms; "
          f"last logits vs a prefill of the same prompts: max abs err "
          f"{err[0]:.3e}, norm-rel {err[1]:.3e} (tol {TOL_PREFILL_DECODE:.0e}); next-token "
          f"argmax agrees on {sum(agree)}/{batch} prompts {agree}; launches {counts} "
          f"(decode alone {decode_counts})")
    if not bool(torch.isfinite(logits).all()):
        fail("Path E2: non-finite decode logits")
    if not err[1] <= TOL_PREFILL_DECODE:
        fail(f"Path E2: decode and prefill disagree: {err}")
    want = dict.fromkeys(counts, 0)
    if decode_counts != want:
        fail(f"Path E2: the decode path launched kernels {decode_counts}")
    want.update(flash_attention_sm90=cfg.n_layers)
    if counts != want:
        fail(f"Path E2 launch counts {counts}; expected {want}")
    return dict(counts=counts, err=err, agree=agree, ms_step=1e3 * decode_s / n_timed,
                busy_ms=prof["busy_ms"])


def path_e4(e1, prompt_len=32, steps=32, max_len=64) -> dict:
    """greedy_generate on the full model: 4 prompts of 32 tokens, 32 new tokens."""
    import torch

    from repro_torch.models.steps import greedy_generate

    cfg, params = e1["cfg"], e1["params"]
    prompt = e1["tokens"][:, :prompt_len].contiguous()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, steps, max_len)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    print(f"Path E4: greedy_generate, prompts {tuple(prompt.shape)}, {steps} new tokens, "
          f"max_len {max_len}: tokens {tuple(out.shape)} in {total_ms:.1f} ms (host clock, the "
          f"one cast included): {total_ms / steps:.2f} ms per generated token, "
          f"{total_ms / (prompt_len + steps - 1):.2f} ms per decode step; first row "
          f"{out[0, :8].tolist()}...; launches {counts}")
    if out.shape != (prompt.shape[0], steps) or not (0 <= int(out.min()) and
                                                     int(out.max()) < cfg.vocab):
        fail(f"Path E4: tokens of shape {tuple(out.shape)} outside [0, {cfg.vocab})")
    if any(counts.values()):
        fail(f"Path E4: the decode path launched kernels {counts}")
    return dict(counts=counts, ms_token=total_ms / steps)


def path_e3(dev, seed, batch=2, seq=256) -> dict:
    """minitron-4b at full width cut to 2 layers, float32, initialised once
    on the CPU: a prefill on the CPU (plain attention) against the same
    prefill on the card (the kernel)."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import init_params, tree_map
    from repro_torch.models.steps import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on the card
    cfg = minitron(n_layers=2, dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device="cpu")
    tokens = token_batch(gen, batch, seq - 1, cfg.vocab, device="cpu")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    params_dev = tree_map(lambda a: a.to(dev), params)
    zero_counts()
    got = make_prefill_step(cfg)(params_dev, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    counts = read_counts()
    err = rel_err(got.float().cpu(), want.float())
    print(f"Path E3: minitron-4b width, 2 layers, float32, B={batch} S={seq}: CPU init "
          f"{init_s:.2f} s, CPU prefill {cpu_s:.2f} s; card vs CPU last logits max abs err "
          f"{err[0]:.3e}, norm-rel {err[1]:.3e} (tol {TOL_CARD_CPU:.0e}); launches {counts}")
    if not bool(torch.isfinite(got).all()) or not err[1] <= TOL_CARD_CPU:
        fail(f"Path E3: the card's prefill disagrees with the CPU's: {err}")
    want_counts = dict.fromkeys(counts, 0)
    want_counts.update(flash_attention_simt=cfg.n_layers)
    if counts != want_counts:
        fail(f"Path E3 launch counts {counts}; expected {want_counts}")
    return dict(counts=counts, err=err)


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
    a resume from its checkpoint, and a Sec. 7 deblur run, all on the kernel
    step the plan resolves to on the card, one spectral_pointwise and one
    cpadmm_tail launch an iteration (the resume runs none: its checkpoint is
    at the budget); then the 2x2-mesh deblur run twice, as a subprocess."""
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
    # the CLI builds plan(op) with the default tail, which resolves to the
    # kernel step on the card: one launch of each per iteration, the
    # tolerance run's iterations being its slowest signal's
    deblur_iters = max(int(v) for v in _floats(deblur.split("per-signal iterations:")[1]
                                               .splitlines()[0]))
    if not all("tail=kernel" in out for out in (first, second, deblur)):
        fail("CLI: a local run did not report the kernel step")
    want = dict.fromkeys(counts, 0)
    want.update(spectral_pointwise=200 + deblur_iters, cpadmm_tail=200 + deblur_iters)
    print(f"CLI launches (local runs: 200 + 0 resumed + {deblur_iters} deblur iterations): "
          f"{counts}")
    if counts != want:
        fail(f"CLI launch counts {counts}; expected {want}")
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
    "flash_attention_sm90": ("cuda", "src/repro_torch/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention/kernel.py:72"),
    "flash_attention_simt": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:72"),
}
# the PyTorch call timed as each kernel's library_ms (never used by the port)
LIBRARY_CALLS = {
    "spectral_pointwise": None,
    "cpadmm_tail": None,
    "circulant_matvec": "torch.fft path (rfft, product, irfft)",
    "soft_threshold_ista": "F.softshrink(torch.addcmul(x, tau, grad), alpha * tau): two "
                           "launches, no one call fuses it",
    "soft_threshold_admm": None,
    "banded_conv": "F.conv1d on a circular right pad (a correlation, like the kernel)",
    "pack_wire": "view_as_real(z).movedim(-1, 0).to(wire dtype, contiguous, copy=True)",
    "unpack_wire": "view_as_complex(w.movedim(0, -1).to(float32, contiguous, copy=True))",
    "flash_attention_sm90": "F.scaled_dot_product_attention(is_causal, enable_gqa=True) on "
                            "(B, H, S, D) views",
    "flash_attention_simt": "F.scaled_dot_product_attention(is_causal, enable_gqa=True) on "
                            "(B, H, S, D) views",
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
    launch_floors(dev)
    checks = check_kernels(dev, gen)
    a = path_a(dev, 1)
    below = below_crossover()
    b = path_b(dev, torch.Generator().manual_seed(2))
    b_below = path_b(dev, torch.Generator().manual_seed(2), n=below, name=f"B{below}")
    c = path_c(dev, torch.Generator().manual_seed(3))
    c_below = path_c(dev, torch.Generator().manual_seed(3), n=below, name=f"C{below}")
    f = path_f(dev, b)
    d1 = path_d1(dev, 1, a["kernel"]["x"])
    d2 = path_d2(dev, 1)
    cli = cli_phase()
    e1 = path_e1(dev, 4)
    e2 = path_e2(e1)
    e4 = path_e4(e1)
    del e1["params"], e1["prefill"]
    torch.cuda.empty_cache()
    e3 = path_e3(dev, 5)
    d1_counts = {k: d1["fp32"]["counts"][k] + d1["bf16"]["counts"][k] for k in d1["fp32"]["counts"]}
    by_path = {"A": a["kernel"]["counts"], "B": b["kernel"]["counts"],
               "C": c["kernel"]["counts"], f"B{below}": b_below["kernel"]["counts"],
               f"C{below}": c_below["kernel"]["counts"], "F": f["kernel"]["counts"],
               "D1": d1_counts, "D2": d2["counts"],
               "CLI": cli["counts"], "E1": e1["counts"], "E2": e2["counts"],
               "E3": e3["counts"], "E4": e4["counts"]}

    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        head = checks[name][0]  # the shape a driven path gives this kernel
        launches = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches.values()),
            "max_abs_err": max(r["err"][0] for r in checks[name]),
            "max_rel_err": max(r["err"][1] for r in checks[name]), "tol": head["tol"],
            "ms": head["ms"][0], "plain_ms": head["plain_ms"][0],
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "floor_ms": floor_of(name),
            "library_ms": None if head["library_ms"] is None else head["library_ms"][0],
            "library": LIBRARY_CALLS[name], "host_ms": head["ms"][1], "shape": head["shape"],
            "launches_by_path": launches,
            "shapes": [{
                "shape": r["shape"], "max_abs_err": r["err"][0], "max_rel_err": r["err"][1],
                **({} if r.get("row_err") is None else {"max_row_rel_err": r["row_err"]}),
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
