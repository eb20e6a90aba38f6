#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-times [CHECKOUT]
    python3 chip_smoke.py --sharded
    python3 chip_smoke.py --dr
    python3 chip_smoke.py --train

The second form only times a checkout's flash attention at phase 2's cases
that do not route to the wgmma kernel, to compare two checkouts on one card;
the third builds the kernels and runs Paths G4 to G9 alone, the fourth
Path DR alone, the fifth Paths E9 with G11 and G10 (none of the three prints
a result line).

Phases, each unguarded (any failure ends the run with a non-zero code and
no result line):

0. the card's name and power limit, torch / CUDA / Triton versions;
1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. time an empty kernel by each route (Triton, CUDA C++ through ctypes),
   the floor under every kernel's time; hold every kernel against its
   plain PyTorch version on the card, at the shapes the main path gives
   it, and time kernel, plain version, the library yardstick where one
   exists, against the kernel's bound and floor (flash attention: the bf16
   wgmma kernel and the mma.sync kernel (float32 as 3xTF32, bf16 at D = 8,
   16, 32) at Paths E1, G1, G2, G3, E5, E7, E10 and E11's shapes (E10's:
   Whisper's non-causal encoder at S = 1500, its decoder, its
   cross-attention at Sq = 448 and Sq = 1 against Sk = 1500) and the
   training CLI's SMOKE head (bf16, D = 8), also at the reference tests'
   shapes, a ragged S, D = 16, 32 and 256, float32 Sq < Sk and Sq > Sk; the
   soft-threshold pair as CPISTA
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
6a. Path T — the plan autotuner (``repro_torch.ops.tune``) on Path D1's
   problem and mesh: a kernel-tail bf16-wire block walked with the launch
   counters zeroed around the walk (the kernels the walk heard must equal
   the counters); ``plan(op, mesh, tune=True, batch=4)`` on a fresh store
   (candidates, walked groups, the model's top 5 with its terms as the
   store entry keeps them, wall time),
   ``tune="measure"`` (the measured top 2, the pick beside the model's, the
   kernels launched while tuning: cpadmm_tail > 0), the same call warm (one
   cache hit, nothing scored or measured, the same config), then the tuned
   plan's 600-iteration solve against Path A's kernel step, its ms/iter
   beside D1's fp32 plan (the launches of the three tune calls and of the
   solve read apart, each after its own zeroing); Path T-D2: the
   measure-mode tune on D2's four gloo ranks (2x2): one config on every
   rank, the store written once; after each, every wire-kernel signature
   the tune launched replayed bit-exact against the plain version;
6b. Path M — Sec. 7 map-making (Herschel-style) at Path A's frame size: an
   ``extended_emission`` sky of 1024x1024 seen at 4 dithered offsets (0, 1,
   W, W + 1) through one optic (gaussian PSF sigma 1.5, romberg sensing,
   m = n/2), 400 CPADMM iterations under l1 (the kernel step:
   spectral_pointwise and cpadmm_tail once an iteration) and under TV (the
   plain step, no kernel), and l1 on the plain step; each prior's apply
   (non-negative l1, TV, wavelet haar and db4) at that shape held card
   against CPU, the l1 kernel step against the plain step in the map, and
   the TV solve at 256x256 x 4 frames card against CPU;
6c. Path MD1 — Path M's TV problem on Path D1's one-rank NCCL mesh (rfft,
   the hybrid step: the fused transform core, then TV on the gathered
   signals), 100 iterations with fp32 and bf16 wires, against the local TV
   solve (the bf16 wire runs both ``wire_pack`` kernels);
7. Path D2 — four gloo ranks sharing the card
   (``spawn_fake_devices(4, ..., device="cuda:0")``) on a 2x2 (data x
   model) mesh, the same problem at 200 iterations with ``overlap=2``, fp32
   and bf16 wires, held against a local kernel-step solve;
7b. Path S — Sec. 6 serving at the serve CLI's defaults: n = 16384, m =
   n/2, k = n/10, 16 requests from a seeded Poisson stream at 200/s,
   slots 8, round_iters 32, tolerances 3:1 from 1e-3 and 1e-6, max_iters
   2000, min_iters 50, CPADMM (alpha 1e-4, rho = sigma = 0.01) on a
   WallClock: ``warmup`` (the engine captures its round as a CUDA graph),
   the continuous run (spectral_pointwise and cpadmm_tail counted: once a
   replayed step each), then ``static_batch_serve`` on the same stream;
   signals/s, p50/p99, host against device ms a round, the device's idle
   share; a lane recycled (here and in S4096, S-D1 and the serve CLI's
   runs, each more requests than a bucket's slots); every result against
   a solo eager ``solve_until`` (x within TOL_PATHS, equal iteration
   counts), every request converged with MSE <= 1e-4; Path S4096: 16
   requests of the stream at n = 4096 with ``method="ista"``
   (circulant_matvec twice a step, soft_threshold_ista once), held the
   same way against its solo solves (CPISTA at these settings stops short
   of 1e-4 in MSE, alone as in the engine, and the reference's does too:
   printed, not gated); Path S-D1: 16 requests on the one-rank NCCL mesh,
   an fp32-wire and a bf16-wire bucket of 4 slots each (rfft, the kernel
   tail, eager rounds: cpadmm_tail and both wire_pack kernels counted),
   fp32 lanes against their solo solve under the same plan, bf16 lanes
   within twice the wire bound;
7c. Path H — D2's problem on four gloo ranks sharing the card on
   ``make_hier_mesh(1, 2, 2)`` at ``overlap=2``, 25 iterations: the flat
   exchange over the factored axis, the two-stage exchange (bit-equal to
   it) and the two-stage exchange with bf16 inter-host hops (within the
   wire bound); ms/iter on rank 0 and the bytes a transpose hands each
   tier;
8. the recovery CLI (``python -m repro_torch.launch.recover``) as a user
   runs it, with no flag for the step (on the card the plan resolves to
   the kernel step): a checkpointed CPADMM run at its default n = 65536,
   B = 4, run a second time to resume from the checkpoint, a Sec. 7 deblur
   run of two 512x512 frames in tolerance mode (one spectral_pointwise and
   one cpadmm_tail launch an iteration, counted); then ``--prior
   nonneg-l1``, ``wavelet`` and ``tv`` at n = 65536 = 256^2, B = 4 (no
   kernel launch);
8b. every command a user runs as a process, in one batch (15 chains, up to
   PROCESS_WORKERS at once, a chain's commands in order; its wall time
   beside the commands' summed time): ``--tune measure`` through the
   recovery CLI twice on one store (the second run hits it) and ``--tune``
   through the serve CLI on a one-rank mesh; the serve CLI (``python -m
   repro_torch.launch.serve``) ``--n 16384 --requests 16
   --compare-static`` and ``--mesh 1 --rfft``, its report lines checked;
   the recovery CLI's 2x2-mesh deblur run of four 512x512 frames on four
   ranks sharing the card with bf16 wires, run twice to resume, and
   ``--deblur --size 512 --prior tv``; the six ``examples/torch_*.py`` at
   their defaults, each from a directory of its own (the training example
   ``torch_train_lm.py`` among them: 200 steps of a ~40M parameter widened
   codeqwen), and the distributed one again with ``--fake-devices 4``: the
   quickstart must recover with both methods; Path DR's meta walks (below);
   Path G10's meta walks (below); the training CLI
   (``python -m repro_torch.launch.train --arch minitron-4b --smoke
   --steps 20 --ckpt-every 10``, the SMOKE head D = 8 on the mma.sync
   kernel), then again: the second run must resume from step 20; every
   command must exit 0;
9. Path E1 — minitron-4b FULL (32 layers, d_model 3072, GQA 24/8, head_dim
   128, vocab 256000; float32 parameters, bf16 compute) initialised on the
   card from a seed, prefilling 4 prompts of 2048 tokens through
   ``make_prefill_step``: the bf16 wgmma flash attention kernel in
   every layer (32 launches); device and host ms, tokens/s, peak memory,
   the attention's share of a profiled prefill;
10. Path E2 — the same prompts cut to 32 tokens through
   ``make_decode_step`` one token at a time (the reference's cache
   attention, no kernel), the last steps profiled, held against a prefill
   of the same prompts (5e-2 norm-relative);
11. Path E4 — ``greedy_generate``: 4 prompts of 32 tokens, 32 new tokens;
12. Path E3 — minitron-4b's width cut to 2 layers in float32, initialised
   once on the card and copied to the CPU: a prefill on the CPU (plain
   attention) against the same
   prefill on the card (the mma.sync kernel, 3xTF32), 1e-4 norm-relative;
12b. Path G3 — E3's parameters: ``loss_fn``'s loss and every gradient leaf on
   the CPU (plain attention, autograd) against the card (the mma.sync
   kernel's 3xTF32 forward under ``FlashAttentionFn``, the plain recompute
   backward, cuBLAS's TF32 off), batch 2 x 64, no optimizer step: the loss
   within TOL_CARD_CPU, each leaf within TOL_CARD_CPU_GRAD, 4 mma launches
   (remat: two a layer);
13. Path G1 — dense training at full width: minitron-4b FULL cut to 4 layers
   (1.90 B parameters, ~34 GB of state), initialised on the card from a
   seed, 10 steps of ``make_train_step`` at 4 x 2048 tokens (AdamW warmup 3,
   total 10), each step's batch from (seed, step) as the launcher draws it;
   step 1's gradient must reach every leaf; device and host ms a
   step, tokens/s, peak memory, the bound (operations at 989 TFLOP/s plus the
   optimizer's bytes at 3.35 TB/s); every step cut by CUDA events between
   the train step's own two halves (``train_step.gradient``,
   ``train_step.apply``) into gradient and optimizer; an 11th step under
   torch.profiler (the kernel's share of it), and, as an isolated
   estimate, ``FlashAttentionFn``'s backward at a layer's shape alone (the
   plain recompute); gated on finite losses and gradient norms, the loss at
   step 10 below step 1's, 80 sm90 launches (4 layers x 2 x 10 steps);
14. Path G2 — MoE training at full width: moonshot-v1-16b-a3b FULL cut to 3
   layers (one dense, two of 64 routed top-6 experts + 2 shared; 1.93 B
   parameters), the same 10 steps and figures, plus aux a step, the dropped
   share of (token, choice) pairs in each MoE layer (from a forward outside
   the timed steps, before and after them) and, as an isolated estimate,
   ``moe_ffn``'s forward and backward at a layer's shape alone; the same
   gates, 60 sm90 launches; then one trained
   MoE layer's routing of 8192 tokens on the card against the CPU: equal ids
   wherever the k-th choice is decided by more than ROUTING_MARGIN (1e-4),
   the tokens under it counted;
15. Path E5 — G2's trained model: ``make_prefill_step`` on 4 x 2048 prompts
   (3 sm90 launches), ``greedy_generate`` on 4 prompts of 32 tokens, 16 new;
   gated on finiteness, shapes and launches only (an MoE decode routes B
   tokens a step under capacity 1: it does not agree with a prefill, on the
   reference either);
15b. Path G10 — the five later families trained at full width, cut in
   depth (and experts) only, as Paths G7-G9 cut them: zamba2-1.2b to 7
   layers (the shared block twice) and xlstm-350m to 8 (7 mLSTM, 1 sLSTM) at
   4 x 2048 tokens, whisper-large-v3 uncut (32 + 32 layers) at 4 x (1500
   frames + 448 tokens), pixtral-12b to 4 layers at 4 x (1024 image
   embeddings + 1024 tokens), deepseek-v3 to 2 layers (one dense, one MoE of
   16 routed experts top-8 and the shared one) at 2 x 2048; frames and image
   embeddings drawn on the card N(0, 0.02^2); each ``init_train_state`` from a
   seed (bf16 compute over float32 master weights and Adam state), step 1's
   gradient (every leaf but router_bias), 4 steps of ``make_train_step`` on
   one batch repeated (AdamW warmup 1, total 4), each cut into gradient and
   optimizer, as G1 / G2, and a 5th profiled where row 9a runs; its bound
   the dry run's meta walk
   of the same step (phase 8b; xlstm-350m walked at S = 256 and 512 and
   extrapolated); deepseek-v3's drops and its routing card vs CPU; gated on
   finite, falling losses, every gradient and row 9a's launches (zamba2 4,
   whisper 192, pixtral 8 a step, none for MLA and xLSTM); each family freed
   before the next;
16b. Paths G4 and G5 — sharded training at full width: minitron-4b FULL
   (24 / 8 heads, d_model 3072, d_ff 9216, vocab 256000) and
   moonshot-v1-16b-a3b FULL (its dense first layer, then one layer of 64
   routed top-6 experts and 2 shared), each cut to 2 layers, float32 with
   cuBLAS TF32 off: 2 steps of ``make_train_step`` (AdamW warmup 1) at 4 x
   512 positions on one rank of the card first (the baseline: each step's
   gradient and the last parameters kept on the host), then on a data 2 x
   model 2 mesh of four gloo ranks sharing the card (``make_host_mesh(2)``,
   ``rules_for_arch``, ``partition.init_sharded_train_state``, the
   launcher's data rows); each step's loss and gradient norm, step 1's
   gradient leaf by leaf and the last parameters held against the baseline
   block by block (over the weights whose gradients agreed at every step:
   ADAM_RHO_SCALE), the
   mma.sync flash kernel counted in every rank, G5's first routing and its
   drops; each step's host ms, its ms in gloo collectives and each rank's
   peak memory printed beside the card; then the trained parameters serve
   on the same ranks and on one rank: a prefill of 4 x 32 tokens, 2 of them
   decoded and 2 greedy tokens (vocabulary-parallel logits gathered
   over the model ranks, each rank's kv heads' cache, G5's MoE decode routed
   under the global capacity), the logits within TOL_CARD_CPU of the one
   rank's and the tokens equal;
16d. Paths G6 and G7 — the same serving at full width from a seed, without
   training, on one rank and then on the same four gloo ranks (float32,
   TF32 off): whisper-large-v3 FULL (20 heads of 64, 10 a rank; d_ff 5120,
   vocab 51866) cut to 2 encoder and 2 decoder layers, 4 x 1500 frames and
   a 4 x 32 prompt: the prefill, the decode state's ``encoder_forward``, 2
   fed tokens and 2 greedy ones from an argmax loop over
   ``make_decode_step`` (``greedy_generate`` refuses Whisper), the mma.sync
   kernel counted in every rank (non-causal S = 1500, causal 32, cross Sq =
   32 and 1 against 1500); deepseek-v3-671b FULL cut to one dense and one
   MoE layer of 16 of its 256 routed experts (3.373 B parameters), decoding
   with ``mla_absorbed`` False, then True (no kernel: MLA is plain code);
   the ranks draw the global parameters one at a time and keep their blocks;
   every prefill's and greedy token's logits within TOL_CARD_CPU of one
   rank's, the tokens equal; each rank's host ms, its ms in gloo
   collectives and its peak memory printed beside the card;
16e. Paths G8 and G9 — the same serving of the recurrent families at full
   width from a seed, float32, TF32 off: zamba2-1.2b FULL (64 SSM heads of
   64 in 8 groups, 32 a rank, so the rank's heads read their groups' B and
   C; the shared block's 32 heads, 16 a rank) cut to 7 Mamba-2 layers, so
   that the shared block runs twice into its one KV cache (the mma.sync
   kernel at 16 heads of 64 in every rank's prefill), its decode cache
   ``shared_invocations`` positions a token; xlstm-350m FULL (4 heads of
   512, d_model 1024, vocab 50304) cut to 8 layers, 7 mLSTM (the rank's 1024
   columns: 2 whole heads) and 1 sLSTM (its weights gathered whole, the
   recurrence run on every rank), no kernel; every prefill's and greedy
   token's logits within TOL_CARD_CPU of one rank's, the tokens equal; each
   rank's host ms, its ms in gloo collectives and its peak memory printed
   beside the card;
16c. Path DR — the dry run held against the card: ``cost_walk.walk`` on
   real CUDA tensors, after one warm call each, of D1's CPADMM block (2
   iterations, fp32 and bf16 wires: cpadmm_tail, pack_wire, unpack_wire)
   and of minitron-4b FULL cut to 2 layers (a train step at 2 x 512
   tokens, a prefill, a decode step: flash_attention_sm90); then the same
   five walks on ``meta`` by the dry run's walkers in a subprocess (rank 0
   of a fake world of one; run in phase 8b's batch on this run's knobs):
   launches, kernel launches, flops, bytes and
   collective bytes gated equal (the card's decode less its host cache-room
   check, which a dry run skips); the card's peak memory printed beside the
   walk's argument plus peak live bytes;
17. Path E6 — deepseek-v3-671b FULL (MLA: 128 heads, q / k head 128 + 64, v
   head 128, latent 512, q latent 1536) cut to 3 layers, one dense and two
   MoE of 32 of the 256 routed experts (top-8 and the shared expert kept;
   5.718 B parameters): prefill 4 x 2048 with no kernel (MLA's attention is
   the plain ``_attend_chunked``, as the reference's), its bound (FLOPs at
   989 TFLOP/s plus the bf16 weights at 3.35 TB/s); 16 prompt tokens decoded
   with ``mla_absorbed`` False and True, in bf16 (timed, the two compared
   beside the tokens they routed differently) and in float32 (held together
   at TOL_PATHS);
   one MLA layer at full width in float32, ``mla_decode`` and
   ``mla_decode_absorbed`` fed 32 positions against ``mla_forward`` at
   TOL_PATHS;
18. Path E7 — zamba2-1.2b FULL, all 38 Mamba-2 layers and the shared
   attention + MLP block after layers 0, 6, ..., 36: prefill 4 x 2048 (the
   wgmma flash kernel once an invocation: 7 launches), its bound;
   ``greedy_generate`` with 4 prompts of 32 tokens and 32 new, ``max_len``
   sized for the shared cache's 7 positions a token, a decode step's device
   and host ms under torch.profiler; gated on finiteness and launches (the
   reference's decode shares one KV cache across the invocations and does
   not agree with its prefill);
19. Path E8 — xlstm-350m FULL, all 24 layers: prefill 4 x 2048 (no kernel),
   its bound, the sLSTM layers' share (one prefill cut by CUDA events between
   its layers: their loop over 2048 positions is host-issued), then 64 prompt
   tokens through ``decode_step`` against a prefill of them, in bf16
   (printed: 24 xLSTM layers amplify bf16 rounding past TOL_PREFILL_DECODE,
   as the reference's own decode does at 8) and in float32 (gated at
   TOL_PREFILL_DECODE);
20. Path E9 — the five families at full width in float32, card against
   CPU: deepseek-v3 cut to 2 layers (8 experts), zamba2 to 7 (two shared
   invocations), xlstm-350m to 8, whisper-large-v3 to 2 encoder and 2
   decoder layers (64 frames), pixtral-12b to 2 (8 image embeddings); a
   prefill of 2 x 16 tokens, whisper's ``encoder_forward`` and 8 decode
   steps at TOL_CARD_CPU (zamba2's shared block and every attention of
   whisper and pixtral on the mma.sync kernel, whisper's non-causal and at
   Sq != Sk); Path G11 — on the same parameters and tokens, ``loss_fn``'s
   loss and every gradient leaf (``grads_of``) card against CPU, cuBLAS's
   TF32 off: the loss within TOL_CARD_CPU, each leaf within
   TOL_CARD_CPU_GRAD, or, for a family with a leaf past it, within
   TOL_CARD_F64_FACTOR times the CPU float32's own error against a float64
   step plus TOL_CARD_CPU_GRAD; row 9b twice an attention (zamba2 4,
   whisper 12, pixtral 4);
21. Path E10 — whisper-large-v3 FULL (32 + 32 layers, d_model 1280, 20
   heads of 64; float32 parameters, bf16 compute): a prefill of 4 x 448
   tokens against 4 x 1500 frames (the wgmma kernel 96 times: encoder,
   decoder, cross), its bound; ``encoder_forward`` alone (32 launches); 32
   decode steps against its output (32 launches a step, the cross-attention
   at Sq = 1), a step profiled and its cross K / V projections timed alone;
22. Path E11 — pixtral-12b FULL (40 layers, d_model 5120, 32 over 8 heads of
   128), parameters in bf16: a prefill of 4 x (1024 image embeddings + 1024
   tokens) (40 launches), its bound; how far the image moves the last
   logits against a text-only prefill (printed); 32 text tokens decoded
   against a text-only prefill of them at TOL_PREFILL_DECODE;
23. the seconds of every phase, one JSON line with every kernel's
   launches, error, times, bound and floor, then the device line ``{"ok":
   true, "device": {...}}`` last.

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
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
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
# Path E3: float32 on the card (the mma.sync kernel's 3xTF32 products, within
# TOL_FLASH of a float32 softmax; cuBLAS with TF32 off) against float32 on the
# CPU (plain attention), 2 layers at full width.
TOL_CARD_CPU = 1e-4
# Path G3: the float32 gradient of minitron-4b's width (2 layers, 2 x 64
# tokens) on the card against the CPU's, leaf by leaf, norm-relative.  Both
# sides differentiate the same plain functions (the attention's backward is
# _attend_chunked on both); the forward's attention differs (the mma.sync
# kernel's 3xTF32 products against the plain version, within TOL_FLASH's 2e-5
# of its scale),
# and every gradient downstream of it carries that relative difference; the
# float32 sums in another order (cuBLAS against MKL, TF32 off) add ~2^-24
# sqrt(n) ~ 6e-6 at n = 9216.  So 2e-5 (5.3e-6 measured at the worst leaf, the
# embedding table, on an H100 80GB HBM3 at 700 W).
TOL_CARD_CPU_GRAD = 2e-5
# Path G11: the same gate for the five families of Path E9.  Where a family's
# leaf misses TOL_CARD_CPU_GRAD, float32 itself may be the cause: it puts
# Mamba-2's a_log up to 1.9e-5 and mLSTM's w_v up to 7.0e-5 of their largest
# values from a float64 step on the CPU (their long recurrences sum many
# terms of both signs), so two float32 runs that sum in other orders (cuBLAS
# against MKL) may sit twice that apart.  Such a family's step runs once more
# on the CPU in float64, from a float64 copy of the same parameters, and each
# leaf's card error against it must be at most TOL_CARD_F64_FACTOR times the
# CPU float32's own error against it, plus TOL_CARD_CPU_GRAD: the card is as
# far from exact as the CPU's float32 is (the factor 2 for its other order of
# sums), plus the forward's attention difference that TOL_CARD_CPU_GRAD
# bounds.  A leaf within TOL_CARD_CPU_GRAD of the CPU meets this too (the
# triangle inequality), so the rule only widens the gate where float32's own
# rounding is larger than it.
TOL_CARD_F64_FACTOR = 2.0
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


SPIN_CYCLES = 400_000_000  # ~0.2 s of device spin at H100 clocks: the longest a timing queues
SPIN_MIN_CYCLES = 100_000_000  # ~0.05 s: the shortest
SPIN_CYCLES_PER_S = 2e9  # the H100's boost clock, ~1.98 GHz
SPIN_MARGIN = 4  # the spin's length over the enqueue the warm-up calls predict


def timed(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``, over ``iters`` calls.

    A device spin is queued first, so the host enqueues every call before
    the first one runs: the CUDA events then time the device alone, back to
    back, and the host clock times the launch path alone (wrapper checks,
    Triton / ctypes launch, torch dispatch).  The spin lasts SPIN_MARGIN
    times the enqueue of ``iters`` calls at the slowest warm-up call's host
    time after the first (which may compile), between SPIN_MIN_CYCLES and
    SPIN_CYCLES.  Fails if the host took longer than the spin, which would
    let host gaps into the device time; keep ``iters`` x launches per call
    well under the CUDA launch queue's depth, or the host blocks on the full
    queue until the spin ends.
    """
    import torch

    per_call = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        fn()
        if i or warmup == 1:
            per_call = max(per_call, time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(min(SPIN_CYCLES, max(SPIN_MIN_CYCLES,
                                      SPIN_MARGIN * iters * per_call * SPIN_CYCLES_PER_S)))
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= 0.9 * spin.elapsed_time(start):
        fail(f"host enqueue ({host_ms:.1f} ms) outlasted the device spin "
             f"({spin.elapsed_time(start):.1f} ms); raise SPIN_MIN_CYCLES or SPIN_MARGIN")
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
    t0 = [time.perf_counter()]

    def took(what):  # host seconds of each part of this phase
        now = time.perf_counter()
        print(f"phase 2 {what}: {now - t0[0]:.1f} s")
        t0[0] = now

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
    took("spectral_pointwise, cpadmm_tail, circulant_matvec")
    crossover_sweep(rnd)
    took("the crossover sweep")
    check_thresholds(dev, gen, rnd, results)
    took("the soft-threshold pair and its grid sweep")

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
    took("banded_conv")
    check_wire(dev, gen, results)
    took("the wire kernels")
    check_flash(dev, gen, results)
    took("the flash kernels")
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
    (inverse transpose).

    The tuner's candidates (Paths T and T-D2, bf16 wires only) send more:
    D1's full-complex (2, 4, 1024, 1024) payload, and on D2's 2x2 mesh at
    1024^2 frames a rank's full-complex and rfft payloads, all four frames
    or two (the batch on the data axis), each at K = 1.  The tunes' other
    shapes (K > 1 chunks, the unbatched exchanges) are replayed after each
    tune (:func:`replay_wire_calls`)."""
    import torch

    from repro_torch.kernels.wire_pack.ops import WIRE_DTYPES, pack_wire, unpack_wire
    from repro_torch.kernels.wire_pack.ref import pack_wire_ref, unpack_wire_ref

    every, tuner = ("bf16", "fp16", "fp32"), ("bf16",)  # the main path's wire first
    # (label, payload shape, groups, pack axis, unpack axis, wires)
    cases = (("path D1: (2, 4, 1024, 513), 1 rank", (2, 4, 1024, 513), 1, -1, -2, every),
             ("path D2 forward: (2, 2, 256, 514), 2 ranks", (2, 2, 256, 514), 2, -1, -2, every),
             ("path D2 inverse: (2, 2, 1024, 129), 2 ranks", (2, 2, 1024, 129), 2, -2, -1, every),
             ("ragged L=1000, special values", (1000,), None, -1, -1, every),
             ("path T full complex: (2, 4, 1024, 1024), 1 rank", (2, 4, 1024, 1024), 1, -1, -2,
              tuner)) + tuple(
        (f"path T-D2 {way}, {kind}{batch}: {shape}, 2 ranks", shape, 2, p_ax, u_ax, tuner)
        for kind, cols in (("full complex", 1024), ("rfft", 514))
        for batch, frames in (("", 4), (", batch on data", 2))
        for way, shape, p_ax, u_ax in (("forward", (2, frames, 512, cols), -1, -2),
                                       ("inverse", (2, frames, 1024, cols // 2), -2, -1)))
    for label, shape, groups, p_axis, u_axis, wires in cases:
        z = torch.randn(*shape, generator=gen, device=dev, dtype=torch.complex64)
        if shape == (1000,):
            z = _special_values(z)
        n = z.numel()
        for wire in wires:
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


# check_flash's cases: (label, dtype, B, Sq, Sk, H, KH, D, causal)
FLASH_CASES = ([("paths E1, G1: minitron-4b", "bfloat16", 4, 2048, 2048, 24, 8, 128, True),
                ("paths G2, E5: moonshot-v1-16b-a3b", "bfloat16", 4, 2048, 2048, 16, 16, 128,
                 True),
                ("path E7: zamba2-1.2b", "bfloat16", 4, 2048, 2048, 32, 32, 64, True),
                ("path E10: whisper-large-v3 encoder", "bfloat16", 4, 1500, 1500, 20, 20, 64,
                 False),
                ("path E10: whisper-large-v3 decoder", "bfloat16", 4, 448, 448, 20, 20, 64, True),
                ("path E10: whisper-large-v3 cross", "bfloat16", 4, 448, 1500, 20, 20, 64, False),
                ("path E10: whisper-large-v3 decode cross", "bfloat16", 4, 1, 1500, 20, 20, 64,
                 False),
                ("path E11: pixtral-12b", "bfloat16", 4, 2048, 2048, 32, 8, 128, True),
                ("path G4's rank: minitron-4b on a data 2 x model 2 mesh", "bfloat16", 2, 512,
                 512, 12, 4, 128, True),
                ("D=64", "bfloat16", 2, 512, 512, 4, 2, 64, True),
                ("ragged GQA", "bfloat16", 2, 1000, 1000, 8, 1, 128, True),
                ("full", "bfloat16", 1, 300, 300, 4, 4, 128, False),
                ("D=256", "bfloat16", 2, 512, 512, 4, 2, 256, True),
                ("path E1's shape", "float32", 4, 2048, 2048, 24, 8, 128, True),
                ("path G3", "float32", 2, 64, 64, 24, 8, 128, True),
                ("path G6's rank: whisper-large-v3 encoder", "float32", 2, 1500, 1500, 10, 10, 64,
                 False),
                ("path G6's rank: whisper-large-v3 decoder", "float32", 2, 32, 32, 10, 10, 64,
                 True),
                ("path G6's rank: whisper-large-v3 cross", "float32", 2, 32, 1500, 10, 10, 64,
                 False),
                ("path G6's rank: whisper-large-v3 decode cross", "float32", 2, 1, 1500, 10, 10,
                 64, False),
                ("path G8's rank: zamba2-1.2b's shared block", "float32", 2, 32, 32, 16, 16, 64,
                 True),
                ("train CLI: minitron-4b SMOKE", "bfloat16", 16, 256, 256, 6, 2, 8, True),
                ("D=16", "bfloat16", 2, 256, 256, 4, 4, 16, True),
                ("D=32", "bfloat16", 2, 512, 512, 4, 2, 32, True)]
               + [("tests' shape", "float32", 2, s, s, 2, 2, 64, c)
                  for s in (256, 512, 768) for c in (True, False)]
               + [("GQA", "float32", 2, 512, 512, h, kh, 32, True) for h, kh in ((4, 2), (8, 1))]
               + [("ragged", "float32", 2, 1000, 1000, 4, 2, 64, True),
                  ("D=8", "float32", 2, 300, 300, 6, 2, 8, True),
                  ("D=16", "float32", 1, 300, 300, 4, 2, 16, False),
                  ("D=256", "float32", 2, 512, 512, 4, 2, 256, True),
                  ("Sq<Sk, 20 heads", "float32", 2, 300, 1500, 20, 20, 64, False),
                  ("Sq>Sk", "float32", 2, 1000, 300, 4, 2, 64, False)])


def flash_times(root: Path) -> None:
    """``python3 chip_smoke.py --flash-times [CHECKOUT]``: device ms of the
    CHECKOUT's ``flash_attention`` (default: this file's checkout; its kernels
    built under CHECKOUT/build) at every case of :func:`check_flash` that does
    not route to the wgmma kernel, so that two checkouts compare on one card
    (run in the order A, B, B, A)."""
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.flash_attention import ops

    print(card_line())
    print(f"flash times of {Path(ops.__file__).parent}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, dt, b, sq, sk, h, kh, d, causal in FLASH_CASES:
        dt = getattr(torch, dt)
        if ops.kernel_for(dt, d) == "sm90":
            continue
        q, k, v = flash_operands(gen, dev, dt, b, sq, sk, h, kh, d)
        ms = timed(lambda: ops.flash_attention(q, k, v, causal=causal))[0]
        print(f"flash times [{flash_label(label, dt, b, sq, sk, h, kh, d, causal)}]: device ms "
              f"{ms:.4f}")


def flash_operands(gen, dev, dt, b, sq, sk, h, kh, d):
    """q (B, Sq, H, D) and k, v (B, Sk, KH, D), unit normals in ``dt``."""
    import torch

    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dt)
    k, v = (torch.randn(b, sk, kh, d, generator=gen, device=dev).to(dt) for _ in range(2))
    return q, k, v


def flash_label(label, dt, b, sq, sk, h, kh, d, causal) -> str:
    shape = f"S={sq}" if sq == sk else f"Sq={sq} Sk={sk}"
    return (f"{label}: {str(dt).removeprefix('torch.')} B={b} {shape} H={h} KH={kh} D={d} "
            f"causal={causal}")


def sdpa_kernels(fn) -> str:
    """The device kernels one call of ``fn`` runs, by torch.profiler: which
    backend scaled_dot_product_attention picked."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    bare = (name.removeprefix("void ").replace("(anonymous namespace)::", "") for name in names)
    short = list(dict.fromkeys(re.split(r"[(<]", n)[0].split("::")[-1] for n in bare))
    return (f"{len(names)}: {', '.join(short[:4])}{', ...' if len(short) > 4 else ''}"
            if names else "no device kernel recorded")


def check_flash(dev, gen, results) -> None:
    """flash_attention against its plain version, through the public wrapper,
    which routes bf16 at D in SM90_HEAD_DIMS to the wgmma kernel and the rest
    to the mma.sync kernel; the routed kernel's counter must move.

    The wgmma kernel: Paths E1 and G1's shape first (minitron-4b: bf16, B =
    4, S = 2048, H = 24 over KH = 8, D = 128, causal), then Paths G2 and E5's
    (moonshot-v1-16b-a3b: H = KH = 16), E7's (zamba2), Path E10's four
    (whisper-large-v3, 20 heads of 64: the non-causal encoder at a ragged S =
    1500, the causal decoder at 448, the cross-attention at Sq = 448 and Sq =
    1 against Sk = 1500), E11's (pixtral-12b, 32 over 8 heads of 128), D = 64,
    a ragged GQA (8, 1) S = 1000, a full (non-causal) S = 300 and D = 256
    (gemma-7b's head).  The mma.sync
    kernel: E1's shape and Path G3's (B = 2, S = 64) in float32, Path G6's
    four at a rank's 10 heads of 64 (the non-causal encoder at S = 1500, the
    causal decoder at 32, the cross at Sq = 32 and 1 against 1500), Path G8's
    (zamba2-1.2b's shared block at a rank's 16 heads of 64, causal S = 32), the training
    CLI's (minitron-4b SMOKE, bf16, B = 16, S = 256, H = 6 over KH = 2, D = 8)
    and D = 16 (the other SMOKE heads) and D = 32 in bf16, then
    tests/test_flash_attention.py's float32 shapes, its GQA mappings, a
    ragged causal S = 1000, D = 8, 16 and 256, and non-causal Sq < Sk (20
    heads) and Sq > Sk.  Each is held against the
    plain version in float32 (TOL_FLASH, TOL_FLASH_ROW) and timed against
    the plain version in its own dtype.  The bound of a float32 case is the
    design's, three TF32 products at 495 TFLOP/s, with one product at the
    fp32 CUDA-core rate printed beside it.  The library yardstick is
    scaled_dot_product_attention on (B, H, S, D) views with enable_gqa and
    is_causal as the case (never
    called by the port); its own error against the same float32 plain
    version is printed beside the kernel's, and in float32 its time with the
    KV heads expanded to H before the timed calls and the kernels it ran, a
    finding and no gate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cases = [(label, getattr(torch, dt), *shape) for label, dt, *shape in FLASH_CASES]
    for label, dt, b, sq, sk, h, kh, d, causal in cases:
        q, k, v = flash_operands(gen, dev, dt, b, sq, sk, h, kh, d)
        flops = 4 * b * h * sq * sk * d / (2 if causal else 1)  # Q.K^T and P.V
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        name = str(dt).removeprefix("torch.")
        fp32 = dt == torch.float32
        kernel = f"flash_attention_{ops.kernel_for(dt, d)}"
        wrapper = getattr(ops, kernel)
        before = wrapper.launches
        want = lambda a=(q, k, v, causal): flash_attention_ref(
            *(t.float() for t in a[:3]), causal=a[3])
        library = lambda a=(q, k, v, causal): F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a[:3]), is_causal=a[3], enable_gqa=True)
        label = flash_label(label, dt, b, sq, sk, h, kh, d, causal)
        results[kernel].append(check_shape(
            kernel, label,
            lambda a=(q, k, v, causal): ops.flash_attention(*a[:3], causal=a[3]),
            lambda a=(q, k, v, causal): flash_attention_ref(*a[:3], causal=a[3]),
            TOL_FLASH[name], nbytes, 3 * flops if fp32 else flops, want=want,
            row_tol=TOL_FLASH_ROW[name], library=library,
            plain_iters=5 if max(sq, sk) >= 2048 else 20,
            flops_per_s=TF32_FLOPS_PER_S if fp32 else BF16_FLOPS_PER_S,
        ))
        if wrapper.launches == before:
            fail(f"{kernel} [{label}]: the wrapper routed the call elsewhere")
        lib_out, ref_out = library().transpose(1, 2), want()
        print(f"  library [{label}] vs the float32 plain version: norm-rel "
              f"{rel_err(lib_out.float(), ref_out)[1]:.3e}, row by row "
              f"{row_rel_err(lib_out, ref_out):.3e} (a finding, not a gate)")
        if fp32:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            kt, vt = (t.repeat_interleave(h // kh, dim=1) for t in (kt, vt))
            expanded = lambda a=(qt, kt, vt, causal): F.scaled_dot_product_attention(
                *a[:3], is_causal=a[3])
            print(f"  [{label}] beside the bound, one product at the fp32 CUDA-core rate: "
                  f"{bound(nbytes, flops)[0]:.4f} ms; library with the KV heads expanded "
                  f"to H outside the timed calls: {timed(expanded)[0]:.4f} ms, device kernels "
                  f"[{sdpa_kernels(expanded)}] (enable_gqa: [{sdpa_kernels(library)}]); a "
                  f"finding, not a gate")


def _wrappers() -> dict:
    from repro_torch.kernels.banded_conv.ops import blur_apply
    from repro_torch.kernels.circulant_matvec.ops import circulant_matvec_direct
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.flash_attention.ops import flash_attention_mma, flash_attention_sm90
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
        "flash_attention_mma": flash_attention_mma,
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


def step_times(prob, plan, method="cpadmm", calls=5, **kw) -> tuple[float, float]:
    """(device ms, host ms) of one solver step in steady state: how long the
    card is busy per iteration, and how long the host takes to issue it.
    A plain step issues ~25 launches; a TV step ~210 (``calls`` 2 keeps the
    queue short)."""
    from repro_torch.core.solvers import make_stepper

    stepper = make_stepper(prob, method, plan=plan, **kw)
    state = [stepper.init()]

    def one():
        state[0] = stepper.step(state[0])

    return timed(one, iters=calls)


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


def profile_window(fn, label, steps=5, host=True) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``fn``: prints the device's
    busy share of the window, device time by kernel name and (``host``) the
    host ops that cost most, per call; returns {"wall_ms", "busy_ms",
    "kernels": {name: device ms}, "launches": device operations} per call.
    Without ``host`` the profiler records the device's activity alone, which
    a window of ~10^4 launches needs: their host ops take tens of seconds to
    read back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
    host_ops = [e for e in events if host and e.device_type != DeviceType.CUDA]
    for e in sorted(host_ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
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


# -- Paths T, T-D2: the plan autotuner (repro_torch.ops.tune) on D1's problem --
TUNE_BATCH = 4  # D1's frames: the tuning workload's batch


def _print_ranking(label, ranking) -> None:
    from repro_torch.ops.plan import PlanConfig

    for r in ranking:
        t = r["detail"]
        print(f"  {label} {PlanConfig.from_dict(r['config']).describe()}: memory "
              f"{t['memory_s'] * 1e3:.4f}, collective {t['collective_s'] * 1e3:.4f}, launches "
              f"{t['launches']} -> {t['launch_s'] * 1e3:.4f}, modeled total "
              f"{t['modeled_total_s'] * 1e3:.4f} ms a block")


@contextlib.contextmanager
def recorded_wire_calls():
    """Record every ``pack_wire`` / ``unpack_wire`` call the mesh exchange
    makes inside the block: yields a set that fills with (kernel, shape,
    wire, groups or grouped, axis), the arguments that fix a launch's
    geometry.  The calls themselves go through unchanged and are counted as
    ever."""
    import torch

    from repro_torch.dist import fft
    from repro_torch.kernels.wire_pack.ops import WIRE_DTYPES

    calls, pack, unpack = set(), fft.pack_wire, fft.unpack_wire
    wire_of = {dt: name for name, dt in WIRE_DTYPES.items()}

    def pack_recorded(z, wire_dtype, groups=None, axis=-1):
        calls.add(("pack_wire", tuple(z.shape), wire_dtype, groups, axis % z.ndim))
        return pack(z, wire_dtype, groups=groups, axis=axis)

    def unpack_recorded(w, out_dtype=torch.complex64, grouped=False, axis=-1):
        chunk_ndim = w.ndim - (2 if grouped else 1)
        calls.add(("unpack_wire", tuple(w.shape), wire_of[w.dtype], grouped, axis % chunk_ndim))
        return unpack(w, out_dtype, grouped=grouped, axis=axis)

    fft.pack_wire, fft.unpack_wire = pack_recorded, unpack_recorded
    try:
        yield calls
    finally:
        fft.pack_wire, fft.unpack_wire = pack, unpack


def replay_wire_calls(dev, seed, calls, label) -> None:
    """Call the wire kernels again at every recorded signature, on fresh
    random inputs of its shape, and hold each bit-exact against its plain
    version: a kernel wrong at a shape that only a tuning candidate sends
    (a K > 1 chunk, another factorization) could otherwise win a tune
    unseen, since the tune's blocks run on zeros and drop their results.
    Called after the path's counts are read, so these launches are not the
    path's."""
    import torch

    from repro_torch.kernels.wire_pack.ops import WIRE_DTYPES, pack_wire, unpack_wire
    from repro_torch.kernels.wire_pack.ref import pack_wire_ref, unpack_wire_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, shape, wire, split, axis in sorted(calls, key=repr):
        if name == "pack_wire":
            z = torch.randn(*shape, generator=gen, device=dev, dtype=torch.complex64)
            got = pack_wire(z, wire, groups=split, axis=axis)
            want = pack_wire_ref(z, wire, groups=split, axis=axis)
        else:
            w = torch.randn(*shape, generator=gen, device=dev).to(WIRE_DTYPES[wire])
            got = unpack_wire(w, grouped=split, axis=axis)
            want = unpack_wire_ref(w, grouped=split, axis=axis)
        if not torch.equal(got, want):
            fail(f"{label}: {name} at {shape} ({wire}, {split}, axis {axis}) is not bit-equal "
                 f"to its plain version")
    kinds = [c[0] for c in calls]
    print(f"{label}: the wire kernels' {len(calls)} launch signatures (pack_wire "
          f"{kinds.count('pack_wire')}, unpack_wire {kinds.count('unpack_wire')}) replayed on "
          f"fresh inputs, each bit-exact against its plain version")


def _walk_matches_counters(p, mesh) -> dict:
    """A kernel-tail, bf16-wire block of D1's plan walked with the launch
    counters zeroed around the walk alone: the kernels the walk heard must be
    the wrappers' own counts."""
    from repro_torch.launch.cost_walk import walk
    from repro_torch.ops import tune
    from repro_torch.ops.plan import plan

    pl = plan(p.op, mesh, rfft=True, tail="kernel", wire_dtype="bf16")
    operands = tune._block_operands(pl, TUNE_BATCH)
    pl.cpadmm_block(1)(*operands)
    zero_counts()
    cost = walk(pl.cpadmm_block(tune.SCORE_ITERS), *operands)
    counts = {k: v for k, v in read_counts().items() if v}
    print(f"Path T walk: a kernel-tail bf16-wire block of {tune.SCORE_ITERS} iterations, "
          f"{cost.launches} launches, {cost.bytes / 1e6:.3f} MB, {cost.flops / 1e9:.4f} GFLOP, "
          f"wire {cost.collective_bytes}; kernels heard {cost.kernel_launches}, counted {counts}")
    if cost.kernel_launches != counts or not counts.get("cpadmm_tail"):
        fail(f"Path T: the walk heard {cost.kernel_launches}, the wrappers counted {counts}")
    return counts


def path_t(dev, seed, x_a, d1, size=1024, frames=4, iters=600) -> dict:
    """The plan autotuner on D1's problem and one-rank NCCL mesh: model mode
    on a fresh store, measure mode, the same call warm, then the tuned plan's
    600-iteration solve against Path A's kernel step.  The counts are zeroed
    before the model-mode call and read after the warm one (the tune's
    launches, ``counts``), then zeroed again around the solve
    (``solve_counts``); the wire kernels' signatures of both are replayed
    against their plain versions afterwards."""
    import torch

    from repro_torch.core.deblur import deblur_metrics
    from repro_torch.dist.compat import make_mesh
    from repro_torch.ops import tune
    from repro_torch.ops.plan import plan

    prob, p = sec7_problem(dev, seed, size, frames)
    mesh = make_mesh((1,), ("model",), device=dev)
    _walk_matches_counters(p, mesh)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as store_dir, \
            recorded_wire_calls() as wire_calls:
        opts = {"cache": tune.PlanCache(str(Path(store_dir) / "plan_cache.json"))}
        zero_counts()
        t0 = time.perf_counter()
        tune.reset_counters()
        model = plan(p.op, mesh, tune=True, batch=TUNE_BATCH, tune_opts=opts)
        model_s = time.perf_counter() - t0
        entry = next(iter(opts["cache"].entries().values()))
        groups = len({tune._group_key(c)
                      for c in tune.candidate_configs(p.op, mesh, batch=TUNE_BATCH)})
        print(f"Path T model mode: {entry['candidates']} candidates in {groups} walked groups "
              f"({tune.COUNTERS['scored']} walks), tune wall time {model_s:.3f} s, pick "
              f"{model.config.describe()}")
        _print_ranking("model top 5:", entry["ranking"])
        if entry["ranking"][0]["config"] != model.config.to_dict():
            fail(f"Path T: the model's pick {model.config} is not its ranking's first "
                 f"{entry['ranking'][0]['config']}")
        tune.reset_counters()
        before = read_counts()
        t0 = time.perf_counter()
        measured = plan(p.op, mesh, tune="measure", batch=TUNE_BATCH, tune_opts=opts)
        measure_s = time.perf_counter() - t0
        during = {k: v - before[k] for k, v in read_counts().items()}
        entry = next(iter(opts["cache"].entries().values()))
        print(f"Path T measure mode: {dict(tune.COUNTERS)}, tune wall time {measure_s:.3f} s, "
              f"pick {measured.config.describe()} (the model's pick: "
              f"{'the same' if measured.config == model.config else 'another'})")
        for m in entry["measured_top_k"]:
            print(f"  measured {m['s'] * 1e3:.4f} ms a {tune.SCORE_ITERS}-iteration block: "
                  f"{tune.PlanConfig.from_dict(m['config']).describe()}")
        print(f"Path T launches during the measure-mode tune (walks, warm-ups, timed blocks): "
              f"cpadmm_tail {during['cpadmm_tail']}, pack_wire {during['pack_wire']}, "
              f"unpack_wire {during['unpack_wire']}")
        if not during["cpadmm_tail"] > 0:
            fail(f"Path T: the measure-mode tune launched no cpadmm_tail ({during})")
        tune.reset_counters()
        t0 = time.perf_counter()
        warm = plan(p.op, mesh, tune="measure", batch=TUNE_BATCH, tune_opts=opts)
        warm_s = time.perf_counter() - t0
        print(f"Path T warm: {dict(tune.COUNTERS)}, {warm_s * 1e3:.3f} ms, "
              f"{warm.config.describe()}")
        if tune.COUNTERS != {"scored": 0, "measured": 0, "cache_hits": 1, "cache_misses": 0} \
                or warm.config != measured.config:
            fail(f"Path T: the warm call {dict(tune.COUNTERS)} / {warm.config} did not hit "
                 f"the stored {measured.config}")
        tune_counts = read_counts()
        print(f"Path T launches of the three tune calls (model, measure, warm) {tune_counts}")
        zero_counts()
        x, _, ms_iter = timed_solve(prob, measured, iters, iters, **SEC7_KW)
        counts = read_counts()
    replay_wire_calls(dev, seed, wire_calls, "Path T")
    diff = ((x - x_a).norm() / x_a.norm()).item()
    tol = TOL_PATHS if measured.wire_dtype == "fp32" else WIRE_ERROR_BOUND
    print(f"Path T tuned solve: {measured.config.describe()}, {iters} iters, {ms_iter:.4f} "
          f"ms/iter (solve, host clock) beside D1's fp32 plan {d1['fp32']['ms_iter']:.4f}, "
          f"PSNR dB {deblur_metrics(p, x)['psnr_db'].tolist()}, x-hat vs Path A kernel step "
          f"norm-rel {diff:.3e} (tol {tol:.0e}); the solve's launches {counts}")
    if x.shape != x_a.shape or not bool(torch.isfinite(x).all()):
        fail(f"Path T result has shape {tuple(x.shape)} or non-finite values")
    if not diff <= tol:
        fail(f"Path T's tuned solve disagrees with Path A: {diff} > {tol}")
    return dict(counts=tune_counts, solve_counts=counts, model=model.config,
                measured=measured.config, ms_iter=ms_iter, tune_s=(model_s, measure_s, warm_s),
                diff=diff)


def _t_d2_rank(seed, size, frames, store):
    """One rank of Path T-D2: the measure-mode tune on D2's 2x2 mesh; its
    pick, counters, store writes and launch counts."""
    import torch.distributed as dist

    from repro_torch.dist.compat import make_mesh, rank_device
    from repro_torch.ops import tune
    from repro_torch.ops.plan import plan

    class CountingCache(tune.PlanCache):
        puts = 0

        def put(self, key, entry):
            type(self).puts += 1
            super().put(key, entry)

    _, p = sec7_problem(rank_device(), seed, size, frames)
    mesh = make_mesh((2, 2), ("data", "model"))
    cache = CountingCache(store)
    zero_counts()
    tune.reset_counters()
    dist.barrier()
    t0 = time.perf_counter()
    with recorded_wire_calls() as wire_calls:
        pl = plan(p.op, mesh, tune="measure", batch=frames, tune_opts={"cache": cache})
    return dict(config=pl.config.to_dict(), counters=dict(tune.COUNTERS), puts=cache.puts,
                counts=read_counts(), wall_s=time.perf_counter() - t0,
                wire_calls=sorted(wire_calls, key=repr))


def path_t_d2(dev, seed, size=1024, frames=4):
    """Path T-D2: the measure-mode tune on four gloo ranks sharing the card
    (2x2): every rank must return one config, and the store is written once.
    A rank path (:func:`run_on_ranks`)."""
    from repro_torch.ops import tune

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store_dir:
        store = str(Path(store_dir) / "plan_cache.json")
        ranks, _ = yield _t_d2_rank, (seed, size, frames, store)
        entries = tune.PlanCache(store).entries()
    r0 = ranks[0]
    counts = {k: sum(r["counts"][k] for r in ranks) for k in r0["counts"]}
    print(f"Path T-D2: 4 gloo ranks on one card, mesh 2x2, measure mode: pick "
          f"{tune.PlanConfig.from_dict(r0['config']).describe()}, counters {r0['counters']}, "
          f"tune wall time on rank 0 {r0['wall_s']:.3f} s, store writes by rank "
          f"{[r['puts'] for r in ranks]}, launches summed over ranks {counts}")
    if any(r["config"] != r0["config"] for r in ranks):
        fail(f"Path T-D2: the ranks picked different configs {[r['config'] for r in ranks]}")
    if [r["puts"] for r in ranks] != [1, 0, 0, 0] or len(entries) != 1:
        fail(f"Path T-D2: the store was written {[r['puts'] for r in ranks]} times "
             f"({len(entries)} entries)")
    replay_wire_calls(dev, seed, {c for r in ranks for c in r["wire_calls"]}, "Path T-D2")
    return dict(counts=counts, config=r0["config"], wall_s=r0["wall_s"])


def tune_cli_chains(d: Path) -> dict:
    """``--tune`` through both CLIs as processes: the recovery CLI's
    measure-mode deblur run twice on one store (the second must hit it),
    and the serve CLI on a one-rank mesh on a store of its own."""
    recover = lambda run: recover_cmd(
        ["--deblur", "--size", "512", "--mesh", "1", "--rfft", "--tune", "measure",
         "--ckpt-dir", str(d / run)], env={"REPRO_TORCH_PLAN_CACHE": str(d / "plan_cache.json")})
    return {"tune recover": [recover("first"), recover("second")],
            "tune serve": [serve_cmd(["--n", "16384", "--requests", "16", "--mesh", "1",
                                      "--tune"],
                                     env={"REPRO_TORCH_PLAN_CACHE": str(d / "serve_plans.json")})]}


def check_tune_cli(out: dict) -> None:
    runs, (serve_out,) = out["tune recover"], out["tune serve"]
    check_serve_out(serve_out)
    tuned = [[ln for ln in run.splitlines() if ln.startswith("tuned plan [measure]: ")]
             for run in runs]
    if [len(t) for t in tuned] != [1, 1] or not tuned[0][0].endswith("(tuned, stored)") \
            or tuned[1][0] != tuned[0][0].replace("(tuned, stored)", "(cache hit)"):
        fail(f"tune CLI: the recovery CLI's tuned plans were {tuned}")
    if any(run.count("PSNR") != 4 for run in runs):
        fail("tune CLI: a --tune deblur run reported no PSNR for its 4 frames")
    if not any(ln.startswith("tuned plan [model]: ") for ln in serve_out.splitlines()):
        fail("tune CLI: the serve CLI reported no tuned plan")


# Sec. 7 map-making (Herschel-style): the paper's application at users' size
MAP_SHIFTS = lambda w: [0, 1, w, w + 1]  # the 2x2 dither on the raster
MAP_KW = dict(alpha=1e-4, rho=0.01, sigma=0.01)
TOL_PROX = 1e-5  # a prior's apply, card against CPU (roll, sub, clamp: ulps)


def map_problem(dev, seed, size, frames=4):
    """An ``extended_emission`` sky of ``size`` x ``size`` seen at the 2x2
    dither through one optic (gaussian PSF sigma 1.5, romberg sensing, m =
    n/2), drawn on the CPU from ``seed`` and placed on ``dev``."""
    import torch

    from repro_torch.core.mapmaking import build_mapmaking_problem
    from repro_torch.data.synthetic import extended_emission

    sky = extended_emission(torch.Generator().manual_seed(seed), size, size, n_sources=3,
                            device=dev)
    return build_mapmaking_problem(torch.Generator().manual_seed(seed + 1), sky,
                                   MAP_SHIFTS(size)[:frames], blur_order=1.5, subsample=0.5,
                                   sensing="romberg", blur_kind="gaussian")


def moved(p, dev):
    """The same map-making problem with every tensor on ``dev``."""
    from repro_torch import interop

    d = lambda t: t.cpu().numpy()
    return interop.mapmaking_problem_from_numpy(
        d(p.deblur.op.circ.col), d(p.deblur.op.circ.spec), d(p.deblur.op.omega),
        d(p.deblur.blur.col), d(p.deblur.blur.spec), d(p.deblur.y), d(p.deblur.image),
        d(p.sky), p.shifts, device=dev)


def map_recovery(p):
    import math

    from repro_torch.core.solvers import RecoveryProblem

    n = math.prod(p.sky.shape)
    return RecoveryProblem(op=p.deblur.op, y=p.deblur.y,
                           x_true=p.deblur.image.reshape(len(p.shifts), n))


def check_priors(dev, p) -> dict:
    """Each prior's apply at Path M's full shape on the card against the
    same call on the CPU, and its device time."""
    import torch

    from repro_torch.ops.prox import NonNegL1Prox, TVProx, WaveletProx

    x = map_recovery(p).x_true.cpu() + 0.05 * torch.randn(
        *p.deblur.image.reshape(len(p.shifts), -1).shape, generator=torch.Generator().manual_seed(3))
    xd, gamma = x.to(dev), MAP_KW["alpha"] / MAP_KW["sigma"]
    out = {}
    for prox in (NonNegL1Prox(), TVProx(shape=tuple(p.sky.shape)), WaveletProx(),
                 WaveletProx(wavelet="db4")):
        want = prox.apply(x, gamma)
        got = prox.apply(xd, gamma).cpu()
        err = ((got - want).norm() / want.norm()).item()
        calls = 2 if prox.kind == "tv" else 5  # TV issues ~170 launches a call
        ms = timed(lambda: prox.apply(xd, gamma), iters=calls, warmup=1)
        out[prox.tag] = dict(err=err, ms=ms)
        print(f"prior {prox.tag} at {tuple(x.shape)}: card vs CPU norm-rel {err:.3e} (tol "
              f"{TOL_PROX:.0e}); device ms {ms[0]:.4f}, host ms {ms[1]:.4f} per call")
        if not err <= TOL_PROX:
            fail(f"prior {prox.tag} on the card disagrees with the CPU: {err}")
    return out


def path_m(dev, seed, size=1024, iters=400) -> dict:
    """Sec. 7 map-making at Path A's frame size: 4 dithered exposures of an
    extended-emission sky, 400 CPADMM iterations under l1 (the kernel step:
    spectral_pointwise and cpadmm_tail once an iteration) and under TV (the
    plain step, no kernel), and l1 on the plain step for the agreement gate."""
    import torch

    from repro_torch.core.mapmaking import build_mapmaking_plan, solve_mapmaking

    p = map_problem(dev, seed, size)
    prob = map_recovery(p)
    out = {"priors": check_priors(dev, p)}
    for name, prox, tail in (("l1", None, None), ("tv", "tv", None), ("l1 plain", None, "plain")):
        pl = build_mapmaking_plan(p, prox=prox, tail=tail)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, m = solve_mapmaking(p, plan=pl, iters=iters, **MAP_KW)
        torch.cuda.synchronize()
        ms_iter = (time.perf_counter() - t0) * 1e3 / iters
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        dev_ms, host_ms = step_times(prob, pl, calls=2 if prox else 5, **MAP_KW)
        ops = profile_steps(prob, pl, f"Path M {name}", steps=2, **MAP_KW)
        out[name] = dict(z=z, map=m["map"], psnr=m["psnr_db"].item(), rms=m["rms"].item(),
                         ms_iter=ms_iter, dev_ms=dev_ms, host_ms=host_ms, peak_gib=peak,
                         counts=counts, ops=ops["launches"], tail=pl.tail)
        print(f"Path M prior={name}: {size}x{size} sky x {len(p.shifts)} dithered frames "
              f"(n = {size * size}), {iters} iters, plan tail={pl.tail}"
              f"{' (l1 only: the plain tail runs)' if prox else ''}: map PSNR "
              f"{out[name]['psnr']:.2f} dB, RMS {out[name]['rms']:.4e}; {ms_iter:.4f} ms/iter "
              f"(solve with its per-iteration record, host clock), per step device "
              f"{dev_ms:.4f} ms / host issue {host_ms:.4f} ms / {ops['launches']:g} device "
              f"operations, peak memory {peak:.3f} GiB, launches {counts}")
        if z.shape != prob.x_true.shape or not bool(torch.isfinite(m["map"]).all()):
            fail(f"Path M ({name}) result has shape {tuple(z.shape)} or non-finite values")
    zero = dict.fromkeys(out["l1"]["counts"], 0)
    want = dict(zero, spectral_pointwise=iters, cpadmm_tail=iters)
    if out["l1"]["counts"] != want or out["tv"]["counts"] != zero:
        fail(f"Path M launch counts {out['l1']['counts']} (l1) / {out['tv']['counts']} (tv); "
             f"expected {want} / none")
    mk, mp = out["l1"]["map"], out["l1 plain"]["map"]
    diff = ((mk - mp).norm() / mp.norm()).item()
    print(f"Path M: l1 kernel step vs plain step, map norm-rel {diff:.3e} (tol {TOL_PATHS:.0e});"
          f" TV over l1 {out['tv']['psnr'] - out['l1']['psnr']:+.2f} dB (not gated)")
    if not diff <= TOL_PATHS:
        fail(f"Path M l1 kernel and plain steps disagree in the map: {diff}")
    out["card_cpu"] = tv_card_vs_cpu(dev, seed)
    out["problem"] = p
    return out


def tv_card_vs_cpu(dev, seed, size=256, iters=100) -> float:
    """The TV map-making solve at size x size x 4 frames on the card against
    the same solve on the CPU, from the same arrays."""
    import torch

    from repro_torch.core.mapmaking import build_mapmaking_plan, solve_mapmaking

    cpu = map_problem("cpu", seed, size)
    card = moved(cpu, dev)
    z_cpu, _ = solve_mapmaking(cpu, plan=build_mapmaking_plan(cpu), iters=iters, **MAP_KW)
    z_card, _ = solve_mapmaking(card, plan=build_mapmaking_plan(card), iters=iters, **MAP_KW)
    diff = ((z_card.cpu() - z_cpu).norm() / z_cpu.norm()).item()
    print(f"Path M: TV solve {size}x{size} x 4 frames, {iters} iters, card vs CPU norm-rel "
          f"{diff:.3e} (tol {TOL_PATHS:.0e})")
    if not bool(torch.isfinite(z_card).all()) or not diff <= TOL_PATHS:
        fail(f"Path M: the TV solve on the card disagrees with the CPU: {diff}")
    return diff


def path_md1(dev, p, iters=100) -> dict:
    """Path M's TV problem on a one-rank NCCL mesh (rfft, the hybrid step:
    the fused transform core, then TV on the gathered signals), fp32 and
    bf16 wires, against the local TV solve on the card."""
    import torch

    from repro_torch.core.mapmaking import build_mapmaking_plan, solve_mapmaking
    from repro_torch.dist.compat import make_mesh

    mesh = make_mesh((1,), ("model",), device=dev)
    z_local, _ = solve_mapmaking(p, plan=build_mapmaking_plan(p), iters=iters, **MAP_KW)
    prob = map_recovery(p)
    out = {}
    for wire in ("fp32", "bf16"):
        pl = build_mapmaking_plan(p, mesh, rfft=True, wire_dtype=wire)
        if pl.wire_dtype != wire:
            fail(f"Path MD1: the {wire} wire fell back to {pl.wire_dtype} in the plan's guard")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, m = solve_mapmaking(p, plan=pl, iters=iters, **MAP_KW)
        torch.cuda.synchronize()
        ms_iter = (time.perf_counter() - t0) * 1e3 / iters
        counts = read_counts()
        dev_ms, host_ms = step_times(prob, pl, calls=2, **MAP_KW)
        diff = ((z - z_local).norm() / z_local.norm()).item()
        out[wire] = dict(counts=counts, diff=diff, ms_iter=ms_iter, dev_ms=dev_ms,
                         host_ms=host_ms, psnr=m["psnr_db"].item())
        print(f"Path MD1 wire={wire}: mesh 1 (NCCL), {pl.config.describe()}, {iters} iters, "
              f"{ms_iter:.4f} ms/iter (solve, host clock), per step device {dev_ms:.4f} ms / "
              f"host issue {host_ms:.4f} ms, map PSNR {out[wire]['psnr']:.2f} dB, launches "
              f"{counts}, z vs the local TV solve norm-rel {diff:.3e}")
        if not bool(torch.isfinite(z).all()):
            fail(f"Path MD1 ({wire}) has non-finite values")
        tol = TOL_PATHS if wire == "fp32" else WIRE_ERROR_BOUND
        if not diff <= tol:
            fail(f"Path MD1 ({wire}) disagrees with the local TV solve: {diff} > {tol}")
        # 2 transposes per fused iteration and 2 for the one metric record; TV
        # takes the plain tail, so no cpadmm_tail launch
        n_pack = 2 * iters + 2 if wire != "fp32" else 0
        want = dict(dict.fromkeys(counts, 0), pack_wire=n_pack, unpack_wire=n_pack)
        if counts != want or (wire != "fp32" and not n_pack):
            fail(f"Path MD1 ({wire}) launch counts {counts}; expected {want}")
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


def path_d2(dev, seed, size=1024, frames=4, iters=200):
    """Four gloo ranks sharing the card, against a local kernel-step solve.
    A rank path (:func:`run_on_ranks`)."""
    import torch

    from repro_torch.core.deblur import build_deblur_plan

    prob, p = sec7_problem(dev, seed, size, frames)
    x_local, _, _ = timed_solve(prob, build_deblur_plan(p, tail="kernel"), iters, iters,
                                **SEC7_KW)
    ranks, wall = yield _d2_rank, (seed, size, frames, iters)
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
    print(f"Path D2: the four ranks ran both solves in {wall:.2f} s")
    return out


# -- one start of four gloo ranks for several paths ---------------------------
# A path that runs on four gloo ranks sharing the card is a generator: it does
# its one-rank part, yields its rank task (fn, args), receives (the ranks'
# results, the task's seconds on rank 0) and returns its result.  Starting the
# ranks costs ~12 s (the processes, torch, CUDA, gloo), so the paths that run
# next to each other share one start.
def _rank_tasks(tasks):
    """Each (fn, args) of ``tasks`` in turn on this rank, the ranks meeting
    before and after each -> [(result, seconds)]."""
    import torch
    import torch.distributed as dist

    out = []
    for fn, args in tasks:
        dist.barrier()
        t0 = time.perf_counter()
        res = fn(*args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
        out.append((res, time.perf_counter() - t0))
    return out


def run_on_ranks(dev, paths: list, label: str) -> list:
    """Drive each rank path of ``paths`` to its task, run the tasks in turn
    on one start of four gloo ranks sharing the card
    (``spawn_fake_devices(4, ..., device="cuda:0")``: NCCL refuses two ranks
    on one GPU), then hand each path its ranks' results -> the paths'
    results.  Prints the start's own seconds (the wall time less the
    tasks')."""
    from repro_torch.dist.compat import spawn_fake_devices

    try:
        tasks = [next(path) for path in paths]
        t0 = time.perf_counter()
        ranks = spawn_fake_devices(4, _rank_tasks, tasks, device=str(dev))
        wall = time.perf_counter() - t0
        outs = []
        for i, path in enumerate(paths):
            try:
                path.send(([r[i][0] for r in ranks], ranks[0][i][1]))
            except StopIteration as done:
                outs.append(done.value)
            else:
                fail(f"Paths {label}: a rank path yielded a second task")
    finally:
        for path in paths:
            path.close()
    print(f"Paths {label}: {len(tasks)} tasks on one start of four gloo ranks, {wall:.1f} s, "
          f"of which the start and stop {wall - sum(r[1] for r in ranks[0]):.1f} s")
    return outs


# -- Paths S, S4096, S-D1 (Sec. 6 serving), H (the hierarchical exchange) ---
SERVE_TOLS = (1e-3, 1e-3, 1e-3, 1e-6)  # the serve CLI's default 3:1 mix
SERVE_KW = dict(alpha=1e-4, rho=0.01, sigma=0.01)  # the serve CLI's defaults


def serve_stream(dev, n, requests, method, seed=0):
    """The serve CLI's defaults: a partial Gaussian operator (m = n/2) from
    seed ``seed + 1``, a Poisson stream at 200/s, tolerances drawn 3:1 from
    1e-3 and 1e-6, max_iters 2000, min_iters 50."""
    import torch

    from repro_torch.core.circulant import partial_gaussian_circulant
    from repro_torch.serve import synthetic_workload

    op = partial_gaussian_circulant(torch.Generator().manual_seed(seed + 1), n, n // 2,
                                    normalize=True, device=dev)
    return op, synthetic_workload(op, requests, rate=200.0, seed=seed, tols=SERVE_TOLS,
                                  max_iters=2000, min_iters=50, method=method)


def _round_clock(engines) -> list:
    """Wrap each engine's ``run_round`` with the host clock (to its end,
    which reads the round's age and delta back, so the round has run);
    -> the list the host ms a round land in."""
    host = []
    for eng in engines:
        run = eng.run_round

        def timed_round(run=run):
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e3)

        eng.run_round = timed_round
    return host


def _hold_against_solo(name, results, reqs, method, plan=None, bf16=None):
    """Each served result against a solo eager ``solve_until`` of its request
    (same contract, rho, sigma, plan; ``bf16`` maps a bf16-wire lane's
    requests to their plan): x within TOL_PATHS relative (twice the wire
    bound for a bf16-wire lane) and the same iteration count; -> (the
    largest relative gap, the largest count gap, per-request MSE by tol)."""
    from repro_torch.core.solvers import RecoveryProblem, solve_until

    bf16 = bf16 or {}
    by_id = {r.request_id: r for r in reqs}
    worst, gap, mse = 0.0, 0, {}
    for res in results:
        req = by_id[res.request_id]
        lane_bf16 = res.request_id in bf16
        x, used = solve_until(RecoveryProblem(op=req.op, y=req.y), method, tol=req.tol,
                              max_iters=req.max_iters, min_iters=req.min_iters,
                              plan=bf16.get(res.request_id, plan), **SERVE_KW)
        x = x.cpu()
        rel = ((res.x - x).norm() / x.norm()).item()
        tol = 2 * WIRE_ERROR_BOUND if lane_bf16 else TOL_PATHS
        if not rel <= tol:
            fail(f"Path {name}: {res.request_id} is {rel} from its solo solve (> {tol})")
        worst = max(worst, rel)
        gap = max(gap, abs(res.iterations - int(used)))
        if not lane_bf16 and res.iterations != int(used):
            fail(f"Path {name}: {res.request_id} took {res.iterations} iterations, its solo "
                 f"solve {int(used)}")
        d = res.x - req.x_true.cpu()
        mse.setdefault(req.tol, []).append((d * d).mean().item())
    return worst, gap, mse


def _serve_report(name, srv, results, reqs, window_s, host_ms, engines):
    """Print and check a continuous run: the summary line, the recycling
    counters (a lane freed mid-run must take a queued request: the stream
    holds more requests than a bucket has slots), host against device ms a
    round and the device's idle share."""
    import torch

    from repro_torch.serve import summarize

    s, stats = summarize(results), srv.stats()
    t = stats["total"]
    if s["count"] != len(reqs) or s["expired"]:
        fail(f"Path {name}: {s['count']} results for {len(reqs)} requests, {s['expired']} "
             f"expired")
    torch.cuda.synchronize()
    dev_ms = [a.elapsed_time(b) for eng in engines for a, b in eng.replay_events]
    busy = sum(dev_ms) / 1e3
    print(f"Path {name} continuous: {s['signals_per_sec']:.4f} signals/s, p50 "
          f"{s['p50_latency_s'] * 1e3:.2f} ms, p99 {s['p99_latency_s'] * 1e3:.2f} ms, converged "
          f"{s['converged']}/{s['count']}, expired {s['expired']}; buckets {stats['buckets']}, "
          f"admitted {t['admitted']}, recycled {t['recycled']}, rounds {t['rounds']}, "
          f"slot-iterations {t['slot_iters']}, serve window {window_s * 1e3:.2f} ms")
    if not t["recycled"] > 0:
        fail(f"Path {name}: no lane was recycled ({t['admitted']} admitted into "
             f"{stats['buckets']} bucket(s) of {engines[0].slots} slots)")
    host = sorted(host_ms)
    line = (f"Path {name} rounds: host ms a round (clock around run_round) median "
            f"{host[len(host) // 2]:.4f}, mean {sum(host) / len(host):.4f}, max {host[-1]:.4f}")
    if dev_ms:
        d = sorted(dev_ms)
        idle = sum(eng.idle_steps for eng in engines)
        line += (f"; device ms a round (CUDA events around the replay) median "
                 f"{d[len(d) // 2]:.4f}, mean {sum(d) / len(d):.4f}, so "
                 f"{sum(d) / len(d) / engines[0].round_iters:.4f} a step; device idle "
                 f"{100 * (1 - busy / window_s):.2f}% of the serve window; {idle} of "
                 f"{t['rounds'] * engines[0].round_iters} replayed steps ran after every "
                 f"lane had finished")
    print(line)
    return s, stats, dev_ms


def path_s(dev, n=16384, requests=16, method="cpadmm", name="S") -> dict:
    """Sec. 6 serving at the serve CLI's defaults on the card: slots 8,
    round_iters 32, a WallClock; warmup first (it captures the engine's
    round), then the continuous run with its launches counted, then the
    static baseline on the same stream and engine; every result against a
    solo eager solve_until."""
    from repro_torch.serve import RecoveryServer, WallClock, static_batch_serve, summarize

    op, reqs = serve_stream(dev, n, requests, method)
    srv = RecoveryServer(slots=8, round_iters=32, clock=WallClock(), **SERVE_KW)
    t0 = time.perf_counter()
    srv.warmup(reqs[0])
    eng = next(iter(srv.engines.values()))
    print(f"Path {name}: n = {n}, m = {n // 2}, k = {n // 10}, {requests} requests at 200/s, "
          f"method {method}, slots 8, round_iters 32; engine built, warmed up and captured in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (graphed: {eng.graphed}, step: tail="
          f"{eng.plan.tail})")
    if not eng.graphed or eng.plan.tail != "kernel":
        fail(f"Path {name}: the local engine on the card must replay a captured round on "
             f"the kernel step")
    eng.timing = True
    host_ms = _round_clock([eng])
    zero_counts()
    srv.clock = WallClock()
    t0 = time.perf_counter()
    results = srv.serve(reqs)
    window = time.perf_counter() - t0
    counts = read_counts()
    s, stats, dev_ms = _serve_report(name, srv, results, reqs, window, host_ms, [eng])
    steps = stats["total"]["rounds"] * eng.round_iters
    kernels = (("spectral_pointwise", "cpadmm_tail") if method == "cpadmm"
               else ("circulant_matvec", "soft_threshold_ista"))
    per_step = {"spectral_pointwise": 1, "cpadmm_tail": 1, "circulant_matvec": 2,
                "soft_threshold_ista": 1}
    want = dict.fromkeys(counts, 0)
    want.update({k: per_step[k] * steps for k in kernels})
    print(f"Path {name} launches in the continuous run ({steps} replayed steps): {counts}")
    if counts != want:
        fail(f"Path {name} launch counts {counts}; expected {want}")
    eng.replay_events.clear()
    host_ms.clear()
    srv.clock = WallClock()
    static = summarize(static_batch_serve(reqs, server=srv, clock=WallClock()))
    ratio = s["signals_per_sec"] / static["signals_per_sec"]
    print(f"Path {name} static baseline: {static['signals_per_sec']:.4f} signals/s, p50 "
          f"{static['p50_latency_s'] * 1e3:.2f} ms, p99 {static['p99_latency_s'] * 1e3:.2f} ms; "
          f"continuous vs static: {ratio:.4f}x signals/s")
    t0 = time.perf_counter()
    worst, gap, mse = _hold_against_solo(name, results, reqs, method)
    solo_s = time.perf_counter() - t0
    print(f"Path {name}: every result against its solo eager solve_until "
          f"({solo_s:.1f} s): x within {worst:.3e} relative, largest "
          f"iteration-count gap {gap}; MSE against x_true by tol: "
          + ", ".join(f"{tol:g}: max {max(v):.3e} over {len(v)}" for tol, v in mse.items()))
    if method == "cpadmm":
        if s["converged"] != s["count"]:
            fail(f"Path {name}: {s['count'] - s['converged']} requests did not converge")
        if max(max(v) for v in mse.values()) > PAPER_TARGET_MSE:
            fail(f"Path {name}: a request's MSE is above {PAPER_TARGET_MSE}")
    return dict(counts=counts, summary=s, static=static, ratio=ratio, host_ms=host_ms,
                dev_ms=dev_ms, worst=worst, gap=gap)


def path_s_d1(dev, requests=16, slots=4) -> dict:
    """S's stream (n = 16384) on the one-rank NCCL mesh: an fp32-wire bucket
    and a bf16-wire bucket (rfft, the kernel tail), eager rounds, each
    bucket's ``requests / 2`` more than its ``slots``, so that it recycles
    lanes; fp32 lanes against their solo solve under the same plan
    (TOL_PATHS, equal counts), bf16 lanes within twice the wire bound."""
    import dataclasses

    from repro_torch.dist.compat import make_mesh
    from repro_torch.ops.plan import PlanConfig, plan
    from repro_torch.serve import RecoveryServer, WallClock

    mesh = make_mesh((1,), ("model",))
    op, base = serve_stream(dev, 16384, requests, "cpadmm")
    cfgs = [PlanConfig(rfft=True, tail="kernel"),
            PlanConfig(rfft=True, tail="kernel", wire_dtype="bf16")]
    reqs = [dataclasses.replace(r, plan_config=cfgs[i % 2]) for i, r in enumerate(base)]
    srv = RecoveryServer(mesh=mesh, slots=slots, round_iters=32, clock=WallClock(), **SERVE_KW)
    srv.warmup(reqs[0])
    srv.warmup(reqs[1])
    engines = list(srv.engines.values())
    if any(e.graphed for e in engines) or [e.plan.wire_dtype for e in engines] != ["fp32",
                                                                                   "bf16"]:
        fail("Path S-D1: the mesh buckets must run eager rounds, one at each wire")
    host_ms = _round_clock(engines)
    zero_counts()
    srv.clock = WallClock()
    t0 = time.perf_counter()
    results = srv.serve(reqs)
    window = time.perf_counter() - t0
    counts = read_counts()
    s, stats, _ = _serve_report("S-D1", srv, results, reqs, window, host_ms, engines)
    print(f"Path S-D1 launches: {counts}")
    if not (counts["cpadmm_tail"] and counts["pack_wire"] and counts["unpack_wire"]):
        fail(f"Path S-D1: cpadmm_tail, pack_wire and unpack_wire must all launch: {counts}")
    plan32 = plan(op, mesh, rfft=True, tail="kernel")
    plan16 = plan(op, mesh, rfft=True, tail="kernel", wire_dtype="bf16")
    bf16 = {r.request_id: plan16 for r in reqs if r.plan_config.wire_dtype == "bf16"}
    worst, gap, mse = _hold_against_solo("S-D1", results, reqs, "cpadmm", plan=plan32,
                                         bf16=bf16)
    # a bf16 wire re-rounds each transpose (~2^-9 relative), so a lane's
    # relative iterate change may never fall below 1e-6: such a lane runs to
    # max_iters, as its solo solve does; every fp32 lane converges
    tol_of = {q.request_id: q.tol for q in reqs}
    stuck = sorted((r.request_id, r.iterations, tol_of[r.request_id]) for r in results
                   if not r.converged)
    print(f"Path S-D1: every result against its solo solve_until under its plan: x within "
          f"{worst:.3e} relative, largest count gap {gap} (bf16 lanes may differ); MSE by "
          f"tol: " + ", ".join(f"{tol:g}: max {max(v):.3e}" for tol, v in mse.items())
          + f"; not converged (request, iterations, tol): {stuck}")
    if any(rid not in bf16 or iters != 2000 for rid, iters, _ in stuck):
        fail("Path S-D1: every fp32-wire request must converge, and a bf16-wire one that "
             "does not must run to max_iters")
    if max(max(v) for v in mse.values()) > PAPER_TARGET_MSE:
        fail("Path S-D1: a request's MSE is above 1e-4")
    return dict(counts=counts, summary=s, host_ms=host_ms)


def _h_rank(seed, size, frames, iters):
    """One rank of Path H: D2's problem on make_hier_mesh(1, 2, 2), the flat
    exchange over the factored axis, the two-stage exchange, and the
    two-stage exchange with bf16 inter-host hops; overlap 2, rfft, the
    kernel tail.  -> gathered x-hats, launch counts, ms/iter, the bytes a
    transpose hands each tier."""
    import torch.distributed as dist

    from repro_torch.dist import fft as D
    from repro_torch.dist.compat import make_hier_mesh, rank_device
    from repro_torch.ops.plan import plan

    dev = rank_device()
    prob, p = sec7_problem(dev, seed, size, frames)
    mesh = make_hier_mesh(1, 2, 2)
    knobs = dict(n1=size, n2=size, rfft=True, overlap=2, tail="kernel")
    plans = {"flat": plan(p.op, mesh, axis_name=("host", "device"), **knobs),
             "hier": plan(p.op, mesh, hier_axes=(2, 2), **knobs),
             "hier-inter-bf16": plan(p.op, mesh, hier_axes=(2, 2), inter_wire_dtype="bf16",
                                     **knobs)}
    out = {}
    for name, pl in plans.items():
        zero_counts()
        dist.barrier()
        x, _, ms_iter = timed_solve(prob, pl, iters, iters, **SEC7_KW)
        counts = read_counts()
        D.reset_wire_bytes()
        pl.operator.matvec(prob.x_true)  # one matvec of the frames: two transposes
        out[name] = dict(x=x, counts=counts, ms_iter=ms_iter,
                         wires=(pl.wire_dtype, pl.inter_wire_dtype),
                         bytes={k: v // 2 for k, v in D.WIRE_BYTES.items()})
    return out


def path_h(dev, seed, size=1024, frames=4, iters=25):
    """Four gloo ranks sharing the card on a (1, 2, 2) hierarchical mesh.
    A rank path (:func:`run_on_ranks`)."""
    import torch

    ranks, wall = yield _h_rank, (seed, size, frames, iters)
    r0 = ranks[0]
    counts = {}
    for name, got in r0.items():
        summed = {k: sum(r[name]["counts"][k] for r in ranks) for k in got["counts"]}
        for k, v in summed.items():
            counts[k] = counts.get(k, 0) + v
        print(f"Path H {name}: (data, host, device) = (1, 2, 2), wires {got['wires']}, "
              f"{iters} iters, {got['ms_iter']:.4f} ms/iter on rank 0 (host clock), bytes a "
              f"transpose on rank 0 by tier {got['bytes']}, launches summed over ranks "
              f"{summed}")
        if not bool(torch.isfinite(got["x"]).all()):
            fail(f"Path H {name}: non-finite x-hat")
    if not torch.equal(r0["hier"]["x"], r0["flat"]["x"]):
        fail("Path H: the fp32 two-stage exchange is not bit-equal to the flat exchange")
    rel = ((r0["hier-inter-bf16"]["x"] - r0["hier"]["x"]).norm() / r0["hier"]["x"].norm()).item()
    print(f"Path H: fp32 hierarchical == flat bit for bit; bf16 inter-host hops vs fp32 "
          f"norm-rel {rel:.3e} (bound {WIRE_ERROR_BOUND}); the ranks ran it in {wall:.2f} s")
    if r0["hier-inter-bf16"]["wires"] != ("fp32", "bf16") or not 0 < rel <= WIRE_ERROR_BOUND:
        fail(f"Path H: the bf16 inter-host run is {rel} from fp32 or fell back")
    flat_b, hier_b = r0["flat"]["bytes"], r0["hier"]["bytes"]
    if hier_b["intra"] != flat_b["flat"] or 2 * hier_b["inter"] != flat_b["flat"]:
        fail(f"Path H: tier bytes {hier_b} against the flat exchange's {flat_b}")
    return dict(counts=counts, ms={k: v["ms_iter"] for k, v in r0.items()}, rel=rel)


def check_serve_out(out: str) -> None:
    """The serve CLI's report lines, which the reference's also prints; its
    16 requests into 8 slots must recycle a lane."""
    for line in ("serving ", "continuous: ", "signals/s", "buckets ", "recycled "):
        if line not in out:
            fail(f"serve CLI: no {line!r} in its output")
    recycled = [int(v) for v in re.findall(r"\brecycled (\d+)", out)]
    if not recycled or min(recycled) <= 0:
        fail(f"serve CLI: no lane was recycled (recycled {recycled})")


def serve_cli_chains() -> dict:
    return {"serve static": [serve_cmd(["--n", "16384", "--requests", "16",
                                        "--compare-static"])],
            "serve mesh": [serve_cmd(["--n", "16384", "--requests", "16", "--mesh", "1",
                                      "--rfft"])]}


def check_serve_cli(out: dict) -> None:
    (static,), (mesh,) = out["serve static"], out["serve mesh"]
    for text in (static, mesh):
        check_serve_out(text)
    if "static baseline: " not in static or "continuous vs static: " not in static:
        fail("serve CLI: --compare-static printed no baseline or ratio")
    if "mesh=1 (plan API)" not in mesh:
        fail("serve CLI: --mesh 1 did not report the plan API")


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


def lm_config(arch, **cut):
    """``arch``'s FULL config with the fields in ``cut`` replaced (depth,
    experts, dtype: never a width)."""
    import dataclasses

    from repro_torch.configs.registry import full_config

    return dataclasses.replace(full_config(arch), **cut)


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

    cfg = lm_config("minitron-4b")
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




def path_e2(e1, seq=32) -> dict:
    """The same prompts cut to 32 tokens through make_decode_step one token
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
    on the card from ``seed`` and copied to the CPU: a prefill on the CPU
    (plain attention) against the same prefill on the card (the kernel)."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import init_params, tree_map
    from repro_torch.models.steps import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on the card
    cfg = lm_config("minitron-4b", n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    params_dev = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    params = tree_map(lambda a: a.cpu(), params_dev)
    tokens = token_batch(torch.Generator().manual_seed(seed), batch, seq - 1, cfg.vocab,
                         device="cpu")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    zero_counts()
    got = make_prefill_step(cfg)(params_dev, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    counts = read_counts()
    err = rel_err(got.float().cpu(), want.float())
    print(f"Path E3: minitron-4b width, 2 layers, float32, B={batch} S={seq}: init on the "
          f"card and copy to the CPU {init_s:.2f} s, CPU prefill {cpu_s:.2f} s; card vs CPU last logits max abs err "
          f"{err[0]:.3e}, norm-rel {err[1]:.3e} (tol {TOL_CARD_CPU:.0e}); launches {counts}")
    if not bool(torch.isfinite(got).all()) or not err[1] <= TOL_CARD_CPU:
        fail(f"Path E3: the card's prefill disagrees with the CPU's: {err}")
    want_counts = dict.fromkeys(counts, 0)
    want_counts.update(flash_attention_mma=cfg.n_layers)
    if counts != want_counts:
        fail(f"Path E3 launch counts {counts}; expected {want_counts}")
    return dict(counts=counts, err=err, cfg=cfg, params=params, params_dev=params_dev)


def train_flops(cfg, batch: int, seq: int) -> float:
    """The operations one train step needs at ``cfg``: each product of the
    layers and the head 2 FLOP a weight and token a pass, in four passes
    (forward, the layer remat's or the chunked head's recompute, two
    backward); an MoE layer's routed experts counted at the k each token
    chose, its shared experts and router whole; causal attention's Q.K^T and
    P.V over half the square, in the same four passes."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn_w = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    per_token = cfg.vocab_padded * d  # the unembedding
    for kind in cfg.layer_kinds():
        if kind == "dense":
            per_token += attn_w + (3 if cfg.mlp_variant == "glu" else 2) * d * cfg.d_ff
        else:
            expert = 3 * d * cfg.d_ff_expert
            per_token += attn_w + d * cfg.n_experts + (cfg.top_k + cfg.n_shared_experts) * expert
    attn = 4 * batch * cfg.n_heads * seq * seq * hd / 2 * cfg.n_layers
    return 4 * (2 * batch * seq * per_token + attn)


def grad_leaves(params, grads) -> dict:
    """{path: gradient}: ``grads`` in ``lm.tree_items`` order (``steps.grads_of``'s)."""
    from repro_torch.models.lm import tree_items

    return {"/".join(map(str, path)): g for (path, _), g in zip(tree_items(params), grads)}


def missing_gradients(params, grads) -> list:
    """Leaves other than ``router_bias`` whose gradient is None or all zero."""
    return [path for path, g in grad_leaves(params, grads).items()
            if not path.endswith("router_bias") and (g is None or not bool(g.abs().amax() > 0))]


def drop_shares(cfg, params, tokens) -> list:
    """The share of (token, choice) pairs over capacity in each MoE layer's
    routing, from one forward of ``tokens`` without a gradient (kept out of
    the timed steps: it reads each routing's keep mask back)."""
    import torch

    from repro_torch.models import lm, moe

    shares, real_slots = [], moe.dispatch_slots

    def counting_slots(c, idx):
        slot, keep = real_slots(c, idx)
        shares.append(1.0 - keep.float().mean())
        return slot, keep

    moe.dispatch_slots = counting_slots
    try:
        with torch.no_grad():
            lm.forward(params, cfg, tokens[:, :-1])
    finally:
        moe.dispatch_slots = real_slots
    return [float(v) for v in shares]


def attention_backward_ms(cfg, dev, batch, seq) -> tuple[float, float]:
    """(forward kernel ms, forward + backward ms) of FlashAttentionFn at a
    layer's q, k, v shape in the compute dtype: the backward's share is the
    plain _attend_chunked recompute and its vector-Jacobian product."""
    import torch

    from repro_torch.models.attention import FlashAttentionFn

    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    hd = cfg.resolved_head_dim
    q, k, v = (torch.randn(batch, seq, n, hd, generator=gen, device=dev).to(dt)
               .requires_grad_(True) for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    dout = torch.randn(batch, seq, cfg.n_heads, hd, generator=gen, device=dev).to(dt)
    fwd = lambda: FlashAttentionFn.apply(q, k, v, cfg.attn_chunk)
    both = lambda: torch.autograd.grad(fwd(), (q, k, v), dout)
    with torch.no_grad():
        fwd_ms = timed_calls(fwd, iters=5)[0]
    both()
    return fwd_ms, timed_calls(both, iters=3)[0]


def moe_ffn_ms(cfg, params, dev, batch, seq) -> tuple[float, float]:
    """(forward ms, forward + backward ms) of one MoE layer's moe_ffn at
    (batch, seq, d_model) in the compute dtype, on the layer's cast weights."""
    import torch

    from repro_torch.models import lm, moe

    dt = getattr(torch, cfg.dtype)
    layer = lm.tree_map(lambda a: a[0].detach().to(dt) if a.dtype == torch.float32 else
                        a[0].detach(), params["segments"][1]["moe"])
    layer = lm.tree_map(lambda a: a.requires_grad_(True), layer)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(batch, seq, cfg.d_model, generator=gen, device=dev) * 0.5).to(dt)
    x.requires_grad_(True)
    leaves = [x, *lm.tree_leaves(layer)]

    def both():
        out, aux = moe.moe_ffn(layer, cfg, x, cfg.act)
        return torch.autograd.grad(out.float().sum() + aux, leaves, allow_unused=True)

    with torch.no_grad():
        fwd_ms = timed_calls(lambda: moe.moe_ffn(layer, cfg, x, cfg.act), iters=5)[0]
    both()
    return fwd_ms, timed_calls(both, iters=3)[0]


ROUTING_MARGIN = 1e-4  # card against CPU: ids compared where the choice is decided by more


def routing_card_vs_cpu(name, cfg, params, dev, tokens) -> dict:
    """One MoE layer's routing of ``tokens`` random inputs on the card and on
    the CPU (float32 router logits, cuBLAS with TF32 off against MKL): the
    expert ids must agree on every token whose k-th and (k+1)-th selection
    logits differ by more than ROUTING_MARGIN; the tokens under it are
    counted and left out (a ~1e-6 logit difference may flip them), and the
    gates compared on the rest.  Each token's ids are compared as a set
    (sorted, its gates with them): a near-tie inside the top k reorders them."""
    import torch

    from repro_torch.models import lm, moe

    layer = lm.tree_map(lambda a: a[0].detach(), params["segments"][1]["moe"])
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(tokens, cfg.d_model, generator=gen, device=dev).to(getattr(torch, cfg.dtype))
    by_id = lambda i, g: (i.sort(dim=-1).values, torch.gather(g, -1, i.argsort(dim=-1)))
    idx, gates = by_id(*moe._routing(layer, cfg, x)[:2])
    cpu_layer = lm.tree_map(lambda a: a.cpu(), layer)
    cidx, cgates = by_id(*moe._routing(cpu_layer, cfg, x.cpu())[:2])
    logits = x.float().cpu() @ cpu_layer["router"].float()
    select = logits + cpu_layer["router_bias"] if cfg.router_aux_free_bias else logits
    top = torch.topk(select, cfg.top_k + 1, dim=-1).values
    decided = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]) > ROUTING_MARGIN
    same = (idx.cpu() == cidx).all(dim=-1)
    gate_err = rel_err(gates.float().cpu()[decided], cgates.float()[decided])
    print(f"Path {name} routing of {tokens} tokens, card vs CPU: {int((~decided).sum())} tokens "
          f"within {ROUTING_MARGIN:.0e} of a tie at the k-th choice (not compared), "
          f"{int((~same & decided).sum())} of the other {int(decided.sum())} with other ids, "
          f"gates there norm-rel {gate_err[1]:.3e}")
    if bool((~same & decided).any()):
        fail(f"Path {name}: the card routes {int((~same & decided).sum())} decided tokens "
             "elsewhere")
    return dict(undecided=int((~decided).sum()), gate_err=gate_err[1])


TRAIN_STEPS = 10  # Paths G1 and G2

# Path G10: the five families after minitron and moonshot trained at full
# width, cut in depth (and experts) only, as Paths G7-G9 and E9 cut them:
# (arch, cut, batch).  whisper-large-v3 is uncut (32 + 32 layers).
G10_CASES = (("zamba2-1.2b", dict(n_layers=7), 4),
             ("xlstm-350m", dict(n_layers=8), 4),
             ("whisper-large-v3", {}, 4),
             ("pixtral-12b", dict(n_layers=4), 4),
             ("deepseek-v3-671b", dict(n_layers=2, first_k_dense=1, n_experts=16), 2))
G10_SEQ = 2048  # positions an example (pixtral: 1024 image + 1024 text; whisper 1500 + 448)
G10_STEPS = 4  # AdamW warmup 1, total 4, one batch repeated: two moving updates
XLSTM_WALK_SEQ = (256, 512)  # the lengths xlstm-350m's bound is walked at


def g10_shapes(cfg, batch: int, seq: int = G10_SEQ) -> dict:
    """{key: shape} of a G10 batch: tokens (batch, text + 1); whisper's
    ``frames`` (batch, enc_seq_len, d_model) before its 448 text tokens,
    pixtral's ``img_embeds`` (batch, n_img_tokens, d_model) before seq -
    n_img_tokens text tokens."""
    if cfg.is_encdec:
        return {"tokens": (batch, WHISPER_TEXT_LEN + 1),
                "frames": (batch, cfg.enc_seq_len, cfg.d_model)}
    if cfg.n_img_tokens:
        return {"tokens": (batch, seq - cfg.n_img_tokens + 1),
                "img_embeds": (batch, cfg.n_img_tokens, cfg.d_model)}
    return {"tokens": (batch, seq + 1)}


def g10_batch(cfg, gen, batch: int, dev) -> dict:
    """A G10 batch drawn on the card from ``gen``: tokens as the launcher
    draws them, frames and image embeddings N(0, 0.02^2) as Paths E10 / E11
    draw them (the stubbed front ends' outputs)."""
    import torch

    from repro_torch.data.synthetic import token_batch

    out = {}
    for k, shape in g10_shapes(cfg, batch).items():
        out[k] = (token_batch(gen, shape[0], shape[1] - 1, cfg.vocab, device=dev) if k == "tokens"
                  else torch.randn(shape, generator=gen, device=dev) * 0.02)
    return out


def attention_calls(cfg) -> int:
    """The flash attentions one forward of ``cfg`` runs: one a layer, zamba2's
    shared block once an invocation, whisper's encoder, decoder and cross
    layers; MLA (plain code, as the reference's) and xLSTM none."""
    from repro_torch.models.lm import shared_invocations

    if cfg.attn_type == "mla" or cfg.block_type == "xlstm":
        return 0
    if cfg.block_type == "mamba2":
        return shared_invocations(cfg)
    return cfg.n_enc_layers + 2 * cfg.n_layers if cfg.is_encdec else cfg.n_layers


def path_train(name, cfg, dev, seed, batch=4, seq=2048, steps=TRAIN_STEPS, warmup=3,
               batches=None, flops=None, estimates=True, profiled="full") -> dict:
    """Paths G1 / G2 / G10: ``cfg`` initialised on the card from a seed,
    ``steps`` steps of make_train_step (AdamW ``warmup``, total ``steps``),
    on ``batches`` (steps of them, and one more if ``profiled``; by default
    each step's batch of seq + 1 tokens drawn from (seed, step) as the
    launcher does at ``--seq seq``).  Each step runs as its two halves
    (``train_step.gradient``, ``train_step.apply``), cut by CUDA events
    into gradient and optimizer; step 1's gradient, between its halves,
    must reach every leaf but router_bias.  The losses and gradient norms
    must be finite, the last loss below step 1's, the flash kernel launched
    twice an attention a step (remat).  ``profiled`` ("full", "device" or
    ""): one more step under torch.profiler (:func:`profile_window`, with
    the host's ops or the device's alone), for the device's busy share and
    the kernel's time.  The bound is ``flops`` (by default
    :func:`train_flops`) at 989 TFLOP/s plus the optimizer's bytes at 3.35
    TB/s; ``estimates`` adds the isolated estimates of FlashAttentionFn's
    backward and the MoE FFN at a layer's shape (G1, G2)."""
    import torch

    from repro_torch.data.synthetic import step_generator, token_batch
    from repro_torch.models.lm import tree_leaves
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    t_path = time.perf_counter()
    opt_cfg = AdamWConfig(warmup_steps=warmup, total_steps=steps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    state = init_train_state(gen, cfg, opt_cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    if batches is None:
        batches = [{"tokens": token_batch(step_generator(seed, s, 0), batch, seq, cfg.vocab,
                                          device=dev)} for s in range(steps + bool(profiled))]
    tokens = batches[0]["tokens"]
    targets = tokens.shape[0] * (tokens.shape[1] - 1)  # the loss's positions
    positions = sum(b.shape[0] * b.shape[1] for k, b in batches[0].items() if k != "tokens")
    positions += targets  # every position the model runs: frames and image embeddings too
    n_moe = cfg.layer_kinds().count("moe")
    drop_before = drop_shares(cfg, state.params, tokens) if n_moe else []
    train_step = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    metrics, dev_ms, host_ms, split = [], [], [], []
    for s in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        h0 = time.perf_counter()
        ev[0].record()
        m, g = train_step.gradient(state, batches[s])
        ev[1].record()
        if s == 0:  # step 1's gradient (a host sync a leaf, between the events)
            missing = missing_gradients(state.params, g)
            n_grads, n_leaves = sum(x is not None for x in g), len(g)
        state, m = train_step.apply(state, m, g)
        ev[2].record()
        del g
        metrics.append({k: float(v) for k, v in m.items()})  # syncs
        host_ms.append((time.perf_counter() - h0) * 1e3)
        dev_ms.append(ev[0].elapsed_time(ev[2]))
        split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    median = lambda v: sorted(v[1:])[len(v[1:]) // 2]  # the median after the first
    steady, steady_host = median(dev_ms), median(host_ms)
    grad_ms, opt_ms = median([a for a, _ in split]), median([b for _, b in split])
    prof = None
    if profiled:
        box = [state]

        def one():
            box[0], _ = train_step(box[0], batches[steps])

        prof = profile_window(one, f"Path {name} train step", steps=1,
                              host=profiled == "full")
        state = box[0]
    flash_ms = sum(ms for k, ms in prof["kernels"].items() if "flash_fwd" in k) if prof else 0.0
    if flops is None:
        flops = train_flops(cfg, batch, seq)
    opt_bytes = 28 * n_params  # read p, g, m, v; write p, m, v: 7 float32 each
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3 + opt_bytes / HBM_BYTES_PER_S * 1e3
    out = dict(cfg=cfg, state=state, counts=counts, metrics=metrics, dev_ms=dev_ms,
               host_ms=host_ms, steady_ms=steady, steady_host_ms=steady_host,
               tok_s=targets / (steady_host / 1e3), pos_s=positions / (steady_host / 1e3),
               peak_gib=peak_gib, bound_ms=bound_ms, flops=flops, grad_ms=grad_ms,
               opt_ms=opt_ms, flash_ms=flash_ms, busy_ms=prof and prof["busy_ms"],
               wall_ms=prof and prof["wall_ms"], n_params=n_params, init_s=init_s)
    split_ms = grad_ms + opt_ms
    shapes = {k: tuple(v.shape) for k, v in batches[0].items()}
    print(f"Path {name}: {cfg.name}, {len(cfg.layer_kinds())} layers {cfg.layer_kinds()}, "
          f"{n_params / 1e9:.3f} B parameters, init {init_s:.2f} s; {steps} steps of {shapes}: "
          f"device ms a step {[round(v, 2) for v in dev_ms]}, host clock ms "
          f"{[round(v, 2) for v in host_ms]} (median after the first: device {steady:.2f}, host "
          f"{steady_host:.2f}, {out['tok_s']:.0f} tokens/s, {out['pos_s']:.0f} positions/s); peak "
          f"memory {peak_gib:.2f} GiB; bound {bound_ms:.2f} ms ({flops:.3e} FLOP at 989 TFLOP/s "
          f"+ {opt_bytes / 1e9:.1f} GB of optimizer traffic at 3.35 TB/s)")
    print(f"Path {name} losses {[round(m['loss'], 4) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in metrics]}, lr "
          f"{[round(m['lr'], 7) for m in metrics]}, aux {[round(m['aux'], 4) for m in metrics]}"
          f"; step-1 gradients: {n_grads} of {n_leaves} leaves non-None, missing or zero "
          f"{missing}; cut by CUDA events between train_step.gradient and train_step.apply "
          f"(median after the first): gradient {grad_ms:.2f} ms, optimizer {opt_ms:.2f} ms "
          f"({100 * opt_ms / split_ms:.1f}%)")
    if n_moe:
        out["routing"] = routing_card_vs_cpu(name, cfg, state.params, dev, targets)
        out["drop"] = (drop_before, drop_shares(cfg, state.params, batches[-1]["tokens"]))
        print(f"Path {name} dropped share of (token, choice) pairs in each MoE layer's routing "
              f"(a forward without a gradient, outside the timed steps): step 1's batch before "
              f"training {[round(v, 4) for v in out['drop'][0]]}, the last step's after "
              f"{[round(v, 4) for v in out['drop'][1]]}")
    if estimates:
        attn_fwd_ms, attn_both_ms = attention_backward_ms(cfg, dev, batch, seq)
        out["recompute_ms"] = cfg.n_layers * (attn_both_ms - attn_fwd_ms)
        print(f"Path {name} isolated estimate, the plain attention recompute "
              f"(FlashAttentionFn's backward at a layer's shape alone, "
              f"{attn_both_ms - attn_fwd_ms:.2f} ms, x {cfg.n_layers} layers) "
              f"{out['recompute_ms']:.2f} ms ({100 * out['recompute_ms'] / split_ms:.1f}% of a "
              f"step)")
        if n_moe:
            moe_fwd_ms, moe_both_ms = moe_ffn_ms(cfg, state.params, dev, batch, seq)
            out["moe_ms"] = n_moe * (moe_fwd_ms + moe_both_ms)  # forward, then remat + backward
            print(f"Path {name} isolated estimate, MoE FFN at a layer's shape alone: forward "
                  f"{moe_fwd_ms:.2f} ms, forward + backward {moe_both_ms:.2f} ms, x {n_moe} "
                  f"layers (forward, then the remat's forward and the backward) "
                  f"{out['moe_ms']:.2f} ms ({100 * out['moe_ms'] / split_ms:.1f}% of a step)")
    if prof:
        print(f"Path {name} step {steps + 1} (profiled): device busy {prof['busy_ms']:.2f} of "
              f"{prof['wall_ms']:.2f} ms; flash_attention_sm90 in the profile {flash_ms:.2f} ms "
              f"({100 * flash_ms / prof['busy_ms']:.1f}% of the busy time)")
    out["seconds"] = time.perf_counter() - t_path
    print(f"Path {name}: launches {counts}; {out['seconds']:.1f} s [{card_line()}]")
    if any(not math.isfinite(m["loss"]) or not math.isfinite(m["grad_norm"]) for m in metrics):
        fail(f"Path {name}: a non-finite loss or gradient norm")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        fail(f"Path {name}: the loss did not fall: {metrics[0]['loss']} -> {metrics[-1]['loss']}")
    if missing:
        fail(f"Path {name}: leaves without a gradient on the card: {missing}")
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention_sm90=2 * attention_calls(cfg) * steps)
    if counts != want:
        fail(f"Path {name} launch counts {counts}; expected {want} (2 an attention a step: remat)")
    return out


def g10_attention_ms(cfg, dev, batch: int) -> tuple[float, str]:
    """An isolated estimate of the plain attention's device ms in a G10 step
    (each piece timed alone at a layer's shape in the compute dtype, times
    its layers): deepseek-v3's MLA, ``_attend_chunked`` at 128 heads of 192
    / 128 forward twice (the forward, the layer remat's) and backward;
    whisper-large-v3's ``FlashAttentionFn`` backward (the plain recompute
    and its vector-Jacobian product) non-causal over 1500 frames, causal over
    448 tokens and the cross-attention 448 x 1500.  -> (ms, what was timed)."""
    import torch

    from repro_torch.models.attention import FlashAttentionFn, _attend_chunked

    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(sq, sk, dqk, dv):
        q, k, v = (torch.randn(batch, n, cfg.n_heads, d, generator=gen, device=dev).to(dt)
                   .requires_grad_(True) for n, d in ((sq, dqk), (sk, dqk), (sk, dv)))
        return q, k, v, torch.randn(batch, sq, cfg.n_heads, dv, generator=gen, device=dev).to(dt)

    def fwd_and_both(fn, q, k, v, dout):
        with torch.no_grad():
            fwd_ms = timed_calls(lambda: fn(q, k, v), iters=3)[0]
        both = lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), dout)
        both()
        return fwd_ms, timed_calls(both, iters=3)[0]

    if cfg.attn_type == "mla":
        dqk = cfg.nope_head_dim + cfg.rope_head_dim
        fwd, both = fwd_and_both(lambda q, k, v: _attend_chunked(
            q, k, v, causal=True, chunk=cfg.attn_chunk, scale=dqk ** -0.5),
            *operands(G10_SEQ, G10_SEQ, dqk, cfg.v_head_dim))
        return (cfg.n_layers * (fwd + both),
                f"MLA's _attend_chunked ({batch} x {G10_SEQ}, {cfg.n_heads} heads of {dqk} / "
                f"{cfg.v_head_dim}): forward {fwd:.2f} ms, forward + backward {both:.2f} ms, x "
                f"{cfg.n_layers} layers (forward, then the remat's forward and the backward)")
    hd, total, parts = cfg.resolved_head_dim, 0.0, []
    for what, sq, sk, causal, n in (("encoder", cfg.enc_seq_len, cfg.enc_seq_len, False,
                                     cfg.n_enc_layers),
                                    ("decoder", WHISPER_TEXT_LEN, WHISPER_TEXT_LEN, True,
                                     cfg.n_layers),
                                    ("cross", WHISPER_TEXT_LEN, cfg.enc_seq_len, False,
                                     cfg.n_layers)):
        fwd, both = fwd_and_both(lambda q, k, v, c=causal: FlashAttentionFn.apply(
            q, k, v, cfg.attn_chunk, c), *operands(sq, sk, hd, hd))
        total += n * (both - fwd)
        parts.append(f"{what} {sq} x {sk} {both - fwd:.2f} ms x {n}")
    return total, "FlashAttentionFn's backward (the plain recompute) " + ", ".join(parts)


def path_g10(dev, seed, walks: dict) -> dict:
    """Path G10: the five families of G10_CASES trained on the card, each
    through :func:`path_train` on one batch (:func:`g10_batch`) repeated for
    G10_STEPS steps and the profiled one, its bound from ``walks`` (the
    dry run's meta walk of the same step, :func:`g10_walks`); each family
    freed before the next.  -> {arch: path_train's figures, "counts": the
    launches summed}."""
    import torch

    out, total = {}, dict.fromkeys(_wrappers(), 0)
    for i, (arch, cut, batch) in enumerate(G10_CASES):
        cfg = lm_config(arch, **cut)
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        b = g10_batch(cfg, gen, batch, dev)
        w = walks[arch]
        print(f"Path G10 {arch}: bound's operations {w['flops']:.4e} FLOP from the dry run's meta "
              f"walk of this step at S = {w['walked_at']}"
              + (f", extrapolated linearly to {G10_SEQ} (xlstm's sLSTM loops over the positions"
                 f" in Python: a walk at {G10_SEQ} takes minutes)"
                 if len(w["walked_at"]) > 1 else "") + f" ({w['walk_s']:.1f} s)")
        # the device's busy share and row 9a's of a step; xlstm-350m's sLSTM
        # issues ~2.6e5 launches a step, which take minutes to profile
        profiled = "" if cfg.block_type == "xlstm" else "device"
        r = path_train(f"G10 {arch}", cfg, dev, seed + i, batch=batch, steps=G10_STEPS,
                       warmup=1, batches=[b] * (G10_STEPS + bool(profiled)), flops=w["flops"],
                       estimates=False, profiled=profiled)
        del r["state"], b
        torch.cuda.empty_cache()
        if cfg.attn_type == "mla" or cfg.is_encdec:
            r["attn_ms"], what = g10_attention_ms(cfg, dev, batch)
            step = r["grad_ms"] + r["opt_ms"]
            print(f"Path G10 {arch} isolated estimate, the plain attention: {what}: "
                  f"{r['attn_ms']:.2f} ms ({100 * r['attn_ms'] / step:.1f}% of a step)")
            torch.cuda.empty_cache()
        total = {k: total[k] + r["counts"][k] for k in total}
        out[arch] = r
    out["counts"] = total
    return out


def path_g3(dev, e3, seed, batch=2, seq=64) -> dict:
    """minitron-4b's width cut to 2 layers in float32 (Path E3's parameters,
    initialised once on the CPU): the loss and every gradient of loss_fn on
    the CPU (plain attention forward) and on the card (the mma.sync kernel's
    3xTF32 forward, the plain recompute backward, cuBLAS with TF32 off), no
    optimizer step; the loss within TOL_CARD_CPU, every leaf within
    TOL_CARD_CPU_GRAD, norm-relative."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.steps import grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = e3["cfg"]
    tokens = token_batch(torch.Generator().manual_seed(seed), batch, seq, cfg.vocab,
                         device="cpu")
    t0 = time.perf_counter()
    cpu_m, cpu_g = grads_of(e3["params"], cfg, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    dev_m, dev_g = grads_of(e3["params_dev"], cfg, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    counts = read_counts()
    loss_err = abs(float(dev_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
    errs = {}
    for (path, g_cpu), g_dev in zip(grad_leaves(e3["params"], cpu_g).items(), dev_g):
        errs[path] = rel_err(g_dev.float().cpu(), g_cpu.float())[1]
    worst = sorted(errs.items(), key=lambda kv: kv[1], reverse=True)
    print(f"Path G3: minitron-4b width, 2 layers, float32, B={batch} S={seq}: loss CPU "
          f"{float(cpu_m['loss']):.6f} ({cpu_s:.2f} s with its gradient), card "
          f"{float(dev_m['loss']):.6f} ({dev_s:.2f} s), relative {loss_err:.3e} (tol "
          f"{TOL_CARD_CPU:.0e}); {len(errs)} gradient leaves, norm-relative card vs CPU: worst "
          f"{[(p, f'{e:.3e}') for p, e in worst[:4]]}, median "
          f"{worst[len(worst) // 2][1]:.3e} (tol {TOL_CARD_CPU_GRAD:.0e}); launches {counts}")
    if not loss_err <= TOL_CARD_CPU or not all(math.isfinite(e) for e in errs.values()):
        fail(f"Path G3: the card's loss disagrees with the CPU's: {loss_err}")
    if not worst[0][1] <= TOL_CARD_CPU_GRAD:
        fail(f"Path G3: gradient {worst[0][0]} disagrees: {worst[0][1]}")
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention_mma=2 * cfg.n_layers)  # forward and remat recompute
    if counts != want:
        fail(f"Path G3 launch counts {counts}; expected {want}")
    return dict(counts=counts, loss_err=loss_err, worst=worst[0], errs=errs)


def path_e5(g2, dev, seed, batch=4, seq=2048, prompt_len=32, steps=16) -> dict:
    """Path G2's trained model serving: make_prefill_step on 4 prompts of
    2048 tokens (the bf16 wgmma kernel once a layer), then
    greedy_generate on 4 prompts of 32 tokens, 16 new.  Gated on
    finiteness, shapes and launches only: an MoE model's decode routes B
    tokens a step under capacity max(1, int(1.25 * B * 6 / 64)) = 1, so it
    drops choices a prefill keeps, and the two do not agree (the
    reference's semantics)."""
    import torch

    from repro_torch.data.synthetic import step_generator, token_batch
    from repro_torch.models.steps import greedy_generate, make_prefill_step

    cfg, params = g2["cfg"], g2["state"].params
    tokens = token_batch(step_generator(seed, 0, 0), batch, seq - 1, cfg.vocab, device=dev)
    prefill = make_prefill_step(cfg)
    batch_in = {"tokens": tokens}
    prefill(params, batch_in)  # the one cast of the weights, and warm-up
    torch.cuda.synchronize()
    zero_counts()
    logits = prefill(params, batch_in)
    torch.cuda.synchronize()
    counts = read_counts()
    dev_ms, host_ms = timed_calls(lambda: prefill(params, batch_in), iters=3)
    prompt = tokens[:, :prompt_len].contiguous()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, steps, prompt_len + steps)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    gen_counts = read_counts()
    print(f"Path E5: {cfg.name} ({cfg.n_layers} layers, trained {TRAIN_STEPS} steps by Path "
          f"G2) prefill B={batch} S={seq}: device {dev_ms:.2f} ms, host clock {host_ms:.2f} ms, "
          f"{batch * seq / (host_ms / 1e3):.0f} tokens/s; greedy_generate prompts "
          f"{tuple(prompt.shape)}, {steps} new tokens in {gen_ms:.1f} ms (host clock, the one "
          f"cast included): {gen_ms / steps:.2f} ms a generated token, "
          f"{gen_ms / (prompt_len + steps - 1):.2f} ms a decode step, "
          f"{batch * steps / (gen_ms / 1e3):.1f} tokens/s; first row {out[0, :8].tolist()}...; "
          f"launches: prefill {counts}, greedy {gen_counts}")
    if logits.shape != (batch, cfg.vocab_padded) or not bool(torch.isfinite(logits).all()):
        fail(f"Path E5 logits have shape {tuple(logits.shape)} or non-finite values")
    if out.shape != (batch, steps) or not (0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        fail(f"Path E5: tokens of shape {tuple(out.shape)} outside [0, {cfg.vocab})")
    want = dict.fromkeys(counts, 0)
    if any(gen_counts.values()):
        fail(f"Path E5: the decode path launched kernels {gen_counts}")
    want.update(flash_attention_sm90=cfg.n_layers)
    if counts != want:
        fail(f"Path E5 launch counts {counts}; expected {want} (one a layer)")
    return dict(counts=counts, dev_ms=dev_ms, host_ms=host_ms, gen_ms=gen_ms)


def train_cli_chains(d: Path) -> dict:
    """``python -m repro_torch.launch.train --arch minitron-4b --smoke
    --steps 20 --ckpt-every 10`` on the card as a process, then again with
    the same checkpoint directory: the second run must resume from step 20.
    Its attention is the mma.sync kernel at the SMOKE head, D = 8, in bf16:
    bf16 products, P split into hi + lo (held against its plain version at
    this shape in phase 2)."""
    cmd = dict(argv=["-m", "repro_torch.launch.train", "--arch", "minitron-4b", "--smoke",
                     "--steps", "20", "--ckpt-every", "10", "--ckpt-dir", str(d / "train_ckpt")],
               env={})
    return {"train CLI": [cmd, cmd]}


def check_train_cli(out: dict) -> None:
    first, second = out["train CLI"]
    losses = [_floats(ln.split("loss")[1])[0] for ln in first.splitlines()
              if ln.startswith("step")]
    if "resumed" in first or len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        fail(f"train CLI: the first run's progress lines {losses}")
    if "resumed from step 20" not in second:
        fail("train CLI: the second run did not resume from step 20")


def process_phase(extra: dict) -> tuple[dict, dict]:
    """Every command a user runs as a process, in one batch on the card:
    the recovery and serve CLIs under ``--tune``, the serve CLI, the
    recovery CLI's 2x2-mesh and TV runs, the examples and the training CLI
    (each chain's checks as before), and the ``extra`` chains, whose output
    a later path reads; its wall time beside the commands' summed time,
    which running them one at a time would take.  -> run_chains' result."""
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        d = Path(d)
        # the longest chains first (~50, 40, 39, 35 and 28 s alone on the H100)
        chains = {**cli_chains(d), **tune_cli_chains(d), **train_cli_chains(d), **extra,
                  **example_chains(d), **serve_cli_chains()}
        t0 = time.perf_counter()
        out, walls = run_chains(chains)
        wall = time.perf_counter() - t0
    check_tune_cli(out)
    check_serve_cli(out)
    check_cli(out)
    check_examples(out)
    check_train_cli(out)
    n, summed = sum(len(c) for c in chains.values()), sum(map(sum, walls.values()))
    print(f"Processes: {n} commands in {len(chains)} chains, {PROCESS_WORKERS} at a time, took "
          f"{wall:.1f} s against {summed:.1f} s one after another (saving {summed - wall:.1f} s)")
    return out, walls


# ---------------------------------------------------------------------------
# Paths E6-E9: the MLA, Mamba-2 hybrid and xLSTM families at full width
# ---------------------------------------------------------------------------


def prefill_work(cfg, params, batch: int, seq: int, enc_seq: int = 0,
                 input_bytes: float = 0.0) -> tuple[float, float]:
    """(FLOP, bytes) the least a prefill of batch x seq positions (an image
    prefix included) needs at ``cfg``: every product of the layers 2 FLOP a
    weight and position (an MoE layer's routed experts at the k each token
    chose, its shared experts and router whole; zamba2's shared block once
    an invocation); causal attention's Q.K^T and P.V over half the square;
    the SSD's and mLSTM's chunk products over half of each chunk's square,
    plus their chunk states; an encoder-decoder's encoder over ``enc_seq``
    positions (its attention non-causal, over the whole square) and its
    cross layers (Q and the output over the decoder's positions, K and V
    over the encoder's, Q.K^T and P.V over seq x enc_seq); the head at the
    last position only.  Bytes: every weight's bf16 copy read once (the
    embedding table as the batch's rows), plus ``input_bytes`` (frames or
    image embeddings)."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.lm import segments_of, shared_invocations, tree_items

    tokens = batch * seq
    flops = 2.0 * batch * cfg.d_model * cfg.vocab_padded  # the head, last position
    hd = cfg.resolved_head_dim
    for si, seg in enumerate(segments_of(cfg)):
        for path, w in tree_items(params["segments"][si]):
            if w.ndim >= 3:  # (layers, d_in, d_out), an MoE expert stack (layers, E, ., .)
                share = (cfg.top_k / cfg.n_experts
                         if path[0] == "moe" and path[1] in ("w_gate", "w_up", "w_down") else 1)
                flops += 2.0 * w.numel() * share * tokens
        if seg.kind in ("dense", "moe"):
            dqk, dv = ((cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim)
                       if cfg.attn_type == "mla" else (hd,) * 2)
            flops += seg.n * batch * cfg.n_heads * seq * seq * (dqk + dv)
        elif seg.kind == "mamba2":
            h, n, p = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
            flops += seg.n * tokens * (ssm.CHUNK * h * (n + p) + 4 * h * n * p)
        elif seg.kind == "mlstm":
            h, dk = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
            flops += seg.n * tokens * (xlstm.CHUNK * h * 2 * dk + 4 * h * dk * dk)
    if "shared_attn" in params:
        inv = shared_invocations(cfg)
        flops += inv * sum(2.0 * w.numel() * tokens for _, w in tree_items(params["shared_attn"])
                           if w.ndim == 2)
        flops += inv * 2 * batch * cfg.n_heads * seq * seq * hd
    if "encoder" in params:
        enc_tokens = batch * enc_seq
        flops += sum(2.0 * w.numel() * enc_tokens
                     for _, w in tree_items(params["encoder"]["layers"]) if w.ndim >= 3)
        flops += cfg.n_enc_layers * 4.0 * batch * cfg.n_heads * enc_seq * enc_seq * hd
        cross = params["cross"]["attn"]
        flops += 2.0 * (cross["wq"].numel() + cross["wo"].numel()) * tokens
        flops += 2.0 * (cross["wk"].numel() + cross["wv"].numel()) * enc_tokens
        flops += cfg.n_layers * 4.0 * batch * cfg.n_heads * seq * enc_seq * hd
    table = params["embed"]["table"]
    n_bytes = 2.0 * (sum(t.numel() for _, t in tree_items(params)) - table.numel()
                     + tokens * cfg.d_model) + input_bytes
    return flops, n_bytes


def prefill_phase(name, cfg, params, tokens, iters=3, inputs=None) -> dict:
    """``make_prefill_step`` on ``tokens`` and ``inputs`` (``frames``,
    ``img_embeds``): the one cast and a warm-up, then one counted call (the
    launch counters zeroed just before), then ``iters`` timed calls; device
    and host ms, positions/s, peak memory, the bound (FLOPs at 989 TFLOP/s
    plus the weights' and inputs' bytes at 3.35 TB/s)."""
    import torch

    from repro_torch.models.steps import make_prefill_step

    prefill = make_prefill_step(cfg)
    inputs = inputs or {}
    batch_in = {"tokens": tokens, **inputs}
    t0 = time.perf_counter()
    prefill(params, batch_in)  # the one cast of the weights to bf16, and warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    logits = prefill(params, batch_in)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, host_ms = timed_calls(lambda: prefill(params, batch_in), iters=iters)
    b, s = tokens.shape
    img, frames = inputs.get("img_embeds"), inputs.get("frames")
    s += 0 if img is None else img.shape[1]
    flops, n_bytes = prefill_work(
        cfg, params, b, s, enc_seq=0 if frames is None else frames.shape[1],
        input_bytes=sum(t.numel() * t.element_size() for t in inputs.values()))
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3 + n_bytes / HBM_BYTES_PER_S * 1e3
    tok_s = b * s / (host_ms / 1e3)
    enc = "" if frames is None else f", {frames.shape[1]} encoder frames"
    print(f"Path {name}: {cfg.name}, {cfg.n_layers} layers {sorted(set(cfg.layer_kinds()))}, "
          f"prefill B={b} S={s}{enc}: cast + warm-up {warm_s:.2f} s; device {dev_ms:.2f} ms, "
          f"host clock {host_ms:.2f} ms, {tok_s:.0f} positions/s, peak memory {peak_gib:.2f} "
          f"GiB; bound {bound_ms:.2f} ms ({flops:.3e} FLOP at 989 TFLOP/s + {n_bytes / 1e9:.2f} "
          f"GB of bf16 weights and inputs at 3.35 TB/s), {bound_ms / dev_ms:.1%} of the device "
          f"time; launches {counts}")
    if logits.shape != (b, cfg.vocab_padded) or not bool(torch.isfinite(logits).all()):
        fail(f"Path {name} logits have shape {tuple(logits.shape)} or non-finite values")
    return dict(prefill=prefill, logits=logits, counts=counts, dev_ms=dev_ms, host_ms=host_ms,
                tok_s=tok_s, peak_gib=peak_gib, bound_ms=bound_ms, flops=flops, bytes=n_bytes)


def decode_run(cfg, params, tokens, max_len, decode=None, cross_kv=None) -> dict:
    """``tokens`` (B, T) fed one at a time through ``make_decode_step`` from
    an empty state (an encoder-decoder's against ``cross_kv``); every step's
    logits, host ms a step to a synchronize."""
    import torch

    from repro_torch.models.lm import init_decode_state
    from repro_torch.models.steps import make_decode_step

    decode = decode or make_decode_step(cfg)
    state = init_decode_state(cfg, tokens.shape[0], max_len, cross_kv=cross_kv,
                              device=tokens.device)
    logits = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(tokens.shape[1]):
        out, state = decode(params, tokens[:, i:i + 1], state)
        logits.append(out)
    torch.cuda.synchronize()
    return dict(logits=logits, state=state, decode=decode,
                ms_step=(time.perf_counter() - t0) * 1e3 / tokens.shape[1])


def decode_profile(name, cfg, params, tokens, max_len, steps=PROFILED_STEPS) -> dict:
    """Device and host ms of a decode step: ``tokens[:, :-steps]`` fed from
    an empty state, the last ``steps`` under torch.profiler."""
    from repro_torch.models.lm import init_decode_state
    from repro_torch.models.steps import make_decode_step

    decode = make_decode_step(cfg)
    box = [init_decode_state(cfg, tokens.shape[0], max_len, device=tokens.device), 0]

    def one():
        i = box[1]
        _, box[0] = decode(params, tokens[:, i:i + 1], box[0])
        box[1] = i + 1

    for _ in range(tokens.shape[1] - steps):
        one()
    return profile_window(one, f"Path {name} decode steps", steps=steps)


@contextlib.contextmanager
def recorded_routing():
    """Every MoE routing's top-k expert ids (T, k), in call order, while the
    context is open (``moe._routing`` wrapped; its results unchanged)."""
    from repro_torch.models import moe

    routes, real = [], moe._routing

    def recording(params, cfg, x2d):
        idx, gates, aux = real(params, cfg, x2d)
        routes.append(idx)
        return idx, gates, aux

    moe._routing = recording
    try:
        yield routes
    finally:
        moe._routing = real


def path_e6(dev, seed, batch=4, seq=2048, decode_tokens=16, mla_positions=32) -> dict:
    """deepseek-v3-671b FULL (d_model 7168, 128 heads of MLA: q / k head 128
    + 64, v head 128, latent 512, q latent 1536; vocab 129280) cut to 3
    layers, one dense and two MoE of 32 of the 256 routed experts (top-8, 1
    shared kept): prefill 4 x 2048 (no kernel: MLA's q / k and v heads
    differ, so its attention is the plain ``_attend_chunked``, as the
    reference's); then 16 prompt tokens through ``decode_step`` with
    ``mla_absorbed`` False and True from empty states, in bf16 (timed; the
    two printed beside the tokens whose routing they chose differently: a
    decode step routes its 4 tokens under capacity 1, so a rounding that
    moves a router logit past a tie moves a whole expert) and in float32,
    where the two are held together at TOL_PATHS; then one MLA layer at
    full width in float32:
    ``mla_decode`` and ``mla_decode_absorbed`` fed 32 positions one at a
    time against ``mla_forward`` at TOL_PATHS."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import attention as attn
    from repro_torch.models.config import count_params
    from repro_torch.models.lm import init_params, tree_items

    cfg = lm_config("deepseek-v3-671b", n_layers=3, first_k_dense=1, n_experts=32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_items(params))
    n_norms = sum(t.numel() for p, t in tree_items(params) if p[-1] in ("scale", "router_bias"))
    counted = count_params(cfg)
    print(f"Path E6: {cfg.name} cut to {cfg.layer_kinds()}, {cfg.n_experts} of 256 routed "
          f"experts, {n_params / 1e9:.3f} B parameters ({n_params - n_norms} + {n_norms} norm "
          f"scales and router biases; count_params {counted}), init {init_s:.2f} s")
    if n_params - n_norms != counted["total"]:
        fail(f"Path E6: {n_params - n_norms} parameters; count_params says {counted}")
    tokens = token_batch(gen, batch, seq - 1, cfg.vocab, device=dev)
    out = prefill_phase("E6", cfg, params, tokens)
    del out["prefill"], out["logits"]  # the prefill's bf16 copy of the weights
    if any(out["counts"].values()):
        fail(f"Path E6: MLA's prefill launched kernels {out['counts']}")
    prompt = tokens[:, :decode_tokens].contiguous()
    zero_counts()
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for absorbed in (False, True):
            with recorded_routing() as routes:
                run = decode_run(dataclasses.replace(cfg, dtype=dtype, mla_absorbed=absorbed),
                                 params, prompt, decode_tokens)
            runs[dtype, absorbed] = dict(logits=[t.float() for t in run["logits"]],
                                         ms_step=run["ms_step"], routes=routes)
            del run
    counts = read_counts()
    errs, flips = {}, {}
    for dtype in ("bfloat16", "float32"):
        naive, absorbed = runs[dtype, False], runs[dtype, True]
        errs[dtype] = [rel_err(a, n)[1] for a, n in zip(absorbed["logits"], naive["logits"])]
        flips[dtype] = sum(int((a != n).any(-1).sum()) for a, n in zip(absorbed["routes"],
                                                                       naive["routes"]))
    finite = all(bool(torch.isfinite(t).all()) for r in runs.values() for t in r["logits"])
    decode_ms = {f"{d} {'absorbed' if a else 'naive'}": r["ms_step"]
                 for (d, a), r in runs.items()}
    n_routes = sum(int(r.shape[0]) for r in runs["bfloat16", False]["routes"])
    print(f"Path E6 decode of {decode_tokens} prompt tokens from empty states, ms a step (host "
          f"clock): {decode_ms}; absorbed vs naive logits norm-rel by step: bf16 "
          f"{[f'{e:.2e}' for e in errs['bfloat16']]}, float32 "
          f"{[f'{e:.2e}' for e in errs['float32']]} (tol {TOL_PATHS:.0e} in float32); tokens "
          f"whose top-k experts differ between the two runs, of {n_routes} routed: {flips} (an "
          f"MoE decode step routes its 4 tokens under capacity 1); launches {counts}")
    if not finite or not max(errs["float32"]) <= TOL_PATHS:
        fail(f"Path E6: the absorbed and naive decodes disagree: {errs} (finite {finite})")
    if any(counts.values()):
        fail(f"Path E6: the decode launched kernels {counts}")
    del params, runs
    torch.cuda.empty_cache()
    # one MLA layer at full width in float32
    f32 = dataclasses.replace(cfg, dtype="float32")
    layer = attn.init_mla(gen, f32, torch.float32)
    x = torch.randn(2, mla_positions, cfg.d_model, generator=gen, device=dev) * 0.3
    full = attn.mla_forward(layer, f32, x, torch.arange(mla_positions, device=dev).expand(2, -1))
    mla_errs = {}
    for name, fn in (("mla_decode", attn.mla_decode),
                     ("mla_decode_absorbed", attn.mla_decode_absorbed)):
        cache = attn.init_mla_cache(f32, 2, mla_positions, torch.float32, dev)
        steps = []
        for t in range(mla_positions):
            y, cache = fn(layer, f32, x[:, t:t + 1], cache)
            steps.append(y)
        mla_errs[name] = rel_err(torch.cat(steps, dim=1), full)[1]
    print(f"Path E6 one MLA layer at full width, float32, B=2, {mla_positions} positions fed one "
          f"at a time against mla_forward: norm-rel {mla_errs} (tol {TOL_PATHS:.0e})")
    if not max(mla_errs.values()) <= TOL_PATHS:
        fail(f"Path E6: MLA's decode disagrees with its forward at full width: {mla_errs}")
    out.update(decode_errs=errs, decode_ms=decode_ms, flips=flips, mla_errs=mla_errs,
               n_params=n_params)
    return out


def path_e7(dev, seed, batch=4, seq=2048, prompt_len=32, steps=32) -> dict:
    """zamba2-1.2b FULL, all 38 Mamba-2 layers (d_model 2048, 64 SSM heads of
    64, state 64, 8 groups) with the shared attention + MLP block (32 heads
    of 64, causal, no window) after layers 0, 6, ..., 36: prefill 4 x 2048,
    the wgmma flash kernel once an invocation (7 launches); then
    ``greedy_generate``, 4 prompts of 32 tokens and 32 new, with ``max_len``
    sized for the shared cache's 7 positions a token; a decode step's device
    and host ms under torch.profiler.  Gated on finiteness and launches: the
    reference's decode shares one KV cache across the invocations and does
    not agree with its prefill (ROADMAP.md Queue 3)."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import init_params, shared_invocations, tree_items
    from repro_torch.models.steps import greedy_generate

    cfg = lm_config("zamba2-1.2b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    inv = shared_invocations(cfg)
    print(f"Path E7: {cfg.name}, {cfg.n_layers} layers, the shared block {inv} times a token, "
          f"{n_params / 1e9:.3f} B parameters, init {time.perf_counter() - t0:.2f} s")
    tokens = token_batch(gen, batch, seq - 1, cfg.vocab, device=dev)
    out = prefill_phase("E7", cfg, params, tokens)
    del out["prefill"], out["logits"]
    want = dict.fromkeys(out["counts"], 0)
    want.update(flash_attention_sm90=inv)
    if out["counts"] != want:
        fail(f"Path E7 launch counts {out['counts']}; expected {want} (one an invocation)")
    prompt = tokens[:, :prompt_len].contiguous()
    max_len = inv * (prompt_len + steps)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_tokens = greedy_generate(params, cfg, prompt, steps, max_len)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    gen_counts = read_counts()
    gen_peak = torch.cuda.max_memory_allocated() / 2**30
    prof = decode_profile("E7", cfg, params, prompt[:, :8], inv * 8)
    n_calls = prompt_len + steps - 1
    print(f"Path E7 greedy_generate, prompts {tuple(prompt.shape)}, {steps} new tokens, max_len "
          f"{max_len} ({inv} shared positions a token): {gen_ms:.1f} ms (host clock, the one "
          f"cast included), {gen_ms / n_calls:.2f} ms a decode step; a profiled step: device "
          f"busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms, {prof['launches']:g} device "
          f"operations; peak memory {gen_peak:.2f} GiB; first row {gen_tokens[0, :8].tolist()}"
          f"...; launches {gen_counts}")
    if gen_tokens.shape != (batch, steps) or not (0 <= int(gen_tokens.min())
                                                  and int(gen_tokens.max()) < cfg.vocab):
        fail(f"Path E7: tokens of shape {tuple(gen_tokens.shape)} outside [0, {cfg.vocab})")
    if any(gen_counts.values()):
        fail(f"Path E7: the decode path launched kernels {gen_counts}")
    del params
    torch.cuda.empty_cache()
    out.update(gen_ms=gen_ms, ms_step=gen_ms / n_calls, step_busy_ms=prof["busy_ms"],
               step_wall_ms=prof["wall_ms"], gen_peak_gib=gen_peak, n_params=n_params)
    return out


def layer_times(cfg, params, tokens) -> dict:
    """{layer kind: device ms} of one prefill of ``tokens``, cut by CUDA
    events between its layers (the stack's loop as ``lm.backbone_forward``
    runs it, on the cast weights): a host-issued layer keeps the device
    waiting, and the span between its events counts that wait."""
    import torch

    from repro_torch.models import lm

    p = lm.cast_params(params, cfg)
    spans = []
    with torch.no_grad():
        x = lm._embed_scaled(p, cfg, tokens)
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[0], -1)
        for si, seg in enumerate(lm.segments_of(cfg)):
            for i in range(seg.n):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                x, _ = lm._layer_forward(lm._layer(p["segments"][si], i), seg.kind, cfg, x,
                                         positions, p.get("shared_attn"), seg.start + i)
                ev[1].record()
                spans.append((seg.kind, ev))
    torch.cuda.synchronize()
    out = {}
    for kind, (a, b) in spans:
        out[kind] = out.get(kind, 0.0) + a.elapsed_time(b)
    return out


def path_e8(dev, seed, batch=4, seq=2048, decode_tokens=64) -> dict:
    """xlstm-350m FULL, all 24 layers (d_model 1024, 4 heads; mLSTM with an
    sLSTM every 8th): prefill 4 x 2048 (no kernel); one more prefill cut by
    CUDA events between its layers, for the sLSTM layers' share (a loop over
    2048 positions, issued by the host step by step); then 64 prompt tokens
    through ``decode_step`` against a prefill of the same 64 tokens, in bf16
    (printed: 24 layers of xLSTM amplify bf16 rounding, and the reference's
    own decode misses TOL_PREFILL_DECODE at 8 layers) and in float32, where
    the last logits are held at TOL_PREFILL_DECODE."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import init_params, tree_items
    from repro_torch.models.steps import make_prefill_step

    cfg = lm_config("xlstm-350m")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg, device=dev)
    n_params = sum(t.numel() for _, t in tree_items(params))
    tokens = token_batch(gen, batch, seq - 1, cfg.vocab, device=dev)
    out = prefill_phase("E8", cfg, params, tokens, iters=2)
    if any(out["counts"].values()):
        fail(f"Path E8: the prefill launched kernels {out['counts']}")
    by_kind = layer_times(cfg, params, tokens)
    share = by_kind["slstm"] / sum(by_kind.values())
    prompt = tokens[:, :decode_tokens].contiguous()
    zero_counts()
    errs, ms_step = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        run = decode_run(c, params, prompt, decode_tokens)
        want = make_prefill_step(c)(params, {"tokens": prompt})
        errs[dtype] = rel_err(run["logits"][-1].float(), want.float())
        ms_step[dtype] = run["ms_step"]
        if not bool(torch.isfinite(run["logits"][-1]).all()):
            fail(f"Path E8: non-finite {dtype} decode logits")
        del run
    counts = read_counts()
    print(f"Path E8 one prefill cut by CUDA events between its layers: mlstm "
          f"{by_kind['mlstm']:.2f} ms, slstm {by_kind['slstm']:.2f} ms ({share:.1%} of the "
          f"layers' {sum(by_kind.values()):.2f} ms); {decode_tokens} prompt tokens decoded one at "
          f"a time, ms a step (host clock, the one cast included) {ms_step}; last logits vs a "
          f"prefill of the same tokens, (max abs, norm-rel): bf16 {errs['bfloat16']} (printed), "
          f"float32 {errs['float32']} (tol {TOL_PREFILL_DECODE:.0e}); launches {counts}")
    if not errs["float32"][1] <= TOL_PREFILL_DECODE:
        fail(f"Path E8: decode and prefill disagree in float32: {errs['float32']}")
    if any(counts.values()):
        fail(f"Path E8: the decode launched kernels {counts}")
    del out["prefill"], out["logits"], params
    torch.cuda.empty_cache()
    out.update(layer_ms=by_kind, slstm_share=share, decode_errs=errs, decode_ms=ms_step,
               n_params=n_params)
    return out


@contextlib.contextmanager
def float64_step():
    """Inside, every aten op the step runs, its backward's included, is
    asked for float64 wherever it is asked for a narrower float (the model
    code's upcasts ``.float()`` and ``.to(torch.float32)``, the reference's
    ``astype(float32)`` before a recurrence or a softmax, the float32
    buffers its recurrences start from, a reduction's ``dtype``), and the
    default dtype is float64 (RoPE's and the sinusoids' ``arange``, a
    ``torch.tensor`` constant), so that a step on float64 parameters and
    inputs runs in float64 throughout: Path G11's exact reference.  An op
    that still gives a narrower float (a float32 tensor made before the
    step) fails it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map as map_leaves

    narrow_dtypes = (torch.float32, torch.bfloat16, torch.float16)
    widen = lambda a: torch.float64 if isinstance(a, torch.dtype) and a in narrow_dtypes else a
    narrow = set()

    class Float64(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*map_leaves(widen, args), **map_leaves(widen, kwargs or {}))
            narrow.update(f"{func} -> {t.dtype}" for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor) and t.dtype in narrow_dtypes)
            return out

    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with Float64():
            yield
    finally:
        torch.set_default_dtype(default)
    if narrow:
        fail(f"float64_step: the step ran ops below float64: {sorted(narrow)[:8]}")


def grads_card_vs_cpu(cfg, params, cpu_params, batch, dev) -> dict:
    """Path G11 for one family: ``loss_fn``'s loss and every gradient leaf
    (``grads_of``) on the CPU and on the card in float32, cuBLAS with TF32
    off; the card's launches counted alone.  The loss within TOL_CARD_CPU;
    each leaf within TOL_CARD_CPU_GRAD, norm-relative, or, for a family with
    a leaf that misses it, within TOL_CARD_F64_FACTOR times the CPU's own
    error against a float64 step plus TOL_CARD_CPU_GRAD."""
    import dataclasses

    import torch

    from repro_torch.models.lm import tree_map
    from repro_torch.models.steps import grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    name = f"Path G11 {cfg.name}"
    t0 = time.perf_counter()
    cpu_m, cpu_g = grads_of(cpu_params, cfg, batch)
    cpu_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    dev_m, dev_g = grads_of(params, cfg, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    counts = read_counts()
    loss_err = abs(float(dev_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
    paths = list(grad_leaves(cpu_params, cpu_g))
    unreached = [p for p, c, d in zip(paths, cpu_g, dev_g) if c is None or d is None]
    if any((c is None) != (d is None) for c, d in zip(cpu_g, dev_g)):
        fail(f"{name}: the loss reaches other leaves on the card and the CPU: {unreached}")
    # router_bias reaches the loss only through topk's indices: no gradient on either side
    keep = [i for i, c in enumerate(cpu_g) if c is not None]
    paths, cpu_g = [paths[i] for i in keep], [cpu_g[i] for i in keep]
    dev_g = [dev_g[i].cpu() for i in keep]
    errs = {p: rel_err(d.float(), c.float())[1] for p, c, d in zip(paths, cpu_g, dev_g)}
    worst = sorted(errs.items(), key=lambda kv: kv[1], reverse=True)
    print(f"{name}: loss CPU {float(cpu_m['loss']):.6f} ({cpu_s:.2f} s with its gradient), card "
          f"{float(dev_m['loss']):.6f} ({dev_s:.2f} s), relative {loss_err:.3e} (tol "
          f"{TOL_CARD_CPU:.0e}); {len(errs)} gradient leaves, norm-relative card vs CPU: worst "
          f"{[(p, f'{e:.3e}') for p, e in worst[:4]]}, median {worst[len(worst) // 2][1]:.3e} "
          f"(tol {TOL_CARD_CPU_GRAD:.0e}); no gradient on either side {unreached}; launches "
          f"{counts}")
    if not loss_err <= TOL_CARD_CPU or not all(math.isfinite(e) for e in errs.values()):
        fail(f"{name}: the card's loss disagrees with the CPU's: {loss_err}")
    out = dict(counts=counts, loss_err=loss_err, worst=worst[0], f64=None)
    missed = [p for p, e in worst if e > TOL_CARD_CPU_GRAD]
    if not missed:
        return out
    t0 = time.perf_counter()
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    with float64_step():
        _, exact = grads_of(tree_map(lambda a: a.double() if a.is_floating_point() else a,
                                     cpu_params), cfg64,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in batch.items()})
    exact = [exact[i] for i in keep]
    if any(x.dtype != torch.float64 for x in exact):
        fail(f"{name}: the float64 step gave gradients {sorted({str(x.dtype) for x in exact})}")
    rows = []
    for p, c, d, x in zip(paths, cpu_g, dev_g, exact):
        cpu_x, dev_x = rel_err(c.double(), x)[1], rel_err(d.double(), x)[1]
        rows.append((p, dev_x, cpu_x, dev_x <= TOL_CARD_F64_FACTOR * cpu_x + TOL_CARD_CPU_GRAD))
    bad = [r for r in rows if not r[3]]
    print(f"{name}: {len(missed)} leaves past {TOL_CARD_CPU_GRAD:.0e} ({missed[:6]}); a float64 "
          f"step on the CPU ({time.perf_counter() - t0:.2f} s): card and CPU float32 against it, "
          f"norm-relative, where the card's is largest "
          + str([(p, f"card {a:.3e}", f"CPU {b:.3e}") for p, a, b, _ in
                 sorted(rows, key=lambda r: r[1], reverse=True)[:4]])
          + f"; gate card <= {TOL_CARD_F64_FACTOR:g} x CPU + {TOL_CARD_CPU_GRAD:.0e}: "
          f"{len(rows) - len(bad)} of {len(rows)} leaves meet it")
    if bad:
        fail(f"{name}: gradients {[(p, a, b) for p, a, b, _ in bad[:6]]} past "
             f"{TOL_CARD_F64_FACTOR:g} x the CPU's float32 error against float64 + "
             f"{TOL_CARD_CPU_GRAD:.0e}")
    out["f64"] = dict(missed=missed, worst=max(rows, key=lambda r: r[1])[:3])
    return out


def path_e9(dev, seed, batch=2, seq=16, steps=8, enc_seq=64) -> dict:
    """The five families at full width in float32, the card against the
    CPU (as Path E3 for minitron): deepseek-v3 cut to 2 layers (one dense,
    one MoE of 8 routed experts), zamba2 to 7 layers (the shared block after
    layers 0 and 6: two invocations share the decode cache), xlstm-350m to 8
    (7 mLSTM, 1 sLSTM), whisper-large-v3 to 2 encoder and 2 decoder layers
    (64 frames), pixtral-12b to 2 layers (8 image embeddings before the
    text).  Each is initialised on the card from a seed and copied to the
    CPU; a prefill of 2 x 16 tokens (zamba2's shared block and every
    attention of whisper and pixtral through the mma.sync kernel on the
    card, whisper's non-causal and at Sq != Sk; the plain version on the
    CPU), whisper's ``encoder_forward``, and 8 decode steps from an empty
    state (whisper's against the encoder's output, the cross-attention on
    the kernel at Sq = 1), every output held at TOL_CARD_CPU.  Then Path
    G11 on the same parameters and tokens (:func:`grads_card_vs_cpu`)."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import encoder_forward, init_params, shared_invocations, tree_map
    from repro_torch.models.steps import make_prefill_step

    cases = (("deepseek-v3-671b", dict(n_layers=2, first_k_dense=1, n_experts=8)),
             ("zamba2-1.2b", dict(n_layers=7)), ("xlstm-350m", dict(n_layers=8)),
             ("whisper-large-v3", dict(n_layers=2, n_enc_layers=2)),
             ("pixtral-12b", dict(n_layers=2, n_img_tokens=8)))
    total = dict.fromkeys(_wrappers(), 0)
    g11_total, g11_s = dict.fromkeys(_wrappers(), 0), 0.0
    errs, g11 = {}, {}
    for arch, cut in cases:
        cfg = lm_config(arch, dtype="float32", **cut)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(gen, cfg, device=dev)
        cpu_params = tree_map(lambda a: a.cpu(), params)
        tokens = token_batch(gen, batch, seq - 1, cfg.vocab, device=dev)
        inputs = {}
        if cfg.is_encdec:
            inputs["frames"] = torch.randn(batch, enc_seq, cfg.d_model, generator=gen,
                                           device=dev) * 0.02
        if cfg.n_img_tokens:
            inputs["img_embeds"] = torch.randn(batch, cfg.n_img_tokens, cfg.d_model,
                                               generator=gen, device=dev) * 0.02
        max_len = steps * max(1, shared_invocations(cfg))

        def run(p, device):
            moved = {k: v.to(device) for k, v in inputs.items()}
            out = [make_prefill_step(cfg)(p, {"tokens": tokens.to(device), **moved})]
            cross = None
            if cfg.is_encdec:
                with torch.no_grad():
                    cross = encoder_forward(p, cfg, moved["frames"])
                out.append(cross)
            return out + decode_run(cfg, p, tokens[:, :steps].to(device), max_len,
                                    cross_kv=cross)["logits"]

        t0 = time.perf_counter()
        want = run(cpu_params, "cpu")
        cpu_s = time.perf_counter() - t0
        zero_counts()
        got = run(params, dev)
        torch.cuda.synchronize()
        counts = read_counts()
        errs[arch] = [rel_err(g.float().cpu(), w.float())[1] for g, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        enc = (f", encoder_forward over {enc_seq} frames norm-rel {errs[arch][1]:.3e}"
               if cfg.is_encdec else "")
        print(f"Path E9 {cfg.name} cut to {len(cfg.layer_kinds())} layers "
              f"{sorted(set(cfg.layer_kinds()))}{inputs and f' with {sorted(inputs)}' or ''}, "
              f"float32, card vs CPU (CPU {cpu_s:.2f} s): prefill B={batch} S={seq} norm-rel "
              f"{errs[arch][0]:.3e}{enc}, {steps} decode steps worst "
              f"{max(errs[arch][1 + cfg.is_encdec:]):.3e} (tol {TOL_CARD_CPU:.0e}); launches "
              f"{counts}")
        if not finite or not max(errs[arch]) <= TOL_CARD_CPU:
            fail(f"Path E9 {arch}: the card disagrees with the CPU: {errs[arch]}")
        want_counts = dict.fromkeys(counts, 0)
        if cfg.is_encdec:  # prefill: encoder, decoder, cross; the encoder again; cross a step
            mma = 2 * cfg.n_enc_layers + 2 * cfg.n_layers + steps * cfg.n_layers
        else:
            mma = shared_invocations(cfg) or (cfg.n_layers if arch == "pixtral-12b" else 0)
        want_counts.update(flash_attention_mma=mma)
        if counts != want_counts:
            fail(f"Path E9 {arch} launch counts {counts}; expected {want_counts}")
        total = {k: total[k] + counts[k] for k in total}
        # Path G11: loss_fn's gradient on the same parameters and tokens
        t0 = time.perf_counter()
        g11[arch] = grads_card_vs_cpu(cfg, params, cpu_params,
                                      {"tokens": tokens.cpu(),
                                       **{k: v.cpu() for k, v in inputs.items()}}, dev)
        want_counts = dict.fromkeys(counts, 0)
        want_counts.update(flash_attention_mma=2 * attention_calls(cfg))  # remat: twice
        if g11[arch]["counts"] != want_counts:
            fail(f"Path G11 {arch} launch counts {g11[arch]['counts']}; expected {want_counts}")
        g11_total = {k: g11_total[k] + g11[arch]["counts"][k] for k in g11_total}
        g11_s += time.perf_counter() - t0
        del params, cpu_params
        torch.cuda.empty_cache()
    return dict(counts=total, errs=errs, g11=dict(g11, counts=g11_total, seconds=g11_s))


WHISPER_TEXT_LEN = 448  # whisper's decoder horizon (the reference's launch/specs.py)


def path_e10(dev, seed, batch=4, steps=32) -> dict:
    """whisper-large-v3 FULL: 32 encoder and 32 decoder layers, d_model 1280,
    20 heads of 64 (H = KH), d_ff 5120, vocab 51866, float32 parameters and
    a bf16 compute copy.  4 windows of 1500 frames (the encoder's 30 s after
    the stubbed conv front end, N(0, 0.02^2)) and 448 decoder tokens:
    ``make_prefill_step`` with frames (the wgmma kernel 96 times: 32
    non-causal encoder layers at S = 1500, 32 causal decoder layers at 448,
    32 cross layers at 448 against 1500), its bound; ``encoder_forward``
    alone (32 launches); then 32 decode steps from ``init_decode_state(...,
    max_len=448, cross_kv=...)`` (the cross-attention on the kernel at Sq =
    1 against 1500, 32 launches a step; the cross K / V projected anew every
    step, as the reference does), a step profiled, and the cross K / V
    projections of a step timed alone (32 layers' two products of 4 x 1500
    x 1280 by 1280 x 1280 in bf16, an isolated estimate).  Gated on
    finiteness and launches."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import encoder_forward, init_params, tree_items
    from repro_torch.models.steps import make_decode_step

    cfg = lm_config("whisper-large-v3")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    print(f"Path E10: {cfg.name}, {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
          f"{n_params / 1e9:.3f} B parameters (float32 {4 * n_params / 1e9:.2f} GB, bf16 copy "
          f"{2 * n_params / 1e9:.2f} GB), init {time.perf_counter() - t0:.2f} s")
    frames = torch.randn(batch, cfg.enc_seq_len, cfg.d_model, generator=gen, device=dev) * 0.02
    tokens = token_batch(gen, batch, WHISPER_TEXT_LEN - 1, cfg.vocab, device=dev)
    out = prefill_phase("E10", cfg, params, tokens, inputs={"frames": frames})
    want = dict.fromkeys(out["counts"], 0)
    want.update(flash_attention_sm90=cfg.n_enc_layers + 2 * cfg.n_layers)
    if out["counts"] != want:
        fail(f"Path E10 prefill launch counts {out['counts']}; expected {want} (encoder, "
             f"decoder and cross layers, one each)")
    del out["prefill"]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        cross_kv = encoder_forward(params, cfg, frames)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    enc_counts = read_counts()
    want = dict.fromkeys(enc_counts, 0)
    want.update(flash_attention_sm90=cfg.n_enc_layers)
    if enc_counts != want or not bool(torch.isfinite(cross_kv).all()):
        fail(f"Path E10 encoder_forward: launches {enc_counts} (expected {want}) or non-finite")
    decode = make_decode_step(cfg)
    prompt = tokens[:, :steps + PROFILED_STEPS].contiguous()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = decode_run(cfg, params, prompt[:, :steps], WHISPER_TEXT_LEN, decode=decode,
                     cross_kv=cross_kv)
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = all(bool(torch.isfinite(t).all()) for t in run["logits"])
    box = [run["state"], steps]

    def one():  # the next decode step
        i = box[1]
        _, box[0] = decode(params, prompt[:, i:i + 1], box[0])
        box[1] = i + 1

    prof = profile_window(one, "Path E10 decode steps", steps=PROFILED_STEPS)
    flash_ms = sum(ms for name, ms in prof["kernels"].items() if "flash_fwd" in name)
    wk, wv = (params["cross"]["attn"][w].to(torch.bfloat16) for w in ("wk", "wv"))
    proj_ms = timed_calls(lambda: [cross_kv @ w[i] for i in range(cfg.n_layers)
                                   for w in (wk, wv)], iters=3)[0]
    del wk, wv
    # a step's least work: the decoder's and the cross layers' products on B
    # tokens, the head, the cross K / V of every layer over the encoder's
    # positions, attention over them; the weights it reads in bf16 and the
    # encoder's output once
    cross = params["cross"]["attn"]
    proj_flops = 2.0 * (cross["wk"].numel() + cross["wv"].numel()) * cross_kv.shape[:2].numel()
    used = (sum(t.numel() for _, t in tree_items(params["segments"]))
            + sum(t.numel() for _, t in tree_items(params["cross"]))
            + params["embed"]["unembed"].numel())
    step_flops = (2.0 * batch * (used - cross["wk"].numel() - cross["wv"].numel()) + proj_flops
                  + 4.0 * batch * cfg.n_heads * cross_kv.shape[1] * cfg.resolved_head_dim
                  * cfg.n_layers)
    step_bytes = 2.0 * (used + cross_kv.numel())
    step_bound = step_flops / BF16_FLOPS_PER_S * 1e3 + step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"Path E10 encoder_forward alone: {enc_ms:.2f} ms (host clock to a synchronize, the "
          f"one cast included), launches {enc_counts}; {steps} decode steps against the "
          f"encoder's output: {run['ms_step']:.2f} ms a step (host clock), peak memory "
          f"{peak_gib:.2f} GiB, launches {counts}; a profiled step: device busy "
          f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms, flash kernel (Sq = 1, Sk = "
          f"{cross_kv.shape[1]}) {flash_ms:.4f} ms ({flash_ms / prof['busy_ms']:.1%} of the "
          f"busy time); the cross K / V projections of a step alone {proj_ms:.3f} device ms "
          f"({proj_flops:.3e} FLOP; {proj_ms / prof['busy_ms']:.1%} of a step's busy time, an "
          f"isolated estimate); a step's bound {step_bound:.3f} ms ({step_flops:.3e} FLOP + "
          f"{step_bytes / 1e9:.2f} GB of bf16 weights)")
    if not finite:
        fail("Path E10: non-finite decode logits")
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention_sm90=steps * cfg.n_layers)
    if counts != want:
        fail(f"Path E10 decode launch counts {counts}; expected {want} (one a layer a step)")
    out["counts"] = {k: out["counts"][k] + enc_counts[k] + counts[k] for k in counts}
    out.update(enc_ms=enc_ms, decode_ms=run["ms_step"], step_busy_ms=prof["busy_ms"],
               step_flash_ms=flash_ms, proj_ms=proj_ms, step_bound_ms=step_bound,
               decode_peak_gib=peak_gib, n_params=n_params)
    del params, cross_kv, run, box
    torch.cuda.empty_cache()
    return out


def path_e11(dev, seed, batch=4, text=1024, steps=32) -> dict:
    """pixtral-12b FULL, all 40 layers (d_model 5120, 32 query heads over 8
    KV heads of 128, d_ff 14336, vocab 131072), its parameters held in bf16
    (``param_dtype``: a dtype cut, no width; in float32 with a bf16 copy they
    would take ~73.5 GB of the 80).  4 examples of 1024 image embeddings
    (the stubbed vision encoder's, N(0, 0.02^2)) before 1024 text tokens:
    ``make_prefill_step`` (the wgmma kernel once a layer: 40 launches, at S =
    2048), its bound; the same text prefilled without the image (printed:
    how far the prefix moves the last logits); then 32 text tokens decoded
    one at a time from an empty state against a text-only prefill of them,
    held at TOL_PREFILL_DECODE.  Gated on finiteness, launches and that
    agreement."""
    import torch

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.lm import init_params, tree_items

    cfg = lm_config("pixtral-12b", param_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    print(f"Path E11: {cfg.name}, {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters in "
          f"bf16 ({2 * n_params / 1e9:.2f} GB), init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    img = torch.randn(batch, cfg.n_img_tokens, cfg.d_model, generator=gen, device=dev) * 0.02
    tokens = token_batch(gen, batch, text - 1, cfg.vocab, device=dev)
    out = prefill_phase("E11", cfg, params, tokens, inputs={"img_embeds": img})
    want = dict.fromkeys(out["counts"], 0)
    want.update(flash_attention_sm90=cfg.n_layers)
    if out["counts"] != want:
        fail(f"Path E11 prefill launch counts {out['counts']}; expected {want} (one a layer)")
    prefill = out.pop("prefill")
    text_only = prefill(params, {"tokens": tokens})
    moved = rel_err(text_only.float(), out["logits"].float())
    prompt = tokens[:, :steps].contiguous()
    zero_counts()
    run = decode_run(cfg, params, prompt, steps)
    counts = read_counts()
    want_logits = prefill(params, {"tokens": prompt})
    err = rel_err(run["logits"][-1].float(), want_logits.float())
    finite = (all(bool(torch.isfinite(t).all()) for t in run["logits"])
              and bool(torch.isfinite(text_only).all()))
    print(f"Path E11 the image prefix moves the last logits by max abs {moved[0]:.3e}, norm-rel "
          f"{moved[1]:.3e} against a text-only prefill of the same {text} tokens (printed, not "
          f"gated); {steps} text tokens decoded one at a time: {run['ms_step']:.2f} ms a step "
          f"(host clock, from an empty state), last logits vs a text-only prefill of them: max "
          f"abs {err[0]:.3e}, norm-rel {err[1]:.3e} (tol {TOL_PREFILL_DECODE:.0e}); decode "
          f"launches {counts}")
    if not finite:
        fail("Path E11: non-finite logits")
    if not err[1] <= TOL_PREFILL_DECODE:
        fail(f"Path E11: decode and a text-only prefill disagree: {err}")
    if any(counts.values()):
        fail(f"Path E11: the decode launched kernels {counts}")
    del params, prefill, run
    torch.cuda.empty_cache()
    out.update(image_moves=moved, decode_err=err, n_params=n_params)
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


# Every command a user runs as a process (the CLIs, the examples) goes into
# one batch: a process spends ~10 s reaching the card and importing torch, so
# chains of commands run side by side, each chain's commands in order.
PROCESS_WORKERS = 8


def recover_cmd(args: list, env=None) -> dict:
    return dict(argv=["-m", "repro_torch.launch.recover", *args], env=env or {})


def serve_cmd(args: list, env=None) -> dict:
    return dict(argv=["-m", "repro_torch.launch.serve", *args], env=env or {})


def run_chains(chains: dict) -> tuple[dict, dict]:
    """Run ``chains`` ({name: [command, ...]}, a command being ``argv`` after
    the interpreter, ``env`` added to this process's and an optional
    ``cwd``), PROCESS_WORKERS chains at a time, a chain's commands one after
    another; echo every command's output in the chains' order and fail on
    the first that exited non-zero.  -> ({name: [stdout, ...]}, {name:
    [wall seconds, ...]})."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    def chain_run(chain):
        done = []
        for cmd in chain:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **cmd["env"])
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *cmd["argv"]], cwd=cmd.get("cwd", ROOT),
                                  env=env, capture_output=True, text=True, timeout=600)
            done.append((time.perf_counter() - t0, proc))
            if proc.returncode != 0:
                break
        return done

    with ThreadPoolExecutor(PROCESS_WORKERS) as pool:
        futures = {name: pool.submit(chain_run, chain) for name, chain in chains.items()}
    out, walls = {}, {}
    for name, chain in chains.items():
        out[name], walls[name] = [], []
        for cmd, (wall, proc) in zip(chain, futures[name].result()):
            shown = " ".join(a.replace(f"{ROOT}/", "") for a in cmd["argv"])
            print(f"$ python {shown}   [{wall:.2f} s, exit {proc.returncode}]\n"
                  f"{proc.stdout.rstrip()}")
            if proc.returncode != 0:
                fail(f"{name}: `python {shown}` exited {proc.returncode}: "
                     f"{proc.stderr[-3000:]}")
            out[name].append(proc.stdout)
            walls[name].append(wall)
    return out, walls


def _floats(text: str) -> list:
    return [float(v) for v in re.findall(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|inf|nan)", text)]


def cli_phase() -> dict:
    """The recovery CLI as a user runs it, on the card: a checkpointed run,
    a resume from its checkpoint, and a Sec. 7 deblur run, all on the kernel
    step the plan resolves to on the card, one spectral_pointwise and one
    cpadmm_tail launch an iteration (the resume runs none: its checkpoint is
    at the budget).  The 2x2-mesh deblur runs are :func:`cli_chains`'."""
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


def cli_chains(d: Path) -> dict:
    """The recovery CLI's runs that need processes of their own: the 2x2-mesh
    deblur run of four 512x512 frames on four ranks sharing the card (bf16
    wires) twice on one checkpoint directory, and ``--deblur --size 512
    --prior tv``."""
    mesh = recover_cmd(["--deblur", "--size", "512", "--batch", "4", "--mesh", "2x2",
                        "--fake-devices", "4", "--rfft", "--wire-dtype", "bf16", "--iters",
                        "200", "--chunk", "100", "--ckpt-dir", str(d / "mesh_ckpt")])
    tv = recover_cmd(["--deblur", "--size", "512", "--batch", "2", "--prior", "tv", "--iters",
                      "200", "--chunk", "100", "--ckpt-dir", str(d / "tv_ckpt")])
    return {"recover mesh": [mesh, mesh], "recover tv": [tv]}


def check_cli(out: dict) -> None:
    mesh_first, mesh_second = out["recover mesh"]
    if "resumed" in mesh_first or "resumed from iteration 200" not in mesh_second:
        fail("CLI: the second 2x2-mesh run did not resume from iteration 200")
    mesh_psnr = [_floats(ln.split("PSNR")[1])[0] for ln in mesh_second.splitlines()
                 if "PSNR" in ln]
    if len(mesh_psnr) != 4 or not all(math.isfinite(v) and v > 0 for v in mesh_psnr):
        fail(f"CLI: per-frame PSNR of the 2x2-mesh deblur run is {mesh_psnr}")
    (tv,) = out["recover tv"]
    psnr = [_floats(ln.split("PSNR")[1])[0] for ln in tv.splitlines() if "PSNR" in ln]
    if "prior=tv" not in tv or len(psnr) != 2 or not all(math.isfinite(v) for v in psnr):
        fail(f"CLI --deblur --prior tv: per-frame PSNR {psnr}")


def cli_priors_phase() -> dict:
    """``--prior`` through the recovery CLI on the card: non-negative l1,
    wavelet and TV at n = 65536 = 256^2, B = 4 (the plain step: no kernel
    launch).  Each must end with finite per-signal metrics; the 512 x 512
    deblur under TV is :func:`cli_chains`'."""
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    zero_counts()
    mse = {}
    for prior in ("nonneg-l1", "wavelet", "tv"):
        with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
            out = run_cli(["--n", "65536", "--batch", "4", "--iters", "200", "--chunk", "100",
                           "--prior", prior, "--ckpt-dir", ckpt_dir])
        mse[prior] = _floats(out.split("per-signal MSE:")[-1])
        if f"prior={prior}" not in out or len(mse[prior]) != 4 or not all(
                math.isfinite(v) for v in mse[prior]):
            fail(f"CLI --prior {prior}: per-signal MSE {mse[prior]}")
    counts = read_counts()
    if any(counts.values()):
        fail(f"CLI priors launched kernels: {counts}")
    return dict(counts=counts, mse=mse)


# (script, arguments): each example at its defaults, the distributed one also
# on four gloo ranks sharing the card; the longest first (process_phase)
EXAMPLES = (
    ("torch_train_lm.py", []),
    ("torch_distributed_recovery.py", ["--fake-devices", "4"]),
    ("torch_quickstart.py", []),
    ("torch_deblur_astronomy.py", []),
    ("torch_deblur_multiframe.py", []),
    ("torch_distributed_recovery.py", []),
    ("torch_mapmaking_herschel.py", []),
)


def example_chains(d: Path) -> dict:
    """The port's examples as a user runs them, each from a scratch
    directory of its own (their renders and checkpoints land there)."""
    chains = {}
    for i, (script, args) in enumerate(EXAMPLES):
        cwd = d / f"example{i}"
        cwd.mkdir()
        chains[" ".join([script, *args])] = [
            dict(argv=[str(ROOT / "examples" / script), *args], env={}, cwd=cwd)]
    return chains


def check_examples(out: dict) -> None:
    """Every example exited 0 (run_chains holds that); the quickstart must
    recover with both methods."""
    if out["torch_quickstart.py"][0].count("-> recovered") != 2:
        fail("examples: the quickstart did not recover with both methods")


# -- Paths G4, G5: sharded training on four gloo ranks sharing the card ------
SHARDED_STEPS = 2  # Paths G4 and G5: AdamW warmup 1, total 2
# Adam's update of a weight is lr * m^ / (sqrt(v^) + eps), about lr * sign(g)
# at its first nonzero gradient: where the two runs' gradients straddle zero
# the weight moves by up to lr either way, however well the gradients agree.
# The parameters after the last step are therefore held at TOL_CARD_CPU_GRAD
# of their leaf's largest over the decided weights: those whose gradient, at
# every step, is 0 in both runs or agrees within rho of the one-rank run's
# value, rho = TOL_CARD_CPU_GRAD * (the leaf's largest |w|) / (ADAM_RHO_SCALE
# * the steps' summed rates).  A relative gradient change rho moves the
# first update by at most lr * rho and the second, a ratio of the two steps'
# moments, by about 3 lr * rho, so a decided weight that disagrees by more
# than the tolerance is the optimizer's fault, not the gradients'.  The other
# weights are counted and their worst difference printed: the step-1
# gradient check alone holds them.  The largest |g| / leaf max at which the
# two runs' step-1 signs differ is printed beside it (PERF.md section 6).
ADAM_RHO_SCALE = 4
ERR_CHUNK = 1 << 24  # elements of a block compared at a time


def _sharded_opt():
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(warmup_steps=1, total_steps=SHARDED_STEPS)


def _sharded_batches(cfg, seed, batch, seq) -> list:
    """The global batches of the launcher at ``--seq seq``: (seed, step, 0)."""
    from repro_torch.data.synthetic import step_generator, token_batch

    return [{"tokens": token_batch(step_generator(seed, s, 0), batch, seq, cfg.vocab,
                                   device="cpu")} for s in range(SHARDED_STEPS)]


# Paths G4 / G5 after training, and G6 / G7: a prefill of SERVE_PROMPT tokens, then
# the first SERVE_FED of them fed through the decode step and SERVE_TOKENS greedy
# tokens (G5's and G7's decode steps gather their experts' FSDP blocks through gloo:
# ~1.6 s a step).
SERVE_PROMPT, SERVE_FED, SERVE_TOKENS = 32, 2, 2
LAST_SERVE: dict = {}  # the last _serve's host ms a decode step (to a synchronize)


def _serve_prompt(cfg, seed):
    """Paths G4 / G5's 4 x SERVE_PROMPT prompt, the launcher's batch drawing
    past the trained steps."""
    from repro_torch.data.synthetic import step_generator, token_batch

    return token_batch(step_generator(seed, SHARDED_STEPS, 0), 4, SERVE_PROMPT, cfg.vocab,
                       device="cpu")[:, :SERVE_PROMPT]


def _serve(cfg, params, prompt, steps_n, frames=None, prefill=True):
    """The prefill of ``prompt`` (its last position's logits; ``None`` when
    ``prefill`` is false), then its first SERVE_FED tokens fed one by one
    through the decode step and ``steps_n`` greedy tokens (an argmax loop
    over the decode step, ``greedy_generate``'s) -> (prefill logits, the
    logits each greedy token was taken from (B, steps_n, V), the tokens).
    An encoder-decoder prefills with ``frames`` and decodes against their
    encoder output (``encoder_forward``, the state's ``cross_kv``)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models import steps as steps_mod

    batch = {"tokens": prompt} if frames is None else {"tokens": prompt, "frames": frames}
    first = steps_mod.make_prefill_step(cfg)(params, batch) if prefill else None
    decode = steps_mod.make_decode_step(cfg)
    cross_kv = None
    if frames is not None:
        with torch.no_grad():
            cross_kv = lm.encoder_forward(params, cfg, frames)
    # zamba2's shared cache spends shared_invocations positions a token
    max_len = (SERVE_FED + steps_n) * max(1, lm.shared_invocations(cfg))
    state = lm.init_decode_state(cfg, prompt.shape[0], max_len, cross_kv=cross_kv,
                                 device=prompt.device)
    t0 = time.perf_counter()
    for i in range(SERVE_FED):
        logits, state = decode(params, prompt[:, i:i + 1], state)
    seen, out = [], []
    for i in range(steps_n):
        seen.append(logits)
        out.append(torch.argmax(logits[:, :cfg.vocab], dim=-1))
        if i + 1 < steps_n:
            logits, state = decode(params, out[-1][:, None], state)
    if prompt.is_cuda:
        torch.cuda.synchronize()
    LAST_SERVE["step_ms"] = (time.perf_counter() - t0) * 1e3 / (SERVE_FED + steps_n - 1)
    return first, torch.stack(seen, dim=1), torch.stack(out, dim=1)


@contextlib.contextmanager
def recorded_keeps():
    """(kept, total) (token, choice) pairs of every MoE dispatch, in call order."""
    from repro_torch.models import moe

    keeps, real = [], moe.dispatch_slots

    def recording(cfg, idx):
        slot, keep = real(cfg, idx)
        keeps.append(keep)
        return slot, keep

    moe.dispatch_slots = recording
    try:
        yield keeps
    finally:
        moe.dispatch_slots = real


@contextlib.contextmanager
def collective_timer():
    """Host ms spent in ``torch.distributed.all_reduce`` / ``all_gather``
    while open, each call between two synchronizes (gloo stages a CUDA
    tensor through the host)."""
    import torch
    import torch.distributed as dist

    box = {"ms": 0.0, "calls": 0}
    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def timing(fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            box["ms"] += (time.perf_counter() - t0) * 1e3
            box["calls"] += 1
            return out

        return call

    for n, fn in real.items():
        setattr(dist, n, timing(fn))
    try:
        yield box
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def sharded_baseline(name, cfg, dev, seed, batch, seq, store) -> dict:
    """The one-rank run of Paths G4 / G5 on the card, before the ranks
    start: ``cfg`` from ``seed``, SHARDED_STEPS steps of make_train_step on
    the launcher's global batches; each step's gradient and the parameters
    after the last step go to ``store`` on the host (``grads_<step>.pt``
    for every step, ``params.pt``), the card is freed.  -> the losses, the gradient norms,
    the first routing's ids, the top-k margin of each token and its kept
    share, the launch counts and the host ms of each step."""
    import torch

    from repro_torch.models.lm import tree_items
    from repro_torch.models.steps import init_train_state, make_train_step

    opt = _sharded_opt()
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in _sharded_batches(cfg, seed, batch, seq)]
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed), cfg, opt,
                             device=dev)
    paths = ["/".join(map(str, p)) for p, _ in tree_items(state.params)]
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, gnorms, host_ms, out = [], [], [], {}
    for s, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_routing() as routes, recorded_keeps() as keeps:
            m, grads = step.gradient(state, b)
        torch.cuda.synchronize()
        grad_ms = (time.perf_counter() - t0) * 1e3
        torch.save({p: g.cpu() for p, g in zip(paths, grads) if g is not None},
                   f"{store}/grads_{s + 1}.pt")
        if s == 0:
            if routes:
                out.update(ids=routes[0].cpu(), kept=float(keeps[0].float().mean()),
                           margin=routing_margin(state.params, cfg, b["tokens"]))
        t0 = time.perf_counter()
        state, m = step.apply(state, m, grads)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        host_ms.append(grad_ms + (time.perf_counter() - t0) * 1e3)
        del grads
    counts = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_counts()
    serve = tuple(t.cpu() for t in _serve(cfg, state.params, _serve_prompt(cfg, seed).to(dev),
                                          SERVE_TOKENS))
    out.update(serve=serve, serve_counts=read_counts(),
               serve_ms=(time.perf_counter() - t0) * 1e3)
    torch.save({p: t.cpu() for p, t in zip(paths, (t for _, t in tree_items(state.params)))},
               f"{store}/params.pt")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for _, t in tree_items(state.params))
    del state, step
    torch.cuda.empty_cache()
    print(f"Path {name} one-rank run on the card: losses {losses}, grad norms {gnorms}, host ms "
          f"a step {[round(v, 2) for v in host_ms]}, peak {peak:.2f} GiB, launches {counts} "
          f"[{card_line()}]")
    return dict(out, losses=losses, gnorms=gnorms, counts=counts, host_ms=host_ms,
                peak_gib=peak, n_params=n_params)


def routing_margin(params, cfg, tokens):
    """The gap between each token's k-th and (k+1)-th selection logit in the
    first MoE layer's routing of ``tokens`` (a forward without a gradient,
    whose first routing is recorded), on the host."""
    import torch

    from repro_torch.models import lm, moe

    gaps, real = [], moe._routing

    def measuring(p, c, x2d):
        logits = x2d.float() @ p["router"].float()
        select = logits + p["router_bias"] if c.router_aux_free_bias else logits
        top = torch.topk(select, c.top_k + 1, dim=-1).values
        gaps.append((top[:, c.top_k - 1] - top[:, c.top_k]).cpu())
        return real(p, c, x2d)

    moe._routing = measuring
    try:
        with torch.no_grad():
            lm.forward(params, cfg, tokens[:, :-1])
    finally:
        moe._routing = real
    return gaps[0]


def _flat_pieces(*ts):
    """Flat ERR_CHUNK-element pieces of same-sized tensors, side by side."""
    return zip(*(t.reshape(-1).split(ERR_CHUNK) for t in ts))


def _reduced(mesh, specs, paths, rows, dev, summed=()):
    """Per-leaf rows reduced over the ranks by max, the ``summed`` columns
    by sum over distinct blocks (a replicated block counts once, not once
    a copy) -> {path: row}."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.blocks import spec_axes

    stats = torch.tensor(rows, dtype=torch.float64, device=dev)
    sums = stats[:, list(summed)].clone()
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    dist.all_reduce(sums)
    copies = [math.prod(mesh.axis_sizes) // math.prod(mesh.size(a) for a in spec_axes(s))
              for s in specs]
    stats[:, list(summed)] = sums / torch.tensor(copies, dtype=torch.float64,
                                                 device=dev)[:, None]
    return {p: tuple(float(v) for v in row) for p, row in zip(paths, stats.cpu())}


def _grad_errors(mesh, specs, paths, grads, store_file, dev, rho, agree):
    """Per leaf, over the mesh: (max |grad - baseline|, max |baseline|, max
    |baseline| where the two differ in sign) of this rank's gradient blocks
    against the one-rank run's (``store_file``, mapped, each rank reading
    its blocks, ERR_CHUNK elements at a time); ``agree[p]`` (this rank's
    flat block, on the host) keeps the weights whose gradient is within
    ``rho[p]`` of the baseline's, relatively (both 0 included)."""
    import torch

    from repro_torch.dist.blocks import shard_leaf

    base = torch.load(store_file, mmap=True, weights_only=True)
    rows = []
    for p, local, spec in zip(paths, grads, specs):
        row = [0.0, 0.0, 0.0]
        rows.append(row)
        if local is None and p not in base:  # no gradient on either side
            continue
        local = torch.zeros(agree[p].shape, device=dev) if local is None else local
        want = torch.zeros(local.shape) if p not in base else shard_leaf(base[p], spec, mesh)
        start = 0
        for w, v in _flat_pieces(want, local):
            w = w.to(dev)
            d = (w - v).abs_()
            row[0] = max(row[0], float(d.max()))
            row[1] = max(row[1], float(w.abs().max()))
            row[2] = max(row[2], float(torch.where(w.sign() != v.sign(), w.abs(), 0).max()))
            agree[p][start:start + w.numel()] &= (d <= rho[p] * w.abs()).cpu()
            start += w.numel()
        del want
    return _reduced(mesh, specs, paths, rows, dev)


def _param_errors(mesh, specs, paths, params, store_file, dev, agree):
    """Per leaf, over the mesh: (max |param - baseline| over the decided
    weights (``agree``), max |baseline|, max |param - baseline| over every
    weight, the count of undecided weights) of this rank's blocks against
    the one-rank run's parameters (``store_file``)."""
    import torch

    from repro_torch.dist.blocks import shard_leaf

    base = torch.load(store_file, mmap=True, weights_only=True)
    rows = []
    for p, local, spec in zip(paths, params, specs):
        want = shard_leaf(base[p], spec, mesh)
        row = [0.0, 0.0, 0.0, float((~agree[p]).sum())]
        rows.append(row)
        for w, v, ok in _flat_pieces(want, local, agree[p]):
            w = w.to(dev)
            d = (w - v).abs_()
            row[0] = max(row[0], float(d.masked_fill_(~ok.to(dev), 0.0).max()))
            row[1] = max(row[1], float(w.abs().max()))
            row[2] = max(row[2], float((w - v).abs_().max()))
        del want
    return _reduced(mesh, specs, paths, rows, dev, summed=(3,))


def _sharded_rank(name, cfg, seed, batch, seq, store):
    """One of Paths G4 / G5's four ranks: a data 2 x model 2 mesh
    (``make_host_mesh(2)``) under ``rules_for_arch``, the one-rank run's
    initial state cut to this rank's blocks, its data rows of the same
    global batches, SHARDED_STEPS steps; each step's gradient and the last
    parameters held block by block against the baseline in ``store``, the
    parameters over the weights whose gradients agree (see ADAM_RHO_SCALE)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.compat import rank_device
    from repro_torch.dist.sharding import activate_rules, rules_for_arch
    from repro_torch.launch import partition
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import steps as steps_mod
    from repro_torch.models.lm import tree_items
    from repro_torch.optim.adamw import schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    mesh = make_host_mesh(2)
    rules = rules_for_arch(cfg, mesh)
    opt = _sharded_opt()
    with activate_rules(rules, mesh):
        t0 = time.perf_counter()
        state = partition.init_sharded_train_state(
            torch.Generator(device=dev).manual_seed(seed), cfg, opt, mesh, rules, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.empty_cache()  # the global copy's blocks, for the other ranks
        paths = ["/".join(map(str, p)) for p, _ in tree_items(state.params)]
        specs = partition.leaf_specs(mesh, state.params, rules)
        batches = [partition.data_rows({k: v.to(dev) for k, v in b.items()}, mesh, rules)
                   for b in _sharded_batches(cfg, seed, batch, seq)]
        step = steps_mod.make_train_step(cfg, opt)
        # rho of each leaf (ADAM_RHO_SCALE), from its largest initial |w|
        lr_sum = sum(float(schedule(opt, torch.tensor(s + 1))) for s in range(SHARDED_STEPS))
        wmax = torch.stack([t.abs().max().float() for _, t in tree_items(state.params)])
        dist.all_reduce(wmax, op=dist.ReduceOp.MAX)
        rho = {p: TOL_CARD_CPU_GRAD * float(w) / (ADAM_RHO_SCALE * lr_sum)
               for p, w in zip(paths, wmax.cpu())}
        agree = {p: torch.ones(t.numel(), dtype=torch.bool) for p, (_, t) in
                 zip(paths, tree_items(state.params))}
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        dist.barrier()
        losses, gnorms, host_ms, coll_ms, out = [], [], [], [], {"grad_err": []}
        for s, b in enumerate(batches):
            with collective_timer() as coll:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with recorded_routing() as routes, recorded_keeps() as keeps:
                    m, grads = step.gradient(state, b)
                torch.cuda.synchronize()
                grad_ms = (time.perf_counter() - t0) * 1e3
            with collective_timer():  # kept out of the step's figures
                out["grad_err"].append(_grad_errors(mesh, specs, paths, grads,
                                                    f"{store}/grads_{s + 1}.pt", dev, rho,
                                                    agree))
                if s == 0 and routes:
                        out["ids"] = partition.gather_leaf(routes[0], ("data",), mesh).cpu()
                        out["kept"] = float(keeps[0].float().mean())
            with collective_timer() as coll2:
                t0 = time.perf_counter()
                state, m = step.apply(state, m, grads)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                host_ms.append(grad_ms + (time.perf_counter() - t0) * 1e3)
            coll_ms.append(coll["ms"] + coll2["ms"])
            del grads
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["param_err"] = _param_errors(mesh, specs, paths,
                                         [t for _, t in tree_items(state.params)],
                                         f"{store}/params.pt", dev, agree)
        local_params = sum(t.numel() for _, t in tree_items(state.params))
        # the trained parameters serve: this rank's prompt rows, its heads and vocabulary
        prompt = partition.data_rows({"tokens": _serve_prompt(cfg, seed).to(dev)}, mesh,
                                     rules)["tokens"]
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        zero_counts()
        served = _serve(cfg, state.params, prompt, SERVE_TOKENS)
        torch.cuda.synchronize()
        out.update(serve_counts=read_counts(), serve_ms=(time.perf_counter() - t0) * 1e3)
        served = [partition.gather_leaf(t, ("data",), mesh) for t in served]
        out["serve"] = tuple(t.cpu() for t in served) if dist.get_rank() == 0 else None
    del state, step, batches
    torch.cuda.empty_cache()
    return dict(out, losses=losses, gnorms=gnorms, host_ms=host_ms, coll_ms=coll_ms,
                counts=counts,
                peak_gib=peak, init_s=init_s, local_params=local_params,
                rules={k: v for k, v in rules.items() if v is not None},
                coords=dict(zip(mesh.axis_names, mesh.coords)))


def path_sharded(name, cfg, dev, seed, batch=4, seq=512):
    """Paths G4 / G5: ``cfg`` trained SHARDED_STEPS steps on one rank of the
    card, then on a data 2 x model 2 mesh of four gloo ranks sharing it
    (``spawn_fake_devices(4, ..., device="cuda:0")``: NCCL refuses two ranks
    on one GPU), both from ``seed`` on the same global batches of batch x seq
    positions, float32 with cuBLAS TF32 off.  Gates: each step's loss within
    TOL_CARD_CPU of the one-rank run's, and so each step's gradient norm
    (the clip's global norm); step 1's gradient, leaf by leaf over every
    rank's blocks, within TOL_CARD_CPU_GRAD of the leaf's largest; the last
    parameters within TOL_CARD_CPU_GRAD over the weights whose gradients
    agreed at every step (ADAM_RHO_SCALE; the rest counted, held by the
    gradient check); the mma.sync
    flash kernel launched in every rank, 2 a layer a step (the remat); an
    MoE config's first routing equal to the one-rank run's on every token
    decided by more than ROUTING_MARGIN, and some choices dropped.  A rank
    path (:func:`run_on_ranks`): the baseline stays on the host's disk until
    the ranks have read it."""
    import shutil

    import torch

    print(f"Path {name}: before the baseline this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({torch.cuda.memory_reserved() / 2**30:.2f}"
          f" GiB reserved) of the card; {shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.0f} "
          f"GB free under {tempfile.gettempdir()}")
    store = tempfile.mkdtemp(prefix=f"sharded_{name}_")
    try:
        t0 = time.perf_counter()
        base = sharded_baseline(name, cfg, dev, seed, batch, seq, store)
        base_s = time.perf_counter() - t0
        ranks, ranks_s = yield _sharded_rank, (name, cfg, seed, batch, seq, store)
        disk_gb = sum(f.stat().st_size for f in Path(store).iterdir()) / 1e9
    finally:
        shutil.rmtree(store, ignore_errors=True)
    card = card_line()
    r0 = ranks[0]
    rel = lambda e, scale: e / max(scale, 1e-30)
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], base["losses"])]
    norm_errs = [abs(a - b) / abs(b) for a, b in zip(r0["gnorms"], base["gnorms"])]
    grad_worst = sorted(((rel(e[0], e[1]), p) for p, e in r0["grad_err"][0].items()),
                        reverse=True)
    flip = max((rel(e[2], e[1]), p) for p, e in r0["grad_err"][0].items())
    later = [max((rel(e[0], e[1]), p) for p, e in g.items()) for g in r0["grad_err"][1:]]
    param_worst = max((rel(e[0], e[1]), p) for p, e in r0["param_err"].items())
    param_all = max((rel(e[2], e[1]), p) for p, e in r0["param_err"].items())
    n_undecided = int(sum(e[3] for e in r0["param_err"].values()))
    mma = [r["counts"]["flash_attention_mma"] for r in ranks]
    print(f"Path {name}: {cfg.name}, {cfg.n_layers} layers {cfg.layer_kinds()}, float32, "
          f"{batch} x {seq} positions, {SHARDED_STEPS} steps; mesh data 2 x model 2 of four gloo "
          f"ranks on one card, rules {r0['rules']}; {r0['local_params'] / 1e9:.3f} B parameters "
          f"on rank 0 [{card}]")
    for i, r in enumerate(ranks):
        print(f"Path {name} rank {i} {r['coords']}: init {r['init_s']:.2f} s, host ms a step "
              f"{[round(v, 2) for v in r['host_ms']]} of which in gloo collectives (staged "
              f"through the host) {[round(v, 2) for v in r['coll_ms']]}, peak memory "
              f"{r['peak_gib']:.2f} GiB, launches {r['counts']} [{card}]")
    print(f"Path {name} losses sharded {r0['losses']} vs one rank {base['losses']}: relative "
          f"{[f'{e:.3e}' for e in loss_errs]}, gradient norms {r0['gnorms']} vs "
          f"{base['gnorms']}: relative {[f'{e:.3e}' for e in norm_errs]} (tol "
          f"{TOL_CARD_CPU:.0e}); step-1 gradient over {len(grad_worst)} leaves, worst of its "
          f"leaf's largest {[(p, f'{e:.3e}') for e, p in grad_worst[:3]]} (tol "
          f"{TOL_CARD_CPU_GRAD:.0e}), its signs differing up to {flip[0]:.3e} of the leaf's "
          f"largest ({flip[1]}); later steps' gradients (after the first update) worst "
          f"{[(p, f'{e:.3e}') for e, p in later]}, not gated")
    print(f"Path {name} parameters after step {SHARDED_STEPS}: over the weights whose gradient "
          f"agreed at every step within rho (ADAM_RHO_SCALE {ADAM_RHO_SCALE}) worst "
          f"({param_worst[1]}, {param_worst[0]:.3e}) of the leaf's largest (tol "
          f"{TOL_CARD_CPU_GRAD:.0e}); the other {n_undecided} of {base['n_params']} weights "
          f"({n_undecided / base['n_params']:.4%}) are held by the gradient check alone, worst "
          f"over every weight ({param_all[1]}, {param_all[0]:.3e})")
    print(f"Path {name} one-rank host ms a step {[round(v, 2) for v in base['host_ms']]}, peak "
          f"{base['peak_gib']:.2f} GiB; baseline {base_s:.1f} s, ranks {ranks_s:.1f} s, "
          f"{disk_gb:.1f} GB of baseline on the host's disk [{card}]")
    if "ids" in base:
        ids, want = r0["ids"], base["ids"]
        differ = (ids.sort(dim=-1).values != want.sort(dim=-1).values).any(dim=-1)
        decided = base["margin"] > ROUTING_MARGIN
        print(f"Path {name} first routing: {int(differ.sum())} of {ids.shape[0]} tokens with "
              f"other expert ids than the one-rank run's ({int((differ & decided).sum())} of "
              f"the {int(decided.sum())} decided by more than {ROUTING_MARGIN:.0e}); kept share "
              f"sharded {r0['kept']:.4f}, one rank {base['kept']:.4f}")
        if bool((differ & decided).any()):
            fail(f"Path {name}: the sharded routing differs on decided tokens")
        if not base["kept"] < 1.0 or not r0["kept"] < 1.0:
            fail(f"Path {name}: no choice dropped at this batch; the capacity is not exercised")
    if not all(e <= TOL_CARD_CPU for e in loss_errs):
        fail(f"Path {name}: a sharded loss disagrees with the one-rank run's: {loss_errs}")
    if not all(e <= TOL_CARD_CPU for e in norm_errs):
        fail(f"Path {name}: a sharded gradient norm disagrees with the one-rank run's: "
             f"{norm_errs}")
    if not grad_worst[0][0] <= TOL_CARD_CPU_GRAD:
        fail(f"Path {name}: gradient {grad_worst[0][1]} disagrees: {grad_worst[0][0]}")
    if not param_worst[0] <= TOL_CARD_CPU_GRAD:
        fail(f"Path {name}: parameters disagree over the decided weights: {param_worst}")
    want_counts = dict.fromkeys(r0["counts"], 0)
    want_counts.update(flash_attention_mma=2 * cfg.n_layers * SHARDED_STEPS)
    if any(r["counts"] != want_counts for r in ranks):
        fail(f"Path {name} launch counts by rank {[r['counts'] for r in ranks]}; expected "
             f"{want_counts} in every rank")
    # the trained parameters' prefill and greedy decode, sharded against one rank
    (pre, seen, toks), (bpre, bseen, btoks) = r0["serve"], base["serve"]
    pre_err = rel(float((pre - bpre).abs().max()), float(bpre.abs().max()))
    seen_err = rel(float((seen - bseen).abs().max()), float(bseen.abs().max()))
    print(f"Path {name} serving the trained parameters: prefill {pre.shape[0]} x "
          f"{SERVE_PROMPT} tokens, then {SERVE_FED} of them decoded and {SERVE_TOKENS} greedy "
          f"tokens; "
          f"sharded vs one rank: prefill logits {pre_err:.3e}, decode logits {seen_err:.3e} of "
          f"the largest (tol {TOL_CARD_CPU:.0e}), greedy tokens equal "
          f"{bool(torch.equal(toks, btoks))}; host ms sharded "
          f"{[round(r['serve_ms'], 1) for r in ranks]}, one rank {base['serve_ms']:.1f}; "
          f"launches by rank {[r['serve_counts'] for r in ranks]}, one rank "
          f"{base['serve_counts']} [{card}]")
    if not (pre_err <= TOL_CARD_CPU and seen_err <= TOL_CARD_CPU):
        fail(f"Path {name}: sharded serving logits disagree with one rank's: prefill "
             f"{pre_err}, decode {seen_err}")
    if not torch.equal(toks, btoks):
        fail(f"Path {name}: sharded greedy tokens {toks.tolist()} differ from one rank's "
             f"{btoks.tolist()}")
    want_serve = dict.fromkeys(r0["counts"], 0)
    want_serve.update(flash_attention_mma=cfg.n_layers)  # the float32 prefill, once a layer
    if any(r["serve_counts"] != want_serve for r in ranks):
        fail(f"Path {name} serving launch counts {[r['serve_counts'] for r in ranks]}; "
             f"expected {want_serve} in every rank")
    counts = {k: sum(r["counts"][k] + r["serve_counts"][k] for r in ranks) for k in r0["counts"]}
    print(f"Path {name}: flash_attention_mma launched {mma} times by rank")
    return dict(counts=counts, loss_errs=loss_errs, norm_errs=norm_errs,
                grad_worst=grad_worst[0], sign_flip=flip, later_grads=later,
                param_worst=param_worst, undecided=n_undecided, ranks_s=ranks_s,
                base_s=base_s, host_ms=[r["host_ms"] for r in ranks],
                coll_ms=[r["coll_ms"] for r in ranks], peak_gib=[r["peak_gib"] for r in ranks])


# -- Paths G6, G7: sharded serving of whisper-large-v3 and deepseek-v3 -------------
WHISPER_FRAMES = 1500  # the encoder's 30 s window after the stubbed conv front end


def _serve_inputs(cfg, seed) -> dict:
    """Paths G6 / G7's inputs, drawn on the host from ``seed``: 4 x
    SERVE_PROMPT tokens and, for an encoder-decoder, 4 x WHISPER_FRAMES
    frames, N(0, 0.02^2)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (4, SERVE_PROMPT), generator=gen)}
    if cfg.is_encdec:
        out["frames"] = torch.randn(4, WHISPER_FRAMES, cfg.d_model, generator=gen) * 0.02
    return out


def _serve_variants(cfgs, params, inputs) -> list:
    """:func:`_serve` of ``inputs`` under each config of ``cfgs`` (the same
    parameters; the prefill under the first alone)."""
    return [_serve(c, params, inputs["tokens"], SERVE_TOKENS, inputs.get("frames"),
                   prefill=i == 0) for i, c in enumerate(cfgs)]


def _serve_rank(cfgs, seed):
    """One of Paths G6 / G7's four ranks: a data 2 x model 2 mesh
    (``make_host_mesh(2)``) under ``rules_for_arch``; the one-rank run's
    parameters drawn from ``seed`` on the card, one rank at a time, and cut
    to this rank's blocks; its data rows of the inputs; :func:`_serve_variants`
    with its host ms, its ms in gloo collectives, its launches and its peak
    memory; the results gathered over the data ranks on rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.compat import rank_device
    from repro_torch.dist.sharding import activate_rules, rules_for_arch
    from repro_torch.launch import partition
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import init_params, tree_items

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    mesh = make_host_mesh(2)
    cfg = cfgs[0]
    rules = rules_for_arch(cfg, mesh)
    with activate_rules(rules, mesh):
        t0 = time.perf_counter()
        for r in range(dist.get_world_size()):  # one global copy on the card at a time
            if dist.get_rank() == r:
                params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                     device=dev)
                params = partition.shard_tree(
                    params, partition.param_shardings(mesh, params, rules), mesh)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        init_s = time.perf_counter() - t0
        inputs = partition.data_rows({k: v.to(dev) for k, v in _serve_inputs(cfg, seed).items()},
                                     mesh, rules)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        dist.barrier()
        with collective_timer() as coll:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = _serve_variants(cfgs, params, inputs)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = LAST_SERVE["step_ms"]
        gathered = [tuple(None if t is None else partition.gather_leaf(t, ("data",), mesh).cpu()
                          for t in o) for o in outs]
        local_params = sum(t.numel() for _, t in tree_items(params))
    del params, outs
    torch.cuda.empty_cache()
    return dict(serve=gathered if dist.get_rank() == 0 else None, host_ms=host_ms,
                coll_ms=coll["ms"], coll_calls=coll["calls"], counts=counts, peak_gib=peak,
                init_s=init_s, step_ms=step_ms, local_params=local_params,
                rules={k: v for k, v in rules.items() if v is not None},
                coords=dict(zip(mesh.axis_names, mesh.coords)))


def _serve_launches(cfg, variants: int) -> dict:
    """The launches of :func:`_serve_variants` in every rank: float32
    attention without a sliding window runs the mma.sync kernel, once a
    layer in a prefill (an encoder-decoder's encoder, decoder and cross
    layers), once an encoder layer in the decode state's ``encoder_forward``,
    once a cross layer a decode step (Sq = 1); once an invocation of
    zamba2's shared block in a prefill (its decode attends in plain code);
    MLA and xLSTM none (plain code)."""
    from repro_torch.models.lm import shared_invocations

    want = dict.fromkeys(_wrappers(), 0)
    if cfg.block_type == "mamba2":
        want["flash_attention_mma"] = shared_invocations(cfg)
    elif cfg.attn_type != "mla" and cfg.block_type != "xlstm":
        steps = variants * (SERVE_FED + SERVE_TOKENS - 1)
        n = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers if cfg.is_encdec else 0)
        if cfg.is_encdec:
            n += variants * cfg.n_enc_layers + steps * cfg.n_layers
        want["flash_attention_mma"] = n
    return want


def path_sharded_serve(name, cfgs, dev, seed):
    """Paths G6 / G7: ``cfgs[0]`` (the others the same model under another
    decode setting) from ``seed`` served on one rank of the card, then on a
    data 2 x model 2 mesh of four gloo ranks sharing it
    (``spawn_fake_devices(4, ..., device="cuda:0")``), float32 with cuBLAS
    TF32 off: a prefill of 4 x SERVE_PROMPT tokens, SERVE_FED of them fed
    through the decode step and SERVE_TOKENS greedy tokens under each
    config. Gates: every prefill's and every greedy token's logits within
    TOL_CARD_CPU of the one-rank run's largest, the tokens equal, and the
    launches of :func:`_serve_launches` on one rank and in every rank.  A
    rank path (:func:`run_on_ranks`)."""
    import torch

    from repro_torch.models.lm import init_params, tree_items

    cfg = cfgs[0]
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    n_params = sum(t.numel() for _, t in tree_items(params))
    shapes = {k: tuple(v.shape) for k, v in _serve_inputs(cfg, seed).items()}
    inputs = {k: v.to(dev) for k, v in _serve_inputs(cfg, seed).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.perf_counter()
    base = [tuple(None if t is None else t.cpu() for t in o)
            for o in _serve_variants(cfgs, params, inputs)]
    base_ms = (time.perf_counter() - t1) * 1e3
    base_counts, base_peak, base_step = read_counts(), torch.cuda.max_memory_allocated() / 2**30, \
        LAST_SERVE["step_ms"]
    del params, inputs
    torch.cuda.empty_cache()
    base_s = time.perf_counter() - t0
    ranks, ranks_s = yield _serve_rank, (cfgs, seed)
    card = card_line()
    r0 = ranks[0]
    shape = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers" if cfg.is_encdec
             else f"{cfg.n_layers} layers {cfg.layer_kinds()}"
             + (f", {cfg.n_experts} experts" if cfg.block_type == "transformer" else ""))
    print(f"Path {name}: {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads), "
          f"{shape}, {n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.2f} GB in float32), "
          f"{r0['local_params'] / 1e9:.3f} B on rank 0; inputs {shapes}; mesh data 2 x model 2 "
          f"of four gloo ranks on one card, rules {r0['rules']} [{card}]")
    for i, r in enumerate(ranks):
        print(f"Path {name} rank {i} {r['coords']}: init {r['init_s']:.2f} s, host ms "
              f"{r['host_ms']:.1f} (decode {r['step_ms']:.1f} a step) of which in gloo "
              f"collectives (staged through the host) {r['coll_ms']:.1f} over "
              f"{r['coll_calls']} calls, peak memory {r['peak_gib']:.2f} GiB, launches "
              f"{r['counts']} [{card}]")
    print(f"Path {name} one rank: host ms {base_ms:.1f} (decode {base_step:.1f} a step), peak "
          f"{base_peak:.2f} GiB, launches {base_counts}; baseline {base_s:.1f} s, ranks "
          f"{ranks_s:.1f} s [{card}]")
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    errs = []
    for c, got, want in zip(cfgs, r0["serve"], base):
        pre = None if want[0] is None else rel(got[0], want[0])
        seen = rel(got[1], want[1])
        equal = bool(torch.equal(got[2], want[2]))
        tag = f"mla_absorbed={c.mla_absorbed}" if c.attn_type == "mla" else "decode"
        print(f"Path {name} [{tag}] sharded vs one rank: prefill logits "
              f"{'-' if pre is None else f'{pre:.3e}'}, greedy tokens' logits {seen:.3e} of the "
              f"largest (tol {TOL_CARD_CPU:.0e}), tokens equal {equal} {got[2].tolist()}")
        errs.append((pre, seen, equal))
        if not all(bool(torch.isfinite(t).all()) for t in got[:2] if t is not None):
            fail(f"Path {name} [{tag}]: non-finite logits")
        if not ((pre is None or pre <= TOL_CARD_CPU) and seen <= TOL_CARD_CPU):
            fail(f"Path {name} [{tag}]: sharded logits disagree with one rank's: prefill {pre}, "
                 f"decode {seen}")
        if not equal:
            fail(f"Path {name} [{tag}]: sharded greedy tokens {got[2].tolist()} differ from one "
                 f"rank's {want[2].tolist()}")
    want = _serve_launches(cfg, len(cfgs))
    if base_counts != want or any(r["counts"] != want for r in ranks):
        fail(f"Path {name} launch counts: one rank {base_counts}, by rank "
             f"{[r['counts'] for r in ranks]}; expected {want} on each")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in want}
    return dict(counts=counts, errs=errs, base_s=base_s, ranks_s=ranks_s,
                host_ms=[r["host_ms"] for r in ranks], coll_ms=[r["coll_ms"] for r in ranks],
                peak_gib=[r["peak_gib"] for r in ranks], n_params=n_params)


def sharded_paths(dev) -> tuple:
    """Paths G4 (minitron-4b) and G5 (moonshot-v1-16b-a3b: its dense first
    layer and one MoE layer), each at full width cut to 2 layers; then G6
    (whisper-large-v3 cut to 2 encoder and 2 decoder layers) and G7
    (deepseek-v3-671b cut to one dense and one MoE layer of 16 of its 256
    routed experts, decoding naive and absorbed); then G8 (zamba2-1.2b cut
    to 7 layers: the shared block twice) and G9 (xlstm-350m cut to 8: 7
    mLSTM, 1 sLSTM), float32; their one-rank runs first, then their rank
    tasks on one start of the four ranks.  A path's time is its one-rank
    run's and its task's on rank 0."""
    import dataclasses

    ds = lm_config("deepseek-v3-671b", n_layers=2, first_k_dense=1, n_experts=16,
                   dtype="float32")
    g4, g5, g6, g7, g8, g9 = run_on_ranks(dev, [
        path_sharded("G4", lm_config("minitron-4b", n_layers=2, dtype="float32"), dev, 16),
        path_sharded("G5", lm_config("moonshot-v1-16b-a3b", n_layers=2, dtype="float32"), dev,
                     17),
        path_sharded_serve("G6", [lm_config("whisper-large-v3", n_layers=2, n_enc_layers=2,
                                            dtype="float32")], dev, 18),
        path_sharded_serve("G7", [dataclasses.replace(ds, mla_absorbed=a)
                                  for a in (False, True)], dev, 19),
        path_sharded_serve("G8", [lm_config("zamba2-1.2b", n_layers=7, dtype="float32")], dev,
                           20),
        path_sharded_serve("G9", [lm_config("xlstm-350m", n_layers=8, dtype="float32")], dev,
                           21)], "G4-G9")
    took = lambda *gs: sum(g["base_s"] + g["ranks_s"] for g in gs)
    print(f"Paths G4-G5 took {took(g4, g5):.1f} s")
    print(f"Paths G6-G7 took {took(g6, g7):.1f} s")
    print(f"Paths G8-G9 took {took(g8, g9):.1f} s")
    return g4, g5, g6, g7, g8, g9


# -- Path DR: the dry run (repro_torch.launch.dryrun / cs_dryrun) held against the card --
DR_WALKS = ("cs_fp32", "cs_bf16", "train", "prefill", "decode")
DR_GATED = ("launches", "kernel_launches", "flops", "bytes", "collective_bytes")
DR_CS_ITERS, DR_BATCH, DR_SEQ = 2, 2, 512


def _dr_lm():
    """Path DR's model: minitron-4b FULL cut to 2 layers (bf16 compute)."""
    return lm_config("minitron-4b", n_layers=2)


def dr_meta(knobs: dict) -> dict:
    """Path DR's ``meta`` side, in a subprocess of its own: D1's CS block
    (the card's plan knobs ``knobs[wire]``) and minitron-4b's train step,
    prefill and decode step, each walked by the dry run's walkers
    (``cs_dryrun.walk_variant``, ``dryrun.walk_step``) after one warm call,
    on rank 0 of a fake world of one; the mesh of one rank is the card's."""
    import torch

    from repro_torch.dist.compat import init_dry_run, make_mesh
    from repro_torch.launch import cs_dryrun, dryrun, specs
    from repro_torch.models import steps

    init_dry_run(1)
    out = {}
    for wire, k in knobs.items():
        cost, arg = cs_dryrun.walk_variant(make_mesh((1,), ("model",)), k["n1"], k["n2"],
                                           k["batch"], DR_CS_ITERS, k["fused"], k["rfft"],
                                           k["overlap"], k["wire_dtype"])
        out[f"cs_{wire}"] = dict(dryrun.walk_numbers(cost), peak=cost.peak_bytes, argument=arg)
    cfg = _dr_lm()
    mesh = make_mesh((1, 1), ("data", "model"))
    tokens = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    cases = {
        "train": (steps.make_train_step(cfg, specs.opt_config()),
                  (specs.train_state_specs(cfg), {"tokens": tokens(DR_BATCH, DR_SEQ + 1)})),
        "prefill": (steps.make_prefill_step(cfg),
                    (specs.params_specs(cfg), {"tokens": tokens(DR_BATCH, DR_SEQ)})),
        "decode": (steps.make_decode_step(cfg),
                   (specs.params_specs(cfg), tokens(DR_BATCH, 1),
                    specs.decode_state_specs(cfg, DR_BATCH, DR_SEQ))),
    }
    for kind, (fn, args) in cases.items():
        rec = dryrun.walk_step(cfg, kind, fn, args, mesh, warm=True)
        if not rec["ok"]:
            raise RuntimeError(f"Path DR meta {kind}: {rec['error']}")
        out[kind] = dict(rec["walk"], peak=rec["memory"]["temp"],
                         argument=rec["memory"]["argument"], static_bounds=rec["static_bounds"])
    return out


def g10_walks(archs=None) -> dict:
    """The operations of each Path G10 train step, for its bound: the step
    walked on ``meta`` by the dry run's walker (``dryrun.walk_step``, cold,
    as :func:`dr_meta` walks minitron's, which Path DR holds to the card's)
    at G10's config, batch and shapes, on rank 0 of a fake world of one.
    xlstm-350m's sLSTM loops over the positions in Python, so its walk at S
    = 2048 takes minutes: it is walked at S = 256 and 512 and extrapolated
    linearly to 2048.  Its operations are affine in S: the products of every
    position (the sLSTM's loop, the projections, the head) and of each
    256-position mLSTM chunk, less one chunk's state update in the backward
    (the last chunk's carried state reaches no output).
    ``archs``: those of G10_CASES alone.  -> {arch: {"flops", "walked_at",
    "walk_s"}}."""
    import torch

    from repro_torch.dist.compat import init_dry_run, make_mesh
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import steps

    init_dry_run(1)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch, cut, batch in G10_CASES:
        if archs and arch not in archs:
            continue
        cfg = lm_config(arch, **cut)

        def walk(seq):
            b = {k: torch.empty(shape, dtype=torch.int32 if k == "tokens" else torch.float32,
                                device="meta") for k, shape in g10_shapes(cfg, batch, seq).items()}
            rec = dryrun.walk_step(cfg, "train", steps.make_train_step(cfg, specs.opt_config()),
                                   (specs.train_state_specs(cfg), b), mesh)
            if not rec["ok"]:
                raise RuntimeError(f"Path G10 meta walk of {arch} at S = {seq}: {rec['error']}")
            return rec["walk"]["flops"]

        t0 = time.perf_counter()
        if cfg.block_type == "xlstm":
            (s0, f0), (s1, f1) = ((s, walk(s)) for s in XLSTM_WALK_SEQ)
            flops, walked = f0 + (G10_SEQ - s0) * (f1 - f0) / (s1 - s0), list(XLSTM_WALK_SEQ)
        else:
            flops, walked = walk(G10_SEQ), [G10_SEQ]
        out[arch] = dict(flops=flops, walked_at=walked, walk_s=time.perf_counter() - t0)
    return out


def _dr_knob(pl) -> dict:
    """What the meta walk of Path DR's CPADMM block needs of plan ``pl``."""
    return dict(n1=pl.n1, n2=pl.n2, rfft=pl.rfft, overlap=pl.overlap, fused=pl.fused,
                wire_dtype=pl.wire_dtype, batch=4)


def dr_knobs(dev) -> dict:
    """The knobs of Path DR's two CPADMM blocks: D1's problem (4 x 1024^2
    frames) planned on the one-rank NCCL mesh with fp32 and bf16 wires."""
    from repro_torch.core.deblur import build_deblur_plan
    from repro_torch.dist.compat import make_mesh

    _, p = sec7_problem(dev, 1, 1024, 4)
    mesh = make_mesh((1,), ("model",), device=dev)
    knobs = {}
    for wire in ("fp32", "bf16"):
        pl = build_deblur_plan(p, mesh, rfft=True, tail="kernel", wire_dtype=wire)
        knobs[wire] = _dr_knob(pl)
    return knobs


def dr_meta_chain(knobs: dict) -> dict:
    """Path DR's meta walks (:func:`dr_meta`) as a chain of the process
    batch: they need no card, only the knobs."""
    return {"DR meta": [dict(argv=[str(Path(__file__).resolve()), "--dr-meta",
                                   json.dumps(knobs)], env={})]}


def g10_meta_chains() -> dict:
    """Path G10's meta walks (:func:`g10_walks`) as two chains of the process
    batch, beside DR's (they need no card): xlstm-350m's two walks (~45 s
    alone on the CPU) and the other four."""
    script = str(Path(__file__).resolve())
    rest = ",".join(a for a, _, _ in G10_CASES if a != "xlstm-350m")
    return {name: [dict(argv=[script, "--g10-meta", archs], env={})]
            for name, archs in (("G10 meta xlstm-350m", "xlstm-350m"), ("G10 meta", rest))}


def g10_meta_results(procs: dict) -> dict:
    """{arch: walk} from the output of :func:`g10_meta_chains`' commands."""
    out = {}
    for name in g10_meta_chains():
        out.update(json.loads(procs[name][0].strip().splitlines()[-1]))
    return out


def path_dr(dev, meta_run=None) -> dict:
    """Path DR: the dry run held against the card.  In this process, on real
    CUDA tensors with the kernels launching, ``cost_walk.walk`` after one
    warm call of each: D1's problem (4 x 1024^2 frames, the one-rank NCCL
    mesh) through 2 iterations of ``cpadmm_block`` at fp32 and bf16 wires
    (cpadmm_tail, pack_wire, unpack_wire), and minitron-4b FULL cut to 2
    layers: one train step at 2 x 512 tokens (flash_attention_sm90, and
    FlashAttentionFn's plain recompute in the backward), one prefill of 2 x
    512 and one decode step against a 512-deep cache.  Then the same five on
    ``meta`` by the dry run's walkers in a subprocess (:func:`dr_meta`), or
    ``meta_run``: (the knobs it walked, its output, its seconds), run in the
    process batch; its knobs must be this run's.
    Gate: launches, kernel launches, flops, bytes and collective bytes equal,
    walk for walk; the card's decode also runs ``lm._cache_room``'s host
    check, which a dry run skips (a static bound), so its decode is held
    less that check's own walk.  Printed, not gated: the card's peak memory
    beside the walk's argument plus peak live bytes."""
    import torch

    from repro_torch.core.deblur import build_deblur_plan
    from repro_torch.dist.compat import make_mesh
    from repro_torch.launch.cost_walk import walk
    from repro_torch.launch.dryrun import tree_bytes, walk_numbers
    from repro_torch.launch.specs import opt_config
    from repro_torch.models import lm, steps
    from repro_torch.ops import tune

    t0 = time.perf_counter()
    card, knobs = {}, {}
    zero_counts()

    def walked(name, fn, *args):
        fn(*args)  # the warm call: twiddles, the Triton JIT, the cast of the weights
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cost = walk(fn, *args)
        torch.cuda.synchronize()
        card[name] = dict(walk_numbers(cost), peak=cost.peak_bytes, argument=tree_bytes(args),
                          card_peak=torch.cuda.max_memory_allocated() - base)
        return cost

    prob, p = sec7_problem(dev, 1, 1024, 4)
    mesh = make_mesh((1,), ("model",), device=dev)
    for wire in ("fp32", "bf16"):
        pl = build_deblur_plan(p, mesh, rfft=True, tail="kernel", wire_dtype=wire)
        walked(f"cs_{wire}", pl.cpadmm_block(DR_CS_ITERS), *tune._block_operands(pl, 4))
        knobs[wire] = _dr_knob(pl)
    del prob, p
    cfg = _dr_lm()
    gen = torch.Generator(device=dev).manual_seed(20)
    state = steps.init_train_state(gen, cfg, opt_config(), device=dev)
    tokens = torch.randint(0, cfg.vocab, (DR_BATCH, DR_SEQ + 1), generator=gen, device=dev,
                           dtype=torch.int32)
    walked("train", steps.make_train_step(cfg, opt_config()), state, {"tokens": tokens})
    prompt = {"tokens": tokens[:, :DR_SEQ].contiguous()}
    walked("prefill", steps.make_prefill_step(cfg), state.params, prompt)
    cache = lm.init_decode_state(cfg, DR_BATCH, DR_SEQ, device=dev)
    walked("decode", steps.make_decode_step(cfg), state.params, tokens[:, :1].contiguous(),
           cache)
    room = walk(lm._cache_room, cfg, cache)
    counts = read_counts()
    card_s = time.perf_counter() - t0
    del state, cache
    torch.cuda.empty_cache()

    if meta_run is None:
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dr-meta",
                               json.dumps(knobs)], capture_output=True, text=True, timeout=300,
                              cwd=str(ROOT))
        if proc.returncode != 0:
            fail(f"Path DR: the meta walks failed:\n{proc.stderr[-3000:]}")
        meta_run = (knobs, proc.stdout, time.perf_counter() - t1)
    meta_knobs, meta_out, meta_s = meta_run
    if meta_knobs != knobs:
        fail(f"Path DR: the meta walks ran the knobs {meta_knobs}, the card's are {knobs}")
    meta = json.loads(meta_out.strip().splitlines()[-1])
    for key in ("launches", "flops", "bytes"):  # the card's decode less its host room check
        card["decode"][key] -= getattr(room, key)
    bad = []
    for name in DR_WALKS:
        c, m = card[name], meta[name]
        diff = {k: (c[k], m[k]) for k in DR_GATED if c[k] != m[k]}
        print(f"Path DR {name}: card walk launches {c['launches']}, kernels {c['kernel_launches']},"
              f" {c['flops']:.6e} FLOP, {c['bytes']:.6e} B, collectives {c['collective_bytes']}; "
              f"meta walk {'equal' if not diff else diff}; card peak {c['card_peak'] / 2**30:.3f} "
              f"GiB beside the walk's argument {c['argument'] / 2**30:.3f} + peak live "
              f"{c['peak'] / 2**30:.3f} GiB (meta: {m['argument'] / 2**30:.3f} + "
              f"{m['peak'] / 2**30:.3f} GiB)")
        if diff:
            bad.append((name, diff))
    print(f"Path DR: the card's decode less lm._cache_room's walk ({room.launches} launches, "
          f"{room.bytes:.0f} B, the host check a dry run skips: "
          f"{meta['decode']['static_bounds']}); launches {counts}; card walks {card_s:.1f} s, "
          f"meta walks {meta_s:.1f} s (a subprocess) [{card_line()}]")
    if bad:
        fail(f"Path DR: the meta walks differ from the card's: {bad}")
    for name in ("cpadmm_tail", "pack_wire", "unpack_wire", "flash_attention_sm90"):
        if not counts[name]:
            fail(f"Path DR: {name} never launched on the card")
    return dict(counts=counts, card=card, meta=meta, seconds=card_s + meta_s)


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
    "flash_attention_mma": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
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
    "flash_attention_mma": "F.scaled_dot_product_attention(is_causal, enable_gqa=True) on "
                           "(B, H, S, D) views",
}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dr-meta"]:  # Path DR's meta walks: no card needed
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(dr_meta(json.loads(sys.argv[2]))))
        return 0
    if sys.argv[1:2] == ["--g10-meta"]:  # Path G10's meta walks: no card needed
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(g10_walks(sys.argv[2].split(",") if len(sys.argv) > 2 else None)))
        return 0
    if sys.argv[1:2] == ["--flash-times"]:
        flash_times(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)
        return 0
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

    if sys.argv[1:2] == ["--sharded"]:
        sharded_paths(dev)
        return 0
    if sys.argv[1:2] == ["--dr"]:
        path_dr(dev)
        return 0
    if sys.argv[1:2] == ["--train"]:  # Paths E9 + G11 and G10 alone
        t0 = time.perf_counter()
        procs, _ = run_chains(g10_meta_chains())
        print(f"Path G10 meta walks: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        path_e9(dev, 13)
        print(f"phase E9-G11: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        path_g10(dev, 16, g10_meta_results(procs))
        print(f"phase G10: {time.perf_counter() - t0:.1f} s")
        return 0
    laps, lap_t = {}, [time.perf_counter()]

    def lap(name):  # host seconds of each phase, printed as it ends and all at the end
        now = time.perf_counter()
        laps[name] = round(now - lap_t[0], 1)
        lap_t[0] = now
        print(f"phase {name}: {laps[name]} s (at {now - t_start:.1f} s)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    launch_floors(dev)
    checks = check_kernels(dev, gen)
    lap("kernels")
    a = path_a(dev, 1)
    lap("A")
    below = below_crossover()
    b = path_b(dev, torch.Generator().manual_seed(2))
    b_below = path_b(dev, torch.Generator().manual_seed(2), n=below, name=f"B{below}")
    lap("B")
    c = path_c(dev, torch.Generator().manual_seed(3))
    c_below = path_c(dev, torch.Generator().manual_seed(3), n=below, name=f"C{below}")
    lap("C")
    f = path_f(dev, b)
    lap("F")
    d1 = path_d1(dev, 1, a["kernel"]["x"])
    lap("D1")
    t = path_t(dev, 1, a["kernel"]["x"], d1)
    lap("T")
    m = path_m(dev, 6)
    lap("M")
    md1 = path_md1(dev, m.pop("problem"))
    lap("MD1")
    d2, t_d2, h = run_on_ranks(dev, [path_d2(dev, 1), path_t_d2(dev, 1), path_h(dev, 1)],
                               "D2, T-D2, H")
    lap("D2, T-D2, H")
    s = path_s(dev)
    lap("S")
    s_below = path_s(dev, n=below, method="ista", name=f"S{below}")
    lap(f"S{below}")
    sd1 = path_s_d1(dev)
    lap("S-D1")
    cli = cli_phase()
    cli_priors = cli_priors_phase()
    lap("CLI")
    knobs = dr_knobs(dev)
    procs, walls = process_phase({**g10_meta_chains(), **dr_meta_chain(knobs)})
    lap("processes")
    e1 = path_e1(dev, 4)
    e2 = path_e2(e1)
    e4 = path_e4(e1)
    del e1["params"], e1["prefill"]
    torch.cuda.empty_cache()
    lap("E1-E4")
    e3 = path_e3(dev, 5)
    g3 = path_g3(dev, e3, 5)
    del e3["params"], e3["params_dev"]
    torch.cuda.empty_cache()
    lap("E3-G3")
    g1 = path_train("G1", lm_config("minitron-4b", n_layers=4), dev, 7)
    del g1["state"]
    torch.cuda.empty_cache()
    lap("G1")
    g2 = path_train("G2", lm_config("moonshot-v1-16b-a3b", n_layers=3), dev, 8)
    e5 = path_e5(g2, dev, 9)
    del g2["state"]
    torch.cuda.empty_cache()
    lap("G2-E5")
    g10 = path_g10(dev, 16, g10_meta_results(procs))
    lap("G10")
    g4, g5, g6, g7, g8, g9 = sharded_paths(dev)
    lap("G4-G9")
    dr = path_dr(dev, (knobs, procs["DR meta"][0], walls["DR meta"][0]))
    lap("DR")
    e6 = path_e6(dev, 10)
    torch.cuda.empty_cache()
    lap("E6")
    e7 = path_e7(dev, 11)
    lap("E7")
    e8 = path_e8(dev, 12)
    lap("E8")
    e9 = path_e9(dev, 13)
    lap("E9-G11")
    print(f"Paths G10 and G11 took {laps['G10'] + e9['g11']['seconds']:.1f} s (G10 "
          f"{laps['G10']:.1f}, G11 {e9['g11']['seconds']:.1f})")
    e10 = path_e10(dev, 14)
    lap("E10")
    e11 = path_e11(dev, 15)
    lap("E11")
    d1_counts = {k: d1["fp32"]["counts"][k] + d1["bf16"]["counts"][k] for k in d1["fp32"]["counts"]}
    m_counts = {k: m["l1"]["counts"][k] + m["tv"]["counts"][k] for k in m["l1"]["counts"]}
    md1_counts = {k: md1["fp32"]["counts"][k] + md1["bf16"]["counts"][k]
                  for k in md1["fp32"]["counts"]}
    by_path = {"A": a["kernel"]["counts"], "B": b["kernel"]["counts"],
               "C": c["kernel"]["counts"], f"B{below}": b_below["kernel"]["counts"],
               f"C{below}": c_below["kernel"]["counts"], "F": f["kernel"]["counts"],
               "D1": d1_counts, "T": t["counts"], "T solve": t["solve_counts"],
               "T-D2": t_d2["counts"], "M": m_counts, "MD1": md1_counts, "D2": d2["counts"],
               "S": s["counts"], f"S{below}": s_below["counts"], "S-D1": sd1["counts"],
               "H": h["counts"],
               "CLI": cli["counts"], "CLI priors": cli_priors["counts"], "E1": e1["counts"],
               "E2": e2["counts"], "E3": e3["counts"], "E4": e4["counts"], "G1": g1["counts"],
               "G2": g2["counts"], "G3": g3["counts"], "E5": e5["counts"], "E6": e6["counts"],
               "E7": e7["counts"], "E8": e8["counts"], "E9": e9["counts"], "E10": e10["counts"],
               "E11": e11["counts"], "G4": g4["counts"], "G5": g5["counts"], "G6": g6["counts"],
               "G7": g7["counts"], "G8": g8["counts"], "G9": g9["counts"], "DR": dr["counts"],
               "G10": g10["counts"], "G11": e9["g11"]["counts"]}

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
    print(f"chip_smoke: every phase done in {time.perf_counter() - t_start:.1f} s; "
          f"seconds by phase {json.dumps(laps)}")
    print(json.dumps({"kernels": kernels}))
    torch.distributed.destroy_process_group()  # Path D1's world of one
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
