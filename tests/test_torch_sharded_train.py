"""Sharded training on gloo ranks against the reference's one-device step.

Each mesh is one ``spawn_fake_devices`` call that runs every case of that
mesh (``torch_sharded_programs.sharded_train_program``): the ranks hold
their blocks of the reference's parameters (carried by
``repro_torch.interop``) under ``rules_for_arch`` of their mesh, train on
their data rows of the global batch, and rank 0 returns the gathered
gradients and updated parameters.  Each case is held, in float32, against
the reference's one-device train step (``repro.models.steps``, jitted) and
against the port's one-rank step, at 1e-5 norm-relative on the loss, the
accuracy, the aux loss, the gradient norm, every gradient leaf and every
updated parameter:

* minitron-4b on data 2 x model 2 at 1 and 2 microbatches (heads and kv
  heads split, G = 3 on each rank; the vocabulary-parallel embedding and
  loss head);
* pixtral-12b's text stack on 2 x 2 with ``img_embeds``;
* moonshot-v1-16b-a3b on 2 x 2 at a batch whose capacity drops choices
  (4 experts a model rank, ``d_model`` split over data: the global
  routing, the experts' partial sums, FSDP);
* granite-34b on 1 x 2 (the single kv head replicated) and gemma-7b on
  1 x 2 (tied embeddings, the softcap);
* minitron-4b on 1 x 3: 2 query heads a rank over a replicated pair of kv
  heads, rank 1's heads straddling the two groups (gathered to G = 1);
* deepseek-v3-671b (MLA over the MoE) and whisper-large-v3 (the
  encoder-decoder, ``frames`` in the batch) on 2 x 2, 1 x 2 and 1 x 3: MLA's
  heads split with its latent path replicated (every replicated latent
  leaf's gradient held on its own), Whisper's encoder, decoder and cross
  heads split; at TP 3 their 4 heads replicate with no collective;
* the launcher on 2 x 2 and on one rank, each resuming the other's step-4
  checkpoint for 2 more steps: every run ends where 6 one-rank steps end;
* sharded prefill and decode (``torch_sharded_programs.sharded_serve``) of
  minitron-4b and moonshot-v1-16b-a3b on 2 x 2 and 1 x 2, of minitron-4b
  on 1 x 3 (a rank's query heads straddling two kv groups, read at G = 1
  from a cache of every kv head), and of deepseek-v3-671b (the naive and
  the absorbed MLA decode, each rank's cache the whole latent of its data
  rows) and whisper-large-v3 (decoding against ``cross_kv``) on all three:
  the prefill's last-position logits and every decode step's logits within
  1e-5 of the reference's one-device prefill and decode, the greedy tokens
  equal to the port's one rank's (``greedy_generate``, or Whisper's argmax
  loop over the decode step).
"""

import dataclasses
import shutil
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.dist.compat import spawn_fake_devices
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import lm as port_lm
from repro_torch.models import steps as port_steps
from repro_torch.optim import adamw as port_adamw
from torch_sharded_programs import (drop_counter, f32_smoke, launcher, path_dict, routing_ids,
                                    serve_run, sharded_train_program)

TOL = 1e-5
S = 24
# the reference's default AdamWConfig: step 1's rate is 3e-4 / 100 (the warmup)
OPT = {}
# arch -> global batch rows (one set of parameters and one batch an arch)
ROWS = {"minitron-4b": 4, "granite-34b": 2, "gemma-7b": 2, "pixtral-12b": 4,
        "moonshot-v1-16b-a3b": 8, "deepseek-v3-671b": 4, "whisper-large-v3": 4,
        "zamba2-1.2b": 4, "xlstm-350m": 4}
# arch -> config fields over its f32 SMOKE config, on both sides: zamba2's 8 SSM
# heads in one group (two model ranks share its B and C, as two of zamba2-1.2b's
# 16 do), xLSTM's one head of 128 (split over two model ranks, as each of
# xlstm-350m's 4 heads of 512 is over 16); sLSTM's gates i | f | z | o and g | u
# straddle the model ranks at its SMOKE width as they do at full width
CFG = {"zamba2-1.2b": {"ssm_groups": 1}, "xlstm-350m": {"n_heads": 1, "n_kv_heads": 1}}
S_ENC = 12  # whisper's frames a row
# mesh -> {case: (arch, microbatches)}
MESHES = {
    (2, 2): {"minitron-m1": ("minitron-4b", 1), "minitron-m2": ("minitron-4b", 2),
             "pixtral": ("pixtral-12b", 1), "moonshot": ("moonshot-v1-16b-a3b", 1),
             "deepseek": ("deepseek-v3-671b", 1), "whisper": ("whisper-large-v3", 1),
             "zamba2": ("zamba2-1.2b", 1), "xlstm": ("xlstm-350m", 1)},
    (1, 2): {"granite": ("granite-34b", 1), "gemma": ("gemma-7b", 1),
             "deepseek": ("deepseek-v3-671b", 1), "whisper": ("whisper-large-v3", 1),
             "zamba2": ("zamba2-1.2b", 1), "xlstm": ("xlstm-350m", 1)},
    (1, 3): {"minitron-tp3": ("minitron-4b", 1), "deepseek": ("deepseek-v3-671b", 1),
             "whisper": ("whisper-large-v3", 1), "zamba2": ("zamba2-1.2b", 1),
             "xlstm": ("xlstm-350m", 1)},
}
# the archs held against the reference's step (its compile dominates this
# file's time, so each runs once, at 1 microbatch: a dense model's 2
# microbatches are the same arithmetic, within 1e-5 on either side); the
# port's one-rank pixtral is held against the reference in test_torch_encdec.py
REFERENCE = ("minitron-4b", "granite-34b", "gemma-7b", "moonshot-v1-16b-a3b",
             "deepseek-v3-671b", "whisper-large-v3", "zamba2-1.2b", "xlstm-350m")
# Mamba-2 and xLSTM (RECURRENT).  float32 alone puts their gradients on these
# inputs up to 7.0e-5 (the port) and 3.6e-5 (the reference) of a leaf's largest from
# a float64 run of the port's step (xLSTM's one head of 128: mLSTM's w_v), and 0.65e-5
# / 1.9e-5 (zamba2: Mamba-2's a_log), so their gradients are held against the
# reference at tests/test_torch_train.py's tolerance for these families' gradients
# against jax.grad, TOL_REF_GRAD, and at TOL against the port's one rank.
RECURRENT = ("zamba2-1.2b", "xlstm-350m")
TOL_REF_GRAD = 1e-4
# A zero-initialised leaf (Mamba-2's conv_b and dt_bias, sLSTM's b) takes Adam's
# first step as lr * g / (|g| + eps), so where |g| is small its step follows the
# gradient's rounding; sLSTM's input-gate bias has a gradient of zero in exact
# arithmetic (exp(b_i) scales c and n alike), its float32 value rounding alone.
# As chip_smoke.py's sharded training does (ADAM_RHO_SCALE there), RECURRENT's
# updated parameters are held at TOL over the weights whose gradients agree within
# rho = TOL * (the leaf's largest |w|) / (ADAM_RHO_SCALE * lr) of the other side's
# (or are 0 on both), and every other weight within two of Adam's first steps,
# 2 lr (1 + weight_decay |w|), of the other side's.
ADAM_RHO_SCALE = 4
# serve key -> (arch, config fields over its f32 SMOKE config)
SERVE_KEYS = {"minitron-4b": ("minitron-4b", {}),
              "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}),
              "deepseek-naive": ("deepseek-v3-671b", {"mla_absorbed": False}),
              "deepseek-absorbed": ("deepseek-v3-671b", {"mla_absorbed": True}),
              "whisper-large-v3": ("whisper-large-v3", {}),
              "zamba2-1.2b": ("zamba2-1.2b", CFG["zamba2-1.2b"]),
              "xlstm-350m": ("xlstm-350m", CFG["xlstm-350m"])}
_MLA_WHISPER = {"serve-deepseek-naive": "deepseek-naive",
                "serve-deepseek-absorbed": "deepseek-absorbed",
                "serve-whisper": "whisper-large-v3", "serve-zamba2": "zamba2-1.2b",
                "serve-xlstm": "xlstm-350m"}
# mesh -> {serve case: serve key}: sharded prefill and decode from the initial parameters
SERVES = {
    (2, 2): {"serve-minitron": "minitron-4b", "serve-moonshot": "moonshot-v1-16b-a3b",
             **_MLA_WHISPER},
    (1, 2): {"serve-minitron": "minitron-4b", "serve-moonshot": "moonshot-v1-16b-a3b",
             **_MLA_WHISPER},
    (1, 3): {"serve-minitron": "minitron-4b", **_MLA_WHISPER},
}
PROMPT, MAX_LEN, GEN = 8, 16, 4  # prompt tokens, cache positions, greedy tokens
LAUNCH = ["--arch", "minitron-4b", "--smoke", "--steps", "6", "--batch", "4", "--seq", "16",
          "--ckpt-every", "4", "--device", "cpu"]


def rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def close(got, want, what, tol=TOL):
    err = rel_err(got, want)
    assert err <= tol, f"{what}: norm-relative error {err:.3e} > {tol:.0e}"


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.float64)


def close_updated(got, want, g_got, g_want, w0, lr, what):
    """A RECURRENT case's updated parameter ``got`` against ``want``: at TOL
    of the leaf's largest over the weights whose gradients agree within rho
    (ADAM_RHO_SCALE), every other weight within two of Adam's first steps
    of ``want`` (its initial value ``w0``); -> the share of decided weights."""
    got, want, g_got, g_want, w0 = map(_np, (got, want, g_got, g_want, w0))
    assert got.shape == want.shape == g_got.shape == g_want.shape == w0.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-30)
    rho = TOL * scale / (ADAM_RHO_SCALE * lr)
    decided = (np.abs(g_got - g_want) <= rho * np.abs(g_want)) | ((g_got == 0) & (g_want == 0))
    err = np.abs(got - want)
    worst = float(np.max(err[decided], initial=0.0)) / scale
    assert worst <= TOL, f"{what}: norm-relative error {worst:.3e} > {TOL:.0e} (decided weights)"
    step = lr * (1.0 + port_adamw.AdamWConfig(**OPT).weight_decay * np.abs(w0))
    assert np.all(err[~decided] <= 2.0 * step[~decided] * (1.0 + 1e-6)), \
        f"{what}: an undecided weight moved by more than two of Adam's steps"
    return float(decided.mean())


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import lm, steps
    from repro.optim import adamw

    jax.config.update("jax_enable_x64", False)
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, lm=lm, steps=steps,
                                 adamw=adamw)


def _max_len(cfg) -> int:
    """MAX_LEN tokens of a decode cache: zamba2's shared cache spends
    ``shared_invocations`` positions a token, on both sides."""
    return MAX_LEN * max(1, port_lm.shared_invocations(cfg))


def _inputs(arch, seed):
    """An arch's float32 parameters (the port's init, from ``seed``) and its
    global batch, drawn by numpy from ``seed``, as numpy arrays."""
    cfg = f32_smoke(arch, **CFG.get(arch, {}))
    params = port_lm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    tree = port_lm.tree_map(lambda a: a.numpy(), params)
    rng = np.random.default_rng(seed)
    rows = ROWS[arch]
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, S + 1)).astype(np.int64)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (rows, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = (rng.standard_normal((rows, S_ENC, cfg.d_model)) * 0.02).astype(
            np.float32)
    return tree, batch


def _reference(ref, arch, tree, batch, micro):
    """The reference's one-device step: its ``loss_fn``'s gradient (jitted),
    averaged over the microbatches as its train step does, then its AdamW
    update -> (the gradient, the updated parameters, the metrics)."""
    jax, jnp = ref.jax, ref.jnp
    cfg = dataclasses.replace(ref.registry.smoke_config(arch), dtype="float32",
                              **CFG.get(arch, {}))
    opt = ref.adamw.AdamWConfig(**OPT)

    @jax.jit
    def gradient(params, batch):
        grads = jax.tree.map(jnp.zeros_like, params)
        metrics = []
        for i in range(micro):
            mb = jax.tree.map(lambda a: a.reshape((micro, -1) + a.shape[1:])[i], batch)
            (_, m), g = jax.value_and_grad(lambda p: ref.steps.loss_fn(p, cfg, mb),
                                           has_aux=True)(params)
            grads = jax.tree.map(lambda a, b: a + b / micro, grads, g)
            metrics.append(m)
        return grads, jax.tree.map(lambda *m: jnp.mean(jnp.stack(m)), *metrics)

    rbatch = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
              for k, v in batch.items()}
    grads, metrics = gradient(tree, rbatch)
    params, _, opt_metrics = ref.adamw.update(tree, grads, ref.adamw.init(tree, opt), opt)
    flat = lambda t: {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                      np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(t)}
    metrics = {k: float(v) for k, v in dict(metrics, **opt_metrics).items()}
    return flat(grads), flat(params), metrics


def _one_rank(arch, tree, batch, micro):
    """The port's one-rank step on the same numbers."""
    cfg = f32_smoke(arch, **CFG.get(arch, {}))
    opt = port_adamw.AdamWConfig(**OPT)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    state = port_steps.TrainState(params, port_adamw.init(params, opt),
                                  torch.zeros((), dtype=torch.int32))
    step = port_steps.make_train_step(cfg, opt, microbatches=micro)
    with drop_counter() as kept, routing_ids() as ids:
        metrics, grads = step.gradient(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    init = {k: v.clone() for k, v in path_dict(state.params).items()}
    state, after = step.apply(state, metrics, grads)
    paths = list(path_dict(state.params))
    return dict(grads=dict(zip(paths, grads)), params=path_dict(state.params),
                metrics={k: float(v) for k, v in after.items()}, kept=kept,
                ids=ids[0] if ids else None, init=init)


def _serve_case(key, tree, batch):
    arch, kw = SERVE_KEYS[key]
    return dict(arch=arch, cfg=kw, tree=tree, prompt=batch["tokens"][:, :PROMPT],
                frames=batch.get("frames"), max_len=_max_len(f32_smoke(arch, **kw)), steps=GEN)


def _reference_serve(ref, key, tree, batch):
    """The reference's one-device prefill (jitted) and decode (jitted, the
    prompt fed token by token; an encoder-decoder's against the encoder's
    output of its frames) -> (prefill logits, (B, PROMPT, V) decode logits)."""
    jax, jnp = ref.jax, ref.jnp
    arch, kw = SERVE_KEYS[key]
    cfg = dataclasses.replace(ref.registry.smoke_config(arch), dtype="float32", **kw)
    prompt = jnp.asarray(batch["tokens"][:, :PROMPT].astype(np.int32))
    inputs = {"tokens": prompt}
    cross_kv = None
    if cfg.is_encdec:
        inputs["frames"] = jnp.asarray(batch["frames"])
        cross_kv = jax.jit(lambda p, f: ref.lm.encoder_forward(p, cfg, f))(tree,
                                                                          inputs["frames"])
    prefill = jax.jit(ref.steps.make_prefill_step(cfg))(tree, inputs)
    decode = jax.jit(ref.steps.make_decode_step(cfg))
    state = ref.lm.init_decode_state(cfg, prompt.shape[0], _max_len(cfg), cross_kv=cross_kv)
    logits = []
    for i in range(PROMPT):
        step_logits, state = decode(tree, prompt[:, i:i + 1], state)
        logits.append(np.asarray(step_logits))
    return np.asarray(prefill), np.stack(logits, axis=1)


def _one_rank_serve(key, tree, batch):
    """The port's one-rank ``serve_run`` on the same numbers."""
    arch, kw = SERVE_KEYS[key]
    cfg = f32_smoke(arch, **kw)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    frames = batch.get("frames")
    return serve_run(cfg, params, torch.as_tensor(batch["tokens"][:, :PROMPT]), _max_len(cfg),
                     GEN, None if frames is None else torch.as_tensor(frames))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launcher: 6 one-rank steps (a step-4 checkpoint in ``one``); on
    2 x 2, 6 steps from scratch (a step-4 checkpoint in ``two``) and 2 steps
    resumed from ``one``'s; then 2 one-rank steps resumed from ``two``'s."""
    root = tmp_path_factory.mktemp("sharded_launcher")
    base_out, base = launcher(LAUNCH + ["--ckpt-dir", str(root / "one")])
    shutil.copytree(root / "one", root / "one_copy")
    return types.SimpleNamespace(root=root, base=base, base_out=base_out, runs=[
        ("fresh", LAUNCH + ["--model-parallel", "2", "--ckpt-dir", str(root / "two")]),
        ("resumed", LAUNCH + ["--model-parallel", "2", "--ckpt-dir", str(root / "one_copy")])])


@pytest.fixture(scope="module")
def spawned(ref, launched):
    """mesh -> (the ranks' results, {case: (the reference's step or None,
    the port's one-rank step)}).  One spawn per mesh, the three in a thread
    while this process runs the reference and the one-rank steps."""
    inputs = {arch: _inputs(arch, seed) for seed, arch in enumerate(ROWS)}
    got = {}

    def spawn_all():
        for shape, cases in MESHES.items():
            args = {name: dict(arch=arch, cfg=CFG.get(arch, {}), tree=inputs[arch][0],
                               batch=inputs[arch][1], micro=micro, opt=OPT)
                    for name, (arch, micro) in cases.items()}
            runs = launched.runs if shape == (2, 2) else ()
            serves = {name: _serve_case(key, *inputs[SERVE_KEYS[key][0]])
                      for name, key in SERVES[shape].items()}
            got[shape] = spawn_fake_devices(int(np.prod(shape)), sharded_train_program, shape,
                                            args, runs, serves)[0]

    ranks = threading.Thread(target=spawn_all)
    ranks.start()
    try:
        refs = {arch: _reference(ref, arch, *inputs[arch], 1) for arch in REFERENCE}
        want = {shape: {name: (refs.get(arch), _one_rank(arch, *inputs[arch], micro))
                        for name, (arch, micro) in cases.items()}
                for shape, cases in MESHES.items()}
        serve_keys = {k for s in SERVES.values() for k in s.values()}
        served = {key: (_reference_serve(ref, key, *inputs[SERVE_KEYS[key][0]]),
                        _one_rank_serve(key, *inputs[SERVE_KEYS[key][0]]))
                  for key in serve_keys}
        for shape, cases in SERVES.items():
            want[shape].update({name: served[key] for name, key in cases.items()})
    finally:
        ranks.join()
    assert set(got) == set(MESHES), "a mesh's ranks failed (see their output above)"
    return {shape: (got[shape], want[shape]) for shape in MESHES}


CASES = [(shape, name) for shape, cases in MESHES.items() for name in cases]


@pytest.mark.parametrize("shape,name", CASES, ids=[f"{n}-{s[0]}x{s[1]}" for s, n in CASES])
def test_sharded_step_matches_reference_and_one_rank(spawned, shape, name):
    got_all, want_all = spawned[shape]
    got = got_all[name]
    reference, one = want_all[name]
    recurrent = MESHES[shape][name][0] in RECURRENT
    sides = [("one rank", one["metrics"], {k: v for k, v in one["grads"].items()},
              {k: v.numpy() for k, v in one["params"].items()})]
    if reference is not None:
        sides.append(("the reference", reference[2], reference[0], reference[1]))
    for side, metrics, grads, params in sides:
        for key in ("loss", "aux", "grad_norm", "lr"):
            close(got["metrics"][key], metrics[key], f"{key} vs {side}")
        assert got["metrics"]["acc"] == pytest.approx(metrics["acc"], abs=1e-6)
        assert sorted(got["grads"]) == sorted(grads) == sorted(got["params"]) == sorted(params)
        for path, want in grads.items():
            g = got["grads"][path]
            if path.endswith("router_bias"):  # reaches the loss through topk's indices alone
                assert g is None and (want is None or not np.any(want))
                continue
            tol = TOL_REF_GRAD if recurrent and side == "the reference" else TOL
            close(g, want if isinstance(want, np.ndarray) else want.numpy(),
                  f"grad {path} vs {side}", tol)
        for path, want in params.items():
            if recurrent:
                close_updated(got["params"][path], want, got["grads"][path], grads[path],
                              one["init"][path], metrics["lr"], f"param {path} vs {side}")
            else:
                close(got["params"][path], want, f"param {path} vs {side}")
    assert got["kept"] == one["kept"]


def test_sharding_is_real(spawned):
    """The rules shard what the cases claim: heads and kv heads on 2 x 2,
    heads over a replicated kv head on 1 x 2 (granite) and 1 x 3
    (minitron), experts and FSDP for moonshot, the vocabulary everywhere,
    MLA's heads over its whole latent path, Whisper's heads where 4 divide;
    rank 0's blocks are the shapes that says."""
    two, one_by_two, one_by_three = (spawned[s][0] for s in ((2, 2), (1, 2), (1, 3)))
    assert two["minitron-m1"]["rules"]["heads"] == two["minitron-m1"]["rules"]["kv_heads"] \
        == "model"
    assert one_by_two["granite"]["rules"]["heads"] == "model"
    assert one_by_two["granite"]["rules"]["kv_heads"] is None
    assert one_by_three["minitron-tp3"]["rules"]["heads"] == "model"
    assert one_by_three["minitron-tp3"]["rules"]["kv_heads"] is None
    moon = two["moonshot"]["rules"]
    assert moon["experts"] == "model" and moon["fsdp"] == "data" and moon["vocab"] == "model"
    assert (512 // 2, 48) in two["minitron-m1"]["local"]  # the vocab-split embedding table
    # MLA's heads split on 2 x 2: rank 0's blocks of the first layer's w_uq, w_uk, w_uv
    # and wo (2 of 4 heads), its latent path whole
    ds = f32_smoke("deepseek-v3-671b")
    assert two["deepseek"]["rules"]["heads"] == "model"
    local = two["deepseek"]["local"]
    for want in ((1, ds.q_lora_rank, 2 * (ds.nope_head_dim + ds.rope_head_dim)),
                 (1, ds.kv_lora_rank, 2 * ds.nope_head_dim),
                 (1, ds.kv_lora_rank, 2 * ds.v_head_dim), (1, 2 * ds.v_head_dim, ds.d_model),
                 (1, ds.d_model, ds.kv_lora_rank), (1, ds.d_model, ds.q_lora_rank)):
        assert want in local, (want, local)
    # whisper's 4 heads split on 2 x 2 and on 1 x 2, replicated at TP 3 (so are its
    # MLP and vocabulary: 128 and 256 do not divide over 3), as are deepseek's
    for mesh in (two, one_by_two):
        assert mesh["whisper"]["rules"]["heads"] == mesh["whisper"]["rules"]["kv_heads"] \
            == "model"
    assert one_by_three["whisper"]["rules"]["heads"] is None
    assert one_by_three["deepseek"]["rules"]["heads"] is None
    # Mamba-2 on 2 x 2: in_proj's rows over data (fsdp), out_proj's columns; xLSTM:
    # mLSTM's and sLSTM's projections' columns over model (ssm_inner), w_down's rows;
    # at TP 3 their ssm_inner (128) replicates, as do zamba2's heads and both vocabularies
    z = f32_smoke("zamba2-1.2b", **CFG["zamba2-1.2b"])
    assert two["zamba2"]["rules"]["ssm_inner"] == "model" == two["zamba2"]["rules"]["heads"]
    assert two["zamba2"]["rules"]["fsdp"] == "data"
    cols = 2 * z.d_ssm_inner + 2 * z.ssm_groups * z.ssm_state + z.n_ssm_heads
    blocks = two["zamba2"]["blocks"]
    assert blocks["segments/0/mamba/in_proj"] == (z.n_layers, z.d_model // 2, cols)
    assert blocks["segments/0/mamba/out_proj"] == (z.n_layers, z.d_ssm_inner, z.d_model // 2)
    assert blocks["shared_attn/attn/wq"] == (z.d_model, z.d_model // 2)
    xl = f32_smoke("xlstm-350m", **CFG["xlstm-350m"])
    d, din = xl.d_model, 2 * xl.d_model
    blocks = two["xlstm"]["blocks"]
    assert two["xlstm"]["rules"]["ssm_inner"] == "model"
    for path, want in (("segments/0/mlstm/w_q", (1, din, din // 2)),
                       ("segments/0/mlstm/w_up", (1, d, din)),
                       ("segments/0/mlstm/w_down", (1, din // 2, d)),
                       ("segments/0/mlstm/w_i", (1, din, xl.n_heads)),
                       ("segments/1/slstm/w_x", (1, d, 2 * d)),
                       ("segments/1/slstm/w_up", (1, d, d)),
                       ("segments/1/slstm/w_down", (1, d // 2, d))):
        assert blocks[path] == want, (path, blocks[path], want)
    for arch in ("zamba2", "xlstm"):
        assert one_by_three[arch]["rules"]["ssm_inner"] is None
        assert one_by_three[arch]["rules"]["vocab"] is None
    assert one_by_three["zamba2"]["rules"]["heads"] is None


def test_moe_routing_is_global_and_drops(spawned):
    """moonshot on 2 x 2: every routing keeps and drops the one-rank step's
    (token, choice) pairs, some are dropped, and the first layer's expert
    ids gathered over the data ranks equal the one-rank run's."""
    got_all, want_all = spawned[(2, 2)]
    got, (_, one) = got_all["moonshot"], want_all["moonshot"]
    assert got["kept"] == one["kept"]
    assert any(k < n for k, n in got["kept"])
    assert torch.equal(got["ids"], one["ids"])


def test_launcher_checkpoints_cross_meshes(spawned, launched, capsys):
    """2 x 2 from scratch, 2 x 2 resumed from the one-rank run's step-4
    checkpoint, one rank resumed from the 2 x 2 run's: each ends within 1e-5
    of 6 one-rank steps."""
    got = spawned[(2, 2)][0]
    fresh_out, fresh = got["fresh"]
    resumed_out, resumed = got["resumed"]
    assert "resumed" not in fresh_out and fresh_out.rstrip().endswith("done")
    assert "resumed from step 4 (re-sharded onto 2x2)" in resumed_out
    out, back = launcher(LAUNCH + ["--ckpt-dir", str(launched.root / "two")])
    assert "resumed from step 4" in out
    for path, want in launched.base.items():
        for what, run in (("2x2", fresh), ("2x2 resumed", resumed), ("1x1 resumed", back)):
            close(run[path], want.numpy(), f"{what} {path}")


SERVE_CASES = [(shape, name) for shape, cases in SERVES.items() for name in cases]


@pytest.mark.parametrize("shape,name", SERVE_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for s, n in SERVE_CASES])
def test_sharded_prefill_and_decode_match_reference(spawned, shape, name):
    """The prefill's logits and every decode step's, gathered over the data
    ranks, within 1e-5 of the reference's one-device prefill and decode (the
    vocabulary gathered over the model ranks; the MoE decode routing each
    step's B tokens under the global capacity); the greedy tokens those of
    the port's one rank."""
    got_all, want_all = spawned[shape]
    got = got_all[name]
    (prefill, decode), one = want_all[name]
    close(got["prefill"], prefill, f"{name} prefill logits")
    assert got["decode"].shape == decode.shape
    for i in range(PROMPT):
        close(got["decode"][:, i], decode[:, i], f"{name} decode step {i} logits")
    assert torch.equal(got["tokens"], one["tokens"])


def test_sharded_decode_cache_holds_the_ranks_kv_heads(spawned):
    """minitron-4b SMOKE's kv heads split over 2 model ranks, and replicated
    over 3 (the straddling case reads them at G = 1)."""
    kv = f32_smoke("minitron-4b").n_kv_heads
    assert spawned[(2, 2)][0]["serve-minitron"]["cache_heads"] == kv // 2
    assert spawned[(1, 3)][0]["serve-minitron"]["cache_heads"] == kv


@pytest.mark.parametrize("shape", list(SERVES), ids=[f"{s[0]}x{s[1]}" for s in SERVES])
def test_sharded_mla_cache_holds_the_whole_latent(spawned, shape):
    """deepseek-v3-671b SMOKE: rank 0's first-segment MLA cache is the whole
    latent (kv_lora_rank wide) of its data rows, and the ranks' caches,
    gathered over the data axis after the fed prompt, hold the one-rank
    run's latent; the naive and the absorbed decode each write it."""
    cfg = f32_smoke("deepseek-v3-671b")
    rows = ROWS["deepseek-v3-671b"] // shape[0]
    got_all, want_all = spawned[shape]
    for name in ("serve-deepseek-naive", "serve-deepseek-absorbed"):
        got, (_, one) = got_all[name], want_all[name]
        # (layers of the first segment, rows, positions, latent)
        assert got["cache_shape"] == (cfg.first_k_dense, rows, MAX_LEN, cfg.kv_lora_rank), name
        assert got["cache_heads"] is None
        close(got["latent"], one["cache"].c_kv.numpy(), f"{name} latent cache")


@pytest.mark.parametrize("shape", list(SERVES), ids=[f"{s[0]}x{s[1]}" for s in SERVES])
def test_sharded_recurrent_caches_are_whole(spawned, shape):
    """zamba2's Mamba-2 caches and xLSTM's mLSTM and sLSTM caches after the fed
    prompt: rank 0's are whole (the one-rank run's shapes over its data
    rows), every rank's equals its data row's model rank 0's, and gathered
    over the data ranks they hold the one-rank run's within TOL."""
    got_all, want_all = spawned[shape]
    for name in ("serve-zamba2", "serve-xlstm"):
        got, (_, one) = got_all[name], want_all[name]
        want = [t for c in one["caches"] if not hasattr(c, "k") for t in c[:-1]]
        assert len(got["recurrent"]) == len(want) > 0, name
        for local, g, w in zip(got["recurrent_shapes"], got["recurrent"], want):
            assert local == (w.shape[0], w.shape[1] // shape[0]) + tuple(w.shape[2:]), name
            close(g, w.numpy(), f"{name} cache {tuple(w.shape)}")
        assert got["recurrent_spread"] == 0.0, (name, got["recurrent_spread"])
