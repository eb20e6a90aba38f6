"""Programs the sharded-training tests run on spawned gloo ranks.

Free of JAX, like ``torch_mesh_programs.py``: the ranks import this module
and need torch and ``repro_torch`` alone.  Every rank builds the same global
parameters and batch from the numpy arrays it is given, keeps its blocks
(``launch.partition``) under ``rules_for_arch`` of its mesh, and runs the
port's train step, or its prefill and decode; rank 0 returns the gathered
results, the others ``None``.
"""

import contextlib
import dataclasses
import io

import torch

from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.dist.compat import make_mesh
from repro_torch.dist.sharding import activate_rules, rules_for_arch
from repro_torch.launch import partition, train
from repro_torch.models import lm, moe, steps
from repro_torch.optim import adamw


def f32_smoke(arch, **kw):
    """``arch``'s SMOKE config computing in float32."""
    return dataclasses.replace(registry.smoke_config(arch), dtype="float32", **kw)


def _lead(out):
    return out if torch.distributed.get_rank() == 0 else None


def path_dict(tree) -> dict:
    return {"/".join(map(str, p)): leaf for p, leaf in lm.tree_items(tree)}


@contextlib.contextmanager
def drop_counter():
    """Record the kept share of every routing's (token, choice) pairs."""
    kept, real = [], moe.dispatch_slots

    def counting(cfg, idx):
        slot, keep = real(cfg, idx)
        kept.append((int(keep.sum()), keep.numel()))
        return slot, keep

    moe.dispatch_slots = counting
    try:
        yield kept
    finally:
        moe.dispatch_slots = real


@contextlib.contextmanager
def routing_ids():
    """Record the expert ids of every MoE routing, in call order."""
    ids, real = [], moe._routing

    def recording(*args):
        out = real(*args)
        ids.append(out[0])
        return out

    moe._routing = recording
    try:
        yield ids
    finally:
        moe._routing = real


def sharded_step(mesh, case: dict) -> dict:
    """One train step of ``case`` on this rank's blocks: the metrics, every
    gathered gradient (``None`` where autograd gives none), every gathered
    parameter after the update, the (kept, total) choices of each routing
    and the expert ids of the first MoE layer's routing on this rank."""
    cfg = f32_smoke(case["arch"], **case.get("cfg", {}))
    rules = rules_for_arch(cfg, mesh)
    opt_cfg = adamw.AdamWConfig(**case["opt"])
    with activate_rules(rules, mesh):
        params = interop.lm_params_from_numpy(case["tree"], cfg, "cpu")
        specs = partition.param_shardings(mesh, params, rules)
        params = partition.shard_tree(params, specs, mesh)
        state = steps.TrainState(params, adamw.init(params, opt_cfg),
                                 torch.zeros((), dtype=torch.int32))
        batch = partition.data_rows({k: torch.as_tensor(v) for k, v in case["batch"].items()},
                                    mesh, rules, case["micro"])
        step = steps.make_train_step(cfg, opt_cfg, microbatches=case["micro"])
        with drop_counter() as kept, routing_ids() as ids:
            metrics, grads = step.gradient(state, batch)
        spec_list = partition.leaf_specs(mesh, state.params, rules)
        grads_global = [None if g is None else partition.gather_leaf(g, s, mesh)
                        for g, s in zip(grads, spec_list)]
        state, after = step.apply(state, metrics, grads)
        params_after = partition.gather_tree(state.params, specs, mesh)
    paths = list(path_dict(params_after))
    return dict(metrics={k: float(v) for k, v in after.items()},
                grads=dict(zip(paths, grads_global)), params=path_dict(params_after),
                kept=kept, rules=dict(rules),
                ids=partition.gather_leaf(ids[0], ("data",), mesh) if ids else None,
                local=[tuple(t.shape) for t in lm.tree_leaves(state.params)],
                blocks={k: tuple(t.shape) for k, t in path_dict(state.params).items()})


def serve_run(cfg, params, prompt, max_len, steps_n, frames=None) -> dict:
    """The prefill of ``prompt`` (the last position's logits, (B, V)), the
    logits of each decode step feeding it token by token (B, S, V), the
    first layer's decode cache after them, and ``steps_n`` greedy tokens:
    ``greedy_generate``'s, or for an encoder-decoder (whose decode reads
    ``cross_kv``, the encoder's output of ``frames``, and which
    ``greedy_generate`` refuses) an argmax loop over the same decode step
    continuing from the fed prompt."""
    batch = {"tokens": prompt} if frames is None else {"tokens": prompt, "frames": frames}
    prefill = steps.make_prefill_step(cfg)(params, batch)
    decode = steps.make_decode_step(cfg)
    cross_kv = None
    if cfg.is_encdec:
        with torch.no_grad():
            cross_kv = lm.encoder_forward(params, cfg, frames)
    state = lm.init_decode_state(cfg, prompt.shape[0], max_len, cross_kv=cross_kv,
                                 device=prompt.device)
    logits = []
    for i in range(prompt.shape[1]):
        step_logits, state = decode(params, prompt[:, i:i + 1], state)
        logits.append(step_logits)
    cache, caches = state.segments[0], state.segments
    if cfg.is_encdec:
        out = [torch.argmax(step_logits[:, :cfg.vocab], dim=-1)]
        for _ in range(steps_n - 1):
            step_logits, state = decode(params, out[-1][:, None], state)
            out.append(torch.argmax(step_logits[:, :cfg.vocab], dim=-1))
        tokens = torch.stack(out, dim=1)
    else:
        tokens = steps.greedy_generate(params, cfg, prompt, steps_n, max_len)
    return dict(prefill=prefill, decode=torch.stack(logits, dim=1), tokens=tokens, cache=cache,
                caches=caches)


def _recurrent_caches(caches, mesh) -> tuple:
    """Mamba-2's, mLSTM's and sLSTM's caches (every field but the length):
    each as this rank holds it (its shape), gathered over the data ranks,
    and the largest difference between any rank's and its data row's model
    rank 0's (a broadcast over the model group)."""
    group = mesh.group("model")
    src = torch.distributed.get_global_rank(group, 0)
    shapes, rows, spread = [], [], torch.zeros(())
    for cache in caches:
        if hasattr(cache, "k") or hasattr(cache, "c_kv"):
            continue
        for t in cache[:-1]:
            first = t.clone()
            torch.distributed.broadcast(first, src=src, group=group)
            spread = torch.maximum(spread, (t - first).abs().max())
            shapes.append(tuple(t.shape))
            rows.append(partition.gather_leaf(t, (None, "data"), mesh))
    torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX)
    return shapes, rows, float(spread)


def sharded_serve(mesh, case: dict) -> dict:
    """:func:`serve_run` of ``case["prompt"]`` (and ``case["frames"]``) on
    this rank's blocks and batch rows (its kv heads' cache, or the whole MLA
    latent), each result gathered over the data ranks; the first layer's
    cache as this rank holds it (its shape) and, for MLA, its latent
    gathered over the data ranks; the recurrent caches of Mamba-2 and xLSTM
    (:func:`_recurrent_caches`)."""
    cfg = f32_smoke(case["arch"], **case.get("cfg", {}))
    rules = rules_for_arch(cfg, mesh)
    with activate_rules(rules, mesh):
        params = interop.lm_params_from_numpy(case["tree"], cfg, "cpu")
        params = partition.shard_tree(params, partition.param_shardings(mesh, params, rules),
                                      mesh)
        inputs = {"tokens": torch.as_tensor(case["prompt"])}
        if case.get("frames") is not None:
            inputs["frames"] = torch.as_tensor(case["frames"])
        inputs = partition.data_rows(inputs, mesh, rules)
        out = serve_run(cfg, params, inputs["tokens"], case["max_len"], case["steps"],
                        inputs.get("frames"))
    rows = lambda t, dim=0: partition.gather_leaf(t, (None,) * dim + ("data",), mesh)
    cache = out["cache"]
    shapes, caches, spread = _recurrent_caches(out["caches"], mesh)
    return dict(prefill=rows(out["prefill"]), decode=rows(out["decode"]),
                recurrent_shapes=shapes, recurrent=caches, recurrent_spread=spread,
                tokens=rows(out["tokens"]), cache_shape=tuple(cache[0].shape),
                cache_heads=cache.k.shape[3] if hasattr(cache, "k") else None,
                latent=rows(cache.c_kv, 1) if hasattr(cache, "c_kv") else None)


def launcher(argv, arch="minitron-4b") -> tuple:
    """The training CLI in this rank (its SMOKE config in float32) -> (its
    standard output, the gathered parameters at the end)."""
    real = train.smoke_config
    train.smoke_config = lambda a: f32_smoke(a)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            state = train.main(argv)
    finally:
        train.smoke_config = real
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        mesh = make_mesh((torch.distributed.get_world_size() // 2, 2), ("data", "model"))
        cfg = f32_smoke(arch)
        rules = rules_for_arch(cfg, mesh)
        params = partition.gather_tree(state.params,
                                       partition.param_shardings(mesh, state.params, rules), mesh)
    else:
        params = state.params
    return out.getvalue(), path_dict(params)


def sharded_train_program(shape, cases: dict, runs=(), serves=None) -> dict:
    """Every case's :func:`sharded_step` on one ``shape`` mesh, every
    ``serves`` case's :func:`sharded_serve`, then the launcher ``runs``
    (name -> argv) in order."""
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {name: sharded_step(mesh, case) for name, case in cases.items()}
    out.update({name: sharded_serve(mesh, case) for name, case in (serves or {}).items()})
    for name, argv in runs:
        out[name] = launcher(argv)
    return _lead(out)
