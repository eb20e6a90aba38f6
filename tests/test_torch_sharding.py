"""The sharding rules and partition specs against the reference's, with no ranks.

``rules_for_arch``, ``spec_for_param`` and the spec trees read only a
mesh's axis names and sizes, so both packages take a duck-typed mesh here:
the reference one whose ``devices`` is ``np.empty(shape)`` (no JAX device
needed; its ``NamedSharding`` is replaced by a holder of the spec), the
port one with ``axis_sizes``.  For the ten registry ids at full size
(the port's parameters built on the meta device, the reference's by
``jax.eval_shape``) on the production meshes (16, 16) and (2, 16, 16) and
the host meshes (2, 2), (1, 2), (1, 3) and (4, 1): the rules, fallbacks
included; every parameter leaf's spec and every TrainState leaf's; every
decode-cache leaf's at a batch that divides the data axes and at one that
does not; the batch specs.  Then ``shard_leaf`` on every coordinate of a
mesh, its blocks put back together in coordinate order, is bit-exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.dist import blocks as port_blocks
from repro_torch.dist import sharding
from repro_torch.launch import partition
from repro_torch.models import layers as port_layers
from repro_torch.models import lm as port_lm
from repro_torch.models import moe as port_moe
from repro_torch.models import steps as port_steps
from repro_torch.optim import adamw as port_adamw

ARCHS = ["codeqwen1.5-7b", "granite-34b", "minitron-4b", "gemma-7b", "deepseek-v3-671b",
         "moonshot-v1-16b-a3b", "zamba2-1.2b", "pixtral-12b", "xlstm-350m", "whisper-large-v3"]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((1, 2), ("data", "model")),
          ((1, 3), ("data", "model")), ((4, 1), ("data", "model"))]
CACHE_BATCHES = (64, 6)  # divides every data extent here / divides none above 3


class _Held:
    """Stands in for the reference's NamedSharding: holds the spec."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.dist import sharding as ref_sharding
    from repro.launch import partition as ref_partition
    from repro.models import lm, steps
    from repro.optim import adamw

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, lm=lm,
                                 steps=steps, adamw=adamw, sharding=ref_sharding,
                                 partition=ref_partition)


@pytest.fixture
def held(ref, monkeypatch):
    monkeypatch.setattr(ref.partition, "NamedSharding", _Held)
    return ref


def _meshes(shape, names):
    return (types.SimpleNamespace(axis_names=names, devices=np.empty(shape)),
            types.SimpleNamespace(axis_names=names, axis_sizes=shape))


def _meta_normal(gen, shape, std, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture(scope="module")
def trees(ref):
    """arch -> (the reference's parameter and cache shapes by batch, the
    port's on the meta device), each built once."""
    built = {}
    jax = ref.jax

    def get(arch):
        if arch not in built:
            cfg, pcfg = ref.registry.full_config(arch), port_registry.full_config(arch)
            rparams = jax.eval_shape(lambda: ref.lm.init_params(jax.random.PRNGKey(0), cfg))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(port_layers, "_truncated_normal", _meta_normal)
                mp.setattr(port_moe, "_truncated_normal", _meta_normal)
                pparams = port_lm.init_params(torch.Generator(), pcfg, device="meta")
            caches = {}
            for b in CACHE_BATCHES:
                rcross = jax.ShapeDtypeStruct((b, 16, cfg.d_model), jax.numpy.float32) \
                    if cfg.is_encdec else None
                pcross = torch.empty((b, 16, cfg.d_model), device="meta") \
                    if cfg.is_encdec else None
                caches[b] = (jax.eval_shape(lambda: ref.lm.init_decode_state(cfg, b, 32, rcross)),
                             port_lm.init_decode_state(pcfg, b, 32, pcross, device="meta"))
            built[arch] = (cfg, pcfg, rparams, pparams, caches)
        return built[arch]

    return get


def _ref_flat(jax, tree) -> dict:
    """{path: spec} of the reference's spec tree (``_Held`` leaves)."""
    key = lambda k: str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
    return {"/".join(key(k) for k in path): leaf.spec
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_flat(tree, specs) -> dict:
    """{path: spec} of a port tree and its spec tree."""
    out = {}

    def at(path):
        s = specs
        for p in path:
            s = getattr(s, p) if isinstance(p, str) and port_blocks._is_namedtuple(s) else s[p]
        return s

    port_blocks._map_with_path(lambda path, leaf: out.setdefault(
        "/".join(map(str, path)), at(path)), tree)
    return out


def _train_state(tree, make_state, make_opt, scalar):
    return make_state(tree, make_opt(tree, tree, scalar), scalar)


@pytest.mark.parametrize("shape,names", MESHES, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(held, trees, arch, shape, names):
    ref, jax = held, held.jax
    cfg, pcfg, rparams, pparams, caches = trees(arch)
    rmesh, pmesh = _meshes(shape, names)
    rules = ref.sharding.rules_for_arch(cfg, rmesh)
    assert sharding.rules_for_arch(pcfg, pmesh) == rules
    assert rules == ref.sharding.rules_for_arch(cfg, rmesh)  # the fallbacks are the reference's

    want = _ref_flat(jax, ref.partition.param_shardings(rmesh, rparams, rules))
    got = _port_flat(pparams, partition.param_shardings(pmesh, pparams, rules))
    assert got == want
    shapes = {p: tuple(t.shape) for p, t in _port_flat(pparams, pparams).items()}
    assert shapes == _ref_flat(jax, jax.tree.map(lambda s: _Held(None, s.shape), rparams))

    scalar = jax.ShapeDtypeStruct((), jax.numpy.int32)
    rstate = _train_state(rparams, ref.steps.TrainState, ref.adamw.AdamWState, scalar)
    pstate = _train_state(pparams, port_steps.TrainState, port_adamw.AdamWState,
                          torch.empty((), dtype=torch.int32, device="meta"))
    want = _ref_flat(jax, ref.partition.train_state_shardings(rmesh, rstate, rules))
    got = _port_flat(pstate, partition.train_state_shardings(pmesh, pstate, rules))
    assert got == want

    for b, (rcache, pcache) in caches.items():
        want = _ref_flat(jax, ref.partition.cache_shardings(rmesh, rcache, rules))
        got = _port_flat(pcache, partition.cache_shardings(pmesh, pcache, rules))
        assert got == want, b
        rbatch = {"tokens": jax.ShapeDtypeStruct((b, 9), jax.numpy.int32)}
        want = _ref_flat(jax, ref.partition.batch_shardings(rmesh, rbatch, rules))
        pbatch = {"tokens": torch.empty((b, 9), device="meta")}
        got = _port_flat(pbatch, partition.batch_shardings(pmesh, pbatch, rules))
        assert got == want, b


def test_rule_fallbacks_are_the_references():
    """The fallbacks the tests above hold, spelled out: minitron-4b's 24
    heads and 8 kv heads do not divide 16 (and its kv heads not 3), granite's
    single kv head divides no TP > 1, deepseek's experts and d_model split."""
    mesh = lambda *shape: types.SimpleNamespace(axis_names=("data", "model")[-len(shape):],
                                                axis_sizes=shape)
    full = port_registry.full_config
    r = sharding.rules_for_arch(full("minitron-4b"), mesh(16, 16))
    assert r["heads"] is None and r["kv_heads"] is None and r["mlp"] == "model"
    r = sharding.rules_for_arch(full("minitron-4b"), mesh(1, 3))
    assert r["heads"] == "model" and r["kv_heads"] is None
    for tp in (2, 16):
        r = sharding.rules_for_arch(full("granite-34b"), mesh(1, tp))
        assert r["heads"] == "model" and r["kv_heads"] is None
    r = sharding.rules_for_arch(full("deepseek-v3-671b"), mesh(16, 16))
    assert r["experts"] == "model" and r["fsdp"] == "data"


class _Coords:
    """A port mesh seen from one coordinate, without process groups."""

    def __init__(self, names, sizes, coords):
        self.axis_names, self.axis_sizes, self.coords = names, sizes, coords

    def size(self, name):
        return self.axis_sizes[self.axis_names.index(name)]

    def index(self, name):
        return self.coords[self.axis_names.index(name)]


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((1, 3), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model"))],
                         ids=["2x2", "1x3", "2x2x2"])
def test_shard_blocks_tile_the_global_tree_bit_exact(shape, names):
    """Every coordinate's ``shard_tree`` block of the parameters (minitron-4b
    and moonshot SMOKE; moonshot's FSDP over (pod, data) on the 3-axis mesh,
    taken row-major) is, bit for bit, the slice of the global leaf its
    coordinates name, and the blocks of the coordinates that differ on a
    split axis tile the leaf: gathering them back is the identity
    (``gather_tree`` runs on ranks in test_torch_sharded_train.py)."""
    import itertools

    for arch in ("minitron-4b", "moonshot-v1-16b-a3b"):
        cfg = dataclasses.replace(port_registry.smoke_config(arch), d_model=48, d_ff=192,
                                  vocab=384)
        params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        rules = sharding.rules_for_arch(cfg, _Coords(names, shape, (0,) * len(shape)))
        rules = dict(rules, fsdp=("pod", "data") if "pod" in names else rules["fsdp"])
        specs = partition.param_shardings(_Coords(names, shape, (0,) * len(shape)), params, rules)
        blocks = {c: partition.shard_tree(params, specs, _Coords(names, shape, c))
                  for c in itertools.product(*(range(s) for s in shape))}
        last = tuple(n - 1 for n in shape)
        layout = partition.ShardedLayout(_Coords(names, shape, last), specs)
        assert layout.is_distributed
        assert not partition.ShardedLayout(_Coords(names, (1,) * len(shape), (0,) * len(shape)),
                                           specs).is_distributed
        for (_, got), (_, want) in zip(port_lm.tree_items(layout.local_state(params)),
                                       port_lm.tree_items(blocks[last])):
            assert torch.equal(got, want)  # the checkpoints' plan cuts the same blocks
        for (path, whole), (_, spec) in zip(port_lm.tree_items(params),
                                            _port_flat(params, specs).items()):
            def pick(tree):
                for p in path:
                    tree = tree[p]
                return tree

            got = {c: pick(b) for c, b in blocks.items()}
            for c, t in got.items():  # each block is the slice its coordinates name
                want = whole
                for dim, entry in enumerate(spec):
                    n, i = 1, 0
                    for a in port_blocks._axes(entry):
                        n, i = n * shape[names.index(a)], i * shape[names.index(a)] + \
                            c[names.index(a)]
                    size = want.shape[dim] // n
                    want = want.narrow(dim, i * size, size)
                assert torch.equal(t, want), (arch, path, c)
            axes = partition.spec_axes(spec)
            assert sum(t.numel() for t in got.values()) == whole.numel() * \
                int(np.prod([s for a, s in zip(names, shape) if a not in axes]))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
def test_moe_rank_slots_rebase_exactly(ranks, skew):
    """``moe.rebase_slots``, no ranks needed: each data rank's kept (token,
    choice) pairs, rebased, are its pairs' global slots less the earlier
    ranks' pairs of the same expert, distinct within an expert and inside
    the rows it returns; the rows are at most the global capacity, and
    under a uniform routing below it, which is what the rebase buys."""
    cfg = dataclasses.replace(port_registry.smoke_config("moonshot-v1-16b-a3b"),
                              capacity_factor=1.0)
    rng = np.random.default_rng(ranks + 10 * skew)
    t_all, k, e = 64 * ranks, cfg.top_k, cfg.n_experts
    p = np.arange(1, e + 1, dtype=np.float64) ** (3 if skew else 0)
    all_idx = torch.as_tensor(np.stack([rng.choice(e, k, replace=False, p=p / p.sum())
                                        for _ in range(t_all)]))
    slot_all, keep_all = port_moe.dispatch_slots(cfg, all_idx)
    cap = port_moe.capacity(cfg, t_all)
    assert not bool(keep_all.all())  # the capacity drops choices here
    flat, pairs = all_idx.reshape(-1), t_all * k // ranks
    for r in range(ranks):
        sl = slice(r * pairs, (r + 1) * pairs)
        slot, rows = port_moe.rebase_slots(cfg, all_idx, slot_all[sl], keep_all[sl], r * pairs)
        keep, ids = keep_all[sl], flat[sl]
        before = torch.bincount(flat[:r * pairs], minlength=e)
        assert torch.equal(slot[keep] + before[ids[keep]], slot_all[sl][keep])
        assert bool(keep.any())
        assert int(slot[keep].min()) >= 0 and int(slot[keep].max()) < rows
        assert len({(int(a), int(b)) for a, b in zip(ids[keep], slot[keep])}) == int(keep.sum())
        assert rows <= cap
        if not skew:
            assert rows < cap
