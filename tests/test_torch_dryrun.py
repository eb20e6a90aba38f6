"""The port's dry-run layer (``repro_torch.launch.{specs,dryrun,roofline}``)
against the reference's.

* The specs: the ``meta`` trees of ``launch/specs.py`` (every argument of
  every cell of all ten FULL archs) equal the reference's ``jax.eval_shape``
  trees, keys, shapes and dtypes, and are built with no draw.
* The argument bytes: a rank's blocks of minitron-4b and
  moonshot-v1-16b-a3b SMOKE on a (2, 4) mesh, in ``train_4k``,
  ``prefill_32k`` and ``decode_32k``, hold exactly the bytes the
  reference's compiled cell takes as arguments.
* The records: the SMOKE cells walked on rank 0 of a fake world of 8 (one
  subprocess), and one FULL production cell on the 512-rank multi-pod mesh,
  hold the reference's ``test_dryrun_artifacts.py`` properties; every
  family is sharded, so no cell is listed as blocked.
* The roofline: ``derive`` and the command line over those records.

Every fake world and every reference run on 8 placeholder devices runs in
a subprocess (``torch_dryrun_programs.py``).
"""

import dataclasses
import json
import time

import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.launch import roofline, specs
from repro_torch.models import lm as port_lm
from torch_dryrun_programs import start

ARCHS = port_registry.all_arch_ids()
# the SMOKE cells walked on (2, 4): every cell, but the dense train cells of
# the four archs whose train step is the same code as minitron's (7 s each), and
# xlstm-350m's train and prefill cells, whose sLSTM layers loop over 4096 / 32768
# positions in Python (~6 / ~8 min of the walk's dispatch on meta; the CLI's
# `--all` walks them, PERF.md section 6)
SMOKE_CELLS = [(a, s, "single") for a in ARCHS for s in port_registry.cells_for(a)
               if not (s == "train_4k" and a in ("codeqwen15_7b", "granite_34b", "gemma_7b",
                                                 "pixtral_12b"))
               and not (a == "xlstm_350m" and s in ("train_4k", "prefill_32k"))]
# the cells whose family has no sharded step yet: none since Mamba-2 and xLSTM
# (ROADMAP Queue 1 item 11.7c-b) shard
BLOCKED_BY_11_7C = set()
# deepseek-v3's, whisper's, zamba2's and xlstm-350m's decode cells: the MLA latent
# cache, cross_kv and the Mamba-2 / mLSTM / sLSTM caches whole on the model ranks
# (their rows on data), whose reference argument bytes cost no train-step compile
ARG_CELLS = [(a, s) for a in ("minitron_4b", "moonshot_v1_16b_a3b")
             for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    (a, "decode_32k") for a in ("deepseek_v3_671b", "whisper_large_v3", "zamba2_1p2b",
                                "xlstm_350m")]
FULL_CELL = ("minitron_4b", "prefill_32k", "multipod")


def _port_flat(tree, path=()) -> dict:
    """{path: (shape, dtype)} of a port tree (NamedTuples by field name)."""
    if tree is None:
        return {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(map(str, path)): (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, path + (k,)))
    return out


def _ref_flat(jax, tree) -> dict:
    def key(k):
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)

    return {"/".join(key(k) for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.launch import specs as ref_specs

    return jax, registry, ref_specs


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references_eval_shape_trees(ref, programs, arch):
    """Every argument tree of every cell of ``arch`` (FULL), and the
    parameter and train-state trees, key for key in shape and dtype; all on
    ``meta``, built with no draw."""
    jax, ref_registry, ref_specs = ref
    cfg, rcfg = port_registry.full_config(arch), ref_registry.full_config(arch)
    t0 = time.perf_counter()
    state = specs.train_state_specs(cfg)
    built_s = time.perf_counter() - t0
    assert _port_flat(state) == _ref_flat(jax, ref_specs.train_state_specs(rcfg))
    assert _port_flat(specs.params_specs(cfg)) == _ref_flat(jax, ref_specs.params_specs(rcfg))
    assert all(t.device.type == "meta" for t in port_lm.tree_leaves(state))
    assert port_registry.cells_for(arch) == ref_registry.cells_for(arch)
    for shape in port_registry.cells_for(arch):
        seq, batch, kind = port_registry.SHAPES[shape]
        assert specs.cell_specs(cfg, shape)[0] == kind
        if kind == "train":
            pairs = [(specs.train_batch_specs(cfg, seq, batch),
                      ref_specs.train_batch_specs(rcfg, seq, batch))]
        elif kind == "prefill":
            pairs = [(specs.prefill_batch_specs(cfg, seq, batch),
                      ref_specs.prefill_batch_specs(rcfg, seq, batch))]
        else:
            pairs = [(specs.decode_state_specs(cfg, batch, seq),
                      ref_specs.decode_state_specs(rcfg, batch, seq)),
                     (specs.cell_specs(cfg, shape)[2][1],
                      ref_specs.SDS((batch, 1), jax.numpy.int32))]
        for got, want in pairs:
            assert _port_flat(got) == _ref_flat(jax, want), (arch, shape)
    # shapes, not draws: deepseek-v3-671b's 671e9 parameters and two moments
    assert built_s < 10.0, f"{arch}'s train state took {built_s:.1f} s to build"


def test_specs_draw_nothing():
    """The generator stand-in is never drawn from: a real generator's state
    is untouched by building the specs, which hold no storage."""
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state().clone()
    params = specs.params_specs(port_registry.smoke_config("minitron-4b"))
    assert torch.equal(gen.get_state(), before)
    assert all(t.untyped_storage().data_ptr() == 0 for t in port_lm.tree_leaves(params))


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The file's three subprocesses, started together when its first test
    runs (they run beside the in-process spec tests): the SMOKE cells on
    rank 0 of a fake (2, 4) world, the FULL production cell on the
    multi-pod mesh, each written as a record, and the reference's compiled
    SMOKE cells' argument bytes."""
    out_dir = str(tmp_path_factory.mktemp("dryrun_torch"))
    started = {"smoke": start("port_cells", arch_shapes=SMOKE_CELLS, out_dir=out_dir),
               "full": start("port_cells", arch_shapes=[FULL_CELL], smoke=False,
                             out_dir=out_dir)}
    try:
        import jax  # noqa: F401

        started["ref"] = start("ref_argument_bytes", cells=ARG_CELLS)
    except ImportError:
        pass
    yield out_dir, started
    for s in started.values():  # a selection that read no result leaves none running
        s.proc.kill()
        s.proc.communicate()


@pytest.fixture(scope="module")
def smoke_records(programs):
    out_dir, started = programs
    recs = dict(started["smoke"].result())
    recs.update(started["full"].result())
    return out_dir, {tuple(k.split("/")): v for k, v in recs.items()}


@pytest.fixture(scope="module")
def ref_argument_bytes(programs):
    if "ref" not in programs[1]:
        pytest.skip("jax is not installed")
    return programs[1]["ref"].result()


@pytest.mark.parametrize("arch,shape", ARG_CELLS)
def test_argument_bytes_equal_the_references(smoke_records, ref_argument_bytes, arch, shape):
    rec = smoke_records[1][arch, shape, "single"]
    assert rec["ok"], rec.get("error")
    assert rec["memory"]["argument"] == ref_argument_bytes[f"{arch}/{shape}"]


def test_all_cells_recorded_and_ok_but_the_listed_ones(smoke_records):
    """Every walked cell is recorded and ok, the Mamba-2 hybrid's and
    xLSTM's among them: no cell is listed as blocked (a listed one would be
    ``ok: false`` naming 11.7c-b and still record its memory)."""
    recs = smoke_records[1]
    for arch, shape, mesh in SMOKE_CELLS:
        rec = recs[arch, shape, mesh]
        assert rec["memory"]["argument"] > 0, (arch, shape)
        if (arch, shape) in BLOCKED_BY_11_7C:
            assert not rec["ok"] and "11.7c-b" in rec["error"], (arch, shape, rec.get("error"))
        else:
            assert rec["ok"], (arch, shape, rec.get("error"))
    blocked = {(a, s) for a, s, _ in SMOKE_CELLS} & BLOCKED_BY_11_7C
    assert blocked == BLOCKED_BY_11_7C and len(BLOCKED_BY_11_7C) == 0


def test_cost_numbers_sane(smoke_records):
    for key, rec in smoke_records[1].items():
        if not rec["ok"]:
            continue
        w = rec["walk"]
        assert w["flops"] > 0 and w["bytes"] > 0 and w["launches"] > 0, key
        seq, batch, kind = port_registry.SHAPES[rec["shape"]]
        if kind == "train":
            lower = 6.0 * rec["params"]["active"] * seq * batch * 0.5
            assert w["flops"] * rec["n_devices"] > lower * 0.05, key
        assert rec["memory"]["temp"] >= 0, key
        if rec["kind"] in ("train", "prefill"):  # the bf16 flash kernel on the card's route
            mla = port_registry.smoke_config(rec["arch"]).attn_type == "mla"
            # MLA attends in plain code, as the reference does: no kernel
            assert bool(w["kernel_launches"]) != mla, key


def test_meshes_and_ranks(smoke_records):
    """The SMOKE cells ran on (2, 4); the FULL cell on the 512-rank
    (pod 2, data 16, model 16) mesh, its batch over (pod, data)."""
    for key, rec in smoke_records[1].items():
        if key == FULL_CELL:
            assert rec["n_devices"] == 512 and rec["mesh_shape"] == [2, 16, 16]
            assert {g["axes"] for g in rec["collective_groups"]} >= {"model"}
        else:
            assert rec["n_devices"] == 8 and rec["mesh_shape"] == [2, 4], key


def test_train_cells_have_collectives(smoke_records):
    """Every sharded train cell communicates (gradient and TP reductions),
    by kind and by group; an MoE cell gathers the routing too, Mamba-2 its
    FSDP blocks, and xLSTM's decode its up-projection, q, k, v and sLSTM
    weights."""
    recs = smoke_records[1]
    for key, rec in recs.items():
        if rec["ok"] and rec["shape"] == "train_4k":
            total = sum(rec["walk"]["collective_bytes"].values())
            assert total > 1e6, (key, total)
            assert rec["walk"]["collective_bytes"]["all-reduce"] > 0, key
            axes = {g["axes"] for g in rec["collective_groups"]}
            assert {"data", "model"} <= axes, (key, axes)
    moe = recs["moonshot_v1_16b_a3b", "train_4k", "single"]
    assert moe["walk"]["collective_bytes"]["all-gather"] > 0
    # fsdp_gather / tp_gather: all-gathers (xlstm-350m's decode: its train cell is
    # not walked here)
    for key in (("zamba2_1p2b", "train_4k", "single"), ("xlstm_350m", "decode_32k", "single")):
        assert recs[key]["walk"]["collective_bytes"]["all-gather"] > 0, key
    assert "models/moe.py:rebase_slots" in moe["static_bounds"]


def test_roofline_derive_and_table(smoke_records, tmp_path, capsys):
    """``derive`` prices every ok record (the terms, the bound, the useful
    ratio, ``fits_hbm`` against 80 GB); the command line writes one row per
    record and prices every cell in its table (no ERROR row)."""
    out_dir, recs = smoke_records
    rec = recs[FULL_CELL]
    row = roofline.derive(rec)
    assert row["compute_s"] == rec["walk"]["flops"] / roofline.BF16_FLOPS
    assert row["memory_s"] == rec["walk"]["bytes"] / roofline.HBM_BW
    assert row["step_s_bound"] == max(row["compute_s"], row["memory_s"], row["collective_s"])
    assert row["bottleneck"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert row["hbm_need_bytes"] == mem["argument"] + mem["temp"] + mem["output"] - mem["alias"]
    assert row["fits_hbm"] == (row["hbm_need_bytes"] <= 80e9)
    # minitron's TP groups of 16 span two 8-GPU nodes: InfiniBand
    assert row["inter_host_wire_bytes"] > 0
    assert row["useful_ratio"] == pytest.approx(
        roofline.model_flops(rec) / (rec["walk"]["flops"] * 512))
    json_out = tmp_path / "roofline.json"
    roofline.main(["--dir", out_dir, "--mesh", "all", "--json-out", str(json_out)])
    rows = json.loads(json_out.read_text())
    assert len(rows) == len(recs)
    table = capsys.readouterr().out
    assert "not measured" in table and "| ERROR |" not in table
    priced = [line for line in table.splitlines() if line.startswith("| ")
              and line.split(" | ")[3:4] != ["compute"]]
    assert len(priced) == len(recs) and all("**" in line for line in priced)
    assert {r["arch"] for r in rows} >= {"zamba2_1p2b", "xlstm_350m"}


def test_group_tier_by_node():
    assert roofline.group_tier(range(8)) == "nvlink"
    assert roofline.group_tier(range(8, 16)) == "nvlink"
    assert roofline.group_tier(range(16)) == "inter_host"
    assert roofline.group_tier(range(0, 256, 16)) == "inter_host"


def test_model_flops_closed_forms():
    rec = {"params": {"active": 1e9}}
    for shape, want in (("train_4k", 6e9 * 4096 * 256), ("prefill_32k", 2e9 * 32768 * 32),
                        ("decode_32k", 2e9 * 128), ("long_500k", 2e9)):
        assert roofline.model_flops(dict(rec, shape=shape)) == want


def test_specs_dtypes_are_the_references():
    """int32 tokens, bf16 frames and image embeddings, the parameters in
    ``param_dtype``."""
    w = port_registry.full_config("whisper-large-v3")
    p = port_registry.full_config("pixtral-12b")
    tb = specs.train_batch_specs(w, 4096, 2)
    assert tb["tokens"].dtype == torch.int32 and tb["frames"].dtype == torch.bfloat16
    assert tb["tokens"].shape == (2, specs.WHISPER_TEXT_LEN + 1)
    pb = specs.prefill_batch_specs(p, 4096, 2)
    assert pb["img_embeds"].shape == (2, p.n_img_tokens, p.d_model)
    assert pb["tokens"].shape == (2, 4096 - p.n_img_tokens)
    d = specs.decode_state_specs(w, 2, 64)
    assert d.cross_kv.shape == (2, specs.WHISPER_CROSS_LEN, w.d_model)
    cfg = dataclasses.replace(port_registry.smoke_config("minitron-4b"), param_dtype="bfloat16")
    assert {t.dtype for t in port_lm.tree_leaves(specs.params_specs(cfg))} == {torch.bfloat16}
