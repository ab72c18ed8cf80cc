"""The port's mesh explorer and its dry-run layer against the reference, on
the CPU.

  * `parallel.sharding`: `rules_for_model` and `spec_for` equal the
    reference's for all ten archs on the four default topologies, for every
    param, optimizer and cache leaf (the reference's functions read only
    ``mesh.shape``, so a namespace stands in for its mesh);
    `Model.logical()` / `cache_logical_tree()` equal the reference's per
    leaf;
  * `launch.costparse`: the hand cases on a 2x4 fake mesh -- a matmul's
    per-device flops under two placements, the ring-factor link bytes of
    an all-gather, a reduce-scatter and an all-reduce, an all-to-all that
    DTensor inserts inside an op -- and, on a (1, 1) mesh, the dry-run's
    flops equal `FlopCounterMode` of the same step on plain CPU tensors;
  * `launch.dryrun.run_cell` at smoke width for one arch of each family x
    train / prefill / decode: the reference's record keys, the JSON cache
    read back without tracing again, the `SKIP_CELLS` records, and the CLI
    at published size on whisper-tiny x decode_32k;
  * `core.mesh_explorer`: `energy_proxy`, `variation_summary` and
    `explore_mesh_suite`'s picks equal the reference's on identical
    evaluations, and the entry points raise without a card unless asked
    for the CPU.

The fake process group is set up once for the module and torn down after
it, so no other test file on the worker sees a default group.
"""

import contextlib
import dataclasses
import io
import json
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as RCF
from repro.core import mesh_explorer as RMX
from repro.models.config import ParallelConfig as RPC
from repro.models.model import Model as RModel
from repro.parallel import sharding as RSH
from repro_torch import configs as PCF
from repro_torch.core import mesh_explorer as PMX
from repro_torch.launch import costparse as PC
from repro_torch.launch import dryrun as PD
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PS
from repro_torch.models.config import SHAPES, ParallelConfig, ShapeConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw as A
from repro_torch.parallel import sharding as PSH
from repro_torch.train.steps import make_train_step

CPU = "cpu"
#: the reference's default topologies as ``mesh.shape`` dicts
TOPOLOGIES = {
    "single-16x16": dict(data=16, model=16),
    "single-32x8": dict(data=32, model=8),
    "single-64x4": dict(data=64, model=4),
    "multi-2x16x16": dict(pod=2, data=16, model=16),
}
#: one arch of each family
FAMILIES = ("minicpm-2b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b",
            "whisper-tiny", "internvl2-2b")
#: the keys of the reference's dry-run record (`src/repro/launch/dryrun.py`)
RECORD_KEYS = {"arch", "shape", "mesh", "tag", "n_chips", "lower_s", "compile_s", "memory",
               "hbm_per_device_gb", "cost", "roofline", "n_collectives", "trip_counts"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "generated_code_size_in_bytes", "alias_size_in_bytes"}
#: small shapes for the smoke-width cells (the published ones trace 32k steps)
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 32, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32, 8, "decode"),
}


@pytest.fixture(scope="module")
def fake_group():
    PM.fake_world()
    yield
    PM.destroy_fake_world()


@pytest.fixture
def smoke_shapes(monkeypatch):
    for k, v in SMOKE_SHAPES.items():
        monkeypatch.setitem(SHAPES, k, v)


def _pc(shape: dict, ref: bool):
    axes = ("pod", "data") if "pod" in shape else ("data",)
    return (RPC if ref else ParallelConfig)(data_axes=axes)


def _leaves(tree, prefix=""):
    """(path, leaf) of nested dicts / lists with tuple leaves."""
    if isinstance(tree, tuple) or not isinstance(tree, (dict, list)):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))


def _ref_cache_logical(rm) -> dict:
    """The reference's cache logical tree, a recurrent kind's ``(conv,
    state)`` pair keyed as the port's dict."""
    out = {}
    for path, lg in jax.tree_util.tree_flatten_with_path(
            rm.cache_logical_tree(),
            is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(e, (str, type(None))) for e in x))[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-1] in ("0", "1"):
            keys[-1] = ("conv", "state")[int(keys[-1])]
        out[".".join(keys)] = lg
    return out


def _ref_cache_shapes(rm, b: int, s: int) -> dict:
    sds = jax.eval_shape(lambda: rm.init_cache(b, s))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-1] in ("0", "1"):
            keys[-1] = ("conv", "state")[int(keys[-1])]
        out[".".join(keys)] = tuple(leaf.shape)
    return out


# ---------------------------------------------------------------------------
# rules, specs and logical trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PCF.ARCH_IDS)
def test_rules_and_spec_for_match_the_reference(arch):
    rcfg, pcfg = RCF.get_config(arch), PCF.get_config(arch)
    rm = RModel(rcfg, RPC())
    pm = Model(pcfg, ParallelConfig(), device="meta")
    p_logical = dict(_leaves(pm.logical()))
    r_logical = dict(_leaves(rm.logical()))
    r_shapes = dict(_leaves(rm.param_shapes()))
    shape = SHAPES["decode_32k"]
    r_cache_lg = _ref_cache_logical(rm)
    r_cache_shapes = _ref_cache_shapes(rm, shape.global_batch, shape.seq_len)
    p_cache_lg = dict(_leaves(pm.cache_logical_tree()))
    assert p_cache_lg.keys() == r_cache_lg.keys() == r_cache_shapes.keys()
    for name, sizes in TOPOLOGIES.items():
        rmesh = types.SimpleNamespace(shape=dict(sizes))
        r_rules = RSH.rules_for_model(rcfg, _pc(sizes, True), rmesh)
        p_rules = PSH.rules_for_model(pcfg, _pc(sizes, False), sizes)
        assert p_rules == r_rules, name
        # params (and the optimizer's moments, placed like them)
        for path, shp in pm.param_shapes().items():
            want = tuple(RSH.spec_for(rmesh, r_shapes[path], r_logical[path], r_rules))
            assert PSH.spec_for(sizes, shp, p_logical[path], p_rules) == want, (name, path)
        assert PSH.spec_for(sizes, (), (), p_rules) == tuple(RSH.spec_for(rmesh, (), (), r_rules))
        # caches
        for path, shp in r_cache_shapes.items():
            want = tuple(RSH.spec_for(rmesh, shp, r_cache_lg[path], r_rules))
            assert PSH.spec_for(sizes, shp, p_cache_lg[path], p_rules) == want, (name, path)


@pytest.mark.parametrize("arch", PCF.ARCH_IDS)
def test_logical_trees_match_the_reference(arch):
    rm = RModel(RCF.get_config(arch), RPC())
    pm = Model(PCF.get_config(arch), ParallelConfig(), device="meta")
    assert dict(_leaves(pm.logical())) == dict(_leaves(rm.logical()))
    assert dict(_leaves(pm.cache_logical_tree())) == _ref_cache_logical(rm)
    # every stacked leaf leads with the layers axis, and a model on meta
    # allocates nothing
    for path, lg in _leaves(pm.logical()):
        names, scanned = pm._targets(path)
        assert (lg[0] == "layers") == scanned, path
    assert all(p.device.type == "meta" for p in pm.parameters())


def test_resolve_device_takes_meta_only_when_asked():
    from repro_torch.device import resolve_device

    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="meta"):
        PMX.explore_mesh("whisper-tiny", "decode_32k", device="meta")


def test_placements_and_tree_specs():
    sizes = TOPOLOGIES["single-16x16"]
    assert PSH.tree_specs(sizes, {"a": ("batch", None), "b": [("vocab", "embed")]},
                          {"a": (32, 4), "b": [(64, 48)]},
                          PSH.default_rules(ParallelConfig())) == {
        "a": ("data",), "b": [("model", "data")]}


# ---------------------------------------------------------------------------
# the fake group and its meshes
# ---------------------------------------------------------------------------


def test_fake_world_refuses_another_backend():
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo"):
            PM.fake_world()
    finally:
        dist.destroy_process_group()


def test_production_meshes(fake_group):
    single = PM.make_production_mesh()
    multi = PM.make_production_mesh(multi_pod=True)
    assert single.shape == (16, 16) and single.mesh_dim_names == ("data", "model")
    assert multi.shape == (2, 16, 16) and multi.mesh_dim_names == ("pod", "data", "model")
    assert PM.parallel_config_for(single).all_data_axes == ("data",)
    assert PM.parallel_config_for(multi).all_data_axes == ("pod", "data")
    explicit = PM.make_production_mesh(mesh_shape=(64, 4))
    assert explicit.shape == (64, 4) and explicit.size() == 256
    # the multi-pod DTensors live on its (pod*data, model) view
    cm = PSH.compute_mesh(multi)
    assert cm.shape == (32, 16) and PSH.mesh_axes(multi) == dict(pod=2, data=16, model=16)
    assert PSH.placements_for(multi, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(2))
    with pytest.raises(ValueError, match="together"):
        PSH.placements_for(multi, ("data",))
    t = PSH.sharded_zeros(multi, (64, 32), (("pod", "data"), "model"), torch.float32, "meta")
    assert t.to_local().shape == (2, 2) and t.shape == (64, 32)


@pytest.mark.parametrize("placements", [(Shard(0), Shard(1)), (Replicate(), Replicate()),
                                        (Replicate(), Shard(0))])
def test_softplus_backward_rule_on_the_fake_group(fake_group, placements):
    """`aten.softplus_backward` on a sharded DTensor keeps the placements
    and, stitched over every rank's shard, equals the plain op on the full
    tensor bit for bit (fp64).  The fake group runs rank 0 only, so each
    shard is put in turn as rank 0's local tensor: a pointwise op reads
    nothing of the mesh coordinate."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(scale=10.0, size=(8, 16)))  # past the threshold too
    grad = torch.from_numpy(rng.normal(size=(8, 16)))
    want = torch.ops.aten.softplus_backward(grad, x, 1.0, 20.0)
    splits = [1, 1]  # shards per tensor dim
    for p, n in zip(placements, mesh.shape):
        if isinstance(p, Shard):
            splits[p.dim] *= n
    rows = []
    for xr, gr in zip(x.chunk(splits[0], 0), grad.chunk(splits[0], 0)):
        cols = []
        for xs, gs in zip(xr.chunk(splits[1], 1), gr.chunk(splits[1], 1)):
            dx, dg = (DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                                         shape=x.shape, stride=x.stride()) for t in (xs, gs))
            out = torch.ops.aten.softplus_backward(dg, dx, 1.0, 20.0)
            assert out.placements == placements
            cols.append(out.to_local())
        rows.append(torch.cat(cols, 1))
    assert torch.equal(torch.cat(rows, 0), want)


@pytest.mark.parametrize("placements", [(Shard(0), Shard(2)), (Replicate(), Replicate()),
                                        (Shard(2), Shard(1))])
def test_constant_pad_nd_rule_on_the_fake_group(fake_group, placements):
    """`aten.constant_pad_nd` (the causal conv's left pad of the sequence,
    dim 1, with a non-zero value here) keeps a shard of an unpadded dim
    and, stitched over every rank's shard, equals the plain op on the full
    tensor bit for bit; a shard of the padded dim is gathered first, so
    the output is replicated there.  Ranks as in the softplus test."""
    import itertools

    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 8, 16)))
    pad = (0, 0, 3, 0)
    want = torch.ops.aten.constant_pad_nd(x, pad, 0.5)
    padded = any(p == Shard(1) for p in placements)
    kept = tuple(Replicate() if p == Shard(1) else p for p in placements)
    splits = [1, 1, 1]  # shards per tensor dim
    for p, n in zip(placements, mesh.shape):
        if isinstance(p, Shard):
            splits[p.dim] *= n
    for pos in itertools.product(*(range(n) for n in splits)):
        local = x
        for d, (i, n) in enumerate(zip(pos, splits)):
            local = local.chunk(n, d)[i]
        dx = DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                                shape=x.shape, stride=x.stride())
        out = torch.ops.aten.constant_pad_nd(dx, pad, 0.5)
        assert out.placements == kept and out.shape == want.shape
        if not padded:  # the fake group's gather fills no values to compare
            part = want
            for d, (i, n) in enumerate(zip(pos, splits)):
                part = part.chunk(n, d)[i]
            assert torch.equal(out.to_local(), part)


@pytest.mark.parametrize("placements", [(Shard(0), Shard(2)), (Shard(0), Replicate()),
                                        (Replicate(), Shard(3)), (Replicate(), Replicate())])
def test_ssd_scan_by_shard_on_the_fake_group(fake_group, placements):
    """`models.ssm._ssd_by_shard` on DTensors runs `_ssd_chunked` on each
    device's shard and places y and the state by x's placements; stitched
    over every rank's shard (each put in turn as rank 0's, as in the
    softplus test) it equals the scan of the full tensors (fp32, 1e-6).
    Backward: each operand's grad is sharded as the operand is, or
    ``Partial`` where the operand is replicated and x is sharded, and the
    rank-local grads, summed into their slices over every rank, equal the
    full tensors' grads (fp32, 1e-5: partial sums add in another order)."""
    import itertools

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models import ssm

    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(0)
    x, b, c = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((4, 16, 8, 4), (4, 16, 3), (4, 16, 3)))
    dt = torch.from_numpy(rng.uniform(0.1, 1.0, (4, 16, 8)).astype(np.float32))
    a = -torch.from_numpy(rng.uniform(0.5, 2.0, 8).astype(np.float32))
    gy, gs = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
              for sh in ((4, 16, 8, 4), (4, 8, 4, 3)))
    full = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    want_y, want_state = ssm._ssd_chunked(*full, chunk=8)
    ((want_y * gy).sum() + (want_state * gs).sum()).backward()
    want_grads = [t.grad for t in full]
    want_y, want_state = want_y.detach(), want_state.detach()
    ins, grads, outs = zip(*(ssm._ssd_placements(pl) for pl in placements))
    ways = {0: 1, 2: 1, 3: 1}  # shards of x's batch, head and head-dim axes
    for pl, m in zip(placements, mesh.shape):
        if isinstance(pl, Shard):
            ways[pl.dim] *= m
    #: each operand's axes as x's axes (None: not split by the scan)
    axes = ((0, None, 2, 3), (0, None, 2), (2,), (0, None, None), (0, None, None))
    got_grads = [torch.zeros_like(t) for t in want_grads]
    for pos in itertools.product(*(range(ways[d]) for d in (0, 2, 3))):
        at = dict(zip((0, 2, 3), pos))

        def part(t, dims):
            for axis, d in enumerate(dims):
                if d is not None:
                    t = t.chunk(ways[d], axis)[at[d]]
            return t

        dts = [DTensor.from_local(part(t, ax).contiguous(), mesh, pls, run_check=False,
                                  shape=t.shape, stride=t.stride()).requires_grad_()
               for t, ax, pls in zip((x, dt, a, b, c), axes, zip(*ins))]
        y, state = ssm._ssd_by_shard(*dts, chunk=8)
        assert y.placements == tuple(o[0] for o in outs)
        assert state.placements == tuple(o[1] for o in outs)
        assert (y.shape, state.shape) == (want_y.shape, want_state.shape)
        # fp32 einsums over fewer heads may block their sums differently
        torch.testing.assert_close(y.to_local(), part(want_y, (0, None, 2, 3)),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(state.to_local(), part(want_state, (0, 2, 3, None)),
                                   rtol=1e-6, atol=1e-6)
        ((y.to_local() * part(gy, (0, None, 2, 3))).sum()
         + (state.to_local() * part(gs, (0, 2, 3, None))).sum()).backward()
        for d, ax, pls, got in zip(dts, axes, zip(*grads), got_grads):
            assert d.grad.placements == pls
            part(got, ax).add_(d.grad.to_local())
    for got, want in zip(got_grads, want_grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the cost reader
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh24(fake_group):
    return PM.make_mesh((2, 4), ("data", "model"))


def test_costs_of_a_matmul_by_placement(mesh24):
    x = PSH.sharded_zeros(mesh24, (64, 2048), ("data",), torch.bfloat16, "meta")
    glob = 2 * 64 * 2048 * 4096
    for w_spec, ways in (((), 2), ((None, "model"), 8)):
        w = PSH.sharded_zeros(mesh24, (2048, 4096), w_spec, torch.bfloat16, "meta")
        with PC.CostMode() as cm:
            y = x @ w
        assert cm.cost.flops == glob / ways
        assert cm.cost.n_collectives == 0
        # the local shards read and the local output written
        assert cm.cost.hbm_bytes == 2 * (64 * 2048 / 2 + 2048 * 4096 / (ways // 2)
                                         + 64 * 4096 / ways)
        assert y.to_local().numel() == 64 * 4096 / ways


def test_costs_of_collectives(mesh24):
    a = PSH.sharded_zeros(mesh24, (64, 2048), (None, "model"), torch.float32, "meta")
    full = 64 * 2048 * 4  # bytes
    with PC.CostMode() as cm:
        a.redistribute(mesh24, [Replicate(), Replicate()])
    assert cm.cost.coll_by_kind == {"all-gather": 3 / 4 * full}
    p = DTensor.from_local(torch.empty(64, 2048, device="meta"), mesh24,
                           [Replicate(), Partial()], run_check=False)
    with PC.CostMode() as cm:
        p.redistribute(mesh24, [Replicate(), Replicate()])
    assert cm.cost.coll_by_kind == {"all-reduce": 2 * 3 / 4 * full}
    with PC.CostMode() as cm:
        p.redistribute(mesh24, [Replicate(), Shard(0)])
    assert cm.cost.coll_by_kind == {"reduce-scatter": 3 * full / 4}
    assert cm.cost.link_bytes == 3 * full / 4 and cm.cost.n_collectives == 1
    # inside an op: DTensor moves a's shards to b's placement (an all-to-all)
    b = PSH.sharded_zeros(mesh24, (64, 2048), ("model",), torch.float32, "meta")
    with implicit_replication(), PC.CostMode() as cm:
        c = a + b
    assert c.placements == (Replicate(), Shard(0))
    assert cm.cost.coll_by_kind == {"all-to-all": 3 / 4 * full / 4}
    assert cm.cost.flops == 0 and cm.cost.peak_bytes >= full / 4


def test_ring_factors_are_the_references():
    n, res = 16, 1024.0
    assert PC.collective_link_bytes("all-reduce", res, n) == 2 * 15 / 16 * res
    assert PC.collective_link_bytes("all-gather", res, n) == 15 / 16 * res
    assert PC.collective_link_bytes("reduce-scatter", res, n) == 15 * res
    assert PC.collective_link_bytes("all-to-all", res, n) == 15 / 16 * res
    assert PC.collective_link_bytes("collective-permute", res, n) == res


def test_peak_live_bytes_follow_frees():
    with PC.CostMode() as cm:
        a = torch.empty(1024, device="meta")
        b = a * 2  # 4 KiB live
        del b
        c = a + 1
        d = c[:10]  # a view: nothing new
    assert cm.cost.peak_bytes == 2 * 4096  # a and c, never b with both
    del a, c, d


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_on_a_one_device_mesh_equal_flop_counter(fake_group, smoke_shapes, kind):
    arch = "minicpm-2b"
    cfg = PCF.smoke_config(arch)
    shape = {"prefill": "prefill_32k", "train": "train_4k"}[kind]
    s = SHAPES[shape]
    mesh = PM.make_production_mesh(mesh_shape=(1, 1))
    cell = PS.CellSpec(arch, shape, mesh, cfg=cfg, q_chunk=16, kv_chunk=16)
    fn, args, _, _ = cell.step_fn_and_args()
    with implicit_replication(), PC.CostMode(device="meta") as cm:
        fn(*args)
    assert cm.cost.n_collectives == 0 and cm.cost.link_bytes == 0

    train = kind == "train"
    m = Model(cfg, ParallelConfig(remat="full"), q_chunk=16, kv_chunk=16, device=CPU,
              param_dtype=torch.float32 if train else torch.bfloat16)
    m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (s.global_batch, s.seq_len))
                            .astype(np.int32))
    batch = dict(tokens=toks)
    if train:
        batch.update(labels=toks.clone(), mask=torch.ones(toks.shape))
        step = make_train_step(m, A.constant_schedule(1e-4), A.AdamWConfig())
        params = m.train_params()
        run = lambda: step(params, A.adamw_init(params, A.AdamWConfig()), batch)
    else:
        run = lambda: m.prefill(batch)
    with FlopCounterMode(display=False) as fc:
        run()
    assert cm.cost.flops == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_records_and_cache(fake_group, smoke_shapes, tmp_path, monkeypatch, arch):
    cfg = PCF.smoke_config(arch)
    recs = {}
    for shape in SMOKE_SHAPES:
        # the recurrent families' train cells go through softplus_backward,
        # which takes the rule `parallel.sharding` registers
        rec = PD.run_cell(arch, shape, False, str(tmp_path), mesh_shape=(2, 4), tag="t",
                          overrides=dict(cfg=cfg, q_chunk=16, kv_chunk=16))
        assert set(rec) == RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS, shape
        r = rec["roofline"]
        assert rec["n_chips"] == 8 and rec["compile_s"] == 0.0
        assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["bottleneck"] in (
            "compute", "memory", "collective")
        mem = rec["memory"]
        assert mem["temp_size_in_bytes"] > 0 and mem["argument_size_in_bytes"] > 0
        donated = mem["alias_size_in_bytes"]
        assert (donated > 0) == (shape != "prefill_32k")
        assert rec["hbm_per_device_gb"] == round(
            (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**30, 3)
        scanned = {f"seg{i}": g.n_groups for i, g in enumerate(
            Model(cfg, device="meta").segments) if g.scanned}
        assert rec["trip_counts"] == scanned
        recs[shape] = rec
    # the JSON cache: read back, nothing traced
    monkeypatch.setattr(PS, "CellSpec", None)
    for shape, rec in recs.items():
        again = PD.run_cell(arch, shape, False, str(tmp_path), mesh_shape=(2, 4), tag="t")
        assert again == json.loads(json.dumps(rec))
    assert (tmp_path / f"{arch}__decode_32k__single__t.json").exists()


def test_skip_cells_write_their_record(tmp_path):
    (arch, shape), why = next(iter(PCF.SKIP_CELLS.items()))
    rec = PD.run_cell(arch, shape, True, str(tmp_path))
    assert rec == dict(arch=arch, shape=shape, mesh="multi", skipped=why)
    assert json.loads((tmp_path / f"{arch}__{shape}__multi.json").read_text()) == rec


def test_shard_grads_redistributes_the_grads(fake_group, smoke_shapes, tmp_path):
    cfg = PCF.smoke_config("minicpm-2b")
    kinds = {}
    for rs in (False, True):
        rec = PD.run_cell("minicpm-2b", "train_4k", False, str(tmp_path), mesh_shape=(2, 4),
                          tag=f"rs{rs}", overrides=dict(cfg=cfg, shard_grads=rs))
        kinds[rs] = rec["roofline"]["coll_breakdown"]
    # the grads' data-parallel reduction no longer lands as all-reduces
    assert kinds[True]["all-reduce"] < kinds[False]["all-reduce"]
    m = Model(cfg, device=CPU)
    with pytest.raises(ValueError, match="grad_shardings"):
        make_train_step(m, A.constant_schedule(1e-3), A.AdamWConfig(), grad_shardings={})


def test_dryrun_cli_at_published_size(fake_group, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        PD.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(tmp_path)])
    text = out.getvalue()
    assert "dry-run complete: 1 ok, 0 skipped, 0 FAILED" in text
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__single.json").read_text())
    assert rec["n_chips"] == 256 and rec["n_collectives"] > 0
    # bf16 params and the {k, v, xk, xv} caches, one device's shards
    assert rec["memory"]["argument_size_in_bytes"] < 2**30 < 28 * 2**30


# ---------------------------------------------------------------------------
# the explorer's selection
# ---------------------------------------------------------------------------


def _evals(pkg, n: int = 8, seed: int = 11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        roof = dict(flops=float(rng.uniform(1e15, 5e15)),
                    hbm_bytes=float(rng.uniform(1e12, 9e12)),
                    link_bytes=float(rng.uniform(1e11, 9e11)),
                    compute_s=0.0, memory_s=0.0, collective_s=0.0)
        rec = dict(roofline=roof, n_chips=(256, 512)[i % 2])
        out.append(pkg.MeshEvaluation(
            topo=f"t{i % 3}", recipe=f"r{i}", latency_s=float(rng.uniform(0.1, 2.0)),
            energy_j=pkg.energy_proxy(rec), hbm_gb=float(rng.uniform(4, 20)),
            fits=bool(i % 3), bottleneck="compute", record=rec))
    return out


def test_energy_proxy_and_constants_match_the_reference():
    for r, p in zip(_evals(RMX), _evals(PMX)):
        assert p.energy_j == r.energy_j
    assert PMX.constant_corners(0.3) == RMX.constant_corners(0.3)
    assert (PMX.HBM_GB, PMX.NOMINAL_CONSTANTS) == (RMX.HBM_GB, RMX.NOMINAL_CONSTANTS)
    assert [dataclasses.astuple(t) for t in PMX.DEFAULT_TOPOLOGIES] == [
        dataclasses.astuple(t) for t in RMX.DEFAULT_TOPOLOGIES]
    assert [r.overrides() | {"name": r.name} for r in PMX.DEFAULT_RECIPES] == [
        r.overrides() | {"name": r.name} for r in RMX.DEFAULT_RECIPES]


@pytest.mark.parametrize("max_latency_s", [None, 1.0])
def test_variation_summary_matches_the_reference(max_latency_s):
    """The port of ``tests/test_selection.py::
    test_mesh_variation_summary_matches_per_variant_loop`` on identical
    evaluations: the reference's summary and its per-variant loop."""
    variants = PMX.constant_corners(0.4)
    out = PMX.variation_summary(_evals(PMX), variants, max_latency_s, device=CPU)
    assert out == RMX.variation_summary(_evals(RMX), variants, max_latency_s)
    evals = _evals(RMX)
    fits = np.array([e.fits for e in evals])
    lat = np.array([e.latency_s for e in evals])
    for v, k in enumerate(variants):
        energy = np.array([e.record["n_chips"] * (
            e.record["roofline"]["flops"] * k["pj_per_flop"]
            + e.record["roofline"]["hbm_bytes"] * k["pj_per_hbm_byte"]
            + e.record["roofline"]["link_bytes"] * k["pj_per_link_byte"]) for e in evals])
        i = RMX.select_best(energy, fits, latency=lat, max_latency=max_latency_s)
        assert out["winners"][v] == dict(topo=evals[i].topo, recipe=evals[i].recipe)


def test_suite_picks_match_the_reference(monkeypatch):
    workloads = [("a0", "s0"), ("a1", "s1")]
    seeds = {"a0": 1, "a1": 2}
    monkeypatch.setattr(RMX, "_sweep_workload", lambda a, *_: _evals(RMX, seed=seeds[a]))
    monkeypatch.setattr(PMX, "_sweep_workload", lambda a, *_: _evals(PMX, seed=seeds[a]))
    kw = dict(max_latency_s=1.5, constant_sweep=PMX.constant_corners())
    want = RMX.explore_mesh_suite(workloads, **kw)
    assert PMX.explore_mesh_suite(workloads, device=CPU, **kw) == want
    for a, s in workloads:
        want = RMX.explore_mesh(a, s, **kw)
        assert PMX.explore_mesh(a, s, device=CPU, **kw) == want


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(PMX, "_sweep_workload", lambda *a: pytest.fail("swept"))
    with pytest.raises(RuntimeError, match="CUDA"):
        PMX.explore_mesh("whisper-tiny", "decode_32k")
    with pytest.raises(RuntimeError, match="CUDA"):
        PMX.explore_mesh_suite([("whisper-tiny", "decode_32k")])
    with pytest.raises(RuntimeError, match="CUDA"):
        PMX.variation_summary(_evals(PMX), PMX.constant_corners())


def test_explorer_cli_on_the_cpu(fake_group, smoke_shapes, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        PMX.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--device", CPU,
                  "--out", str(tmp_path), "--corner-spread", "0.25"])
    lines = out.getvalue().splitlines()
    assert sum(" lat=" in ln for ln in lines) == 24
    assert "constants sweep: best_yield=" in lines[-1]
