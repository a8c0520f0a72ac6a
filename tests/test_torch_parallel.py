# The port's parallel/ against the JAX package's, in one process: the mesh
# config's resolution, the sharding rules, shard_pytree's slices against
# JAX's NamedSharding on the 8 virtual CPU devices (tests/conftest.py) at
# every rank coordinate of dp2×tp2 and tp4 for dense, int8 and int4 trees,
# and the multihost config.
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.parallel import mesh as jmesh
from copilot_for_consensus_tpu.parallel import multihost as jmh
from copilot_for_consensus_tpu.parallel import sharding as jsh
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.parallel import mesh as tmesh
from copilot_for_consensus_tpu_torch.parallel import multihost as tmh
from copilot_for_consensus_tpu_torch.parallel import sharding as tsh

SETTINGS = [dict(), dict(tp=2), dict(dp=2), dict(dp=2, tp=2), dict(tp=4),
            dict(dp=0, tp=2), dict(dp=0, tp=4), dict(sp=2), dict(ep=2),
            dict(pp=2, tp=0), dict(dp=3), dict(dp=2, tp=3),
            dict(dp=0, tp=3), dict(tp=8), dict(dp=1, tp=1)]


def _resolve(cls, kw, n):
    try:
        return cls(**kw).resolve(n).shape
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", SETTINGS, ids=str)
def test_mesh_config_resolves_as_jax(kw, n):
    assert _resolve(tmesh.MeshConfig, kw, n) == \
        _resolve(jmesh.MeshConfig, kw, n)


def test_mesh_axes_and_pow2_helper_match_jax():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    for n in range(0, 20):
        assert tmesh.largest_pow2_leq(n) == jmesh.largest_pow2_leq(n)


def test_one_rank_mesh_needs_no_process_group():
    m = tmesh.build_mesh()
    assert m.size == 1 and dict(m.shape) == dict.fromkeys(tmesh.MESH_AXES, 1)
    assert all(m.group(ax) is None for ax in tmesh.MESH_AXES)
    assert m.world is None and m.axis_names == tmesh.MESH_AXES
    with pytest.raises(ValueError):
        tmesh.build_mesh(tmesh.MeshConfig(tp=2))
    with pytest.raises(KeyError):
        m.group("xp")


@pytest.mark.parametrize("axes", [("vocab", "embed"), (None, "heads"),
                                  ("batch", "kv_heads", None),
                                  ("experts", "embed", "expert_ffn")])
def test_logical_to_spec_matches_jax(axes):
    assert tsh.logical_to_spec(axes) == tuple(jsh.logical_to_spec(axes))


def test_logical_to_spec_unknown_axis_raises():
    with pytest.raises(KeyError, match="unknown logical axis 'embd'"):
        tsh.logical_to_spec(("embd",))
    with pytest.raises(KeyError):
        jsh.logical_to_spec(("embd",))


class _Shape:
    """What the rule helpers read of a mesh."""

    def __init__(self, tp):
        self.shape = {"dp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": tp}


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["tiny", "mistral-7b"])
def test_serving_param_rules_match_jax(name, tp):
    got = tsh.serving_param_rules(decoder_config(name), _Shape(tp))
    assert got == jsh.serving_param_rules(jax_config(name), _Shape(tp))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_logical_axes_against_jax(mode):
    cfg = decoder_config("tiny")
    got = tquant.quantize_logical_axes(tdec.logical_axes(cfg), mode=mode)
    want = jquant.quantize_logical_axes(jdec.logical_axes(jax_config("tiny")),
                                        mode=mode)
    for path in tquant.DECODER_QUANT_LEAVES:
        g, w = got, want
        for p in path:
            g, w = g[p], w[p]
        key = "q4" if mode == "int4" else "q"
        assert g[key] == w[key]
        if mode == "int8":
            assert g["scale"] == w["scale"]
        else:
            # the group axis shards like the rows it scales (a rank
            # multiplies its own rows); JAX replicates it
            assert g["scale"] == g[key]
            assert w["scale"] == tuple(None if i == len(w[key]) - 2 else a
                                       for i, a in enumerate(w[key]))


def test_logical_axes_match_jax():
    for name in ("tiny", "tiny-moe"):
        assert tdec.logical_axes(decoder_config(name)) == \
            jdec.logical_axes(jax_config(name))
    assert tdec.cache_logical_axes() == jdec.cache_logical_axes()


def _tree(kind: str):
    cfg = decoder_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(3), jax_config("tiny"),
                          dtype=jnp.float32)
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "float32")
    if kind == "int8":
        tree = tquant.quantize_params(tree, mode="int8")
    elif kind == "int4":
        # 32-row groups: every row-parallel leaf's G divides tp 4
        tree = tquant.quantize_params(tree, mode="int4", group=32)
    return cfg, tree


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


MESH_CASES = [("dp2tp2", dict(dp=2, tp=2)), ("tp4", dict(tp=4))]


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("label,shape", MESH_CASES, ids=[c[0] for c in
                                                          MESH_CASES])
def test_shard_pytree_matches_named_sharding(label, shape, kind):
    cfg, tree = _tree(kind)
    n = int(np.prod(list(shape.values())))
    jm = jmesh.build_mesh(jmesh.MeshConfig(**shape),
                          devices=jax.devices()[:n])
    rcfg = tmesh.MeshConfig(**shape).resolve(n)
    rules = tsh.serving_param_rules(cfg, _Shape(rcfg.tp))
    axes = tdec.param_logical_axes(cfg, tree)
    specs = tsh.spec_tree(axes, rules)
    pieces = {path: [] for path, _ in _leaves(tree)}
    for coord in itertools.product(*(range(s) for s in rcfg.shape)):
        coords = dict(zip(tmesh.MESH_AXES, coord))
        view = tmesh.Mesh(rcfg, coords=coords, device="cpu")
        shards = tsh.shard_pytree(tree, axes, view, rules)
        dev = jm.devices[coord]
        for path, leaf in _leaves(tree):
            spec = _get(specs, path)
            shard = _get(shards, path)
            named = NamedSharding(jm, PartitionSpec(*spec))
            assert tuple(shard.shape) == named.shard_shape(leaf.shape), path
            want = named.devices_indices_map(leaf.shape)[dev]
            got = tsh.shard_slices(leaf.shape, spec, view)
            assert [s.indices(d) for s, d in zip(got, leaf.shape)] == \
                [s.indices(d) for s, d in zip(want, leaf.shape)], path
            assert torch.equal(shard, leaf[got]), path
            pieces[path].append((got, shard))
    # the shards put back together are the leaf
    for path, leaf in _leaves(tree):
        back = torch.empty_like(leaf)
        for sl, shard in pieces[path]:
            back[sl] = shard
        assert torch.equal(back, leaf), path


def test_int4_row_parallel_shard_that_splits_a_group_raises():
    cfg, tree = _tree("int4")
    whole = tquant.quantize_params(_tree("dense")[1], mode="int4")  # G = 1
    rcfg = tmesh.MeshConfig(tp=2).resolve(2)
    view = tmesh.Mesh(rcfg, coords={"tp": 1}, device="cpu")
    rules = tsh.serving_param_rules(cfg, view)
    with pytest.raises(ValueError, match="do not divide"):
        tsh.shard_pytree(whole, tdec.param_logical_axes(cfg, whole), view,
                         rules)
    shards = tsh.shard_pytree(tree, tdec.param_logical_axes(cfg, tree), view,
                              rules)
    wo = shards["layers"]["wo"]
    assert wo["q4"].shape == (2, 32, 128) and wo["scale"].shape == (2, 2, 128)
    assert wo["q4"].dtype == torch.int8


def test_whole_leaf_on_its_device_is_not_copied():
    _, tree = _tree("dense")
    view = tmesh.Mesh(tmesh.MeshConfig().resolve(1), device="cpu")
    out = tsh.shard_pytree(tree, tdec.logical_axes(decoder_config("tiny")),
                           view)
    assert out["layers"]["wq"] is tree["layers"]["wq"]


def test_params_from_numpy_cuts_the_shard_before_the_copy():
    cfg = decoder_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(3), jax_config("tiny"),
                          dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    view = tmesh.Mesh(tmesh.MeshConfig(tp=2).resolve(2), coords={"tp": 1},
                      device="cpu")
    out = params_from_numpy(tree, "cpu", "float32", mesh=view, cfg=cfg)
    assert out["tok_emb"].shape == (256, 128)
    assert torch.equal(out["tok_emb"],
                       torch.from_numpy(np.array(tree["tok_emb"][256:])))
    assert out["layers"]["wo"].shape == (2, 64, 128)
    with pytest.raises(ValueError, match="cfg"):
        params_from_numpy(tree, "cpu", "float32", mesh=view)


def test_local_config_and_kv_selection():
    cfg = decoder_config("tiny")                  # 4 q heads over 2 kv
    for tp, rank, want_kv in ((2, 1, 1), (4, 0, 0), (4, 1, 0), (4, 2, 1),
                              (4, 3, 1)):
        rules = tsh.serving_param_rules(cfg, _Shape(tp))
        local = tdec.local_config(cfg, tp, rules)
        assert local.n_heads == 4 // tp and local.head_dim == 32
        assert local.n_kv_heads == 1 and local.d_ff == 256 // tp
        if tp == 4:
            assert rules["kv_heads"] is None
            _, tree = _tree("dense")
            got = tdec.select_kv_heads(tree, cfg, tp, rank)
            # q head `rank` groups to kv head rank // 2
            assert torch.equal(got["layers"]["wk"],
                               tree["layers"]["wk"][..., want_kv * 32:
                                                    (want_kv + 1) * 32])
    with pytest.raises(NotImplementedError):
        tdec.local_config(cfg, 8, tsh.serving_param_rules(cfg, _Shape(8)))


CONFIG_CASES = [
    {"coordinator_address": "10.0.0.1:8476", "num_processes": 4,
     "process_id": 2},
    {"coordinator_address": "x:1"},
    {"coordinator_address": "x:1", "num_processes": 2, "process_id": 2},
    {"coordinator_address": "x:1", "num_processes": 2, "process_id": 1,
     "local_device_ids": [1]},
    {}, True, None,
    {"num_processes": 4, "process_id": 2},
    {"local_device_ids": [0]},
]


def _validate(cls, cfg):
    c = cls.from_config(cfg)
    try:
        c.validate()
        return (c.is_explicit, c.coordinator_address, c.num_processes,
                c.process_id, c.local_device_ids)
    except ValueError as exc:
        return ("ValueError", str(exc).split(" — ")[0])


@pytest.mark.parametrize("cfg", CONFIG_CASES, ids=str)
def test_multihost_config_parses_and_validates_as_jax(cfg):
    assert _validate(tmh.MultiHostConfig, cfg) == \
        _validate(jmh.MultiHostConfig, cfg)


def test_single_process_explicit_is_noop():
    assert tmh.initialize_multihost({
        "coordinator_address": "127.0.0.1:1", "num_processes": 1,
        "process_id": 0}) is False
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    assert not tmh.is_multihost()


def test_nccl_join_without_a_card_raises(monkeypatch):
    # NCCL is the default; the CPU's gloo is taken only when named
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tmh.initialize_multihost({
            "coordinator_address": "127.0.0.1:1", "num_processes": 2,
            "process_id": 0})
    assert not tmh.is_multihost()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend 'mpi'"):
        tmh.initialize_multihost(None, backend="mpi")
