"""The port's sharding rules, mesh shapes, elastic plan and abstract specs
(``repro_torch/distributed/{sharding,elastic}.py``,
``repro_torch/launch/{mesh,specs}.py``) held against the JAX reference on
the CPU, with no process group:

* every leaf's spec -- parameters, AdamW and Adafactor states, decode
  caches and train batches of all ten configs, reduced and published --
  equals the reference's ``PartitionSpec`` on the meshes (2, 4), (4, 2),
  (8, 1), (1, 8) and (2, 2, 2), under both rule sets.  The reference's
  rules read only ``mesh.shape``, so a stand-in carrying that mapping
  needs no devices; its ``named_sharding`` is replaced by the spec it
  wraps;
* ``replan_mesh`` field by field over a grid;
* ``shard_leaf`` blocks, cut for every coordinate, tile the full leaf;
* the ``meta`` specs allocate nothing.
"""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_config as j_get_config
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.train import optimizers as jopt

from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeSpec, get_config
from repro_torch.convert import lm_params_to_reference
from repro_torch.distributed import elastic, sharding
from repro_torch.distributed.sharding import (LOGICAL_RULES, SERVING_RULES,
                                              shard_leaf)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models import lm
from repro_torch.train import optimizers as opt_mod
from repro_torch.tree import flatten_with_paths

MESHES = {"2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2},
          "8x1": {"data": 8, "model": 1}, "1x8": {"data": 1, "model": 8},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
RULES = {"logical": (LOGICAL_RULES, jsharding.LOGICAL_RULES),
         "serving": (SERVING_RULES, jsharding.SERVING_RULES)}


class StandIn:
    """What the reference's rules read of a ``Mesh``: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


class Spec:
    """A pytree leaf holding a spec as a tuple."""

    def __init__(self, spec):
        self.spec = tuple(spec)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``*_shardings`` returning their specs, each a
    ``Spec`` leaf, in place of ``NamedSharding``s."""
    monkeypatch.setattr(
        jsharding, "named_sharding",
        lambda shape, logical, mesh, rules=None: Spec(
            jsharding.spec_for_shape(shape, logical, mesh, rules)))
    return jsharding


def ref_paths(tree) -> dict:
    return {jsharding.path_to_str(path): leaf.spec
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def trees(name, reduced):
    """-> (reference abstract params, AdamW and Adafactor states, decode
    caches, train batch) and the port's (meta), in the reference's
    layout."""
    jcfg, cfg = j_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_to_reference(lm.abstract_params(cfg), cfg)
    shape = J_SHAPES["decode_32k"] if not reduced \
        else JShapeSpec("small", "decode", 64, 8)
    tshape = SHAPES["decode_32k"] if not reduced \
        else ShapeSpec("small", "decode", 64, 8)
    out = {"params": (jp, tp)}
    for opt in ("adamw", "adafactor"):
        out[opt] = (jax.eval_shape(jopt.get_optimizer(opt, 1e-3).init, jp),
                    opt_mod.get_optimizer(opt, 1e-3).init(tp))
    if jcfg.has_decode:
        out["caches"] = (jspecs.decode_input_specs(jcfg, shape)[0],
                         specs.decode_input_specs(cfg, tshape)[0])
    train_shape = J_SHAPES["train_4k"]
    out["batch"] = (jspecs.train_input_specs(jcfg, train_shape),
                    specs.train_input_specs(cfg, SHAPES["train_4k"]))
    return jcfg, cfg, out


def _cache_pairs(jcfg, jc, tc):
    """(reference path, port path) of every cache leaf: the stacked and
    per-layer layouts match path for path; the reference's period-scanned
    hybrid stacks period position j's layers under ``period/j``, the port
    keeps one cache a layer."""
    tpaths = flatten_with_paths(tc)
    if not jcfg.use_period_scan:
        return {p: p for p in tpaths}
    period, n_per, tail = jcfg.period_info
    plen = len(period)
    pairs = {}
    for path in tpaths:
        i, leaf = path.split("/", 1)
        i = int(i)
        ref = (f"period/{i % plen}/{leaf}" if i < n_per * plen
               else f"tail/{i - n_per * plen}/{leaf}")
        pairs[ref] = path
    return pairs


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_match_reference(name, reduced, mesh_name, ref_specs):
    jcfg, cfg, out = trees(name, reduced)
    shape = MESHES[mesh_name]
    jm = StandIn(shape)
    for rule_name, (rules, jrules) in RULES.items():
        for kind in ("params", "adamw", "adafactor"):
            jt, tt = out[kind]
            want = ref_specs.param_shardings(jt, jm, jrules)
            want = ref_paths(want)
            got = sharding.param_shardings(tt, shape, rules)
            assert got == want, (rule_name, kind)
    if "caches" in out:
        jc, tc = out["caches"]
        want = ref_paths(ref_specs.cache_shardings(jc, jm))
        got = sharding.cache_shardings(tc, shape)
        pairs = _cache_pairs(jcfg, jc, tc)
        assert set(pairs) == set(want)
        lead = 1 if jcfg.use_period_scan else 0
        for ref_path, port_path in pairs.items():
            w = want[ref_path]
            if lead and ref_path.startswith("period"):
                assert w[0] is None
                w = w[1:]
            assert got[port_path] == w, ref_path
    jb, tb = out["batch"]
    want = ref_paths(ref_specs.batch_shardings(jb, jm))
    assert sharding.batch_shardings(tb, shape) == want


@pytest.mark.parametrize("mesh_name", MESHES)
def test_spec_for_shape_matches_reference_on_a_grid(mesh_name):
    """Divisibility fallback, the prefix cut and no-axis-reuse on shapes
    made to hit them: every logical name pair over sizes 1-16."""
    shape = MESHES[mesh_name]
    jm = StandIn(shape)
    names = [None] + sorted(LOGICAL_RULES)
    rng = np.random.default_rng(0)
    for a, b in itertools.product(names, repeat=2):
        for _ in range(3):
            dims = tuple(int(x) for x in rng.integers(1, 17, 3))
            for rules, jrules in RULES.values():
                want = tuple(jsharding.spec_for_shape(dims, (a, b), jm,
                                                      jrules))
                assert sharding.spec_for_shape(dims, (a, b), shape,
                                               rules) == want


@pytest.mark.parametrize("path", [
    "embed", "layers/mixer/wq", "mu/layers/ffn/w_down", "v/embed/vr",
    "v/layers/mixer/wo/vc", "v/layers/ln1/v", "v/head/vr",
    "layers/ffn/we_gate", "v/layers/ffn/we_down/vc", "frontend/proj",
    "layers/mixer/conv_w", "step", "layers/period/0/mixer/w_out"])
def test_leaf_logical_matches_reference(path):
    for ndim in (1, 2, 3, 4):
        assert sharding._leaf_logical(path, ndim) == \
            jsharding._leaf_logical(path, ndim)


def test_replan_mesh_matches_reference():
    fields = ("mesh_shape", "axis_names", "microbatches", "note")
    n = 0
    for devices, mp, batch, micro, pods in itertools.product(
            (1, 2, 3, 4, 7, 8, 16, 24, 256, 511), (1, 2, 4, 8),
            (1, 6, 8, 12, 256), (1, 2), (1, 2)):
        try:
            want = jelastic.replan_mesh(devices, mp, batch, micro, pods)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                elastic.replan_mesh(devices, mp, batch, micro, pods)
            continue
        got = elastic.replan_mesh(devices, mp, batch, micro, pods)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f
        n += 1
    assert n > 200


def test_mesh_shapes_match_reference():
    for multi in (False, True):
        shape, names = tmesh.production_mesh_shape(multi_pod=multi)
        assert names == (("pod", "data", "model") if multi
                         else ("data", "model"))
        assert shape == ((2, 16, 16) if multi else (16, 16))
    for devices, mp, pods in ((8, 2, 1), (8, 1, 2), (8, 4, 2), (4, 4, 1)):
        shape, names = tmesh.mesh_shape_for(devices, mp, pods)
        assert np.prod(shape) == devices and shape[-1] == mp
        assert len(names) == len(shape)
    with pytest.raises(ValueError):
        tmesh.mesh_shape_for(6, 4)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_mesh_for(2, 1, device_type="cpu")


@pytest.mark.parametrize("spec,sizes", [
    ((None, "model"), {"data": 2, "model": 4}),
    (("data", "model"), {"data": 2, "model": 4}),
    ((("model", "data"), None), {"data": 2, "model": 4}),
    ((None, ("pod", "data"), "model"), {"pod": 2, "data": 2, "model": 2}),
    (("data",), {"data": 4, "model": 1}),
    ((), {"data": 2, "model": 2})])
def test_shard_leaf_blocks_tile_the_leaf(spec, sizes):
    """The blocks of every coordinate, placed by ``block_index``, rebuild
    the full leaf exactly, each block exactly its place's shape."""
    shape = (8, 16, 4) if len(spec) == 3 else (16, 8)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32
                        ).reshape(shape)
    spec = spec + (None,) * (full.dim() - len(spec))
    rebuilt = torch.full_like(full, -1.0)
    axes = list(sizes)
    for coord in itertools.product(*(range(sizes[a]) for a in axes)):
        coords = dict(zip(axes, coord))
        blk = shard_leaf(full, spec, sizes, coords)
        assert blk.is_contiguous()
        index = []
        for d, entry in enumerate(spec):
            i, n = sharding.block_index(entry, sizes, coords)
            size = full.shape[d] // n
            index.append(slice(i * size, (i + 1) * size))
        assert tuple(blk.shape) == tuple(x.stop - x.start for x in index)
        rebuilt[tuple(index)] = blk
    assert torch.equal(rebuilt, full)


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "kimi-k2-1t-a32b",
                                  "hubert-xlarge", "recurrentgemma-2b"])
def test_meta_specs_allocate_nothing(name):
    """Published sizes (kimi-k2's trillion parameters included) on the
    ``meta`` device: every leaf meta, the byte counts the reference's."""
    cfg, jcfg = get_config(name), j_get_config(name)
    params = specs.abstract_params(cfg)
    leaves = list(flatten_with_paths(params).values())
    assert all(x.is_meta for x in leaves)
    want = jspecs.param_bytes(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    assert specs.param_bytes(params) == want
    batch = specs.train_input_specs(cfg, SHAPES["train_4k"])
    jbatch = jspecs.train_input_specs(jcfg, J_SHAPES["train_4k"])
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batch.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jbatch.items()}
    assert all(v.is_meta for v in batch.values())
    if cfg.has_decode:
        caches, tok, pos = specs.decode_input_specs(cfg, SHAPES["decode_32k"])
        assert all(x.is_meta for x in flatten_with_paths(caches).values())
        assert tok.shape == (128, 1) and pos.shape == ()


def test_constrainer_keeps_the_reference_attributes():
    fn = sharding.make_constrainer(None)
    x = torch.ones(3)
    assert fn(x, "batch") is x
    assert fn.mesh is None and fn.moe_impl == "ep" and not fn.serving
    assert sharding.make_constrainer(None, rules=SERVING_RULES).serving
