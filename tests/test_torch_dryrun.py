"""The port's dry-run (``repro_torch/launch/dryrun.py``) and the GEE fold's
lowering (``repro_torch/core/distributed.py::lower_gee_distributed``) held
against the JAX reference on the CPU.

(a) the census: the port's ring wire-byte model over recorded collectives
    equals the reference's ``collective_census`` of the same collectives
    rendered as HLO lines, exactly;
(b) each runnable cell's ``meta`` at published widths (parameters, their
    bytes, the optimizer state's and the caches' bytes, the optimizer,
    microbatches and remat) equals the reference's, computed with
    ``jax.eval_shape`` (no device);
(c) every leaf's per-rank block on meshes (2, 4) and (2, 2, 2) equals
    ``NamedSharding(mesh, spec).shard_shape`` of the reference's spec, in
    a subprocess of 8 fake XLA devices;
(d) the FLOPs counted on a reduced dense train step equal its closed-form
    matmul count, and a prefill's (its attention's block count reckoned
    from the first row of blocks) on both block schedules; a train step of
    4 microbatches traced at 2 and reckoned records and counts what the
    whole trace does;
(e) a fake-group trace records the collectives that real gloo ranks
    record for the same reduced step (ops, counts, payload bytes);
(f) ``lower_gee_distributed`` gives the reference's collectives (its
    lowering compiled under 8 fake XLA devices);
(h) the CLI traces ``qwen3-0.6b x train_4k`` on 16 x 16 with status ok.

A fake process group cannot share a process with a real one, so each
trace runs in a subprocess of its own.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from conftest import run_with_devices

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPAWN_TIMEOUT_S = 300


def _python(code: str, timeout: int = 300) -> str:
    """Run ``code`` in a fresh interpreter (the port on ``PYTHONPATH``)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"rc={proc.returncode}\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# (a) the census
# ---------------------------------------------------------------------------

_HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float64": "f64",
              "int32": "s32", "int64": "s64", "float16": "f16",
              "uint8": "u8", "int8": "s8"}
_ELEM = {"f32": 4, "bf16": 2, "f64": 8, "s32": 4, "s64": 8, "f16": 2,
         "u8": 1, "s8": 1}

CENSUS_CASES = [
    [{"op": "all-reduce", "dtype": "float32", "shape": [1024], "group": 16}],
    [{"op": "all-gather", "dtype": "bfloat16", "shape": [512, 8], "group": 8},
     {"op": "all-gather", "dtype": "float32", "shape": [3, 5], "group": 2}],
    [{"op": "reduce-scatter", "dtype": "float32", "shape": [64], "group": 4},
     {"op": "all-to-all", "dtype": "float32", "shape": [32, 16], "group": 4},
     {"op": "collective-permute", "dtype": "float32", "shape": [8],
      "group": 2}],
    [{"op": "all-reduce", "dtype": "float64", "shape": [1000], "group": 8},
     {"op": "reduce-scatter", "dtype": "float64", "shape": [125, 4],
      "group": 8},
     {"op": "all-reduce", "dtype": "bfloat16", "shape": [2, 1, 4096],
      "group": 256},
     {"op": "all-to-all", "dtype": "bfloat16", "shape": [16, 12, 2048],
      "group": 16}],
]


def _records(case):
    return [{"op": c["op"], "group_size": c["group"],
             "payload_bytes": int(np.prod(c["shape"]))
             * _ELEM[_HLO_DTYPE[c["dtype"]]]} for c in case]


def _hlo(case) -> str:
    lines = ["HloModule census"]
    for i, c in enumerate(case):
        dt = _HLO_DTYPE[c["dtype"]]
        dims = ",".join(str(d) for d in c["shape"])
        g = c["group"]
        lines.append(f"  %c{i} = {dt}[{dims}]{{0}} {c['op']}(%x{i}), "
                     f"replica_groups=[{1024 // g},{g}]<=[1024]")
    return "\n".join(lines)


@pytest.mark.parametrize("case", range(len(CENSUS_CASES)))
def test_census_equals_the_reference(case):
    from repro.launch.dryrun import collective_census

    from repro_torch.launch.dryrun import census

    got = census(_records(CENSUS_CASES[case]))
    want = collective_census(_hlo(CENSUS_CASES[case]), default_group=512)
    assert set(got) == set(want)
    for op, v in want.items():
        if isinstance(v, dict):
            assert got[op]["count"] == v["count"], op
            assert got[op]["payload_bytes"] == v["payload_bytes"], op
            assert got[op]["wire_bytes"] == v["wire_bytes"], op
    assert got["total_wire_bytes"] == want["total_wire_bytes"]


def test_knobs_are_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch import dryrun as jdry

    from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
    from repro_torch.launch import dryrun

    for arch in ARCH_NAMES:
        for s in SHAPES:
            cfg, jcfg = get_config(arch), jget(arch)
            assert dryrun.choose_optimizer(cfg) == jdry.choose_optimizer(jcfg)
            assert dryrun.choose_microbatches(cfg, SHAPES[s]) \
                == jdry.choose_microbatches(jcfg, JSHAPES[s])
            assert dryrun.choose_remat(cfg, SHAPES[s]) \
                == jdry.choose_remat(jcfg, JSHAPES[s])


# ---------------------------------------------------------------------------
# (b) meta
# ---------------------------------------------------------------------------

def _runnable():
    from repro_torch.configs import all_cells

    return [(a, s) for a, s, ok, _ in all_cells() if ok]


def _reference_meta(arch, shape_name):
    import jax

    from repro.configs import SHAPES, get_config
    from repro.launch import dryrun as jdry
    from repro.launch import specs
    from repro.train.optimizers import get_optimizer

    cfg, shape = get_config(arch), SHAPES[shape_name]
    p_abs = specs.abstract_params(cfg)
    meta = {"params": int(sum(x.size for x in jax.tree.leaves(p_abs))),
            "param_bytes": specs.param_bytes(p_abs),
            "remat": jdry.choose_remat(cfg, shape)}
    if shape.kind == "train":
        name = jdry.choose_optimizer(cfg)
        o_abs = jax.eval_shape(get_optimizer(name, 1e-4).init, p_abs)
        meta.update(optimizer=name,
                    microbatches=jdry.choose_microbatches(cfg, shape),
                    opt_state_bytes=specs.param_bytes(o_abs))
    elif shape.kind == "decode":
        caches, _, _ = specs.decode_input_specs(cfg, shape)
        meta["cache_bytes"] = specs.param_bytes(caches)
    return meta


def test_thirty_one_runnable_cells():
    assert len(_runnable()) == 31


@pytest.mark.parametrize("arch,shape_name", _runnable())
def test_cell_meta_equals_the_references(arch, shape_name):
    from repro_torch.launch.dryrun import cell_meta

    got = cell_meta(arch, shape_name, {"data": 16, "model": 16})
    want = _reference_meta(arch, shape_name)
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)
    assert got["mesh"] == {"data": 16, "model": 16}


# ---------------------------------------------------------------------------
# (c) per-rank blocks
# ---------------------------------------------------------------------------

BLOCK_ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "mamba2-2.7b",
               "recurrentgemma-2b", "qwen2-vl-72b", "chatglm3-6b",
               "kimi-k2-1t-a32b", "hubert-xlarge")
BLOCK_MESHES = {"2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _port_blocks():
    """{mesh: {arch/tree/path: block shape}}: parameters under both rule
    sets, decode caches, from the port's specs."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.distributed.sharding import (SERVING_RULES,
                                                  block_shape,
                                                  cache_shardings,
                                                  param_shardings)
    from repro_torch.launch import specs
    from repro_torch.tree import flatten_with_paths

    out = {}
    for tag, (shape, names) in BLOCK_MESHES.items():
        sizes = dict(zip(names, shape))
        got = {}
        for arch in BLOCK_ARCHS:
            cfg = get_config(arch)
            p_abs = lm_params_to_reference(specs.abstract_params(cfg), cfg)
            trees = {"train": (p_abs, param_shardings(p_abs, sizes)),
                     "serve": (p_abs, param_shardings(p_abs, sizes,
                                                      SERVING_RULES))}
            if cfg.has_decode:
                caches, _, _ = specs.decode_input_specs(cfg,
                                                        SHAPES["decode_32k"])
                trees["cache"] = (caches, cache_shardings(caches, sizes))
            for t, (tree, sp) in trees.items():
                for path, x in flatten_with_paths(tree).items():
                    got[f"{arch}/{t}/{_reference_path(cfg, t, path)}"] = \
                        _stack_of(cfg, t, path) + list(block_shape(
                            tuple(x.shape), sp[path], sizes))
        out[tag] = got
    return out


def _reference_path(cfg, tree: str, path: str) -> str:
    """A port cache path (one cache a layer) as the reference names it:
    a period-scanned hybrid stacks its caches by pattern position
    (``period/<j>/...``) with the tail apart (``tail/<i>/...``)."""
    if tree != "cache" or not cfg.use_period_scan:
        return path
    period, n_per, _ = cfg.period_info
    i, rest = path.split("/", 1)
    i, plen = int(i), len(period)
    if i < n_per * plen:
        return f"period/{i % plen}/{rest}"
    return f"tail/{i - n_per * plen}/{rest}"


def _stack_of(cfg, tree: str, path: str) -> list:
    if tree != "cache" or not cfg.use_period_scan:
        return []
    period, n_per, _ = cfg.period_info
    return [n_per] if int(path.split("/", 1)[0]) < n_per * len(period) \
        else []


REFERENCE_BLOCKS = """
import json
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.distributed.sharding import (SERVING_RULES, cache_shardings,
                                        param_shardings)
from repro.launch import specs
from repro.distributed.sharding import path_to_str

ARCHS = {archs!r}
MESHES = {meshes!r}
out = {{}}
for tag, (shape, names) in MESHES.items():
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    got = {{}}
    for arch in ARCHS:
        cfg = get_config(arch)
        p_abs = specs.abstract_params(cfg)
        trees = {{"train": (p_abs, param_shardings(p_abs, mesh)),
                  "serve": (p_abs, param_shardings(p_abs, mesh,
                                                   SERVING_RULES))}}
        if cfg.has_decode:
            caches, _, _ = specs.decode_input_specs(cfg,
                                                    SHAPES["decode_32k"])
            trees["cache"] = (caches, cache_shardings(caches, mesh))
        for t, (tree, sh) in trees.items():
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            shs = jax.tree.leaves(sh, is_leaf=lambda s: isinstance(
                s, NamedSharding))
            for (path, x), s in zip(leaves, shs):
                got[f"{{arch}}/{{t}}/{{path_to_str(path)}}"] = list(
                    s.shard_shape(x.shape))
    out[tag] = got
print(json.dumps(out))
"""


def test_per_rank_blocks_equal_the_references_shard_shapes():
    code = REFERENCE_BLOCKS.format(archs=BLOCK_ARCHS, meshes={
        k: (list(v[0]), list(v[1])) for k, v in BLOCK_MESHES.items()})
    want = _last_json(run_with_devices(code, 8))
    got = _port_blocks()
    for tag in BLOCK_MESHES:
        assert set(got[tag]) == set(want[tag]), tag
        bad = {k: (got[tag][k], want[tag][k]) for k in want[tag]
               if got[tag][k] != want[tag][k]}
        assert not bad, (tag, dict(list(bad.items())[:8]))


# ---------------------------------------------------------------------------
# (d) FLOPs
# ---------------------------------------------------------------------------

FLOPS_CODE = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), remat="none")
with dryrun.fake_world(1):
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    out = dryrun.trace_cell("qwen3-0.6b", ShapeSpec("t", "train", {s}, {b}),
                            mesh, config=cfg, microbatches=1, remat="none")
print(json.dumps({{"flops": out["flops"], "n": len(out["records"])}}))
"""


def test_counted_flops_equal_the_closed_form():
    """A reduced qwen3 train step, no remat, one block of attention: every
    product forward (the q/k/v/o projections, the GLU's three, the
    masked schedule's QK^T and PV over S x S, the tied head) and twice
    that backward."""
    from repro_torch.configs import get_config

    b, s = 4, 16
    cfg = get_config("qwen3-0.6b").reduced()
    out = _last_json(_python(FLOPS_CODE.format(b=b, s=s)))
    t, d, h, kv = b * s, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, f, v = cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab
    layer = (2 * t * d * h * hd * 2 + 2 * t * d * kv * hd * 2
             + 3 * 2 * t * d * f + 2 * 2 * b * h * s * s * hd)
    forward = cfg.num_layers * layer + 2 * t * d * v
    assert out["flops"] == 3 * forward
    assert out["n"] == 0                      # a mesh of one: no collective


PREFILL_CODE = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
cfg = get_config("qwen3-0.6b").reduced()
out = {{}}
with dryrun.fake_world(1):
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    for impl in ("masked", "triangular"):
        out[impl] = dryrun.trace_cell(
            "qwen3-0.6b", ShapeSpec("p", "prefill", {s}, {b}), mesh,
            config=cfg, attn_impl=impl)["flops"]
print(json.dumps(out))
"""


def test_prefill_flops_equal_the_closed_form():
    """A reduced qwen3 prefill of four 512-position chunks: the tracer runs
    the first Q chunk's row of blocks and reckons the rest, so the count
    must be the closed form's: every projection and GLU product, the head
    over every position, and QK^T and PV over 16 blocks (masked) or the
    10 of the lower triangle (triangular)."""
    from repro_torch.configs import get_config

    b, s, c = 2, 2048, 512
    cfg = get_config("qwen3-0.6b").reduced()
    out = _last_json(_python(PREFILL_CODE.format(b=b, s=s)))
    t, d, h, kv = b * s, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, f, v = cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab
    linear = (cfg.num_layers * (2 * t * d * h * hd * 2
                                + 2 * t * d * kv * hd * 2 + 3 * 2 * t * d * f)
              + 2 * t * d * v)
    block = 2 * 2 * b * h * c * c * hd
    n = s // c
    assert out["masked"] == linear + cfg.num_layers * n * n * block
    assert out["triangular"] == (linear + cfg.num_layers
                                 * n * (n + 1) // 2 * block)


MICRO_CODE = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
cfg = get_config("qwen3-0.6b").reduced()
out = {{}}
with dryrun.fake_world(4):
    mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
    for remat in ("none", "full"):
        for traced in (2, 4):
            got = dryrun.trace_cell(
                "qwen3-0.6b", ShapeSpec("t", "train", {s}, {b}), mesh,
                config=cfg, microbatches=4, remat=remat, optimizer="adamw",
                traced_microbatches=traced)
            out[f"{{remat}}/{{traced}}"] = [got["flops"], got["records"]]
print(json.dumps(out))
"""


def test_reckoned_microbatches_equal_the_whole_trace():
    """A reduced qwen3 step of 4 microbatches on (2, 2), without and with
    remat: traced at 2 microbatches with the second one's records and
    FLOPs added twice more, it records the collectives (op, payload,
    group, in order) and counts the FLOPs of all 4 traced."""
    out = _last_json(_python(MICRO_CODE.format(b=16, s=16)))
    for remat in ("none", "full"):
        (f2, r2), (f4, r4) = out[f"{remat}/2"], out[f"{remat}/4"]
        assert len(r4) > 0
        assert f2 == f4, (remat, f2, f4)
        assert r2 == r4, remat


# ---------------------------------------------------------------------------
# (e) a fake trace against real gloo ranks
# ---------------------------------------------------------------------------

E_MESH, E_B, E_S = (2, 2), 4, 16


def _e_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               remat="none")


def _real_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.distributed.tensor_parallel import ShardedLM, shard_tree
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.launch.dryrun import CollectiveRecorder
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train import optimizers as opt_mod

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        cfg = _e_config()
        mesh = make_mesh_for(world, E_MESH[1], device_type="cpu")
        params = lm_params_to_reference(lm.init_params(cfg, 0,
                                                       device="cpu"), cfg)
        shard = ShardedLM(cfg, mesh)
        blocks = shard_tree(params, shard.param_specs, mesh)
        opt = opt_mod.get_optimizer("adamw", 1e-4, layout=shard.layout,
                                    inplace=True)
        state = opt.init(blocks)
        step = loop.make_train_step(cfg, opt, shard=shard)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (E_B, E_S))}
        with CollectiveRecorder() as rec:
            step(blocks, state, batch)
        if rank == 0:
            with open(os.path.join(out_dir, "real.json"), "w") as f:
                json.dump(rec.records, f)
    finally:
        dist.destroy_process_group()


FAKE_CODE = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), remat="none")
with dryrun.fake_world({world}):
    mesh = dryrun.fake_mesh({mesh}, ("data", "model"))
    out = dryrun.trace_cell("qwen3-0.6b", ShapeSpec("t", "train", {s}, {b}),
                            mesh, config=cfg, microbatches=1, remat="none",
                            optimizer="adamw")
print(json.dumps(out["records"]))
"""


def _key(r):
    return (r["op"], r["payload_bytes"], r["group_size"])


def test_fake_trace_records_what_real_ranks_do(tmp_path):
    world = E_MESH[0] * E_MESH[1]
    ctx = mp.start_processes(
        _real_rank, args=(world, str(tmp_path / "store"), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the gloo ranks did not finish")
    with open(tmp_path / "real.json") as f:
        real = json.load(f)
    fake = _last_json(_python(FAKE_CODE.format(
        world=world, mesh=E_MESH, b=E_B, s=E_S)))
    assert len(real) > 0
    assert sorted(map(_key, fake)) == sorted(map(_key, real))
    assert [r["op"] for r in fake] == [r["op"] for r in real]


# ---------------------------------------------------------------------------
# (f) the GEE fold's lowering
# ---------------------------------------------------------------------------

REF_GEE = """
import json, re
import jax
from repro.core.distributed import lower_gee_distributed
from repro.core.gee import GEEOptions
from repro.launch.dryrun import COLLECTIVE_OPS, _shape_bytes
mesh = jax.make_mesh((8,), ('data',))
out = {}
for lap in (True, False):
    txt = lower_gee_distributed(mesh, ('data',), num_nodes=1000,
                                num_edges=20000, num_classes=4,
                                opts=GEEOptions(laplacian=lap)
                                ).compile().as_text()
    found = []
    for line in txt.splitlines():
        m = re.match(r"(?:ROOT )?%?[\\w.\\-]+ = (\\S+) ([a-z\\-]+)\\(",
                     line.strip())
        if m and m.group(2) in COLLECTIVE_OPS:
            found.append([m.group(2), _shape_bytes(m.group(1))])
    out[str(lap)] = found
print(json.dumps(out))
"""

PORT_GEE = """
import json
from repro_torch.core.distributed import lower_gee_distributed
from repro_torch.core.gee import GEEOptions
from repro_torch.launch import dryrun
out = {}
with dryrun.fake_world(8):
    mesh = dryrun.fake_mesh((8,), ("data",))
    for lap in (True, False):
        low = lower_gee_distributed(mesh, ("data",), 1000, 20000, 4,
                                    GEEOptions(laplacian=lap))
        out[str(lap)] = {"records": low["records"],
                         "collectives": low["collectives"],
                         "bytes": low["bytes_per_rank"]}
print(json.dumps(out))
"""


def test_gee_lowering_has_the_references_collectives():
    """Each of the reference's collectives (the all-reduce of the f32
    degrees with the Laplacian, the reduce-scatter of the f32 [N, K]
    partial) is the port's, with as many elements: the port sums in
    float64 (ROADMAP F2), so its payload bytes are twice the reference's.
    XLA's CPU lowering may render a reduce-scatter as an all-reduce of
    the whole [N, K] (``tests/test_gee_distributed.py`` allows either);
    then its elements are P times the port's block.  The reference's
    ``collective_census`` does not count a ``ROOT`` instruction (its
    pattern wants the name first), so the HLO is read here directly."""
    want = _last_json(run_with_devices(REF_GEE, 8))
    got = _last_json(_python(PORT_GEE))
    for lap in ("True", "False"):
        port = [(r["op"], r["payload_bytes"] // 8) for r in got[lap]
                ["records"]]
        assert all(r["dtype"] == "float64" for r in got[lap]["records"])
        ref = []
        for op, nbytes in want[lap]:
            elems = nbytes // 4
            if op == "all-reduce" and elems == 1000 * 4:
                op, elems = "reduce-scatter", elems // 8
            ref.append((op, elems))
        assert sorted(port) == sorted(ref), (lap, port, ref)
        assert got[lap]["collectives"]["reduce-scatter"]["count"] == 1
        assert got[lap]["collectives"]["all-reduce"]["count"] == \
            (1 if lap == "True" else 0)
        assert got[lap]["bytes"] == {"edges": 2500 * 12, "labels": 4000,
                                     "output": 125 * 4 * 4}


# ---------------------------------------------------------------------------
# (h) the CLI
# ---------------------------------------------------------------------------

def test_cli_traces_a_production_cell(tmp_path):
    out = tmp_path / "dryrun.json"
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--out", str(out),
         "--dump-hlo", str(tmp_path / "hlo")],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    seconds = time.monotonic() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["microbatches"] == 4 and rec["remat"] == "full"
    for key in ("argument_bytes", "alias_bytes", "temp_bytes",
                "bytes_per_device", "peak_bytes"):
        assert rec["memory"][key] > 0, key
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["corrected"]["method"] == "eager trace (every layer counted)"
    assert rec["corrected"]["flops"] == rec["flops_per_device_raw"] > 0
    assert (tmp_path / "hlo" /
            "qwen3-0.6b_train_4k_single_pod_16x16.collectives.json").exists()
    assert seconds < 120, seconds
