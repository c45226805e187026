"""The port's train step on a (data, model) mesh
(``repro_torch/distributed/tensor_parallel.py``, the ``shard=`` hooks of
``models/lm.py`` and ``train/loop.py``, the optimizers' ``layout=``,
sharded ``ckpt.save`` / ``restore`` and ``elastic.restore_on_mesh``) held
against the JAX reference's one-device step on the CPU.

Gloo ranks are spawned with a ``FileStore`` in the test's directory (as
``tests/test_torch_distributed.py`` does), each spawn under a timeout: P =
2 runs meshes (1, 2) and (2, 1) in turn, P = 4 runs (2, 2) and (1, 4).  On every mesh
the reduced dense (qwen3), vlm (qwen2-vl), audio (hubert), ssm (mamba2)
and hybrid (recurrentgemma) configs take the reference's weights and
batch and run the sharded gradient and whole AdamW and Adafactor steps at
microbatches 1 and 2; rank 0 gathers every leaf.  The MoE configs
(deepseek-moe-16b, kimi-k2-1t-a32b) run the same checks on the same
meshes in ``tests/test_torch_sharded_moe.py``, with this file's
machinery.  The (1, 4) mesh cuts
qwen3's two KV heads (the gathered-``wk`` fallback).  Held: the loss
within 1e-5 relative, every gathered gradient leaf within ``1e-4 *
max|want| + 1e-5``, updated parameters within ``PERF.md`` section 2's step
bounds, the optimizer state within ``1e-4 * max|want| + 1e-9``.

A checkpoint saved sharded at (2, 2) is restored at (1, 4) through
``restore_on_mesh`` and saved again, and restored in this process: the
three digests are equal.  Eight ranks on (pod, data, model) = (2, 2, 2)
run remat'd steps against the port's one-process step, and reduced
deepseek-moe-16b's forward against the reference's one-device logits;
``launch.train`` under ``torchrun`` resumes on another mesh;
``tools/lm_ranks.py`` runs on two gloo ranks.
"""

import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.train import optimizers as jopt

from test_torch_train import (_one_thread, adafactor_bound,  # noqa: F401
                              adamw_bound, ref_flat, within)

SPAWN_TIMEOUT_S = 300
NAMES = ("qwen3-0.6b", "qwen2-vl-72b", "hubert-xlarge", "mamba2-2.7b",
         "recurrentgemma-2b")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
OPTS = ("adamw", "adafactor")
MICRO = (1, 2)
LR = 1e-3
CHUNK = 8
B, S = 4, 12
# specs whose blocks each mesh gathers back (tuple entries: the first axis
# outermost)
ROUND_TRIPS = [(None, "model", None), ("data", "model", None),
               (("data", "model"), None, None), (None, ("model", "data"),
                                                 None),
               ("model", None, "data"), (None, None, None)]


def _batch(cfg):
    from repro_torch.data import pipeline

    dc = pipeline.DataConfig(cfg.vocab_size, S, B, seed=1)
    if cfg.frontend == "frame":
        return pipeline.encoder_batch_at(dc, 0, cfg.frontend_dim)
    out = pipeline.batch_at(dc, 0)
    if cfg.frontend == "patch":
        out["patches"] = np.random.default_rng(5).standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _variant(name):
    """``"<arch>[@cf<x>][@b<n>]"`` -> (arch, capacity factor or None, rows
    or None): an MoE config at capacity factor x, the batch cut to its
    first n rows (cases of the gradient alone)."""
    arch, *opts = name.split("@")
    cf = next((float(o[2:]) for o in opts if o.startswith("cf")), None)
    rows = next((int(o[1:]) for o in opts if o.startswith("b")), None)
    return arch, cf, rows


def _config(get, name):
    """The reduced config of ``name`` (``_variant``)."""
    import dataclasses

    arch, cf, _ = _variant(name)
    cfg = get(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


@functools.lru_cache(maxsize=None)
def reference(name):
    """-> (reference config, weights, numpy batch)."""
    jcfg = _config(j_get_config, name)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rows = _variant(name)[2]
    return jcfg, jp, {k: v[:rows] for k, v in _batch(jcfg).items()}


@functools.lru_cache(maxsize=None)
def reference_grads(name):
    jcfg, jp, batch = reference(name)
    fn = jax.jit(jax.value_and_grad(
        functools.partial(jloop.loss_fn, cfg=jcfg, chunk=CHUNK),
        has_aux=True))
    (_, metrics), grads = fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    return {k: float(v) for k, v in metrics.items()}, ref_flat(grads)


@functools.lru_cache(maxsize=None)
def reference_step(name, opt_name, micro):
    jcfg, jp, batch = reference(name)
    jo = jopt.get_optimizer(opt_name, LR)
    step = jax.jit(jloop.make_train_step(jcfg, jo, microbatches=micro,
                                         chunk=CHUNK))
    p1, s1, m = step(jp, jo.init(jp), {k: jnp.asarray(v) for k, v in
                                       batch.items()})
    return ref_flat(p1), ref_flat(s1), {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store, plan, in_dir, out_dir, ckpt_dir):
    """Every ``(mesh name, config names)`` of ``plan`` in turn on this
    world's ranks, the results keyed by mesh; with ``ckpt_dir``, (2, 2)
    saves the checkpoint that (1, 4) restores."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for mesh_name, names in plan:
            mesh = make_mesh_for(world, MESHES[mesh_name][1],
                                 device_type="cpu")
            res = _mesh_work(mesh, names, in_dir, out_dir,
                             ckpt_dir if mesh_name == "1x4" else None,
                             ckpt_dir if mesh_name == "2x2" else None)
            out.update({f"{mesh_name}/{k}": v for k, v in res.items()})
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    finally:
        dist.destroy_process_group()


def _mesh_work(mesh, names, in_dir, out_dir, ckpt_in, ckpt_out) -> dict:
    """One mesh's work on this rank -> its results (rank 0's are kept)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference, tree_from_flat)
    from repro_torch.distributed.elastic import restore_on_mesh
    from repro_torch.distributed.sharding import (gather_leaf,
                                                  param_shardings,
                                                  shard_leaf)
    from repro_torch.distributed.tensor_parallel import (ShardedLM,
                                                         shard_tree)
    from repro_torch.train import loop
    from repro_torch.train import optimizers as opt_mod
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    out = {}
    full = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    for i, spec in enumerate(ROUND_TRIPS):
        back = gather_leaf(shard_leaf(full, spec, mesh), spec, mesh)
        out[f"roundtrip/{i}"] = float(torch.equal(back, full))

    def gathered(prefix, tree, specs):
        for path, x in zip(tree_paths(tree), tree_leaves(tree)):
            full = gather_leaf(x, specs[path], mesh)
            out[f"{prefix}/{path}"] = full.double().numpy()

    for name in names:
        cfg = _config(get_config, name)
        with np.load(os.path.join(in_dir, f"{name}.npz")) as f:
            stored = {k: f[k] for k in f.files}
        params = lm_params_to_reference(lm_params_from_reference(
            tree_from_flat(stored, "param/"), cfg, device="cpu"), cfg)
        batch = {k[6:]: torch.from_numpy(v) for k, v in stored.items()
                 if k.startswith("batch/")}
        shard = ShardedLM(cfg, mesh)
        blocks = shard_tree(params, shard.param_specs, mesh)
        m, g = loop.grad_and_metrics(blocks, shard.local_batch(batch),
                                     cfg, chunk=CHUNK, shard=shard)
        gathered(f"grad/{name}", g, shard.param_specs)
        for k, v in m.items():
            out[f"metric/{name}/grad/{k}"] = float(v)
        if "@" in name:
            continue
        # microbatch 2's accumulated gradient, as the step forms it
        halves = [loop.grad_and_metrics(
            blocks, shard.local_batch({k: v[i * B // 2:(i + 1) * B // 2]
                                       for k, v in batch.items()}),
            cfg, chunk=CHUNK, shard=shard)[1] for i in range(2)]
        acc = [a.to(torch.float32) + b.to(torch.float32) for a, b in
               zip(tree_leaves(halves[0]), tree_leaves(halves[1]))]
        gathered(f"gacc/{name}", tree_unflatten(g, [a / 2 for a in acc]),
                 shard.param_specs)
        for opt_name in OPTS:
            opt = opt_mod.get_optimizer(opt_name, LR,
                                        layout=shard.layout)
            state_specs = param_shardings(
                opt_mod.get_optimizer(opt_name, LR).init(params), mesh)
            for micro in MICRO:
                step = loop.make_train_step(cfg, opt, microbatches=micro,
                                            chunk=CHUNK, shard=shard)
                p1, s1, m = step(blocks, opt.init(blocks), batch)
                key = f"{name}/{opt_name}/{micro}"
                gathered(f"param/{key}", p1, shard.param_specs)
                gathered(f"state/{key}", s1, state_specs)
                for k, v in m.items():
                    out[f"metric/{key}/{k}"] = float(v)
                if ckpt_out and (name, opt_name, micro) == (
                        "qwen3-0.6b", "adamw", 1):
                    tree = {"params": p1, "opt": s1}
                    tree_specs = param_shardings(
                        {"params": params, "opt": opt.init(params)}, mesh)
                    ckpt.save(ckpt_out, 1, tree, {"step": 1},
                              shardings=tree_specs, mesh=mesh)
                    _host_gather(tree, tree_specs, mesh, out_dir, out)
    if ckpt_in:
        from repro_torch.models import lm

        cfg = get_config("qwen3-0.6b").reduced()
        abstract = lm_params_to_reference(lm.abstract_params(cfg), cfg)
        opt = opt_mod.get_optimizer("adamw", LR)
        like = {"params": abstract, "opt": opt.init(abstract)}
        tree, extra = restore_on_mesh(ckpt_in, 1, like, mesh, "cpu")
        specs = param_shardings(like, mesh)
        assert extra == {"step": 1}
        ckpt.save(os.path.join(out_dir, "resaved"), 1, tree, extra,
                  shardings=specs, mesh=mesh)
    return out


def _host_gather(tree, specs, mesh, out_dir, out):
    """``ckpt.gather_to_host`` on every rank: each rank's count of host
    leaves (rank 0 records them all), and rank 0's dict saved whole into
    ``out_dir/host_gathered``."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt

    host = ckpt.gather_to_host(tree, specs, mesh)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(host))
    out["host_leaves"] = np.asarray(counts)
    if dist.get_rank() == 0:
        ckpt.save(os.path.join(out_dir, "host_gathered"), 1, host,
                  {"step": 1})


def _spawn(world, plan, tmp_path, in_dir, ckpt_dir=None):
    """``plan``'s meshes on ``world`` spawned gloo ranks -> (rank 0's
    results keyed by mesh, the output directory)."""
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "store"), plan, str(in_dir),
                          str(out_dir), ckpt_dir),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    with np.load(out_dir / "rank0.npz") as f:
        return {k: f[k] for k in f.files}, out_dir


def write_inputs(d, names):
    """The reference's weights and batch of each config, as npz files the
    ranks read (they import no JAX)."""
    for name in names:
        _, jp, batch = reference(name)
        np.savez(d / f"{name}.npz",
                 **{"param/" + k: v for k, v in ref_flat(jp).items()},
                 **{"batch/" + k: v for k, v in batch.items()})
    return d


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("inputs"), NAMES)


def world_of(mesh_name) -> int:
    return MESHES[mesh_name][0] * MESHES[mesh_name][1]


def spawned(tmp_path_factory, inputs, names_of, ckpt_dir=None):
    """-> get(mesh name) -> (rank 0's results on that mesh, the output
    directory): the meshes of one world size spawned once, together."""
    cache = {}

    def get(mesh_name):
        world = world_of(mesh_name)
        if world not in cache:
            plan = tuple((m, names_of(m)) for m in MESHES
                         if world_of(m) == world)
            cache[world] = _spawn(world, plan, tmp_path_factory.mktemp(
                f"world{world}"), inputs, ckpt_dir)
        res, out_dir = cache[world]
        return _prefixed(res, mesh_name), out_dir

    return get


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """mesh name -> rank 0's gathered results; (2, 2) saves the checkpoint
    that (1, 4) restores, in the same four ranks."""
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    get = spawned(tmp_path_factory, inputs, lambda m: NAMES, str(ckpt_dir))
    get.ckpt_dir = ckpt_dir
    return get


def _prefixed(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_gradients_match_reference(name, mesh_name, ranks):
    check_gradients(ranks(mesh_name)[0], name)


def check_gradients(res, name):
    """Rank 0's gathered gradient and metrics of ``name`` against the
    reference's one-device gradient."""
    want_m, want = reference_grads(name)
    got = _prefixed(res, f"grad/{name}")
    assert set(got) == set(want)
    for k, v in want.items():
        within(got[k], v)
    got_m = _prefixed(res, f"metric/{name}/grad")
    assert float(got_m["loss"]) == pytest.approx(want_m["loss"], rel=1e-5)
    assert float(got_m["tokens"]) == want_m["tokens"]


@pytest.mark.parametrize("micro", MICRO)
@pytest.mark.parametrize("opt_name", OPTS)
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_reference(name, mesh_name, opt_name, micro,
                                        ranks):
    check_step(ranks(mesh_name)[0], name, opt_name, micro)


def check_step(res, name, opt_name, micro):
    """Metrics, updated parameters (the reference's whole step, within the
    step bounds) and the optimizer's state, gathered."""
    key = f"{name}/{opt_name}/{micro}"
    want_p, want_s, want_m = reference_step(name, opt_name, micro)
    got_m = _prefixed(res, f"metric/{key}")
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        assert float(got_m[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    _, jp, _ = reference(name)
    p0 = ref_flat(jp)
    got_p = _prefixed(res, f"param/{key}")
    assert set(got_p) == set(want_p)
    # the gradients the two steps clipped, for AdamW's bound: microbatch
    # 1's, or the mean over the microbatches
    g_ref = _reference_step_grads(name, micro)
    g_got = _prefixed(res, f"{'grad' if micro == 1 else 'gacc'}/{name}")
    scale_got = min(1.0, 1.0 / max(float(got_m["grad_norm"]), 1e-9))
    scale_want = min(1.0, 1.0 / max(want_m["grad_norm"], 1e-9))
    for k, v in want_p.items():
        if opt_name == "adamw":
            bound = adamw_bound(g_got[k] * scale_got, g_ref[k] * scale_want,
                                got_p[k], v, LR)
        else:
            bound = adafactor_bound(v - p0[k], p0[k], rel=1e-4)
        err = np.abs(got_p[k] - v)
        assert np.all(err <= bound), (k, float((err - bound).max()))
    got_s = _prefixed(res, f"state/{key}")
    assert set(got_s) == set(want_s)
    for k, v in want_s.items():
        within(got_s[k], v, rel=1e-4, atol=1e-9)


@functools.lru_cache(maxsize=None)
def _reference_step_grads(name, micro):
    """The reference's gradient of a whole step: microbatch 1's, or the
    mean over the microbatches, in the reference's order."""
    jcfg, jp, batch = reference(name)
    if micro == 1:
        return reference_grads(name)[1]
    per = B // micro
    fn = jax.jit(jax.grad(lambda p, b: jloop.loss_fn(p, b, jcfg,
                                                     chunk=CHUNK)[0]))
    parts = [ref_flat(fn(jp, {k: jnp.asarray(v[i * per:(i + 1) * per])
                              for k, v in batch.items()}))
             for i in range(micro)]
    return {k: sum(p[k].astype(np.float64) for p in parts) / micro
            for k in parts[0]}


def test_checkpoint_crosses_meshes_with_an_equal_digest(ranks):
    """Saved sharded at (2, 2), restored at (1, 4) through
    ``restore_on_mesh`` and saved again, and restored whole in this
    process and saved: the same manifest digest, the same leaves; and the
    values are the (2, 2) step's gathered ones."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.models import lm
    from repro_torch.train import optimizers as opt_mod

    res22, _ = ranks("2x2")
    _, out14 = ranks("1x4")
    src = str(ranks.ckpt_dir)

    def manifest(d):
        with open(os.path.join(d, "step_0000000001", "manifest.json")) as f:
            return json.load(f)

    first = manifest(src)
    assert manifest(out14 / "resaved")["digest"] == first["digest"]
    cfg = get_config("qwen3-0.6b").reduced()
    abstract = lm_params_to_reference(lm.abstract_params(cfg), cfg)
    like = {"params": abstract,
            "opt": opt_mod.get_optimizer("adamw", LR).init(abstract)}
    tree, extra = ckpt.restore(src, 1, like, "cpu")
    local = os.path.join(str(out14), "whole")
    ckpt.save(local, 1, tree, extra)
    assert manifest(local) == first
    arrays, _ = ckpt.restore_arrays(src, 1, verify=True)
    want = _prefixed(res22, "param/qwen3-0.6b/adamw/1")
    for k, v in want.items():
        np.testing.assert_array_equal(arrays["params/" + k], v)


def test_gather_to_host_keeps_the_state_on_rank_0_only(ranks):
    """``ckpt.gather_to_host`` at (2, 2): rank 0 holds every leaf of the
    step's parameters and AdamW state, ranks 1-3 return ``{}``, and rank
    0's dict saved whole has the sharded save's digest."""
    res22, out22 = ranks("2x2")
    src = str(ranks.ckpt_dir)

    def manifest(d):
        with open(os.path.join(d, "step_0000000001", "manifest.json")) as f:
            return json.load(f)

    counts = [int(c) for c in res22["host_leaves"]]
    assert counts[0] == len(manifest(src)["index"]) > 0
    assert counts[1:] == [0, 0, 0]
    assert manifest(out22 / "host_gathered")["digest"] \
        == manifest(src)["digest"]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_gather_leaf_inverts_shard_leaf(mesh_name, ranks):
    res, _ = ranks(mesh_name)
    got = _prefixed(res, "roundtrip")
    assert len(got) == len(ROUND_TRIPS)
    assert all(float(v) == 1.0 for v in got.values()), got


# ---------------------------------------------------------------------------
# the launcher and the tool under torchrun
# ---------------------------------------------------------------------------

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _torchrun(nproc, args, timeout=SPAWN_TIMEOUT_S):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), *args],
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_launcher_resumes_on_another_mesh(tmp_path):
    """``launch.train`` on a (2, 2) mesh of gloo ranks checkpoints after 2
    steps; restarted on (1, 2) it re-shards that checkpoint
    (``restore_on_mesh``) and runs steps 2-3, whose losses and norms are an
    uninterrupted one-process run's."""
    from repro_torch.launch import train as launch

    args = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "4", "--seq",
            "16", "--log-every", "1", "--device", "cpu", "--ckpt-interval",
            "2"]
    run = ["-m", "repro_torch.launch.train", *args, "--ckpt-dir",
           str(tmp_path / "run")]
    _torchrun(4, run + ["--devices", "4", "--model-parallel", "2",
                        "--steps", "2"])
    out = _torchrun(2, run + ["--devices", "2", "--model-parallel", "2",
                              "--steps", "4", "--metrics-out",
                              str(tmp_path / "m.json")])
    assert out.count("resumed from step 2") == 1
    got = json.loads((tmp_path / "m.json").read_text())
    want = launch.main(args + ["--steps", "4"])
    assert [h["step"] for h in got] == [2, 3]
    for g, w in zip(got, want[2:]):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)


def test_lm_ranks_tool_runs_on_the_host(tmp_path):
    """``tools/lm_ranks.py`` still drives the port: two gloo ranks on a
    (1, 2) mesh at the reduced size, every check passed."""
    out = tmp_path / "ranks.json"
    stdout = _torchrun(2, [os.path.join(SRC, "..", "tools", "lm_ranks.py"),
                           "--device", "cpu", "--reduced", "--batch", "4",
                           "--seq", "32", "--steps", "2", "--check-seq",
                           "16", "--out", str(out)])
    assert stdout.count("lm_ranks: 2 ranks over gloo") == 1
    report = json.loads(out.read_text())
    assert report["mesh"] == [1, 2]
    assert report["f32_check"]["grad_worst_over_bound"] <= 1.0
    assert report["checkpoint"]["restored_on"] == [2, 1]
    assert report["compressed"]["max_abs_err"] <= report["compressed"]["bound"]


# ---------------------------------------------------------------------------
# remat and the pod axis: eight ranks on (2, 2, 2)
# ---------------------------------------------------------------------------

REMAT_CASES = (("qwen3-0.6b", "full"), ("hubert-xlarge", "dots"))
POD_FORWARD = "deepseek-moe-16b"


def _pod_rank_main(rank, world, store, out_dir, in_path):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference, tree_from_flat,
                                     unstack_layers)
    from repro_torch.distributed.sharding import gather_leaf
    from repro_torch.distributed.tensor_parallel import (ShardedLM,
                                                         shard_tree)
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import batch_for
    from repro_torch.data import pipeline
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train import optimizers as opt_mod
    from repro_torch.tree import tree_leaves, tree_paths

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh_for(world, 2, pods=2, device_type="cpu")
        out = {}
        for name, remat in REMAT_CASES:
            cfg = dataclasses.replace(get_config(name).reduced(),
                                      remat=remat)
            params = lm_params_to_reference(
                lm.init_params(cfg, 0, device="cpu"), cfg)
            dc = pipeline.DataConfig(cfg.vocab_size, S, 8, seed=1)
            batch = {k: torch.from_numpy(v)
                     for k, v in batch_for(cfg, dc, 0).items()}
            shard = ShardedLM(cfg, mesh)
            blocks = shard_tree(params, shard.param_specs, mesh)
            opt = opt_mod.get_optimizer("adafactor", LR,
                                        layout=shard.layout)
            p1, _, m = loop.make_train_step(cfg, opt, chunk=CHUNK,
                                            shard=shard)(
                blocks, opt.init(blocks), batch)
            for path, x in zip(tree_paths(p1), tree_leaves(p1)):
                out[f"{name}/param/{path}"] = gather_leaf(
                    x, shard.param_specs[path], mesh).double().numpy()
            out[f"{name}/loss"] = float(m["loss"])
        # the reference's weights and batch of the MoE forward: the
        # logits, gathered over the batch and vocabulary blocks
        cfg = get_config(POD_FORWARD).reduced()
        with np.load(in_path) as f:
            stored = {k: f[k] for k in f.files}
        params = lm_params_to_reference(lm_params_from_reference(
            tree_from_flat(stored, "param/"), cfg, device="cpu"), cfg)
        shard = ShardedLM(cfg, mesh)
        blocks = shard_tree(params, shard.param_specs, mesh)
        batch = shard.local_batch({"tokens": torch.from_numpy(
            stored["tokens"])})
        with torch.no_grad():
            logits, _, _ = lm.forward(unstack_layers(blocks, cfg), batch,
                                      cfg, chunk=CHUNK, shard=shard)
        spec = (("pod", "data"), None, "model" if shard.vocab_tp else None)
        out[f"{POD_FORWARD}/logits"] = gather_leaf(logits, spec,
                                                   mesh).double().numpy()
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def pod_forward_reference():
    """The reference's test_full_model_distributed_matches_single_device
    inputs and its one-device logits."""
    jcfg = j_get_config(POD_FORWARD).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                jcfg.vocab_size)
    want, _, _ = jlm.forward(jp, {"tokens": tokens}, jcfg, mode="train",
                             chunk=CHUNK)
    return jp, np.asarray(tokens), np.asarray(want)


@pytest.fixture(scope="module")
def pod_ranks(tmp_path_factory):
    """Eight ranks on (pod, data, model) = (2, 2, 2), spawned once."""
    tmp = tmp_path_factory.mktemp("pods")
    jp, tokens, _ = pod_forward_reference()
    np.savez(tmp / "moe.npz", tokens=tokens,
             **{"param/" + k: v for k, v in ref_flat(jp).items()})
    world = 8
    ctx = mp.start_processes(
        _pod_rank_main, args=(world, str(tmp / "store"), str(tmp),
                              str(tmp / "moe.npz")),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{world} ranks did not finish")
    with np.load(tmp / "rank0.npz") as f:
        return {k: f[k] for k in f.files}


def test_remat_and_pods_match_one_process(pod_ranks):
    """Remat (a layer's gathers redone in its recompute) on a (pod, data,
    model) = (2, 2, 2) mesh, the batch split over pod x data: an
    Adafactor step equals the one-process step of the port (itself held
    against the reference above) within the step bound."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.data import pipeline
    from repro_torch.launch.train import batch_for
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train import optimizers as opt_mod
    from repro_torch.tree import flatten_with_paths

    got = pod_ranks
    for name, _ in REMAT_CASES:
        cfg = get_config(name).reduced()
        params = lm_params_to_reference(lm.init_params(cfg, 0, device="cpu"),
                                        cfg)
        dc = pipeline.DataConfig(cfg.vocab_size, S, 8, seed=1)
        batch = {k: torch.from_numpy(v)
                 for k, v in batch_for(cfg, dc, 0).items()}
        opt = opt_mod.get_optimizer("adafactor", LR)
        p1, _, m = loop.make_train_step(cfg, opt, chunk=CHUNK)(
            params, opt.init(params), batch)
        assert got[f"{name}/loss"] == pytest.approx(float(m["loss"]),
                                                    rel=1e-5)
        p0 = {k: v.double().numpy()
              for k, v in flatten_with_paths(params).items()}
        for k, v in flatten_with_paths(p1).items():
            v = v.double().numpy()
            bound = adafactor_bound(v - p0[k], p0[k], rel=1e-4)
            err = np.abs(got[f"{name}/param/{k}"] - v)
            assert np.all(err <= bound), (name, k)


def test_full_model_distributed_matches_single_device(pod_ranks):
    """The reference's test of the same name, on the port: reduced
    deepseek-moe-16b's train-mode logits on (pod, data, model) = (2, 2,
    2) -- the MoE layers through the expert-parallel dispatch, the expert
    FFN width split over ``pod`` -- within 5e-4 of the reference's
    one-device forward."""
    _, _, want = pod_forward_reference()
    got = pod_ranks[f"{POD_FORWARD}/logits"]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < 5e-4, err
