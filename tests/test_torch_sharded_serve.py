"""Prefill and decode on a (data, model) mesh (``ShardedLM.prefill`` under
the training layout, ``distributed/serving.py::ServingLM`` under
``SERVING_RULES``) held against the JAX reference's one-device
``lm.forward(mode="prefill")`` and ``lm.decode_step`` on the CPU.

Gloo ranks are spawned with a ``FileStore`` in the test's directory, as
``tests/test_torch_sharded_train.py`` does: P = 2 runs meshes (1, 2) and
(2, 1), P = 4 runs (2, 2) and (1, 4).  Each reduced config (dense qwen3
and chatglm3, MoE deepseek, SSM mamba2, hybrid recurrentgemma, the
patch-frontend qwen2-vl) takes the reference's weights, prefills a batch
of B = 4 prompts and decodes DECODE tokens, under the serving layout and
again under the training layout; rank 0's logits (whole on every rank)
are held within 1e-4 * max|want| + 1e-5 of the reference's.
The reduced MoE config keeps its capacity factor of 8.0, so neither its
expert-parallel dispatch (capacities of their own) nor the one-device one
drops a token (R10 is ``tests/test_torch_moe_ep.py``'s).  The cache
holds PROMPT + patches + DECODE positions, a multiple of 4: at (1, 4)
the reduced configs' 2 KV heads do not split over 4, so their caches
split their sequence (``kv_seq``), and at (1, 2) the K/V split by heads
while ``pos`` splits by sequence (R11).  Every rank also reports that its
decode gathered no weight: its all-gathers' payloads are activations.
"""

import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 300
NAMES = ("qwen3-0.6b", "chatglm3-6b", "deepseek-moe-16b", "mamba2-2.7b",
         "recurrentgemma-2b", "qwen2-vl-72b")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
B, PROMPT, DECODE = 4, 9, 3
CHUNK = 8


def _cache_len(cfg) -> int:
    n = PROMPT + DECODE + (cfg.frontend_tokens if cfg.frontend == "patch"
                           else 0)
    return n + (-n % 4)


def _batch(cfg):
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)
                                  ).astype(np.int32)}
    if cfg.frontend == "patch":
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    out["decode"] = rng.integers(0, cfg.vocab_size, (DECODE, B, 1)
                                 ).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def reference(name):
    """-> (flat weights, batch, the reference's logits: the prefill's last
    position, then each decode step's)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import lm as jlm

    from test_torch_train import ref_flat

    cfg = get_config(name).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg)
    inputs = {k: jnp.asarray(v) for k, v in batch.items() if k != "decode"}
    cache_len = _cache_len(cfg)
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    logits, caches, _ = jlm.forward(jp, inputs, cfg, mode="prefill",
                                    cache_len=cache_len, chunk=CHUNK)
    want = [np.asarray(logits[:, -1:])]
    pos = logits.shape[1]
    for t in range(DECODE):
        lg, caches = jlm.decode_step(jp, jnp.asarray(batch["decode"][t]),
                                     caches, pos + t, cfg)
        want.append(np.asarray(lg))
    return ref_flat(jp), batch, np.stack(want)


def _rank_main(rank, world, store, plan, in_dir, out_dir):
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
            for name in names:
                for k, v in _serve(mesh, name, in_dir).items():
                    out[f"{mesh_name}/{name}/{k}"] = v
        gathered = [None] * world
        dist.all_gather_object(gathered, {k: v for k, v in out.items()
                                          if k.endswith("weight_gathers")})
        if rank == 0:
            for r, g in enumerate(gathered):
                out.update({f"{k}@{r}": v for k, v in g.items()})
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    finally:
        dist.destroy_process_group()


def _serve(mesh, name, in_dir) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_reference, tree_from_flat
    from repro_torch.distributed.serving import ServingLM
    from repro_torch.distributed.sharding import (SERVING_RULES,
                                                  param_shardings, shard_leaf)
    from repro_torch.distributed.tensor_parallel import ShardedLM
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    cfg = get_config(name).reduced()
    with np.load(os.path.join(in_dir, f"{name}.npz")) as f:
        stored = {k: f[k] for k in f.files}
    params = lm_params_from_reference(tree_from_flat(stored, "param/"), cfg,
                                      device="cpu")
    batch = {k[6:]: torch.from_numpy(v) for k, v in stored.items()
             if k.startswith("batch/")}
    steps = batch.pop("decode")
    cache_len = _cache_len(cfg)

    shard = ShardedLM(cfg, mesh)
    specs = param_shardings(params, mesh)
    blocks = tree_unflatten(params, [
        shard_leaf(x, specs[p], mesh)
        for x, p in zip(tree_leaves(params), tree_paths(params))])
    last, caches = shard.prefill(blocks, batch, cache_len=cache_len,
                                 chunk=CHUNK)
    caches_train = tree_unflatten(caches, [x.clone()
                                           for x in tree_leaves(caches)])
    pos = PROMPT + (cfg.frontend_tokens if cfg.frontend == "patch" else 0)
    out = {}
    # the serving layout, then the training layout (``--rules train``)
    for key, rules, cch in (("logits", SERVING_RULES, caches),
                            ("logits_train", None, caches_train)):
        model = ServingLM(cfg, mesh, B, cache_len, rules=rules)
        sblocks = model.shard_params(params)
        spy = _WeightGatherSpy(tree_leaves(sblocks))
        got = [last]
        for t in range(DECODE):
            with spy:
                lg, cch = model.decode_step(
                    sblocks, model.own(steps[t], 0, model.rows), cch,
                    pos + t)
            got.append(lg)
        out[key] = torch.stack(got).numpy()
        if rules is SERVING_RULES:
            out.update(weight_gathers=np.asarray(spy.weight_gathers),
                       gathers=np.asarray(spy.gathers))
    return out


class _WeightGatherSpy:
    """Counts the all-gathers a step makes, and those whose input is (the
    storage of) one of ``weights``."""

    def __init__(self, weights):
        from torch.utils._python_dispatch import TorchDispatchMode

        ptrs = {w.untyped_storage().data_ptr() for w in weights}
        spy = self
        spy.gathers = spy.weight_gathers = 0

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "c10d" and "allgather" in func._opname:
                    spy.gathers += 1
                    ins = args[1] if isinstance(args[1], (list, tuple)) \
                        else [args[1]]
                    spy.weight_gathers += any(
                        t.untyped_storage().data_ptr() in ptrs for t in ins)
                return func(*args, **(kwargs or {}))

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _spawn(world, plan, tmp_path, in_dir):
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "store"), plan, str(in_dir),
                          str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    with np.load(out_dir / "rank0.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh name -> rank 0's results on it; the meshes of one world size
    spawned once, together."""
    in_dir = tmp_path_factory.mktemp("inputs")
    for name in NAMES:
        flat, batch, _ = reference(name)
        np.savez(in_dir / f"{name}.npz",
                 **{"param/" + k: v for k, v in flat.items()},
                 **{"batch/" + k: v for k, v in batch.items()})
    cache = {}

    def get(mesh_name):
        world = MESHES[mesh_name][0] * MESHES[mesh_name][1]
        if world not in cache:
            plan = tuple((m, NAMES) for m in MESHES
                         if MESHES[m][0] * MESHES[m][1] == world)
            cache[world] = _spawn(world, plan, tmp_path_factory.mktemp(
                f"world{world}"), in_dir)
        return cache[world]

    return get


@pytest.mark.parametrize("layout", ("logits", "logits_train"))
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_on_a_mesh_match_the_reference(name, mesh_name,
                                                          layout, ranks):
    """The decode under the serving layout (``logits``) and under the
    training layout (``logits_train``: the dry-run's ``--rules train``),
    each from the same prefill."""
    res = ranks(mesh_name)
    got = res[f"{mesh_name}/{name}/{layout}"]
    want = reference(name)[2]
    assert got.shape == want.shape
    for step, (g, w) in enumerate(zip(got, want)):
        err = float(np.max(np.abs(g - w)))
        bound = 1e-4 * float(np.max(np.abs(w))) + 1e-5
        assert err <= bound, (name, mesh_name, step, err, bound)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_decode_gathers_no_weight(mesh_name, ranks):
    res = ranks(mesh_name)
    world = MESHES[mesh_name][0] * MESHES[mesh_name][1]
    for name in NAMES:
        for r in range(world):
            assert int(res[f"{mesh_name}/{name}/weight_gathers@{r}"]) == 0
        # the spy saw the activations' gathers (a mesh of more than one
        # rank gathers the token rows or the projections' columns)
        assert int(res[f"{mesh_name}/{name}/gathers"]) > 0


def test_kv_seq_layout_at_model_4():
    """The reduced configs' 2 KV heads do not split over 4: the caches the
    (1, 4) ranks hold split their sequence instead."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import cache_shardings
    from repro_torch.models import lm

    for name in ("qwen3-0.6b", "chatglm3-6b", "qwen2-vl-72b"):
        cfg = get_config(name).reduced()
        assert cfg.num_kv_heads == 2
        specs = cache_shardings(lm.init_caches(cfg, B, _cache_len(cfg),
                                               device="meta"),
                                {"data": 1, "model": 4})
        assert specs["k"][2] == "model" and specs["k"][3] is None, specs
