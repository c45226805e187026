"""The port's multi-device folds -- ``repro_torch.core.distributed``
(``gee_distributed``), the sharded half of ``repro_torch.core.fold``
(``combine_partials``, ``gather_rows``, ``gee_streamed_sharded``) and their
routes through ``GEEPlan``, ``GEEEmbedder`` and ``gee_run`` -- held against
the JAX reference on the CPU, with inputs made from a numpy seed.

A world of one runs in this process (no process group: no collective
call).  P = 2 and P = 4 run as real gloo groups of spawned ranks, joined
through a ``FileStore`` in the test's own directory (no port to collide
across test workers), each spawn bounded by a timeout.  On the CPU the
``cuda`` local backend takes the plain ``gee_spmm``.

Tolerance: the row-scaled 1e-5·|want| + 1e-5·min(1, max |want row|) of
``PERF.md`` section 2 (the sharded sums run in another order than the
reference's, and gloo reduces in its own order); bit equality only where
the arithmetic is the same (the ranks' gathered copies, a pre-sharded
input).
"""

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core.distributed import gee_distributed as j_gee_distributed
from repro.core.fold import gee_streamed_sharded as j_gee_streamed_sharded
from repro.graph import io as jio
from repro.graph.containers import edge_list_from_numpy as j_edge_list
from repro.graph.containers import symmetrize as j_symmetrize

from repro_torch.core import distributed as tdist
from repro_torch.core.api import GEEEmbedder
from repro_torch.core.distributed import gee_distributed
from repro_torch.core.fold import (LOCAL_BACKENDS, combine_partials,
                                   gather_rows, gee_streamed_sharded,
                                   pad_labels, pad_nodes, world_size)
from repro_torch.core.gee import ALL_OPTION_SETTINGS, GEEOptions
from repro_torch.core.plan import GEEPlan, PreparedGraph, select_backend
from repro_torch.graph import io as tio
from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
from repro_torch.graph.partition import shard_edges, shard_edges_to_ell

from conftest import run_with_devices

jgee = importlib.import_module("repro.core.gee")

RTOL = ATOL = 1e-5
OPT_IDS = [o.tag() for o in ALL_OPTION_SETTINGS]
DEFAULT = GEEOptions(laplacian=True, diag_aug=True, correlation=True)
N, E, K = 41, 173, 3            # 41 rows: no P in (2, 4) divides them
WINDOW = 37                     # entries a stored window
SPAWN_TIMEOUT_S = 240
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _jopts(o):
    return jgee.GEEOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                           correlation=o.correlation)


def _arrays():
    """One entry per undirected edge: duplicates, a hub, self loops, a
    zero weight; labels with -1s."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    src[: E // 4] = 0                            # node 0 is a hub
    dst[::11] = src[::11]                        # self loops
    w = (rng.random(E) + 0.25).astype(np.float32)
    w[3] = 0.0
    labels = rng.integers(0, K, N).astype(np.int32)
    labels[rng.random(N) < 0.2] = -1
    return src, dst, w, labels


def _edges():
    src, dst, w, _ = _arrays()
    return symmetrize(edge_list_from_numpy(src, dst, w, N, device="cpu"))


def _chunked():
    src, dst, w, _ = _arrays()
    return tio.ChunkedEdgeList(src, dst, w, N, chunk_edges=WINDOW,
                               undirected=True)


def _reference(opts):
    src, dst, w, labels = _arrays()
    edges = j_symmetrize(j_edge_list(src, dst, w, N))
    return np.asarray(jgee.gee_sparse_jax(edges, labels, K, _jopts(opts)))


def assert_rows(got, want):
    """Each entry within RTOL·|want| + ATOL·min(1, max |want row|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.minimum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    bad = np.abs(got - want) > RTOL * np.abs(want) + ATOL * scale
    assert not bad.any(), f"{int(bad.sum())} entries off, max err " \
        f"{np.abs(got - want).max():.3g}"


def _write_geeb(path):
    src, dst, w, labels = _arrays()
    with tio.BinaryEdgeWriter(path, N, E, undirected=True) as wr:
        wr.append(src, dst, w)
    tio.save_labels(path, labels)
    return path


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_world_of_one_matches_reference(opts):
    """Both local backends, in memory and streamed (prefetch 0 and 2),
    against ``gee_sparse_jax`` and against the reference's own one-device
    ``gee_distributed`` / ``gee_streamed_sharded`` with the same local
    backend (``pallas`` in interpret mode for the port's ``cuda``)."""
    import jax

    assert world_size() == 1
    want = _reference(opts)
    src, dst, w, labels = _arrays()
    jedges = j_symmetrize(j_edge_list(src, dst, w, N))
    jch = jio.ChunkedEdgeList(src, dst, w, N, chunk_edges=WINDOW,
                              undirected=True)
    mesh = jax.make_mesh((1,), ("data",))
    for lb, jlb in zip(LOCAL_BACKENDS, ("segment_sum", "pallas")):
        z = gee_distributed(_edges(), labels, K, opts, local_backend=lb)
        assert z.shape == (N, K) and z.device.type == "cpu"
        assert_rows(z.numpy(), want)
        jz = j_gee_distributed(jedges, labels, K, _jopts(opts), mesh=mesh,
                               local_backend=jlb)
        assert_rows(z.numpy(), np.asarray(jz)[:N])
        jz = np.asarray(j_gee_streamed_sharded(jch, labels, K, _jopts(opts),
                                               local_backend=jlb))
        for depth in (0, 2):
            z = gee_streamed_sharded(_chunked(), labels, K, opts,
                                     local_backend=lb,
                                     prefetch_windows=depth, device="cpu")
            assert z.shape == (N, K)
            assert_rows(z.numpy(), want)
            assert_rows(z.numpy(), jz)


def test_pre_sharded_and_the_refusals():
    """Pre-shuffled arrays give the same bits as the shuffle inside; the
    reference's two ``ValueError``s; the labels check of the stream."""
    _, _, _, labels = _arrays()
    edges = _edges()
    z = gee_distributed(edges, labels, K, DEFAULT)
    pre = shard_edges(edges, 1, device="cpu")
    np.testing.assert_array_equal(
        gee_distributed(pre, labels, K, DEFAULT, pre_sharded=True).numpy(),
        z.numpy())
    with pytest.raises(ValueError, match="pre_sharded"):
        gee_distributed(edges, labels, K, DEFAULT, pre_sharded=True,
                        local_backend="cuda")
    with pytest.raises(ValueError, match="unknown local_backend"):
        gee_distributed(edges, labels, K, DEFAULT, local_backend="pallas")
    with pytest.raises(ValueError, match="unknown local_backend"):
        gee_streamed_sharded(_chunked(), labels, K, DEFAULT,
                             local_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="labels cover"):
        gee_streamed_sharded(_chunked(), labels[:-1], K, DEFAULT,
                             device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        tdist.local_shard(edges, edges.padded_size + 1, 0,
                          local_backend="segment_sum", num_rows=N,
                          pre_sharded=True, device="cpu")


def test_replayed_ranks_match_one_rank():
    """The per-rank steps of P = 4 run one after another and summed as the
    collectives would sum them (what the card's run replays) give the one
    rank's embedding, for both local backends."""
    _, _, _, labels = _arrays()
    edges = _edges()
    n_pad = pad_nodes(N, 4)
    pre = shard_edges(edges, 4, device="cpu")
    cols, vals = shard_edges_to_ell(edges, 4, n_pad, device="cpu")
    by_backend = {
        "segment_sum": [tdist.local_shard(pre, 4, r, pre_sharded=True,
                                          local_backend="segment_sum",
                                          num_rows=n_pad, device="cpu")
                        for r in range(4)],
        "cuda": [(cols[lo:lo + n_pad], vals[lo:lo + n_pad])
                 for lo in range(0, 4 * n_pad, n_pad)]}
    for lb, shards in by_backend.items():
        # the ranks' own inputs are these blocks
        mine = tdist.local_shard(edges, 4, 2, local_backend=lb,
                                 num_rows=n_pad, device="cpu")
        for a, b in zip(mine if lb == "cuda" else
                        (mine.src, mine.dst, mine.weight),
                        shards[2] if lb == "cuda" else
                        (shards[2].src, shards[2].dst, shards[2].weight)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for opts in ALL_OPTION_SETTINGS:
            z = tdist.replay_ranks(shards, labels, K, opts, num_nodes=N)
            assert z.shape == (N, K)
            assert_rows(z.numpy(), _reference(opts))


def test_plan_embedder_and_routes(tmp_path):
    """``GEEPlan`` and ``GEEEmbedder`` take both multi-device backends in a
    world of one; ``auto`` streams across ranks only past the budget with
    more than one device, and never picks ``distributed``."""
    _, _, _, labels = _arrays()
    prep = PreparedGraph(_edges())
    for b in ("streamed_sharded", "distributed"):
        for lb in LOCAL_BACKENDS:
            plan = GEEPlan.build(prep, K, DEFAULT, backend=b,
                                 local_backend=lb, chunk_edges=WINDOW)
            names = [s.name for s in plan.stages]
            assert names[-1] == "gather_rows"
            assert lb in plan.describe()
            assert_rows(plan.execute(labels).numpy(), _reference(DEFAULT))
            z = GEEEmbedder(num_classes=K, backend=b, local_backend=lb,
                            device="cpu", chunk_edges=WINDOW).fit_transform(
                                _edges(), labels)
            assert_rows(z.numpy(), _reference(DEFAULT))
    assert GEEPlan.build(prep, K, backend="streamed_sharded").stages[0].name \
        == "chunk_manifest"
    assert GEEPlan.build(prep, K, backend="streamed_sharded"
                         ).prefetch_windows is not None
    with pytest.raises(ValueError, match="unknown local_backend"):
        GEEPlan.build(prep, K, backend="distributed", local_backend="x")
    assert select_backend(prep, K, budget_bytes=1, num_devices=4) == \
        "streamed_sharded"
    assert select_backend(prep, K, budget_bytes=1, num_devices=1) == \
        "chunked"
    assert select_backend(prep, K, budget_bytes=1) == "chunked"  # world 1
    assert select_backend(prep, K, num_devices=4) == "sparse_torch"
    assert GEEPlan.build(prep, K, budget_bytes=1).backend == "chunked"
    path = _write_geeb(str(tmp_path / "g.geeb"))
    for lb in LOCAL_BACKENDS:
        emb = GEEEmbedder(num_classes=K, backend="streamed_sharded",
                          local_backend=lb, device="cpu",
                          chunk_edges=WINDOW)
        assert_rows(emb.fit_transform_file(path).numpy(),
                    _reference(DEFAULT))


def test_combine_and_gather_in_a_world_of_one():
    """No group: ``combine_partials`` is the epilogue on the whole f32 sum
    and ``gather_rows`` a cut to N rows."""
    _, _, _, labels = _arrays()
    lab = pad_labels(labels, 44, "cpu")
    assert lab.shape == (44,) and (lab[N:] == -1).all()
    z = torch.rand(44, K, dtype=torch.float64)
    winv = torch.rand(K)
    dinv = torch.rand(44)
    out = combine_partials(z, lab, winv, dinv, opts=GEEOptions())
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), z.float().numpy())
    assert gather_rows(out, N).shape == (N, K)
    assert pad_nodes(41, 4) == 44 and pad_nodes(44, 4) == 44


# ---------------------------------------------------------------------------
# real gloo groups: P = 2 and P = 4 spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store, out_dir, geeb):
    """One rank: every sharded route under all 8 settings and both local
    backends, gathered to [N, K], saved for the parent to check."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        _, _, _, labels = _arrays()
        edges = _edges()
        files = tio.open_window_parallel(geeb, world, chunk_edges=WINDOW)
        assert files.window_edges % world == 0
        assert world_size() == world
        out = {}
        for opts in ALL_OPTION_SETTINGS:
            for lb in LOCAL_BACKENDS:
                key = f"{opts.tag()}|{lb}"
                block = gee_distributed(edges, labels, K, opts,
                                        local_backend=lb)
                assert block.shape == (pad_nodes(N, world) // world, K)
                out[f"distributed|{key}"] = gather_rows(block, N).numpy()
                out[f"streamed|{key}"] = gather_rows(gee_streamed_sharded(
                    _chunked(), labels, K, opts, local_backend=lb,
                    device="cpu"), N).numpy()
                out[f"geeb|{key}"] = gather_rows(gee_streamed_sharded(
                    files, labels, K, opts, local_backend=lb,
                    prefetch_windows=0, device="cpu"), N).numpy()
        prep = PreparedGraph(edges)
        assert select_backend(prep, K, budget_bytes=1) == "streamed_sharded"
        assert GEEPlan.build(prep, K, budget_bytes=1).backend == \
            "streamed_sharded"
        for b in ("streamed_sharded", "distributed"):
            out[f"embedder|{b}"] = GEEEmbedder(
                num_classes=K, backend=b, device="cpu",
                chunk_edges=WINDOW).fit_transform(edges, labels).numpy()
        out["embedder|file"] = GEEEmbedder(
            num_classes=K, backend="streamed_sharded", device="cpu",
            chunk_edges=WINDOW).fit_transform_file(geeb).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path):
    """Run ``_rank_main`` on ``world`` spawned ranks; fail the test if they
    do not all finish within ``SPAWN_TIMEOUT_S``."""
    geeb = _write_geeb(str(tmp_path / "g.geeb"))
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp_path / "store"), str(tmp_path),
                          geeb),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{world} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_reference(world, tmp_path):
    ranks = _spawn(world, tmp_path)
    want = {o.tag(): _reference(o) for o in ALL_OPTION_SETTINGS}
    for key, z in ranks[0].items():
        route, rest = key.split("|", 1)
        tag = rest.split("|")[0] if route != "embedder" else DEFAULT.tag()
        assert_rows(z, want[tag])
        for other in ranks[1:]:                 # every rank gathered the same
            np.testing.assert_array_equal(other[key], z)
    assert len(ranks[0]) == 3 * 8 * 2 + 3


def test_four_ranks_match_the_reference_four_devices(tmp_path):
    """P = 4 over gloo against the reference's own 4-device run (fake XLA
    devices in a subprocess): ``gee_distributed`` and
    ``gee_streamed_sharded`` with the segment-sum body under all 8
    settings.  The port shuffles and splits the edges as the reference
    does, so the two differ only in the order of the sums."""
    ranks = _spawn(4, tmp_path)
    ref_path = tmp_path / "reference.npz"
    src, dst, w, labels = _arrays()
    np.savez(tmp_path / "inputs.npz", src=src, dst=dst, w=w, labels=labels)
    run_with_devices(f"""
import numpy as np, jax
from repro.core.distributed import gee_distributed
from repro.core.fold import gee_streamed_sharded
from repro.core.gee import ALL_OPTION_SETTINGS
from repro.graph.containers import edge_list_from_numpy, symmetrize
from repro.graph.io import ChunkedEdgeList
d = np.load({str(tmp_path / "inputs.npz")!r})
src, dst, w, labels = d["src"], d["dst"], d["w"], d["labels"]
from jax.sharding import Mesh
mesh = Mesh(np.asarray(jax.devices()), ("data",))
assert mesh.size == 4
edges = symmetrize(edge_list_from_numpy(src, dst, w, {N}))
ch = ChunkedEdgeList(src, dst, w, {N}, chunk_edges={WINDOW}, undirected=True)
out = {{}}
for o in ALL_OPTION_SETTINGS:
    out["distributed|" + o.tag()] = np.asarray(gee_distributed(
        edges, labels, {K}, o, mesh=mesh))[:{N}]
    out["streamed|" + o.tag()] = np.asarray(gee_streamed_sharded(
        ch, labels, {K}, o, mesh=mesh))
np.savez({str(ref_path)!r}, **out)
""", num_devices=4, timeout=SPAWN_TIMEOUT_S)
    ref = dict(np.load(ref_path))
    assert len(ref) == 16
    for key, want in ref.items():
        route, tag = key.split("|")
        assert_rows(ranks[0][f"{route}|{tag}|segment_sum"], want)


def test_gee_run_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.gee_run
    --backend streamed_sharded --device cpu`` joins a gloo group, verifies
    against the in-memory fit, and only rank 0 prints."""
    geeb = _write_geeb(str(tmp_path / "g.geeb"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.gee_run",
         "--edge-file", geeb, "--chunk-edges", str(WINDOW), "--backend",
         "streamed_sharded", "--lap", "--diag", "--cor", "--verify",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("streamed x2") == 1, proc.stdout
    assert "0 entries off the row tolerance: ok" in proc.stdout
    assert "windows=5x38" in proc.stdout     # 37 rounded up to 2 shards


def test_sharded_ranks_tool_runs_on_the_host(tmp_path):
    """``tools/sharded_ranks.py`` still drives the port: two gloo ranks on
    the host at a small size, every route within the row tolerance."""
    out = tmp_path / "ranks.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(SRC, "..", "tools", "sharded_ranks.py"),
         "--device", "cpu", "--sbm", "300", "--nodes", "400", "--edges",
         "3000", "--reps", "2", "--out", str(out)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("sharded_ranks: 2 ranks over gloo") == 1
    report = json.loads(out.read_text())
    assert report["world"] == 2 and len(report["max_abs_err"]) == 4
    assert all(v <= 1e-5 for v in report["max_abs_err"].values())
