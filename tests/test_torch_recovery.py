"""The port's crash-safe serving -- ``repro_torch.checkpoint`` (``ckpt``,
``CheckpointManager``), ``serve.snapshot`` (``DeltaLog``,
``GEESnapshotter``, ``recover``) and ``serve.replica`` -- held against the
JAX reference on the CPU, with inputs made from a numpy seed.

Both packages write the same files (WAL records, snapshot steps and their
manifests), so directories cross between them both ways: a snapshot and
WAL written by one recover in the other with bit-equal accumulators and
the same watermark.  The kill-and-recover contract runs the port's
``gee_stream`` in subprocesses and SIGKILLs one mid-stream.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.checkpoint.manager import suggest_interval as j_suggest_interval
from repro.core.gee import GEEOptions as JOptions
from repro.core.incremental import IncrementalGEE as JInc
from repro.graph import delta as jdelta
from repro.graph.sbm import sample_sbm as j_sample_sbm
from repro.search.index import ClassPartitionedIndex as JIndex
from repro.search.service import GEEDeltaServer as JDeltaServer
from repro.search.service import GEEQueryService as JService
from repro.serve import snapshot as jsnap

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            suggest_interval)
from repro_torch.core.gee import GEEOptions
from repro_torch.core.incremental import IncrementalGEE
from repro_torch.graph import delta as tdelta
from repro_torch.graph.sbm import sample_sbm
from repro_torch.launch.gee_search import recall_at_k
from repro_torch.search.index import ClassPartitionedIndex
from repro_torch.search.service import (GEEDeltaServer, GEEQueryService,
                                        LoadShedError)
from repro_torch.serve.replica import GEEReplica, ReplicaRouter
from repro_torch.serve.snapshot import DeltaLog, GEESnapshotter, recover

N = 200
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
LAP_DIAG = GEEOptions(laplacian=True, diag_aug=True)
SNAP_OPTS = [GEEOptions(), LAP_DIAG,
             GEEOptions(laplacian=True, diag_aug=True, correlation=True)]


def _jopts(o):
    return JOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                    correlation=o.correlation)


def _inc(opts=GEEOptions(), seed=0, n=N):
    s = sample_sbm(n, seed=seed, device="cpu")
    return IncrementalGEE.from_graph(s.edges, s.labels, s.num_classes,
                                     opts), s


def _edge_batch(rng, n=N, size=16, mod=tdelta):
    return mod.edge_delta_from_numpy(rng.integers(0, n, size),
                                     rng.integers(0, n, size),
                                     rng.random(size))


def _label_batch(rng, k, n=N, size=4, mod=tdelta):
    return mod.label_delta_from_numpy(rng.integers(0, n, size),
                                      rng.integers(0, k, size))


def assert_same_accumulators(a, b):
    """Bit for bit, with the adjacency and the watermark."""
    for name in ("S", "nk", "deg", "_dinv", "labels"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.out_nbrs == b.out_nbrs and a.in_nbrs == b.in_nbrs
    assert a.applied_seq == b.applied_seq


# -- checkpoint store --------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((8, 16)).astype(
                np.float32)),
            "nested": {"b": np.arange(10, dtype=np.int32),
                       "c": np.float32(3.5)}}


def test_ckpt_layout_matches_reference(tmp_path):
    """Same step directory, leaf files, manifest and digest as the
    reference's ``save``; each package's ``restore_arrays`` reads the
    other's."""
    t = _tree()
    ckpt.save(str(tmp_path / "port"), 7, t, {"note": "x"})
    j_ckpt.save(str(tmp_path / "ref"), 7,
                {"a": t["a"].numpy(), "nested": t["nested"]},
                {"note": "x"})
    mans = []
    for side in ("port", "ref"):
        with open(tmp_path / side / "step_0000000007" / "manifest.json") as f:
            mans.append(json.load(f))
    assert mans[0] == mans[1]
    assert set(mans[0]["index"]) == {"a", "nested/b", "nested/c"}
    for side, reader in (("port", j_ckpt), ("ref", ckpt)):
        arrays, extra = reader.restore_arrays(str(tmp_path / side), 7,
                                              verify=True)
        assert extra == {"note": "x"}
        np.testing.assert_array_equal(arrays["a"], t["a"].numpy())
        np.testing.assert_array_equal(arrays["nested/b"], np.arange(10))
    assert ckpt.available_steps(str(tmp_path / "port")) == [7]
    assert ckpt.available_steps(str(tmp_path / "none")) == []


def _tamper_one_leaf(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        entry = sorted(json.load(f)["index"].items())[0][1]
    path = os.path.join(step_dir, entry["file"])
    np.save(path, np.full_like(np.load(path), 13.0))
    return path


def test_restore_arrays_rejects_tampered_and_truncated(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    path = _tamper_one_leaf(str(tmp_path / "step_0000000001"))
    ckpt.restore_arrays(str(tmp_path), 1, verify=False)
    with pytest.raises(ValueError, match="digest"):
        ckpt.restore_arrays(str(tmp_path), 1, verify=True)
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY")                 # torn write: header only
    with pytest.raises(ValueError, match="unreadable leaf"):
        ckpt.restore_arrays(str(tmp_path), 1, verify=True)


def test_manager_retention_failure_and_fallback(tmp_path):
    calls = []

    def bomb(step):
        calls.append(step)
        if step == 5:
            raise RuntimeError("injected disk failure")

    mgr = CheckpointManager(str(tmp_path), interval=2, keep_last=3,
                            failure_hook=bomb)
    live = torch.zeros(4)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, {"x": live + s}, {"step_tag": s}, force=s == 1)
    live += 100.0                     # the queued copies are not aliased
    mgr.wait()
    assert ckpt.available_steps(str(tmp_path)) == [1, 2, 4]
    mgr.save_async(5, {"x": live})
    with pytest.raises(RuntimeError, match="injected"):
        mgr.wait()
    assert calls == [1, 2, 4, 5] and mgr.latest_step() == 4
    _tamper_one_leaf(str(tmp_path / "step_0000000004"))
    torn = tmp_path / "step_0000000009"
    torn.mkdir()                      # no manifest: invisible
    skipped = []
    step, arrays, extra = mgr.restore_latest_arrays(skipped=skipped)
    assert (step, extra, skipped) == (2, {"step_tag": 2}, [4])
    np.testing.assert_array_equal(arrays["x"], np.full(4, 2.0, np.float32))
    mgr.close()
    assert not mgr._writer.is_alive()
    empty = CheckpointManager(str(tmp_path / "nothing"), interval=1)
    assert empty.restore_latest_arrays() == (None, None, {})
    empty.close()
    for args in ((30.0, 5000.0, 1000, 0.5), (1.0, 1.0, 1, 10.0)):
        assert suggest_interval(*args) == j_suggest_interval(*args)


# -- DeltaLog ----------------------------------------------------------------

def test_delta_log_roundtrip_reopen_and_prune(tmp_path):
    log = DeltaLog(str(tmp_path))
    rng = np.random.default_rng(0)
    b1 = log.append([_edge_batch(rng)], meta={"batch": 0})
    b2 = log.append([_edge_batch(rng), _label_batch(rng, 3)],
                    meta={"batch": 1})
    assert [d.seq for d in b1] == [0] and [d.seq for d in b2] == [1, 2]
    log2 = DeltaLog(str(tmp_path))                # reopened: same seq space
    assert log2.head_seq == 2
    (b3,) = log2.append(_edge_batch(rng))
    assert b3.seq == 3
    replayed = list(log2.replay(after_seq=-1))
    assert [seq for seq, _d, _m in replayed] == [0, 1, 2, 3]
    assert replayed[1][2] == {"batch": 1}
    assert [seq for seq, _d, _m in log2.replay(after_seq=1)] == [2, 3]
    log2.prune(upto_seq=1)                        # record (1, 2) spans seq 2
    assert [seq for seq, _d, _m in log2.replay(after_seq=-1)] == [1, 2, 3]
    log2.prune(upto_seq=2)
    assert [seq for seq, _d, _m in log2.replay(after_seq=-1)] == [3]
    with pytest.raises(ValueError, match="empty"):
        log2.append([])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_delta_log_records_cross_packages(tmp_path, writer):
    """A record written by either package replays in the other with the
    same payload, dtypes, seqs and meta."""
    src, dst = np.array([3, 1, 4]), np.array([1, 5, 9])
    w = np.array([0.25, -1.0, 2.0])
    nodes, labs = np.array([2, 7]), np.array([1, -1])
    mod, log_cls, read_cls = ((tdelta, DeltaLog, jsnap.DeltaLog)
                              if writer == "port"
                              else (jdelta, jsnap.DeltaLog, DeltaLog))
    log_cls(str(tmp_path)).append(
        [mod.edge_delta_from_numpy(src, dst, w, pad_to=8),
         mod.label_delta_from_numpy(nodes, labs, pad_to=4)],
        meta={"batch": 5})
    (name,) = os.listdir(tmp_path)
    assert name == "rec_0000000000_002.npz"
    with np.load(tmp_path / name) as data:
        assert {k: str(data[k].dtype) for k in data.files if k != "meta"
                and k != "kinds"} == {
            "d0_src": "int32", "d0_dst": "int32", "d0_weight": "float32",
            "d1_node": "int32", "d1_new_label": "int32"}
        assert data["meta"].shape == ()
    (s0, e, m0), (s1, lab, _m1) = read_cls(str(tmp_path)).replay()
    assert (s0, s1, m0, e.seq, lab.seq) == (0, 1, {"batch": 5}, 0, 1)
    np.testing.assert_array_equal(np.asarray(e.src)[:3], src)
    np.testing.assert_array_equal(np.asarray(e.dst)[:3], dst)
    np.testing.assert_array_equal(np.asarray(e.weight)[:3],
                                  w.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(lab.node)[:2], nodes)
    np.testing.assert_array_equal(np.asarray(lab.new_label)[:2], labs)


def test_watermark_makes_replay_idempotent():
    inc, _s = _inc()
    rng = np.random.default_rng(1)
    stamped = [dataclasses.replace(d, seq=i)
               for i, d in enumerate([_edge_batch(rng), _edge_batch(rng)])]
    for d in stamped:
        inc.apply(d)
    assert inc.applied_seq == 1
    ref = inc.embedding()
    for d in stamped:                      # at-least-once delivery
        inc.apply(d)
    assert inc.stats["skipped_replays"] == 2
    assert torch.equal(inc.embedding(), ref)
    inc.apply(_edge_batch(rng))            # unsequenced still applies
    assert inc.applied_seq == 1


# -- snapshot -> recover ------------------------------------------------------

def _serve_and_snapshot(directory, opts, seed=2):
    """Three batches folded into a snapshot, two more only in the WAL;
    returns the live state."""
    inc, s = _inc(opts)
    index = ClassPartitionedIndex.build(inc.embedding(), s.labels,
                                        s.num_classes)
    service = GEEQueryService(index, inc, flush_every=10**9)
    snap = GEESnapshotter(str(directory), every=10**9)
    server = GEEDeltaServer(inc, flush_every=10**9, log=snap.log)
    rng = np.random.default_rng(seed)
    for b in range(3):
        server.meta = {"batch": b}
        server.submit(_edge_batch(rng))
        server.submit(_label_batch(rng, s.num_classes))
        server.flush()
    snap.snapshot(inc, index, service=service, delta_server=server)
    for b in range(3, 5):
        server.meta = {"batch": b}
        server.submit(_edge_batch(rng))
        server.flush()
    snap.close()
    service.close()
    return inc


@pytest.mark.parametrize("opts", SNAP_OPTS, ids=lambda o: o.tag())
def test_snapshot_recover_exact(tmp_path, opts):
    inc = _serve_and_snapshot(tmp_path, opts)
    st = recover(str(tmp_path), device="cpu")
    assert st.replayed_deltas == 2 and st.last_meta == {"batch": 4}
    assert [e["event"] for e in st.timeline] == [
        "load_snapshot", "replay", "repair_index", "recovered"]
    assert_same_accumulators(st.inc, inc)
    assert torch.equal(st.inc.embedding(), inc.embedding())
    assert st.index.stats["builds"] == 0
    assert st.index._centroids.device.type == "cpu"
    assert st.index._table_dev is None
    z = st.inc.embedding()
    assert torch.equal(st.index.z, z)             # repaired at recovery
    q = z[:8]
    _, sc_f = st.index.search(q, 5, nprobe=st.index.num_cells)
    _, sc_b = st.index.search(q, 5, brute_force=True)
    np.testing.assert_array_equal(sc_f.numpy(), sc_b.numpy())


def test_recover_falls_back_past_corrupt_snapshot(tmp_path):
    inc, _s = _inc()
    snap = GEESnapshotter(str(tmp_path), every=10**9, keep_last=3)
    server = GEEDeltaServer(inc, flush_every=10**9, log=snap.log)
    rng = np.random.default_rng(3)
    server.submit(_edge_batch(rng))
    server.flush()
    snap.snapshot(inc, delta_server=server)          # good snapshot
    server.submit(_edge_batch(rng))
    server.flush()
    step2 = snap.snapshot(inc, delta_server=server)  # will be corrupted
    snap.close()
    _tamper_one_leaf(os.path.join(str(tmp_path), "snapshots",
                                  f"step_{step2:010d}"))
    st = recover(str(tmp_path), device="cpu")
    assert st.snapshot_step < step2 and st.skipped_steps == (step2,)
    assert st.replayed_deltas >= 1 and st.index is None
    assert torch.equal(st.inc.embedding(), inc.embedding())


def test_recover_wal_only_cold_start(tmp_path):
    """No snapshot and no ``cold_start`` raises; with one the whole WAL
    replays into a fresh state; an empty WAL gives the cold state."""
    with pytest.raises(FileNotFoundError):
        recover(str(tmp_path / "empty"), device="cpu")
    k = 3
    ref = IncrementalGEE(N, k, LAP_DIAG, device="cpu")
    log = DeltaLog(os.path.join(str(tmp_path), "wal"))
    rng = np.random.default_rng(8)
    for _ in range(4):
        for d in log.append([_edge_batch(rng), _label_batch(rng, k)]):
            ref.apply(d)
    with pytest.raises(FileNotFoundError):
        recover(str(tmp_path), device="cpu")
    for opts in (LAP_DIAG, {"laplacian": True, "diag_aug": True}):
        st = recover(str(tmp_path), device="cpu", cold_start={
            "num_nodes": N, "num_classes": k, "opts": opts})
        assert st.snapshot_step is None and st.snapshot_watermark == -1
        assert st.replayed_deltas == 8
        assert st.inc.applied_seq == ref.applied_seq == 7
        assert_same_accumulators(st.inc, ref)
        assert torch.equal(st.inc.embedding(), ref.embedding())
    st = recover(str(tmp_path / "cold"), device="cpu",
                 cold_start={"num_nodes": 10, "num_classes": 2})
    assert st.replayed_deltas == 0 and st.inc.applied_seq == -1
    assert torch.equal(st.inc.embedding(), torch.zeros(10, 2))


def test_wal_prune_respects_retained_snapshots(tmp_path):
    inc, _s = _inc()
    snap = GEESnapshotter(str(tmp_path), every=2, keep_last=2)
    server = GEEDeltaServer(inc, flush_every=10**9, log=snap.log)
    rng = np.random.default_rng(4)
    steps = []
    for _ in range(6):
        server.submit(_edge_batch(rng))
        server.flush()
        step = snap.tick(inc, delta_server=server)
        if step is not None:
            steps.append(step)
    snap.close()
    assert len(steps) == 3 and snap.stats["ticks"] == 6
    kept = ckpt.available_steps(os.path.join(str(tmp_path), "snapshots"))
    assert kept == steps[-2:]
    replayable = [seq for seq, _d, _m in
                  DeltaLog(os.path.join(str(tmp_path), "wal")).replay()]
    assert replayable and min(replayable) <= kept[0]


def test_poisoned_batch_rejected_before_wal(tmp_path):
    inc, s = _inc()
    log = DeltaLog(str(tmp_path))
    server = GEEDeltaServer(inc, flush_every=10**9, log=log)
    server.submit(tdelta.edge_delta_from_numpy([0, inc.n + 7], [1, 2],
                                               [1.0, 1.0]))
    with pytest.raises(ValueError):
        server.flush()
    assert log.head_seq == -1 and server.stats["rejected_deltas"] == 2
    server.submit(_edge_batch(np.random.default_rng(5)))
    server.flush()
    assert log.head_seq == 0
    server.submit(tdelta.label_delta_from_numpy([1], [s.num_classes + 3]))
    with pytest.raises(ValueError):
        server.flush()
    assert log.head_seq == 0


# -- both ways across the packages ---------------------------------------------

def _ref_serve_and_snapshot(directory, opts, seed=2):
    """The reference's run of ``_serve_and_snapshot``'s stream."""
    s = j_sample_sbm(N, seed=0)
    inc = JInc.from_graph(s.edges, s.labels, s.num_classes, _jopts(opts))
    index = JIndex.build(inc.embedding(), s.labels, s.num_classes)
    service = JService(index, inc, flush_every=10**9)
    snap = jsnap.GEESnapshotter(str(directory), every=10**9)
    server = JDeltaServer(inc, flush_every=10**9, log=snap.log)
    rng = np.random.default_rng(seed)
    for b in range(3):
        server.meta = {"batch": b}
        server.submit(_edge_batch(rng, mod=jdelta))
        server.submit(_label_batch(rng, s.num_classes, mod=jdelta))
        server.flush()
    snap.snapshot(inc, index, service=service, delta_server=server)
    for b in range(3, 5):
        server.meta = {"batch": b}
        server.submit(_edge_batch(rng, mod=jdelta))
        server.flush()
    snap.close()
    service.close()
    return inc


@pytest.mark.parametrize("opts", SNAP_OPTS, ids=lambda o: o.tag())
def test_directories_recover_across_packages(tmp_path, opts):
    """The same stream served by each package; each directory recovers in
    the other package to the writer's accumulators and watermark, bit for
    bit, with the same index tables, and Z within the row tolerance."""
    t_live = _serve_and_snapshot(tmp_path / "port", opts)
    j_live = _ref_serve_and_snapshot(tmp_path / "ref", opts)
    assert_same_accumulators(t_live, j_live)
    in_port = recover(str(tmp_path / "ref"), device="cpu")
    in_ref = jsnap.recover(str(tmp_path / "port"))
    assert_same_accumulators(in_port.inc, j_live)
    assert_same_accumulators(in_ref.inc, t_live)
    assert in_port.replayed_deltas == in_ref.replayed_deltas == 2
    assert in_port.last_meta == in_ref.last_meta == {"batch": 4}
    for a, b in ((in_port.index, in_ref.index),):
        for name in ("_table", "_cell_len", "_row_cell", "_row_slot",
                     "_active"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (a.metric, a.nprobe, a.pad_multiple) == \
            (b.metric, b.nprobe, b.pad_multiple)
    z_port = in_port.inc.embedding().numpy()
    z_ref = np.asarray(in_ref.inc.embedding())
    scale = np.minimum(np.abs(z_ref).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(z_port - z_ref) <= 1e-5 * np.abs(z_ref)
            + 1e-5 * scale).all()


# -- replicas ---------------------------------------------------------------

def _snapshot_dir_with_index(directory):
    inc, s = _inc()
    index = ClassPartitionedIndex.build(inc.embedding(), s.labels,
                                        s.num_classes)
    service = GEEQueryService(index, inc, flush_every=10**9)
    snap = GEESnapshotter(str(directory), every=10**9)
    snap.snapshot(inc, index, service=service)
    snap.close()
    service.close()
    return inc


def test_replica_staleness_bound_and_catch_up(tmp_path):
    ref = _snapshot_dir_with_index(tmp_path)
    r1, r2 = (GEEReplica.from_directory(str(tmp_path), name=name,
                                        device="cpu", flush_every=10**9)
              for name in ("r1", "r2"))
    assert r1.watermark == ref.applied_seq and r1.backlog == 0
    log = DeltaLog(str(tmp_path / "router_wal"))
    router = ReplicaRouter([r1, r2], max_lag=0, log=log)
    rng = np.random.default_rng(7)
    router.publish([_edge_batch(rng), _edge_batch(rng)], meta={"b": 0})
    assert router.head_seq == log.head_seq == 1
    assert r1.watermark < router.head_seq          # lazily stale
    router.read_rows([0, 1], k=3, max_lag=10)      # lag-tolerant: no catch-up
    assert max(r1.watermark, r2.watermark) < router.head_seq
    ids, _sc = router.read_rows([0, 1], k=3, max_lag=0)
    assert ids.shape == (2, 3) and [int(i) for i in ids[:, 0]] == [0, 1]
    assert max(r1.watermark, r2.watermark) == router.head_seq
    assert router.stats["catch_up_deltas"] == 2
    router.catch_up(r1), router.catch_up(r2)
    assert router._retained == []
    assert_same_accumulators(r1.inc, r2.inc)
    router.close()
    with pytest.raises(ValueError, match="unique"):
        ReplicaRouter([r1, r1])
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])


def test_router_sheds_only_when_every_replica_full(tmp_path):
    _snapshot_dir_with_index(tmp_path)
    reps = [GEEReplica.from_directory(str(tmp_path), name=f"r{i}",
                                      device="cpu", flush_every=10**9,
                                      max_pending=6)
            for i in range(2)]
    router = ReplicaRouter(reps, max_lag=0)
    served = shed = 0
    for _ in range(5):                             # 5*3 = 15 > 2*6 slots
        try:
            router.submit_rows([0, 1, 2])
            served += 1
        except LoadShedError:
            shed += 1
    assert served == 4 and shed == 1
    assert router.stats["shed_reads"] == shed
    assert sum(router.stats["routed"].values()) == served
    router.flush_all()
    assert all(r.backlog == 0 for r in reps)
    router.close()


def test_replica_needs_an_index(tmp_path):
    inc, _s = _inc()
    snap = GEESnapshotter(str(tmp_path), every=10**9)
    snap.snapshot(inc)
    snap.close()
    with pytest.raises(ValueError, match="carries no index"):
        GEEReplica.from_directory(str(tmp_path), device="cpu")


# -- the integration contract: SIGKILL mid-stream, recover, compare ----------

# The reference's STREAM_ARGS (tests/test_recovery.py).  The kill lands at
# the second snapshot, after batch 1 of 153; the 151 batches left (each an
# fsynced WAL record, every second one a snapshot) outlast the 0.05 s poll
# below by far, so the kill cannot miss.
STREAM_ARGS = ["--sbm", "300", "--stream-frac", "0.5", "--batch", "16",
               "--verify-every", "0", "--snapshot-every", "2",
               "--seed", "3", "--lap", "--diag", "--device", "cpu"]
WAIT_S = 240


def _spawn_stream(snapshot_dir, extra=()):
    env = {**os.environ,
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gee_stream", *STREAM_ARGS,
         "--snapshot-dir", str(snapshot_dir), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=30)
        raise AssertionError(f"stream did not end in {WAIT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return out


def test_sigkill_recover_matches_uninterrupted(tmp_path):
    """SIGKILL the port's stream mid-flight, resume it with ``--recover``,
    and the final state equals an uninterrupted run's: the same watermark,
    bit-equal accumulators and Z, and the top 10 of brute force."""
    ref_dir, kill_dir = tmp_path / "ref", tmp_path / "kill"
    ref_proc = _spawn_stream(ref_dir)
    child = _spawn_stream(kill_dir)
    snap_sub = kill_dir / "snapshots"
    deadline = time.time() + WAIT_S
    killed = False
    try:
        while time.time() < deadline and child.poll() is None:
            if snap_sub.is_dir() and len([s for s in os.listdir(snap_sub)
                                          if s.startswith("step_")]) >= 2:
                child.send_signal(signal.SIGKILL)
                child.wait(timeout=30)
                killed = True
                break
            time.sleep(0.05)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert killed, "stream finished before the kill point"

    out = _finish(_spawn_stream(kill_dir, extra=["--recover"]))
    assert "recovered snapshot step" in out
    _finish(ref_proc)

    ref = recover(str(ref_dir), device="cpu")
    rec = recover(str(kill_dir), device="cpu")
    assert rec.inc.applied_seq == ref.inc.applied_seq
    assert_same_accumulators(rec.inc, ref.inc)
    z_ref, z_rec = ref.inc.embedding(), rec.inc.embedding()
    assert torch.equal(z_ref, z_rec)
    rows = np.arange(0, 300, 7)
    ids_b, sc_b = ref.index.search(z_ref[rows], 10, brute_force=True)
    ids_r, sc_r = rec.index.search(z_rec[rows], 10,
                                   nprobe=rec.index.num_cells)
    assert recall_at_k(ids_r.numpy(), sc_r.numpy(), ids_b.numpy(),
                       sc_b.numpy()) == 1.0


def test_gee_stream_resumes_across_packages(tmp_path, capsys):
    """A stream the reference's ``gee_stream`` snapshotted resumes in the
    port's (``--recover``) and ends with the accumulators of the port's
    own uninterrupted run, bit for bit."""
    from repro.launch import gee_stream as j_gee_stream

    from repro_torch.launch import gee_stream

    args = ["--sbm", "300", "--stream-frac", "0.3", "--batch", "16",
            "--verify-every", "0", "--snapshot-every", "2", "--seed", "4",
            "--lap", "--diag", "--cor"]
    j_gee_stream.main(args + ["--max-batches", "3", "--snapshot-dir",
                              str(tmp_path / "mixed")])
    resumed = gee_stream.run(gee_stream.parse_args(
        args + ["--max-batches", "6", "--snapshot-dir",
                str(tmp_path / "mixed"), "--recover", "--device", "cpu"]))
    assert "resuming at batch 3/6" in capsys.readouterr().out
    whole = gee_stream.run(gee_stream.parse_args(
        args + ["--max-batches", "6", "--snapshot-dir",
                str(tmp_path / "port"), "--device", "cpu"]))
    assert resumed["watermark"] == whole["watermark"]
    assert_same_accumulators(resumed["inc"], whole["inc"])
    z_r = resumed["inc"].embedding().numpy()
    z_w = whole["inc"].embedding().numpy()
    scale = np.minimum(np.abs(z_w).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(z_r - z_w) <= 1e-5 * np.abs(z_w) + 1e-5 * scale).all()
