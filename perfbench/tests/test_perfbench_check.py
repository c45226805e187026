"""What decides ``correct``: a sound run passes, and the control and every
fault a cell can have fail.  Each drives the rest of a run on the CPU,
small (the look for a chip skipped), with the timed path broken
underneath; the limits are the committed ones of ``perfbench/checks/``.

The control is the reference computed in bfloat16 (the step below the
float32 the configurations state) put in the program's place.  The faults:
a step that returns its state unchanged (a fit or a flush answering with
the previous one's result), half of the batch left out (a fit over half
of the edges, a flush answering its second half with its first), and an
answer altered where it is produced (an id changed, or the best id served
twice, as a merge fault of a top-k would).  One card, so no exchange between
cards to leave out."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

from repro_torch.core.api import GEEEmbedder  # noqa: E402
from repro_torch.core.plan import PreparedGraph  # noqa: E402
from repro_torch.graph.containers import EdgeList  # noqa: E402
from repro_torch.search.index import ClassPartitionedIndex  # noqa: E402

BENCH = harness.load_benchmark(ROOT)
SMALL = {"cl-100k-1d8-l5": {"num_nodes": 2000, "num_edges": 40000},
         "sbm-10k": {"num_nodes": 500}}
FITS = ["cl-100k-1d8-l5.refit", "sbm-10k.sweep8"]
QUERY = ["cl-100k-1d8-l5.query"]


def _run(workload, seed=123456789012):
    found = harness.find_cell(BENCH, workload, ROOT)
    found["config"].update(SMALL[found["cell"]["config"]])
    found["traffic"].update(query_set=300, warmup_flushes=2)
    result, lines, _ = harness.run_cell(found, workload, seed, 0.4, False,
                                        "cpu", harness.Clock())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert lines and all(line.startswith("check ") for line in lines)
    return result


@pytest.mark.parametrize("workload", FITS + QUERY)
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", FITS + QUERY)
def test_the_bfloat16_control_is_not_correct(workload):
    from perfbench import control

    found = harness.find_cell(BENCH, workload, ROOT)
    found["config"].update(SMALL[found["cell"]["config"]])
    found["traffic"].update(query_set=300, warmup_flushes=2)
    got = control.read(workload, 99, 0.3, "cpu", found)
    limits = found["limits"]
    assert all(v <= limits[k] for k, v in got["program"].items())
    assert any(v > limits[k] for k, v in got["control_bfloat16"].items()), \
        got


def _stale_fit(monkeypatch):
    orig = GEEEmbedder.fit_transform
    last = {}

    def fit_transform(self, edges, labels):
        z = orig(self, edges, labels)
        prev, last["z"] = last.get("z"), z
        return z if prev is None else prev.clone()
    monkeypatch.setattr(GEEEmbedder, "fit_transform", fit_transform)


def _half_fit(monkeypatch):
    orig = GEEEmbedder.fit_transform

    def fit_transform(self, edges, labels):
        base = edges.base
        m = base.num_edges // 2
        half = EdgeList(src=base.src[:m], dst=base.dst[:m],
                        weight=base.weight[:m], num_nodes=base.num_nodes,
                        num_edges=m)
        return orig(self, PreparedGraph(half), labels) * 2.0
    monkeypatch.setattr(GEEEmbedder, "fit_transform", fit_transform)


def _altered_fit(monkeypatch):
    orig = GEEEmbedder.fit_transform

    def fit_transform(self, edges, labels):
        z = orig(self, edges, labels).clone()
        z[7] = z[7].flip(0)
        z[8, 0] += 1e-3 * z[8].abs().max()
        return z
    monkeypatch.setattr(GEEEmbedder, "fit_transform", fit_transform)


@pytest.mark.parametrize("fault", [_stale_fit, _half_fit, _altered_fit])
@pytest.mark.parametrize("workload", FITS)
def test_a_broken_fit_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(workload)["correct"]


def _stale_flush(monkeypatch):
    orig = ClassPartitionedIndex.search
    last = {}

    def search(self, queries, k=10, **kw):
        out = orig(self, queries, k, **kw)
        prev, last["out"] = last.get("out"), out
        return out if prev is None else prev
    monkeypatch.setattr(ClassPartitionedIndex, "search", search)


def _half_flush(monkeypatch):
    orig = ClassPartitionedIndex.search

    def search(self, queries, k=10, **kw):
        ids, scores = orig(self, queries, k, **kw)
        h = ids.shape[0] // 2
        ids, scores = ids.clone(), scores.clone()
        ids[h:2 * h], scores[h:2 * h] = ids[:h], scores[:h]
        return ids, scores
    monkeypatch.setattr(ClassPartitionedIndex, "search", search)


def _altered_flush(monkeypatch):
    orig = ClassPartitionedIndex.search

    def search(self, queries, k=10, **kw):
        ids, scores = orig(self, queries, k, **kw)
        ids = ids.clone()
        ids[5, 3] = (ids[5, 3] + 1) % self.num_points
        return ids, scores
    monkeypatch.setattr(ClassPartitionedIndex, "search", search)


def _duplicate_flush(monkeypatch):
    orig = ClassPartitionedIndex.search

    def search(self, queries, k=10, **kw):
        ids, scores = orig(self, queries, k, **kw)
        ids, scores = ids.clone(), scores.clone()
        ids[5, 1], scores[5, 1] = ids[5, 0], scores[5, 0]
        return ids, scores
    monkeypatch.setattr(ClassPartitionedIndex, "search", search)


@pytest.mark.parametrize("fault", [_stale_flush, _half_flush,
                                   _altered_flush, _duplicate_flush])
@pytest.mark.parametrize("workload", QUERY)
def test_a_broken_flush_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(workload)["correct"]


def test_the_limits_lie_between_their_readings():
    """Each limit above the program's largest sound reading and below the
    control's smallest (an exact count: 0), and the control failing at
    least one number of every cell."""
    import json

    for w in (c["name"] for c in BENCH["workloads"]):
        data = json.loads((ROOT / f"perfbench/checks/{w}.json").read_text())
        failed = False
        for name, limit in data["limits"].items():
            lo = data["readings"][name]["program_max"]
            hi = data["readings"][name]["control_min"]
            if limit == 0:
                assert lo == 0, (w, name)
            else:
                assert lo < limit < hi, (w, name)
            failed |= hi > limit
        assert failed, w
