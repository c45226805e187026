"""The plan's observability in the port (``repro_torch.core.plan``:
``_stage``, ``execute``'s ``plan.execute`` root span, ``last_timings``,
``describe(timings=True)``, the ``plan.*`` counters and histogram;
``repro_torch.obs.cli.plan_span_coverage``), held against the reference's
on the CPU.

Tolerances: a traced execution returns the untraced one's bits (tracing
adds syncs, no arithmetic); the stage names and the counters match the
reference's where both packages have the backend.  Span coverage is a wall
clock share, and the reference's own >= 0.9 bound reads 0.83-0.97 on the
CPU from run to run (``ROADMAP.md`` R2), so the port is held to >= 0.5 in
the best of ``COVERAGE_TRIES`` traced fits: a fit of a few ms on a loaded
host can lose its thread between two stages, which a stage missing its
span would not survive in every try.
"""

import importlib

import numpy as np
import pytest

from repro.core.plan import GEEPlan as JPlan
from repro.core.plan import PreparedGraph as JPrepared
from repro.graph.containers import edge_list_from_numpy as j_edge_list
from repro.graph.containers import symmetrize as j_symmetrize
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace

from repro_torch.core.gee import GEEOptions
from repro_torch.core.plan import KNOWN_BACKENDS, GEEPlan, PreparedGraph
from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
from repro_torch.launch import gee_run
from repro_torch.obs import cli as obs_cli
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace

jgee = importlib.import_module("repro.core.gee")

COVERAGE_FLOOR = 0.5
COVERAGE_TRIES = 5
N, E, K = 60, 400, 3
ALL_ON = GEEOptions(laplacian=True, diag_aug=True, correlation=True)
# the port's backend -> the reference's of the same stages
SAME_STAGES = {"sparse_torch": "sparse_jax", "chunked": "chunked",
               "scipy": "scipy", "python_loop": "python_loop"}


def _arrays():
    rng = np.random.default_rng(9)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    w = (rng.random(E) + 0.25).astype(np.float32)
    labels = rng.integers(0, K, N).astype(np.int32)
    labels[::7] = -1
    return src, dst, w, labels


@pytest.fixture
def fresh_obs():
    """A tracer (off) and a registry of the test's own, for both
    packages."""
    tracer, registry = t_trace.Tracer(), t_metrics.MetricsRegistry()
    prev = t_trace.set_tracer(tracer), t_metrics.set_registry(registry)
    jtracer = j_trace.Tracer(enabled=False, annotate_device=False)
    jprev = j_trace.set_tracer(jtracer), j_metrics.set_registry(
        j_metrics.MetricsRegistry())
    try:
        yield tracer, registry, jtracer
    finally:
        t_trace.set_tracer(prev[0])
        t_metrics.set_registry(prev[1])
        j_trace.set_tracer(jprev[0])
        j_metrics.set_registry(jprev[1])


def _prepared():
    src, dst, w, labels = _arrays()
    return PreparedGraph(symmetrize(edge_list_from_numpy(
        src, dst, w, N, device="cpu"))), labels


@pytest.mark.parametrize("backend", KNOWN_BACKENDS)
def test_traced_execution_times_every_stage(fresh_obs, backend):
    tracer, reg, _ = fresh_obs
    prep, labels = _prepared()
    plan = GEEPlan.build(prep, K, ALL_ON, backend=backend, chunk_edges=97)
    z_ref = plan.execute(labels).numpy()               # untraced
    assert plan.last_timings == {}                     # no trace, no cost
    assert "no traced execution yet" in plan.describe(timings=True)
    assert reg.snapshot()["counters"].get("plan.executions", 0) == 0

    tracer.enable()
    z = plan.execute(labels).numpy()
    np.testing.assert_array_equal(z, z_ref)
    names = [s.name for s in plan.stages]
    timed = plan.last_timings
    assert set(timed) == set(names) | {"total_ms"}
    assert sum(v for n, v in timed.items() if n != "total_ms") <= \
        timed["total_ms"] * 1.1
    desc = plan.describe(timings=True)
    for line, name in zip(desc.splitlines()[1:], names):
        assert name in line and line.endswith(" ms]")
    assert "total" in desc.splitlines()[-1]

    events = tracer.events()
    root = [e for e in events if e.name == "plan.execute"][-1]
    assert root.args["backend"] == backend and root.depth == 0
    stages = [e for e in events if e.name.startswith("plan.stage.")]
    assert [e.name for e in stages] == ["plan.stage." + n for n in names]
    assert all(e.depth == root.depth + 1 for e in stages)

    snap = reg.snapshot()
    assert snap["counters"]["plan.executions"] == 1    # only the traced run
    assert snap["histograms"]["plan.execute_ms"]["count"] == 1
    assert snap["counters"]["plan.cache_hits"] == root.args["cache_hits"]
    assert snap["counters"]["plan.cache_misses"] == root.args["cache_misses"]

    covs = [obs_cli.plan_span_coverage(tracer)]
    for _ in range(COVERAGE_TRIES - 1):
        plan.execute(labels)
        covs.append(obs_cli.plan_span_coverage(tracer))
    assert all(c is not None and c <= 1.0 + 1e-6 for c in covs)
    assert max(covs) >= COVERAGE_FLOOR, covs


def test_cache_tags_and_counters_match_reference(fresh_obs):
    """Cold, then warm: the root span's cache tags, the cached stage flags
    and the ``plan.*`` counters move as the reference's do, and its stages
    carry the reference's names."""
    tracer, reg, jtracer = fresh_obs
    src, dst, w, labels = _arrays()
    jprep = JPrepared(j_symmetrize(j_edge_list(src, dst, w, N)))
    prep, _ = _prepared()
    tracer.enable()
    jtracer.enable()
    for backend, jbackend in SAME_STAGES.items():
        plan = GEEPlan.build(prep, K, ALL_ON, backend=backend)
        jplan = JPlan.build(jprep, K, jgee.GEEOptions(
            laplacian=True, diag_aug=True, correlation=True),
            backend=jbackend)
        for _ in range(2):
            plan.execute(labels)
            jplan.execute(labels)
            got = [e for e in tracer.events() if e.name == "plan.execute"]
            want = [e for e in jtracer.events() if e.name == "plan.execute"]
            for key in ("cache_hits", "cache_misses"):
                assert got[-1].args[key] == want[-1].args[key], backend
        assert list(plan.last_timings) == list(jplan.last_timings), backend
        stages = [e for e in tracer.events()
                  if e.name.startswith("plan.stage.")]
        assert any(e.args.get("cached") for e in stages)
    snap = reg.snapshot()["counters"]
    jsnap = j_metrics.get_registry().snapshot()["counters"]
    for key in ("plan.executions", "plan.cache_hits", "plan.cache_misses"):
        assert snap[key] == jsnap[key], key


def test_coverage_without_a_plan_and_gee_run_prints_it(fresh_obs, tmp_path,
                                                       capsys):
    tracer, _, _ = fresh_obs
    assert obs_cli.plan_span_coverage(tracer) is None
    with tracer.span("not.a.plan"):
        pass
    assert obs_cli.plan_span_coverage(tracer) is None
    trace = str(tmp_path / "t.json")
    assert gee_run.main(["--sbm", "200", "--backend", "streamed_sharded",
                         "--plan", "--trace", trace, "--lap", "--cor",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "window_shard_fold" in out and "gather_rows" in out
    assert "total" in out and "ms (stage syncs forced by tracing)" in out
    assert "% of fit time]" in out
    # one fit's share (the floor is held over several fits above)
    cov = float(out.split("plan stages cover ")[1].split("%")[0]) / 100
    assert 0.0 < cov <= 1.0
