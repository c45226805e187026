"""The port's launch-geometry registry (``repro_torch/kernels/autotune.py``)
held to the reference registry's behaviour (``tests/test_plan.py``), the
port's three geometry policies resolved through it (with nothing recorded,
exactly the policy), recorded geometries reaching a launch, measured search
at launch time only on opt-in, and one cache file serving both packages.

The launches here run on CPU tensors: the contraction's through a stand-in
library that records the geometry it is given, the top-k's chunk counts
through the resolver the wrappers call on the card.
"""

import doctest
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import gee_fused as _jfused          # noqa: F401
from repro.kernels import gee_spmm as _jspmm            # noqa: F401
from repro.kernels import topk_score as _jtopk          # noqa: F401

from repro_torch.kernels import autotune as at
from repro_torch.kernels import gee_spmm as gs
from repro_torch.kernels import topk_score as ts
from repro_torch.kernels.autotune import (REGISTRY, AutotuneRegistry,
                                          ceil_to, pow2_at_least, pow2_bucket)

PORT_KERNELS = (gs.KERNEL_NAME, gs.FUSED_KERNEL_NAME,
                gs.GATHERED_KERNEL_NAME, ts.PAIRWISE_KERNEL,
                ts.GATHERED_KERNEL)
REF_KERNELS = ("gee_spmm", "gee_spmm_fused", "topk_pairwise",
               "topk_gathered")
# the bucket widths of the two main-path graphs and the boundaries of
# launch_geometry (a warp's 32 * SEG_LOADS loads, a span, several spans)
WIDTHS = (1, 3, 4, 7, 8, 16, 64, 127, 128, 512, 2047, 2048, 2052, 4096,
          8191, 8192, 8196, 20000, 262144)
SMS = 132


@pytest.fixture
def clean_registry():
    """The port's REGISTRY with its recorded entries restored afterwards."""
    saved = REGISTRY.recorded()
    yield REGISTRY
    REGISTRY.clear()
    for kernel, entries in saved.items():
        for key, value in entries.items():
            REGISTRY.record(kernel, key, value)


@pytest.fixture
def sm132(monkeypatch):
    monkeypatch.setattr(ts, "_sm_count", lambda device: SMS)
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# the registry itself, as tests/test_plan.py holds the reference's
# ---------------------------------------------------------------------------

def test_autotune_helpers():
    assert ceil_to(1, 8) == 8 and ceil_to(8, 8) == 8 and ceil_to(9, 8) == 16
    assert pow2_at_least(0) == 1 and pow2_at_least(5) == 8
    assert pow2_bucket(3, 100, 1) == (4, 128, 1)
    for x in range(0, 300, 7):
        assert pow2_at_least(x) == jat.pow2_at_least(x)
        assert ceil_to(x, 8) == jat.ceil_to(x, 8)


def test_module_doctest():
    assert doctest.testmod(at).failed == 0


def test_registry_resolution_order_and_roundtrip(tmp_path):
    reg = AutotuneRegistry()
    reg.register("k", table={(8, 8): (1, 1)},
                 fallback=lambda key: (key[0], key[1]))
    assert reg.lookup("k", (8, 8)) == (1, 1)        # table
    assert reg.lookup("k", (16, 8)) == (16, 8)      # formula
    reg.record("k", (16, 8), (2, 2))                # measurement wins
    assert reg.lookup("k", (16, 8)) == (2, 2)
    path = str(tmp_path / "tune.json")
    assert reg.save(path) == path

    reg2 = AutotuneRegistry()
    reg2.register("k", fallback=lambda key: (0, 0))
    assert reg2.load(path) == 1
    assert reg2.lookup("k", (16, 8)) == (2, 2)      # persisted entry
    assert reg2.load(str(tmp_path / "absent.json")) == 0
    reg2.clear("k")
    assert reg2.lookup("k", (16, 8)) == (0, 0)
    with pytest.raises(KeyError):
        reg.lookup("unregistered", (1,))


def test_registry_env_persistence(tmp_path, monkeypatch):
    path = str(tmp_path / "env_tune.json")
    monkeypatch.setenv(at.ENV_CACHE_PATH, path)
    reg = AutotuneRegistry()
    reg.register("k", fallback=lambda key: (3,))
    reg.record("k", (4,), (9,))
    assert reg.save() == path                       # env default path
    reg2 = AutotuneRegistry()
    reg2.register("k", fallback=lambda key: (3,))
    assert reg2.lookup("k", (4,)) == (9,)           # lazy env load


def test_reregister_drops_memo_keeps_recorded():
    reg = AutotuneRegistry()
    reg.register("k", fallback=lambda key: (1,))
    assert reg.lookup("k", (5,)) == (1,)
    reg.record("k", (6,), (7,))
    reg.register("k", fallback=lambda key: (2,))
    assert reg.lookup("k", (5,)) == (2,)            # memo dropped
    assert reg.lookup("k", (6,)) == (7,)            # measurement kept


def test_corrupt_cache_file_is_ignored(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    reg = AutotuneRegistry()
    reg.register("k", fallback=lambda key: (1,))
    assert reg.load(str(path)) == 0
    reg.record("k", (2,), (3,))
    reg.save(str(path))                             # overwrites the junk
    assert json.loads(path.read_text())["recorded"] == {"k": {"2": [3]}}


def test_measured_search_records_the_fastest_and_is_deterministic(
        tmp_path, monkeypatch):
    path = str(tmp_path / "m.json")
    monkeypatch.setenv(at.ENV_CACHE_PATH, path)
    reg = AutotuneRegistry()
    reg.register("k", fallback=lambda key: (1,))
    calls = []

    def runner(c):
        calls.append(c)
        return torch.ones(10 ** c[0])                # bigger is slower

    winner, timings = reg.measured_search("k", (3,), [(5,), (1,), (5,), (3,)],
                                          runner, repeats=2)
    assert winner == (1,) and set(timings) == {(5,), (1,), (3,)}
    assert all(t > 0 for t in timings.values())
    assert reg.lookup("k", (3,)) == (1,)
    assert json.loads(open(path).read())["recorded"] == {"k": {"3": [1]}}
    n = len(calls)
    assert reg.measured_search("k", (3,), [(2,)], runner) == ((1,), {})
    assert len(calls) == n                           # a recorded key: no runs
    with pytest.raises(ValueError):
        reg.measured_search("k", (4,), [], runner)


def test_measure_runtime_on_the_host_clock():
    t = at.measure_runtime(lambda: torch.ones(100), warmup=1, repeats=3)
    assert 0 < t < 1


def test_measure_enabled_reads_the_env(monkeypatch):
    monkeypatch.delenv(at.ENV_MEASURE, raising=False)
    assert not at.measure_enabled()
    for off in ("0", "false", "False", ""):
        monkeypatch.setenv(at.ENV_MEASURE, off)
        assert not at.measure_enabled()
    monkeypatch.setenv(at.ENV_MEASURE, "1")
    assert at.measure_enabled()


# ---------------------------------------------------------------------------
# the port's geometry policies through the registry
# ---------------------------------------------------------------------------

def test_port_kernels_registered_under_names_of_their_own():
    assert set(PORT_KERNELS) <= set(REGISTRY.kernels())
    assert not set(PORT_KERNELS) & set(REF_KERNELS)
    assert not set(PORT_KERNELS) & set(jat.REGISTRY.kernels())
    assert not set(REGISTRY.kernels()) & set(REF_KERNELS)


@pytest.mark.parametrize("kernel", (gs.KERNEL_NAME, gs.FUSED_KERNEL_NAME,
                                    gs.GATHERED_KERNEL_NAME))
def test_contraction_geometry_is_the_policy(kernel, clean_registry):
    """With nothing recorded, every launch geometry resolves to exactly
    ``launch_geometry``'s."""
    clean_registry.clear(kernel)
    n = 0
    for d in WIDTHS:
        for k in (1, 3, 5, 8, 9, 40, 65):
            for vec in (False, True):
                if vec and d % 4:
                    continue
                got = gs.resolve_geometry(kernel, d, k, vec)
                assert got == gs.launch_geometry(d, k, vec), (d, k, vec)
                n += 1
    assert n > 150


@pytest.mark.parametrize("name", ("scored_topk", "scored_topk_gathered"))
def test_topk_chunks_are_the_policy(name, sm132, clean_registry):
    kernel, policy = {"scored_topk": (ts.PAIRWISE_KERNEL, ts._num_chunks),
                      "scored_topk_gathered": (ts.GATHERED_KERNEL,
                                               ts._gathered_chunks)}[name]
    clean_registry.clear(kernel)
    for q in (1, 2, 3, 63, 64, 65, 4096):
        for m in (1, 31, 2047, 2048, 2049, 10000, 58752, 92482, 10 ** 6):
            assert ts.resolve_chunks(kernel, sm132, q, m) \
                == policy(sm132, q, m), (q, m)


def test_topk_key_holds_the_sm_count(monkeypatch, clean_registry):
    dev = torch.device("cpu")
    monkeypatch.setattr(ts, "_sm_count", lambda device: 132)
    assert ts.chunks_key(dev, 64, 92482) == (132, 64, 92482)
    a = ts.resolve_chunks(ts.PAIRWISE_KERNEL, dev, 1, 92482)
    monkeypatch.setattr(ts, "_sm_count", lambda device: 16)
    b = ts.resolve_chunks(ts.PAIRWISE_KERNEL, dev, 1, 92482)
    assert (a, b) == (ts._pairwise_policy(132, 1, 92482),
                      ts._pairwise_policy(16, 1, 92482)) and a != b


def test_check_geometry_rejects_what_the_kernels_refuse(clean_registry,
                                                        sm132):
    assert gs.check_geometry((8, 4096, 1), 100, 5) == (8, 4096, 1)
    assert gs.check_geometry((256, 4096, 5), 20000, 5) == (256, 4096, 5)
    for bad, d, k in (((3, 4096, 1), 100, 5),      # not a power of two
                      ((8, 4096, 1), 100, 9),      # a class tile needs 32
                      ((8, 4096, 2), 100, 5),      # a segment has one span
                      ((512, 4096, 1), 100, 5),    # more than a block
                      ((64, 4098, 5), 20000, 5),   # span not a multiple of 4
                      ((64, 4096, 4), 20000, 5),   # spans != ceil(D / span)
                      ((64, 4096), 20000, 5)):
        with pytest.raises(ValueError):
            gs.check_geometry(bad, d, k)
    clean_registry.record(gs.KERNEL_NAME, gs.geometry_key(100, 5, True),
                          (8, 4096, 3))
    with pytest.raises(ValueError):
        gs.resolve_geometry(gs.KERNEL_NAME, 100, 5, True)
    clean_registry.record(ts.PAIRWISE_KERNEL, (SMS, 1, 5), (0,))
    with pytest.raises(ValueError):
        ts.resolve_chunks(ts.PAIRWISE_KERNEL, sm132, 1, 5)


@pytest.mark.parametrize("d,k", [(7, 3), (64, 5), (2048, 5), (8192, 9),
                                 (20000, 40), (262144, 5)])
def test_geometry_candidates_are_all_launchable(d, k, clean_registry):
    for vec in (False, True):
        if vec and d % 4:
            continue
        cands = gs.geometry_candidates(gs.KERNEL_NAME, d, k, vec)
        assert cands[0] == gs.launch_geometry(d, k, vec)
        assert len(cands) == len(set(cands)) >= 1
        for g in cands:
            gs.check_geometry(g, d, k)
    if d > 4096:
        assert len(gs.geometry_candidates(gs.KERNEL_NAME, d, k, True)) > 2


class _FakeLib:
    """Stands in for the built library: records the geometry each
    contraction launch is given and writes nothing."""

    def __init__(self):
        self.geometries = []

    def gee_spmm_launch(self, *args):
        self.geometries.append((args[-3], args[-2]))      # (lanes, span)
        return 0

    def gee_spmm_fused_launch(self, *args):
        self.geometries.append((args[-3], args[-2]))
        return 0

    def gee_gathered_launch(self, *args):
        self.geometries.append((args[-3], args[-2]))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(gs, "load_library", lambda: lib)
    monkeypatch.setattr(gs, "stream_of", lambda t: 0)
    return lib


def _planes(r, d, k, seed=0):
    rng = np.random.default_rng(seed)
    ylab = torch.from_numpy(rng.integers(-1, k, (r, d)).astype(np.int32))
    contrib = torch.from_numpy(rng.random((r, d)).astype(np.float32))
    return ylab, contrib


def test_launch_takes_the_registry_geometry(fake_launch, clean_registry,
                                            monkeypatch):
    monkeypatch.delenv(at.ENV_MEASURE, raising=False)
    ylab, contrib = _planes(6, 20000, 5)
    vec = gs._vec(ylab, contrib)
    lanes, span, spans = gs.launch_geometry(20000, 5, vec)
    gs.launch_contraction(ylab, contrib, None, None, 5)
    assert fake_launch.geometries[-1] == (lanes, span)
    clean_registry.record(gs.KERNEL_NAME, gs.geometry_key(20000, 5, vec),
                          (128, 8192, 3))
    gs.launch_contraction(ylab, contrib, None, None, 5)
    assert fake_launch.geometries[-1] == (128, 8192)
    # the fused kernel resolves under its own name: still the policy
    rowlab = torch.zeros(6, dtype=torch.int32)
    dadd = torch.zeros(6, dtype=torch.float32)
    gs.launch_contraction(ylab, contrib, rowlab, dadd, 5)
    assert fake_launch.geometries[-1] == (lanes, span)
    assert clean_registry.recorded(gs.FUSED_KERNEL_NAME) == {}


def test_measured_search_runs_at_launch_only_on_opt_in(
        fake_launch, clean_registry, monkeypatch):
    ylab, contrib = _planes(4, 9000, 3)
    key = gs.geometry_key(9000, 3, gs._vec(ylab, contrib))
    clean_registry.clear(gs.KERNEL_NAME)
    monkeypatch.delenv(at.ENV_MEASURE, raising=False)
    monkeypatch.delenv(at.ENV_CACHE_PATH, raising=False)
    gs.launch_contraction(ylab, contrib, None, None, 3)
    assert len(fake_launch.geometries) == 1
    assert clean_registry.recorded(gs.KERNEL_NAME) == {}
    monkeypatch.setenv(at.ENV_MEASURE, "1")
    gs.launch_contraction(ylab, contrib, None, None, 3)
    cands = gs.geometry_candidates(gs.KERNEL_NAME, 9000, 3, True)
    # warmup + 3 repeats a candidate, then the launch itself
    assert len(fake_launch.geometries) == 1 + 4 * len(cands) + 1
    winner = clean_registry.recorded(gs.KERNEL_NAME)[key]
    assert winner in cands
    assert fake_launch.geometries[-1] == winner[:2]
    n = len(fake_launch.geometries)
    gs.launch_contraction(ylab, contrib, None, None, 3)   # recorded: no search
    assert len(fake_launch.geometries) == n + 1


def _gathered(r, d, k, n=50, seed=0):
    """A gathered launch's operands on the CPU: cols, vals, row_ids,
    verts, winv, out."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, n, (r, d)).astype(np.int32)),
            torch.from_numpy(rng.random((r, d)).astype(np.float32)),
            torch.arange(r, dtype=torch.int32),
            torch.from_numpy(rng.integers(-1, k, (n, 2)).astype(np.int32)),
            torch.full((k,), 0.25), torch.zeros((n, k)))


def test_gathered_launch_resolves_under_its_own_name(
        fake_launch, clean_registry, monkeypatch):
    """A geometry recorded for the plane kernels is never taken by the
    gathered launch, and its measured search records under its own name."""
    monkeypatch.delenv(at.ENV_MEASURE, raising=False)
    monkeypatch.delenv(at.ENV_CACHE_PATH, raising=False)
    ops = _gathered(6, 20000, 5)
    vec = gs._vec(ops[0], ops[1])
    key = gs.geometry_key(20000, 5, vec)
    lanes, span, _ = gs.launch_geometry(20000, 5, vec)
    for kernel in (gs.KERNEL_NAME, gs.FUSED_KERNEL_NAME):
        clean_registry.record(kernel, key, (128, 8192, 3))
    clean_registry.clear(gs.GATHERED_KERNEL_NAME)
    assert gs.launch_gathered(*ops, 5, diag_aug=True) is ops[-1]
    assert fake_launch.geometries[-1] == (lanes, span)
    monkeypatch.setenv(at.ENV_MEASURE, "1")
    gs.launch_gathered(*ops, 5)
    cands = gs.geometry_candidates(gs.GATHERED_KERNEL_NAME, 20000, 5, vec)
    assert len(fake_launch.geometries) == 1 + 4 * len(cands) + 1
    winner = clean_registry.recorded(gs.GATHERED_KERNEL_NAME)[key]
    assert winner in cands
    assert fake_launch.geometries[-1] == winner[:2]
    assert clean_registry.recorded(gs.KERNEL_NAME)[key] == (128, 8192, 3)


@pytest.mark.parametrize("d", (6, 130))
def test_gathered_launch_takes_16_byte_loads_only(fake_launch, clean_registry,
                                                  monkeypatch, d):
    """The gathered source is built for 16-byte loads alone: a width off
    them raises before anything is launched or searched."""
    monkeypatch.setenv(at.ENV_MEASURE, "1")
    ops = _gathered(4, d, 3)
    assert not gs._vec(ops[0], ops[1])
    with pytest.raises(ValueError, match="16-byte loads"):
        gs.launch_gathered(*ops, 3, laplacian=True)
    assert fake_launch.geometries == []
    assert not clean_registry.recorded(gs.GATHERED_KERNEL_NAME)


def test_topk_measured_search_on_opt_in(sm132, clean_registry, monkeypatch):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.float32))
    key = ts.chunks_key(sm132, 3, 300)
    clean_registry.clear(ts.PAIRWISE_KERNEL)
    monkeypatch.delenv(at.ENV_CACHE_PATH, raising=False)
    monkeypatch.delenv(at.ENV_MEASURE, raising=False)
    args = (q, x, None, 5)
    kw = {"metric": "l2", "fused": True}
    assert ts._launch_chunks("scored_topk", args, kw, None) \
        == ts._num_chunks(sm132, 3, 300)
    assert ts._launch_chunks("scored_topk", args, kw, 7) == 7
    assert clean_registry.recorded(ts.PAIRWISE_KERNEL) == {}
    monkeypatch.setenv(at.ENV_MEASURE, "1")
    got = ts._launch_chunks("scored_topk", args, kw, None)
    assert clean_registry.recorded(ts.PAIRWISE_KERNEL) == {key: (got,)}
    assert (got,) in ts.chunk_candidates(ts.PAIRWISE_KERNEL, sm132, 3, 300)
    with pytest.raises(ValueError):
        ts._launch_chunks("scored_topk", args, kw, 0)


# ---------------------------------------------------------------------------
# one cache file, both packages
# ---------------------------------------------------------------------------

def test_registry_files_cross_packages(tmp_path, sm132, clean_registry,
                                       monkeypatch):
    """A file the reference's ``AutotuneRegistry.save`` wrote loads into the
    port's REGISTRY, and one the port wrote into the reference's REGISTRY,
    and no lookup of either package changes: the kernel names never meet.
    One merged file then serves each package its own entries."""
    monkeypatch.delenv(at.ENV_CACHE_PATH, raising=False)
    port_keys = ([(gs.KERNEL_NAME, gs.geometry_key(d, 5, True))
                  for d in (4, 64, 2048, 20000)]
                 + [(gs.FUSED_KERNEL_NAME, gs.geometry_key(64, 3, True)),
                    (ts.PAIRWISE_KERNEL, ts.chunks_key(sm132, 64, 92482)),
                    (ts.GATHERED_KERNEL, ts.chunks_key(sm132, 64, 58752))])
    ref_keys = [("gee_spmm", pow2_bucket(10000, 64, 3)),
                ("gee_spmm_fused", pow2_bucket(10000, 64, 3)),
                ("topk_pairwise", pow2_bucket(64, 92482, 5)),
                ("topk_gathered", pow2_bucket(64, 58752, 5))]
    jreg = jat.REGISTRY
    jsaved = jreg.recorded()
    try:
        port_before = {nk: REGISTRY.lookup(*nk) for nk in port_keys}
        ref_before = {nk: jreg.lookup(*nk) for nk in ref_keys}
        # the reference's file, of its own names, into the port
        ref_writer = jat.AutotuneRegistry()
        ref_entries = {}
        for name, key in ref_keys:
            ref_writer.register(name, fallback=lambda key: (0,))
            value = tuple(2 * v for v in ref_before[(name, key)])
            ref_writer.record(name, key, value)
            ref_entries[(name, key)] = value
        ref_file = str(tmp_path / "ref.json")
        assert ref_writer.save(ref_file) == ref_file
        assert REGISTRY.load(ref_file) == len(ref_keys)
        assert {nk: REGISTRY.lookup(*nk) for nk in port_keys} == port_before
        # the port's file, of its own names, into the reference
        port_writer = AutotuneRegistry()
        port_entries = {(gs.KERNEL_NAME, gs.geometry_key(20000, 5, True)):
                        (128, 8192, 3),
                        (ts.PAIRWISE_KERNEL,
                         ts.chunks_key(sm132, 64, 92482)): (4,)}
        for (name, key), value in port_entries.items():
            port_writer.register(name, fallback=lambda key: (0,))
            port_writer.record(name, key, value)
        port_file = str(tmp_path / "port.json")
        port_writer.save(port_file)
        assert jreg.load(port_file) == len(port_entries)
        assert {nk: jreg.lookup(*nk) for nk in ref_keys} == ref_before
        # one file holding both: each package reads its own entries
        port_writer.save(ref_file)                     # merge-on-write
        data = json.loads(open(ref_file).read())["recorded"]
        assert set(data) == set(REF_KERNELS) | {gs.KERNEL_NAME,
                                                ts.PAIRWISE_KERNEL}
        jreader = jat.AutotuneRegistry()
        for name, key in ref_keys:
            jreader.register(name, fallback=lambda key: (0,))
        assert jreader.load(ref_file) == len(ref_keys) + len(port_entries)
        assert {nk: jreader.lookup(*nk) for nk in ref_keys} == ref_entries
        REGISTRY.load(ref_file)
        for nk in port_keys:
            assert REGISTRY.lookup(*nk) == port_entries.get(nk,
                                                            port_before[nk])
    finally:
        jreg.clear()
        for kernel, entries in jsaved.items():
            for k, v in entries.items():
                jreg.record(kernel, k, v)
