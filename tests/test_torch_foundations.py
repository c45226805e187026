"""Port foundations held against the JAX reference: containers, epilogue,
class weights, the host references and the ``sparse_torch`` backend, the
``convert`` hand-over, the device rule and the import boundary.

Inputs are numpy arrays from fixed seeds, handed to both packages; outputs
agree to 1e-5 max-abs (f32 sums taken in another order).
"""

import importlib
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epilogue as jepi
from repro.graph import containers as jcont
from repro.graph.sbm import sample_sbm as j_sample_sbm

from repro_torch.core import epilogue as tepi
from repro_torch.core import gee as tgee
from repro_torch.graph import containers as tcont
from repro_torch.graph.sbm import sample_sbm as t_sample_sbm

# ``repro.core`` re-exports the function ``gee`` under the module's name
jgee = importlib.import_module("repro.core.gee")

ATOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT_IDS = [o.tag() for o in tgee.ALL_OPTION_SETTINGS]


def _jopts(o):
    return jgee.GEEOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                           correlation=o.correlation)


# ---------------------------------------------------------------------------
# the adversarial corners of tests/test_fused_differential.py, written out
# ---------------------------------------------------------------------------

def adversarial(seed, n, k, m_mult=2, hub=False, loops=False,
                unknown=0.0, empty_class=False, pad=False):
    """(src, dst, w, n, labels, k, pad) in the shape of the reference's
    ``adversarial_graphs`` strategy: a tail of untouched nodes stays
    isolated; ``hub`` adds a star on node 0; ``loops`` explicit self
    loops; ``unknown`` the share of -1 labels; ``empty_class`` empties
    class k-1; ``pad`` a zero-weight padded tail."""
    rng = np.random.default_rng(seed)
    m = m_mult * n
    src = rng.integers(0, max(n - 3, 1), m)        # last nodes isolated
    dst = rng.integers(0, max(n - 3, 1), m)
    if hub and n >= 2:
        src = np.concatenate([src, np.zeros(2 * n, np.int64)])
        dst = np.concatenate([dst, rng.integers(1, n, 2 * n)])
    if loops:
        ids = rng.integers(0, n, 3)
        src, dst = np.concatenate([src, ids]), np.concatenate([dst, ids])
    w = rng.uniform(0.2, 2.0, src.shape[0]).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    labels[rng.random(n) < unknown] = -1
    if empty_class and k >= 2:
        labels[labels == k - 1] = -1
    return src, dst, w, n, labels, k, 64 if pad else None


ADVERSARIAL = {
    "isolated": adversarial(1, 20, 3),
    "hub": adversarial(2, 24, 4, hub=True),
    "self_loops": adversarial(3, 15, 2, loops=True),
    "empty_class": adversarial(4, 22, 5, empty_class=True),
    "unknown_labels": adversarial(5, 26, 3, unknown=0.5),
    "padded_tail": adversarial(6, 18, 3, pad=True),
    "everything": adversarial(7, 28, 5, hub=True, loops=True, unknown=0.3,
                              empty_class=True, pad=True),
    "k1": adversarial(8, 9, 1, loops=True),
    "n1_e0": (np.zeros(0, np.int64), np.zeros(0, np.int64),
              np.zeros(0, np.float32), 1, np.array([0], np.int32), 1, None),
}


def both_edge_lists(src, dst, w, n, pad):
    ref = jcont.symmetrize(jcont.edge_list_from_numpy(src, dst, w, n))
    port = tcont.symmetrize(tcont.edge_list_from_numpy(src, dst, w, n,
                                                       device="cpu"))
    if pad:
        ref, port = ref.with_padding(pad), port.with_padding(pad)
    return ref, port


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_containers_match_reference(case):
    src, dst, w, n, _, _, pad = ADVERSARIAL[case]
    ref, port = both_edge_lists(src, dst, w, n, pad)
    assert (port.num_nodes, port.num_edges, port.padded_size) == \
        (ref.num_nodes, ref.num_edges, ref.padded_size)
    for a, b in zip(port.valid_arrays(), ref.valid_arrays()):
        np.testing.assert_array_equal(a, b)
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)))
    rl, pl_ = jcont.add_self_loops(ref), tcont.add_self_loops(port)
    assert pl_.num_edges == rl.num_edges
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(_np(getattr(pl_, name)),
                                      _np(getattr(rl, name)))
    np.testing.assert_allclose(_np(tcont.degrees(port)),
                               _np(jcont.degrees(ref)), atol=ATOL)


def test_edge_list_to_device_and_padding_tail():
    e = tcont.edge_list_from_numpy([0, 1], [1, 2], None, 3, pad_to=5,
                                   device="cpu")
    assert e.padded_size == 5 and e.num_edges == 2
    assert e.to("cpu") is e
    assert float(e.weight[2:].abs().sum()) == 0.0
    assert e.with_padding(5) is e and e.with_padding(4).padded_size == 8


# ---------------------------------------------------------------------------
# epilogue and class weights
# ---------------------------------------------------------------------------

def test_epilogue_matches_reference():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((50, 6)).astype(np.float32)
    z[::7] = 0.0
    np.testing.assert_allclose(
        _np(tepi.row_l2_normalize(torch.from_numpy(z))),
        _np(jepi.row_l2_normalize_jnp(jnp.asarray(z))), atol=ATOL)
    # a row whose squares are denormal: XLA's CPU backend flushes them to
    # zero, so it is held against the numpy twin, which does not
    z[3] = 1e-21
    np.testing.assert_allclose(
        _np(tepi.row_l2_normalize(torch.from_numpy(z))),
        tepi.row_l2_normalize_np(z), atol=ATOL)
    assert float(tepi.row_l2_normalize(torch.from_numpy(z))[3, 0]) > 0.4
    np.testing.assert_array_equal(tepi.row_l2_normalize_np(z),
                                  jepi.row_l2_normalize_np(z))
    z[3] = 0.5
    deg = rng.uniform(0, 5, 40).astype(np.float32)
    deg[::5] = 0.0
    np.testing.assert_allclose(
        _np(tepi.inv_sqrt_degrees(torch.from_numpy(deg))),
        _np(jepi.inv_sqrt_degrees(jnp.asarray(deg))), rtol=1e-6)
    np.testing.assert_array_equal(tepi.inv_sqrt_degrees_np(deg),
                                  jepi.inv_sqrt_degrees_np(deg))
    labels = rng.integers(-1, 6, 50).astype(np.int32)
    winv = rng.uniform(0, 1, 6).astype(np.float32)
    dinv = rng.uniform(0, 1, 50).astype(np.float32)
    for o in tgee.ALL_OPTION_SETTINGS:
        got = tepi.apply_epilogue(torch.from_numpy(z),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(winv),
                                  torch.from_numpy(dinv), opts=o)
        want = jepi.apply_epilogue(jnp.asarray(z), jnp.asarray(labels),
                                   jnp.asarray(winv), jnp.asarray(dinv),
                                   opts=_jopts(o))
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL,
                                   err_msg=o.tag())


def test_row_l2_normalize_impls():
    z = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    for impl in ("auto", "torch", "cuda"):     # cuda on a CPU tensor: plain
        np.testing.assert_allclose(
            _np(tepi.row_l2_normalize(z, impl=impl)), [[0.6, 0.8], [0, 0]])
    with pytest.raises(ValueError, match="unknown impl"):
        tepi.row_l2_normalize(z, impl="pallas")


@pytest.mark.parametrize("k", [1, 3, 7])
def test_class_weights_match_reference(k):
    labels = np.random.default_rng(k).integers(-1, k, 60).astype(np.int32)
    labels[labels == k - 1] = -1                # an empty class
    t = torch.from_numpy(labels)
    np.testing.assert_array_equal(_np(tgee.class_counts(t, k)),
                                  _np(jgee.class_counts(jnp.asarray(labels),
                                                        k)))
    np.testing.assert_allclose(
        _np(tgee.class_weight_inv(t, k)),
        _np(jgee.class_weight_inv(jnp.asarray(labels), k)), rtol=1e-7)


# ---------------------------------------------------------------------------
# backends: sparse_torch vs gee_scipy / gee_sparse_jax, all 8 settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_sparse_torch_matches_scipy_adversarial(case):
    src, dst, w, n, labels, k, pad = ADVERSARIAL[case]
    ref_e, port_e = both_edge_lists(src, dst, w, n, pad)
    s, d, ww = ref_e.valid_arrays()
    for o in tgee.ALL_OPTION_SETTINGS:
        want = jgee.gee_scipy(s, d, ww, labels, k, _jopts(o), num_nodes=n)
        got = tgee.gee_sparse_torch(port_e, torch.from_numpy(labels), k, o)
        np.testing.assert_allclose(_np(got), want, atol=ATOL,
                                   err_msg=f"{case} {o.tag()}")


@pytest.mark.parametrize("case", ["everything", "n1_e0", "hub"])
@pytest.mark.parametrize("opts", tgee.ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_sparse_torch_matches_sparse_jax(case, opts):
    src, dst, w, n, labels, k, pad = ADVERSARIAL[case]
    ref_e, port_e = both_edge_lists(src, dst, w, n, pad)
    want = jgee.gee_sparse_jax(ref_e, jnp.asarray(labels), k, _jopts(opts))
    got = tgee.gee_sparse_torch(port_e, torch.from_numpy(labels), k, opts)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("seed", [0])
def test_sparse_torch_matches_reference_on_sbm(seed):
    ref, port = j_sample_sbm(150, seed=seed), t_sample_sbm(150, seed=seed,
                                                           device="cpu")
    s, d, w = ref.edges.valid_arrays()
    for o in tgee.ALL_OPTION_SETTINGS:
        got = _np(tgee.gee_sparse_torch(port.edges, port.labels, 3, o))
        np.testing.assert_allclose(
            got, jgee.gee_scipy(s, d, w, ref.labels, 3, _jopts(o)),
            atol=ATOL, err_msg=o.tag())
        np.testing.assert_allclose(
            got, _np(jgee.gee_sparse_jax(ref.edges, jnp.asarray(ref.labels),
                                         3, _jopts(o))),
            atol=ATOL, err_msg=o.tag())


@pytest.mark.parametrize("case", ["everything", "self_loops", "n1_e0"])
def test_host_copies_equal_reference(case):
    src, dst, w, n, labels, k, pad = ADVERSARIAL[case]
    ref_e, _ = both_edge_lists(src, dst, w, n, pad)
    s, d, ww = ref_e.valid_arrays()
    for o in tgee.ALL_OPTION_SETTINGS:
        np.testing.assert_array_equal(
            tgee.gee_scipy(s, d, ww, labels, k, o, num_nodes=n),
            jgee.gee_scipy(s, d, ww, labels, k, _jopts(o), num_nodes=n))
        np.testing.assert_array_equal(
            tgee.gee_python_loop(s, d, ww, labels, k, o, num_nodes=n),
            jgee.gee_python_loop(s, d, ww, labels, k, _jopts(o),
                                 num_nodes=n))


def test_options_and_settings_mirror_reference():
    assert [o.tag() for o in tgee.ALL_OPTION_SETTINGS] == \
        [o.tag() for o in jgee.ALL_OPTION_SETTINGS]


# ---------------------------------------------------------------------------
# the device rule and the import boundary
# ---------------------------------------------------------------------------

def test_default_device_without_gpu_raises(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core.api import GEEEmbedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcont.edge_list_from_numpy([0], [1], None, 2)
    e = tcont.edge_list_from_numpy([0], [1], None, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GEEEmbedder(num_classes=2).fit_transform(e, np.array([0, 1]))
    z = GEEEmbedder(num_classes=2, device="cpu").fit_transform(
        e, np.array([0, 1]))
    assert z.device.type == "cpu"


def _port_modules():
    root = os.path.join(SRC, "repro_torch")
    mods = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "repro_torch.core.plan" in mods and len(mods) >= 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_name_jax_or_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)"
                     r"|from repro\.)", re.MULTILINE)
    root = os.path.join(SRC, "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(SRC, "..", "chip_smoke.py"))
    offenders = []
    for path in files:
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(path)
    assert not offenders, offenders
