"""The port's training slice (``repro_torch/data/pipeline.py``,
``repro_torch/train/{optimizers,loop}.py``, remat in ``models/lm.py``,
``convert.lm_params_to_reference``) held against the JAX reference
(``repro/data``, ``repro/train``) on the same numpy-seeded inputs: the
data pipeline byte for byte; the cross entropy, the clip and the schedule;
both optimizers on a toy tree; the loss and every leaf's gradient of the
dense, MoE, SSM and hybrid configs reduced (and the 7-layer period-scanned
hybrid); whole train steps for both optimizers at microbatches 1 and 2;
Adafactor's state leaf for leaf in the reference's stacked layout; remat's
gradients bit-equal to none; mamba2's backward; and the committed fixture
that ``chip_smoke.py`` phase 16(a) reads on the card.

The port's train step takes and returns its trees in the reference's
layout, so parameters, gradients and state are compared path for path.
Losses are held within 1e-5 relative and gradients within
``1e-4 * max|want| + 1e-5`` (``within``).  Updated parameters are held
within the bounds derived at ``repro_torch.train.optimizers``'
``adamw_step_bound`` and ``adafactor_step_bound``.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.train import optimizers as jopt

from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference, tree_from_flat,
                                 unstack_layers)
from repro_torch.data import pipeline
from repro_torch.models import lm
from repro_torch.train import loop
from repro_torch.train import optimizers as opt_mod
from repro_torch.train.optimizers import (adafactor_step_bound,
                                          adamw_step_bound)
from repro_torch.tree import (flatten_with_paths, tree_leaves, tree_map,
                              tree_unflatten)

FIXTURES = Path(__file__).parent / "torch_fixtures"
FIXTURE = FIXTURES / "lm_train_reduced.npz"
PARAMS_FIXTURE = FIXTURES / "lm_qwen3_reduced.npz"
FIXTURE_LR = 1e-3
FIXTURE_DATA = dict(seq_len=16, global_batch=4)
# (arch, layers): the four families reduced, and the hybrid at 7 layers
# (its period-scanned layout: two periods of (rec, rec, attn) and a tail)
STACKS = (("qwen3-0.6b", None), ("deepseek-moe-16b", None),
          ("mamba2-2.7b", None), ("recurrentgemma-2b", None),
          ("recurrentgemma-2b", 7))
CHUNK = 8
# f32 unit roundoff
U32 = 2.0 ** -24


@pytest.fixture(autouse=True)
def _one_thread():
    """The reduced models' ops are tiny: one intra-op thread is the
    fastest here, and keeps parallel test workers off each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def within(got, want, rel=1e-4, atol=1e-5):
    """Assert ``|got - want| <= rel * max|want| + atol`` everywhere."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = rel * np.abs(want).max() + atol
    err = np.abs(got - want).max()
    assert err <= bound, f"max-abs {err:.3g} > {bound:.3g}"
    return err


def t(a):
    return torch.from_numpy(np.array(a))


def configs(name, layers=None, **changes):
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    if layers:
        changes["num_layers"] = layers
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(cfg, **changes))


def models(name, layers=None, seed=0, **changes):
    """-> the reference's config and weights, the port's config and the
    same weights in the reference's layout, as the train step takes them
    (through the port's layout and back)."""
    jcfg, cfg = configs(name, layers, **changes)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return jcfg, jp, cfg, lm_params_to_reference(tp, cfg)


def tokens(cfg, b=4, s=16, step=0):
    dc = pipeline.DataConfig(cfg.vocab_size, s, b, seed=1)
    return pipeline.batch_at(dc, step)["tokens"]


def ref_flat(tree) -> dict:
    """A reference tree as ``{path: np.ndarray}``."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def np_flat(tree) -> dict:
    """A port tree as ``{path: f64 np.ndarray}``, paths as the reference
    names them."""
    return {k: v.detach().double().numpy()
            for k, v in flatten_with_paths(tree).items()}


def ref_grads(jcfg, jp, toks):
    fn = jax.jit(jax.value_and_grad(
        functools.partial(jloop.loss_fn, cfg=jcfg, chunk=CHUNK),
        has_aux=True))
    (total, metrics), grads = fn(jp, {"tokens": jnp.asarray(toks)})
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


def adamw_bound(g_got, g_want, p1_got, p1_want, lr):
    """``adamw_step_bound`` of numpy arrays (f32 parameters)."""
    return adamw_step_bound(*(torch.from_numpy(np.array(x, np.float64))
                              for x in (g_got, g_want, p1_got, p1_want)),
                            lr).numpy()


def adafactor_bound(d_want, p0, rel):
    return adafactor_step_bound(torch.from_numpy(np.array(d_want)),
                                torch.from_numpy(np.array(p0)),
                                rel).numpy()


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

DATA_CASES = [dict(vocab_size=100, seq_len=16, global_batch=4, seed=3),
              dict(vocab_size=151_936, seq_len=33, global_batch=8),
              dict(vocab_size=7, seq_len=5, global_batch=2, seed=9,
                   noise=0.5, mult=3, offset=1)]


@pytest.mark.parametrize("case", DATA_CASES)
def test_batch_at_matches_reference(case):
    for step in (0, 1, 17):
        want = jpipe.batch_at(jpipe.DataConfig(**case), step)
        got = pipeline.batch_at(pipeline.DataConfig(**case), step)
        assert set(got) == set(want) == {"tokens"}
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_host_slice_matches_reference():
    dc = dict(vocab_size=100, seq_len=8, global_batch=8)
    full = pipeline.batch_at(pipeline.DataConfig(**dc), 0)
    for count in (1, 2, 4):
        parts = [pipeline.host_slice(full, i, count) for i in range(count)]
        for i, part in enumerate(parts):
            want = jpipe.host_slice(full, i, count)
            assert part["tokens"].tobytes() == want["tokens"].tobytes()
        assert np.concatenate([p["tokens"] for p in parts]).tobytes() \
            == full["tokens"].tobytes()


@pytest.mark.parametrize("step", (0, 5))
def test_encoder_batch_at_matches_reference(step):
    dc = dict(vocab_size=16, seq_len=8, global_batch=4, seed=2)
    want = jpipe.encoder_batch_at(jpipe.DataConfig(**dc), step, 32)
    got = pipeline.encoder_batch_at(pipeline.DataConfig(**dc), step, 32)
    assert set(got) == set(want) == {"frames", "labels"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes()


# ---------------------------------------------------------------------------
# loss, clip, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", (False, True))
def test_cross_entropy_matches_reference(masked):
    """The padded-vocab columns excluded, the mask's count returned, and
    the gradient with respect to the logits the reference's."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 37)) * 3).astype(np.float32)
    labels = rng.integers(0, 30, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(lg):
        return jloop.cross_entropy(lg, jnp.asarray(labels), 30, jmask)[0]

    want, want_n = jloop.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), 30, jmask)
    want_g = jax.grad(jloss)(jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    got, got_n = loop.cross_entropy(lg, t(labels), 30,
                                    None if mask is None else t(mask))
    (got_g,) = torch.autograd.grad(got, lg)
    assert float(got_n) == float(want_n)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    within(got_g.numpy(), want_g)
    assert float(got_g[..., 30:].abs().max()) == 0.0


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 3,
            "b": [rng.standard_normal(5).astype(np.float32)]}
    for max_norm in (0.5, 1e3):
        want, want_n = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        got, got_n = opt_mod.clip_by_global_norm(
            {"a": t(tree["a"]), "b": [t(tree["b"][0])]}, max_norm)
        assert float(got_n) == pytest.approx(float(want_n), rel=1e-6)
        within(got["a"].numpy(), want["a"], rel=1e-6, atol=0)
        within(got["b"][0].numpy(), want["b"][0], rel=1e-6, atol=0)
        assert got["a"].dtype == torch.float32


def test_cosine_schedule_matches_reference():
    jlr = jopt.cosine_schedule(3e-4, warmup=10, total=100, floor=0.1)
    lr = opt_mod.cosine_schedule(3e-4, warmup=10, total=100, floor=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jlr(jnp.int32(step)))
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_tree_map_result_is_freed_without_the_collector():
    """``tree_unflatten`` holds no reference cycle: a tree it built is freed
    as soon as its last reference goes, not when the collector next runs
    (on the card an optimizer step's new parameters or an f32 copy of the
    weights would stay allocated until then)."""
    import gc
    import weakref

    tree = {"a": [torch.ones(3), torch.ones(2)], "b": torch.zeros(4)}
    enabled = gc.isenabled()
    gc.disable()
    try:
        copy = tree_map(lambda x: x + 1, tree)
        refs = [weakref.ref(x) for x in tree_leaves(copy)]
        del copy
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


# ---------------------------------------------------------------------------
# the optimizers on a toy tree, from the same gradients
# ---------------------------------------------------------------------------

def _toy(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "s": [rng.standard_normal((2, 3, 5)).astype(np.float32)]}


def _torch_tree(tree):
    return tree_map(t, tree)


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.1)),
    ("adamw", dict(weight_decay=0.0, max_grad_norm=0.1)),
    ("adafactor", dict(weight_decay=0.01)),
    ("adafactor", dict(max_grad_norm=1e3))])
def test_optimizer_steps_match_reference(name, kw):
    """Three steps from the same gradients (a cosine schedule, so the lr
    moves): parameters, state and metrics within f32 round-off."""
    lr_args = (1e-2, 2, 10)
    jo = jopt.get_optimizer(name, jopt.cosine_schedule(*lr_args), **kw)
    po = opt_mod.get_optimizer(name, opt_mod.cosine_schedule(*lr_args), **kw)
    params = _toy(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    js, ts = jo.init(jp), po.init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda x: x * (step + 1.5), _toy(10 + step))
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = po.update(_torch_tree(grads), ts, tp)
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
        for k, v in ref_flat(jp).items():
            within(np_flat(tp)[k], v, rel=1e-6, atol=0)
        want_state = ref_flat(js)
        got_state = np_flat(ts)
        assert set(got_state) == set(want_state)
        for k, v in want_state.items():
            within(got_state[k], v, rel=1e-5, atol=0)
        assert int(ts["step"]) == step + 1


@pytest.mark.parametrize("chunk", [1 << 26, 8])
def test_adamw_inplace_equals_the_pure_update(chunk, monkeypatch):
    """``adamw(inplace=True)`` writes the pure update's bits into the
    trees it is given (a bf16 and an f32 leaf, a 0-d leaf, and with
    ``chunk`` 8 the leading dims cut into slices), three steps."""
    monkeypatch.setattr(opt_mod, "INPLACE_CHUNK", chunk)
    lr = opt_mod.cosine_schedule(1e-2, 2, 10)
    pure, inpl = (opt_mod.adamw(lr), opt_mod.adamw(lr, inplace=True))
    params = _torch_tree(_toy(0))
    params["h"] = params["w"].to(torch.bfloat16)
    params["z"] = torch.tensor(0.5)
    donated = tree_map(torch.clone, params)
    sp, si = pure.init(params), inpl.init(donated)
    for step in range(3):
        grads = tree_map(lambda x: x * (step + 1.5), params)
        params, sp, mp_ = pure.update(grads, sp, params)
        out, si_out, mi = inpl.update(grads, si, donated)
        assert out is donated and si_out is si
        for a, b in zip(tree_leaves((params, sp)), tree_leaves((out, si))):
            assert torch.equal(a, b)
        assert float(mi["grad_norm"]) == float(mp_["grad_norm"])


# ---------------------------------------------------------------------------
# loss and gradients of every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,layers", STACKS)
def test_loss_and_gradients_match_reference(name, layers):
    """``loss_fn`` (the CE plus, with MoE, the load-balance and z losses)
    and every leaf's gradient, in the reference's stacked layout."""
    jcfg, jp, cfg, tp = models(name, layers)
    toks = tokens(cfg)
    want_total, want_m, want_g = ref_grads(jcfg, jp, toks)
    with torch.no_grad():
        got_total, _ = loop.loss_fn(tp, {"tokens": t(toks)}, cfg,
                                    chunk=CHUNK)
    got_m, got_g = loop.grad_and_metrics(tp, {"tokens": t(toks)}, cfg,
                                         chunk=CHUNK)
    assert float(got_total) == pytest.approx(want_total, rel=1e-5)
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        assert float(got_m[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    if cfg.moe is not None:
        assert {"load_balance", "drop_fraction"} <= set(got_m)
    want = ref_flat(want_g)
    got = np_flat(got_g)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        within(got[k], v)
    assert all(g.dtype == p.dtype for g, p in zip(
        tree_leaves(got_g), tree_leaves(tp)))


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

# (arch, optimizer, microbatches, accumulator dtype)
TRAIN_CASES = [("qwen3-0.6b", "adamw", 1, None),
               ("qwen3-0.6b", "adamw", 2, None),
               ("qwen3-0.6b", "adamw", 2, "bfloat16"),
               ("qwen3-0.6b", "adafactor", 1, None),
               ("qwen3-0.6b", "adafactor", 2, None),
               ("deepseek-moe-16b", "adamw", 2, None),
               ("recurrentgemma-2b", "adafactor", 1, None)]


@pytest.mark.parametrize("name,opt_name,micro,accum", TRAIN_CASES)
def test_train_step_matches_reference(name, opt_name, micro, accum):
    """One ``make_train_step`` against the reference's: the metrics; the
    updated parameters (a) against the reference's optimizer applied to the
    port's own accumulated gradients, within f32 round-off, and (b) against
    the reference's whole step within the derived bound; the optimizer's
    state leaf for leaf, path for path.  A bf16 accumulator rounds the
    running sum, so (b) holds the two steps' own accumulated gradients."""
    layers = 7 if name == "recurrentgemma-2b" else None
    jcfg, jp, cfg, tp = models(name, layers)
    toks = tokens(cfg, b=4)
    lr = 1e-3
    jo = jopt.get_optimizer(opt_name, lr)
    po = opt_mod.get_optimizer(opt_name, lr)
    jstep = jax.jit(jloop.make_train_step(
        jcfg, jo, microbatches=micro, chunk=CHUNK,
        accum_dtype=accum and jnp.dtype(accum)))
    jp1, js1, jm = jstep(jp, jo.init(jp), {"tokens": jnp.asarray(toks)})
    pstep = loop.make_train_step(cfg, po, microbatches=micro, chunk=CHUNK,
                                 accum_dtype=accum)
    ts0 = po.init(tp)
    tp1, ts1, tm = pstep(tp, ts0, {"tokens": t(toks)})
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-7), k

    # the port's accumulated gradient, as the step computes it
    per = toks.shape[0] // micro
    parts = [tree_leaves(loop.grad_and_metrics(
        tp, {"tokens": t(toks[i * per:(i + 1) * per])}, cfg,
        chunk=CHUNK)[1]) for i in range(micro)]
    acc_dt = getattr(torch, accum or "float32")
    acc = [g.to(acc_dt) for g in parts[0]]
    for part in parts[1:]:
        acc = [a + g.to(acc_dt) for a, g in zip(acc, part)]
    g_port = tree_unflatten(tp, [a / micro for a in acc])
    g_got = np_flat(g_port)
    jp_port, js_port, _ = jo.update(_like(g_got, jp), jo.init(jp), jp)

    p0 = ref_flat(jp)
    want_full = ref_flat(jp1)
    want_same = ref_flat(jp_port)
    got = np_flat(tp1)
    # the reference's own gradient of the whole step, for the bound
    g_ref = ref_flat(_ref_step_grads(jcfg, jp, toks, micro, accum))
    scale_got = min(1.0, 1.0 / max(float(tm["grad_norm"]), 1e-9))
    scale_want = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    for k, v in want_full.items():
        # (a) the same gradients: round-off of the update only
        d_same = want_same[k] - p0[k]
        same_bound = 16 * U32 * np.abs(d_same).max() \
            + 2 * U32 * np.abs(p0[k]) + 1e-12
        assert np.all(np.abs(got[k] - want_same[k]) <= same_bound), k
        # (b) the reference's whole step
        if opt_name == "adamw":
            bound = adamw_bound(g_got[k] * scale_got, g_ref[k] * scale_want,
                                got[k], v, lr)
        else:
            bound = adafactor_bound(v - p0[k], p0[k], rel=1e-4)
        err = np.abs(got[k] - v)
        assert np.all(err <= bound), (k, float((err - bound).max()))
    _hold_state(ts1, js_port)


def _like(leaves, like):
    """The ``{path: array}`` ``leaves`` as a reference tree shaped like
    ``like``, f32."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(leaves["/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)],
            jnp.float32), like)


def _ref_step_grads(jcfg, jp, toks, micro, accum=None):
    """The reference's gradient as its train step accumulates it."""
    fn = jax.jit(jax.value_and_grad(
        functools.partial(jloop.loss_fn, cfg=jcfg, chunk=CHUNK),
        has_aux=True))
    per = toks.shape[0] // micro
    parts = [fn(jp, {"tokens": jnp.asarray(toks[i * per:(i + 1) * per])})[1]
             for i in range(micro)]
    acc_dt = jnp.dtype(accum or "float32")

    def accumulate(*g):
        total = g[0].astype(acc_dt)
        for x in g[1:]:
            total = total + x.astype(acc_dt)
        return (total / micro).astype(jnp.float32)

    return jax.tree.map(accumulate, *parts)


def _hold_state(got_state, want_state):
    """The port's optimizer state against the reference's, leaf for leaf,
    path for path (within f32 round-off of the moments)."""
    got = np_flat(got_state)
    want = ref_flat(want_state)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        within(got[k], v, rel=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Adafactor's leaf layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,layers", [("qwen3-0.6b", None),
                                         ("recurrentgemma-2b", 7)])
def test_adafactor_factors_per_stacked_leaf(name, layers):
    """Adafactor on the reference's stacked leaves equals the reference's
    after a step from the same gradients, state and parameters: a norm
    scale, [d] a layer in the port, is one [L, d] leaf there, factored into
    vr [L] and vc [d], and its update clipped by the RMS of the whole
    stack.  ``make_train_step`` hands the optimizer that layout: its state
    after a step has the reference's shapes, path for path.  The same
    optimizer on the port's per-layer trees factors otherwise and lands
    elsewhere, which this test refuses."""
    jcfg, jp, cfg, tp = models(name, layers)
    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), jp)
    jo = jopt.adafactor(1e-2)
    jp1, js1, _ = jo.update(g, jo.init(jp), jp)
    g_layers = lm_params_from_reference(jax.tree.map(np.asarray, g), cfg,
                                        device="cpu")
    po = opt_mod.adafactor(1e-2)
    tp1, ts1, _ = po.update(lm_params_to_reference(g_layers, cfg),
                            po.init(tp), tp)
    _hold_state(ts1, js1)
    for k, v in ref_flat(jp1).items():
        within(np_flat(tp1)[k], v, rel=1e-6, atol=0)
    first = "layers/period/0/ln1" if layers else "layers/ln1"
    assert f"v/{first}/vr" in np_flat(ts1)
    # the train step's state has the reference's paths and shapes
    _, ts_step, _ = loop.make_train_step(cfg, po, chunk=CHUNK)(
        tp, po.init(tp), {"tokens": t(tokens(cfg))})
    assert {k: v.shape for k, v in np_flat(ts_step).items()} \
        == {k: v.shape for k, v in ref_flat(js1).items()}
    # per port layer: a [d] norm is not factored at all
    tl = unstack_layers(tp, cfg)
    bp1, bs1, _ = po.update(g_layers, po.init(tl), tl)
    assert set(bs1["v"]["layers"][0]["ln1"]) == {"v"}
    with pytest.raises(AssertionError):
        for k, v in ref_flat(jp1).items():
            within(np_flat(lm_params_to_reference(bp1, cfg))[k], v,
                   rel=1e-6, atol=0)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ("full", "dots"))
@pytest.mark.parametrize("name,layers", STACKS)
def test_remat_gradients_bit_equal(name, layers, remat):
    """Remat changes memory, not numbers: the loss and every gradient bit
    for bit equal to the run without it (the recomputed forward repeats
    the first one's ops), for every layout ``remat_groups`` checkpoints."""
    _, cfg = configs(name, layers)
    params = lm_params_to_reference(lm.init_params(cfg, 0, device="cpu"),
                                    cfg)
    batch = {"tokens": t(tokens(cfg))}
    m0, g0 = loop.grad_and_metrics(params, batch, cfg, chunk=CHUNK)
    rcfg = dataclasses.replace(cfg, remat=remat)
    m1, g1 = loop.grad_and_metrics(params, batch, rcfg, chunk=CHUNK)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    groups = lm.remat_groups(rcfg)
    assert sorted(i for idx, _ in groups for i in idx) \
        == list(range(cfg.num_layers))


def test_remat_groups_follow_the_reference():
    """Where the reference puts ``jax.checkpoint``: each layer of a scanned
    stack with the config's policy, each period of a period-scanned hybrid
    in full with its tail unwrapped, each layer of a per-layer list in
    full."""
    _, q = configs("qwen3-0.6b", remat="dots")
    assert lm.remat_groups(q) == [([0], "dots"), ([1], "dots")]
    _, h = configs("recurrentgemma-2b", 7, remat="dots")
    assert lm.remat_groups(h) == [([0, 1, 2], "full"), ([3, 4, 5], "full"),
                                  ([6], "none")]
    _, h4 = configs("recurrentgemma-2b", remat="dots")
    assert lm.remat_groups(h4) == [([i], "full") for i in range(4)]


def test_dots_policy_saves_plain_matmuls_only():
    """The selective policy keeps ``mm`` outputs and recomputes batched
    ``bmm``s (``dots_with_no_batch_dims_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    assert lm._dots_policy(None, torch.ops.aten.mm.default) \
        == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default,
               torch.ops.aten.mul.Tensor):
        assert lm._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# mamba2's backward
# ---------------------------------------------------------------------------

def test_mamba2_backward_runs_and_serving_is_unchanged():
    """The SSD's decay product was scaled in place, which autograd refuses
    (``exp`` reads its output back): now it is out of place.  The backward
    runs, and the forward under autograd, a no-grad forward and a prefill
    give the same bits."""
    _, cfg = configs("mamba2-2.7b")
    params = lm.init_params(cfg, 0, device="cpu")
    toks = t(tokens(cfg))
    live = {k: v for k, v in params.items()}
    live["embed"] = params["embed"].detach().requires_grad_(True)
    logits, _, _ = lm.forward(live, {"tokens": toks}, cfg, mode="train")
    logits.sum().backward()
    assert live["embed"].grad is not None
    assert bool(torch.isfinite(live["embed"].grad).all())
    with torch.no_grad():
        quiet, _, _ = lm.forward(params, {"tokens": toks}, cfg)
        pre, _, _ = lm.forward(params, {"tokens": toks}, cfg,
                               mode="prefill")
    assert torch.equal(logits.detach(), quiet)
    assert torch.equal(quiet, pre)


# ---------------------------------------------------------------------------
# the launcher's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", (["--devices", "2"],
                                   ["--model-parallel", "2"]))
def test_launcher_refuses_more_than_one_device(flags, tmp_path):
    """More than one device, once refused, now runs on a mesh: two gloo
    ranks under ``torchrun`` (a (2, 1) or a (1, 2) mesh) log the losses a
    one-process run logs, and started alone the launcher says to use
    ``torchrun``."""
    import os
    import subprocess
    import sys

    from repro_torch.launch import train as launch

    args = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "16", "--log-every", "1", "--device", "cpu"]
    with pytest.raises(SystemExit, match="torchrun"):
        launch.main(args + flags)
    out = tmp_path / "metrics.json"
    src = str(Path(__file__).parent.parent / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
         *flags, "--metrics-out", str(out)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("step     2") == 1       # rank 0 alone prints
    import json

    got = json.loads(out.read_text())
    want = launch.main(args)
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)


# ---------------------------------------------------------------------------
# the reference fixture chip_smoke.py reads on the card
# ---------------------------------------------------------------------------

def build_fixture() -> dict:
    """qwen3-0.6b reduced (the weights of ``lm_qwen3_reduced.npz``,
    ``PRNGKey(0)``), made by the JAX package on the CPU: a ``batch_at``
    batch, the gradient of every leaf (``grad/...``), and for one AdamW
    and one Adafactor step at a constant lr of ``FIXTURE_LR`` the metrics
    (``<opt>/loss``, ``<opt>/grad_norm``) and the updated parameters
    (``<opt>/param/...``), layers stacked as the reference keeps them."""
    cfg = j_get_config("qwen3-0.6b").reduced()
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    toks = jpipe.batch_at(jpipe.DataConfig(cfg.vocab_size, **FIXTURE_DATA),
                          0)["tokens"]
    out = {"tokens": toks}
    _, _, grads = ref_grads(cfg, params, toks)
    out.update({"grad/" + k: v for k, v in ref_flat(grads).items()})
    for name in ("adamw", "adafactor"):
        opt = jopt.get_optimizer(name, FIXTURE_LR)
        p1, _, m = jax.jit(jloop.make_train_step(cfg, opt, chunk=CHUNK))(
            params, opt.init(params), {"tokens": jnp.asarray(toks)})
        out[f"{name}/loss"] = np.float32(m["loss"])
        out[f"{name}/grad_norm"] = np.float32(m["grad_norm"])
        out.update({f"{name}/param/" + k: v
                    for k, v in ref_flat(p1).items()})
    return out


def test_train_fixture_is_current():
    """The committed fixture equals a fresh one from the JAX package: the
    tokens exactly, the rest within 1e-6 (XLA's CPU code may round
    differently on another host); and its weights are the LM fixture's."""
    assert FIXTURE.stat().st_size < 1 << 20
    fresh = build_fixture()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    assert set(stored) == set(fresh)
    for key, want in fresh.items():
        assert stored[key].dtype == want.dtype, key
        if key == "tokens":
            np.testing.assert_array_equal(stored[key], want)
        else:
            np.testing.assert_allclose(stored[key], want, rtol=0, atol=1e-6)
    with np.load(PARAMS_FIXTURE) as f:
        jp = jlm.init_params(jax.random.PRNGKey(0),
                             j_get_config("qwen3-0.6b").reduced())
        for k, v in ref_flat(jp).items():
            np.testing.assert_array_equal(f["param/" + k], v)


def fixture_checks(stored, params, cfg, device):
    """What phase 16(a) runs on the card: one AdamW and one Adafactor step
    of the port from the fixture's weights (``params``, the reference's
    layout) against the fixture -> the worst gradient error over its bound
    and the worst parameter error over its bound (each must be <= 1)."""
    toks = torch.from_numpy(stored["tokens"]).to(device)
    worst = {"grad": 0.0, "param": 0.0}
    p0 = np_flat(params)
    for name in ("adamw", "adafactor"):
        po = opt_mod.get_optimizer(name, FIXTURE_LR)
        m, g = loop.grad_and_metrics(params, {"tokens": toks}, cfg,
                                     chunk=CHUNK)
        p1, _, tm = loop.make_train_step(cfg, po, chunk=CHUNK)(
            params, po.init(params), {"tokens": toks})
        assert float(tm["loss"]) == pytest.approx(
            float(stored[f"{name}/loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(stored[f"{name}/grad_norm"]), rel=1e-5)
        got_g, got_p = np_flat(g), np_flat(p1)
        scale_got = min(1.0, 1.0 / max(float(tm["grad_norm"]), 1e-9))
        scale_want = min(1.0, 1.0 / max(float(stored[f"{name}/grad_norm"]),
                                        1e-9))
        for k in p0:
            want_g = stored["grad/" + k]
            bound_g = 1e-4 * np.abs(want_g).max() + 1e-5
            worst["grad"] = max(worst["grad"], float(
                np.abs(got_g[k] - want_g).max() / bound_g))
            want_p = stored[f"{name}/param/" + k]
            if name == "adamw":
                bound = adamw_bound(got_g[k] * scale_got, want_g * scale_want,
                                    got_p[k], want_p, FIXTURE_LR)
            else:
                bound = adafactor_bound(want_p - p0[k], p0[k], 1e-4)
            worst["param"] = max(worst["param"], float(
                (np.abs(got_p[k] - want_p) / bound).max()))
    return worst


def test_port_matches_train_fixture_on_cpu():
    """What phase 16(a) does on the card, here on the CPU."""
    cfg = get_config("qwen3-0.6b").reduced()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    with np.load(PARAMS_FIXTURE) as f:
        params = lm_params_to_reference(lm_params_from_reference(
            tree_from_flat({k: f[k] for k in f.files}, "param/"), cfg,
            device="cpu"), cfg)
    worst = fixture_checks(stored, params, cfg, "cpu")
    assert worst["grad"] <= 1.0 and worst["param"] <= 1.0, worst


if __name__ == "__main__":              # regenerate the fixture
    FIXTURES.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(FIXTURE, FIXTURE.stat().st_size)
