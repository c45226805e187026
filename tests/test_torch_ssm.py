"""The port's SSM and hybrid decoders (``repro_torch/models/ssm.py``,
``repro_torch/models/rglru.py``, the ``ssm`` and ``hybrid`` families through
``repro_torch/models/lm.py``, ``repro_torch.convert`` and the serving path)
held against the JAX reference (``repro/models/{ssm,rglru,lm}.py``,
``repro/serve``) on the same numpy-seeded inputs, reduced configs, f32.

Floats are held within ``1e-4 * max|want| + 1e-5``: the mixers and their
carried states, the SSD chunk rule at lengths the configured chunk does not
divide, the full stacks' forward and prefill + decode for ``mamba2-2.7b``
and ``recurrentgemma-2b`` reduced, and the hybrid at 7 layers, where the
reference scans periods and keeps its parameters by pattern position (the
port's conversion must interleave them in order).  Also the committed
reference fixtures that ``chip_smoke.py`` phase 15(b) reads on the card,
regenerated here so they cannot go stale.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.serve import batching as jbatching

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, tree_from_flat
from repro_torch.models import lm, rglru, ssm
from repro_torch.serve import decode
from repro_torch.serve.batching import BatchedServer, Request

FIXTURES = Path(__file__).parent / "torch_fixtures"
FIXTURE_FILES = {"mamba2-2.7b": FIXTURES / "lm_mamba2_reduced.npz",
                 "recurrentgemma-2b": FIXTURES / "lm_recurrentgemma_l7.npz"}
FIXTURE_LAYERS = {"mamba2-2.7b": None, "recurrentgemma-2b": 7}
FIXTURE_PREFILL = 9
# (arch, layers): the reduced stacks, and the hybrid at 7 layers
STACKS = (("mamba2-2.7b", None), ("recurrentgemma-2b", None),
          ("recurrentgemma-2b", 7))


def within(got, want, rel=1e-4, atol=1e-5):
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


def models(name, layers=None, seed=0):
    jcfg, cfg = configs(name, layers)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return jcfg, jp, cfg, tp


def randomize_vectors(jp, seed, scale=0.3):
    """The mixer's 1-D parameters (norm scales, the SSM's and RG-LRU's
    gates, all zeros or ramps at init) perturbed, so every gate matters."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jp.items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = jnp.asarray(v)
    return out


def inputs(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def ssm_params(cfg, jcfg, seed=0):
    jp = randomize_vectors(jssm.init_ssm(jax.random.PRNGKey(seed), jcfg),
                           seed)
    return jp, {k: t(v) for k, v in jp.items()}


def rglru_params(cfg, jcfg, seed=0):
    jp = randomize_vectors(jrglru.init_rglru(jax.random.PRNGKey(seed), jcfg),
                           seed)
    return jp, {k: t(v) for k, v in jp.items()}


def hold_state(got, want):
    within(got["h"].numpy(), want["h"])
    within(got["conv"].numpy(), want["conv"])
    assert got["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the SSD mixer
# ---------------------------------------------------------------------------

def test_chunk_rule_halves_until_it_divides():
    assert ssm.chunk_len(384, 128) == 128
    assert ssm.chunk_len(96, 128) == 96
    assert ssm.chunk_len(200, 128) == 8
    assert ssm.chunk_len(21, 16) == 1
    assert ssm.chunk_len(24, 16) == 8


@pytest.mark.parametrize("seq,chunk", [(16, 16), (32, 16), (24, 16),
                                       (21, 16), (5, 16), (200, 128)])
def test_ssm_forward_matches_reference(seq, chunk):
    """Whole chunks, several, a length the chunk does not divide (halved
    to 8), an odd one (chunks of 1), a short one, and 200 tokens under the
    published chunk of 128 (no factor 128: chunks of 8); the final state
    and the conv tail too."""
    jcfg, cfg = configs("mamba2-2.7b")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=chunk))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=chunk))
    jp, tp = ssm_params(cfg, jcfg)
    u = inputs(cfg, s=seq, seed=seq)
    jy, jst = jssm.ssm_forward(jp, jnp.asarray(u), jcfg, return_state=True)
    gy, gst = ssm.ssm_forward(tp, t(u), cfg, return_state=True)
    within(gy.numpy(), jy)
    hold_state(gst, jst)
    assert ssm.ssm_forward(tp, t(u), cfg)[1] is None


def test_ssm_decode_matches_reference_and_commits_rows():
    jcfg, cfg = configs("mamba2-2.7b")
    jp, tp = ssm_params(cfg, jcfg, seed=1)
    u = inputs(cfg, b=3, s=16, seed=2)
    _, jst = jssm.ssm_forward(jp, jnp.asarray(u[:, :9]), jcfg,
                              return_state=True)
    _, gst = ssm.ssm_forward(tp, t(u[:, :9]), cfg, return_state=True)
    for step in range(9, 16):
        jy, jst = jssm.ssm_decode(jp, jnp.asarray(u[:, step:step + 1]), jst,
                                  jcfg)
        gy, gst = ssm.ssm_decode(tp, t(u[:, step:step + 1]), gst, cfg)
        within(gy.numpy(), jy)
        hold_state(gst, jst)
    before = {k: v.clone() for k, v in gst.items()}
    jy, jnew = jssm.ssm_decode(jp, jnp.asarray(u[:, :1]), jst, jcfg)
    gy, _ = ssm.ssm_decode(tp, t(u[:, :1]), gst, cfg,
                           rows=torch.tensor([False, True, False]))
    within(gy.numpy(), jy)                     # every row computed
    for k in ("h", "conv"):
        assert torch.equal(gst[k][[0, 2]], before[k][[0, 2]])
        within(gst[k][1].numpy(), np.asarray(jnew[k])[1])


# ---------------------------------------------------------------------------
# the RG-LRU mixer
# ---------------------------------------------------------------------------

def test_linear_scan_holds_where_a_closed_form_underflows():
    """log a = -17 a step: the running product underflows f32 within ~6
    steps, the doubling scan does not divide by it."""
    rng = np.random.default_rng(0)
    a = np.exp(-17.0 * rng.uniform(0.5, 1.0, (2, 70, 5))).astype(np.float32)
    b = rng.standard_normal((2, 70, 5)).astype(np.float32)
    want = np.zeros_like(b, np.float64)
    h = np.zeros((2, 5))
    for i in range(70):
        h = a[:, i] * h + b[:, i]
        want[:, i] = h
    got = rglru.linear_scan(t(a), t(b))
    assert bool(torch.isfinite(got).all())
    within(got.numpy(), want, rel=1e-6, atol=1e-7)
    for s in (1, 2, 3, 64):
        within(rglru.linear_scan(t(a[:, :s]), t(b[:, :s])).numpy(),
               want[:, :s], rel=1e-6, atol=1e-7)


@pytest.mark.parametrize("seq", (1, 3, 16, 33))
def test_rglru_forward_matches_reference(seq):
    jcfg, cfg = configs("recurrentgemma-2b")
    jp, tp = rglru_params(cfg, jcfg)
    x = inputs(cfg, s=seq, seed=seq)
    jy, jst = jrglru.rglru_forward(jp, jnp.asarray(x), jcfg,
                                   return_state=True)
    gy, gst = rglru.rglru_forward(tp, t(x), cfg, return_state=True)
    within(gy.numpy(), jy)
    hold_state(gst, jst)


def test_rglru_decode_matches_reference_and_commits_rows():
    jcfg, cfg = configs("recurrentgemma-2b")
    jp, tp = rglru_params(cfg, jcfg, seed=1)
    x = inputs(cfg, b=3, s=12, seed=3)
    _, jst = jrglru.rglru_forward(jp, jnp.asarray(x[:, :5]), jcfg,
                                  return_state=True)
    _, gst = rglru.rglru_forward(tp, t(x[:, :5]), cfg, return_state=True)
    for step in range(5, 12):
        jy, jst = jrglru.rglru_decode(jp, jnp.asarray(x[:, step:step + 1]),
                                      jst, jcfg)
        gy, gst = rglru.rglru_decode(tp, t(x[:, step:step + 1]), gst, cfg)
        within(gy.numpy(), jy)
        hold_state(gst, jst)
    before = {k: v.clone() for k, v in gst.items()}
    jy, jnew = jrglru.rglru_decode(jp, jnp.asarray(x[:, :1]), jst, jcfg)
    gy, _ = rglru.rglru_decode(tp, t(x[:, :1]), gst, cfg,
                               rows=torch.tensor([True, False, False]))
    within(gy.numpy(), jy)
    for k in ("h", "conv"):
        assert torch.equal(gst[k][1:], before[k][1:])
        within(gst[k][0].numpy(), np.asarray(jnew[k])[0])


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def ref_layer_caches(jcfg, jc):
    """The reference's caches as one dict a layer (unstacking a scanned
    stack or the period layout), numpy."""
    if isinstance(jc, dict) and "period" in jc:
        period, n_per, _ = jcfg.period_info
        out = [jax.tree.map(lambda a, i=i: np.asarray(a)[i], jc["period"][j])
               for i in range(n_per) for j in range(len(period))]
        return out + [jax.tree.map(np.asarray, c) for c in jc["tail"]]
    if isinstance(jc, dict):
        return [jax.tree.map(lambda a, i=i: np.asarray(a)[i], jc)
                for i in range(jcfg.num_layers)]
    return [jax.tree.map(np.asarray, c) for c in jc]


def hold_caches(jcfg, gc, jc):
    want = ref_layer_caches(jcfg, jc)
    assert len(want) == jcfg.num_layers
    for i, w in enumerate(want):
        g = lm.layer_cache(gc, i)
        assert set(g) == set(w)
        for name in w:
            if name == "pos":
                np.testing.assert_array_equal(g[name].numpy(), w[name])
            else:
                within(g[name].numpy(), w[name])


@pytest.mark.parametrize("name,layers", STACKS)
def test_forward_matches_reference(name, layers):
    jcfg, jp, cfg, tp = models(name, layers)
    assert cfg.use_period_scan == (layers == 7)
    toks = _tokens(cfg)
    want, _, jaux = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                chunk=8)
    got, caches, aux = lm.forward(tp, {"tokens": t(toks)}, cfg, chunk=8)
    assert caches is None and aux == {} and jaux == {}
    within(got.numpy(), want)
    jl, jc, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill", chunk=4)
    gl, gc, _ = lm.forward(tp, {"tokens": t(toks)}, cfg, mode="prefill",
                           chunk=4)
    within(gl.numpy(), jl)
    hold_caches(jcfg, gc, jc)
    assert isinstance(gc, dict) == lm.stacked(cfg) == (name == "mamba2-2.7b")


@pytest.mark.parametrize("name,layers", STACKS)
@pytest.mark.parametrize("half,cache_len", [(9, 16), (11, None)])
def test_prefill_decode_matches_reference(name, layers, half, cache_len):
    """Prefill then decode past it; for the hybrid both past its window of
    8 (a ring of 8 slots by default) and into a 16-slot cache."""
    jcfg, jp, cfg, tp = models(name, layers, seed=1)
    toks = _tokens(cfg, seed=1)
    total = toks.shape[1]
    jl, jc, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks[:, :half])},
                            jcfg, mode="prefill", chunk=4,
                            cache_len=cache_len)
    gl, gc, _ = lm.forward(tp, {"tokens": t(toks[:, :half])}, cfg,
                           mode="prefill", chunk=4, cache_len=cache_len)
    gouts = [gl[:, -1:]]
    for step in range(half, total):
        jlg, jc = jlm.decode_step(jp, jnp.asarray(toks[:, step:step + 1]), jc,
                                  jnp.int32(step), jcfg)
        glg, gc = lm.decode_step(tp, t(toks[:, step:step + 1]), gc, step,
                                 cfg)
        within(glg.numpy(), jlg)
        gouts.append(glg)
    hold_caches(jcfg, gc, jc)
    want_full, _, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    within(torch.cat(gouts, 1).numpy(), np.asarray(want_full)[:, half - 1:])


def test_period_layout_is_interleaved_in_order():
    """Layer i * 3 + j of the 7-layer hybrid is the reference's
    ``period[j][i]``; the tail follows.  Positions 0 and 1 (rec, rec) have
    one shape, so swapping them converts without error, and computes
    something else."""
    jcfg, jp, cfg, tp = models("recurrentgemma-2b", 7, seed=2)
    period, n_per, tail = cfg.period_info
    assert (period, n_per, tail) == (("rec", "rec", "attn"), 2, ("rec",))
    for i in range(n_per):
        for j in range(len(period)):
            key = "w_out" if period[j] == "rec" else "wo"
            got = tp["layers"][i * 3 + j]["mixer"][key].numpy()
            want = np.asarray(jp["layers"]["period"][j]["mixer"][key][i])
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tp["layers"][6]["ffn"]["w_up"].numpy(),
        np.asarray(jp["layers"]["tail"][0]["ffn"]["w_up"]))
    toks = t(_tokens(cfg, seed=2))
    good, _, _ = lm.forward(tp, {"tokens": toks}, cfg)
    swapped = dict(tp, layers=[tp["layers"][1], tp["layers"][0]]
                   + tp["layers"][2:])
    bad, _, _ = lm.forward(swapped, {"tokens": toks}, cfg)
    assert float((bad - good).abs().max()) > 1e-2 * float(good.abs().max())
    wrong = jax.tree.map(np.asarray, jp)
    wrong["layers"]["tail"] = []
    with pytest.raises(ValueError):
        lm_params_from_reference(wrong, cfg, device="cpu")


def test_caches_by_kind_and_slot_reset():
    _, _, cfg, tp = models("mamba2-2.7b")
    c = lm.init_caches(cfg, 3, 8, device="cpu")
    assert set(c) == {"h", "conv"}
    assert tuple(c["h"].shape) == (2, 3, 8, 16, 16)
    assert c["h"].dtype == torch.float32
    _, _, hcfg, _ = models("recurrentgemma-2b")
    hc = lm.init_caches(hcfg, 3, 32, device="cpu")
    assert [sorted(x) for x in hc] == [["conv", "h"], ["conv", "h"],
                                       ["k", "pos", "v"], ["conv", "h"]]
    assert hc[2]["k"].shape[1] == 8                     # the window
    for caches, config, params in ((c, cfg, tp),):
        server = BatchedServer(params, config, batch_slots=3, max_len=8,
                               device="cpu")
        for _, leaf, bd in lm.cache_leaves(server.caches):
            leaf.normal_()
        server._reset_slot(1)
        for _, leaf, bd in lm.cache_leaves(server.caches):
            assert (leaf.select(bd, 1) == 0).all()
            assert (leaf.select(bd, 0) != 0).any()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lens, news = (5, 3, 7, 4, 6), (6, 8, 4, 7, 5)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, news))]


def reference_server_tokens(jcfg, jp, slots, max_len):
    jserver = jbatching.BatchedServer(jp, jcfg, batch_slots=slots,
                                      max_len=max_len)
    for r in _requests(jcfg):
        jserver.submit(jbatching.Request(uid=r.uid, prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens))
    return {r.uid: list(map(int, r.output)) for r in jserver.run()}


@pytest.mark.parametrize("name", ("mamba2-2.7b", "recurrentgemma-2b"))
def test_batched_server_matches_reference(name):
    """Staggered slots (5 requests, 2 slots): every call runs one position
    group while the other slot's state sits elsewhere; the tokens are the
    reference server's."""
    jcfg, jp, cfg, tp = models(name, seed=3)
    server = BatchedServer(tp, cfg, batch_slots=2, max_len=32, device="cpu")
    for r in _requests(cfg):
        server.submit(r)
    got = {r.uid: r.output for r in server.run()}
    want = reference_server_tokens(jcfg, jp, 2, 32)
    assert got == want


def test_server_refuses_a_period_scanned_hybrid():
    _, _, cfg, tp = models("recurrentgemma-2b", 7)
    with pytest.raises(NotImplementedError, match="generate"):
        BatchedServer(tp, cfg, batch_slots=2, max_len=16, device="cpu")


def test_generate_serves_the_period_scanned_hybrid():
    """The full recurrentgemma-2b is served through ``generate``: here at
    7 layers, past the window, greedy tokens equal the forward's argmax."""
    jcfg, jp, cfg, tp = models("recurrentgemma-2b", 7, seed=4)
    prompt = _tokens(cfg, b=2, s=10, seed=4)
    got = decode.generate(tp, cfg, t(prompt), max_new_tokens=5).numpy()
    full, _, _ = lm.forward(tp, {"tokens": t(got)}, cfg)
    np.testing.assert_array_equal(
        got[:, 10:], full[:, 9:14, :cfg.vocab_size].argmax(-1).numpy())


# ---------------------------------------------------------------------------
# the reference fixtures chip_smoke.py reads on the card
# ---------------------------------------------------------------------------

def build_fixture(name) -> dict:
    """``name`` reduced (the hybrid at 7 layers, period-scanned), made by
    the JAX package on the CPU: its parameters (``param/...``, in the
    reference's layout), an S = 16 token sequence, the forward logits
    and the logits of a prefill of ``FIXTURE_PREFILL`` tokens followed by
    decode steps over the rest.  One sequence (B = 1) keeps the 7-layer
    hybrid's file under 1 MiB."""
    jcfg, _ = configs(name, FIXTURE_LAYERS[name])
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(jcfg, b=1)
    out = {"param/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    out["tokens"] = toks
    logits, _, _ = jlm.forward(params, {"tokens": jnp.asarray(toks)}, jcfg)
    out["logits_forward"] = np.asarray(logits)
    half, total = FIXTURE_PREFILL, toks.shape[1]
    lg, caches, _ = jlm.forward(params,
                                {"tokens": jnp.asarray(toks[:, :half])},
                                jcfg, mode="prefill", cache_len=total)
    outs = [lg[:, -1:]]
    for step in range(half, total):
        lg, caches = jlm.decode_step(
            params, jnp.asarray(toks[:, step:step + 1]), caches,
            jnp.int32(step), jcfg)
        outs.append(lg)
    out["logits_decode"] = np.asarray(jnp.concatenate(outs, 1))
    out["prefill_len"] = np.int32(half)
    out["num_layers"] = np.int32(jcfg.num_layers)
    return out


@pytest.mark.parametrize("name", sorted(FIXTURE_FILES))
def test_fixture_is_current(name):
    """The committed fixture equals a fresh one from the JAX package: the
    parameters and tokens exactly, the logits within 1e-6."""
    path = FIXTURE_FILES[name]
    assert path.stat().st_size < 1 << 20
    fresh = build_fixture(name)
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files}
    assert set(stored) == set(fresh)
    for key, want in fresh.items():
        if key.startswith("logits"):
            np.testing.assert_allclose(stored[key], want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(stored[key], want)
            assert stored[key].dtype == want.dtype


@pytest.mark.parametrize("name", sorted(FIXTURE_FILES))
def test_port_matches_fixture_on_cpu(name):
    """What phase 15(b) does on the card, here on the CPU."""
    with np.load(FIXTURE_FILES[name]) as f:
        stored = {k: f[k] for k in f.files}
    _, cfg = configs(name, int(stored["num_layers"]))
    params = lm_params_from_reference(tree_from_flat(stored, "param/"),
                                      cfg, device="cpu")
    toks = t(stored["tokens"])
    logits, _, _ = lm.forward(params, {"tokens": toks}, cfg)
    within(logits.numpy(), stored["logits_forward"])
    half = int(stored["prefill_len"])
    lg, caches, _ = lm.forward(params, {"tokens": toks[:, :half]}, cfg,
                               mode="prefill", cache_len=toks.shape[1])
    outs = [lg[:, -1:]]
    for step in range(half, toks.shape[1]):
        lg, caches = lm.decode_step(params, toks[:, step:step + 1], caches,
                                    step, cfg)
        outs.append(lg)
    within(torch.cat(outs, 1).numpy(), stored["logits_decode"])


if __name__ == "__main__":              # regenerate the fixtures
    FIXTURES.mkdir(exist_ok=True)
    for arch, path in FIXTURE_FILES.items():
        np.savez_compressed(path, **build_fixture(arch))
        print(path, path.stat().st_size)
