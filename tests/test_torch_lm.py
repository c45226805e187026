"""The port's LM scaffolding (``repro_torch/models``, ``repro_torch/configs``,
``repro_torch.convert.lm_params_from_reference``) held against the JAX
reference (``repro/models``) on the same numpy-seeded inputs: the norm and
rotary primitives, the three attention schedules and the decode step, and
the dense backbone's forward (train and prefill) and prefill + decode for
the four dense configs reduced, with the reference's weights carried
across.  Also the configs as data (``param_count`` of all ten), the
parameter tree's shapes at full size (on the meta device), unported
families raising, and the committed reference fixture that ``chip_smoke.py``
phase 14(b) reads on the card, regenerated here so it cannot go stale.

Logits are held within ``1e-4 * max|want| + 1e-5``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm

from repro_torch.configs import (ARCH_NAMES, SHAPES, all_cells,
                                 cell_is_runnable, get_config)
from repro_torch.convert import lm_params_from_reference, tree_from_flat
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import lm
from repro_torch.tree import tree_leaves

DENSE = ("qwen3-0.6b", "chatglm3-6b", "granite-3-8b", "command-r-35b")
# the MoE, SSM and hybrid configs (their tests: test_torch_moe.py,
# test_torch_ssm.py)
OTHER = ("deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-2.7b",
         "recurrentgemma-2b")
# the patch and frame frontends' configs (their tests:
# test_torch_frontends.py)
UNPORTED = ("qwen2-vl-72b", "hubert-xlarge")
# param_count() of the published configs the card serves
PARAM_COUNTS = {"qwen3-0.6b": 596_071_424,
                "deepseek-moe-16b": 16_879_626_240,
                "mamba2-2.7b": 2_830_946_816,
                "recurrentgemma-2b": 2_658_664_960}
FIXTURE = Path(__file__).parent / "torch_fixtures" / "lm_qwen3_reduced.npz"
FIXTURE_PREFILL = 9


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


def port_params(jparams, cfg):
    return lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_data():
    assert ARCH_NAMES == J_ARCHS
    for name in ARCH_NAMES:
        a, b = dataclasses.asdict(get_config(name)), \
            dataclasses.asdict(j_get_config(name))
        assert a == b, name
        ra, rb = get_config(name).reduced(), j_get_config(name).reduced()
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert get_config(name).padded_vocab == j_get_config(name).padded_vocab
    assert list(all_cells()) == list(__import__(
        "repro.configs", fromlist=["all_cells"]).all_cells())
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}
    ok, _ = cell_is_runnable(get_config("qwen3-0.6b"), SHAPES["decode_32k"])
    assert ok
    with pytest.raises(KeyError):
        get_config("nope")


@pytest.mark.parametrize("name", J_ARCHS)
def test_param_count_matches_reference(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.reduced().param_count() == jcfg.reduced().param_count()


@pytest.mark.parametrize("name", DENSE + OTHER)
def test_parameter_tree_shapes_at_full_size(name):
    """The port's tree (meta device, nothing allocated) has the reference's
    leaves, unstacked (a scanned stack's [L, ...], a period-scanned
    hybrid's pattern positions and tail); its element count is
    ``param_count()`` plus the vocabulary padding rows, the q/k norm
    scales, the qkv biases, the SSM's ``dt_bias`` and the RG-LRU's ``lam``,
    less the one d_model vector an attention layer that the analytic count
    adds beyond the two norms."""
    cfg, jcfg = get_config(name), j_get_config(name)
    want = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    got = lm.abstract_params(cfg)
    assert all(p.device.type == "meta" for p in tree_leaves(got))
    assert len(got["layers"]) == cfg.num_layers
    flat_want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path): leaf
                 for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    info = cfg.period_info
    for key, leaf in flat_want.items():
        parts = key.split("/")
        node = got
        shape = leaf.shape
        if parts[:2] == ["layers", "period"]:      # [n_per, ...] by position
            node, parts = got["layers"][int(parts[2])], parts[3:]
            shape = leaf.shape[1:]
        elif parts[:2] == ["layers", "tail"]:
            node = got["layers"][info[1] * len(info[0]) + int(parts[2])]
            parts = parts[3:]
        elif parts[0] == "layers":                 # [L, ...]
            node, parts = got["layers"][0], parts[1:]
            shape = leaf.shape[1:]
        for p in parts:
            node = node[p]
        assert tuple(node.shape) == tuple(shape), key
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), key
    copies = {"period": info[1] if info else 0, "tail": 1}
    assert len(list(tree_leaves(got))) == sum(
        (copies[k.split("/")[1]] if k.split("/")[1] in copies
         else cfg.num_layers) if k.startswith("layers/") else 1
        for k in flat_want)
    n = sum(p.numel() for p in tree_leaves(got))
    d, hd, pattern = cfg.d_model, cfg.resolved_head_dim, cfg.layer_pattern
    n_attn, n_ssm, n_rec = (pattern.count(k) for k in ("attn", "ssm", "rec"))
    heads = 1 if cfg.tie_embeddings else 2
    expect = (cfg.param_count()
              + heads * (cfg.padded_vocab - cfg.vocab_size) * d
              + n_attn * (2 * hd if cfg.qk_norm else 0)
              + n_attn * ((cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                          if cfg.attn_bias else 0)
              + n_ssm * (cfg.ssm.expand * d // cfg.ssm.head_dim
                         if cfg.ssm else 0)
              + n_rec * ((cfg.rglru.lru_width or d) if cfg.rglru else 0)
              - n_attn * d)
    assert n == expect == lm.tree_size_from_param_count(cfg)
    if name in PARAM_COUNTS:
        assert cfg.param_count() == PARAM_COUNTS[name]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_families_raise(name):
    """The vlm and audio families, once refused, now run: init, a forward
    over projected patches or frames, and (vlm) empty decode caches."""
    cfg = get_config(name).reduced()
    params = lm.init_params(cfg, device="cpu")
    assert params["frontend"]["proj"].shape == (cfg.frontend_dim,
                                                cfg.d_model)
    gen = torch.Generator().manual_seed(0)
    if cfg.frontend == "frame":
        batch = {"frames": torch.randn((1, 4, cfg.frontend_dim),
                                       generator=gen)}
        s = 4
    else:
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                 "patches": torch.randn((1, cfg.frontend_tokens,
                                         cfg.frontend_dim), generator=gen)}
        s = 4 + cfg.frontend_tokens
        caches = lm.init_caches(cfg, 1, 8, device="cpu")
        assert caches["k"].shape[:3] == (cfg.num_layers, 1, 8)
    logits, _, _ = lm.forward(params, batch, cfg)
    assert logits.shape == (1, s, cfg.padded_vocab)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name,window,prefill", [
    ("qwen3-0.6b", 5, 3), ("qwen3-0.6b", 8, 5), ("recurrentgemma-2b", 8, 5)])
def test_decode_past_a_short_windowed_prefill_raises(name, window, prefill):
    """A prefill shorter than the window keeps min(window, S) slots, which
    is not a ring buffer: a decode step past it raises the port's
    ``CachePositionError`` (an ``IndexError``) before any layer writes,
    and a graphed step refuses such a cache before it captures.  With the
    window's slots (a ring) the same step runs and equals the port's own
    forward.  (The reference clamps its write here instead, ROADMAP.md R4;
    nothing holds the port to that.)"""
    from repro_torch.serve.decode import GraphedDecodeStep

    cfg = dataclasses.replace(get_config(name).reduced(),
                              sliding_window=window)
    params = lm.init_params(cfg, 0, device="cpu")
    toks = t(_tokens(cfg, b=2, s=prefill + 1))
    _, caches, _ = lm.forward(params, {"tokens": toks[:, :prefill]}, cfg,
                              mode="prefill")
    assert lm.attention_cache_len(caches) == prefill
    before = [leaf.clone() for _, leaf, _ in lm.cache_leaves(caches)]
    with pytest.raises(attn.CachePositionError, match="not a ring") as err:
        lm.decode_step(params, toks[:, prefill:], caches, prefill, cfg)
    assert isinstance(err.value, IndexError)
    assert all(torch.equal(a, b) for a, (_, b, _) in
               zip(before, lm.cache_leaves(caches)))
    with pytest.raises(attn.CachePositionError):
        GraphedDecodeStep(params, caches, cfg)
    first = next(i for i, k in enumerate(cfg.layer_pattern) if k == "attn")
    x = torch.zeros((2, 1, cfg.d_model))
    with pytest.raises(attn.CachePositionError):
        attn.attention_decode(params["layers"][first]["mixer"], x,
                              lm.layer_cache(caches, first), prefill, cfg)
    _, ring, _ = lm.forward(params, {"tokens": toks[:, :prefill]}, cfg,
                            mode="prefill", cache_len=window)
    GraphedDecodeStep(params, ring, cfg)        # a ring: accepted
    got, _ = lm.decode_step(params, toks[:, prefill:], ring, prefill, cfg)
    want, _, _ = lm.forward(params, {"tokens": toks}, cfg)
    within(got.numpy(), want[:, -1:].numpy())


def test_init_params_seeded_and_shaped():
    cfg = get_config("qwen3-0.6b").reduced()
    a = lm.init_params(cfg, 3, device="cpu")
    b = lm.init_params(cfg, 3, device="cpu")
    c = lm.init_params(cfg, 4, device="cpu")
    ta, tb, tc = (list(tree_leaves(p)) for p in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert not all(torch.equal(x, y) for x, y in zip(ta, tc))
    shapes = [tuple(p.shape) for p in tree_leaves(lm.abstract_params(
        cfg))]
    assert [tuple(p.shape) for p in ta] == shapes
    w = a["layers"][0]["mixer"]["wq"]
    assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    gen = torch.Generator().manual_seed(3)
    d = lm.init_params(cfg, device="cpu", generator=gen)
    assert all(torch.equal(x, y) for x, y in zip(ta, tree_leaves(d)))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    jx = jnp.asarray(x).astype(dtype)
    want = jlayers.rms_norm(jx, jnp.asarray(scale), 1e-6)
    got = layers.rms_norm(t(x).to(getattr(torch, dtype)), t(scale), 1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", ("rope", "rope2d", "mrope", "none"))
def test_apply_rope_matches(variant):
    rng = np.random.default_rng(1)
    b, s, h, kv, hd = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 3 + s), (b, s)).astype(np.int32)
    mrope = None
    if variant == "mrope":
        mrope = rng.integers(0, 50, (b, s, 3)).astype(np.int32)
    jq, jk = jlayers.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(pos), hd, 1e4, variant,
                                None if mrope is None else jnp.asarray(mrope))
    gq, gk = layers.apply_rope(t(q), t(k), t(pos), hd, 1e4, variant,
                               None if mrope is None else t(mrope))
    np.testing.assert_allclose(gq.numpy(), np.asarray(jq), atol=2e-6)
    np.testing.assert_allclose(gk.numpy(), np.asarray(jk), atol=2e-6)
    if variant == "rope2d":                     # the second half passes
        np.testing.assert_array_equal(gq.numpy()[..., hd // 2:],
                                      q[..., hd // 2:])
    if variant == "mrope":                      # t = h = w degenerates
        a = layers.apply_rope(t(q), t(k), t(pos), hd, 1e4, "mrope")
        r = layers.apply_rope(t(q), t(k), t(pos), hd, 1e4, "rope")
        assert not torch.allclose(a[0], r[0])   # sections rotate apart
    with pytest.raises(ValueError):
        layers.apply_rope(t(q), t(k), t(pos), hd, 1e4, "bogus")


def test_causal_conv1d_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    want = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(layers.causal_conv1d(t(x), t(w)).numpy(),
                               np.asarray(want), atol=1e-6)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jy, js = jlayers.causal_conv1d_update(jnp.asarray(x[:, 0]),
                                          jnp.asarray(state), jnp.asarray(w))
    gy, gs_ = layers.causal_conv1d_update(t(x[:, 0]), t(state), t(w))
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_array_equal(gs_.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_cfg(**kw):
    base = get_config("qwen3-0.6b").reduced()
    return dataclasses.replace(base, **kw)


def _attn_params(cfg, seed=0):
    jcfg = j_get_config("qwen3-0.6b").reduced()
    jcfg = dataclasses.replace(jcfg, **{f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(cfg)})
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                          * 0.1) if v.ndim == 1 else v)
          for k, v in jp.items()}                 # non-zero norms, biases
    return jcfg, jp, {k: t(v) for k, v in jp.items()}


ATTN_CASES = [
    # (cfg changes, S, chunk, impl)
    ({}, 16, 512, "masked"),
    ({}, 32, 8, "masked"),
    ({}, 32, 8, "triangular"),
    ({"attn_bias": True, "rope": "rope2d"}, 16, 4, "masked"),
    ({"sliding_window": 8}, 32, 8, "auto"),          # banded
    ({"sliding_window": 8}, 32, 8, "masked"),
    ({"causal": False, "rope": "none"}, 16, 8, "masked"),
    ({}, 24, 16, "masked"),          # padded here, chunk halved there
    ({}, 40, 16, "triangular"),
    ({"sliding_window": 8}, 40, 16, "banded"),
]


@pytest.mark.parametrize("changes,s,chunk,impl", ATTN_CASES)
def test_attention_schedules_match(changes, s, chunk, impl):
    cfg = _attn_cfg(**changes)
    jcfg, jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    jy, jc = jattn.attention_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                     jcfg, impl=impl, chunk=chunk,
                                     return_cache=True)
    gy, gc = attn.attention_forward(tp, t(x), t(pos), cfg, impl=impl,
                                    chunk=chunk, return_cache=True)
    within(gy.numpy(), jy)
    for name in ("k", "v", "pos"):
        within(gc[name].numpy(), jc[name])
    if impl != "auto":               # every schedule computes one function
        my, _ = attn.attention_forward(tp, t(x), t(pos), cfg, impl="masked",
                                       chunk=s)
        within(gy.numpy(), my.numpy())


@pytest.mark.parametrize("window,cache_len", [(None, 24), (8, None),
                                              (8, 8)])
def test_attention_decode_matches(window, cache_len):
    """Prefill then decode through the reference's and the port's caches,
    including the padded cache (positions -1) and the ring buffer."""
    cfg = _attn_cfg(sliding_window=window)
    jcfg, jp, tp = _attn_params(cfg, seed=1)
    rng = np.random.default_rng(6)
    b, s, half = 2, 20, 11
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    _, jc = jattn.attention_forward(jp, jnp.asarray(x[:, :half]),
                                    jnp.asarray(pos[:, :half]), jcfg,
                                    chunk=4, return_cache=True,
                                    cache_len=cache_len)
    _, gc = attn.attention_forward(tp, t(x[:, :half]), t(pos[:, :half]),
                                   cfg, chunk=4, return_cache=True,
                                   cache_len=cache_len)
    for step in range(half, s):
        jy, jc = jattn.attention_decode(jp, jnp.asarray(x[:, step:step + 1]),
                                        jc, jnp.int32(step), jcfg)
        gy, gc = attn.attention_decode(tp, t(x[:, step:step + 1]), gc, step,
                                       cfg)
        within(gy.numpy(), jy)
        for name in ("k", "v"):
            within(gc[name].numpy(), jc[name])
        np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(jc["pos"]))


def test_attention_decode_rows_write_only_their_rows():
    cfg = _attn_cfg()
    _, _, tp = _attn_params(cfg)
    cache = attn.init_cache(cfg, 3, 8, torch.float32)
    x = torch.randn(3, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    before = {k: v.clone() for k, v in cache.items()}
    attn.attention_decode(tp, x, cache, 2, cfg, rows=[1])
    for name in ("k", "v", "pos"):
        assert torch.equal(cache[name][[0, 2]], before[name][[0, 2]])
        assert not torch.equal(cache[name][1], before[name][1])
    assert cache["pos"][1].tolist() == [-1, -1, 2, -1, -1, -1, -1, -1]
    with pytest.raises(IndexError):
        attn.attention_decode(tp, x, cache, 8, cfg)


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_reference(name):
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_params(jp, cfg)
    toks = _tokens(cfg)
    want, _, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                             mode="train", chunk=8)
    got, caches, aux = lm.forward(tp, {"tokens": t(toks)}, cfg, mode="train",
                                  chunk=8)
    assert caches is None and aux == {}
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 16, cfg.padded_vocab)
    within(got.numpy(), want)
    # prefill: the logits and the stacked caches
    jl, jc, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill", chunk=4, cache_len=24)
    gl, gc, _ = lm.forward(tp, {"tokens": t(toks)}, cfg, mode="prefill",
                           chunk=4, cache_len=24)
    within(gl.numpy(), jl)
    for key in ("k", "v"):
        assert tuple(gc[key].shape) == jc[key].shape
        within(gc[key].numpy(), jc[key])
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_matches_reference(name):
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = port_params(jp, cfg)
    toks = _tokens(cfg, seed=1)
    half, total = 9, 16
    jl, jc, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks[:, :half])},
                            jcfg, mode="prefill", chunk=4, cache_len=total)
    gl, gc, _ = lm.forward(tp, {"tokens": t(toks[:, :half])}, cfg,
                           mode="prefill", chunk=4, cache_len=total)
    jouts, gouts = [jl[:, -1:]], [gl[:, -1:]]
    for step in range(half, total):
        jlg, jc = jlm.decode_step(jp, jnp.asarray(toks[:, step:step + 1]), jc,
                                  jnp.int32(step), jcfg)
        glg, gc = lm.decode_step(tp, t(toks[:, step:step + 1]), gc, step,
                                 cfg)
        within(glg.numpy(), jlg)
        jouts.append(jlg)
        gouts.append(glg)
    want_full, _, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    within(torch.cat(gouts, 1).numpy(), jnp.concatenate(jouts, 1))
    within(torch.cat(gouts, 1).numpy(), want_full[:, half - 1:])


def test_untied_head_and_tree_checks():
    cfg, jcfg = get_config("granite-3-8b").reduced(), \
        j_get_config("granite-3-8b").reduced()
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(2),
                                                  jcfg))
    tp = lm_params_from_reference(jp, cfg, device="cpu")
    np.testing.assert_array_equal(tp["head"].numpy(), jp["head"])
    np.testing.assert_array_equal(tp["layers"][1]["ffn"]["w_down"].numpy(),
                                  jp["layers"]["ffn"]["w_down"][1])
    bad = dict(jp)
    del bad["head"]
    with pytest.raises(ValueError):
        lm_params_from_reference(bad, cfg, device="cpu")
    qcfg = get_config("qwen3-0.6b").reduced()
    with pytest.raises(ValueError):             # a tied config has no head
        lm_params_from_reference(jp, qcfg, device="cpu")


def test_bf16_params_cross_bit_for_bit():
    jcfg = dataclasses.replace(j_get_config("qwen3-0.6b").reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    tp = lm_params_from_reference(jp, cfg, device="cpu")
    got = tp["layers"][0]["mixer"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  jp["layers"]["mixer"]["wq"][0]
                                  .view(np.int16))
    # bf16 end to end: the port's bf16 forward against its own f32 forward
    # of the same weights within the bf16 bound chip_smoke.py states
    toks = t(_tokens(cfg))
    lo, _, _ = lm.forward(tp, {"tokens": toks}, cfg)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    tp32 = lm_params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg32,
        device="cpu")
    hi, _, _ = lm.forward(tp32, {"tokens": toks}, cfg32)
    within(lo.numpy(), hi.numpy(), rel=2 ** -8 * (6 * cfg.num_layers) ** 0.5)


# ---------------------------------------------------------------------------
# the reference fixture chip_smoke.py reads on the card
# ---------------------------------------------------------------------------

def build_fixture() -> dict:
    """qwen3-0.6b reduced, made by the JAX package on the CPU: its
    parameters (``param/...``, layers stacked as the reference keeps them),
    a B = 2, S = 16 token batch, the forward logits and the logits of a
    prefill of ``FIXTURE_PREFILL`` tokens (its last position) followed by
    decode steps over the rest."""
    cfg = j_get_config("qwen3-0.6b").reduced()
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    out = {"param/" + "/".join(str(getattr(k, "key", k)) for k in path):
           np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    out["tokens"] = toks
    logits, _, _ = jlm.forward(params, {"tokens": jnp.asarray(toks)}, cfg)
    out["logits_forward"] = np.asarray(logits)
    half, total = FIXTURE_PREFILL, toks.shape[1]
    lg, caches, _ = jlm.forward(params, {"tokens": jnp.asarray(toks[:, :half])},
                                cfg, mode="prefill", cache_len=total)
    outs = [lg[:, -1:]]
    for step in range(half, total):
        lg, caches = jlm.decode_step(params, jnp.asarray(toks[:, step:step + 1]),
                                     caches, jnp.int32(step), cfg)
        outs.append(lg)
    out["logits_decode"] = np.asarray(jnp.concatenate(outs, 1))
    out["prefill_len"] = np.int32(half)
    return out


def test_fixture_is_current():
    """The committed fixture equals a fresh one from the JAX package: the
    parameters and tokens exactly, the logits within 1e-6 (XLA's CPU code
    may round differently on another host)."""
    assert FIXTURE.stat().st_size < 1 << 20
    fresh = build_fixture()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    assert set(stored) == set(fresh)
    for key, want in fresh.items():
        if key.startswith("logits"):
            np.testing.assert_allclose(stored[key], want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(stored[key], want)
            assert stored[key].dtype == want.dtype


def test_port_matches_fixture_on_cpu():
    """What phase 14(b) does on the card, here on the CPU."""
    cfg = get_config("qwen3-0.6b").reduced()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    params = lm_params_from_reference(tree_from_flat(stored, "param/"), cfg,
                                      device="cpu")
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


if __name__ == "__main__":              # regenerate the fixture
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(FIXTURE, FIXTURE.stat().st_size)
