"""The port's MoE layer and MoE serving (``repro_torch/models/moe.py``, the
``moe`` family through ``repro_torch/models/lm.py`` and
``repro_torch/serve/batching.py``) held against the JAX reference
(``repro/models/moe.py``, ``repro/serve/batching.py``) on the same
numpy-seeded inputs, reduced configs, f32.

Floats are held within ``1e-4 * max|want| + 1e-5``; the dispatch's integer
planes (top-k experts, the stable sort, counts, ``keep``, ``slot``) exactly.
The server test runs at ``capacity_factor`` 1.0, where a decode call's rows
compete for capacity: the port's server must emit the reference's tokens
exactly, which it does only if every row of a call is computed as the
reference computes it (its new K/V column in place), not only the calling
slot's rows.  Also the committed reference fixture that ``chip_smoke.py``
phase 15(b) reads on the card, regenerated here so it cannot go stale.
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
from repro.models import moe as jmoe
from repro.serve import batching as jbatching

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, tree_from_flat
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.serve import decode
from repro_torch.serve.batching import BatchedServer, Request

MOE = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
FIXTURE = Path(__file__).parent / "torch_fixtures" / "lm_deepseek_moe_reduced.npz"
FIXTURE_PREFILL = 9
# the server: 8 slots, requests of these prompt and new-token lengths
SLOTS, MAX_LEN = 8, 32
LENS = (5, 3, 7, 4, 6, 3, 9, 5, 4, 8, 3, 6)
NEWS = (6, 8, 4, 7, 5, 9, 3, 6, 8, 4, 7, 5)


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


def configs(name, **moe_changes):
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    if moe_changes:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    return jcfg, cfg


def models(name, seed=0, **moe_changes):
    jcfg, cfg = configs(name, **moe_changes)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return jcfg, jp, cfg, tp


def ref_route(logits, m, c):
    """The reference's dispatch, ``repro/models/moe.py``'s lines from the
    softmax to ``slot``, on given f32 logits [T, E]."""
    t_, k, e = logits.shape[0], m.top_k, m.num_experts
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(t_ * k)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos_in_e = jnp.arange(t_ * k, dtype=jnp.int32) - starts[sorted_e]
    keep = pos_in_e < c
    slot = jnp.where(keep, sorted_e * c + pos_in_e, e * c)
    return {"probs": probs, "top_p": top_p, "top_e": top_e,
            "sort_idx": sort_idx, "sorted_e": sorted_e,
            "token_of": sort_idx // k, "counts": counts, "keep": keep,
            "slot": slot}


def hold_route(got, want):
    for name in ("top_e", "sort_idx", "sorted_e", "token_of", "counts",
                 "keep", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    within(got["top_p"].numpy(), want["top_p"])
    within(got["probs"].numpy(), want["probs"])


def moe_inputs(cfg, b=2, s=16, seed=0, shared=0.0):
    """x [B, S, D]; ``shared`` > 0 mixes one common row into every token,
    so the tokens route alike and overflow the experts' capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if shared:
        x = shared * x[:1, :1] + (1 - shared) * x
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    for name in MOE:
        m = get_config(name).moe
        jm = j_get_config(name).moe
        for tokens in (1, 7, 8, 64, 100, 4096, 32768):
            assert moe.capacity(tokens, m) == jmoe.capacity(tokens, jm)
            assert moe.capacity(tokens, m) % 4 == 0


def test_top_k_keeps_lax_order_on_ties():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    probs[0] = 0.25                           # every expert ties
    for k in (1, 2, 6, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(t(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    assert moe.top_k(t(probs), 3)[1][0].tolist() == [0, 1, 2]


@pytest.mark.parametrize("factor", (1.25, 1.0, 0.5))
def test_route_integer_planes_match(factor):
    """The dispatch planes of the reference's lines, on the same logits,
    exactly; tokens that route alike overflow and drop the later choices."""
    m = dataclasses.replace(get_config("deepseek-moe-16b").moe,
                            capacity_factor=factor)
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((48, m.num_experts)).astype(np.float32)
    logits[16:32] = logits[16] + 0.01 * logits[16:32]   # alike: overflow
    c = moe.capacity(48, m)
    want = ref_route(jnp.asarray(logits), m, c)
    got = moe.route(t(logits), m, c)
    hold_route(got, want)
    assert not bool(got["keep"].all())
    dropped = got["slot"][~got["keep"]]
    assert (dropped == m.num_experts * c).all()


@pytest.mark.parametrize("name", MOE)
def test_moe_forward_matches_reference(name):
    jcfg, cfg = configs(name)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg.d_model, jcfg.moe,
                       jnp.float32)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    x = moe_inputs(cfg)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg.moe)
    gy, gaux = moe.moe_forward(tp, t(x), cfg.moe)
    within(gy.numpy(), jy)
    assert set(gaux) == set(jaux)
    for key in jaux:
        assert gaux[key].dtype == torch.float32 and gaux[key].dim() == 0
        within(gaux[key].numpy(), jaux[key])
    assert float(jaux["drop_fraction"]) == 0.0   # the reduced factor, 8.0
    assert tp["router"].dtype == torch.float32


@pytest.mark.parametrize("name", MOE)
def test_capacity_drops_match_reference(name):
    """At ``capacity_factor`` 1.0 with tokens that route alike the
    reference drops choices; the port drops the same ones (``slot`` and
    ``keep`` equal exactly) and its output and aux agree."""
    jcfg, cfg = configs(name, capacity_factor=1.0)
    jp = jmoe.init_moe(jax.random.PRNGKey(4), jcfg.d_model, jcfg.moe,
                       jnp.float32)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    x = moe_inputs(cfg, seed=2, shared=0.8)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg.moe)
    assert float(jaux["drop_fraction"]) > 0
    gy, gaux = moe.moe_forward(tp, t(x), cfg.moe)
    within(gy.numpy(), jy)
    for key in jaux:
        within(gaux[key].numpy(), jaux[key])
    xf = x.reshape(-1, cfg.d_model)
    c = moe.capacity(xf.shape[0], cfg.moe)
    logits = xf @ np.asarray(jp["router"])
    hold_route(moe.route(t(logits), cfg.moe, c),
               ref_route(jnp.asarray(logits), jcfg.moe, c))


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("factor", (None, 1.0))
def test_forward_and_aux_match_reference(name, factor):
    changes = {} if factor is None else {"capacity_factor": factor}
    jcfg, jp, cfg, tp = models(name, **changes)
    toks = _tokens(cfg)
    want, _, jaux = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                chunk=8)
    got, caches, aux = lm.forward(tp, {"tokens": t(toks)}, cfg, chunk=8)
    assert caches is None
    within(got.numpy(), want)
    assert set(aux) == set(jaux) == set(lm.AUX_KEYS)
    for key in jaux:
        within(aux[key].numpy(), jaux[key])
    # prefill: the logits and the stacked caches
    jl, jc, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill", chunk=4, cache_len=24)
    gl, gc, _ = lm.forward(tp, {"tokens": t(toks)}, cfg, mode="prefill",
                           chunk=4, cache_len=24)
    within(gl.numpy(), jl)
    for key in ("k", "v"):
        within(gc[key].numpy(), jc[key])
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("name", MOE)
def test_prefill_decode_matches_reference(name):
    jcfg, jp, cfg, tp = models(name, seed=1)
    toks = _tokens(cfg, seed=1)
    half, total = 9, 16
    jl, jc, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks[:, :half])},
                            jcfg, mode="prefill", chunk=4, cache_len=total)
    gl, gc, _ = lm.forward(tp, {"tokens": t(toks[:, :half])}, cfg,
                           mode="prefill", chunk=4, cache_len=total)
    within(gl.numpy(), jl)
    for step in range(half, total):
        jlg, jc = jlm.decode_step(jp, jnp.asarray(toks[:, step:step + 1]), jc,
                                  jnp.int32(step), jcfg)
        glg, gc = lm.decode_step(tp, t(toks[:, step:step + 1]), gc, step,
                                 cfg)
        within(glg.numpy(), jlg)
    for key in ("k", "v"):
        within(gc[key].numpy(), jc[key])


def test_masked_rows_are_computed_as_the_reference_computes_them():
    """A decode call writing one row: that row's logits are the reference's
    step over every row (the other rows' new columns in place, coupled
    through capacity), and only its cache changes."""
    jcfg, jp, cfg, tp = models("deepseek-moe-16b", seed=2,
                               capacity_factor=1.0)
    b = 8
    rng = np.random.default_rng(3)
    hist = rng.integers(0, cfg.vocab_size, (b, 6)).astype(np.int32)
    jcache = jlm.init_caches(jcfg, b, 12)
    gcache = lm.init_caches(cfg, b, 12, device="cpu")
    for pos in range(6):
        _, jcache = jlm.decode_step(jp, jnp.asarray(hist[:, pos:pos + 1]),
                                    jcache, jnp.int32(pos), jcfg)
        lm.decode_step(tp, t(hist[:, pos:pos + 1]), gcache, pos, cfg)
    before = {k: v.clone() for k, v in gcache.items()}
    tok = np.full((b, 1), 7, np.int32)              # every row alike
    jlg, jnew = jlm.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(3),
                                jcfg)
    glg, _ = lm.decode_step(tp, t(tok), gcache, 3, cfg, rows=[5])
    within(glg[5].numpy(), np.asarray(jlg)[5])
    within(glg.numpy(), jlg)                      # every row as computed
    for key in ("k", "v", "pos"):
        rest = [r for r in range(b) if r != 5]
        assert torch.equal(gcache[key][:, rest], before[key][:, rest])
        within(gcache[key][:, 5].numpy(), np.asarray(jnew[key])[:, 5])


# ---------------------------------------------------------------------------
# the server at capacity_factor 1.0
# ---------------------------------------------------------------------------

def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(LENS, NEWS))]


def reference_server_tokens(jcfg, jp):
    jserver = jbatching.BatchedServer(jp, jcfg, batch_slots=SLOTS,
                                      max_len=MAX_LEN)
    for r in _requests(jcfg):
        jserver.submit(jbatching.Request(uid=r.uid, prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens))
    return {r.uid: list(map(int, r.output)) for r in jserver.run()}


def test_batched_server_emits_the_reference_tokens_under_drops(monkeypatch):
    """8 slots at capacity_factor 1.0: the first prefill call sends one
    token to every row, so every row routes alike and half the choices
    overflow capacity 4.  The port's server emits the reference's tokens
    exactly, and its calls did drop choices."""
    jcfg, jp, cfg, tp = models("deepseek-moe-16b", capacity_factor=1.0)
    drops = []
    orig = moe.moe_forward

    def spy(params, x, m):
        y, aux = orig(params, x, m)
        drops.append(float(aux["drop_fraction"]))
        return y, aux

    monkeypatch.setattr(moe, "moe_forward", spy)
    server = BatchedServer(tp, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                           device="cpu")
    for r in _requests(cfg):
        server.submit(r)
    got = {r.uid: r.output for r in server.run()}
    monkeypatch.undo()
    want = reference_server_tokens(jcfg, jp)
    assert sorted(got) == sorted(want) == list(range(len(LENS)))
    for uid in want:
        assert got[uid] == want[uid], uid
    assert max(drops) >= 0.5 and sum(d > 0 for d in drops) > len(drops) // 4


def test_generate_runs_the_moe_family():
    jcfg, jp, cfg, tp = models("kimi-k2-1t-a32b", seed=3)
    prompt = _tokens(cfg, b=2, s=5, seed=4)
    got = decode.generate(tp, cfg, t(prompt), max_new_tokens=4).numpy()
    full, _, _ = lm.forward(tp, {"tokens": t(got)}, cfg)
    np.testing.assert_array_equal(
        got[:, 5:], full[:, 4:8, :cfg.vocab_size].argmax(-1).numpy())


# ---------------------------------------------------------------------------
# the reference fixture chip_smoke.py reads on the card
# ---------------------------------------------------------------------------

def build_fixture() -> dict:
    """deepseek-moe-16b reduced at capacity_factor 1.0, made by the JAX
    package on the CPU: its parameters (``param/...``, stacked as the
    reference keeps them), a B = 2, S = 16 token batch, the forward logits
    and aux, the logits of a prefill of ``FIXTURE_PREFILL`` tokens and
    decode steps over the rest, and the requests of ``_requests``
    (``server_prompt/<uid>``, ``server_new/<uid>``, the server's slots and
    ``max_len``) with the reference server's tokens (``server/<uid>``)."""
    jcfg, _ = configs("deepseek-moe-16b", capacity_factor=1.0)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(jcfg)
    out = {"param/" + "/".join(str(getattr(k, "key", k)) for k in path):
           np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    out["tokens"] = toks
    logits, _, aux = jlm.forward(params, {"tokens": jnp.asarray(toks)}, jcfg)
    out["logits_forward"] = np.asarray(logits)
    for key, val in aux.items():
        out[f"aux/{key}"] = np.asarray(val)
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
    out["server_slots"] = np.int32(SLOTS)
    out["server_max_len"] = np.int32(MAX_LEN)
    for r in _requests(jcfg):
        out[f"server_prompt/{r.uid}"] = r.prompt
        out[f"server_new/{r.uid}"] = np.int32(r.max_new_tokens)
    for uid, tokens in reference_server_tokens(jcfg, params).items():
        out[f"server/{uid}"] = np.asarray(tokens, np.int32)
    return out


def test_fixture_is_current():
    """The committed fixture equals a fresh one from the JAX package: the
    parameters, tokens and the server's tokens exactly, the logits and aux
    within 1e-6 (XLA's CPU code may round differently on another host)."""
    assert FIXTURE.stat().st_size < 1 << 20
    fresh = build_fixture()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    assert set(stored) == set(fresh)
    for key, want in fresh.items():
        if key.startswith(("logits", "aux")):
            np.testing.assert_allclose(stored[key], want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(stored[key], want)
            assert stored[key].dtype == want.dtype


def test_port_matches_fixture_on_cpu():
    """What phase 15(b) does on the card, here on the CPU."""
    _, cfg = configs("deepseek-moe-16b", capacity_factor=1.0)
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    params = lm_params_from_reference(tree_from_flat(stored, "param/"), cfg,
                                      device="cpu")
    toks = t(stored["tokens"])
    logits, _, aux = lm.forward(params, {"tokens": toks}, cfg)
    within(logits.numpy(), stored["logits_forward"])
    for key in lm.AUX_KEYS:
        within(aux[key].numpy(), stored[f"aux/{key}"])
    half = int(stored["prefill_len"])
    lg, caches, _ = lm.forward(params, {"tokens": toks[:, :half]}, cfg,
                               mode="prefill", cache_len=toks.shape[1])
    outs = [lg[:, -1:]]
    for step in range(half, toks.shape[1]):
        lg, caches = lm.decode_step(params, toks[:, step:step + 1], caches,
                                    step, cfg)
        outs.append(lg)
    within(torch.cat(outs, 1).numpy(), stored["logits_decode"])
    server = BatchedServer(params, cfg,
                           batch_slots=int(stored["server_slots"]),
                           max_len=int(stored["server_max_len"]),
                           device="cpu")
    uids = sorted(int(k.split("/")[1]) for k in stored
                  if k.startswith("server/"))
    for uid in uids:
        server.submit(Request(uid=uid,
                              prompt=stored[f"server_prompt/{uid}"],
                              max_new_tokens=int(
                                  stored[f"server_new/{uid}"])))
    done = server.run()
    assert sorted(r.uid for r in done) == uids
    for r in done:
        assert r.output == stored[f"server/{r.uid}"].tolist()


if __name__ == "__main__":              # regenerate the fixture
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **build_fixture())
    print(FIXTURE, FIXTURE.stat().st_size)
