"""The port's patch and frame frontends (``repro_torch/models/frontends.py``)
and the ``vlm`` and ``audio`` families of ``repro_torch/models/lm.py``,
held against the JAX reference on the CPU with numpy-seeded inputs:
M-RoPE position triples exactly; ``embed_inputs``, forward logits, the
vlm's prefill and decode steps (its text ``t`` continuing after the patch
grid), the loss and every leaf's gradient, and whole AdamW and Adafactor
steps of reduced ``qwen2-vl-72b`` and ``hubert-xlarge``; ``convert`` both
ways with the ``frontend/proj`` leaf; the encoder-only refusals; and the
committed fixtures that ``chip_smoke.py`` phase 17 reads on the card.

Logits and gradients within ``1e-4 * max|want| + 1e-5``, losses within
1e-5 relative, updated parameters within ``PERF.md`` section 2's step
bounds (``adamw_step_bound``, ``adafactor_step_bound``).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import cell_is_runnable as j_cell_is_runnable
from repro.configs import get_config as j_get_config
from repro.models import frontends as jfront
from repro.models import lm as jlm
from repro.train import loop as jloop
from repro.train import optimizers as jopt

from repro_torch.configs import SHAPES, cell_is_runnable, get_config
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference, tree_from_flat)
from repro_torch.data import pipeline
from repro_torch.models import frontends, lm
from repro_torch.serve.batching import BatchedServer, Request
from repro_torch.train import loop
from repro_torch.train import optimizers as opt_mod
from repro_torch.tree import flatten_with_paths

from test_torch_train import (_one_thread, adafactor_bound,  # noqa: F401
                              adamw_bound, configs, np_flat, ref_flat, t,
                              within)

FIXTURES = Path(__file__).parent / "torch_fixtures"
FIXTURE_FILES = {"qwen2-vl-72b": FIXTURES / "lm_qwen2vl_reduced.npz",
                 "hubert-xlarge": FIXTURES / "lm_hubert_reduced.npz"}
NAMES = tuple(FIXTURE_FILES)
CHUNK = 8


def models(name, seed=0):
    jcfg, cfg = configs(name)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return jcfg, jp, cfg, tp


def batch_for(cfg, b=2, s=12, step=0):
    """numpy batch: tokens + zero-mean patches (vlm), or encoder frames and
    labels (audio), from a numpy seed."""
    dc = pipeline.DataConfig(cfg.vocab_size, s, b, seed=1)
    if cfg.frontend == "frame":
        return pipeline.encoder_batch_at(dc, step, cfg.frontend_dim)
    out = pipeline.batch_at(dc, step)
    rng = np.random.default_rng(step + 7)
    out["patches"] = rng.standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE positions and embed_inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_patch,text_len,batch", [
    (4, 8, 2), (256, 5, 1), (1, 3, 3), (10, 0, 2), (0, 4, 1), (17, 9, 2)])
def test_patch_grid_mrope_matches_reference(n_patch, text_len, batch):
    want = np.asarray(jfront.patch_grid_mrope(n_patch, text_len, batch))
    got = frontends.patch_grid_mrope(n_patch, text_len, batch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_patch", [1, 2, 4, 9, 10, 255, 256, 1024, 1025])
def test_text_mrope_t0_matches_reference(n_patch):
    assert frontends.text_mrope_t0(n_patch) == jfront.text_mrope_t0(n_patch)


@pytest.mark.parametrize("name", NAMES)
def test_embed_inputs_matches_reference(name):
    jcfg, jp, cfg, tp = models(name)
    batch = batch_for(cfg)
    wx, wpos, wm = jfront.embed_inputs(jp, jbatch(batch), jcfg,
                                       jp.get("embed"))
    gx, gpos, gm = frontends.embed_inputs(tp, tbatch(batch), cfg,
                                          tp.get("embed"))
    within(gx.numpy(), wx)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    assert gpos.dtype == torch.int32
    if wm is None:
        assert gm is None
    else:
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_embed_inputs_takes_given_mrope_positions():
    jcfg, jp, cfg, tp = models("qwen2-vl-72b")
    batch = batch_for(cfg)
    s = cfg.frontend_tokens + batch["tokens"].shape[1]
    batch["mrope_positions"] = np.random.default_rng(3).integers(
        0, 50, (2, s, 3)).astype(np.int32)
    _, _, wm = jfront.embed_inputs(jp, jbatch(batch), jcfg, jp["embed"])
    _, _, gm = frontends.embed_inputs(tp, tbatch(batch), cfg, tp["embed"])
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    logits_w, _, _ = jlm.forward(jp, jbatch(batch), jcfg, chunk=CHUNK)
    logits_g, _, _ = lm.forward(tp, tbatch(batch), cfg, chunk=CHUNK)
    within(logits_g.numpy(), logits_w)


# ---------------------------------------------------------------------------
# the families: init, forward, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_tree_and_size(name):
    """The port's tree has the reference's paths, shapes and dtypes (the
    frontend's projection [frontend_dim, D] included) and
    ``tree_size_from_param_count`` counts it, reduced and published."""
    for reduce in (True, False):
        cfg, jcfg = get_config(name), j_get_config(name)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        want = jax.eval_shape(lambda: jlm.init_params(
            jax.random.PRNGKey(0), jcfg))
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in ref_flat_abstract(want).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in flatten_with_paths(lm_params_to_reference(
                   lm.abstract_params(cfg), cfg)).items()}
        assert got == want
        assert "frontend/proj" in got
        n = sum(int(np.prod(shape)) for shape, _ in got.values())
        assert n == lm.tree_size_from_param_count(cfg)


def ref_flat_abstract(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    jcfg, jp, cfg, tp = models(name)
    batch = batch_for(cfg, s=13)          # 13 + 4 patches: not a chunk
    want, _, _ = jlm.forward(jp, jbatch(batch), jcfg, chunk=CHUNK)
    got, _, _ = lm.forward(tp, tbatch(batch), cfg, chunk=CHUNK)
    assert got.dtype == torch.float32 and got.shape == want.shape
    within(got.numpy(), want)


def test_frame_forward_needs_no_embedding():
    _, _, cfg, tp = models("hubert-xlarge")
    batch = tbatch(batch_for(cfg))
    full, _, _ = lm.forward(tp, batch, cfg, chunk=CHUNK)
    no_embed = {k: v for k, v in tp.items() if k != "embed"}
    got, _, _ = lm.forward(no_embed, batch, cfg, chunk=CHUNK)
    assert torch.equal(got, full)


def test_vlm_prefill_and_decode_match_reference():
    """A prefill of the patches and 5 tokens, then decode steps that
    continue the text ``t`` coordinate, against the reference's
    ``decode_step`` step for step and against one forward of the whole
    sequence."""
    jcfg, jp, cfg, tp = models("qwen2-vl-72b")
    batch = batch_for(cfg, s=11)
    toks, n_p = batch["tokens"], cfg.frontend_tokens
    total = n_p + toks.shape[1]
    half = 5
    pre = dict(batch, tokens=toks[:, :half])
    wl, wc, _ = jlm.forward(jp, jbatch(pre), jcfg, mode="prefill",
                            cache_len=total, chunk=CHUNK)
    gl, gc, _ = lm.forward(tp, tbatch(pre), cfg, mode="prefill",
                           cache_len=total, chunk=CHUNK)
    within(gl.numpy(), wl)
    full, _, _ = lm.forward(tp, tbatch(batch), cfg, chunk=CHUNK)
    for i in range(half, toks.shape[1]):
        pos = n_p + i
        wl, wc = jlm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), wc,
                                 jnp.int32(pos), jcfg)
        gl, gc = lm.decode_step(tp, t(toks[:, i:i + 1]), gc, pos, cfg)
        within(gl.numpy(), wl)
        within(gl[:, 0].numpy(), full[:, pos].numpy())


def test_vlm_decode_takes_embeds():
    """``embeds_t`` [B, 1, D] stands for the token's embedding."""
    jcfg, jp, cfg, tp = models("qwen2-vl-72b")
    toks = batch_for(cfg)["tokens"]
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    a, _ = lm.decode_step(tp, t(toks[:, :1]), caches, 6, cfg)
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    emb = tp["embed"][t(toks[:, :1]).long()]
    b, _ = lm.decode_step(tp, None, caches, 6, cfg, embeds_t=emb)
    assert torch.equal(a, b)
    jc = jlm.init_caches(jcfg, 2, 8)
    w, _ = jlm.decode_step(jp, None, jc, jnp.int32(6), jcfg,
                           embeds_t=jnp.asarray(emb.numpy()))
    within(b.numpy(), w)


def test_vlm_server_serves_token_prompts():
    """``BatchedServer`` over token prompts (no patches), greedy, against
    the reference's own server step for step: the same tokens."""
    from repro.serve.batching import BatchedServer as JServer
    from repro.serve.batching import Request as JRequest

    jcfg, jp, cfg, tp = models("qwen2-vl-72b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 6, 4)]
    server = BatchedServer(tp, cfg, batch_slots=2, max_len=16,
                           device="cpu")
    jserver = JServer(jp, jcfg, batch_slots=2, max_len=16)
    for uid, p in enumerate(prompts):
        server.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        jserver.submit(JRequest(uid=uid, prompt=p, max_new_tokens=4))
    got = {r.uid: r.output for r in server.run()}
    want = {r.uid: [int(x) for x in r.output] for r in jserver.run()}
    assert got == want and all(len(v) == 4 for v in got.values())


# ---------------------------------------------------------------------------
# the encoder-only refusals
# ---------------------------------------------------------------------------

def test_encoder_only_refusals():
    cfg = get_config("hubert-xlarge")
    assert not cfg.has_decode
    for sname in SHAPES:
        got = cell_is_runnable(cfg, SHAPES[sname])
        want = j_cell_is_runnable(j_get_config("hubert-xlarge"),
                                  J_SHAPES[sname])
        assert got == want
    red = cfg.reduced()
    with pytest.raises(ValueError, match="encoder-only"):
        BatchedServer({}, red, batch_slots=1, max_len=8, device="cpu")
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_vlm_serve_launcher_runs():
    from repro_torch.launch import serve

    done = serve.main(["--arch", "qwen2-vl-72b", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new",
                       "4"])
    assert len(done) == 3 and all(r.output for r in done)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_convert_both_ways(name):
    """Reference -> port -> reference is the identity, bit for bit, for
    the parameters and for AdamW's moments (parameter-shaped f32 trees),
    the ``frontend/proj`` leaf included."""
    jcfg, jp, cfg, tp = models(name)
    jo = jopt.get_optimizer("adamw", 1e-3)
    _, js, _ = jax.jit(jloop.make_train_step(jcfg, jo, chunk=CHUNK))(
        jp, jo.init(jp), jbatch(batch_for(cfg)))
    for tree in (jp, js["mu"], js["nu"]):
        port = lm_params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                                        device="cpu")
        back = flatten_with_paths(lm_params_to_reference(port, cfg))
        want = ref_flat(tree)
        assert set(back) == set(want) and "frontend/proj" in want
        for k in want:
            assert back[k].numpy().tobytes() == want[k].tobytes(), k
    assert float(np.abs(ref_flat(js["mu"])["frontend/proj"]).max()) > 0


# ---------------------------------------------------------------------------
# training: loss, gradients, whole steps
# ---------------------------------------------------------------------------

def ref_grads(jcfg, jp, batch):
    fn = jax.jit(jax.value_and_grad(
        functools.partial(jloop.loss_fn, cfg=jcfg, chunk=CHUNK),
        has_aux=True))
    (total, metrics), grads = fn(jp, jbatch(batch))
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    """The text-logits slice after the patch slots (vlm) and the
    per-position CE (audio): the loss and every leaf's gradient, the
    frontend's projection included."""
    jcfg, jp, cfg, tp = models(name)
    tp = lm_params_to_reference(tp, cfg)
    batch = batch_for(cfg, b=4, s=12)
    want_total, want_m, want_g = ref_grads(jcfg, jp, batch)
    got_m, got_g = loop.grad_and_metrics(tp, tbatch(batch), cfg,
                                         chunk=CHUNK)
    assert float(got_m["loss"]) == pytest.approx(want_total, rel=1e-5)
    for k, v in want_m.items():
        assert float(got_m[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    want, got = ref_flat(want_g), np_flat(got_g)
    assert set(got) == set(want)
    assert "frontend/proj" in got
    for k, v in want.items():
        within(got[k], v)
    assert float(np.abs(got["frontend/proj"]).max()) > 0


@pytest.mark.parametrize("name,opt_name", [
    ("qwen2-vl-72b", "adamw"), ("qwen2-vl-72b", "adafactor"),
    ("hubert-xlarge", "adamw"), ("hubert-xlarge", "adafactor")])
def test_train_step_matches_reference(name, opt_name):
    jcfg, jp, cfg, tp = models(name)
    tp = lm_params_to_reference(tp, cfg)
    batch = batch_for(cfg, b=4, s=12)
    lr = 1e-3
    jo, po = (jopt.get_optimizer(opt_name, lr),
              opt_mod.get_optimizer(opt_name, lr))
    jstep = jax.jit(jloop.make_train_step(jcfg, jo, chunk=CHUNK))
    jp1, js1, jm = jstep(jp, jo.init(jp), jbatch(batch))
    pstep = loop.make_train_step(cfg, po, chunk=CHUNK)
    tp1, ts1, tm = pstep(tp, po.init(tp), tbatch(batch))
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-7), k
    _, _, jg = ref_grads(jcfg, jp, batch)
    _, tg = loop.grad_and_metrics(tp, tbatch(batch), cfg, chunk=CHUNK)
    g_ref, g_got = ref_flat(jg), np_flat(tg)
    scale_got = min(1.0, 1.0 / max(float(tm["grad_norm"]), 1e-9))
    scale_want = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    p0, want, got = ref_flat(jp), ref_flat(jp1), np_flat(tp1)
    for k, v in want.items():
        if opt_name == "adamw":
            bound = adamw_bound(g_got[k] * scale_got, g_ref[k] * scale_want,
                                got[k], v, lr)
        else:
            bound = adafactor_bound(v - p0[k], p0[k], rel=1e-4)
        err = np.abs(got[k] - v)
        assert np.all(err <= bound), (k, float((err - bound).max()))
    want_s, got_s = ref_flat(js1), np_flat(ts1)
    assert set(got_s) == set(want_s)


def test_launcher_trains_both_frontends(tmp_path):
    """``launch.train`` builds the reference's batches (``encoder_batch_at``
    frames and labels for the frame frontend, zero patches beside the
    tokens for the patch frontend, byte for byte) and trains both configs
    reduced for a few steps with finite losses, the vlm through a
    checkpoint and a resume."""
    from repro.data import pipeline as jpipe

    from repro_torch.launch import train as launch

    for name in NAMES:
        cfg = get_config(name).reduced()
        dc = pipeline.DataConfig(cfg.vocab_size, 16, 4, seed=3)
        jdc = jpipe.DataConfig(cfg.vocab_size, 16, 4, seed=3)
        got = launch.batch_for(cfg, dc, 5)
        if cfg.frontend == "frame":
            want = jpipe.encoder_batch_at(jdc, 5, cfg.frontend_dim)
        else:
            want = dict(jpipe.batch_at(jdc, 5), patches=np.zeros(
                (4, cfg.frontend_tokens, cfg.frontend_dim), np.float32))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (name, k)
    hist = launch.main(["--arch", "hubert-xlarge", "--reduced", "--steps",
                        "3", "--batch", "4", "--seq", "16", "--log-every",
                        "1", "--device", "cpu"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    run = ["--arch", "qwen2-vl-72b", "--reduced", "--batch", "2", "--seq",
           "8", "--device", "cpu", "--ckpt-dir", str(tmp_path / "run"),
           "--ckpt-interval", "1", "--log-every", "1"]
    launch.main(run + ["--steps", "1"])
    hist = launch.main(run + ["--steps", "2"])
    assert [h["step"] for h in hist] == [1]
    assert all(np.isfinite(h["loss"]) for h in hist)


# ---------------------------------------------------------------------------
# the committed fixtures chip_smoke.py phase 17 reads on the card
# ---------------------------------------------------------------------------

FIXTURE_SEQ = 12
FIXTURE_PREFILL = 5


def build_fixture(name) -> dict:
    """The reduced config made by the JAX package on the CPU: its
    parameters (``param/...``, layers stacked), a B = 2 batch, the forward
    logits, and for the vlm the logits of a prefill of the patches and
    ``FIXTURE_PREFILL`` tokens (its last position) followed by decode
    steps over the rest."""
    jcfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = batch_for(cfg, s=FIXTURE_SEQ)
    out = {"param/" + k: v for k, v in ref_flat(params).items()}
    out.update({"batch/" + k: v for k, v in batch.items()})
    logits, _, _ = jlm.forward(params, jbatch(batch), jcfg)
    out["logits_forward"] = np.asarray(logits)
    if jcfg.has_decode:
        toks, n_p = batch["tokens"], jcfg.frontend_tokens
        pre = dict(batch, tokens=toks[:, :FIXTURE_PREFILL])
        lg, caches, _ = jlm.forward(params, jbatch(pre), jcfg,
                                    mode="prefill",
                                    cache_len=n_p + toks.shape[1])
        outs = [lg[:, -1:]]
        for i in range(FIXTURE_PREFILL, toks.shape[1]):
            lg, caches = jlm.decode_step(
                params, jnp.asarray(toks[:, i:i + 1]), caches,
                jnp.int32(n_p + i), jcfg)
            outs.append(lg)
        out["logits_decode"] = np.asarray(jnp.concatenate(outs, 1))
        out["prefill_len"] = np.int32(FIXTURE_PREFILL)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_current(name):
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


def port_against_fixture(stored, cfg, device) -> dict:
    """What phase 17 does with a fixture on the card: the port's forward
    (and for the vlm its prefill and decode steps) from the fixture's
    weights and batch, -> ``{name: (got, want)}`` numpy pairs."""
    params = lm_params_from_reference(tree_from_flat(stored, "param/"), cfg,
                                      device=device)
    batch = {k[len("batch/"):]: torch.from_numpy(v).to(device)
             for k, v in stored.items() if k.startswith("batch/")}
    with torch.no_grad():
        logits, _, _ = lm.forward(params, batch, cfg)
        out = {"forward": (logits.cpu().numpy(), stored["logits_forward"])}
        if "logits_decode" in stored:
            toks, n_p = batch["tokens"], cfg.frontend_tokens
            half = int(stored["prefill_len"])
            lg, caches, _ = lm.forward(
                params, dict(batch, tokens=toks[:, :half]), cfg,
                mode="prefill", cache_len=n_p + toks.shape[1])
            outs = [lg[:, -1:]]
            for i in range(half, toks.shape[1]):
                lg, caches = lm.decode_step(params, toks[:, i:i + 1], caches,
                                            n_p + i, cfg)
                outs.append(lg)
            out["decode"] = (torch.cat(outs, 1).cpu().numpy(),
                             stored["logits_decode"])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_port_matches_fixture_on_cpu(name):
    with np.load(FIXTURE_FILES[name]) as f:
        stored = {k: f[k] for k in f.files}
    pairs = port_against_fixture(stored, get_config(name).reduced(), "cpu")
    assert set(pairs) == ({"forward", "decode"} if name == "qwen2-vl-72b"
                          else {"forward"})
    for got, want in pairs.values():
        within(got, want)


if __name__ == "__main__":              # regenerate the fixtures
    FIXTURES.mkdir(exist_ok=True)
    for n, p in FIXTURE_FILES.items():
        np.savez_compressed(p, **build_fixture(n))
        print(p, p.stat().st_size)
