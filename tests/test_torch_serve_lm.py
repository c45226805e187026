"""The port's LM serving path (``repro_torch/serve/decode.py``,
``repro_torch/serve/batching.py``, ``repro_torch.launch.serve``) held against
the JAX reference (``repro/serve``) at temperature 0, reduced configs, f32.

Logits are compared, not only tokens: each decode call's logits for the
slots it serves are recorded by wrapping the server's decode function and
held against the reference within ``1e-4 * max|want| + 1e-5``; tokens are
compared only while the top-2 margin exceeds 10x that tolerance (past a
near tie either token is right).  The staggered-slot test serves requests
of different prompt lengths in fewer slots than requests, so slots at
different positions share every decode call: a step that wrote the new K/V
column into every row would corrupt the other slots' caches, and it fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.serve import batching as jbatching
from repro.serve import decode as jdecode

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.serve import decode
from repro_torch.serve.batching import BatchedServer, GEEDeltaServer, Request
from repro_torch.search.service import GEEDeltaServer as ServiceDeltaServer


def tolerance(want) -> float:
    return 1e-4 * float(np.abs(want).max()) + 1e-5


def check_logits(got, want):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    assert err <= tolerance(want), (err, tolerance(want))


def margin(row, vocab) -> float:
    top = np.sort(np.asarray(row[:vocab], np.float64))[-2:]
    return float(top[1] - top[0])


def models(name="qwen3-0.6b", seed=0):
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return jcfg, jp, cfg, tp


def ref_logits(jp, jcfg, seq):
    """The reference's forward logits over one token sequence."""
    out, _, _ = jlm.forward(jp, {"tokens": jnp.asarray(seq)[None]}, jcfg)
    return np.asarray(out[0])


def record(server):
    """Wrap the server's decode function: the logits of every emitted
    token, by request and position."""
    rec = {}
    orig = server._decode

    def wrapped(p, c, t, pos, rows):
        logits, caches = orig(p, c, t, pos, rows)
        for s in rows:
            req = server.slot_req[s]
            if pos >= len(req.prompt) - 1:          # a tick, not prefill
                rec.setdefault(req.uid, {})[pos] = logits[s, 0].cpu().numpy()
        return logits, caches

    server._decode = wrapped
    return rec


def hold_request(req, rec, jp, jcfg, vocab):
    """Every emitted token's logits against the reference's forward over
    prompt + output; returns how many tokens were emitted."""
    seq = np.concatenate([req.prompt, np.asarray(req.output, np.int32)])
    want = ref_logits(jp, jcfg, seq)
    p0 = len(req.prompt) - 1
    assert sorted(rec[req.uid]) == list(range(p0, p0 + len(req.output)))
    for j, tok in enumerate(req.output):
        got = rec[req.uid][p0 + j]
        check_logits(got, want[p0 + j])
        assert 0 <= tok < vocab
        if margin(got, vocab) > 10 * tolerance(want[p0 + j]):
            assert tok == int(np.argmax(got[:vocab]))
    return len(req.output)


def same_tokens_while_margins_allow(got_tokens, want_tokens, margins, tol):
    for g, w, m in zip(got_tokens, want_tokens, margins):
        if m <= 10 * tol:
            return
        assert g == w


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sample_never_returns_a_padded_id():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 1, 64)).astype(
        np.float32) * 10)
    logits[..., 50:] = 1e6                       # padded ids would win
    gen = torch.Generator().manual_seed(0)
    for temp in (0.0, 0.5, 1.0, 5.0):
        for _ in range(20):
            tok = decode.sample(logits, gen, temp, vocab_size=50)
            assert tok.dtype == torch.int32 and tuple(tok.shape) == (4, 1)
            assert int(tok.max()) < 50
    greedy = decode.sample(logits, None, 0.0, vocab_size=50)
    assert torch.equal(greedy[:, 0], logits[:, 0, :50].argmax(-1).int())
    assert float(logits[0, 0, 60]) == 1e6        # the input is not changed
    want = jdecode.sample(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                          0.0, 50)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))


def test_sample_at_temperature_is_seeded_and_calibrated():
    logits = torch.tensor([[[0.0, float(np.log(3.0)), -1e30]]]).repeat(
        4000, 1, 1)
    a = decode.sample(logits, torch.Generator().manual_seed(1), 1.0)
    b = decode.sample(logits, torch.Generator().manual_seed(1), 1.0)
    assert torch.equal(a, b)
    share = float((a == 1).float().mean())
    assert abs(share - 0.75) < 0.03 and int(a.max()) <= 1


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("qwen3-0.6b", "chatglm3-6b"))
def test_generate_matches_reference(name, monkeypatch):
    jcfg, jp, cfg, tp = models(name)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    steps = []
    orig_fwd, orig_dec = lm.forward, lm.decode_step

    def fwd(*a, **kw):
        out = orig_fwd(*a, **kw)
        steps.append(out[0][:, -1].numpy().copy())
        return out

    def dec(*a, **kw):
        out = orig_dec(*a, **kw)
        steps.append(out[0][:, 0].numpy().copy())
        return out

    monkeypatch.setattr(lm, "forward", fwd)
    monkeypatch.setattr(lm, "decode_step", dec)
    got = decode.generate(tp, cfg, torch.from_numpy(prompt),
                          max_new_tokens=6).numpy()
    monkeypatch.undo()
    assert got.shape == (2, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :6], prompt)
    assert len(steps) == 6
    want = np.asarray(jdecode.generate(jp, jcfg, jnp.asarray(prompt),
                                       max_new_tokens=6))
    for row in range(2):
        ref = ref_logits(jp, jcfg, got[row])
        for j in range(6):
            check_logits(steps[j][row], ref[5 + j])
        same_tokens_while_margins_allow(
            got[row, 6:], want[row, 6:],
            [margin(steps[j][row], cfg.vocab_size) for j in range(6)],
            tolerance(ref[5:11]))


def test_generate_eos_and_determinism():
    _, _, cfg, tp = models()
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32))
    a = decode.generate(tp, cfg, prompt, max_new_tokens=5, temperature=0.8,
                        seed=7)
    b = decode.generate(tp, cfg, prompt, max_new_tokens=5, temperature=0.8,
                        seed=7)
    assert torch.equal(a, b) and int(a.max()) < cfg.vocab_size
    greedy = decode.generate(tp, cfg, prompt, max_new_tokens=5)
    eos = int(greedy[0, 6])                       # row 0's second new token
    cut = decode.generate(tp, cfg, prompt, max_new_tokens=5, eos_id=eos)
    assert torch.equal(cut[0, :7], greedy[0, :7])
    assert (cut[0, 7:] == eos).all()


def test_prefill_and_serve_step_builders():
    _, _, cfg, tp = models()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    last, caches = decode.make_prefill(cfg, cache_len=12)(
        tp, {"tokens": toks[:, :7]})
    assert tuple(last.shape) == (2, 1, cfg.padded_vocab)
    assert tuple(caches["k"].shape)[:3] == (cfg.num_layers, 2, 12)
    step = decode.make_serve_step(cfg)
    logits, caches = step(tp, caches, toks[:, 7:8], 7)
    full, _, _ = lm.forward(tp, {"tokens": toks}, cfg)
    check_logits(logits[:, 0].numpy(), full[:, 7].numpy())
    check_logits(last[:, 0].numpy(), full[:, 6].numpy())


# ---------------------------------------------------------------------------
# the continuous-batching server
# ---------------------------------------------------------------------------

def _requests(cfg, lens, news, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("name", ("qwen3-0.6b", "granite-3-8b"))
def test_batched_server_matches_reference(name):
    jcfg, jp, cfg, tp = models(name)
    lens, news = (5, 8, 3, 6), (5, 3, 6, 4)
    server = BatchedServer(tp, cfg, batch_slots=2, max_len=32, device="cpu")
    rec = record(server)
    for r in _requests(cfg, lens, news):
        server.submit(r)
    done = {r.uid: r for r in server.run()}
    jserver = jbatching.BatchedServer(jp, jcfg, batch_slots=2, max_len=32)
    for r in _requests(cfg, lens, news):
        jserver.submit(jbatching.Request(uid=r.uid, prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens))
    jdone = {r.uid: r for r in jserver.run()}
    assert sorted(done) == sorted(jdone) == list(range(4))
    for uid, req in done.items():
        assert hold_request(req, rec, jp, jcfg, cfg.vocab_size) == news[uid]
        p0 = len(req.prompt) - 1
        ref = ref_logits(jp, jcfg, np.concatenate(
            [req.prompt, np.asarray(req.output, np.int32)]))
        same_tokens_while_margins_allow(
            req.output, jdone[uid].output,
            [margin(rec[uid][p0 + j], cfg.vocab_size)
             for j in range(len(req.output))], tolerance(ref))


@pytest.mark.parametrize("slots", (2, 3))
def test_staggered_slots_match_their_own_generate(slots):
    """Requests of different prompt lengths in fewer slots: every decode
    call serves one position group while the other slots sit at other
    positions.  Each request equals its own ``generate``."""
    jcfg, jp, cfg, tp = models(seed=2)
    lens, news = (3, 9, 5, 12, 7, 4), (6, 3, 8, 4, 5, 7)
    server = BatchedServer(tp, cfg, batch_slots=slots, max_len=32,
                           device="cpu")
    rec = record(server)
    for r in _requests(cfg, lens, news, seed=1):
        server.submit(r)
    done = server.run()
    assert len(done) == 6
    assert server.stats["ticks"] < sum(news)      # slots did share ticks
    for req in done:
        assert hold_request(req, rec, jp, jcfg, cfg.vocab_size) \
            == news[req.uid]
        alone = decode.generate(tp, cfg, torch.from_numpy(req.prompt)[None],
                                max_new_tokens=req.max_new_tokens).numpy()
        p0 = len(req.prompt) - 1
        ref = ref_logits(jp, jcfg, alone[0])
        same_tokens_while_margins_allow(
            req.output, alone[0, len(req.prompt):],
            [margin(rec[req.uid][p0 + j], cfg.vocab_size)
             for j in range(len(req.output))], tolerance(ref))


def test_batched_server_slot_churn():
    _, _, cfg, tp = models()
    rng = np.random.default_rng(0)
    server = BatchedServer(tp, cfg, batch_slots=2, max_len=48, device="cpu")
    for uid in range(5):
        server.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 6))))
    done = server.run()
    assert len(done) == 5
    assert all(r.done for r in done)
    assert server.stats["tokens_out"] == sum(len(r.output) for r in done)
    assert 0 < min(server.stats["batch_occupancy"]) \
        <= max(server.stats["batch_occupancy"]) <= 1.0
    assert all(r is None for r in server.slot_req)


def test_server_resets_a_slot_in_place_and_stops_at_max_len():
    _, _, cfg, tp = models()
    server = BatchedServer(tp, cfg, batch_slots=2, max_len=10, device="cpu")
    k = server.caches["k"]
    for r in _requests(cfg, (4, 6), (50, 50)):
        server.submit(r)
    done = server.run()
    assert server.caches["k"] is k                # never reallocated
    for r in done:                                # the cache's last column
        assert len(r.prompt) - 1 + len(r.output) == 10 - 1
    server._reset_slot(1)
    assert (server.caches["pos"][:, 1] == -1).all()
    assert (server.caches["k"][:, 1] == 0).all()
    assert (server.caches["pos"][:, 0] >= 0).any()


def test_unported_family_refused_by_the_server():
    """The vlm, once refused, is served over token prompts (its parity
    with the reference's server: test_torch_frontends.py); the
    encoder-only audio config is refused, having no decode step."""
    cfg = get_config("qwen2-vl-72b").reduced()
    server = BatchedServer(lm.init_params(cfg, device="cpu"), cfg,
                           batch_slots=1, max_len=8, device="cpu")
    server.submit(Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                          max_new_tokens=2))
    assert len(server.run()[0].output) == 2
    with pytest.raises(ValueError, match="encoder-only"):
        BatchedServer({}, get_config("hubert-xlarge").reduced(),
                      batch_slots=1, max_len=8, device="cpu")


def test_gee_delta_server_reexport():
    assert GEEDeltaServer is ServiceDeltaServer


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_launch_serve_runs_reduced_on_cpu(capsys):
    done = serve_cli.main(["--device", "cpu", "--requests", "5", "--slots",
                           "2", "--max-new", "6", "--seed", "1"])
    assert len(done) == 5 and all(r.done for r in done)
    assert all(4 <= len(r.output) <= 6 for r in done)
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "tok/s" in out


def test_launch_serve_no_reduced_reaches_the_published_config(monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def fake_init(cfg, seed=0, **kw):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(serve_cli.lm, "init_params", fake_init)
    for argv, layers in ((["--device", "cpu"], 2),
                         (["--device", "cpu", "--reduced"], 2),
                         (["--device", "cpu", "--no-reduced"], 28)):
        with pytest.raises(Stop):
            serve_cli.main(argv)
        assert seen[-1].num_layers == layers
    assert seen[-1] == get_config("qwen3-0.6b")
    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", "--arch", "hubert-xlarge"])


@pytest.mark.parametrize("arch,layers", [
    ("deepseek-moe-16b", 28), ("kimi-k2-1t-a32b", 61), ("mamba2-2.7b", 64),
    ("recurrentgemma-2b", 26)])
def test_launch_serve_reaches_the_other_families(arch, layers, capsys,
                                                 monkeypatch):
    """The MoE, SSM and hybrid families serve reduced on the CPU through
    the CLI; ``--no-reduced`` reaches their published configs."""
    done = serve_cli.main(["--device", "cpu", "--arch", arch, "--requests",
                           "3", "--slots", "2", "--max-new", "5"])
    assert len(done) == 3 and all(r.done for r in done)
    assert "served 3 requests" in capsys.readouterr().out
    seen = []

    class Stop(Exception):
        pass

    def fake_init(cfg, seed=0, **kw):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(serve_cli.lm, "init_params", fake_init)
    with pytest.raises(Stop):
        serve_cli.main(["--device", "cpu", "--arch", arch, "--no-reduced"])
    assert seen[-1] == get_config(arch) and seen[-1].num_layers == layers


@pytest.mark.cuda
def test_graphed_server_on_card():
    """On the card the server replays the decode step as a CUDA graph:
    staggered slots, every emitted token's logits against a forward over
    prompt + output on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs run only there)")
    cfg = get_config("qwen3-0.6b").reduced()
    params = lm.init_params(cfg, 0, device="cuda")
    server = BatchedServer(params, cfg, batch_slots=3, max_len=32,
                           device="cuda")
    rec = record(server)
    for r in _requests(cfg, (3, 9, 5, 12, 7), (6, 3, 8, 4, 5), seed=1):
        server.submit(r)
    done = server.run()
    assert len(done) == 5
    for req in done:
        seq = np.concatenate([req.prompt, np.asarray(req.output, np.int32)])
        want, _, _ = lm.forward(params, {"tokens": torch.from_numpy(seq)[None]
                                         .cuda()}, cfg)
        p0 = len(req.prompt) - 1
        for j in range(len(req.output)):
            check_logits(rec[req.uid][p0 + j], want[0, p0 + j].cpu().numpy())
