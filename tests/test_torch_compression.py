"""The port's int8 error-feedback compression
(``repro_torch/distributed/compression.py``) against the JAX reference's
(``repro/distributed/compression.py``): the counterparts of
``tests/test_compression.py``, plus quantization bit for bit, and the
compressed mean over four gloo ranks against the reference's own
four-device ``compressed_psum_mean`` (fake XLA devices in a subprocess)
and against the exact mean.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.distributed import compression as jcomp

from repro_torch.distributed.compression import (
    compressed_all_reduce_mean, dequantize_int8, make_compressed_allreduce,
    quantize_int8, wire_bytes_f32, wire_bytes_int8)

from conftest import run_with_devices

SPAWN_TIMEOUT_S = 240
WORLD = 4


def _x(seed, shape, scale=5.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(_x(0, 1000))
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-6      # half-ulp bound


@pytest.mark.parametrize("seed,scale", [(0, 5.0), (1, 1e-3), (2, 0.0),
                                        (3, 1e4)])
def test_quantize_matches_reference(seed, scale):
    """The int8 payload bit for bit and the scale (round half to even on
    both sides; an all-zero tensor takes the 1e-12 floor)."""
    x = _x(seed, (7, 33), scale)
    wq, ws = jcomp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert float(s) == pytest.approx(float(ws), rel=1e-7)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(jcomp.dequantize_int8(wq, ws)),
                               rtol=1e-6, atol=0)


def test_error_feedback_reduces_bias():
    """Repeated compression of the same gradient: with error feedback the
    accumulated update converges to the true sum; without it the
    quantization bias persists."""
    g = torch.from_numpy(_x(1, 256, 0.01))
    steps = 50
    total_fb = torch.zeros_like(g)
    err = torch.zeros_like(g)
    total_nofb = torch.zeros_like(g)
    for _ in range(steps):
        q, s = quantize_int8(g + err)
        deq = dequantize_int8(q, s)
        err = (g + err) - deq
        total_fb += deq
        q2, s2 = quantize_int8(g)
        total_nofb += dequantize_int8(q2, s2)
    true = g * steps
    err_fb = float((total_fb - true).abs().max())
    err_nofb = float((total_nofb - true).abs().max())
    assert err_fb <= err_nofb + 1e-7
    assert err_fb < float(g.abs().max())          # bounded residual


def test_wire_bytes_accounting():
    tree = {"a": torch.zeros((100,)), "b": torch.zeros((10, 10))}
    jtree = {"a": jnp.zeros((100,)), "b": jnp.zeros((10, 10))}
    assert wire_bytes_f32(tree) == jcomp.wire_bytes_f32(jtree) == 800
    assert wire_bytes_int8(tree) == jcomp.wire_bytes_int8(jtree) == 208


def _rank_main(rank, world, store, out_dir, xs_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        xs = np.load(xs_path)
        x = torch.from_numpy(xs[rank])
        mean, err = compressed_all_reduce_mean(x, None, torch.zeros_like(x))
        # twice more with the kept error: the running mean of three
        # compressed means approaches the exact one
        mesh = make_mesh_for(world, 1, device_type="cpu")
        allreduce = make_compressed_allreduce(mesh, "data")
        tree, etree = {"g": [x]}, {"g": [err]}
        means = [mean]
        for _ in range(2):
            out, etree = allreduce(tree, etree)
            means.append(out["g"][0])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 mean=mean.numpy(), err=err.numpy(),
                 means=torch.stack(means).numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("comp")
    xs = np.random.default_rng(0).standard_normal((WORLD, 64)).astype(
        np.float32)
    np.save(d / "xs.npy", xs)
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, str(d / "store"), str(d),
                          str(d / "xs.npy")),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return xs, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)], d


def test_compressed_mean_matches_exact_mean(four_ranks):
    """Every rank holds the same mean, within int8 quantization noise of
    the exact one (the reference's own test's bound)."""
    xs, ranks, _ = four_ranks
    true = xs.mean(0)
    for r in ranks:
        np.testing.assert_array_equal(r["mean"], ranks[0]["mean"])
    rel = np.abs(ranks[0]["mean"] - true).max() / (np.abs(true).max() + 1e-9)
    assert rel < 0.05, rel
    # the shared scale: each element off by at most half a quantum a rank
    scale = np.abs(xs).max() / 127
    assert np.abs(ranks[0]["mean"] - true).max() <= scale / 2 + 1e-6
    # the kept error is the rank's own residual
    for x, r in zip(xs, ranks):
        assert np.abs(r["err"]).max() <= scale / 2 + 1e-6


def test_error_feedback_mean_converges(four_ranks):
    xs, ranks, _ = four_ranks
    true = xs.mean(0)
    means = ranks[0]["means"]
    first = np.abs(means[0] - true).max()
    running = np.abs(means.mean(0) - true).max()
    assert running <= first + 1e-7


def test_four_ranks_match_the_reference_four_devices(four_ranks):
    """The reference's ``compressed_psum_mean`` over 4 fake XLA devices on
    the same inputs: the same mean and the same kept errors, within f32
    round-off of the dequantization."""
    xs, ranks, d = four_ranks
    code = f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.compat import shard_map_nocheck
from repro.distributed.compression import compressed_psum_mean
mesh = jax.make_mesh((4,), ('data',))
x = jnp.asarray(np.load({str(d / "xs.npy")!r}))
def body(xs, err):
    m, e = compressed_psum_mean(xs[0], 'data', err[0])
    return m, e[None]
mean, err = shard_map_nocheck(
    body, mesh=mesh, in_specs=(P('data'), P('data')),
    out_specs=(P(), P('data')))(x, jnp.zeros_like(x))
np.savez({str(d / "ref.npz")!r}, mean=np.asarray(mean), err=np.asarray(err))
print('OK')
"""
    assert "OK" in run_with_devices(code, WORLD)
    ref = np.load(d / "ref.npz")
    np.testing.assert_allclose(ranks[0]["mean"], ref["mean"], rtol=1e-6,
                               atol=1e-7)
    for r, want in zip(ranks, ref["err"]):
        np.testing.assert_allclose(r["err"], want, rtol=1e-6, atol=1e-7)
