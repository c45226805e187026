"""Resuming training (``repro_torch/launch/train.py`` and the resume half of
``repro_torch/checkpoint/{ckpt,manager}.py``): the port's launcher killed
after an in-loop checkpoint and resumed ends with an uninterrupted run's
digest; a checkpoint labelled by the updates it holds; checkpoints crossing
between the packages both ways, for both optimizers; bf16 leaves written in
the reference's format and read back bit for bit, including one the
reference wrote.

Crossing runs are held within ``1e-4 * max|want| + 1e-5`` of the other
package's straight run.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.launch.train import main as j_train_main

from repro_torch.checkpoint import ckpt
from repro_torch.launch import train as launch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
BASE = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "4", "--seq", "32",
        "--log-every", "100"]
WAIT_S = 240


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def within(got, want, rel=1e-4, atol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = rel * np.abs(want).max() + atol
    err = np.abs(got - want).max()
    assert err <= bound, f"max-abs {err:.3g} > {bound:.3g}"
    return err


def manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


def leaves(directory, step):
    arrays, _ = ckpt.restore_arrays(str(directory), step, verify=True)
    return arrays


def port_main(args):
    return launch.main(BASE + args + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# killed and resumed (R5)
# ---------------------------------------------------------------------------

# 60 steps of ~30 ms with a checkpoint every 2 outlast the 0.02 s poll
# below by far
KILL_ARGS = BASE + ["--steps", "60", "--ckpt-interval", "2", "--device",
                    "cpu"]
# the launcher's main on the reduced config in bf16, so the checkpoint
# holds bf16 leaves
BF16_MAIN = """
import dataclasses, sys
from repro_torch.configs import get_config
from repro_torch.launch import train
cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                          param_dtype="bfloat16", compute_dtype="bfloat16")
train.main(sys.argv[1:], cfg=cfg)
"""


def _spawn(ckpt_dir):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(
        [sys.executable, "-c", BF16_MAIN, *KILL_ARGS,
         "--ckpt-dir", str(ckpt_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=30)
        raise AssertionError(f"training did not end in {WAIT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return out


def test_sigkill_after_an_in_loop_save_resumes_to_the_same_digest(tmp_path):
    """SIGKILL the port's launcher (bf16 weights) once an in-loop
    checkpoint is on disk, run it again with the same flags: it resumes
    from that checkpoint and its final one equals an uninterrupted run's,
    digest and every leaf (a checkpoint labelled one update early would
    replay a batch and end elsewhere, ROADMAP.md R5)."""
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    ref_proc = _spawn(straight)
    child = _spawn(killed)
    deadline = time.time() + WAIT_S
    try:
        while time.time() < deadline and child.poll() is None:
            if ckpt.available_steps(str(killed)):
                child.send_signal(signal.SIGKILL)
                child.wait(timeout=30)
                break
            time.sleep(0.02)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    _finish(ref_proc)
    assert child.returncode == -signal.SIGKILL
    at_kill = ckpt.available_steps(str(killed))
    assert at_kill and at_kill[-1] < 60 and at_kill[-1] % 2 == 0, at_kill
    out = _finish(_spawn(killed))
    resumed_from = at_kill[-1]
    assert f"resumed from step {resumed_from}" in out, out
    want, got = manifest(straight, 60), manifest(killed, 60)
    assert got["digest"] == want["digest"]
    dtypes = {e["dtype"] for e in got["index"].values()}
    assert "bfloat16" in dtypes and "float32" in dtypes
    a, b = leaves(straight, 60), leaves(killed, 60)
    assert set(a) == set(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_an_in_loop_checkpoint_holds_its_label_of_updates(tmp_path):
    """The save after the update that consumed batch k is labelled k + 1:
    the in-loop ``step_2`` of a 4-step run equals the final ``step_2`` of a
    2-step run (both inside the warmup, so one schedule)."""
    port_main(["--steps", "4", "--ckpt-interval", "2", "--ckpt-dir",
               str(tmp_path / "a")])
    port_main(["--steps", "2", "--ckpt-interval", "100", "--ckpt-dir",
               str(tmp_path / "b")])
    assert ckpt.available_steps(str(tmp_path / "a")) == [2, 4]
    assert manifest(tmp_path / "a", 2)["extra"] == {"step": 2}
    assert manifest(tmp_path / "a", 2)["digest"] \
        == manifest(tmp_path / "b", 2)["digest"]
    a, b = leaves(tmp_path / "a", 2), leaves(tmp_path / "b", 2)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert int(a["opt/step"]) == 2


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_resume_in_process_equals_straight(tmp_path, optimizer):
    """Three updates, the final checkpoint removed, resumed to three: bit
    for bit the straight run, for both optimizers' state layouts."""
    args = ["--optimizer", optimizer, "--steps", "3", "--ckpt-interval", "2"]
    port_main(args + ["--ckpt-dir", str(tmp_path / "a")])
    port_main(args + ["--ckpt-dir", str(tmp_path / "b")])
    os.rename(tmp_path / "b" / "step_0000000003", tmp_path / "gone")
    hist = port_main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert [h["step"] for h in hist] == [2]
    a, b = leaves(tmp_path / "a", 3), leaves(tmp_path / "b", 3)
    assert set(a) == set(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


# ---------------------------------------------------------------------------
# crossing the packages
# ---------------------------------------------------------------------------

def _params(arrays):
    return {k: v for k, v in arrays.items() if k.startswith("params/")}


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_reference_checkpoint_resumes_in_the_port(tmp_path, optimizer):
    """The reference trains 3 steps and saves; the port resumes its
    directory and trains to 6; its parameters equal the reference's
    straight 6-step run within the bound, and so does its state."""
    args = ["--optimizer", optimizer, "--ckpt-interval", "100"]
    cross, straight = str(tmp_path / "cross"), str(tmp_path / "straight")
    j_train_main(BASE + args + ["--steps", "3", "--ckpt-dir", cross])
    port_main(args + ["--steps", "6", "--ckpt-dir", cross])
    j_train_main(BASE + args + ["--steps", "6", "--ckpt-dir", straight])
    got, want = leaves(cross, 6), leaves(straight, 6)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        within(got[k], want[k])


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_port_checkpoint_resumes_in_the_reference(tmp_path, optimizer):
    """The port trains 3 steps and saves; the reference's ``main`` resumes
    that directory and trains to 6; its parameters equal the port's
    straight 6-step run within the bound."""
    args = ["--optimizer", optimizer, "--ckpt-interval", "100"]
    cross, straight = str(tmp_path / "cross"), str(tmp_path / "straight")
    port_main(args + ["--steps", "3", "--ckpt-dir", cross])
    j_train_main(BASE + args + ["--steps", "6", "--ckpt-dir", cross])
    port_main(args + ["--steps", "6", "--ckpt-dir", straight])
    got, want = leaves(cross, 6), leaves(straight, 6)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        within(got[k], want[k])


# ---------------------------------------------------------------------------
# bf16 leaves
# ---------------------------------------------------------------------------

def _bf16_bits():
    """Every kind of bf16 value: normals, subnormals, signed zeros,
    infinities and a NaN."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, 60).astype(np.uint16)
    special = np.array([0x0000, 0x8000, 0x0001, 0x807F, 0x7F80, 0xFF80,
                        0x7FC1, 0x3F80], np.uint16)
    return np.concatenate([bits, special]).reshape(4, 17)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    """The port writes a bf16 tensor as the reference does (the same
    ``.npy`` bytes and manifest), and reads it back bit for bit: by
    ``restore`` into a bf16 tensor, and by ``restore_arrays`` (verified)
    as two-byte records."""
    bits = _bf16_bits()
    tensor = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16)
    tree = {"w": tensor, "n": {"s": torch.tensor(7, dtype=torch.int32)}}
    ckpt.save(str(tmp_path / "port"), 1, tree)
    j_ckpt.save(str(tmp_path / "ref"), 1,
                {"w": jnp.asarray(bits.view(jnp.bfloat16)),
                 "n": {"s": jnp.int32(7)}})
    mp, mr = manifest(tmp_path / "port", 1), manifest(tmp_path / "ref", 1)
    assert mp == mr
    assert mp["index"]["w"]["dtype"] == "bfloat16"
    for entry in mp["index"].values():
        with open(tmp_path / "port" / "step_0000000001" / entry["file"],
                  "rb") as a, \
                open(tmp_path / "ref" / "step_0000000001" / entry["file"],
                     "rb") as b:
            assert a.read() == b.read()
    like = {"w": torch.empty((4, 17), dtype=torch.bfloat16, device="meta"),
            "n": {"s": torch.empty((), dtype=torch.int32, device="meta")}}
    out, _ = ckpt.restore(str(tmp_path / "port"), 1, like, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert out["w"].view(torch.int16).numpy().tobytes() == bits.tobytes()
    assert out["n"]["s"].shape == () and int(out["n"]["s"]) == 7
    arrays, _ = ckpt.restore_arrays(str(tmp_path / "port"), 1, verify=True)
    assert ckpt.is_bf16(arrays["w"])
    assert ckpt.from_host(arrays["w"]).view(torch.int16).numpy().tobytes() \
        == bits.tobytes()


def test_reference_bf16_leaf_loads_into_the_port(tmp_path):
    """A bf16 leaf the reference wrote loads into the port bit for bit
    (the reference's own ``restore`` cannot cast it back, ROADMAP.md R6,
    so bf16 checkpoints cross from the reference to the port only)."""
    bits = _bf16_bits()
    jtree = {"w": jnp.asarray(bits.view(jnp.bfloat16))}
    j_ckpt.save(str(tmp_path), 3, jtree)
    like = {"w": torch.empty((4, 17), dtype=torch.bfloat16, device="meta")}
    out, _ = ckpt.restore(str(tmp_path), 3, like, device="cpu")
    assert out["w"].view(torch.int16).numpy().tobytes() == bits.tobytes()
    with pytest.raises(ValueError):
        j_ckpt.restore(str(tmp_path), 3, jax.eval_shape(lambda: jtree))
