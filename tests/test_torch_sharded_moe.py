"""The port's train step on a (data, model) mesh with MoE layers, held
against the JAX reference's one-device step on the CPU: the reduced
``deepseek-moe-16b`` and ``kimi-k2-1t-a32b`` on meshes (1, 2), (2, 1),
(2, 2) and (1, 4), under the bounds ``tests/test_torch_sharded_train.py``
holds the other families to (its machinery, in a file of its own so that
a parallel run puts these spawns on another worker).

On (1, 2), (2, 2) and (1, 4) the MoE layers go through the expert-parallel
dispatch (``repro_torch/distributed/moe_ep.py``: the experts split over
``model``, an all-to-all each way), on (2, 1) through the global dispatch
(one capacity for all global tokens, as the reference's GSPMD
``moe_forward``).  The reduced configs' capacity factor (8.0) drops
nothing, so the drops there equal one device's; on (2, 1) deepseek also
runs at capacity factor 1.0, where choices drop, against the reference's
one-device step.  A batch of one row, which the two data ranks do not
split, runs on both: on (2, 1) at capacity factor 1.0 (the global
dispatch counts the row once, so it drops what one device drops) and on
(2, 2) (the expert-parallel dispatch).
"""

import json
import os

import numpy as np
import pytest

from test_torch_sharded_train import (B, MESHES, MICRO, OPTS, S,  # noqa: F401
                                      _one_thread, _prefixed,
                                      check_gradients, check_step,
                                      reference, reference_grads, spawned,
                                      within, write_inputs)

NAMES = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
# the capacity-binding case: reduced deepseek at capacity factor 1.0 on
# (2, 1), where the reference sorts all global tokens under one capacity
BINDING = "deepseek-moe-16b@cf1.0"
BINDING_MESH = "2x1"
# one row held by both data ranks: (name, mesh)
COPIED = (("deepseek-moe-16b@cf1.0@b1", "2x1"), ("deepseek-moe-16b@b1",
                                                  "2x2"))


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """mesh name -> rank 0's gathered results, the meshes of a world size
    spawned together; the binding case on (2, 1) only."""
    inputs = write_inputs(tmp_path_factory.mktemp("moe_inputs"),
                          NAMES + (BINDING,) + tuple(n for n, _ in COPIED))
    get = spawned(tmp_path_factory, inputs,
                  lambda m: NAMES + ((BINDING,) if m == BINDING_MESH
                                     else ())
                  + tuple(n for n, mesh in COPIED if mesh == m))
    return lambda mesh_name: get(mesh_name)[0]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_moe_gradients_match_reference(name, mesh_name, moe_ranks):
    check_gradients(moe_ranks(mesh_name), name)


@pytest.mark.parametrize("micro", MICRO)
@pytest.mark.parametrize("opt_name", OPTS)
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_moe_step_matches_reference(name, mesh_name, opt_name, micro,
                                            moe_ranks):
    check_step(moe_ranks(mesh_name), name, opt_name, micro)


def test_capacity_binding_moe_matches_the_global_dispatch(moe_ranks):
    """At capacity factor 1.0 on (2, 1) the reference's GSPMD dispatch
    sorts all 48 global tokens' choices under one capacity: the port's
    sharded loss and drop fraction are the one-device step's, and its
    gradients too, while some choices drop.  The drops are counted
    exactly: the metric is the layers' mean of 1 - kept / (T * k), and
    the reference's compiler turns the division by that constant into a
    product with its f32 reciprocal, so the two fractions may differ in
    their last bits while the counts are equal."""
    dropped = check_drops(moe_ranks(BINDING_MESH), BINDING)
    assert round(dropped["want"]) > 0, dropped


@pytest.mark.parametrize("name,mesh_name", COPIED)
def test_copied_rows_moe_matches_the_reference(name, mesh_name, moe_ranks):
    """A batch of one row on two data ranks, each holding it: the loss,
    the token count, the drops, the load balance and the gradients summed
    over the ranks are the reference's one-device step's.  At capacity
    factor 1.0 on (2, 1) choices drop, so the global dispatch must rank
    the copies' choices as one row's."""
    res = moe_ranks(mesh_name)
    check_gradients(res, name)
    dropped = check_drops(res, name)
    if "@cf1.0" in name:
        assert round(dropped["want"]) > 0, dropped


def check_drops(res, name):
    """The dropped choices, the loss, the load balance and the gradients
    of ``name`` against the reference's one-device step -> the two drop
    counts."""
    want_m, want = reference_grads(name)
    jcfg, _, batch = reference(name)
    choices = (jcfg.num_layers * batch["tokens"].shape[0] * S
               * jcfg.moe.top_k)
    got_m = _prefixed(res, f"metric/{name}/grad")
    dropped = {k: m["drop_fraction"] * choices for k, m in
               (("want", want_m), ("got", got_m))}
    assert round(dropped["got"]) == round(dropped["want"]), dropped
    assert all(abs(v - round(v)) < 1e-4 for v in dropped.values()), dropped
    assert float(got_m["loss"]) == pytest.approx(want_m["loss"], rel=1e-5)
    assert float(got_m["load_balance"]) == pytest.approx(
        want_m["load_balance"], rel=1e-5)
    got = _prefixed(res, f"grad/{name}")
    assert set(got) == set(want)
    for k, v in want.items():
        within(got[k], v)
    return dropped


# ---------------------------------------------------------------------------
# the launcher and the tool under torchrun, with MoE
# ---------------------------------------------------------------------------

# the launcher's main on reduced deepseek-moe-16b cut to one layer
CUT_MAIN = """
import dataclasses, sys
from repro_torch.configs import get_config
from repro_torch.launch import train
cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                          num_layers=1)
train.main(sys.argv[1:], cfg=cfg)
"""


def test_moe_launcher_resumes_on_another_mesh(tmp_path):
    """``launch.train`` with reduced deepseek-moe-16b cut to one layer
    (``main(argv, cfg=)``) on a (2, 2) mesh of gloo ranks
    (expert-parallel) checkpoints after 2 steps; restarted on (1, 2) it
    re-shards that checkpoint and runs steps 2-3, whose losses, norms and
    drop fractions are an uninterrupted one-process run's; each step line
    shows the drop fraction and the load-balance loss."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch

    from test_torch_sharded_train import _torchrun

    script = tmp_path / "cut_main.py"
    script.write_text(CUT_MAIN)
    args = ["--arch", "deepseek-moe-16b", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--device", "cpu", "--ckpt-interval", "2"]
    run = [str(script), *args, "--ckpt-dir", str(tmp_path / "run")]
    first = _torchrun(4, run + ["--devices", "4", "--model-parallel", "2",
                                "--steps", "2"])
    out = _torchrun(2, run + ["--devices", "2", "--model-parallel", "2",
                              "--steps", "4", "--metrics-out",
                              str(tmp_path / "m.json")])
    assert out.count("resumed from step 2") == 1
    steps = [ln for ln in (first + out).splitlines()
             if ln.startswith("step ")]
    assert len(steps) == 4 and all(" drop " in ln and " lb " in ln
                                   for ln in steps), steps
    got = json.loads((tmp_path / "m.json").read_text())
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              num_layers=1)
    want = launch.main(args + ["--steps", "4"], cfg=cfg)
    assert [h["step"] for h in got] == [2, 3]
    for g, w in zip(got, want[2:]):
        for k in ("loss", "grad_norm", "load_balance"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
        assert g["drop_fraction"] == w["drop_fraction"] == 0.0


def test_lm_ranks_tool_runs_moe_on_the_host(tmp_path):
    """``tools/lm_ranks.py --arch deepseek-moe-16b``: two gloo ranks on a
    (1, 2) mesh at the reduced size (the MoE layers expert-parallel), every
    check passed, the f32 check at a capacity factor with no drops."""
    from test_torch_sharded_train import SRC, _torchrun

    out = tmp_path / "ranks.json"
    stdout = _torchrun(2, [os.path.join(SRC, "..", "tools", "lm_ranks.py"),
                           "--arch", "deepseek-moe-16b", "--device", "cpu",
                           "--reduced", "--batch", "4", "--seq", "32",
                           "--steps", "2", "--check-seq", "16", "--out",
                           str(out)])
    assert stdout.count("lm_ranks: 2 ranks over gloo") == 1
    report = json.loads(out.read_text())
    assert report["mesh"] == [1, 2]
    check = report["f32_check"]
    assert check["grad_worst_over_bound"] <= 1.0
    assert check["drop_fraction"] == 0.0 and check["capacity_factor"] == 4.0
    assert len(report["bf16"]["drop_fractions"]) == 2
    assert report["checkpoint"]["restored_on"] == [2, 1]
