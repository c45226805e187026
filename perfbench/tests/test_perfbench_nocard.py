"""The bytes and operations of the rooflines on hand-made inputs, and
every measurement path failing, rather than falling back, without a card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, roofline, timing  # noqa: E402
from perfbench.reference import ivf  # noqa: E402

METRICS = sorted(p.stem for p in (ROOT / "perfbench/metrics").glob("*.py"))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card paths cannot be seen")


def test_fit_bytes_count_each_input_once():
    # a path 0-1-2 plus 2-3: 3 undirected, 6 directed edges; N 4, K 2
    assert roofline.fit_bytes(6, 4, 2) == 8 * 6 + 4 * 4 + 4 * 4 * 2
    assert roofline.fit_flops(6, 4, 2) == 2 * 6 + 3 * 4 * 2
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.bound_seconds(3.35e12, 0, peak) == pytest.approx(1.0)
    assert roofline.bound_seconds(0, 67e12, peak) == pytest.approx(1.0)


def test_flush_work_counts_the_probed_cells():
    # two tight clusters of 3 on the axes: two cells of 3 rows
    z = np.array([[1, 0], [1.1, 0], [0.9, 0], [0, 1], [0, 1.1], [0, 0.9]])
    labels = np.array([0, 0, 0, 1, 1, 1])
    index = ivf.build(z, labels, 2)
    both = ivf.search(index, z, np.array([0, 3]), 2, nprobe=1)
    v = ivf.judge(index, np.array([0, 3]), *both, nprobe=1)
    assert (v["pairs"], v["distinct_rows"]) == (6, 6)
    same = ivf.search(index, z, np.array([0, 1]), 2, nprobe=1)
    v = ivf.judge(index, np.array([0, 1]), *same, nprobe=1)
    assert (v["pairs"], v["distinct_rows"]) == (6, 3)
    assert roofline.flush_bytes(3, 2, 2, 2) == 4 * 2 * (3 + 2) + 8 * 2 * 2
    assert roofline.flush_flops(6, 3, 2, 2) == 6 * 6 + 2 * 2 * 5


def test_readers_share_a_roofline_and_an_idle_share():
    ctx = {"profile": {"busy_s": 0.5, "window_s": 2.0, "units": 4},
           "bound_s_per_unit": 0.01}
    read = {m: harness._load_module(ROOT / f"perfbench/metrics/{m}.py",
                                    "pb_test_" + m.replace(".", "_")).read
            for m in METRICS}
    assert read["fit_roofline"](ctx) == pytest.approx(8.0)
    assert read["flush_roofline"](ctx) == pytest.approx(8.0)
    assert read["device_idle_share.refit"](ctx) == pytest.approx(75.0)


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    read = harness._load_module(ROOT / f"perfbench/metrics/{metric}.py",
                                "pb_test_" + metric.replace(".", "_")).read
    assert read({}) is None
    assert read({"profile": None, "spans": (), "host": {}, "setup": {},
                 "bound_s_per_unit": None}) is None


def test_the_run_refuses_without_a_card(capsys):
    _no_card()
    from perfbench import run

    assert run.main(["--workload", "cl-100k-1d8-l5.refit", "--seed",
                     "3000000000", "--seconds", "1", "--trace", "0"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_the_control_refuses_without_a_card():
    _no_card()
    from perfbench import control

    assert control.main(["--workload", "sbm-10k.sweep8", "--seeds", "1"]) \
        == 1


def test_device_timing_refuses_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError):
        timing.gpu_ms(torch, lambda: None)


def test_a_profile_with_no_device_record_reduces_to_nothing():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(timing.WINDOW_MARK):
            torch.ones(64).sum()
    assert timing.breakdown(torch, prof) is None


def test_no_peaks_for_a_card_the_table_lacks():
    with pytest.raises(KeyError):
        roofline.peaks("cpu")


def test_idle_gaps_and_their_causes():
    busy = [[1.0, 2.0], [4.0, 5.0]]
    gaps = timing.idle_gaps(busy, (0.0, 6.0))
    assert gaps == [(0.0, 1.0), (2.0, 4.0), (5.0, 6.0)]
    host = [(0.0, 6.0, "outer"), (1.9, 4.1, "aten::copy_")]
    causes = timing.gap_causes(gaps, host)
    assert causes == {"outer": 2.0, "aten::copy_": 2.0}
