"""Cell discovery from ``BENCHMARK.json``: every cell resolves to its
configuration, traffic mix, limits and readers by name; a new mix, a new
metric, a new graph model and a new card are new files only; and the file keeps to the benchmark's
contract (names, units, sources, bounds, what each cell reports)."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_by_name(workload):
    found = harness.find_cell(BENCH, workload, ROOT)
    assert hasattr(found["loop"], "Loop")
    assert set(found["readers"]) == {m["name"] for m in found["per_layer"]}
    assert all(callable(r) for r in found["readers"].values())
    names = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and found["per_layer"]
    assert found["limits"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such.cell", ROOT)


def test_a_new_mix_and_metric_are_new_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "perfbench/traffic/refit_dummy.json").write_text(json.dumps(
        dict(json.loads((ROOT / "perfbench/traffic/refit.json").read_text()),
             group=4)))
    (tmp_path / "perfbench/metrics/dummy_reading.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (tmp_path / "perfbench/checks/sbm-10k.dummy.json").write_text(
        json.dumps({"limits": {"z_err": 1e-4}}))
    bench["workloads"].append({"name": "sbm-10k.dummy", "config": "sbm-10k",
                               "traffic": "refit_dummy", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_reading", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "fit_ms",
                               "workloads": ["sbm-10k.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    found = harness.find_cell(bench, "sbm-10k.dummy", tmp_path)
    assert found["traffic"]["group"] == 4
    assert found["readers"]["dummy_reading"]({}) == 42.0
    assert found["loop"].__name__ == "perfbench.loops.refit"
    for p, data in before.items():
        assert p.read_bytes() == data


RING = """
import torch
from perfbench.graphs import generator


def draw(cfg, seed, device):
    n = int(cfg["num_nodes"])
    src = torch.arange(n, dtype=torch.int32, device=device)
    labels = torch.randint(0, 2, (n,), generator=generator(seed, device),
                           device=device, dtype=torch.int32)
    return {"src": src, "dst": (src + 1) % n, "labels": labels,
            "num_nodes": n, "num_classes": 2}
"""

PROBE = """
import json, sys
sys.path[:0] = [{copy!r}, {src!r}]
from perfbench import graphs, roofline
g = graphs.make({{"generator": "ring", "structure_seed": 0,
                 "num_nodes": 8}}, 3, "cpu")
print(json.dumps({{"file": graphs.__file__, "edges": int(g["src"].numel()),
                  "labels": sorted(set(g["labels"].tolist())),
                  "peak": roofline.peaks("Fake Card 9 (SXM)")}}))
"""


def test_a_new_graph_model_and_card_are_new_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    (tmp_path / "perfbench/graphs/ring.py").write_text(RING)
    (tmp_path / "perfbench/peaks/Fake_Card_9__SXM_.json").write_text(
        json.dumps({"kind": "Fake Card 9 (SXM)", "bytes_per_s": 1e12,
                    "f32_flops": 2e12}))
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(copy=str(tmp_path),
                                            src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["edges"] == 8 and set(got["labels"]) <= {0, 1}
    assert got["peak"] == {"bytes_per_s": 1e12, "f32_flops": 2e12}
    for p, data in before.items():
        assert p.read_bytes() == data


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    chips4 = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        chips4 += w["chips"] == 4
    assert used == configs and chips4 <= max(1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in CELLS:
        got = {m["name"] for m in harness.cell_metrics(BENCH, w,
                                                       "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(BENCH, w, "per_layer")


def test_every_file_under_paths_is_named_from_name_characters():
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
