"""Nothing the benchmark loads is JAX, a JAX library or the JAX package:
each module's top-level name (before the first dot) compared whole, so
the port (``repro_torch``) passes and ``repro`` does not."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

# Every cell once, tiny and on the CPU, in a fresh process; then what it
# loaded.  (The run's own process makes the same check once its window has
# closed; this one also covers the control and every reader.)
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import control, harness
bench = harness.load_benchmark()
small = {{"num_nodes": 400, "num_edges": 3000}}
for w in (c["name"] for c in bench["workloads"]):
    found = harness.find_cell(bench, w)
    found["config"].update(small)
    found["traffic"].update(query_set=64, warmup_flushes=1,
                            warmup_groups=1)
    harness.run_cell(found, w, 5, 0.2, True, "cpu", harness.Clock())
    control.read(w, 6, 0.2, "cpu", found)
print(json.dumps(harness.forbidden_modules()))
"""


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["repro_torch.core", "reproduce", "jaxtyping", "numpy",
            "repro.core.gee", "jax", "jaxlib.xla", "flax.linen"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax",
                                               "jaxlib.xla", "repro.core.gee"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, \
                    f"{path}: imports {name}"


def test_a_run_of_every_cell_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
