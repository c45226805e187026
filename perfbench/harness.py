"""Cell discovery and one run of a cell.

Everything a cell needs is found by name from its ``workloads`` entry of
``BENCHMARK.json``: the configuration file named by its ``configs`` entry,
the traffic mix ``perfbench/traffic/<traffic>.json`` (whose ``kind`` names
the generator module ``perfbench/loops/<kind>.py``), the limits of its
check ``perfbench/checks/<workload>.json``, and one reader
``perfbench/metrics/<metric>.py`` for each per-layer metric the cell
reports.  The configuration's ``generator`` names its graph model,
``perfbench/graphs/<generator>.py``, and the card's name its peaks,
``perfbench/peaks/<kind>.json``.  A later cell, mix, metric, graph model
or card is new files and entries only.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Clock:
    """Set-up's clock: seconds since the process started, by phase."""

    def __init__(self, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self._last = self.t0
        self.phases: dict = {}

    def phase(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - self._last
        self._last = now

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Resolve a workload name to everything its run needs; raises
    ``KeyError`` or ``FileNotFoundError`` for what is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    cell = cells[workload]
    here = root / "perfbench"
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "checks" / f"{workload}.json") as f:
        limits = json.load(f)["limits"]
    loop = importlib.import_module(f"perfbench.loops.{traffic['kind']}")
    readers = {}
    for m in cell_metrics(bench, workload, "per_layer"):
        readers[m["name"]] = _load_module(
            here / "metrics" / f"{m['name']}.py",
            "perfbench_metric_" + m["name"].replace(".", "_").replace(
                "-", "_")).read
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "loop": loop, "readers": readers,
            "end_to_end": cell_metrics(bench, workload, "end_to_end"),
            "per_layer": cell_metrics(bench, workload, "per_layer")}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, its libraries' or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def drive(loop, seconds: float) -> None:
    """Units until ``seconds`` have passed."""
    t0 = time.perf_counter()
    while True:
        loop.unit()
        if time.perf_counter() - t0 >= seconds:
            break


def _profiled_slice(torch, loop, units: int):
    """Two slices of ``units`` units each, the program's tracer off.  The
    first is traced for the card's activity alone, which costs the host
    little: its device-busy time over its length (the host clock, between
    two syncs) gives ``busy_s`` and ``window_s``.  The second records the
    host's ops too, for the ``breakdown`` (the device ops by time and the
    idle gaps by what the host was doing; the host runs slower there).
    ``None`` where the trace holds no device record."""
    from perfbench.timing import WINDOW_MARK, breakdown, device_busy

    cuda = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=cuda) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            loop.unit()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    busy_us, records = device_busy(torch, prof)
    if not records:
        return None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU] + cuda) as prof:
        with torch.profiler.record_function(WINDOW_MARK):
            for _ in range(units):
                loop.unit()
            torch.cuda.synchronize()
    detail = breakdown(torch, prof) or {}
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "units": units,
            "device_ops": detail.get("device_ops", []),
            "idle_gaps": detail.get("idle_gaps", [])}


def _traced_part(loop, seconds: float) -> tuple:
    """The rest of the window with the program's span tracer on."""
    from repro_torch.obs import trace as obs_trace

    tracer = obs_trace.Tracer(enabled=True, annotate_device=False)
    previous = obs_trace.set_tracer(tracer)
    try:
        drive(loop, seconds)
        loop.finish()
    finally:
        obs_trace.set_tracer(previous)
    return tracer.events()


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def run_cell(found: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, clock: Clock) -> tuple:
    """One run of a cell on ``device`` (the card; ``"cpu"`` only in the
    tests, which skip the look for a chip).  Returns ``(result,
    check_lines, diagnostics)``: the result line's object, the numbers
    compared beside their limits for the last lines of standard error, and
    set-up's phases and the check's seconds."""
    import torch

    cfg, traffic = found["config"], found["traffic"]
    loop = found["loop"].Loop(cfg, traffic, seed, device, clock)
    if device != "cpu":
        torch.cuda.synchronize()
    # Set-up's heap (torch's modules, the graph's host copies) moves to the
    # collector's permanent generation, so a full collection in the window
    # walks what the window made, not everything the process imported.
    gc.collect()
    gc.freeze()
    setup_s = clock.since_start()
    ctx: dict = {"profile": None, "spans": (), "host": {}}
    t_window = time.perf_counter()
    if not trace:
        drive(loop, seconds)
        loop.finish()
        if device != "cpu":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_window
    else:
        drive(loop, seconds / 2)
        ctx["host"] = {k: list(v) for k, v in loop.host_samples.items()}
        if device != "cpu":
            ctx["profile"] = _profiled_slice(
                torch, loop, int(traffic["profile_units"]))
        ctx["spans"] = _traced_part(loop, seconds / 2)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    attempted, failed = loop.attempted()
    metrics = {}
    if not trace:
        values = loop.end_to_end(elapsed)
        values["setup_s"] = setup_s
        values["peak_device_gib"] = peak / 2**30
        for m in found["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    loop.free()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = loop.check()
    check_s = time.perf_counter() - t_check
    if trace:
        ctx.update(loop.reader_context())
        for m in found["per_layer"]:
            value = found["readers"][m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = found["limits"]
    compared = {}
    for name, value in checks.items():
        if name not in limits:
            raise KeyError(f"the check's {name!r} has no limit in "
                           f"perfbench/checks/{workload}.json")
        compared[name] = {"value": _finite(float(value)),
                          "limit": limits[name]}
    correct = failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name() if device != "cpu"
           else "cpu",
           "count": int(found["cell"]["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    prof = ctx["profile"]
    if trace and prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = compared
    lines = [f"check {n} {c['value']!r} limit {c['limit']!r}"
             for n, c in compared.items()]
    diag = {"setup_phases_s": clock.phases, "check_s": check_s,
            "units": getattr(loop, "units", "units")}
    return result, lines, diag


__all__ = ["Clock", "ROOT", "FORBIDDEN", "load_benchmark", "find_cell",
           "cell_metrics", "drive", "forbidden_modules", "run_cell"]
