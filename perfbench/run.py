"""Run one cell of ``BENCHMARK.json`` once on the card and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, where
the card is missing or holds fewer devices than the cell asks for, where
the checkout lacks the program (``src/repro_torch``), or where JAX or the
JAX package was loaded in this process by the time the window closed.
The numbers compared by the check come last on standard error, each beside
its limit, and last in the result line under ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return 1


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel library already builds into ``build/``)."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import harness

    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return _fail("the program (src/repro_torch) is not in this checkout")
    _cache_dirs()
    try:
        bench = harness.load_benchmark(ROOT)
        found = harness.find_cell(bench, args.workload, ROOT)
    except (OSError, KeyError, ValueError, ImportError) as e:
        return _fail(f"cannot resolve the cell: {e!r}")
    clock = harness.Clock(T_START)
    import torch

    chips = int(found["cell"]["chips"])
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} present")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    clock.phase("import")
    result, lines, diag = harness.run_cell(
        found, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", clock)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"modules of JAX or of the JAX package were loaded: "
                     f"{bad}")
    diag["power_limit"] = _power_limit()
    print("perfbench: " + json.dumps(diag), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
