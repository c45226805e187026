"""Read a cell's check on the program and on its control, at the cell's
own size, on the card, for the limits of ``perfbench/checks/``.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2

For each seed: the cell's set-up, a short window at the cell's own load
(long enough for the check's sample), then the numbers the check compares
twice: on what the program served, and on the control, the reference
computed in bfloat16 (the step below the float32 the configuration
states) and put in the program's place.  One JSON line a seed.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def read(workload: str, seed: int, seconds: float, device: str,
         found: dict | None = None) -> dict:
    """The program's and the control's numbers for one seed."""
    from perfbench import harness

    if found is None:
        found = harness.find_cell(harness.load_benchmark(ROOT), workload,
                                  ROOT)
    loop = found["loop"].Loop(found["config"], found["traffic"], seed,
                              device, harness.Clock())
    harness.drive(loop, seconds)
    loop.finish()
    loop.free()
    return {"workload": workload, "seed": seed,
            "program": loop.check(),
            "control_bfloat16": loop.check(dtype="bfloat16")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read(args.workload, seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
