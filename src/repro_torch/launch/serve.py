"""Serving driver: the continuous-batching decode server (port of
``repro/launch/serve.py``).

Random weights from ``--seed``, prompts of 4-11 random tokens, token-by-token
prefill and batched decode through ``BatchedServer``, slot churn as
requests finish at different lengths, and throughput accounting.  Runs on
the card unless ``--device cpu`` is given.  ``--reduced`` (the default, as
in the reference) serves the small same-family config; ``--no-reduced``
serves the published one.  ``--arch`` takes every config with a decode
step: dense, MoE, SSM, hybrid and the vision-language ``qwen2-vl-72b``
(over token prompts, its M-RoPE text ``t`` continuing after the patch grid
as in the reference); the encoder-only ``hubert-xlarge`` exits, as in the
reference.  A period-scanned hybrid (the published ``recurrentgemma-2b``)
is refused by ``BatchedServer`` as in the reference;
``serve.decode.generate`` serves it.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --no-reduced --requests 32 --slots 8 --max-len 512 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve.batching import BatchedServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (default); "
                         "--no-reduced serves the published one")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    rng = np.random.default_rng(args.seed)
    params = lm.init_params(cfg, args.seed, device=device)

    server = BatchedServer(params, cfg, batch_slots=args.slots,
                           max_len=args.max_len,
                           temperature=args.temperature, seed=args.seed,
                           device=device)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 12)).astype(np.int32)
        server.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=int(rng.integers(
                                  4, args.max_new + 1))))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = server.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    occ = server.stats["batch_occupancy"]
    occ = float(np.mean(list(occ))) if len(occ) else 0.0
    print(f"served {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s), mean batch occupancy {occ:.2f}")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} toks -> "
              f"{len(r.output)} new toks {r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
