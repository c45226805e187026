"""Training launcher (port of ``repro/launch/train.py``): seeded weights,
``batch_at`` data, the train step, periodic checkpoints and resume.

Runs on the card unless ``--device cpu`` is given.  One card only:
``--devices`` or ``--model-parallel`` above 1 is refused (the sharded LM
is ROADMAP.md section 1, item 8f), so the reference's mesh, parameter
shardings and activation constrainer are the identity here.

Fault tolerance:
  * ``CheckpointManager``: asynchronous periodic saves, resume from the
    newest.  A checkpoint is labelled by the number of updates it holds:
    the save after the update that consumed ``batch_at(step)`` is
    ``step + 1``, so a run killed after any save and resumed consumes each
    batch once and ends equal to an uninterrupted run.  (The reference
    labels its in-loop saves ``step``, one early; ROADMAP.md R5.)
  * The data is a pure function of (seed, step).
  * On the card, deterministic algorithms (and cuBLAS's fixed workspace)
    are asked for, so a resumed run repeats the uninterrupted one's bits.
  * ``StragglerMonitor`` flags slow steps; a step ends after a
    synchronize, so its time is the device's too.

The parameters and the optimizer's state are kept in the reference's
layout (layers stacked, ``repro_torch.train.loop``), so a checkpoint,
``{"params": ..., "opt": ...}``, is that state as it is, and either
package resumes the other's directory.  ``main(argv, cfg=...)`` trains a
``ModelConfig`` built in code instead of the one ``--arch`` names.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/run1 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager, StragglerMonitor
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_reference
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import lm
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizers import cosine_schedule, get_optimizer


def build(args, cfg=None):
    if (args.devices or 1) > 1 or args.model_parallel > 1:
        raise SystemExit("--devices and --model-parallel above 1 need the "
                         "sharded LM (ROADMAP.md section 1, item 8f); this "
                         "launcher trains on one device")
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    opt = get_optimizer(args.optimizer,
                        cosine_schedule(args.lr, args.warmup, args.steps))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = lm_params_to_reference(
        lm.init_params(cfg, device=device, generator=gen), cfg)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    return cfg, device, params, opt_state, step_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    return ap.parse_args(argv)


def main(argv=None, cfg=None):
    """``cfg``: a ``ModelConfig`` to train instead of the one ``--arch``
    and ``--reduced`` name (``--arch`` is still required, as a label)."""
    args = parse_args(argv)
    on_card = resolve_device(args.device).type == "cuda"
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    if on_card:
        # before cuBLAS starts: a fixed workspace makes its sums repeatable
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _train(args, cfg)
    finally:
        if on_card:
            torch.use_deterministic_algorithms(was_deterministic)


def _train(args, cfg=None):
    cfg, device, params, opt_state, step_fn = build(args, cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
        if mgr.latest_step() is not None:
            start_step, tree, _ = mgr.restore_latest(
                {"params": params, "opt": opt_state}, device)
            params, opt_state = tree["params"], tree["opt"]
            print(f"resumed from step {start_step}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mon = StragglerMonitor()
    history = []
    saved = None
    for step in range(start_step, args.steps):
        tokens = torch.from_numpy(batch_at(dc, step)["tokens"]).to(device)
        mon.start_step(step)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             {"tokens": tokens})
        sync()
        dt = mon.end_step()
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=step, seconds=round(dt, 3))
            history.append(m)
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m.get('grad_norm', 0):.2f}  {dt:.2f}s",
                  flush=True)
        if mgr:
            updates = step + 1               # what the state now holds
            if updates % args.ckpt_interval == 0:
                mgr.save_async(updates, {"params": params, "opt": opt_state},
                               {"step": updates})
                saved = updates
    if mgr:
        if saved != args.steps:
            mgr.save_async(args.steps, {"params": params, "opt": opt_state},
                           {"step": args.steps})
        mgr.wait()
        mgr.close()
    if mon.events:
        print(f"straggler events: {mon.events}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
