"""Training launcher (port of ``repro/launch/train.py``): seeded weights,
``batch_at`` data (``encoder_batch_at`` frames for the frame frontend,
zero patches for the patch frontend), the train step, periodic
checkpoints and resume.

Runs on the card unless ``--device cpu`` is given.  On one device the
state is whole.  With ``--devices P`` (or ``torchrun``'s world size) and
``--model-parallel M`` it runs one process a rank on a (P / M, M) mesh of
(data, model) axes (``launch/mesh.py``): start it under ``torchrun
--nproc-per-node P``; the ranks join NCCL on the card (rank r on card
``LOCAL_RANK``) or gloo with ``--device cpu``.  Every rank then holds its
blocks of the parameters and the optimizer state under
``sharding.param_shardings`` and runs ``tensor_parallel.ShardedLM``'s
step on the global batch's rows of its data rank; only rank 0 prints.

Fault tolerance:
  * ``CheckpointManager``: asynchronous periodic saves, resume from the
    newest.  A checkpoint is labelled by the number of updates it holds:
    the save after the update that consumed ``batch_at(step)`` is
    ``step + 1``, so a run killed after any save and resumed consumes each
    batch once and ends equal to an uninterrupted run.  (The reference
    labels its in-loop saves ``step``, one early; ROADMAP.md R5.)
  * Elastic: a sharded save gathers each leaf and rank 0 writes it, so a
    checkpoint is the same bytes at any mesh; a restart at another
    ``--devices`` / ``--model-parallel`` re-shards the newest one onto the
    new mesh (``elastic.restore_on_mesh``).
  * The data is a pure function of (seed, step).
  * On the card, deterministic algorithms (and cuBLAS's fixed workspace)
    are asked for, so a resumed run repeats the uninterrupted one's bits.
  * ``StragglerMonitor`` flags slow steps; a step ends after a
    synchronize, so its time is the device's too.

Each step is given the state the loop holds and the loop keeps what it
returns: AdamW updates that state in place (``adamw(inplace=True)``), and
a checkpoint copies it to the host before the next step.  On the card
the logged metrics carry this rank's peak of allocated bytes since the
first step began (``peak_bytes``).

The parameters and the optimizer's state are kept in the reference's
layout (layers stacked, ``repro_torch.train.loop``), so a checkpoint,
``{"params": ..., "opt": ...}``, is that state as it is, and either
package resumes the other's directory.  ``main(argv, cfg=...)`` trains a
``ModelConfig`` built in code instead of the one ``--arch`` names.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/run1 \\
      --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-0.6b --devices 4 \\
      --model-parallel 2 --steps 20 --batch 8 --seq 512
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager, StragglerMonitor
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_reference
from repro_torch.data.pipeline import DataConfig, batch_at, encoder_batch_at
from repro_torch.distributed.elastic import restore_on_mesh
from repro_torch.distributed.sharding import param_shardings
from repro_torch.distributed.tensor_parallel import ShardedLM, shard_tree
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import lm
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizers import cosine_schedule, get_optimizer


@dataclasses.dataclass
class Run:
    """What ``build`` sets up: the config, this rank's device, the state
    (whole, or this rank's blocks on ``mesh``), the step, and with a mesh
    the full state's shapes (``meta``) and specs for checkpoints."""
    cfg: object
    device: torch.device
    params: dict
    opt_state: dict
    step_fn: object
    mesh: object = None
    abstract_state: object = None
    state_specs: object = None
    owns_group: bool = False


def _join_mesh(args, device):
    """-> (this rank's device, the mesh or None, whether this call joined
    the process group)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    devices = args.devices or world
    if devices == 1 and args.model_parallel == 1:
        return device, None, False
    joined = False
    if not dist.is_initialized():
        need = max(devices, args.model_parallel)
        if world != need or need % args.model_parallel:
            raise SystemExit(f"--devices {devices} --model-parallel "
                             f"{args.model_parallel} needs {need} ranks, one "
                             f"a device (have {world}): run under torchrun "
                             f"--nproc-per-node {need}")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
            torch.cuda.set_device(device)
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
        joined = True
    elif device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh_for(devices, args.model_parallel,
                         device_type=device.type)
    return device, mesh, joined


def build(args, cfg=None) -> Run:
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    device, mesh, joined = _join_mesh(args, device)
    shard = ShardedLM(cfg, mesh) if mesh is not None else None
    # the loop gives each step the state it holds and keeps only what the
    # step returns, so AdamW writes its update into that state: one copy
    # of the f32 moments, not two
    donate = {"inplace": True} if args.optimizer == "adamw" else {}
    opt = get_optimizer(args.optimizer,
                        cosine_schedule(args.lr, args.warmup, args.steps),
                        layout=shard and shard.layout, **donate)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = lm_params_to_reference(
        lm.init_params(cfg, device=device, generator=gen), cfg)
    run = Run(cfg, device, params, None, None, mesh, owns_group=joined)
    if mesh is not None:
        abstract = lm_params_to_reference(lm.abstract_params(cfg), cfg)
        run.abstract_state = {"params": abstract, "opt": opt.init(abstract)}
        run.state_specs = param_shardings(run.abstract_state, mesh)
        run.params = shard_tree(params, shard.param_specs, mesh)
        del params
    run.opt_state = opt.init(run.params)
    run.step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                                  shard=shard)
    return run


def batch_for(cfg, dc: DataConfig, step: int) -> dict:
    """Step ``step``'s global batch as numpy, as the reference builds it:
    ``encoder_batch_at``'s frames and labels for the frame frontend,
    ``batch_at``'s tokens otherwise, with zero patches for the patch
    frontend."""
    if cfg.frontend == "frame":
        return encoder_batch_at(dc, step, cfg.frontend_dim)
    batch = batch_at(dc, step)
    if cfg.frontend == "patch":
        batch["patches"] = np.zeros(
            (dc.global_batch, cfg.frontend_tokens, cfg.frontend_dim),
            np.float32)
    return batch


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
    run = build(args, cfg)
    try:
        return _loop(args, run)
    finally:
        if run.owns_group:
            dist.destroy_process_group()


def _loop(args, run: Run):
    cfg, device = run.cfg, run.device
    params, opt_state = run.params, run.opt_state
    rank0 = run.mesh is None or dist.get_rank() == 0
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)
    sharded = {} if run.mesh is None else {"shardings": run.state_specs,
                                           "mesh": run.mesh}

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
        latest = mgr.latest_step()
        if latest is not None:
            if run.mesh is None:
                _, tree, _ = mgr.restore_latest(
                    {"params": params, "opt": opt_state}, device)
            else:
                tree, _ = restore_on_mesh(args.ckpt_dir, latest,
                                          run.abstract_state, run.mesh,
                                          device)
            params, opt_state = tree["params"], tree["opt"]
            start_step = latest
            if rank0:
                print(f"resumed from step {start_step}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mon = StragglerMonitor()
    history = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)   # the steps' own peak
    saved = None
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_for(cfg, dc, step).items()}
        mon.start_step(step)
        params, opt_state, metrics = run.step_fn(params, opt_state, batch)
        sync()
        dt = mon.end_step()
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=step, seconds=round(dt, 3))
            if device.type == "cuda":
                m["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            history.append(m)
            if rank0:
                moe = (f"  drop {m['drop_fraction']:.4f}  "
                       f"lb {m['load_balance']:.4f}"
                       if "drop_fraction" in m else "")
                print(f"step {step:5d}  loss {m['loss']:.4f}  "
                      f"gnorm {m.get('grad_norm', 0):.2f}{moe}  {dt:.2f}s",
                      flush=True)
        if mgr:
            updates = step + 1               # what the state now holds
            if updates % args.ckpt_interval == 0:
                mgr.save_async(updates, {"params": params, "opt": opt_state},
                               {"step": updates}, **sharded)
                saved = updates
    if mgr:
        if saved != args.steps:
            mgr.save_async(args.steps, {"params": params, "opt": opt_state},
                           {"step": args.steps}, **sharded)
        mgr.wait()
        mgr.close()
        if run.mesh is not None:
            dist.barrier()                   # rank 0's writes are done
    if mon.events and rank0:
        print(f"straggler events: {mon.events}")
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
