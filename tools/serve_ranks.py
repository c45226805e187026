#!/usr/bin/env python3
"""Prefill and decode on four ranks under the serving layout, one card a
rank: ``qwen2-vl-72b`` whole at (data, model) = (1, 4), and the mesh held
against one card.

    torchrun --standalone --nproc-per-node 4 tools/serve_ranks.py
    torchrun --standalone --nproc-per-node 4 tools/serve_ranks.py \\
        --device cpu --reduced

On the card every rank joins NCCL on its own GPU (``LOCAL_RANK``); with
``--device cpu`` the ranks join gloo and the configs are the reduced ones.
The prefill runs under the training layout (``ShardedLM.prefill``), the
decode under ``SERVING_RULES`` (``distributed/serving.py::ServingLM``); at
(1, 4) the two layouts cut the same blocks, so one copy of the weights
serves both.  Steps:

1. f32, cut to 2 layers, against the one-device ``lm.forward(mode=
   "prefill")`` and ``lm.decode_step`` of the same seeded weights on each
   rank's device: ``chatglm3-6b`` at (1, 4) (2 KV heads: the cache splits
   its sequence over ``model``) and ``deepseek-moe-16b`` at (2, 2) (the
   expert-parallel dispatch, at capacity factor E / k so that neither
   dispatch drops), within 1e-4 * max|want| + 1e-5;
2. ``qwen2-vl-72b`` cut to ``CHECK_LAYERS`` of 80 layers in bf16 at
   (1, 4): each rank draws its blocks (``ServingLM.place``: the same draws
   as the whole model), rank 0 also holds the whole cut model and runs one
   card's prefill and decode; the mesh's logits within 2 * 2^-8 * sqrt(6 L)
   * max|z| + 1e-5 (each run's rounding walk, the two added);
3. ``qwen2-vl-72b`` at all 80 layers in bf16 at (1, 4): ``BATCH``
   prompts of its 256 patches and ``PROMPT`` text tokens prefilled, then
   ``DECODE`` steps: a step's p50 (host clock, each step ending in a
   device sync and a barrier) beside its bytes bound (this rank's weight
   and cache blocks read once at 3.35 TB/s), tokens/s, each rank's peak
   over the decode against the dry-run's reckoning of the same cell
   (``launch/dryrun.py::trace_cell`` on a fake group of four, run by rank 0
   in a subprocess), and the collectives one step records beside the NCCL
   kernels of a profiled step.

Rank 0 prints one line and writes the JSON to ``--out`` (default
``chiprun_out/serve_ranks.json``).  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
VLM = "qwen2-vl-72b"
PEAK_REL = 0.25                # a rank's decode peak against the reckoning
# step 3's prompts, their text tokens after the patches and the decode
# steps; step 2's layers; the weights' seed
BATCH, PROMPT, DECODE, CHECK_LAYERS, SEED = 8, 64, 32, 16, 0

DRYRUN = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
cfg = get_config({arch!r})
if {reduced!r}:
    cfg = cfg.reduced()
cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                          compute_dtype="bfloat16")
with dryrun.fake_world(4):
    mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
    out = dryrun.trace_cell({arch!r}, ShapeSpec("serve", "decode",
                            {cache_len}, {batch}), mesh, config=cfg)
print(json.dumps({{"memory": out["memory"], "flops": out["flops"],
                  "collectives": len(out["records"])}}))
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo; default: one card a rank (NCCL)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a host-sized run)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "serve_ranks.json"))
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(name, args, **kw):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if args.reduced:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, **kw)


def _inputs(cfg, b, s, t, device, seed):
    from repro_torch.models.attention import torch_dtype

    gen = torch.Generator(device="cpu").manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + t), generator=gen)
    batch = {"tokens": tokens[:, :s].to(device)}
    if cfg.frontend == "patch":
        batch["patches"] = torch.randn(
            b, cfg.frontend_tokens, cfg.frontend_dim, generator=gen).to(
            device, torch_dtype(cfg.compute_dtype))
    return batch, tokens[:, s:].to(device)


def _one_device(params, cfg, batch, steps, cache_len):
    """The one-device logits: the prefill's last position, then each
    decode step's."""
    from repro_torch.models import lm

    with torch.no_grad():
        logits, caches, _ = lm.forward(params, batch, cfg, mode="prefill",
                                       cache_len=cache_len)
        pos = logits.shape[1]
        out = [logits[:, -1:]]
        for i in range(steps.shape[1] - 1):
            lg, caches = lm.decode_step(params, steps[:, i:i + 1], caches,
                                        pos + i, cfg)
            out.append(lg)
    return out


def _blocks_alike(train_specs: dict, serve_specs: dict, sizes: dict) -> bool:
    """Whether two layouts cut the same block of every leaf on this mesh
    (their split axes equal once the size-1 axes are left out)."""
    from repro_torch.distributed.sharding import entry_axes

    def live(spec):
        return tuple(tuple(a for a in entry_axes(e) if sizes[a] > 1)
                     for e in spec)

    return all(live(train_specs[p]) == live(serve_specs[p])
               for p in serve_specs)


class _Mesh:
    """One config's prefill and decode on ``mesh``: the serving blocks
    (``ServingLM``) also feed the training-layout prefill."""

    def __init__(self, cfg, mesh, batch: int, cache_len: int):
        from repro_torch.distributed.serving import ServingLM
        from repro_torch.distributed.sharding import (axis_sizes,
                                                      param_shardings)
        from repro_torch.distributed.tensor_parallel import ShardedLM
        from repro_torch.models import lm

        self.model = ServingLM(cfg, mesh, batch, cache_len)
        self.shard = ShardedLM(cfg, mesh)
        self.cache_len = cache_len
        self.same = _blocks_alike(
            param_shardings(lm.abstract_params(cfg), mesh),
            self.model.specs, axis_sizes(mesh))

    def train_blocks(self, params, blocks):
        """The training layout's blocks: the serving ones where they cut
        the same, else cut from the whole ``params``."""
        if self.same:
            return blocks
        if params is None:
            raise ValueError("the training layout cuts other blocks on this "
                             "mesh: pass the whole parameters")
        from repro_torch.distributed.sharding import (param_shardings,
                                                      shard_leaf)
        from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

        specs = param_shardings(params, self.model.mesh)
        return tree_unflatten(params, [
            shard_leaf(x, specs[p], self.model.mesh)
            for x, p in zip(tree_leaves(params), tree_paths(params))])

    def run(self, tblocks, blocks, batch, steps, timer=None):
        """-> the logits list (whole on every rank); ``timer(i, fn)`` wraps
        each decode step."""
        model = self.model
        with torch.no_grad():
            last, caches = self.shard.prefill(tblocks, batch,
                                              cache_len=self.cache_len)
            pos = batch["tokens"].shape[1] + (
                batch["patches"].shape[1] if "patches" in batch else 0)
            out = [last]
            for i in range(steps.shape[1] - 1):
                def step(i=i, caches=caches):
                    return model.decode_step(
                        blocks, model.own(steps[:, i:i + 1], 0, model.rows),
                        caches, pos + i)[0]
                out.append(step() if timer is None else timer(i, step))
        self.caches = caches
        return out


def _worst(got, want, rel) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        bound = rel * float(w.abs().max()) + 1e-5
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / bound)
    return worst


def f32_checks(args, device) -> dict:
    """Step 1."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm

    out = {}
    for name, model_parallel in (("chatglm3-6b", 4), ("deepseek-moe-16b", 2)):
        cfg = _config(name, args, num_layers=2, param_dtype="float32",
                      compute_dtype="float32")
        note = {}
        if cfg.moe is not None:
            factor = cfg.moe.num_experts / cfg.moe.top_k
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=factor))
            note["capacity_factor"] = factor
        mesh = make_mesh_for(dist.get_world_size(), model_parallel,
                             device_type=device.type)
        b, s, t = 4, 60, 4
        batch, steps = _inputs(cfg, b, s, t, device, SEED)
        cache_len = s + t
        params = lm.init_params(cfg, SEED, device=device)
        want = _one_device(params, cfg, batch, steps, cache_len)
        m = _Mesh(cfg, mesh, b, cache_len)
        blocks = m.model.shard_params(params)
        got = m.run(m.train_blocks(params, blocks), blocks, batch, steps)
        kv = m.model.cache_specs["k"]
        worst = _worst(got, want, 1e-4)
        if not worst <= 1.0:
            raise AssertionError(f"{name}: the mesh's f32 logits off by "
                                 f"{worst:.3g} of the bound")
        out[name] = {"mesh": list(mesh.mesh.shape), "layers": 2,
                     "worst_over_bound": worst,
                     "kv_cache_spec": [None if e is None else str(e)
                                       for e in kv], **note}
        del params, blocks, m
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def vlm_check(args, device) -> dict:
    """Step 2."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm

    cfg = _config(VLM, args, num_layers=min(CHECK_LAYERS,
                                            _config(VLM, args).num_layers),
                  param_dtype="bfloat16", compute_dtype="bfloat16")
    mesh = make_mesh_for(dist.get_world_size(), 4, device_type=device.type)
    b, s, t = 2, PROMPT, 8
    batch, steps = _inputs(cfg, b, s, t, device, SEED)
    cache_len = s + t + cfg.frontend_tokens
    m = _Mesh(cfg, mesh, b, cache_len)
    want = None
    if dist.get_rank() == 0:
        params = lm.init_params(cfg, SEED, device=device)
        want = _one_device(params, cfg, batch, steps, cache_len)
        blocks = m.model.shard_params(params)
        del params
    else:
        blocks = lm.init_params(cfg, SEED, device=device,
                                place=m.model.place)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = m.run(m.train_blocks(None, blocks), blocks, batch, steps)
    rel = 2 * 2.0 ** -8 * (6 * cfg.num_layers) ** 0.5
    res = {"layers": cfg.num_layers, "rel": rel, "batch": b}
    if dist.get_rank() == 0:
        res["worst_over_bound"] = _worst(got, want, rel)
    flag = [res.get("worst_over_bound", 0.0)]
    dist.broadcast_object_list(flag, src=0)
    if not flag[0] <= 1.0:
        raise AssertionError(f"{VLM} at {cfg.num_layers} layers: the mesh's "
                             f"logits off by {flag[0]:.3g} of the bound")
    del blocks, m, got, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _nccl_kernels(prof) -> int:
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "nccl" in e.name.lower())


def vlm_serve(args, device, reckoning) -> dict:
    """Step 3."""
    from repro_torch.distributed.sharding import block_bytes
    from repro_torch.launch.dryrun import CollectiveRecorder
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm

    cfg = _config(VLM, args, param_dtype="bfloat16",
                  compute_dtype="bfloat16")
    mesh = make_mesh_for(dist.get_world_size(), 4, device_type=device.type)
    b, s, t = BATCH, PROMPT, DECODE
    cache_len = s + t + cfg.frontend_tokens
    m = _Mesh(cfg, mesh, b, cache_len)
    t0 = time.perf_counter()
    blocks = lm.init_params(cfg, SEED, device=device,
                            place=m.model.place)
    _sync(device)
    init_s = time.perf_counter() - t0
    batch, steps = _inputs(cfg, b, s, t, device, SEED)
    times = []
    peaks = {}

    def timer(i, step):
        if i == 0 and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        dist.barrier()
        t1 = time.perf_counter()
        lg = step()
        _sync(device)
        dist.barrier()
        times.append((time.perf_counter() - t1) * 1e3)
        return lg

    t0 = time.perf_counter()
    got = m.run(m.train_blocks(None, blocks), blocks, batch, steps, timer)
    wall = time.perf_counter() - t0
    if device.type == "cuda":
        peaks["decode_peak"] = torch.cuda.max_memory_allocated(device)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{VLM}: non-finite logits")
    # one more step, its collectives recorded, and one profiled
    model, caches = m.model, m.caches
    pos = cache_len - 1
    tok = model.own(steps[:, -1:], 0, model.rows)
    with torch.no_grad(), CollectiveRecorder() as rec:
        model.decode_step(blocks, tok, caches, pos)
    _sync(device)
    nccl = None
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]
                                      ) as prof:
            model.decode_step(blocks, tok, caches, pos)
            _sync(device)
        nccl = _nccl_kernels(prof)
    w_bytes = block_bytes(model.abstract, model.specs, model.sizes)
    c_bytes = block_bytes(model.caches_abs, model.cache_specs, model.sizes)
    steady = np.asarray(times[1:] or times)
    p50 = float(np.percentile(steady, 50))
    bound_ms = (w_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3
    res = {"layers": cfg.num_layers, "batch": b, "prompt_text": s,
           "patches": cfg.frontend_tokens, "decode": t,
           "cache_len": cache_len, "init_s": init_s, "wall_s": wall,
           "step_ms": times, "step_ms_p50": p50,
           "tokens_per_s": b / (p50 / 1e3), "weight_block_bytes": w_bytes,
           "cache_block_bytes": c_bytes, "bytes_bound_ms": bound_ms,
           "bound_share": bound_ms / p50,
           "collectives_recorded": len(rec.records),
           "collectives_by_op": _by_op(rec.records),
           "nccl_kernels_profiled": nccl}
    peak = [peaks.get("decode_peak", 0)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, peak[0])
    res["decode_peak_bytes_by_rank"] = every
    if reckoning is not None:
        reck = reckoning["memory"]["peak_bytes"]
        res["reckoned_peak_bytes"] = reck
        res["reckoned_collectives"] = reckoning["collectives"]
        if device.type == "cuda":
            res["peak_over_reckoned"] = [p / reck for p in every]
            if not all(abs(p / reck - 1) <= PEAK_REL for p in every):
                raise AssertionError(
                    f"{VLM}: decode peaks {every} not within "
                    f"{PEAK_REL:.0%} of the reckoned {reck}")
    return res


def _by_op(records) -> dict:
    out: dict = {}
    for r in records:
        out[r["op"]] = out.get(r["op"], 0) + 1
    return out


def _start_reckoning(args):
    cfg = _config(VLM, args)
    code = DRYRUN.format(arch=VLM, reduced=args.reduced,
                         cache_len=PROMPT + DECODE
                         + cfg.frontend_tokens, batch=BATCH)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "LOCAL_WORLD_SIZE", "GROUP_RANK",
              "TORCHELASTIC_RUN_ID"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def rank_work(args, device) -> dict:
    if dist.get_world_size() != 4:
        raise SystemExit("serve_ranks: run four ranks (torchrun "
                         "--nproc-per-node 4)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    proc = _start_reckoning(args) if dist.get_rank() == 0 else None
    reckoning = None
    try:
        out = {"world": 4, "backend": dist.get_backend()}
        t0 = time.perf_counter()
        out["f32"] = f32_checks(args, device)
        out["f32"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["vlm_check"] = vlm_check(args, device)
        out["vlm_check"]["s"] = time.perf_counter() - t0
        if proc is not None:
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"the dry-run failed:\n{stderr[-3000:]}")
            reckoning = json.loads(stdout.strip().splitlines()[-1])
        box = [reckoning]
        dist.broadcast_object_list(box, src=0)
        t0 = time.perf_counter()
        out["vlm_serve"] = vlm_serve(args, device, box[0])
        out["vlm_serve"]["s"] = time.perf_counter() - t0
        out["reckoning"] = box[0]
        return out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def summary(out: dict) -> str:
    f, c, v = out["f32"], out["vlm_check"], out["vlm_serve"]
    checks = ", ".join(f"{k} at {tuple(r['mesh'])} {r['worst_over_bound']:.3g}"
                       for k, r in f.items() if isinstance(r, dict))
    peaks = [round(p / 1e9, 2) for p in v["decode_peak_bytes_by_rank"]]
    return (f"serve_ranks: 4 ranks over {out['backend']}; f32 2 layers vs "
            f"one device (of bound): {checks}; {VLM} {c['layers']} layers "
            f"bf16 at (1, 4) vs one card {c.get('worst_over_bound', 0):.3g} "
            f"of bound; {v['layers']} layers B={v['batch']} x "
            f"({v['patches']} patches + {v['prompt_text']}) then "
            f"{v['decode']} steps: step p50 {v['step_ms_p50']:.2f} ms (bytes "
            f"bound {v['bytes_bound_ms']:.2f} ms, share "
            f"{v['bound_share']:.3f}), {v['tokens_per_s']:,.0f} tok/s, decode "
            f"peak by rank {peaks} GB vs reckoned "
            f"{v.get('reckoned_peak_bytes', 0) / 1e9:.2f} GB; a step's "
            f"collectives {v['collectives_recorded']} recorded, "
            f"{v.get('reckoned_collectives')} reckoned, NCCL kernels "
            f"{v['nccl_kernels_profiled']} profiled")


def _device_for(args, local_rank: int):
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("serve_ranks: no card (use --device cpu for gloo)")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def main(argv=None) -> int:
    args = parse_args(argv)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = _device_for(args, local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            **({"device_id": device}
                               if device.type == "cuda" else {}))
    try:
        out = rank_work(args, device)
        if dist.get_rank() == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
            print(summary(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
