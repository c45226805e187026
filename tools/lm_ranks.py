#!/usr/bin/env python3
"""The LM's train step on a (data, model) mesh across real ranks, one card a
rank: ``qwen3-0.6b`` (or ``--arch``) at its published widths and depth.

    torchrun --standalone --nproc-per-node 4 tools/lm_ranks.py
    torchrun --standalone --nproc-per-node 4 tools/lm_ranks.py \\
        --arch deepseek-moe-16b --model-parallel 4 --remat full
    torchrun --standalone --nproc-per-node 2 tools/lm_ranks.py \\
        --device cpu --layers 2 --batch 4 --seq 32 --steps 2 --reduced

On the card every rank joins NCCL on its own GPU (``LOCAL_RANK``); with
``--device cpu`` the ranks join gloo.  The mesh is (2, 2) on four ranks,
(1, 2) on two and (1, 1) on one (``--model-parallel`` overrides the model
axis).  An MoE config's layers take the mesh's dispatch
(``distributed/moe_ep.py``: expert-parallel where the experts split over
``model``).  Each rank:

1. f32, the config cut to ``--check-layers`` layers: one AdamW step of the
   sharded step (``tensor_parallel.ShardedLM``) against the one-device step
   of the same seeded weights and batch on rank 0's device: the loss within
   1e-5 relative, every gathered gradient leaf within 1e-4 * max|want| +
   1e-5, the updated parameters within ``adamw_step_bound``.  An MoE
   config runs it at capacity factor E / k, where neither dispatch drops
   (the expert-parallel drops differ from one device's by design; the CPU
   tests hold them against the reference's own), and says so;
2. bf16 at full depth (or ``--layers``): ``--steps`` AdamW steps at B x S =
   ``--batch`` x ``--seq`` on ``batch_at`` data (the update in place, the
   state donated), the step's p50 (host clock, each step ending in a
   device sync and a barrier), tokens/s beside the FLOP bound of the
   active parameters, each rank's peak device memory, with MoE each step's
   ``drop_fraction`` at the config's capacity factor, and one profiled
   step's device time split into the collectives' (NCCL) kernels and the
   rest;
3. a checkpoint of the bf16 parameters saved sharded on this mesh, restored
   on another mesh of the same ranks through ``elastic.restore_on_mesh``
   ((1, 4) from (2, 2), (2, 1) from (1, 2); (1, 1) again on one rank) and
   saved again, and restored whole in rank 0's process and saved: the
   three manifests' digests equal;
4. one int8 compressed all-reduce over ``data`` against the exact mean:
   every element within half a quantum of the shared scale;
5. with ``--serve-check``: prefill (``ShardedLM.prefill``, the training
   layout) and decode (``distributed/serving.py::ServingLM``, the serving
   layout) of ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens and
   ``SERVE_DECODE`` new ones on this mesh, against the one-device
   ``lm.forward(mode="prefill")`` and ``lm.decode_step`` of the same
   seeded weights on this rank's device: f32 cut to ``--check-layers``
   layers within 1e-4 * max|want| + 1e-5, bf16 at full depth (or
   ``--layers``) within 2^-8 * sqrt(6 L) * max|want| + 1e-5 (``PERF.md``
   section 2's bf16 walk).

Rank 0 prints one line and writes the JSON to ``--out`` (default
``chiprun_out/lm_ranks.json``).  ``chip_smoke.py`` phase 17 runs the same
work in ranks it spawns (``spawned_rank``).  Exits non-zero if any rank
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ARCH = "qwen3-0.6b"
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
CHECK_CHUNK = 1 << 25          # elements a float64 check takes at once
# (layers, d_model, d_ff, vocab) of the published configs the tool runs, and
# an MoE config's (experts, top-k, expert width, shared, capacity factor)
# step 5's prompts, their tokens and the new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 64, 8
PUBLISHED = {"qwen3-0.6b": ((28, 1024, 3072, 151_936), None),
             "deepseek-moe-16b": ((28, 2048, 1408, 102_400),
                                  (64, 6, 1408, 2, 1.25))}


def mesh_shape(world: int, model_parallel=None) -> tuple:
    """(data, model): (2, 2) on four ranks, (1, 2) on two, (1, 1) on one."""
    m = model_parallel or min(world, 2)
    return world // m, m


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH, choices=sorted(PUBLISHED))
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo; default: one card a rank (NCCL)")
    ap.add_argument("--model-parallel", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--check-layers", type=int, default=2)
    ap.add_argument("--check-batch", type=int, default=4)
    ap.add_argument("--check-seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the bf16 run to this depth (default: all)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a host-sized run)")
    ap.add_argument("--remat", default=None,
                    help="the bf16 run's remat policy (default: the "
                         "config's)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--serve-check", action="store_true",
                    help="step 5: prefill and decode on the mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "lm_ranks.json"))
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gather_tree(tree, specs, mesh):
    from repro_torch.distributed.sharding import gather_leaf
    from repro_torch.tree import tree_leaves, tree_paths

    return {p: gather_leaf(x, specs[p], mesh)
            for p, x in zip(tree_paths(tree), tree_leaves(tree))}


def f32_check(args, cfg, mesh, device) -> dict:
    """Step 1: the sharded f32 step against the one-device step."""
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed.tensor_parallel import ShardedLM, shard_tree
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train.optimizers import adamw_step_bound, get_optimizer
    from repro_torch.tree import flatten_with_paths

    cut = dataclasses.replace(cfg, num_layers=args.check_layers,
                              param_dtype="float32", compute_dtype="float32")
    if cfg.moe is not None:
        cut = dataclasses.replace(cut, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    lr = 1e-2
    params = lm_params_to_reference(
        lm.init_params(cut, args.seed, device=device), cut)
    dc = DataConfig(cut.vocab_size, args.check_seq, args.check_batch,
                    seed=args.seed)
    batch = {"tokens": torch.from_numpy(batch_at(dc, 0)["tokens"])
             .to(device)}
    shard = ShardedLM(cut, mesh)
    blocks = shard_tree(params, shard.param_specs, mesh)
    m_s, g_s = loop.grad_and_metrics(blocks, shard.local_batch(batch), cut,
                                     shard=shard)
    # the steps update in place: a second copy of the f32 moments of
    # deepseek-moe-16b's two layers (12.8 GB) would not fit beside the
    # one-device step's on rank 0's card
    opt = get_optimizer("adamw", lr, layout=shard.layout, inplace=True)
    p1_s, _, sm = loop.make_train_step(cut, opt, shard=shard)(
        blocks, opt.init(blocks), batch)
    g_full = _gather_tree(g_s, shard.param_specs, mesh)
    p_full = _gather_tree(p1_s, shard.param_specs, mesh)
    del blocks, g_s, p1_s
    out = {"layers": args.check_layers, "batch": args.check_batch,
           "seq": args.check_seq}
    if dist.get_rank() == 0:
        m_1, g_1 = loop.grad_and_metrics(params, batch, cut)
        opt1 = get_optimizer("adamw", lr, inplace=True)
        p1_1, _, m1 = loop.make_train_step(cut, opt1)(
            params, opt1.init(params), batch)
        g_1, p1_1 = flatten_with_paths(g_1), flatten_with_paths(p1_1)
        loss_rel = abs(float(sm["loss"]) - float(m1["loss"])) \
            / abs(float(m1["loss"]))
        if not loss_rel <= 1e-5:
            raise AssertionError(f"sharded loss {float(sm['loss'])} vs "
                                 f"{float(m1['loss'])}")
        s_a = min(1.0, 1.0 / max(float(sm["grad_norm"]), 1e-9))
        s_b = min(1.0, 1.0 / max(float(m1["grad_norm"]), 1e-9))
        grad_worst, upd_worst = 0.0, 0.0
        for k, want in g_1.items():
            got = g_full[k]
            bound = 1e-4 * float(want.abs().max()) + 1e-5
            grad_worst = max(grad_worst,
                             float((got - want).abs().max()) / bound)
            # in float64 a slice at a time: a whole stacked expert leaf's
            # temporaries would not fit beside the two steps' state
            flat = [t.reshape(-1) for t in (got, want, p_full[k], p1_1[k])]
            for lo in range(0, flat[0].numel(), CHECK_CHUNK):
                ga, gb, pa, pb = (t[lo:lo + CHECK_CHUNK].double()
                                  for t in flat)
                b = adamw_step_bound(ga * s_a, gb * s_b, pa, pb, lr)
                upd_worst = max(upd_worst,
                                float(((pa - pb).abs() / b).max()))
        if not grad_worst <= 1.0:
            raise AssertionError(f"sharded gradients at {grad_worst:.3g} "
                                 f"of their bound")
        if not upd_worst <= 1.0:
            raise AssertionError(f"sharded updates at {upd_worst:.3g} of "
                                 f"their bound")
        if cut.moe is not None:
            drops = (float(sm["drop_fraction"]), float(m1["drop_fraction"]))
            if drops != (0.0, 0.0):
                raise AssertionError(f"the f32 check's capacity factor "
                                     f"{cut.moe.capacity_factor:.4g} still "
                                     f"drops: {drops}")
            out.update(capacity_factor=cut.moe.capacity_factor,
                       drop_fraction=drops[0],
                       note="MoE at capacity factor E / k: nothing drops "
                            "on either dispatch")
        out.update(loss=float(sm["loss"]), loss_one_device=float(m1["loss"]),
                   loss_rel_diff=loss_rel,
                   grad_norm=float(sm["grad_norm"]),
                   grad_norm_one_device=float(m1["grad_norm"]),
                   grad_worst_over_bound=grad_worst,
                   update_worst_over_bound=upd_worst, leaves=len(g_1))
        del m_1, g_1, p1_1
    del params, g_full, p_full
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def collective_split(prof) -> dict:
    """One profiled step's device records: their summed time, the union of
    their intervals (busy), and the summed time of the collectives' (NCCL)
    kernels and of the rest (the two may overlap: other streams)."""
    spans, total, comm = [], 0.0, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        total += dur
        if "nccl" in e.name.lower():
            comm += dur
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"device_ms": total / 1e3, "busy_ms": busy / 1e3,
            "collective_ms": comm / 1e3, "compute_ms": (total - comm) / 1e3,
            "records": len(spans)}


def bf16_run(args, cfg, mesh, device) -> tuple:
    """Step 2: the bf16 step at full depth -> (numbers, final blocks,
    their specs)."""
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed.tensor_parallel import ShardedLM, shard_tree
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train.optimizers import cosine_schedule, get_optimizer
    from repro_torch.tree import tree_leaves

    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    shard = ShardedLM(cfg, mesh)
    full = lm_params_to_reference(lm.init_params(cfg, args.seed,
                                                 device=device), cfg)
    n = sum(x.numel() for x in tree_leaves(full))
    active = n
    if cfg.moe is not None:       # the routed experts a token does not use
        moe = cfg.moe
        active -= (cfg.num_layers * 3 * (moe.num_experts - moe.top_k)
                   * cfg.d_model * moe.d_expert)
    blocks = shard_tree(full, shard.param_specs, mesh)
    del full
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    opt = get_optimizer("adamw", cosine_schedule(3e-4, 2, args.steps),
                        layout=shard.layout, inplace=True)
    state = opt.init(blocks)
    step = loop.make_train_step(cfg, opt, shard=shard)
    dc = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    times, losses, drops = [], [], []
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(batch_at(dc, i)["tokens"])
                 .to(device)}
        dist.barrier()
        t0 = time.perf_counter()
        blocks, state, m = step(blocks, state, batch)
        _sync(device)
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if "drop_fraction" in m:
            drops.append(float(m["drop_fraction"]))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    batch = {"tokens": torch.from_numpy(batch_at(dc, 0)["tokens"])
             .to(device)}
    dist.barrier()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(blocks, state, batch)
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    split = collective_split(prof)
    split["wall_ms"] = wall
    peaks = torch.tensor([float(peak)], device=device)
    every = [torch.zeros_like(peaks) for _ in range(dist.get_world_size())]
    dist.all_gather(every, peaks)
    steady = np.asarray(times[1:] or times)
    p50 = float(np.percentile(steady, 50))
    tokens = args.batch * args.seq
    attn = 3 * 2 * 2 * args.batch * cfg.num_heads * args.seq ** 2 \
        * cfg.resolved_head_dim * cfg.num_layers / 2
    flop = 6 * active * tokens + attn
    bound_ms = flop / (BF16_OPS_PER_S * dist.get_world_size()) * 1e3
    split["collective_share"] = split["collective_ms"] / max(
        split["device_ms"], 1e-9)
    del state
    return ({"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat,
             "batch": args.batch, "seq": args.seq,
             "steps": args.steps, "param_elements": n,
             "active_param_elements": active, "step_ms": times,
             "step_ms_p50": p50, "tokens_per_s": tokens / (p50 / 1e3),
             "flop_bound_ms_all_ranks": bound_ms,
             "bound_share": bound_ms / p50, "losses": losses,
             "drop_fractions": drops,
             "capacity_factor": cfg.moe and cfg.moe.capacity_factor,
             "peak_bytes_by_rank": [float(x) for x in every],
             "profiled_step": split}, blocks, shard.param_specs)


def checkpoint_cross(args, cfg, blocks, specs, mesh, device, tmp) -> dict:
    """Step 3: saved on this mesh, restored on another, saved again."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.distributed.elastic import restore_on_mesh
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm

    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    world = dist.get_world_size()
    first, second, whole = (os.path.join(tmp, d) for d in ("a", "b", "c"))
    pspecs = {"params/" + k: v for k, v in specs.items()}
    t0 = time.perf_counter()
    ckpt.save(first, 1, {"params": blocks}, {"step": 1}, shardings=pspecs,
              mesh=mesh)
    save_s = time.perf_counter() - t0
    like = {"params": lm_params_to_reference(lm.abstract_params(cfg), cfg)}
    data, model = mesh_shape(world, args.model_parallel)
    # another mesh of the same ranks: (1, 4) from (2, 2), (2, 1) from
    # (1, 2); one rank has only (1, 1)
    other = (1, world) if data > 1 else (world, 1)
    t0 = time.perf_counter()
    mesh2 = make_mesh_for(world, other[1], device_type=device.type)
    tree, extra = restore_on_mesh(first, 1, like, mesh2, device)
    ckpt.save(second, 1, tree, extra, shardings=param_shardings(like, mesh2),
              mesh=mesh2)
    cross_s = time.perf_counter() - t0
    del tree

    def digest(d):
        with open(os.path.join(d, "step_0000000001", "manifest.json")) as f:
            return json.load(f)["digest"]

    # each copy read and removed before the next is written: at
    # deepseek-moe-16b's full width a copy is 34 GB
    digests = [digest(first), digest(second)]
    dist.barrier()
    last = [None]
    if dist.get_rank() == 0:                 # and whole, in one process
        shutil.rmtree(second, ignore_errors=True)
        tree, extra = ckpt.restore(first, 1, like, device)
        ckpt.save(whole, 1, tree, extra)
        del tree
        last = [digest(whole)]
        shutil.rmtree(whole, ignore_errors=True)
    dist.broadcast_object_list(last, src=0)
    digests.append(last[0])
    if len(set(digests)) != 1:
        raise AssertionError(f"checkpoint digests differ across meshes: "
                             f"{digests}")
    return {"saved_on": [data, model], "restored_on": list(other),
            "also_restored_whole": True, "digest": digests[0],
            "save_s": save_s, "restore_and_save_s": cross_s}


def compressed_check(args, mesh, device) -> dict:
    """Step 4: one compressed all-reduce over ``data`` against the exact
    mean."""
    from repro_torch.distributed.compression import (
        compressed_all_reduce_mean)

    grp = mesh.get_group("data")
    n = dist.get_world_size(grp)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + dist.get_rank())
    x = torch.randn((1 << 20,), generator=gen, device=device)
    exact = x.clone()
    dist.all_reduce(exact, group=grp)
    exact /= n
    peak = x.abs().max()
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=grp)
    mean, err = compressed_all_reduce_mean(x, grp, torch.zeros_like(x))
    quantum = float(peak) / 127
    off = float((mean - exact).abs().max())
    bound = quantum / 2 + 1e-6 * float(exact.abs().max())
    if not off <= bound:
        raise AssertionError(f"compressed mean off by {off:.4g} > "
                             f"{bound:.4g}")
    return {"elements": x.numel(), "data_ranks": n, "max_abs_err": off,
            "bound": bound, "quantum": quantum,
            "residual_max": float(err.abs().max())}


def serve_check(args, cfg, mesh, device) -> dict:
    """Step 5: the mesh's prefill and decode against one device's."""
    from repro_torch.distributed.serving import ServingLM
    from repro_torch.distributed.sharding import param_shardings, shard_leaf
    from repro_torch.distributed.tensor_parallel import ShardedLM
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    b, s, t = SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE
    cache_len = s + t
    gen = torch.Generator(device="cpu").manual_seed(args.seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + t), generator=gen
                           ).to(device)
    out = {}
    for name, dtype, layers, rel in (
            ("f32", "float32", args.check_layers, 1e-4),
            ("bf16", "bfloat16", args.layers or cfg.num_layers, None)):
        c = dataclasses.replace(cfg, num_layers=layers, param_dtype=dtype,
                                compute_dtype=dtype)
        rel = rel if rel is not None else 2.0 ** -8 * (6 * layers) ** 0.5
        params = lm.init_params(c, args.seed, device=device)
        with torch.no_grad():
            logits, caches, _ = lm.forward(params, {"tokens": tokens[:, :s]},
                                           c, mode="prefill",
                                           cache_len=cache_len)
            want = [logits[:, -1:]]
            for i in range(t - 1):
                lg, caches = lm.decode_step(params, tokens[:, s + i:s + i + 1],
                                            caches, s + i, c)
                want.append(lg)
        del caches
        specs = param_shardings(params, mesh)
        blocks = tree_unflatten(params, [
            shard_leaf(x, specs[p], mesh)
            for x, p in zip(tree_leaves(params), tree_paths(params))])
        shard = ShardedLM(c, mesh)
        model = ServingLM(c, mesh, b, cache_len)
        sblocks = model.shard_params(params)
        del params
        _sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            last, cblocks = shard.prefill(blocks, {"tokens": tokens[:, :s]},
                                          cache_len=cache_len)
            del blocks
            got = [last]
            for i in range(t - 1):
                lg, cblocks = model.decode_step(
                    sblocks, model.own(tokens[:, s + i:s + i + 1], 0,
                                       model.rows), cblocks, s + i)
                got.append(lg)
        _sync(device)
        wall = time.perf_counter() - t0
        worst = 0.0
        for g, w in zip(got, want):
            bound = rel * float(w.abs().max()) + 1e-5
            worst = max(worst, float((g - w).abs().max()) / bound)
        if not worst <= 1.0:
            raise AssertionError(f"serve check {name}: the mesh's logits "
                                 f"off by {worst:.3g} of the bound")
        out[name] = {"layers": layers, "rel": rel, "worst_over_bound": worst,
                     "batch": b, "prompt": s, "decode": t, "wall_s": wall}
        del sblocks, cblocks
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def rank_work(args, device) -> dict:
    """Steps 1-4 on this rank of the default process group."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for

    world = dist.get_world_size()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    cfg = get_config(args.arch)
    widths, experts = PUBLISHED[args.arch]
    moe = cfg.moe and (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert,
                       cfg.moe.num_shared, cfg.moe.capacity_factor)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    elif ((cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size), moe) != \
            (widths, experts):
        raise AssertionError(f"{args.arch} is not the published config")
    data, model = mesh_shape(world, args.model_parallel)
    mesh = make_mesh_for(world, model, device_type=device.type)
    out = {"world": world, "mesh": [data, model],
           "backend": dist.get_backend()}
    t0 = time.perf_counter()
    out["f32_check"] = f32_check(args, cfg, mesh, device)
    out["f32_check"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["bf16"], blocks, specs = bf16_run(args, cfg, mesh, device)
    out["bf16"]["s"] = time.perf_counter() - t0
    # one directory for every rank: rank 0's
    tmp = [args.ckpt_dir or (tempfile.mkdtemp(prefix="lm_ranks_")
                             if dist.get_rank() == 0 else None)]
    dist.broadcast_object_list(tmp, src=0)
    try:
        out["checkpoint"] = checkpoint_cross(args, cfg, blocks, specs, mesh,
                                             device, tmp[0])
    finally:
        dist.barrier()
        if dist.get_rank() == 0 and not args.ckpt_dir:
            shutil.rmtree(tmp[0], ignore_errors=True)
    del blocks
    out["compressed"] = compressed_check(args, mesh, device)
    if args.serve_check:
        t0 = time.perf_counter()
        out["serve"] = serve_check(args, cfg, mesh, device)
        out["serve"]["s"] = time.perf_counter() - t0
    return out


def summary(out: dict) -> str:
    c, b, k, q = (out["f32_check"], out["bf16"], out["checkpoint"],
                  out["compressed"])
    split = b["profiled_step"]
    moe_check = (f" at capacity factor {c['capacity_factor']:.4g} (no drops)"
                 if "capacity_factor" in c else "")
    moe_run = (f", drop fraction {b['drop_fractions'][0]:.4f} -> "
               f"{b['drop_fractions'][-1]:.4f} at capacity factor "
               f"{b['capacity_factor']}" if b["drop_fractions"] else "")
    return (f"lm_ranks: {out['world']} ranks over {out['backend']}, mesh "
            f"(data, model) = {tuple(out['mesh'])}, {b['arch']}; f32 step "
            f"cut to {c['layers']} layers vs one device{moe_check}: loss rel "
            f"{c['loss_rel_diff']:.3g}, gradients "
            f"{c['grad_worst_over_bound']:.3g} of bound, updates "
            f"{c['update_worst_over_bound']:.3g} of bound; "
            f"bf16 {b['layers']} layers B={b['batch']} x S={b['seq']} (remat "
            f"{b['remat']}): step "
            f"p50 {b['step_ms_p50']:.1f} ms, {b['tokens_per_s']:,.0f} tok/s, "
            f"FLOP bound over the ranks {b['flop_bound_ms_all_ranks']:.2f} ms "
            f"(share {b['bound_share']:.3f}), peak by rank "
            f"{[round(p / 1e9, 2) for p in b['peak_bytes_by_rank']]} GB, a "
            f"profiled step ({split['wall_ms']:.1f} ms) busy "
            f"{split['busy_ms']:.1f} ms, kernels {split['compute_ms']:.1f} "
            f"ms and collectives {split['collective_ms']:.1f} ms (share "
            f"{split['collective_share']:.3f}); loss "
            f"{b['losses'][0]:.4f} -> {b['losses'][-1]:.4f}{moe_run}; "
            f"checkpoint "
            f"{tuple(k['saved_on'])} -> {tuple(k['restored_on'])} and whole: "
            f"digests equal; "
            f"int8 mean over {q['data_ranks']} data ranks off by "
            f"{q['max_abs_err']:.3g} (bound {q['bound']:.3g})"
            + ("" if "serve" not in out else
               "; prefill + decode on the mesh vs one device: " + ", ".join(
                   f"{k} {v['layers']} layers {v['worst_over_bound']:.3g} "
                   f"of bound" for k, v in out["serve"].items()
                   if isinstance(v, dict))))


def _device_for(args, local_rank: int):
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("lm_ranks: no card (use --device cpu for gloo)")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def spawned_rank(rank: int, world: int, store: str, argv: list,
                 out_path: str) -> None:
    """One rank of ``torch.multiprocessing.start_processes`` (as
    ``chip_smoke.py`` phase 17 spawns them): rank r on card r, NCCL (gloo
    with ``--device cpu``) through a ``FileStore``; rank 0 writes the JSON
    to ``out_path``."""
    args = parse_args(argv)
    device = _device_for(args, rank)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        store=dist.FileStore(store, world), rank=rank, world_size=world,
        **({"device_id": device} if device.type == "cuda" else {}))
    try:
        out = rank_work(args, device)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f, indent=1)
    finally:
        dist.destroy_process_group()


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
