"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on one rank of
a fake process group (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step with ``jax.jit`` over
512 fake XLA devices and reads XLA's memory and cost analyses and the
collectives of the optimized HLO.  Torch has no such pipeline; the port's
counterpart runs the step itself, eagerly, as one rank of the production
mesh would, with nothing allocated:

  1. a fake process group (``torch.testing._internal.distributed.fake_pg``
     ``FakeStore``, backend ``"fake"``) of 256 or 512 ranks, this process
     one of them, and a ``DeviceMesh`` of ``launch/mesh.py``'s production
     shape over it (a fake group cannot share a process with a real one:
     run the tracer in a process of its own);
  2. under ``FakeTensorMode`` this rank's blocks of the parameters,
     optimizer state, batch and caches (``sharding.param_shardings`` /
     ``cache_shardings`` / ``batch_shardings``; ``SERVING_RULES`` for the
     weights of a decode cell) as fake tensors on the card's device type
     (``cuda`` where torch is built with CUDA; a CPU-only build cannot run
     autograd on fake ``cuda`` tensors, and there they are fake ``cpu``
     ones);
  3. the step: the train step of ``train/loop.py`` on ``ShardedLM``; the
     prefill under the training rules (``ShardedLM.prefill``); the decode
     step under the serving layout (``distributed/serving.py``);
  4. while it runs: a ``TorchDispatchMode`` records every ``c10d``
     collective (op, payload bytes, group size), ``FlopCounterMode``
     counts the FLOPs and ``MemTracker`` the peak bytes.

The records are priced with the reference's ring wire-byte model
(``census``).  The reference's depth-differencing pass
(``repro/launch/dryrun.py::analysis_pass``) exists because XLA's cost
analysis counts a loop body once; an eager trace runs every layer, so
``corrected`` is the raw count under ``method`` "eager trace (every layer
counted)" and no differencing is done.  Every figure here is a reckoning
of one rank's work, not a time.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both

The default ``--out`` is ``chiprun_out/dryrun.json`` (git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the c10d ops torch.distributed dispatches -> the reference's HLO op names
C10D_OPS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}

DEFAULT_OUT = os.path.join("chiprun_out", "dryrun.json")


# ---------------------------------------------------------------------------
# the census: the reference's ring wire-byte model over recorded collectives
# ---------------------------------------------------------------------------

def wire_bytes(op: str, payload: float, group_size: int) -> float:
    """Per-device wire bytes of one collective under ring algorithms
    (``collective_census``'s model; ``payload`` is the result's bytes):

      all-gather          result * (P-1)/P
      reduce-scatter      result * (P-1)   (result is the scattered piece)
      all-reduce          result * 2(P-1)/P
      all-to-all          result * (P-1)/P
      collective-permute  result
    """
    p = max(int(group_size), 2)
    if op == "all-gather":
        return payload * (p - 1) / p
    if op == "reduce-scatter":
        return payload * (p - 1)
    if op == "all-reduce":
        return payload * 2 * (p - 1) / p
    if op == "all-to-all":
        return payload * (p - 1) / p
    return payload


def census(records) -> dict:
    """``{op: {count, wire_bytes, payload_bytes}}`` for every op of
    ``COLLECTIVE_OPS`` and ``total_wire_bytes``, from records with ``op``,
    ``payload_bytes`` and ``group_size`` (the reference's
    ``collective_census`` keys)."""
    out = {op: {"count": 0, "wire_bytes": 0.0, "payload_bytes": 0.0}
           for op in COLLECTIVE_OPS}
    for r in records:
        entry = out[r["op"]]
        entry["count"] += 1
        entry["wire_bytes"] += wire_bytes(r["op"], r["payload_bytes"],
                                          r["group_size"])
        entry["payload_bytes"] += float(r["payload_bytes"])
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in out.values()
                                  if isinstance(v, dict))
    return out


# ---------------------------------------------------------------------------
# the reference's knobs, copied
# ---------------------------------------------------------------------------

def choose_optimizer(cfg) -> str:
    return "adafactor" if cfg.param_count() > 100e9 else "adamw"


def choose_microbatches(cfg, shape) -> int:
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 8192:
        return 16
    if cfg.d_model >= 4096:
        return 8
    return 4


def choose_remat(cfg, shape) -> str:
    # remat is on for every train cell: without it every layer's
    # activations stay live for the backward pass
    if shape.kind != "train":
        return "none"
    return "full"


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _group_size(args) -> int:
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except Exception:               # a ReduceOp, not a group
                continue
    raise RuntimeError("a c10d op without a process group")


class CollectiveRecorder:
    """A ``TorchDispatchMode`` (built on entry) that appends one record
    per ``c10d`` collective to ``records``: ``op`` (the reference's HLO
    name), ``c10d`` (the op dispatched), ``payload_bytes`` (the result's
    bytes: the gathered output, the scattered piece, the reduced tensors),
    ``group_size``, ``dtype`` and ``shape``."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        records = self.records = []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func.namespace == "c10d":
                    name = func._opname
                    op = C10D_OPS.get(name)
                    if op is not None:
                        out = _tensors(args[0])
                        records.append({
                            "op": op, "c10d": name,
                            "payload_bytes": sum(t.numel() * t.element_size()
                                                 for t in out),
                            "group_size": _group_size(args),
                            "dtype": str(out[0].dtype).replace("torch.", ""),
                            "shape": [list(t.shape) for t in out]})
                return func(*args, **kwargs)

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def trace_device() -> str:
    """The fake tensors' device type: ``cuda`` where torch is built with
    CUDA, else ``cpu`` (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    (no communication; every collective returns at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake process group cannot share a process "
                           "with another group; trace in a process of its "
                           "own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` over the fake group (whose world size
    must be its product)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(trace_device(), tuple(shape),
                            mesh_dim_names=tuple(names))


@contextlib.contextmanager
def production_world(multi_pod: bool = False):
    """-> the production ``DeviceMesh`` (16 x 16, or 2 x 16 x 16) over a
    fake group of 256 or 512 ranks, this process rank 0."""
    from repro_torch.launch.mesh import production_mesh_shape

    shape, names = production_mesh_shape(multi_pod=multi_pod)
    with fake_world(math.prod(shape)):
        yield fake_mesh(shape, names)


# ---------------------------------------------------------------------------
# the attention core, replayed
# ---------------------------------------------------------------------------

def _total(tracker) -> int:
    return sum(v["Total"] for d, v in tracker.get_tracker_snapshot().items()
               if d.type != "meta")


class _Replay(torch.autograd.Function):
    """A traced attention core stood in for by its measured effects: the
    output's shape and dtype, ``fwd`` FLOPs (the backward's two products
    of each forward one: 2 * ``fwd``) and ``saved`` bytes held for the
    backward (saved as autograd saves them, so a remat forward drops them
    as it drops the real ones)."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, saved, flops, out_dtype):
        flops.flop_counts["Global"][torch.ops.aten.bmm] += fwd
        ctx.fwd, ctx.flops = fwd, flops
        ctx.like = [(t.shape, t.dtype) for t in (q, k, v)]
        ctx.save_for_backward(torch.empty(max(saved, 0), dtype=torch.uint8,
                                          device=q.device))
        return torch.zeros(q.shape, dtype=out_dtype, device=q.device)

    @staticmethod
    def backward(ctx, g):
        ctx.flops.flop_counts["Global"][torch.ops.aten.bmm] += 2 * ctx.fwd
        grads = tuple(torch.zeros(shape, dtype=dt, device=g.device)
                      for shape, dt in ctx.like)
        return grads + (None, None, None, None)


@contextlib.contextmanager
def replayed_attention(box: dict):
    """Under this context (``box``: the running trace's ``tracker`` and
    ``flops``), trace ``attention._attend_blocks`` (the masked and triangular
    schedules' block loops: n^2 block updates of ~20 ops each) once per
    distinct call (the shapes, chunk, schedule, config flags, whether
    autograd records) and stand each later identical call in with
    ``_Replay``: the same FLOPs, output and bytes saved for the backward.
    Every layer is still traced; only a repeated block loop is not run op
    by op (a 32,768-token prefill runs 4,096 block updates a layer).  With
    no backward to feed, even the first call runs only its first Q chunk's
    row of blocks and counts the rest from it (every block of a schedule
    does the same products).

    A layer takes the same path in a remat forward and in its recompute
    (``checkpoint`` checks that they save alike): the forward's choices
    are kept and the recompute, which runs the layers in reverse, takes
    them back.  The first layer's core runs in both; a replay keeps the
    most bytes any real call of its key held (a remat forward holds none,
    its recompute what the backward needs).  What a replay leaves out is
    the loop's transient working set, one block's."""
    from repro_torch.models import attention as attn_mod

    real = attn_mod._attend_blocks
    memo: dict = {}
    remat_paths: list = []      # a remat forward's choices, recompute pops

    def hooks() -> str:
        top = torch._C._autograd._top_saved_tensors_default_hooks(False)
        return "" if top is None else getattr(top[0], "__qualname__", "")

    def attend(q, k, v, pos_q, pos_k, cfg, c, triangular):
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        key = (tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype,
               k.dtype, v.dtype, tuple(pos_q.shape), tuple(pos_k.shape), c,
               triangular, cfg.causal, cfg.sliding_window, grad)
        where = hooks() if grad else ""
        if where.startswith("_recomputation_hook"):
            replay = remat_paths.pop()           # the layers come back
        else:                                    # in reverse order
            replay = key in memo
            if where.startswith("_checkpoint_hook"):
                remat_paths.append(replay)
        tracker, flops = box["tracker"], box["flops"]
        if not grad and not replay:
            # no backward: the first Q chunk's row of blocks, for real (its
            # transient in the peak), and the rest reckoned from it
            c_q = min(c, q.shape[1])
            f0 = flops.get_total_flops()
            first = real(q[:, :c_q], k, v, pos_q[:, :c_q], pos_k, cfg, c,
                         triangular)
            n_q, n_k = q.shape[1] // c_q, k.shape[1] // c_q
            done, blocks = (1, n_q * (n_q + 1) // 2) if triangular \
                else (n_k, n_q * n_k)
            fwd = (flops.get_total_flops() - f0) * blocks // done
            flops.flop_counts["Global"][torch.ops.aten.bmm] += \
                fwd - (flops.get_total_flops() - f0)
            memo[key] = (fwd, 0, first.dtype)
            return torch.zeros(q.shape, dtype=first.dtype, device=q.device)
        if not replay:
            f0, m0 = flops.get_total_flops(), _total(tracker)
            out = real(q, k, v, pos_q, pos_k, cfg, c, triangular)
            held = _total(tracker) - m0 - out.numel() * out.element_size()
            if key not in memo or held > memo[key][1]:
                memo[key] = (flops.get_total_flops() - f0, held, out.dtype)
            return out
        fwd, held, out_dtype = memo[key]
        if not grad:
            flops.flop_counts["Global"][torch.ops.aten.bmm] += fwd
            return torch.zeros(q.shape, dtype=out_dtype, device=q.device)
        return _Replay.apply(q, k, v, fwd, held, flops, out_dtype)

    attn_mod._attend_blocks = attend
    try:
        yield
    finally:
        attn_mod._attend_blocks = real


# ---------------------------------------------------------------------------
# per-rank blocks
# ---------------------------------------------------------------------------

def fake_blocks(tree, specs: dict, sizes: dict, device):
    """A tree of fake tensors: each leaf's block under ``specs``, zeros of
    its dtype on ``device`` (call under ``FakeTensorMode``)."""
    from repro_torch.distributed.sharding import block_shape
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    return tree_unflatten(tree, [
        torch.zeros(block_shape(tuple(x.shape), specs[p], sizes),
                    dtype=x.dtype, device=device)
        for x, p in zip(tree_leaves(tree), tree_paths(tree))])


def _meta_like(tree, device):
    from repro_torch.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [torch.zeros(tuple(x.shape), dtype=x.dtype,
                                             device=device)
                                 for x in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _shape_of(shape):
    from repro_torch.configs import SHAPES

    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_config(arch: str, shape, *, remat=None, compute_dtype=None,
                num_layers=None, config=None):
    """-> (config as the cell runs it, shape, remat).  ``shape``: a name of
    ``configs.SHAPES`` or a ``ShapeSpec``; ``config``: a ``ModelConfig``
    to run in place of ``arch``'s published one (a reduced one, say)."""
    from repro_torch.configs import get_config

    cfg = config if config is not None else get_config(arch)
    shape = _shape_of(shape)
    remat = remat if remat is not None else choose_remat(cfg, shape)
    overrides = {"remat": remat}
    if compute_dtype:
        overrides.update(compute_dtype=compute_dtype,
                         param_dtype=compute_dtype)
    if num_layers is not None:
        overrides["num_layers"] = num_layers
    return dataclasses.replace(cfg, **overrides), shape, remat


def cell_meta(arch: str, shape, mesh_sizes: dict, *, attn_impl="auto",
              microbatches=None, remat=None, optimizer=None,
              compute_dtype=None, num_layers=None, config=None) -> dict:
    """The reference's ``meta`` of a cell, from shapes alone (no group, no
    trace): ``arch``, ``shape``, ``mesh``, ``params``, ``param_bytes``,
    ``attn_impl``, ``remat``; ``optimizer``, ``microbatches`` and
    ``opt_state_bytes`` for a train cell; ``cache_bytes`` for a decode
    cell."""
    from repro_torch.launch import specs
    from repro_torch.train import optimizers as opt_mod
    from repro_torch.tree import tree_leaves

    cfg, shape, remat = cell_config(arch, shape, remat=remat,
                                    compute_dtype=compute_dtype,
                                    num_layers=num_layers, config=config)
    p_abs = specs.abstract_params(cfg)
    meta = {"arch": arch, "shape": shape.name, "mesh": dict(mesh_sizes),
            "params": int(sum(x.numel() for x in tree_leaves(p_abs))),
            "param_bytes": specs.param_bytes(p_abs),
            "attn_impl": attn_impl, "remat": remat}
    if shape.kind == "train":
        opt_name = optimizer or choose_optimizer(cfg)
        o_abs = opt_mod.get_optimizer(opt_name, 1e-4).init(
            _reference_layout(p_abs, cfg))
        meta.update(optimizer=opt_name,
                    microbatches=(microbatches if microbatches is not None
                                  else choose_microbatches(cfg, shape)),
                    opt_state_bytes=specs.param_bytes(o_abs))
    elif shape.kind == "decode":
        caches, _, _ = specs.decode_input_specs(cfg, shape)
        meta["cache_bytes"] = specs.param_bytes(caches)
    return meta


def _reference_layout(params, cfg):
    from repro_torch.convert import lm_params_to_reference

    return lm_params_to_reference(params, cfg)


def trace_cell(arch: str, shape, mesh, *, attn_impl="auto",
               microbatches=None, remat=None, optimizer=None,
               compute_dtype=None, num_layers=None, rules="auto",
               opt_inplace: bool = True, config=None,
               traced_microbatches: int = 2) -> dict:
    """Trace one cell's step on this rank of ``mesh`` (a ``DeviceMesh``
    over a fake group: ``production_world``) -> ``meta`` (``cell_meta``'s
    keys), ``records`` (the collectives), ``flops`` and ``memory``:
    ``peak_bytes`` (``MemTracker``'s, the arguments included),
    ``argument_bytes`` (this rank's blocks of the parameters, optimizer
    state, batch and caches, from the specs), ``output_bytes``,
    ``alias_bytes`` (what the step updates in place: the parameters and
    state of a train step, the caches of a decode step), ``temp_bytes``
    (the peak less the arguments) and ``bytes_per_device`` (the
    reference's sum: temp + arguments + outputs - aliased).

    A train step of M microbatches is traced at ``m = min(M,
    max(traced_microbatches, 2))`` microbatches of the same size: the
    microbatches after the first are alike, so the last traced one's
    records and FLOPs (from its start to the optimizer's) are added M - m
    more times, and a run of 2 holds the step's peak (the accumulator
    beside one microbatch's work).

    ``shape``: a name of ``configs.SHAPES`` or a ``ShapeSpec``.
    ``rules``: "auto" puts a decode cell's weights under ``SERVING_RULES``;
    "train" keeps the training layout everywhere (the reference's
    ``--rules train``).  ``opt_inplace``: AdamW updates the parameters and
    state in place, as ``launch.train`` runs it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (SERVING_RULES, axis_sizes,
                                                  batch_shardings,
                                                  block_bytes, block_shape,
                                                  cache_shardings,
                                                  param_shardings)
    from repro_torch.launch import specs

    cfg, shape, remat = cell_config(arch, shape, remat=remat,
                                    compute_dtype=compute_dtype,
                                    num_layers=num_layers, config=config)
    sizes = axis_sizes(mesh)
    meta = cell_meta(arch, shape, sizes, attn_impl=attn_impl,
                     microbatches=microbatches, remat=remat,
                     optimizer=optimizer, compute_dtype=compute_dtype,
                     num_layers=num_layers, config=config)
    dev = torch.device(trace_device())
    mem: dict = {}

    if shape.kind == "train":
        from repro_torch.distributed.tensor_parallel import ShardedLM
        from repro_torch.train import loop
        from repro_torch.train import optimizers as opt_mod

        p_abs = _reference_layout(specs.abstract_params(cfg), cfg)
        batch_abs = specs.train_input_specs(cfg, shape)
        opt_name, micro = meta["optimizer"], meta["microbatches"]
        o_abs = opt_mod.get_optimizer(opt_name, 1e-4).init(p_abs)
        o_specs = param_shardings(o_abs, mesh)
        accum = "bfloat16" if cfg.param_count() > 500e9 else None
        per = shape.global_batch // micro
        traced_micro = min(micro, max(traced_microbatches, 2))
        rows = traced_micro * per

        def setup():
            shard = ShardedLM(cfg, mesh)
            opt = opt_mod.get_optimizer(opt_name, 1e-4, layout=shard.layout,
                                        **({"inplace": True}
                                           if opt_name == "adamw"
                                           and opt_inplace else {}))
            # where each microbatch and the update begin
            local_batch, update = shard.local_batch, opt.update

            def mark(fn):
                def marked(*a):
                    marks.append((len(box["records"]),
                                  box["flops"].get_total_flops()))
                    return fn(*a)
                return marked

            shard.local_batch = mark(local_batch)
            opt = opt._replace(update=mark(update))
            p = fake_blocks(p_abs, shard.param_specs, sizes, dev)
            o = fake_blocks(o_abs, o_specs, sizes, dev)
            batch = _meta_like(specs.train_input_specs(
                cfg, dataclasses.replace(shape, global_batch=rows)), dev)
            step = loop.make_train_step(cfg, opt,
                                        microbatches=traced_micro,
                                        attn_impl=attn_impl,
                                        accum_dtype=accum, shard=shard)
            state = block_bytes(p_abs, shard.param_specs, sizes) \
                + block_bytes(o_abs, o_specs, sizes)
            mem.update(argument_bytes=state + block_bytes(
                batch_abs, batch_shardings(batch_abs, mesh), sizes),
                alias_bytes=state, output_bytes=state)
            return lambda: step(p, o, batch)
    elif shape.kind == "prefill":
        from repro_torch.distributed.tensor_parallel import ShardedLM
        from repro_torch.models import lm

        p_abs = specs.abstract_params(cfg)
        p_specs = param_shardings(p_abs, mesh)
        batch_abs = specs.prefill_input_specs(cfg, shape)
        c_abs = lm.init_caches(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
        c_specs = cache_shardings(c_abs, mesh)

        def setup():
            shard = ShardedLM(cfg, mesh)
            p = fake_blocks(p_abs, p_specs, sizes, dev)
            batch = _meta_like(batch_abs, dev)
            mem.update(
                argument_bytes=block_bytes(p_abs, p_specs, sizes)
                + block_bytes(batch_abs, batch_shardings(batch_abs, mesh),
                              sizes),
                alias_bytes=0,
                output_bytes=shape.global_batch * cfg.padded_vocab * 4
                + block_bytes(c_abs, c_specs, sizes))
            return lambda: shard.prefill(p, batch, cache_len=shape.seq_len,
                                         attn_impl=attn_impl)
    else:
        from repro_torch.distributed.serving import ServingLM

        caches_abs, tok_abs, _ = specs.decode_input_specs(cfg, shape)
        c_specs = cache_shardings(caches_abs, mesh)
        t_spec = batch_shardings({"t": tok_abs}, mesh)["t"]

        def setup():
            model = ServingLM(cfg, mesh, shape.global_batch, shape.seq_len,
                              rules=None if rules == "train"
                              else SERVING_RULES)
            p = fake_blocks(model.abstract, model.specs, sizes, dev)
            caches = fake_blocks(caches_abs, c_specs, sizes, dev)
            tok = torch.zeros(block_shape(tuple(tok_abs.shape), t_spec,
                                          sizes), dtype=tok_abs.dtype,
                              device=dev)
            c_bytes = block_bytes(caches_abs, c_specs, sizes)
            mem.update(argument_bytes=block_bytes(model.abstract, model.specs,
                                                  sizes) + c_bytes
                       + tok.numel() * tok.element_size() + 4,
                       alias_bytes=c_bytes,
                       output_bytes=shape.global_batch * cfg.padded_vocab * 4
                       + c_bytes)
            return lambda: model.decode_step(p, tok, caches,
                                             shape.seq_len - 1)

    box: dict = {}
    marks: list = []

    def traced():
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.utils.flop_counter import FlopCounterMode

        recorder, tracker = CollectiveRecorder(), MemTracker()
        flops = FlopCounterMode(display=False)
        box.update(tracker=tracker, flops=flops, records=recorder.records)
        with tracker:
            run = setup()
            with flops, recorder:
                run()
        # the trace device's alone: the specs' meta tensors count apart
        peak = sum(v["Total"] for d, v in
                   tracker.get_tracker_snapshot("peak").items()
                   if d.type == dev.type)
        return recorder.records, float(flops.get_total_flops()), int(peak)

    with FakeTensorMode(allow_non_fake_inputs=True), replayed_attention(box):
        records, flops, peak = traced()
    if shape.kind == "train" and meta["microbatches"] > traced_micro:
        (r1, f1), (r_opt, f_opt) = marks[traced_micro - 1], \
            marks[traced_micro]
        times = meta["microbatches"] - traced_micro
        records = records[:r_opt] + records[r1:r_opt] * times \
            + records[r_opt:]
        flops += times * (f_opt - f1)
    mem["peak_bytes"] = peak
    mem["temp_bytes"] = peak - mem["argument_bytes"]
    mem["bytes_per_device"] = (mem["temp_bytes"] + mem["argument_bytes"]
                               + mem["output_bytes"] - mem["alias_bytes"])
    return {"meta": meta, "memory": mem, "records": records, "flops": flops}


def run_cell(arch: str, shape_name: str, mesh, mesh_tag: str,
             args) -> dict:
    """One record with the reference's keys (``status``, ``meta``'s keys,
    ``memory``, ``collectives``, ``flops_per_device_raw``, ``corrected``,
    ``num_devices``, ``total_seconds``); ``status`` "fail" with the error
    and its traceback when the trace raised."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh_tag": mesh_tag,
           "status": "ok"}
    try:
        out = trace_cell(arch, shape_name, mesh, attn_impl=args.attn_impl,
                         microbatches=args.microbatches, remat=args.remat,
                         optimizer=args.optimizer,
                         compute_dtype=args.compute_dtype, rules=args.rules)
        t_trace = time.time() - t0
        if out["memory"]["temp_bytes"] < 0:
            raise ValueError(
                f"the peak read {out['memory']['peak_bytes']} bytes, under "
                f"the {out['memory']['argument_bytes']} of the arguments: "
                "MemTracker did not see the trace device")
        cen = census(out["records"])
        rec.update(out["meta"])
        rec.update(
            seconds_trace=round(t_trace, 1),
            flops_per_device_raw=out["flops"],
            memory=out["memory"],
            collectives=cen,
            num_collectives=len(out["records"]),
            num_devices=math.prod(out["meta"]["mesh"].values()),
            corrected={"flops": out["flops"],
                       "wire": cen["total_wire_bytes"],
                       "method": "eager trace (every layer counted)"})
        if args.dump_hlo:
            os.makedirs(args.dump_hlo, exist_ok=True)
            fname = f"{arch}_{shape_name}_{mesh_tag}.collectives.json"
            with open(os.path.join(args.dump_hlo, fname), "w") as f:
                json.dump(out["records"], f)
        print(f"[ok] {arch} x {shape_name} x {mesh_tag}: trace "
              f"{t_trace:.0f}s  flops/dev {out['flops']:.3e}  wire/dev "
              f"{cen['total_wire_bytes']:.3e}B  (reckoned)")
        print(f"     memory: {out['memory']}")
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL] {arch} x {shape_name} x {mesh_tag}: {e}")
    rec["total_seconds"] = round(time.time() - t0, 1)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--compute-dtype", default=None)
    ap.add_argument("--dump-hlo", default=None,
                    help="directory for each cell's recorded collectives "
                         "(the port's nearest counterpart of the HLO)")
    ap.add_argument("--no-analysis", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "eager trace counts every layer, so there is no "
                         "separate analysis pass")
    ap.add_argument("--rules", choices=("auto", "train"), default="auto",
                    help="auto: serving layout for decode cells; train: "
                         "force the training layout everywhere (baseline)")
    ap.add_argument("--tag", default=None,
                    help="experiment tag recorded in each cell")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from repro_torch.configs import (ARCH_NAMES, SHAPES, cell_is_runnable,
                                     get_config)

    args = parse_args(argv)
    cells = []
    archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    for arch in archs:
        cfg = get_config(arch)
        for sname in shapes:
            ok, reason = cell_is_runnable(cfg, SHAPES[sname])
            if ok:
                cells.append((arch, sname))
            else:
                print(f"[skip] {arch} x {sname}: {reason}")

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16", True))

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    t0 = time.time()
    for mesh_tag, multi in meshes:
        with production_world(multi_pod=multi) as mesh:
            for arch, sname in cells:
                rec = run_cell(arch, sname, mesh, mesh_tag, args)
                if args.tag:
                    rec["tag"] = args.tag
                results = [r for r in results
                           if not (r["arch"] == arch and r["shape"] == sname
                                   and r["mesh_tag"] == mesh_tag
                                   and r.get("tag") == args.tag)]
                results.append(rec)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    fails = [r for r in results if r["status"] == "fail"]
    print(f"\n{len(results)} cells recorded, {len(fails)} failures "
          f"({time.time() - t0:.1f} s on the host)")
    return 1 if fails else 0


__all__ = ["COLLECTIVE_OPS", "C10D_OPS", "wire_bytes", "census",
           "choose_optimizer", "choose_microbatches", "choose_remat",
           "CollectiveRecorder", "trace_device", "fake_world", "fake_mesh",
           "production_world", "fake_blocks",
           "cell_config", "cell_meta", "trace_cell", "run_cell",
           "parse_args", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
