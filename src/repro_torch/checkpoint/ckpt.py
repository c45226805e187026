"""Checkpoint save and restore (port of ``repro/checkpoint/ckpt.py``:
``save``, ``available_steps``, ``restore_arrays`` and ``restore``, sharded
trees included: a sharded save gathers each leaf and rank 0 writes it, and
a restore with shardings keeps this rank's block).

Layout, the reference's unchanged so one directory serves both packages:
``<dir>/step_%010d/`` holds one ``.npy`` file per leaf, named by the md5 of
the leaf's path string, plus ``manifest.json`` with ``step``, ``index``
(path -> file, shape, dtype), ``extra`` and a ``digest`` (sha256 over each
leaf's path and its first 4,096 bytes).  Writes are atomic: a temporary
directory is renamed into place, so a crash mid-save never leaves a
half-written step behind that name.

A tree is a (nested) dict, list or tuple of arrays; a leaf's path string
joins its keys with ``/`` (a flat dict's leaf is named by its key).  Device
tensors are copied to the host before they are written.

bfloat16 leaves are written as the reference writes them (numpy with
``ml_dtypes``): a ``.npy`` of two-byte ``<V2`` records holding the bf16
bits, manifest dtype ``"bfloat16"``.  The port needs no ``ml_dtypes`` for
that: on the host such a leaf is a ``V2`` array of the bits (``to_host``),
and ``from_host`` makes it a bf16 tensor again.  (The reference's own
``restore`` cannot cast such a leaf back; its ``restore_arrays`` can load
it.)
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, path_to_str


BF16_RECORD = np.dtype("V2")


def is_bf16(arr: np.ndarray) -> bool:
    """A host array of bf16 bits: ``ml_dtypes``' bfloat16, or the two-byte
    records ``to_host`` and ``np.load`` give for one."""
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                            and arr.dtype.itemsize == 2)


def to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a bf16 tensor as ``V2`` records of its
    bits).  A tensor is always copied (a CPU tensor's ``numpy()`` would
    share its memory with the live state)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_RECORD)
        return t.numpy()
    return np.asarray(leaf)


def from_host(arr: np.ndarray) -> torch.Tensor:
    """A host array (bf16 records included) as a CPU tensor, bit for bit."""
    arr = np.array(arr, order="C")           # a copy; 0-d stays 0-d
    if is_bf16(arr):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if is_bf16(arr) else str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray) -> None:
    if not is_bf16(arr):
        np.save(path, arr)
        return
    # the header np.save writes for ml_dtypes' bfloat16
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes())


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A fresh CPU tensor as a host array, its memory shared."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def gather_to_host(tree, shardings: dict, mesh) -> dict:
    """``{path: host array}`` of a sharded tree on rank 0, ``{}`` on every
    other rank (every rank of the mesh calls it; the mesh spans the
    default group).  Each leaf is this rank's block under
    ``shardings[path]``; leaf by leaf in path order, the ranks holding its
    distinct blocks (coordinate 0 along every axis the spec does not split)
    send them to rank 0, which copies each into the leaf's host array at
    its place.  So one host holds the whole state, and no card holds more
    than its own blocks and one received (an all-gather would put the
    whole leaf on every card: a 28-layer deepseek-moe-16b's f32 moment is
    19.25 GiB)."""
    import itertools

    import torch.distributed as dist

    from repro_torch.distributed.sharding import (axis_sizes, block_index,
                                                  entry_axes, spec_axes)

    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    grid = mesh.mesh
    me = dist.get_rank()
    leaves = flatten_with_paths(tree)
    host = {}
    for name in sorted(leaves):
        block = leaves[name].detach().contiguous()
        spec = tuple(shardings[name]) + (None,) * (block.dim()
                                                   - len(shardings[name]))
        split = set(spec_axes(spec))
        senders = []
        for idx in itertools.product(*(range(n) for n in grid.shape)):
            coords = dict(zip(names, idx))
            if not any(coords[a] for a in names if a not in split):
                senders.append((int(grid[idx]), coords))
        if me != 0:
            if me in {r for r, _ in senders}:
                dist.send(block, dst=0)
            continue
        shape = [n * math.prod(sizes[a] for a in entry_axes(e))
                 for n, e in zip(block.shape, spec)]
        full = torch.empty(shape, dtype=block.dtype)
        buf = None
        for r, coords in senders:
            if r == 0:
                piece = block
            else:
                buf = torch.empty_like(block) if buf is None else buf
                dist.recv(buf, src=r)
                piece = buf
            at = tuple(slice(i * n, (i + 1) * n) for n, (i, _) in zip(
                block.shape, (block_index(e, sizes, coords) for e in spec)))
            full[at].copy_(piece)
        host[name] = _host_array(full)
    return host


def save(directory: str, step: int, tree, extra: dict | None = None,
         shardings: dict | None = None, mesh=None) -> str:
    """Atomically write ``tree`` as checkpoint ``step_<N>``; returns path.

    With ``shardings`` (``{path: spec}``, ``sharding.param_shardings``)
    the leaves are this rank's blocks on ``mesh``: every rank calls
    ``save``, each leaf is gathered (``gather_to_host``), rank 0 writes
    them, and all ranks return once it has (a barrier).  The files,
    manifest and digest are the bytes an unsharded save of the same
    values writes."""
    final = os.path.join(directory, f"step_{step:010d}")
    if shardings is not None:
        import torch.distributed as dist

        host = gather_to_host(tree, shardings, mesh)
        if dist.get_rank() == 0:
            save(directory, step, host, extra)
        dist.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        leaves = flatten_with_paths(tree)
        index = {}
        h = hashlib.sha256()
        for name, leaf in sorted(leaves.items()):
            arr = to_host(leaf)
            fname = hashlib.md5(name.encode()).hexdigest() + ".npy"
            _write_leaf(os.path.join(tmp, fname), arr)
            index[name] = {"file": fname, "shape": list(arr.shape),
                           "dtype": _dtype_name(arr)}
            h.update(name.encode())
            h.update(arr.tobytes()[:4096])
        manifest = {"step": step, "index": index,
                    "extra": extra or {}, "digest": h.hexdigest()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def available_steps(directory: str) -> list[int]:
    """Steps with a manifest under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def restore_arrays(directory: str, step: int,
                   verify: bool = False) -> tuple[dict, dict]:
    """Load checkpoint ``step`` as a flat ``{leaf-path: np.ndarray}`` dict
    and its ``extra`` (a bf16 leaf as ``V2`` records: ``from_host``).

    Shapes and dtypes come from the manifest.  ``verify=True`` recomputes
    the payload digest (the formula of :func:`save`) and cross-checks every
    leaf's shape and dtype against the manifest, raising ``ValueError`` on
    any mismatch -- the corrupt / partial-write rejection that crash
    recovery relies on to fall back to an older snapshot.
    """
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: dict[str, np.ndarray] = {}
    h = hashlib.sha256()
    for name, entry in sorted(manifest["index"].items()):
        try:
            arr = np.load(os.path.join(path, entry["file"]))
        except Exception as e:               # truncated / unreadable leaf
            raise ValueError(f"checkpoint {path}: unreadable leaf {name}: "
                             f"{e}") from e
        if verify and (list(arr.shape) != entry["shape"]
                       or _dtype_name(arr) != entry["dtype"]):
            raise ValueError(f"checkpoint {path}: leaf {name} has "
                             f"{arr.shape}/{arr.dtype}, manifest says "
                             f"{entry['shape']}/{entry['dtype']}")
        arrays[name] = arr
        h.update(name.encode())
        h.update(arr.tobytes()[:4096])
    if verify and h.hexdigest() != manifest.get("digest"):
        raise ValueError(f"checkpoint {path} failed digest verification "
                         f"(corrupt or partially written)")
    return arrays, manifest["extra"]


def restore(directory: str, step: int, like_tree, device=None,
            shardings: dict | None = None, mesh=None):
    """Load checkpoint ``step`` shaped like ``like_tree`` (tensors, on the
    ``meta`` device too): each leaf found by its path, its shape checked,
    cast to the like leaf's dtype and put on ``device`` (``None``: the like
    leaf's own device).  With ``shardings`` (``{path: spec}``) each leaf
    is cut to this rank's block on ``mesh`` before it goes to the device
    (the elastic re-shard: the checkpoint may come from any mesh).
    -> (tree, extra)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    index = manifest["index"]

    def load(prefix, like):
        if isinstance(like, dict):
            return {k: load(prefix + (k,), v) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(load(prefix + (i,), v)
                              for i, v in enumerate(like))
        name = path_to_str(prefix)
        if name not in index:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(path, index[name]["file"]))
        want = tuple(like.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {want}")
        leaf = from_host(arr).to(dtype=like.dtype)
        if shardings is not None:
            from repro_torch.distributed.sharding import shard_leaf

            leaf = shard_leaf(leaf, shardings[name], mesh)
        return leaf.to(device=device or like.device)

    return load((), like_tree), manifest["extra"]


__all__ = ["path_to_str", "is_bf16", "to_host", "from_host",
           "gather_to_host", "save",
           "available_steps", "restore_arrays", "restore"]
