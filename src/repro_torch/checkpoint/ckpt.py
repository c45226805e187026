"""Checkpoint save and array restore (port of ``repro/checkpoint/ckpt.py``:
``save``, ``available_steps``, ``restore_arrays``).

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
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch


def path_to_str(path) -> str:
    """A leaf's key path as the reference names it: keys joined by ``/``."""
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path_to_str(prefix): tree}
    out = {}
    for key, sub in items:
        out.update(_flatten_with_paths(sub, prefix + (key,)))
    return out


def to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array.  A tensor is always copied (a CPU
    tensor's ``numpy()`` would share its memory with the live state)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write ``tree`` as checkpoint ``step_<N>``; returns path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        leaves = _flatten_with_paths(tree)
        index = {}
        h = hashlib.sha256()
        for name, leaf in sorted(leaves.items()):
            arr = to_host(leaf)
            fname = hashlib.md5(name.encode()).hexdigest() + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            index[name] = {"file": fname, "shape": list(arr.shape),
                           "dtype": str(arr.dtype)}
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
    and its ``extra``.

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
                       or str(arr.dtype) != entry["dtype"]):
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


__all__ = ["path_to_str", "to_host", "save", "available_steps",
           "restore_arrays"]
