"""Checkpoint manager: asynchronous writes, retention, resume and a
failure-injection hook, and a step-time watchdog (port of
``repro/checkpoint/manager.py``: ``suggest_interval``,
``CheckpointManager`` and ``StragglerMonitor``).

At scale the checkpoint cadence is the fault-tolerance budget: with
MTBF_cluster = MTBF_node / N, the optimal interval is
sqrt(2 * t_ckpt * MTBF_cluster) (Young/Daly); ``suggest_interval`` applies
that formula.

Asynchronous writes: ``save_async`` copies the tree to the host and hands
it to a writer thread, so the caller blocks only for the device-to-host
copy, not the disk write.  ``wait`` joins the writer (call it before
reading a checkpoint back and before exit).
"""

from __future__ import annotations

import json
import math
import os
import queue
import shutil
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import ckpt


def suggest_interval(ckpt_seconds: float, node_mtbf_hours: float,
                     num_nodes: int, step_seconds: float) -> int:
    """Young/Daly optimal checkpoint interval, in steps."""
    mtbf_cluster = node_mtbf_hours * 3600.0 / max(num_nodes, 1)
    seconds = math.sqrt(2.0 * ckpt_seconds * mtbf_cluster)
    return max(1, int(seconds / max(step_seconds, 1e-9)))


def _host_tree(tree):
    """The same tree with every leaf a host numpy array (tensors copied)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return ckpt.to_host(tree)


class CheckpointManager:
    """Periodic, asynchronous, retained checkpoints under one directory.

    ``failure_hook(step)`` runs on the writer thread before each save;
    tests raise from it to inject a crash.  Errors of the writer surface
    at the next ``wait``.
    """

    def __init__(self, directory: str, interval: int = 100,
                 keep_last: int = 3,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.directory = directory
        self.interval = interval
        self.keep_last = keep_last
        self.failure_hook = failure_hook
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._errors: list[BaseException] = []
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._writer.start()

    # -- writer thread -------------------------------------------------------
    def _write_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                ckpt.save(self.directory, step, tree, extra)
                self._retain()
            except BaseException as e:       # surfaced via .wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _retain(self):
        steps = ckpt.available_steps(self.directory)
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- public API ----------------------------------------------------------
    def maybe_save(self, step: int, tree, extra: dict | None = None,
                   force: bool = False):
        if force or (step > 0 and step % self.interval == 0):
            self.save_async(step, tree, extra)

    def save_async(self, step: int, tree, extra: dict | None = None,
                   shardings: dict | None = None, mesh=None):
        """Copy ``tree`` to the host now (before this returns, so the caller
        may then update it in place); write it on the writer thread.
        With ``shardings`` the leaves are this rank's blocks on ``mesh``:
        every rank calls this, the leaves are gathered here
        (``ckpt.gather_to_host``), and rank 0 alone writes them."""
        if shardings is None:
            self._q.put((step, _host_tree(tree), extra or {}))
            return
        import torch.distributed as dist

        host = ckpt.gather_to_host(tree, shardings, mesh)
        if dist.get_rank() == 0:
            self._q.put((step, host, extra or {}))

    def wait(self, raise_errors: bool = True):
        self._q.join()
        if raise_errors and self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def close(self):
        self.wait(raise_errors=False)
        self._q.put(None)
        self._writer.join(timeout=10)

    def latest_step(self) -> Optional[int]:
        steps = ckpt.available_steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, like_tree, device=None,
                       shardings: dict | None = None, mesh=None):
        """The newest checkpoint shaped like ``like_tree`` (``ckpt.restore``,
        with ``shardings`` this rank's blocks on ``mesh``) -> ``(step,
        tree, extra)``, or ``(None, None, {})`` when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None, {}
        tree, extra = ckpt.restore(self.directory, step, like_tree, device,
                                   shardings=shardings, mesh=mesh)
        return step, tree, extra

    def restore_latest_arrays(self, verify: bool = True,
                              skipped: list | None = None):
        """Newest checkpoint as a flat ``{leaf-path: array}`` dict, walking
        back past corrupt or partial snapshots (``verify=True`` rejects them
        by the manifest digest) to the newest *loadable* one.  Returns
        ``(step, arrays, extra)`` or ``(None, None, {})``.  Pass
        ``skipped=[]`` to collect the steps that failed to load."""
        for step in reversed(ckpt.available_steps(self.directory)):
            try:
                arrays, extra = ckpt.restore_arrays(self.directory, step,
                                                    verify=verify)
                return step, arrays, extra
            except (ValueError, OSError, json.JSONDecodeError):
                if skipped is not None:
                    skipped.append(step)
                continue                       # fall back to the previous one
        return None, None, {}


class StragglerMonitor:
    """Step-time watchdog: records an event for every step slower than
    ``threshold`` x the running median of the last ``window`` steps (after
    the first 5).  The caller ends a step once its work is done (on the
    card: after a synchronize), so a step's time is its device time too."""

    def __init__(self, threshold: float = 2.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.events: list[tuple[int, float, float]] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> Optional[float]:
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        med = float(np.median(self.times[-self.window:])) if self.times \
            else dt
        self.times.append(dt)
        if len(self.times) > 5 and dt > self.threshold * med:
            self.events.append((self._step, dt, med))
        return dt


__all__ = ["suggest_interval", "CheckpointManager", "StragglerMonitor"]
