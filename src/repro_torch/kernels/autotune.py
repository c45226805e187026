"""The launch-geometry registry of the port's CUDA kernels (port of
``repro/kernels/autotune.py``).

``AutotuneRegistry`` is a keyed store ``(kernel, key) -> geometry`` that
resolves, in order: runtime-recorded measurements, the kernel's seeded
table, the kernel's formula fallback; every resolution is memoized.
``save``/``load`` serialize the *recorded* entries (never the seeded tables
or formula results) to JSON, in the reference's file format, so one
``REPRO_AUTOTUNE_CACHE`` file can serve both packages: the port's kernels
register under names of their own (``cuda.gee_spmm``, ...), so no TPU block
size ever reaches a CUDA launch and no CUDA geometry a Pallas call.

The port registers its three geometry policies as fallbacks, with empty
seeded tables (a sweep of the knobs on the H100 found the defaults best or
within 1 % of best, so the formula is the table):

  ``cuda.gee_spmm`` / ``cuda.gee_spmm_fused``  key ``(D, K, vec)`` ->
      ``gee_spmm.launch_geometry``'s ``(lanes, span, spans)``
  ``cuda.topk_pairwise``  key ``(SMs, Q, M)`` -> ``(chunks,)`` of
      ``topk_score._num_chunks``
  ``cuda.topk_gathered``  key ``(SMs, Q, M)`` -> ``(chunks,)`` of
      ``topk_score._gathered_chunks``

Keys are exact, not pow2 buckets, so that a launch with nothing recorded
resolves exactly the policy's geometry.  Measured search
(:meth:`AutotuneRegistry.measured_search`) times candidates with CUDA events
on the card; the launches run it on their own operands only when
``REPRO_AUTOTUNE_MEASURE`` opts in.

>>> reg = AutotuneRegistry()
>>> reg.register("toy", table={(64, 4): (8, 8)},
...              fallback=lambda key: (key[0] // 2, 4))
>>> reg.lookup("toy", (64, 4))          # seeded table hit
(8, 8)
>>> reg.lookup("toy", (128, 4))         # formula fallback
(64, 4)
>>> reg.record("toy", (128, 4), (32, 8))   # a measurement wins over both
>>> reg.lookup("toy", (128, 4))
(32, 8)
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Tuple

ENV_CACHE_PATH = "REPRO_AUTOTUNE_CACHE"
ENV_MEASURE = "REPRO_AUTOTUNE_MEASURE"

Key = Tuple[int, ...]
Value = Tuple[int, ...]


def measure_enabled() -> bool:
    """True when ``REPRO_AUTOTUNE_MEASURE`` opts in to measured search at
    launch time.  Off by default, so cold runs resolve the seeded table or
    the formula."""
    return os.environ.get(ENV_MEASURE, "") not in ("", "0", "false", "False")


def _cuda_result(x):
    """The first CUDA tensor in ``x`` (a tensor or a tuple/list of them), or
    None."""
    import torch

    items = x if isinstance(x, (tuple, list)) else (x,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            return t
    return None


# cycles of the sleep kernel queued ahead of a timed CUDA launch (~5 ms on
# an H100), longer than the host takes to enqueue one launch
SLEEP_CYCLES = 10_000_000


def measure_runtime(fn: Callable[[], object], *, warmup: int = 1,
                    repeats: int = 3) -> float:
    """min-of-N time of ``fn()`` in seconds, after at least one warmup run.

    When ``fn`` returns a CUDA tensor (or a tuple holding one) each repeat
    is timed by CUDA events on the current stream, behind a sleep kernel
    that lets the host enqueue the whole repeat first: its device time,
    which host launch overhead does not blur.  Otherwise the host clock
    times it.
    """
    out = None
    for _ in range(max(int(warmup), 1)):
        out = fn()
    best = float("inf")
    if _cuda_result(out) is not None:
        import torch

        torch.cuda.synchronize()
        for _ in range(max(int(repeats), 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def ceil_to(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return ((x + m - 1) // m) * m


def pow2_at_least(x: int) -> int:
    """Smallest power of two >= ``x`` (1 for x <= 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def pow2_bucket(*dims: int) -> Key:
    """Bucket a shape tuple: each dim -> pow2_at_least(max(dim, 1))."""
    return tuple(pow2_at_least(max(int(d), 1)) for d in dims)


class AutotuneRegistry:
    """Keyed store of launch geometries shared by all kernels.

    Resolution order per ``(kernel, key)``: recorded measurement > seeded
    table > formula fallback; the result is memoized.  Recorded entries are
    the only state ``save``/``load`` persist.
    """

    def __init__(self):
        self._tables: Dict[str, Dict[Key, Value]] = {}
        self._fallbacks: Dict[str, Callable[[Key], Value]] = {}
        self._recorded: Dict[str, Dict[Key, Value]] = {}
        self._memo: Dict[Tuple[str, Key], Value] = {}
        self._loaded_env = False

    # -- kernel opt-in -------------------------------------------------------
    def register(self, kernel: str, *, fallback: Callable[[Key], Value],
                 table: Dict[Key, Value] | None = None) -> None:
        """Declare a kernel's seeded table and formula fallback.

        Re-registering replaces both and drops the kernel's memo; recorded
        measurements survive.
        """
        self._tables[kernel] = dict(table or {})
        self._fallbacks[kernel] = fallback
        self._memo = {mk: v for mk, v in self._memo.items()
                      if mk[0] != kernel}

    def kernels(self) -> Tuple[str, ...]:
        return tuple(sorted(self._tables))

    # -- resolution ----------------------------------------------------------
    def lookup(self, kernel: str, key: Key) -> Value:
        """Resolve the geometry of ``kernel`` at ``key``."""
        self._maybe_load_env()
        key = tuple(int(k) for k in key)
        memo_key = (kernel, key)
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        if kernel not in self._fallbacks:
            raise KeyError(f"kernel {kernel!r} not registered "
                           f"(known: {self.kernels()})")
        value = self._recorded.get(kernel, {}).get(key)
        if value is None:
            value = self._tables[kernel].get(key)
        if value is None:
            value = tuple(int(v) for v in self._fallbacks[kernel](key))
        self._memo[memo_key] = value
        return value

    def record(self, kernel: str, key: Key, value: Value) -> None:
        """Store a measured result; it now wins over table and formula."""
        key = tuple(int(k) for k in key)
        value = tuple(int(v) for v in value)
        self._recorded.setdefault(kernel, {})[key] = value
        self._memo[(kernel, key)] = value

    def measured_search(self, kernel: str, key: Key,
                        candidates: Iterable[Value],
                        runner: Callable[[Value], object], *,
                        warmup: int = 1, repeats: int = 3,
                        persist: bool = True
                        ) -> Tuple[Value, Dict[Value, float]]:
        """Time each candidate with ``runner(candidate)`` (one launch at
        that geometry) through :func:`measure_runtime` and record the
        fastest; flush it to the ``REPRO_AUTOTUNE_CACHE`` file when
        ``persist`` (a no-op without the env path).

        A key already recorded returns at once with empty timings, so a
        fixed cache file makes repeated runs identical; ties break toward
        the earliest candidate.  Returns ``(winner, {candidate: seconds})``.
        """
        self._maybe_load_env()
        key = tuple(int(k) for k in key)
        hit = self._recorded.get(kernel, {}).get(key)
        if hit is not None:
            return hit, {}
        cands: list[Value] = []
        for c in candidates:
            c = tuple(int(v) for v in c)
            if c not in cands:
                cands.append(c)
        if not cands:
            raise ValueError("measured_search needs at least one candidate")
        timings = {
            c: measure_runtime(lambda c=c: runner(c), warmup=warmup,
                               repeats=repeats)
            for c in cands}
        winner = min(cands, key=timings.__getitem__)   # stable: first argmin
        self.record(kernel, key, winner)
        if persist:
            self.save()
        return winner, timings

    def recorded(self, kernel: str | None = None) -> dict:
        """The persistable (measured) entries, for inspection/tests."""
        if kernel is not None:
            return dict(self._recorded.get(kernel, {}))
        return {k: dict(v) for k, v in self._recorded.items()}

    def resolved(self, kernel: str) -> dict:
        """Every key of ``kernel`` looked up so far, with what it resolved
        to (the memo), for inspection."""
        return {k: v for (name, k), v in self._memo.items() if name == kernel}

    def clear(self, kernel: str | None = None) -> None:
        """Drop recorded entries (and memo) for one kernel, or all."""
        if kernel is None:
            self._recorded.clear()
            self._memo.clear()
        else:
            self._recorded.pop(kernel, None)
            self._memo = {mk: v for mk, v in self._memo.items()
                          if mk[0] != kernel}

    # -- persistence ---------------------------------------------------------
    @staticmethod
    def default_path() -> str | None:
        """The ``REPRO_AUTOTUNE_CACHE`` env path, or None when unset."""
        return os.environ.get(ENV_CACHE_PATH) or None

    @staticmethod
    def _read_file(path: str) -> Dict[str, Dict[Key, Value]]:
        """Parse a cache file into {kernel: {key: value}} ({} if absent or
        unreadable: tuning is advisory, never worth failing a run over)."""
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            return {}
        return {
            kernel: {tuple(int(x) for x in k.split(",")):
                     tuple(int(x) for x in v)
                     for k, v in entries.items()}
            for kernel, entries in data.get("recorded", {}).items()
        }

    def save(self, path: str | None = None) -> str | None:
        """Write recorded entries as JSON (``path=None``: the env default);
        returns the path written, or None when there is none.  Entries
        already in the file are kept; this registry's win on collisions."""
        path = path or self.default_path()
        if path is None:
            return None
        merged = self._read_file(path)
        for kernel, entries in self._recorded.items():
            merged.setdefault(kernel, {}).update(entries)
        payload = {
            kernel: {",".join(map(str, k)): list(v)
                     for k, v in entries.items()}
            for kernel, entries in merged.items() if entries
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "recorded": payload}, f, indent=0)
        os.replace(tmp, path)
        return path

    def load(self, path: str | None = None) -> int:
        """Merge a JSON cache file in (file entries win).  A missing file is
        a no-op.  Returns the entries loaded."""
        path = path or self.default_path()
        if path is None:
            return 0
        count = 0
        for kernel, entries in self._read_file(path).items():
            for k, v in entries.items():
                self.record(kernel, k, v)
                count += 1
        return count

    def _maybe_load_env(self) -> None:
        if not self._loaded_env:
            self._loaded_env = True
            self.load()


# The process-wide registry every kernel registers into.
REGISTRY = AutotuneRegistry()

__all__ = ["AutotuneRegistry", "REGISTRY", "ceil_to", "pow2_at_least",
           "pow2_bucket", "ENV_CACHE_PATH", "ENV_MEASURE", "SLEEP_CYCLES",
           "measure_enabled", "measure_runtime"]
