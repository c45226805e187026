"""Device timing and profiler reductions (the yardstick's copies).

``gpu_ms``, ``device_busy`` and ``device_time_by_kind`` are copies of the
sound helpers of ``chip_smoke.py``; the program may change, these may not.
Each takes ``torch`` as its first argument so that importing this module
loads nothing.  A reduction of a profile with no device record returns
nothing: there is no card to speak of, and no number is made up.
"""

from __future__ import annotations

import numpy as np


def gpu_ms(torch, fn, reps: int = 20, warmup: int = 2,
           sleep_cycles: int = 1_000_000) -> float:
    """Median device time (ms) of ``fn``'s launches, by CUDA events.  A
    sleep kernel queued ahead of the start event lets the host enqueue all
    of ``fn``'s launches before the device reaches them, so host launch
    overhead does not show as device time (as long as the host finishes
    within the sleep and ``fn`` never waits for the device)."""
    if not torch.cuda.is_available():
        raise RuntimeError("gpu_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


WINDOW_MARK = "perfbench.slice"
# host records of the profiler's own work, which cover no work of the run
PROFILER_RECORDS = ("Activity Buffer Request",)


def _device_events(torch, prof):
    """The device records: kernels, copies and memsets.  A
    ``record_function`` also leaves an annotation on the device's timeline
    under its own name, which covers no device work: the window's mark is
    left out."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != WINDOW_MARK]


def device_busy(torch, prof) -> tuple:
    """The union of the device intervals (kernels, copies) a
    ``torch.profiler`` run recorded, in us, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(torch, prof))
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us, len(spans)


def device_time_by_kind(torch, prof) -> tuple:
    """The device time (us, summed) and the records a ``torch.profiler``
    run recorded, by kind (kernels, host-to-device copies from pageable and
    from pinned memory, other copies, memsets), and each kernel's time by
    name."""
    out, names = {}, {}
    for e in _device_events(torch, prof):
        if e.name.startswith("Memcpy HtoD"):
            kind = "htod_pageable" if "Pageable" in e.name else "htod_pinned"
        elif e.name.startswith("Memcpy"):
            kind = "copy_other"
        elif e.name.startswith("Memset"):
            kind = "memset"
        else:
            kind = "kernel"
        dur = e.time_range.end - e.time_range.start
        us, n = out.get(kind, (0.0, 0))
        out[kind] = (us + dur, n + 1)
        if kind == "kernel":
            names[e.name] = names.get(e.name, 0.0) + dur
    return ({kind: {"us": us, "records": n} for kind, (us, n) in out.items()},
            names)


def _merge(intervals):
    """Sorted, merged copy of ``[(lo, hi), ...]``."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_gaps(busy, window):
    """The gaps of ``window`` (lo, hi) that no interval of ``busy`` (merged)
    covers."""
    lo, hi = window
    gaps, t = [], lo
    for b0, b1 in busy:
        if b0 > t:
            gaps.append((t, min(b0, hi)))
        t = max(t, b1)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def gap_causes(gaps, host) -> dict:
    """Idle seconds by what the host was doing: each gap goes to the
    narrowest host op (``host`` = sorted ``(start, end, name)``) that covers
    its midpoint and at least half of it, or to ``"host_outside_ops"``
    (Python between ops).  One sweep: the gaps are disjoint and sorted."""
    out: dict = {}
    i, active = 0, []
    for a, b in gaps:
        m, need = 0.5 * (a + b), 0.5 * (b - a)
        while i < len(host) and host[i][0] <= m:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= m]
        best, best_len = "host_outside_ops", float("inf")
        for h0, h1, name in active:
            if min(b, h1) - max(a, h0) >= need and h1 - h0 < best_len:
                best, best_len = name, h1 - h0
        out[best] = out.get(best, 0.0) + (b - a)
    return out


def breakdown(torch, prof, top: int = 10) -> dict | None:
    """The result line's ``breakdown`` from a profile of a slice of the
    window: the ``top`` device ops by time (kernels by name, copies and
    memsets by kind) and the ``top`` causes of the card's idle gaps by
    what the host was doing.  The slice is the host record named
    ``WINDOW_MARK`` (a ``record_function`` around it).  ``None`` when the
    profile holds no device record."""
    dev = _device_events(torch, prof)
    marks = [e for e in prof.events() if e.name == WINDOW_MARK
             and e.device_type != torch.autograd.DeviceType.CUDA]
    if not dev or not marks:
        return None
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    busy = _merge([(max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in dev if e.time_range.end > lo
                   and e.time_range.start < hi])
    kinds, names = device_time_by_kind(torch, prof)
    ops = list(names.items()) + [(kind, kinds[kind]["us"]) for kind in
                                 ("htod_pageable", "htod_pinned",
                                  "copy_other", "memset") if kind in kinds]
    ops = sorted(ops, key=lambda kv: -kv[1])[:top]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CUDA
                  and e.name != WINDOW_MARK
                  and e.name not in PROFILER_RECORDS
                  and e.time_range.end > e.time_range.start)
    causes = gap_causes(idle_gaps(busy, (lo, hi)), host)
    gaps = sorted(causes.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": [[n, us * 1e-6] for n, us in gaps]}


__all__ = ["WINDOW_MARK", "gpu_ms", "device_busy", "device_time_by_kind", "idle_gaps",
           "gap_causes", "breakdown"]
