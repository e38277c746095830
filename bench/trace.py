"""Profiler arithmetic: device busy time, launches by name, idle gaps.

Copied from ``chip_smoke.py``'s ``busy_share`` and extended: the busy time
is the union of the device's operation intervals (kernels, copies and
memsets, which may overlap), not their sum; a kernel launch is a device
event that is not a copy or a memset; an idle gap is a stretch of the
traced window in which no device operation ran, named by the innermost
host event running when it began.

All times here are in the profiler's clock (nanoseconds); the functions
take plain ``(name, start, end)`` tuples so that they can be tested
without a device.
"""
from __future__ import annotations

import collections

#: the harness's span around the traced batches: its bounds are the window
WINDOW_SPAN = "bench.traced_window"
#: top entries kept in each list of the breakdown
TOP = 10


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def busy_intervals(events):
    """Merged ``[start, end]`` intervals of ``(name, start, end)`` events."""
    merged = []
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_gaps(busy, lo: float, hi: float):
    """``(start, end)`` stretches of ``[lo, hi]`` outside the busy intervals."""
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def name_gaps(gaps, host):
    """Seconds of idle device time by the innermost host event running when
    each gap began (``"host python"`` where none ran). ``host`` holds the
    ``(name, start, end)`` events of one thread, which nest."""
    out = collections.Counter()
    stack, i = [], 0
    host = sorted(host, key=lambda ev: (ev[1], -ev[2]))
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][1] <= g0:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= g0:
            stack.pop()
        out[stack[-1][0] if stack else "host python"] += (g1 - g0) / 1e9
    return out


def top(counter, n: int = TOP):
    return [[name, seconds] for name, seconds in counter.most_common(n)]


def summarize(device, host, window):
    """The traced window's numbers from ``(name, start_ns, end_ns)`` device
    and host events and the window's ``(start_ns, end_ns)``: busy and
    window seconds, kernel launches, and the breakdown's two lists."""
    lo, hi = window
    device = [ev for ev in device if ev[2] > lo and ev[1] < hi]
    busy = busy_intervals(device)
    busy_s = sum(min(e, hi) - max(s, lo) for s, e in busy) / 1e9
    per_op = collections.Counter()
    for name, s, e in device:
        per_op[name[:120]] += (e - s) / 1e9
    return {
        "busy_s": busy_s,
        "window_s": (hi - lo) / 1e9,
        "kernel_launches": sum(1 for ev in device if not is_copy(ev[0])),
        "device_ops": top(per_op),
        "idle_gaps": top(name_gaps(idle_gaps(busy, lo, hi), host)),
    }


def from_profiler(prof):
    """``summarize`` of a ``torch.profiler`` session that holds one
    ``WINDOW_SPAN`` span, read from its raw events (building the profiler's
    event tree takes seconds a batch): the device's operations (user
    annotations mirrored onto the device's timeline are not operations),
    and the host events of the span's thread."""
    device, host, window, thread = [], [], None, None
    events = prof.profiler.kineto_results.events()
    for ev in events:
        if ev.name() == WINDOW_SPAN and not _on_device(ev):
            window, thread = (ev.start_ns(), ev.end_ns()), ev.start_thread_id()
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN} span")
    for ev in events:
        item = (ev.name(), ev.start_ns(), ev.end_ns())
        if _on_device(ev):
            if not ev.is_user_annotation():
                device.append(item)
        elif ev.start_thread_id() == thread and ev.name() != WINDOW_SPAN:
            host.append(item)
    return summarize(device, host, window)


def _on_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")
