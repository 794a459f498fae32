"""One engine call under ``torch.profiler`` and one under the host-device
sync counter, reduced to what the per-layer readers (``metrics/``) and the
result's ``breakdown`` read.
"""

from __future__ import annotations

import bisect
import linecache
import time
import warnings
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


class Trace(NamedTuple):
    device: list        # (name, start_us, end_us) of every device operation
    host: list          # (name, start_us, end_us) of every host operation
    wall_s: float       # the traced call's wall, ending in a synchronize
    out: object         # what the call returned


def traced_call(fn) -> Trace:
    """Run ``fn()`` under the profiler, with a device synchronize inside the
    traced interval. CUDA activity only: the device's operations and the
    host's CUDA runtime calls. With CPU activity too, a smoother call's
    6.9 million events took 74 s to stop and 30 s to read on the card's
    host, beside the call's 44 s."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    # the raw events: building prof.events() takes about 60 us an event
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-3
        item = (e.name(), start, start + e.duration_ns() * 1e-3)
        (dev if e.device_type() == DeviceType.CUDA else host).append(item)
    return Trace(dev, host, wall, out)


def count_syncs(fn) -> dict:
    """Host-device synchronizations during one call of ``fn``, by call site
    ("file:line" of the frame that synchronized), each with its count and
    source line: the warnings of ``torch.cuda.set_sync_debug_mode("warn")``
    (a copy of the port's workloads/profile_dense_mag.py::count_syncs)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        site = f"{w.filename.split('rbslam_tpu_torch/')[-1]}:{w.lineno}"
        if site not in sites:
            sites[site] = [0, linecache.getline(w.filename, w.lineno).strip()]
        sites[site][0] += 1
    return sites


def union(intervals) -> list:
    """Disjoint sorted (start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(trace: Trace) -> float:
    """Microseconds in which some operation ran on the device."""
    return sum(e - s for s, e in union((s, e) for _, s, e in trace.device))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time (seconds, summed by
    name) and the device's idle gaps, summed by the outermost host event
    (a CUDA runtime call) running at each gap's middle ("host python"
    where none ran: the host between two calls)."""
    by_op = defaultdict(float)
    for name, s, e in trace.device:
        by_op[name] += (e - s) * 1e-6
    outer = []                       # host operations nested in no other
    for name, s, e in sorted(trace.host, key=lambda h: (h[1], -h[2])):
        if not outer or s >= outer[-1][2]:
            outer.append((name, s, e))
    starts = [s for _, s, _ in outer]
    busy = union((s, e) for _, s, e in trace.device)
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = outer[i][0] if i >= 0 and outer[i][2] >= mid else "host python"
        gaps[name] += (s1 - e0) * 1e-6

    def top_of(d):
        return [[k, v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(gaps)}
