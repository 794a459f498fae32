"""One engine call under the program's span recorder
(``rbslam_tpu_torch.utils.profiling.recording``) and ``torch.profiler``,
joined: what the span readers (``metrics/engine.host_dispatch_*``,
``metrics/engine.step0_peak_gib``) read.

The spans and the profiler's events share one clock, ``time.time_ns()``.
A device operation belongs to the innermost span that holds the start of
the CUDA runtime call that launched it (matched by correlation id); an
idle gap of the device (between the union's busy intervals, and from the
root span's start to the first operation) to the innermost span that holds
its midpoint. The call is made once per ``ctx``, after the readers that
BENCHMARK.json lists before the span readers, with the draws
``noise("warm", 3)``; its per-phase table goes to stderr. Against a
program without the recorder it records nothing and each span reader
reads None.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.traffic import draws

RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside)"            # a point that no span of the call holds


class SpanCall(NamedTuple):
    spans: list      # the recorder's spans (name, id, parent, start_ns, ...)
    runtime: list    # (name, start_ns, end_ns, correlation): runtime calls
    device: list     # (name, start_ns, end_ns, correlation): device ops
    wall_s: float    # the call's wall, ending in a synchronize


class Phase:
    """What one span took, its children's share apart (``self``)."""

    __slots__ = ("wall_ns", "self_ns", "runtime_ns", "ops", "device_ns",
                 "idle_ns")

    def __init__(self):
        self.wall_ns = self.self_ns = self.runtime_ns = 0
        self.ops = self.device_ns = self.idle_ns = 0


def record_call(fn):
    """``fn()`` under recording() and a CUDA-activity profiler (as
    trace.traced_call; CPU activity where there is no card), with a device
    synchronize inside both. None where the program has no recorder or the
    call recorded no span."""
    try:
        from rbslam_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=activities) as prof, recording() as rec:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    return collect(rec.spans, prof, wall) if rec.spans else None


def _is_runtime(e) -> bool:
    """Whether a host event is a CUDA runtime or driver call: by its
    activity type where the profiler names it (torch 2.13), else by the
    APIs' names (``cuda*``, ``cu*``), annotations aside."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in RUNTIME_KINDS
    return not _is_annotation(e) and e.name().startswith("cu")


def _is_annotation(e) -> bool:
    """Whether an event is a ``record_function`` scope (on the host or its
    device annotation), not work."""
    return hasattr(e, "is_user_annotation") and e.is_user_annotation()


def collect(spans, prof, wall_s: float) -> SpanCall:
    """The spans with the CUDA runtime and driver calls and the device
    operations of a finished ``torch.profiler.profile`` (a device
    annotation of a ``record_function`` scope is not an operation)."""
    runtime, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (e.name(), start, start + e.duration_ns(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e):
                device.append(item)
        elif _is_runtime(e):
            runtime.append(item)
    return SpanCall(spans, runtime, device, wall_s)


def call_of(ctx):
    """The span call of the readers' ``ctx``, made at the first read, with
    its join (``ctx.span_phases``)."""
    if not hasattr(ctx, "span_call"):
        cell = ctx.cell
        noise = draws(cell.noise_shapes, cell.seed, "warm", 3, cell.device)
        ctx.span_call = record_call(lambda: cell.call(noise))
        if ctx.span_call is not None:
            ctx.span_phases = join(ctx.span_call)
            print(table(ctx.span_call, ctx.steps, ctx.span_phases),
                  file=sys.stderr)
    return ctx.span_call


def _columns(events):
    """start, end and correlation id of (name, start, end, corr) events as
    int64 arrays."""
    a = np.array([e[1:] for e in events], dtype=np.int64).reshape(-1, 3)
    return a[:, 0], a[:, 1], a[:, 2]


def _owner_of(spans):
    """points (an array of ns) -> the index in ``spans`` of the innermost
    span that holds each, -1 where none does. Spans nest or are disjoint,
    and a span's id is its index."""
    bounds = []
    for s in spans:
        bounds.append((s.start_ns, 1, s.id))
        bounds.append((s.end_ns, 0, -s.id))      # inner spans close first
    bounds.sort()
    stack, times, owners = [], [], []
    for t, opens, sid in bounds:
        if opens:
            stack.append(sid)
        else:
            stack.remove(-sid)
        times.append(t)
        owners.append(stack[-1] if stack else -1)
    times = np.asarray(times, dtype=np.int64)
    owners = np.asarray(owners + [-1], dtype=np.int64)

    def owner_of(points):
        i = np.searchsorted(times, points, side="right") - 1
        return owners[i]                     # i = -1 reads the last: -1
    return owner_of


def _launch_starts(r_start, r_corr, d_corr):
    """For each device op (correlation ids ``d_corr``), the start of the
    runtime call with its correlation id (-1: none)."""
    if not len(r_corr):
        return np.full(len(d_corr), -1, dtype=np.int64)
    order = np.argsort(r_corr, kind="stable")
    r_corr, r_start = r_corr[order], r_start[order]
    i = np.minimum(np.searchsorted(r_corr, d_corr), len(r_corr) - 1)
    return np.where(r_corr[i] == d_corr, r_start[i], -1)


def device_owners(call: SpanCall) -> list:
    """For each device op of the call, the innermost span (id) that holds
    the start of the runtime call that launched it (the same correlation
    id); OUTSIDE where no span does or no runtime call matches."""
    r_start, _, r_corr = _columns(call.runtime)
    d_corr = _columns(call.device)[2]
    starts = _launch_starts(r_start, r_corr, d_corr)
    owners = np.where(starts < 0, -1, _owner_of(call.spans)(starts))
    return [OUTSIDE if o < 0 else int(o) for o in owners]


def join(call: SpanCall) -> dict:
    """{span id (or OUTSIDE): Phase}: each device op, runtime call and idle
    gap put down to the innermost span that holds it; ``wall_ns`` and
    ``self_ns`` from the spans themselves. A runtime call made inside
    another is counted once, in the outer call."""
    spans = call.spans
    n = len(spans)
    owner_of = _owner_of(spans)

    def by_owner(owner_idx, values):
        """Sums of ``values`` by owner; index n holds OUTSIDE's."""
        return np.bincount(np.where(owner_idx < 0, n, owner_idx),
                           weights=values, minlength=n + 1).astype(np.int64)

    r_start, r_end, r_corr = _columns(call.runtime)
    d_start, d_end, d_corr = _columns(call.device)
    launch = _launch_starts(r_start, r_corr, d_corr)
    d_owner = np.where(launch < 0, -1, owner_of(launch))
    ops = by_owner(d_owner, np.ones(len(d_start)))
    device = by_owner(d_owner, d_end - d_start)

    order = np.lexsort((-r_end, r_start))
    r_start, r_end = r_start[order], r_end[order]
    before = np.maximum.accumulate(np.concatenate(([np.iinfo(np.int64).min],
                                                   r_end)))[:-1]
    outer = r_start >= before                # nested in no earlier call
    runtime = by_owner(owner_of(r_start[outer]), r_end[outer] - r_start[outer])

    # idle gaps: between the union's busy intervals, and before the first
    order = np.argsort(d_start, kind="stable")
    s_sorted, e_sorted = d_start[order], d_end[order]
    reach = np.maximum.accumulate(e_sorted)  # busy until, after op i
    g0, g1 = reach[:-1], s_sorted[1:]
    gap = g1 > g0
    g0, g1 = g0[gap], g1[gap]
    roots = [s.start_ns for s in spans if s.parent is None]
    if len(s_sorted) and roots and min(roots) < s_sorted[0]:
        g0 = np.concatenate(([min(roots)], g0))
        g1 = np.concatenate(([s_sorted[0]], g1))
    idle = by_owner(owner_of((g0 + g1) // 2), g1 - g0)

    phases = {}
    for s in spans:
        p = phases.setdefault(s.id, Phase())
        p.wall_ns = s.end_ns - s.start_ns
        p.self_ns += p.wall_ns
        if s.parent is not None:
            phases.setdefault(s.parent, Phase()).self_ns -= p.wall_ns
    for k in range(n + 1):
        if k == n and not (runtime[k] or ops[k] or idle[k]):
            continue
        p = phases.setdefault(OUTSIDE if k == n else k, Phase())
        p.runtime_ns, p.ops = int(runtime[k]), int(ops[k])
        p.device_ns, p.idle_ns = int(device[k]), int(idle[k])
    return phases


def _subtree_sum(call, phases, field):
    """{span id: ``field`` summed over the span and its descendants}."""
    total = {s.id: getattr(phases.get(s.id, Phase()), field)
             for s in call.spans}
    for s in reversed(call.spans):          # children after their parents
        if s.parent is not None:
            total[s.parent] += total[s.id]
    return total


def host_dispatch_ms(call: SpanCall, phases=None) -> float:
    """The root spans' wall less the time inside the CUDA runtime and
    driver calls that started within them, in ms: the host's own Python
    and ATen work."""
    phases = join(call) if phases is None else phases
    runtime = _subtree_sum(call, phases, "runtime_ns")
    roots = [s for s in call.spans if s.parent is None]
    return sum(s.end_ns - s.start_ns - runtime[s.id] for s in roots) * 1e-6


def peak_gib(call: SpanCall, name: str):
    """The largest high-water mark that a span ``name`` recorded, GiB;
    None where none did."""
    peaks = [s.peak_bytes for s in call.spans
             if s.name == name and s.peak_bytes is not None]
    return max(peaks) / 2**30 if peaks else None


def _path(spans, s):
    names = []
    while s is not None:
        names.append(s.name)
        s = None if s.parent is None else spans[s.parent]
    return "/".join(reversed(names))


def table(call: SpanCall, steps: int, phases=None) -> str:
    """Per phase (the spans' name paths from the root), ms and ops a step:
    wall and self time, runtime calls, device ops and their device time,
    device idle time, the port's launches and the largest peak; then the
    shares of device and idle time held below the root spans."""
    phases = join(call) if phases is None else phases
    spans = {s.id: s for s in call.spans}
    rows = defaultdict(lambda: [0, Phase(), defaultdict(int), None])
    for s in call.spans:
        row = rows[_path(spans, s)]
        row[0] += 1
        p = phases.get(s.id, Phase())
        for f in Phase.__slots__:
            setattr(row[1], f, getattr(row[1], f) + getattr(p, f))
        for k, v in s.launches.items():
            row[2][k] += v
        if s.peak_bytes is not None:
            row[3] = max(row[3] or 0, s.peak_bytes)
    out = [f"spans: {len(call.spans)} spans, {len(call.device)} device ops, "
           f"{len(call.runtime)} runtime calls, wall {call.wall_s:.4f} s; "
           "ms a step (ops a step) over "
           f"{steps} steps; self, runtime, ops, device and idle exclude "
           "the children",
           f"{'phase':<28}{'n':>6}{'wall':>9}{'self':>9}{'runtime':>9}"
           f"{'ops':>9}{'device':>9}{'idle':>9}  launches, peak GiB"]
    for path, (n, p, launches, peak) in rows.items():
        out.append(
            f"{path:<28}{n:>6}{p.wall_ns * 1e-6 / steps:>9.4f}"
            f"{p.self_ns * 1e-6 / steps:>9.4f}"
            f"{p.runtime_ns * 1e-6 / steps:>9.4f}{p.ops / steps:>9.2f}"
            f"{p.device_ns * 1e-6 / steps:>9.4f}"
            f"{p.idle_ns * 1e-6 / steps:>9.4f}  {dict(launches) or ''}"
            + ("" if peak is None else f" {peak / 2**30:.3f}"))
    out_p = phases.get(OUTSIDE, Phase())
    out.append(f"{OUTSIDE:<28}{'':>6}{'':>9}{'':>9}"
               f"{out_p.runtime_ns * 1e-6 / steps:>9.4f}"
               f"{out_p.ops / steps:>9.2f}"
               f"{out_p.device_ns * 1e-6 / steps:>9.4f}"
               f"{out_p.idle_ns * 1e-6 / steps:>9.4f}")
    roots = {s.id for s in call.spans if s.parent is None}
    below = [p for k, p in phases.items() if k != OUTSIDE and k not in roots]
    dev = sum(p.device_ns for p in phases.values())
    idle = sum(p.idle_ns for p in phases.values())
    out.append(
        f"device time below the root spans {sum(p.device_ns for p in below)}"
        f" of {dev} ns ({sum(p.device_ns for p in below) / max(dev, 1):.4f})"
        f"; idle {sum(p.idle_ns for p in below)} of {idle} ns "
        f"({sum(p.idle_ns for p in below) / max(idle, 1):.4f}); host "
        f"dispatch {host_dispatch_ms(call, phases) / steps:.4f} ms a step")
    return "\n".join(out)
