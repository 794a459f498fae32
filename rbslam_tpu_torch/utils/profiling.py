"""Engine-phase spans and a Chrome trace of a block of work (port of
rbslam_tpu/utils/profiling.py).

The engines name their phases with :func:`phase_annotation` (the root span
of a call, its steps, and the resampling, dynamics, Jacobian, update and
rebase inside a step). Inside a :func:`recording` block each such phase is
kept as a :class:`Span` on the host clock that ``torch.profiler`` stamps
its events with (``time.time_ns()``), so a span and a profiled device
operation or CUDA runtime call compare directly. While a profiler is
active a phase is also a ``torch.profiler`` scope (``record_function``).
With neither, :func:`phase_annotation` returns one shared no-op context:
it reads no clock and calls nothing in torch.

Recording is per process: on a device mesh each rank records its own
spans.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from ..kernels import _lib

_NOOP = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None     # the open recording() block's


class Span:
    """One phase of an engine call. ``id`` is the span's index in
    ``Recorder.spans`` (spans are kept in the order they open, so a parent
    comes before its children); ``parent`` is the enclosing span's id
    (None for the root of an engine call) and ``call`` the root's id.
    ``start_ns``/``end_ns`` are ``time.time_ns()`` at entry and exit;
    ``launches`` the port kernels launched inside (``kernels/_lib.py``'s
    counters, nonzero entries); ``peak_bytes`` the allocator's high-water
    mark inside a span opened with ``memory_of`` a CUDA device, else
    None; ``k2_p_reads``, on the root span of a call, the P_base matrices
    that K2's float32 form read in the call (counted on the device, filled
    when the recording ends; None on every other span)."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start_ns",
                 "end_ns", "launches", "peak_bytes", "k2_p_reads")

    def __init__(self, name, attrs, id_, parent, call):
        self.name, self.attrs, self.id = name, attrs, id_
        self.parent, self.call = parent, call
        self.start_ns = self.end_ns = None
        self.launches, self.peak_bytes, self.k2_p_reads = {}, None, None


class Recorder:
    """The spans of one :func:`recording` block, in the order they opened,
    and K2's count of P_base reads: one device int64 a call, read back
    once, when the recording ends."""

    def __init__(self):
        self.spans: list = []
        self.open: list = []          # the spans entered and not yet left
        self._k2_reads: dict = {}     # call id -> int64 on the device

    def k2_reads_counter(self, device) -> int:
        """The address of the open call's device int64 that K2 adds the
        P_base matrices it read to (0 outside every span: nothing is
        counted)."""
        if not self.open:
            return 0
        call = self.open[-1].call
        if call not in self._k2_reads:
            self._k2_reads[call] = torch.zeros((), dtype=torch.int64,
                                               device=device)
        return self._k2_reads[call].data_ptr()

    def _read_counters(self) -> None:
        """The calls' counts into their root spans (one copy to the
        host)."""
        if self._k2_reads:
            values = torch.stack(list(self._k2_reads.values())).tolist()
            for call, value in zip(self._k2_reads, values):
                self.spans[call].k2_p_reads = value


class _Phase:
    """The context of one phase while recording or profiling."""

    __slots__ = ("name", "attrs", "memory_of", "rec", "scope", "span",
                 "before")

    def __init__(self, name, attrs, memory_of, rec):
        self.name, self.attrs, self.rec = name, attrs, rec
        self.memory_of = (memory_of if rec is not None
                          and memory_of is not None
                          and torch.device(memory_of).type == "cuda"
                          else None)
        self.scope = self.span = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.scope = torch.profiler.record_function(self.name)
            self.scope.__enter__()
        rec = self.rec
        if rec is not None:
            parent = rec.open[-1] if rec.open else None
            span = Span(self.name, self.attrs, len(rec.spans),
                        None if parent is None else parent.id,
                        len(rec.spans) if parent is None else parent.call)
            rec.spans.append(span)
            rec.open.append(span)
            self.span = span
            if self.memory_of is not None:
                torch.cuda.reset_peak_memory_stats(self.memory_of)
            self.before = _lib.launch_counts()
            span.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        span = self.span
        if span is not None:
            span.end_ns = time.time_ns()
            span.launches = {k: v - self.before[k]
                             for k, v in _lib.launch_counts().items()
                             if v != self.before[k]}
            if self.memory_of is not None:
                # max_memory_allocated() flattens every statistic in Python
                # first: 101 µs a read on the card's host, this 18 µs
                span.peak_bytes = torch.cuda.memory_stats_as_nested_dict(
                    self.memory_of)["allocated_bytes"]["all"]["peak"]
            self.rec.open.pop()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        return False


def phase_annotation(name: str, *, memory_of=None, **attrs):
    """Context of one engine phase named ``name``, with ``attrs`` (the step
    ``t``, the sweep ``k``) kept on its span. Inside :func:`recording` it
    appends a :class:`Span` to the recorder; while a ``torch.profiler`` is
    active it opens ``record_function(name)``; with neither it is one
    shared no-op. ``memory_of`` (a device) marks an engine's top-level
    phase: while recording on a CUDA device its span keeps the allocator's
    high-water mark reached inside it (the peak counter is reset at entry,
    so such phases do not nest)."""
    rec = _recorder
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Phase(name, attrs, memory_of, rec)


@contextlib.contextmanager
def recording():
    """Record the spans of the engine calls inside the block: yields a
    :class:`Recorder` whose ``spans`` fill as the phases run. Off by
    default; a block inside another raises RuntimeError. Spans nest by the
    order they open, so a block records one thread's calls. Recording
    resets the CUDA allocator's peak counter (``torch.cuda.
    reset_peak_memory_stats``) at the entry of each top-level phase, so a
    caller that reads ``max_memory_allocated()`` over a recorded call reads
    its last such phase's peak. K2 counts the P_base matrices it reads on
    the device, one counter a call; the counts reach the host once, as the
    block ends, in the root spans' ``k2_p_reads``."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("recording() is already on in this process")
    rec = _recorder = Recorder()
    _lib._k2_reads_counter = rec.k2_reads_counter
    try:
        yield rec
    finally:
        _recorder = None
        _lib._k2_reads_counter = None
        rec._read_counters()


def spanned(name: str):
    """Decorator: run each call of the function inside
    ``phase_annotation(name)`` (an engine's root span)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with phase_annotation(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def trace_to(logdir: str):
    """Context manager: profile the block (host ops, and the card's kernels
    when CUDA is available) and write a Chrome trace
    (``*.pt.trace.json``, viewable in Perfetto or TensorBoard) under
    ``logdir``. Yields the ``torch.profiler.profile``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
