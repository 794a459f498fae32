"""Profiling and observability helpers (port of rbslam_tpu/utils/profiling.py).

Named scopes per engine phase for ``torch.profiler`` (and NVTX once CUDA
is initialised), a Chrome trace of a block of work, and a host-side
throughput meter for the particle-steps/s metric.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def phase_annotation(name: str):
    """Named scope visible in ``torch.profiler`` traces, and as an NVTX range
    once CUDA is initialised (a CPU-only build has no NVTX)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class ThroughputMeter:
    """Accumulates particle-steps and wall time. Work on a CUDA device is
    queued, so the caller synchronizes (``torch.cuda.synchronize()``)
    before ``stop``; without that the meter times the launches."""

    def __init__(self):
        self.particle_steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, n_particles: int, n_steps: int):
        self.elapsed += time.perf_counter() - self._t0
        self.particle_steps += n_particles * n_steps
        self._t0 = None

    @property
    def particle_steps_per_s(self) -> float:
        return self.particle_steps / self.elapsed if self.elapsed else 0.0


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
