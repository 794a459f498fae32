"""The join of the program's phase spans with a profiled call
(spans.py) on a hand-made trace: device ops by the runtime call that
launched them (correlation ids), idle gaps by their midpoint, each to the
innermost span; the span readers' values, and None where the call
recorded no spans or the program has no recorder."""

import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import spans, spec
from benchmark.spans import OUTSIDE, SpanCall


def _span(id_, parent, name, start, end, peak=None):
    return SimpleNamespace(id=id_, parent=parent, name=name, start_ns=start,
                           end_ns=end, peak_bytes=peak, launches={},
                           attrs={}, call=0)


SPANS = [_span(0, None, "rbpf", 0, 100),
         _span(1, 0, "step0", 0, 20, peak=5 * 2**30),
         _span(2, 0, "loop", 20, 90),
         _span(3, 2, "step", 20, 50),
         _span(4, 3, "update", 30, 45),
         _span(5, 2, "step", 50, 80),
         _span(6, 5, "update", 60, 75),
         _span(7, 0, "finish", 90, 100)]
RUNTIME = [("cudaLaunchKernel", 5, 7, 1),
           ("cudaLaunchKernel", 32, 34, 2),
           ("cudaLaunchKernel", 40, 41, 3),
           ("cudaMemcpyAsync", 52, 55, 4),
           ("cudaLaunchKernel", 61, 64, 5),
           ("cuLaunchKernel", 62, 63, 6),       # inside the call above
           ("cudaLaunchKernel", 95, 96, 7),
           ("cudaStreamSynchronize", 101, 120, 0)]
DEVICE = [("k1", 10, 30, 1),          # runs after its launch's span ended
          ("k2", 35, 40, 2),
          ("k3", 40, 48, 3),
          ("Memcpy HtoD", 56, 60, 4),
          ("k5", 70, 80, 5),
          ("k6", 82, 85, 6),
          ("k7", 97, 110, 7),
          ("k8", 111, 112, 99)]       # no runtime call with its id
CALL = SpanCall(SPANS, RUNTIME, DEVICE, 0.0)


def test_device_ops_go_to_the_span_of_their_launch():
    assert spans.device_owners(CALL) == [1, 4, 4, 5, 6, 6, 7, OUTSIDE]


def test_join_puts_ops_runtime_and_idle_in_the_innermost_span():
    ph = spans.join(CALL)
    got = {k: (p.ops, p.device_ns, p.runtime_ns, p.idle_ns)
           for k, p in ph.items()}
    assert got == {
        0: (0, 0, 0, 0),
        1: (1, 20, 2, 10),        # the leading gap [0, 10]
        2: (0, 0, 0, 2),          # gap [80, 82]: between the loop's steps
        3: (0, 0, 0, 0),
        4: (2, 13, 3, 5),         # gap [30, 35], midpoint 32
        5: (1, 4, 3, 8),          # gap [48, 56], midpoint 52
        6: (2, 13, 3, 10),        # the nested driver call counted once
        7: (1, 13, 1, 12),        # gap [85, 97], midpoint 91
        OUTSIDE: (1, 1, 19, 1),   # the sync after the root; gap [110, 111]
    }
    assert {k: (p.wall_ns, p.self_ns) for k, p in ph.items()
            if k in (0, 2, 3)} == {0: (100, 0), 2: (70, 10), 3: (30, 15)}


def test_equal_bounds_close_the_inner_span_first():
    touching = [_span(0, None, "rbps", 0, 10), _span(1, 0, "setup", 0, 10),
                _span(2, None, "rbps", 10, 20)]
    owner_of = spans._owner_of(touching)
    points = np.array([0, 5, 10, 15, 25, -1])
    assert owner_of(points).tolist() == [1, 1, 2, 2, -1, -1]


def test_readers_on_the_hand_made_call():
    ctx = SimpleNamespace(steps=2, span_call=CALL)

    def read(name):
        return spec.reader(name).read(ctx)

    # the root's wall less its runtime calls (12 ns), per step, in ms
    assert read("engine.host_dispatch_ms_per_step") == pytest.approx(44e-6)
    assert read("engine.host_dispatch_ms_per_step.host") == \
        pytest.approx(44e-6)
    assert read("engine.step0_peak_gib") == pytest.approx(5.0)
    no_step0 = SpanCall(SPANS[:1], RUNTIME, DEVICE, 0.0)
    assert spec.reader("engine.step0_peak_gib").read(
        SimpleNamespace(steps=2, span_call=no_step0)) is None
    table = spans.table(CALL, 2)
    assert "rbpf/loop/step/update" in table and OUTSIDE in table


@pytest.mark.parametrize("name", ["engine.host_dispatch_ms_per_step",
                                  "engine.host_dispatch_ms_per_step.host",
                                  "engine.step0_peak_gib"])
def test_readers_read_none_without_spans(name, monkeypatch):
    assert spec.reader(name).read(
        SimpleNamespace(steps=2, span_call=None)) is None
    # a call that records no span
    assert spans.record_call(lambda: None) is None
    # a program without the recorder (the parent of the span readers)
    monkeypatch.setitem(sys.modules, "rbslam_tpu_torch.utils.profiling",
                        types.ModuleType("rbslam_tpu_torch.utils.profiling"))
    assert spans.record_call(lambda: None) is None


class _Event:
    """A profiler event of torch 2.11, which names no activity type."""

    def __init__(self, name, device, annotation=False, start=0, dur=1,
                 corr=0):
        self._v = (name, device, annotation, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def test_collect_without_activity_types():
    from torch.autograd import DeviceType

    events = [_Event("cudaLaunchKernel", DeviceType.CPU, corr=5),
              _Event("cuLaunchKernel", DeviceType.CPU, corr=6),
              _Event("aten::add", DeviceType.CPU),
              _Event("update", DeviceType.CPU, annotation=True),
              _Event("update", DeviceType.CUDA, annotation=True),
              _Event("k", DeviceType.CUDA, start=3, dur=2, corr=5)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    call = spans.collect([], prof, 1.0)
    assert [e[0] for e in call.runtime] == ["cudaLaunchKernel",
                                            "cuLaunchKernel"]
    assert call.device == [("k", 3, 5, 5)]
