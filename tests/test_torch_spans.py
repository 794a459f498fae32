"""The engines' phase spans (utils/profiling.py): the shared no-op with
recording off, results unchanged with it on, the span tree of the filter
(lowrank, block_gather, xla) and of the smoothers, launch and peak
counters, and the clock shared with ``torch.profiler``, on the CPU at a
small size (the kernels' plain versions)."""

import bisect
import ctypes
import math

import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu_torch.engines import (  # noqa: E402
    RBPFConfig,
    RBPSConfig,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from rbslam_tpu_torch.kernels import _lib  # noqa: E402
from rbslam_tpu_torch.utils import phase_annotation, recording  # noqa: E402
from rbslam_tpu_torch.utils import profiling  # noqa: E402
from rbslam_tpu_torch.workloads.dense_mag import build_problem  # noqa: E402

T, N, PERIOD, SWEEPS = 12, 8, 4, 3
FILTER_CHILDREN = ["resample", "dynamics", "jacobian", "update", "weights"]


@pytest.fixture(scope="module")
def problem():
    prob, _ = build_problem(29, T, seed=1, m_sim=64, device="cpu")
    return prob


def _filter(problem, kf_kernel):
    cfg = RBPFConfig(n_particles=N, resampling="systematic",
                     kf_kernel=kf_kernel, lowrank_period=PERIOD)
    return run_rbpf(*problem.rbpf_args(), cfg,
                    generator=torch.Generator().manual_seed(3), device="cpu")


def _smoother(problem, run=run_rbps_information_form, **kw):
    return run(*problem.rbpf_args(), RBPSConfig(N, SWEEPS),
               generator=torch.Generator().manual_seed(4), device="cpu",
               **kw)


CALLS = {
    "lowrank": lambda p: _filter(p, "lowrank"),
    "block_gather": lambda p: _filter(p, "block_gather"),
    "xla": lambda p: _filter(p, "xla"),
    "info_form": _smoother,
}


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_path_is_the_shared_noop_and_records_nothing():
    assert profiling._recorder is None
    a = phase_annotation("step", memory_of=torch.device("cpu"), t=3)
    assert a is phase_annotation("update") is profiling._NOOP
    with a as entered:
        assert entered is None
    with recording() as rec:
        pass
    assert rec.spans == [] and profiling._recorder is None


def test_off_path_reads_no_clock_and_calls_no_torch(monkeypatch):
    """With recording and the profiler off a phase reads no clock, no
    launch counter and no allocator statistic, and opens no profiler
    scope (its cost, about 0.4 µs, is `benchmark/span_cost.py --off`'s)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the off path called it")

    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(profiling._lib, "launch_counts", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", refuse)
    monkeypatch.setattr(torch, "device", refuse)
    with phase_annotation("step0", memory_of="cuda", t=0):
        with phase_annotation("update"):
            pass


def test_recording_inside_recording_raises():
    with recording():
        with pytest.raises(RuntimeError, match="already on"):
            with recording():
                pass
    assert profiling._recorder is None


@pytest.mark.parametrize("path", list(CALLS))
def test_recording_leaves_the_results_equal(problem, path):
    off = CALLS[path](problem)
    with recording() as rec:
        on = CALLS[path](problem)
    assert rec.spans
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("path", list(CALLS))
def test_one_root_and_children_inside_their_parents(problem, path):
    with recording() as rec:
        CALLS[path](problem)
    spans = rec.spans
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == \
        ["rbps" if path == "info_form" else "rbpf"]
    root = roots[0]
    assert [s.id for s in spans] == list(range(len(spans)))
    for s in spans:
        assert s.call == root.id and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.id < s.id
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for s in spans:           # siblings do not overlap
        kids = _children(spans, s)
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("path", ["lowrank", "block_gather", "xla"])
def test_filter_spans(problem, path):
    with recording() as rec:
        CALLS[path](problem)
    root = rec.spans[0]
    top = [s.name for s in _children(rec.spans, root)]
    assert top == ["step0", "loop", "finish"]
    loop = _children(rec.spans, rec.spans[2])
    steps = [s for s in loop if s.name == "step"]
    assert [s.attrs["t"] for s in steps] == list(range(1, T))
    for s in steps:
        assert [c.name for c in _children(rec.spans, s)] == FILTER_CHILDREN
    rebases = [s for s in loop if s.name == "rebase"]
    assert len(rebases) == (math.ceil((T - 1) / PERIOD)
                            if path == "lowrank" else 0)
    assert len(loop) == len(steps) + len(rebases)
    # memory spans on the CPU keep no peak
    assert all(s.peak_bytes is None for s in rec.spans)


def test_smoother_spans(problem):
    with recording() as rec:
        _smoother(problem)
    sweeps = _children(rec.spans, rec.spans[0])
    assert [(s.name, s.attrs["k"]) for s in sweeps] == \
        [("sweep", k) for k in range(SWEEPS)]
    for sw in sweeps:
        kids = _children(rec.spans, sw)
        assert [s.name for s in kids] == \
            ["setup"] + ["step"] * (T - 1) + ["finish"]
        assert [s.attrs["t"] for s in kids[1:-1]] == list(range(1, T))
        first = sw.attrs["k"] == 0      # no reference: no ancestor weights
        for s in kids[1:-1]:
            assert [c.name for c in _children(rec.spans, s)] == (
                ["resample", "dynamics", "update", "weights"] if first else
                ["resample", "ancestor", "dynamics", "update", "woodbury",
                 "weights"])


def test_cpf_as_sweeps_and_checkpoints(problem, tmp_path):
    """run_rbps has the root and sweep spans (its steps nest inside each
    sweep, tests/test_torch_cpfas_radio.py); a checkpoint directory adds
    one span a sweep."""
    with recording() as rec:
        _smoother(problem, run_rbps, checkpoint_dir=str(tmp_path))
    names = [(s.name, s.attrs.get("k")) for s in
             _children(rec.spans, rec.spans[0])]
    assert names == [(n, k) for k in range(SWEEPS)
                     for n in ("sweep", "checkpoint")]


def test_launches_are_counted_in_every_open_span(monkeypatch):
    monkeypatch.setattr(_lib, "_launches",
                        dict.fromkeys(_lib.KERNEL_NAMES, 0))
    with recording() as rec:
        with phase_annotation("step", t=1):
            with phase_annotation("update"):
                _lib.check(0, "gather_cp")
                _lib.check(0, "gather_cp")
            with phase_annotation("weights"):
                pass
        with phase_annotation("rebase", t=1):
            _lib.check(0, "rebase")
    assert [(s.name, s.launches, s.call) for s in rec.spans] == [
        ("step", {"gather_cp": 2}, 0), ("update", {"gather_cp": 2}, 0),
        ("weights", {}, 0), ("rebase", {"rebase": 1}, 3)]


def test_device_counters_reach_their_span_when_recording_ends(problem):
    """K2's device counter of P_base reads (``_lib.k2_reads_counter``) is
    one int64 a recorded call: every span of a call gives the same
    address, another call another. The counts reach the calls' root spans
    (``Span.k2_p_reads``) once, when the recording ends. Outside every
    span, and with recording off, the counter is a null pointer. A
    recorded call whose kernels count nothing (the plain versions here)
    leaves every span's count None."""
    cpu = torch.device("cpu")
    assert _lib.k2_reads_counter(cpu) == 0
    with recording() as rec:
        assert _lib.k2_reads_counter(cpu) == 0
        with phase_annotation("rbpf"):
            with phase_annotation("update"):
                a = _lib.k2_reads_counter(cpu)
                ctypes.c_int64.from_address(a).value += 5   # a kernel's add
            with phase_annotation("update"):
                assert _lib.k2_reads_counter(cpu) == a
                ctypes.c_int64.from_address(a).value += 2
        with phase_annotation("rbpf"):
            b = _lib.k2_reads_counter(cpu)
            assert b != a
            ctypes.c_int64.from_address(b).value += 4
        assert all(s.k2_p_reads is None for s in rec.spans)
    assert [s.k2_p_reads for s in rec.spans] == [7, None, None, 4]
    assert _lib.k2_reads_counter(cpu) == 0
    with recording() as rec:
        CALLS["lowrank"](problem)
    assert rec.spans and all(s.k2_p_reads is None for s in rec.spans)


def test_k2_reads_reader_on_hand_made_calls():
    """The benchmark's reader of ``kernels.k2_p_reads_per_particle``: the
    P_base matrices counted over N_P times the K2 launches of the spans
    that hold the count; None where no span holds one (a program without
    the count) or no call was recorded."""
    from types import SimpleNamespace

    from benchmark import spec
    from benchmark.spans import SpanCall

    launches = [{"gather_cp": 2, "rebase": 1}, {"gather_cp": 1},
                {"gather_cp": 1}, {"rebase": 1}]
    names = ["rbpf", "update", "update", "rebase"]
    spans = [profiling.Span(name, {}, i, None if i == 0 else 0, 0)
             for i, name in enumerate(names)]
    for s, n in zip(spans, launches):
        s.launches = n
    spans[0].k2_p_reads = 8
    reader = spec.reader("kernels.k2_p_reads_per_particle")

    def read(call_spans):
        return reader.read(SimpleNamespace(
            steps=2, cell=SimpleNamespace(n=8),
            span_call=SpanCall(call_spans, [], [], 0.0)))

    assert read(spans) == pytest.approx(8 / 16)
    spans[0].k2_p_reads = None                  # another form of K2
    assert read(spans) is None
    parent = [SimpleNamespace(name=n, id=i, launches=k)    # no such slot
              for i, (n, k) in enumerate(zip(names, launches))]
    assert read(parent) is None
    assert reader.read(SimpleNamespace(steps=2, span_call=None)) is None


def test_spans_share_the_profiler_clock(problem):
    """Under a CPU-activity profiler every span is also a profiler scope;
    each aten event whose innermost scope (by the profiler's own times) is
    a span's scope starts and ends inside that span's recorded interval."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with recording() as rec:
            _filter(problem, "lowrank")
    events = list(prof.profiler.kineto_results.events())
    scopes = sorted((e for e in events if e.is_user_annotation()),
                    key=lambda e: e.start_ns())
    # the k-th scope named n is the k-th span named n
    assert [e.name() for e in scopes] == [s.name for s in rec.spans]
    starts = [e.start_ns() for e in scopes]
    checked = 0
    for e in events:
        if e.is_user_annotation() or not e.name().startswith("aten::"):
            continue
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        while i >= 0 and scopes[i].end_ns() < e.end_ns():
            i -= 1                       # the innermost scope holding it
        if i < 0:
            continue
        span = rec.spans[i]
        assert span.start_ns <= e.start_ns() and e.end_ns() <= span.end_ns
        checked += 1
    assert checked > 1000
