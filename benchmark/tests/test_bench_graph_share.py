"""The reader of engine.graph_step_share.host: the replayed ``step`` spans of
the span call over all its ``step`` spans, on hand-made spans; None for a
program whose steps say nothing of a graph, and for no spans; 0 for the
smoother cell at a CPU size, whose steps run eagerly there."""

from types import SimpleNamespace

from bench_small import SMALL_SMOOTHER, SMOOTHER

from benchmark import run, spec
from benchmark.spans import SpanCall

READER = spec.reader("engine.graph_step_share.host")


def _step(id_, parent, graph=None):
    attrs = {"t": id_} if graph is None else {"t": id_, "graph": graph}
    return SimpleNamespace(id=id_, parent=parent, name="step", attrs=attrs,
                           start_ns=id_, end_ns=id_ + 1, launches={},
                           peak_bytes=None, call=0)


def _read(spans):
    root = SimpleNamespace(id=0, parent=None, name="rbps", attrs={},
                           start_ns=0, end_ns=100, launches={},
                           peak_bytes=None, call=0)
    call = SpanCall([root] + spans, [], [], 0.0)
    return READER.read(SimpleNamespace(steps=len(spans), span_call=call))


def test_share_of_replayed_steps():
    steps = [_step(1, 0, False)] + [_step(i, 0, True) for i in range(2, 9)]
    assert _read(steps) == 7 / 8
    assert _read([_step(1, 0, False), _step(2, 0, False)]) == 0.0


def test_none_without_the_flag_or_the_spans():
    # the parent program's steps carry no graph attribute
    assert _read([_step(1, 0), _step(2, 0)]) is None
    assert _read([]) is None
    assert READER.read(SimpleNamespace(steps=2, span_call=None)) is None


def test_the_smoother_cell_on_the_cpu_replays_nothing():
    setup = run.prepare(SMOOTHER, 2**33 + 5, "cpu", SMALL_SMOOTHER)
    ctx = SimpleNamespace(cell=setup.cell, steps=setup.cell.steps_per_call)
    assert READER.read(ctx) == 0.0
