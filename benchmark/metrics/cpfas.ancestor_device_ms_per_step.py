"""cpfas.ancestor_device_ms_per_step (ms/step): device time of the
operations launched inside the CPF-AS smoother's ``ancestor`` spans (the
pinned particle's ancestor weights: the heading density, the future
readings' stacked system, its Cholesky and density, the draw), over the
number of those spans (one a step of every conditioned sweep), in the span
call (spans.py). None where no ``ancestor`` span records ``rows`` under an
``rbps`` root: a program without the spans, or another smoother."""

from benchmark import roofline_cpfas, spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    ids = [s.id for s in roofline_cpfas.ancestor_spans(call)]
    if not ids:
        return None
    device = spans._subtree_sum(call, ctx.span_phases, "device_ns")
    return sum(device[i] for i in ids) * 1e-6 / len(ids)
