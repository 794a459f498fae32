"""pf.weights_device_ms_per_step (ms/step): device time of the operations
launched inside the particle filter's ``weights`` spans (the weight of
every particle, normalization and the step's estimates; the exact model's
``basis``, ``predictive`` and ``likelihood`` below them), over the number
of those spans (one a step after step 0), in the span call (spans.py).
None where no ``weights`` span lies under a ``pf`` root."""

from benchmark import spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    ids = [s.id for s in call.spans if s.name == "weights"
           and call.spans[s.call].name == "pf"]
    if not ids:
        return None
    device = spans._subtree_sum(call, ctx.span_phases, "device_ns")
    return sum(device[i] for i in ids) * 1e-6 / len(ids)
