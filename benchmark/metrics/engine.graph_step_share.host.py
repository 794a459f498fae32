"""engine.graph_step_share.host (fraction): the steps of one engine call
that ran as replays of a captured CUDA graph, over all its steps: the
``step`` spans of the call of spans.py whose ``graph`` attribute is true,
over its ``step`` spans. None where no step span says whether it was
replayed: a program that records no such attribute, or no spans."""

from benchmark import spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    flags = [s.attrs.get("graph") for s in call.spans if s.name == "step"]
    if not flags or all(f is None for f in flags):
        return None
    return sum(bool(f) for f in flags) / len(flags)
