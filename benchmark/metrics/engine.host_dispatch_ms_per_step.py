"""engine.host_dispatch_ms_per_step (ms/step): the host's own Python and
ATen work in one engine call, per step: the root span's wall less the time
inside the CUDA runtime and driver calls that started within it, from one
call under the program's span recorder and torch.profiler (spans.py).
None where the call recorded no spans."""

from benchmark import spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    return spans.host_dispatch_ms(
        call, getattr(ctx, "span_phases", None)) / ctx.steps
