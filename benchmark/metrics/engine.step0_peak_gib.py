"""engine.step0_peak_gib (GiB): the allocator's high-water mark inside the
filter's step 0 (its dense update of the whole ensemble), as the program's
``step0`` span recorded it (spans.py). None where no such span recorded a
peak."""

from benchmark import spans


def read(ctx):
    call = spans.call_of(ctx)
    return None if call is None else spans.peak_gib(call, "step0")
