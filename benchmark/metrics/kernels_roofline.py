"""kernels_roofline (%): the port's own CUDA kernels (csrc/, launched from
kernels/*.py) over their roofline in one traced call: the sum of every
launch's least time (roofline.py, from the call's shapes and its ancestors)
over the sum of their traced device times. Nothing is read where the call
launched none of the port's kernels, or other kernels or counts than its
engine's launch plan (engines/<engine>.py::Cell.launches) lists."""

from collections import defaultdict

from benchmark import roofline


def read(ctx):
    plan = ctx.cell.launches(ctx.trace.out.ancestors)
    if not plan:
        return None
    measured = defaultdict(list)
    for name, start, end in sorted(ctx.trace.device, key=lambda e: e[1]):
        fam = roofline.family(name)
        if fam is not None:
            measured[fam].append((end - start) * 1e-6)
    if {f: len(v) for f, v in measured.items()} != \
            {f: len(v) for f, v in plan.items()}:
        return None
    least = sum(launch.least_s() for v in plan.values() for launch in v)
    return 100.0 * least / sum(sum(v) for v in measured.values())
