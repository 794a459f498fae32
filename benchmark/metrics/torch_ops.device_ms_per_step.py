"""torch_ops.device_ms_per_step (ms/step): device time of every operation
in one traced call that is not one of the port's own kernels (the plain
PyTorch of ops/, math/, models/ and the engines, copies and fills
included), per step of the call. The port's kernels are those whose names
match roofline.KERNEL_FAMILIES."""

from benchmark import roofline


def read(ctx):
    us = sum(end - start for name, start, end in ctx.trace.device
             if roofline.family(name) is None)
    return us * 1e-3 / ctx.steps if ctx.trace.device else None
