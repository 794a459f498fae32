"""device.idle_share (fraction): 1 - the union of the device's busy
intervals in one traced call over the median wall of the same process's
un-traced calls (the profiler slows the host, so the traced call's own wall
would overstate idling)."""

from benchmark.trace import busy_us


def read(ctx):
    if not ctx.trace.device:
        return None
    return 1.0 - busy_us(ctx.trace) * 1e-6 / ctx.untraced_wall_s
