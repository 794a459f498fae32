"""engine.device_ops_per_step (ops/step): device operations (kernels,
copies, fills) that one traced engine call launched, per step."""


def read(ctx):
    return len(ctx.trace.device) / ctx.steps if ctx.trace.device else None
