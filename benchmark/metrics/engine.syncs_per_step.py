"""engine.syncs_per_step (syncs/step): host-device synchronizations that
``torch.cuda.set_sync_debug_mode("warn")`` reports in one engine call,
over its steps (trace.py::count_syncs)."""


def read(ctx):
    return sum(n for n, _ in ctx.syncs.values()) / ctx.steps
