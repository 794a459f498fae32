"""The reading of metrics/engine.host_dispatch_ms_per_step.py for the host-bound cells, split from it
so that it moves their own end-to-end metric (particle_steps_per_s.host,
whose runs follow the host CPU's speed and spread far wider than a
device-bound cell's)."""

from benchmark import spec

read = spec.reader("engine.host_dispatch_ms_per_step").read
