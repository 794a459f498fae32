"""The reading of metrics/device.idle_share.py for the host-bound cells, split from it
so that it moves their own end-to-end metric (particle_steps_per_s.host,
whose runs follow the host CPU's speed and spread far wider than a
device-bound cell's)."""

from benchmark import spec

read = spec.reader("device.idle_share").read
