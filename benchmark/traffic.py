"""The general traffic generator. Every mix is a closed loop of one caller
(run.py): engine calls back to back, each with fresh random draws from the
run's seed.

A traffic file (``benchmark/traffic/<name>.json``) holds the mix's
parameters: ``n_particles`` and ``config``, settings merged into the
configuration's that the mix varies (``{"engine_config":
{"ess_threshold": 0.5}}``, ``{"data": {"mag_disturbance": [0, 10, 0]}}``).
The draws of call ``k`` come from their own generator on the run's device,
seeded from (seed, k) alone, so the reference can be handed the very same
draws after the window and two runs of one seed send the same calls.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
_STREAMS = {"data": 0, "warm": 1, "call": 2, "sample": 3}


def load(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def stream_seed(seed: int, stream: str, k: int = 0) -> int:
    """A 63-bit seed of one random stream of the run, from the run's seed
    (any whole number), the stream's name and an index."""
    ss = np.random.SeedSequence([int(seed) % 2**64, _STREAMS[stream], k])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draws(shapes, seed: int, stream: str, k: int, device) -> tuple:
    """One call's draws: for each (kind, shape) of ``shapes``, in order,
    uniforms in [0, 1) ("uniform") or standard normals ("normal"), float32
    on ``device``."""
    g = torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, k))
    make = {"uniform": torch.rand, "normal": torch.randn}
    return tuple(make[kind](shape, generator=g, device=device)
                 for kind, shape in shapes)
