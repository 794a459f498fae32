"""Shared workload utilities: JSON reporting, timing, config dictionaries
(port of rbslam_tpu/workloads/common.py)."""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch


def report(results: dict) -> None:
    """Print one JSON line per workload run (machine-checkable)."""

    def clean(v: Any):
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (torch.Tensor, np.ndarray)):
            return v.tolist()
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()
        return v

    print(json.dumps(clean(results)))


class Timer:
    """Wall time of a block that runs on ``device``: a CUDA device is
    synchronized before the clock is read at the end, so queued work
    counts."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
        return False


def config_dict(cfg) -> dict:
    if dataclasses.is_dataclass(cfg):
        return dataclasses.asdict(cfg)
    return dict(cfg._asdict()) if hasattr(cfg, "_asdict") else vars(cfg)
