"""Evaluation metrics: Procrustes-aligned position RMSE (port of
rbslam_tpu/metrics/rmse.py; run_dense3D_magfield.m:155-160). The
orientation and sparse-map metrics come with the workloads that print
them."""

from __future__ import annotations

import torch

from ..math.procrustes import procrustes


def rms(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Root-mean-square along a dimension (MATLAB ``rms``)."""
    return torch.sqrt(torch.mean(x**2, dim=dim))


def aligned_position_rmse(truth, estimate, per_axis: bool = False):
    """Procrustes-align ``estimate`` [T, d] onto ``truth``, then RMS error:
    the scalar RMSE of the pointwise distance, or with ``per_axis`` the
    per-axis RMS vector the reference prints. ``truth`` is moved to the
    estimate's device and dtype."""
    estimate = torch.as_tensor(estimate)
    truth = torch.as_tensor(truth, dtype=estimate.dtype,
                            device=estimate.device)
    Z, _ = procrustes(truth, estimate)
    err = truth - Z
    if per_axis:
        return rms(err, dim=0)
    return torch.sqrt(torch.mean(torch.sum(err**2, dim=-1)))
