"""Evaluation metrics: Procrustes-aligned position RMSE and
quaternion-error orientation RMSE (port of rbslam_tpu/metrics/rmse.py;
run_dense3D_magfield.m:155-176). The sparse-map metric comes with the
workload that prints it."""

from __future__ import annotations

import torch

from ..math.procrustes import procrustes
from ..math.quaternions import qinv, qmul, quat_to_euler


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


def orientation_rmse_deg(truth_quat, est_quat) -> torch.Tensor:
    """Per-axis RMS [3] of the quaternion-error Euler angles in degrees
    (run_dense3D_magfield.m:163-176). ``truth_quat`` is moved to the
    estimate's device and dtype."""
    est_quat = torch.as_tensor(est_quat)
    truth_quat = torch.as_tensor(truth_quat, dtype=est_quat.dtype,
                                 device=est_quat.device)
    q_err = qmul(est_quat, qinv(truth_quat))
    return rms(quat_to_euler(q_err), dim=0)
