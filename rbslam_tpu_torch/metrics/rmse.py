"""Evaluation metrics: Procrustes-aligned position RMSE, quaternion-error
orientation RMSE (port of rbslam_tpu/metrics/rmse.py;
run_dense3D_magfield.m:155-176), and the sparse-visual path and map RMSE,
where the alignment is estimated on the map and applied to both
(calc_rmses.m:35-55)."""

from __future__ import annotations

from typing import Optional

import torch

from ..math.procrustes import procrustes, procrustes_transform
from ..math.quaternions import qinv, qmul, quat_to_euler


def rms(x, axis: int = 0, *, dim: Optional[int] = None) -> torch.Tensor:
    """Root-mean-square along ``axis`` (MATLAB ``rms``); ``dim``, torch's
    name for it, overrides ``axis``."""
    x = torch.as_tensor(x)
    return torch.sqrt(torch.mean(x**2, dim=axis if dim is None else dim))


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


def map_and_path_rmse(map_truth, map_est, traj_truth, traj_est):
    """Sparse-visual metrics (calc_rmses.m): the similarity transform from
    the map correspondence (map_truth, map_est [M, 2]), applied to the map
    and to the 2D path (traj_est [T, >= 2]). Returns (rmse_path,
    rmse_map); the truths are moved to the estimates' device and dtype."""
    map_est = torch.as_tensor(map_est)
    traj_est = torch.as_tensor(traj_est, dtype=map_est.dtype,
                               device=map_est.device)

    def like(a):
        return torch.as_tensor(a, dtype=map_est.dtype, device=map_est.device)

    map_truth, traj_truth = like(map_truth), like(traj_truth)
    _, tf = procrustes(map_truth, map_est)
    Z_path = procrustes_transform(traj_est[:, :2], tf)
    Z_map = procrustes_transform(map_est, tf)
    d_path = torch.sqrt(torch.sum((traj_truth[:, :2] - Z_path) ** 2, dim=-1))
    d_map = torch.sqrt(torch.sum((map_truth - Z_map) ** 2, dim=-1))
    return (torch.sqrt(torch.mean(d_path**2)),
            torch.sqrt(torch.mean(d_map**2)))
