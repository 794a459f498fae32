"""Dense EKF baseline with error-state orientation relinearization (port
of rbslam_tpu/engines/ekf.py).

Reference: examples/slam-dense-mag/ekf_dense.m (after Viset, Helmons &
Kok 2022). State: [position(3), orientation error(3), map(n_lin)] plus a
quaternion linearization point q_nb. Per step: propagate mean and
covariance through the odometry (:70-75), Kalman-update with the full
Jacobian (position block from the field Hessian, orientation block from
the skew of the predicted field, map block from the basis gradients,
run_dense3D_magfield.m:281-299), then fold the orientation error back
into q_nb (:95-96).

The filter is written for a batch of B independent runs (the Monte-Carlo
repetitions of the disturbance sweep, examples/slam-dense-mag/main.m:37-60):
a Python loop over the T steps whose per-step products are [B, n, n]
batched matrix products, n = 6 + n_lin. The sequential entry is the batch
of one. Nothing here is a hand-written kernel: these are the plain matrix
products that the JAX package leaves to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..basis.potential import ScalarPotentialBasis
from ..math.linalg import psd_cholesky, solve_psd, symmetrize
from ..math.quaternions import expq, mcross, qmul, quat_to_rmat


class EKFResult(NamedTuple):
    x_traj: torch.Tensor        # [T, 6 + n_lin] filtered means (ori error == 0)
    q_traj: torch.Tensor        # [T, 4] linearization quaternions
    P_final: torch.Tensor       # [n, n] final covariance
    chol_retries: torch.Tensor  # int32 count of repaired factorizations


def _measure(potential: ScalarPotentialBasis, x, q):
    """(yhat [B, 3], H [B, 3, n]) at the current linearization point
    (run_dense3D_magfield.m:281-299)."""
    pos = x[:, :3]
    xl = x[:, 6:]
    C_nav = potential.grad_blocks(pos)                      # [B, 3, n_lin]
    RnbT = quat_to_rmat(q).transpose(-1, -2)
    field_nav = torch.einsum("bij,bj->bi", C_nav, xl)
    yhat = torch.einsum("bij,bj->bi", RnbT, field_nav)
    Hpos = RnbT @ torch.einsum("bijk,bk->bij", potential.hess_blocks(pos), xl)
    Hori = RnbT @ mcross(field_nav)
    Hmap = RnbT @ C_nav
    return yhat, torch.cat([Hpos, Hori, Hmap], dim=-1)


def _update(potential, x, q, P, y_t, R, jitter):
    yhat, H = _measure(potential, x, q)
    e = y_t - yhat
    HP = H @ P
    S = HP @ H.transpose(-1, -2) + R
    L, retried = psd_cholesky(S, jitter)
    K = solve_psd(L, HP).transpose(-1, -2)                  # [B, n, 3]
    x_new = x + torch.einsum("bij,bj->bi", K, e)
    P_new = symmetrize(P - K @ S @ K.transpose(-1, -2))
    # relinearize orientation (ekf_dense.m:95-96)
    q_new = qmul(expq(x_new[:, 3:6] / 2.0), q)
    x_new[:, 3:6] = 0.0
    return x_new, q_new, P_new, retried


def run_ekf_dense_batched(potential: ScalarPotentialBasis, dx, y, x0, q0, P0,
                          Q, R, dt, jitter: float = 1e-3, *,
                          device="cuda") -> EKFResult:
    """B independent EKF runs as one batch on ``device``.

    dx [B, T-1, n_u] odometry increments (position 3, quaternion 4);
    y [B, T, 3]; x0 [6 + n_lin] shared or [B, 6 + n_lin]; q0 [4] or
    [B, 4]; P0 [n, n] shared; Q [6, 6] or [T-1, 6, 6] and dt scalar or
    [T-1], shared. Returns an EKFResult with a leading batch axis on every
    field (``chol_retries`` [B] int32, counted per member).

    The [B, n, n] float32 products lose the filter's accuracy in TF32, so
    on a CUDA device the call raises if
    ``torch.backends.cuda.matmul.allow_tf32`` is on.
    """
    device = torch.device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the EKF's float32 covariance products need full precision: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    dx, y, P0, Q, R, dt = t(dx), t(y), t(P0), t(Q), t(R), t(dt)
    if dx.dim() != 3 or y.dim() != 3 or dx.shape[0] != y.shape[0] \
            or dx.shape[1] != y.shape[1] - 1:
        raise ValueError(f"dx must be [B, T-1, n_u] and y [B, T, 3], got "
                         f"{tuple(dx.shape)} and {tuple(y.shape)}")
    B, T = y.shape[:2]
    x = t(x0).expand(B, -1).clone()
    q = t(q0).expand(B, -1)
    n = x.shape[-1]
    if Q.dim() == 2:
        Q = Q.expand((T - 1,) + Q.shape)
    if dt.dim() == 0:
        dt = dt.expand(T - 1)

    x_traj = torch.empty((B, T, n), device=device)
    q_traj = torch.empty((B, T, 4), device=device)
    x, q, P, retried = _update(potential, x, q, P0.expand(B, n, n), y[:, 0],
                               R, jitter)
    retries = retried.to(torch.int32)
    x_traj[:, 0], q_traj[:, 0] = x, q
    for s in range(T - 1):
        # dynamics (run_dense3D_magfield.m:310-316): position += dPos, the
        # linearization quaternion composes the increment, F = I, and Q
        # enters the pose blocks only, rotated for the orientation block.
        # P is this loop's own tensor (the update returned it): add in place
        u = dx[:, s]
        x[:, :3] += u[:, :3]
        q = qmul(q, u[:, 3:7])
        G = quat_to_rmat(q)
        Qt = dt[s] * Q[s]
        P[:, :3, :3] += Qt[:3, :3]
        P[:, 3:6, 3:6] += G @ Qt[3:6, 3:6] @ G.transpose(-1, -2)
        x, q, P, retried = _update(potential, x, q, P, y[:, s + 1], R, jitter)
        retries += retried
        x_traj[:, s + 1], q_traj[:, s + 1] = x, q
    return EKFResult(x_traj=x_traj, q_traj=q_traj, P_final=P,
                     chol_retries=retries)


def run_ekf_dense(potential: ScalarPotentialBasis, dx, y, x0, q0, P0, Q, R,
                  dt, jitter: float = 1e-3, *, device="cuda") -> EKFResult:
    """One EKF run: dx [T-1, n_u], y [T, 3], x0 [6 + n_lin], q0 [4]; the
    batch of one of :func:`run_ekf_dense_batched`, squeezed."""
    res = run_ekf_dense_batched(
        potential, torch.as_tensor(dx)[None], torch.as_tensor(y)[None], x0,
        q0, P0, Q, R, dt, jitter, device=device)
    return EKFResult(*(f[0] for f in res))
