"""Dense 3D magnetic-field SLAM model: position + quaternion, curl-free map
(port of rbslam_tpu/models/mag3d.py; run_dense3D_magfield.m).

- state xn = [p (3), q (4)] with scalar-first unit quaternion;
- dynamics (:301-308):
      p' = p + u[:3] + chol(dt*Q_pos) xi_p
      dq = u_q ⊗ expq(chol(dt*Q_ori) xi_q)        (noisy increment)
      q' = q ⊗ dq
- measurement Jacobian (:265-279): body-frame field,
      C(xn) = R(q)^T @ [I_3 | grad phi(p)]   -> [3, 3 + m]
"""

from __future__ import annotations

import torch

from ..basis.potential import ScalarPotentialBasis
from ..kernels.basis_eval import (
    grad_basis,
    mag3d_jacobian_rows,
    pack_basis_constants,
)
from ..math.quaternions import expq, logq, qinv, qmul, quat_to_rmat
from ..ops.kalman import _chol_small_batched
from .base import DenseModel


def dynamics_with_increment(w, xn, u, dt, Q):
    """One particle's transition from a standard-normal w [6]; returns
    (xn', dq), dq the noisy quaternion increment (the odometry
    generator's second output, run_dense3D_magfield.m:301-308)."""
    p, q = xn[:3], xn[3:7]
    Lp = torch.linalg.cholesky(dt * Q[:3, :3])
    Lq = torch.linalg.cholesky(dt * Q[3:6, 3:6])
    p_new = p + u[:3] + Lp @ w[:3]
    dq = qmul(u[3:7], expq(Lq @ w[3:6]))
    q_new = qmul(q, dq)
    return torch.cat([p_new, q_new]), dq


def make_mag3d_model(potential: ScalarPotentialBasis, center=None, *,
                     device) -> DenseModel:
    """Build the dense magnetic model on ``device``.

    ``center`` shifts positions into the basis' centered domain. The
    whole-ensemble Jacobian hooks run the fused basis kernels
    (kernels/basis_eval.py): K4 for the [P, 3, n_lin] form used at step
    0 and K1 for the rows layout of the lowrank steps.
    """
    device = torch.device(device)
    n_lin = potential.n_lin
    c = torch.zeros(3, device=device) if center is None else \
        torch.as_tensor(center, dtype=torch.float32, device=device)
    consts = pack_basis_constants(potential.basis, device)

    def dynamics_batch(w, xn, u, dt, Q):
        """Whole-ensemble transition from one [P, 6] standard-normal draw,
        with the closed-form 3x3 Cholesky of the reference."""
        Lp = _chol_small_batched(dt * Q[None, :3, :3], 0.0)[0][0]
        Lq = _chol_small_batched(dt * Q[None, 3:6, 3:6], 0.0)[0][0]
        p_new = xn[:, :3] + u[:3][None, :] + w[:, :3] @ Lp.T
        dq = qmul(u[3:7][None, :], expq(w[:, 3:] @ Lq.T))
        q_new = qmul(xn[:, 3:7], dq)
        return torch.cat([p_new, q_new], dim=-1)

    def dynamics(w, xn, u, dt, Q):
        return dynamics_with_increment(w, xn, u, dt, Q)[0]

    def dyn_residual(xn_ref, xn, u, dt, Q):
        """Whitened residual of xn -> xn_ref (position difference and
        quaternion-log orientation error); xn [..., 7]."""
        e_pos = xn_ref[:3] - xn[..., :3] - u[:3]
        q_err = qmul(qmul(qinv(u[3:7]), qinv(xn[..., 3:7])), xn_ref[3:7])
        e = torch.cat([e_pos, logq(q_err)], dim=-1)
        # cholesky_ex: no error check on the host, so no device sync
        L = torch.linalg.cholesky_ex(dt * Q)[0]
        return torch.linalg.solve_triangular(
            L, e[..., None], upper=False)[..., 0]

    def meas_jacobian(xn):
        C_nav = potential.grad_blocks(xn[:3] - c)          # [3, 3+m]
        Rnb = quat_to_rmat(xn[3:7])
        return Rnb.T @ C_nav

    def meas_jacobian_batch(xn):
        g = grad_basis(consts, (xn[:, :3] - c).contiguous())
        eye = torch.eye(3, dtype=xn.dtype, device=xn.device).expand(
            g.shape[:-1] + (3,)
        )
        C_nav = torch.cat([eye, g], dim=-1)                # [P, 3, 3+m]
        Rnb = quat_to_rmat(xn[:, 3:7])
        return torch.einsum("pji,pjk->pik", Rnb, C_nav)

    def meas_jacobian_batch_rows(xn, nl_pad, dtype):
        return mag3d_jacobian_rows(consts, (xn[:, :3] - c).contiguous(),
                                   xn[:, 3:7].contiguous(), nl_pad, dtype)

    return DenseModel(
        dynamics=dynamics,
        dyn_residual=dyn_residual,
        meas_jacobian=meas_jacobian,
        n_nonlin=7,
        n_lin=n_lin,
        ny=3,
        n_noise=6,
        meas_jacobian_batch=meas_jacobian_batch,
        dynamics_batch=dynamics_batch,
        meas_jacobian_batch_rows=meas_jacobian_batch_rows,
    )
