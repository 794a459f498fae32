"""Dense radio-SLAM model: planar position + heading, scalar RSS field (port
of rbslam_tpu/models/radio2d.py; run_dense2D_withHeading.m).

- state xn = [p1, p2, theta];
- dynamics rotate the odometry increment into the heading frame and add
  noise only on heading (:75-77):
      p'     = p + R(theta)^T u[:2]
      theta' = theta + u[2] + sqrt(dt*Q) * xi
  (Q is the 1x1 heading process noise, time-varying with spikes);
- dynamics residual is the whitened heading residual (:77);
- measurement Jacobian is the eigenbasis row at the position (:168):
      C(xn) = phi(p) [1, m],  y = C xl + r.
"""

from __future__ import annotations

import torch

from ..basis.laplace import LaplaceBasis
from ..kernels.basis_eval import pack_basis_constants, phi_basis
from .base import DenseModel


def make_radio2d_model(basis: LaplaceBasis, center=None, *,
                       device) -> DenseModel:
    """Build the dense radio model on ``device``. The whole-ensemble
    Jacobian runs the fused basis kernel K6 (kernels/basis_eval.py)."""
    device = torch.device(device)
    c = torch.zeros(2, device=device) if center is None else \
        torch.as_tensor(center, dtype=torch.float32, device=device)
    consts = pack_basis_constants(basis, device)

    def dynamics_batch(w, xn, u, dt, Q):
        """Whole-ensemble transition from w [P, 1] standard normals; with
        R = [[c, -s], [s, c]], R^T u = [c u1 + s u2, -s u1 + c u2]."""
        theta = xn[..., 2]
        cs, sn = torch.cos(theta), torch.sin(theta)
        sigma = torch.sqrt(dt * Q[0, 0])
        return torch.stack([
            xn[..., 0] + (cs * u[0] + sn * u[1]),
            xn[..., 1] + (-sn * u[0] + cs * u[1]),
            theta + u[2] + sigma * w[..., 0],
        ], dim=-1)

    def dynamics(w, xn, u, dt, Q):
        return dynamics_batch(w, xn, u, dt, Q)

    def dyn_residual(xn_ref, xn, u, dt, Q):
        sigma = torch.sqrt(dt * Q[0, 0])
        return ((xn_ref[2] - xn[..., 2] - u[2]) / sigma)[..., None]

    def meas_jacobian(xn):
        return basis.phi(xn[:2] - c)[None, :]                  # [1, m]

    def meas_jacobian_batch(xn):
        return phi_basis(consts, (xn[:, :2] - c).contiguous())[:, None, :]

    return DenseModel(
        dynamics=dynamics,
        dyn_residual=dyn_residual,
        meas_jacobian=meas_jacobian,
        n_nonlin=3,
        n_lin=basis.m,
        ny=1,
        n_noise=1,
        meas_jacobian_batch=meas_jacobian_batch,
        dynamics_batch=dynamics_batch,
    )
