"""Terrain-matching localization model: a fixed GP map, no linear state
(port of rbslam_tpu/models/terrain.py; examples/mag-localization-mapping/
run_localization.m, particleFilterLocalization.m).

- state xn = [p (3), q (4)];
- dynamics (:274-281):
      p' = p + u[:3] + sqrt(dt*Q_pos) xi_p
      q' = (u_q ⊗ q) ⊗ expq(sqrt(dt*Q_ori) xi_q)
  (the odometry increment left-multiplies, unlike the mag3D SLAM model);
- weights (:241-272): the GP posterior predictive at the particle
  position, rotated to the body frame. ``mode="product"`` is the joint
  log-density of the three axes; ``mode="sum"`` reproduces the
  reference's sum of per-axis pdfs through a logsumexp. As in the JAX
  package, the predictive variance is evaluated at the particle's own
  position and the weights never leave log space.

The exact model's weight runs in three phases (``utils.profiling``
spans inside the engine's ``weights``): ``basis``, the basis gradients
g(x) [N, 3, m] of the field rows C(x) = [I_3 | g(x)] (K4 ``grad_basis``
on a CUDA device, ``grad_phi`` elsewhere; C itself is never formed);
``predictive``, the mean C w and the variance sigma2 diag(C A^-1 C') =
sigma2 ||L^-1 c||^2 of all 3N rows in one launch of K12 ``gp_predictive``
from g and L^-1, formed once at construction (its plain version on the
CPU; attributes ``rows`` and ``n_lin``); ``likelihood``, the rotation
into the body frame and the per-axis densities.

Every callable works on the whole ensemble at once: ``log_weight(y_t [3],
xn [N, 7]) -> [N]`` and ``dynamics(w [N, 6], xn [N, 7], u [7], dt, Q) ->
xn' [N, 7]``, where w holds the standard normals of the position (first
three) and the orientation (last three) draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..basis.potential import ScalarPotentialBasis
from ..kernels.basis_eval import grad_basis, pack_basis_constants
from ..kernels.predictive import gp_predictive, pack_predictive
from ..math.quaternions import expq, qmul, quat_to_rmat
from ..utils.profiling import phase_annotation

_LOG2PI = math.log(2.0 * math.pi)


class TerrainModel(NamedTuple):
    dynamics: Callable       # (w [N, 6], xn [N, 7], u, dt, Q) -> xn' [N, 7]
    log_weight: Callable     # (y_t [3], xn [N, 7]) -> [N]
    predict_field: Callable  # (x [.., 3]) -> (mean [.., 3], var [.., 3])
    n_nonlin: int
    n_noise: int


def _check_mode(mode: str) -> None:
    if mode not in ("product", "sum"):
        raise ValueError(f"mode must be 'product' or 'sum', got {mode!r}")


def _log_weight(y_t, q, mean_nav, var, sigma2: float, mode: str):
    """Log-density of y_t [3] given the field mean [N, 3] (navigation
    frame) and variance [N, 3] at each particle, rotated into the body
    frame of q [N, 4]. The small per-particle products are broadcast
    sums: as an einsum they become batched cuBLAS calls, which took half
    of the 2^20-particle step's device time on an H100."""
    mean_body = torch.sum(quat_to_rmat(q) * mean_nav[:, :, None], dim=1)
    s2 = var + sigma2
    log_pdfs = -0.5 * ((y_t - mean_body) ** 2 / s2 + torch.log(s2)
                       + _LOG2PI)
    if mode == "product":
        return torch.sum(log_pdfs, dim=-1)
    return torch.logsumexp(log_pdfs, dim=-1)


def _propagate(w, xn, u, Lp, Lq):
    """p' = p + u_p + Lp(w_p), q' = (u_q ⊗ q) ⊗ expq(Lq(w_q))."""
    p_new = xn[:, :3] + u[:3] + Lp(w[:, :3])
    q_new = qmul(qmul(u[3:7], xn[:, 3:7]), expq(Lq(w[:, 3:6])))
    return torch.cat([p_new, q_new], dim=-1)


def make_terrain_model(potential: ScalarPotentialBasis,
                       posterior_mean_weights, posterior_chol, sigma2: float,
                       mode: str = "product", center=None) -> TerrainModel:
    """The exact model: the GP predictive from the posterior mean weights
    [n_lin] ("foo", run_localization.m:150-151) and the lower Cholesky
    [n_lin, n_lin] of Phi'Phi + diag(sigma2/k), both float32. L^-1 is
    formed here once, in float64, and rounded to float32
    (``kernels.predictive.pack_predictive``): the predictive variance of
    all 3N gradient rows is then one product with it (K12 on a CUDA
    device). ``center`` [3] (the GP's domain centre) is subtracted from
    the positions the weights and ``predict_field`` are given; by default
    they are centred already. On a CUDA device the rows' basis gradients
    come from K4, whose constants are packed once here, on the device of
    the mean weights."""
    _check_mode(mode)
    w_map = torch.as_tensor(posterior_mean_weights)
    n_lin = potential.n_lin
    predictive_consts = pack_predictive(posterior_chol, w_map, sigma2)
    c = None if center is None else torch.as_tensor(
        np.asarray(center, np.float32), device=w_map.device)
    consts = (pack_basis_constants(potential.basis, w_map.device)
              if w_map.device.type == "cuda" else None)

    def basis_gradients(x):
        """g(x) [.., 3, m] of the field rows [I_3 | g] at positions x
        [.., 3]."""
        if c is not None:
            x = x - c
        if consts is None:
            return potential.basis.grad_phi(x)
        flat = x.reshape(-1, 3).contiguous()
        return grad_basis(consts, flat).reshape(x.shape + (consts.m,))

    def predictive(g):
        """Mean [.., 3] and variance [.., 3] of the field at rows [I | g]."""
        with phase_annotation("predictive", rows=g.numel() // g.shape[-1],
                              n_lin=n_lin):
            return gp_predictive(predictive_consts, g)

    def predict_field(x):
        return predictive(basis_gradients(x))

    def log_weight(y_t, xn):
        with phase_annotation("basis"):
            g = basis_gradients(xn[:, :3])
        mean_nav, var = predictive(g)
        with phase_annotation("likelihood"):
            return _log_weight(y_t, xn[:, 3:7], mean_nav, var, sigma2, mode)

    def dynamics(w, xn, u, dt, Q):
        # cholesky_ex: no host-side error check (a device sync) a step
        Lp = torch.linalg.cholesky_ex(dt * Q[:3, :3])[0]
        Lq = torch.linalg.cholesky_ex(dt * Q[3:6, 3:6])[0]
        return _propagate(w, xn, u, lambda z: z @ Lp.T, lambda z: z @ Lq.T)

    return TerrainModel(dynamics=dynamics, log_weight=log_weight,
                        predict_field=predict_field, n_nonlin=7, n_noise=6)


def make_gridded_terrain_model(mean_grid, var_grid, lo, spacing,
                               sigma2: float, dynamics=None,
                               mode: str = "product") -> TerrainModel:
    """Terrain model with the GP posterior pre-evaluated on a regular grid
    (mean_grid, var_grid [nx, ny, 3]; origin lo [2]; spacing [2]) and
    bilinearly interpolated at the particle positions: the weight is a
    gather and a lerp, the 1M-particle path. The four corners of (mean,
    var) are packed in one 24-float row, so a particle reads one row."""
    _check_mode(mode)
    mean_grid = torch.as_tensor(mean_grid)
    var_grid = torch.as_tensor(var_grid)
    lo = torch.as_tensor(lo)
    spacing = torch.as_tensor(spacing)
    nx, ny_ = mean_grid.shape[0], mean_grid.shape[1]
    mv = torch.cat([mean_grid, var_grid], dim=-1)          # [nx, ny_, 6]
    packed = torch.cat(
        [mv[:-1, :-1], mv[1:, :-1], mv[:-1, 1:], mv[1:, 1:]], dim=-1
    ).reshape((nx - 1) * (ny_ - 1), 24)

    def _interp_both(p):
        """Bilinear (mean [N, 3], var [N, 3]) at p [N, 2]: one row
        gathered a particle. floor, clip and the weights in the JAX
        package's float32 order, so a particle on a cell edge takes the
        same cell."""
        f = (p - lo) / spacing
        i0 = torch.clamp(torch.floor(f[:, 0]).to(torch.int32), 0, nx - 2)
        j0 = torch.clamp(torch.floor(f[:, 1]).to(torch.int32), 0, ny_ - 2)
        tx = torch.clamp(f[:, 0] - i0, 0.0, 1.0)
        ty = torch.clamp(f[:, 1] - j0, 0.0, 1.0)
        row = packed.index_select(0, i0 * (ny_ - 1) + j0).view(-1, 4, 6)
        wgt = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                           (1 - tx) * ty, tx * ty], dim=-1)
        out = torch.sum(wgt[:, :, None] * row, dim=1)
        return out[:, :3], out[:, 3:]

    def predict_field(x):
        x = torch.as_tensor(x)
        if x.dim() == 1:
            mean, var = _interp_both(x[None, :2])
            return mean[0], var[0]
        return _interp_both(x[:, :2])

    def log_weight(y_t, xn):
        mean_nav, var = _interp_both(xn[:, :2])
        return _log_weight(y_t, xn[:, 3:7], mean_nav, var, sigma2, mode)

    def default_dynamics(w, xn, u, dt, Q):
        Lp = torch.sqrt(dt) * torch.sqrt(torch.diagonal(Q[:3, :3]))
        Lq = torch.sqrt(dt) * torch.sqrt(torch.diagonal(Q[3:6, 3:6]))
        return _propagate(w, xn, u, lambda z: Lp * z, lambda z: Lq * z)

    return TerrainModel(dynamics=dynamics or default_dynamics,
                        log_weight=log_weight, predict_field=predict_field,
                        n_nonlin=7, n_noise=6)


def gridify_gp(gp, lo, hi, n=(256, 256), z: float = 0.0):
    """Evaluate a fitted ReducedRankGP's mean and variance on a regular grid
    for :func:`make_gridded_terrain_model`, on the GP's device. Returns
    (mean [n0, n1, 3], var [n0, n1, 3], lo [2], spacing [2])."""
    xs = np.linspace(lo[0], hi[0], n[0])
    ys = np.linspace(lo[1], hi[1], n[1])
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), np.full(X.size, z)], -1)
    mean, var = gp.predict_gradient(pts)
    device = mean.device

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return (mean.reshape(n[0], n[1], 3), var.reshape(n[0], n[1], 3),
            f32([xs[0], ys[0]]), f32([xs[1] - xs[0], ys[1] - ys[0]]))
