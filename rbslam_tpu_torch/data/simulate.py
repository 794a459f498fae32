"""Dense-workload dataset simulation (port of rbslam_tpu/data/simulate.py;
examples/slam-dense-radio/generateData_dense.m).

1. ground-truth trajectory (data/trajectories.py);
2. domain LL = trajectory bounds padded by nLL * lengthScale (:226-231);
3. GP field draw with m_sim basis functions at the trajectory points: 6-D
   trajectories get the curl-free field rotated per step to the body
   frame (:252-257), planar and heading ones a scalar SE field; with
   ``with_grid``, the noise-free field on a 100 x 100 visualization grid
   over LL (:216-290);
4. odometry corruption (:294-323): run the model's own sampled dynamics
   forward from the initial state, then rebuild the increments per family:
   6-D: the differenced noisy path plus the noisy quaternion increments
   actually applied (:303-309); heading families (line_3D, square_3D,
   line_3D_withPos): clean position increments + differenced noisy
   heading (:317-319); planar families: the fully differenced noisy path
   (:320-321).

Host-side torch, float32 unless ``dtype`` says otherwise; the random
draws come from one CPU ``torch.Generator`` or are given. The grid's
values are computed from the drawn weights and draw nothing, so a seed
gives the same dataset with or without the grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..basis.laplace import domain_center, hypercube_basis
from ..basis.potential import ScalarPotentialBasis
from ..math.quaternions import quat_to_rmat
from .fields import _sqrt_in, draw_scalar_field, draw_scalar_potential_field
from .trajectories import generate_trajectory


@dataclass
class DenseDataset:
    dx: torch.Tensor             # noisy odometry [T-1, n_u]
    init_state: torch.Tensor     # [n_nonlin]
    y: torch.Tensor              # measurements [T, ny]
    pos: np.ndarray              # ground-truth positions [T, 2|3]
    quat: Optional[np.ndarray]   # ground-truth quaternions [T, 4] (6-D only)
    LL: np.ndarray               # domain bounds [2, d]
    Q: torch.Tensor              # process noise used [T-1, nw, nw]
    odometry_path: np.ndarray    # noisy integrated path [T, n_nonlin]
    grid: Optional[dict]         # visualization grid + true field values
    field_weights: torch.Tensor  # true field basis weights (m_sim basis)


def _domain_bounds(pos, length_scale, n_ll, three_d: bool):
    lo = pos.min(0) - n_ll * length_scale
    hi = pos.max(0) + n_ll * length_scale
    if three_d:
        return np.stack([[lo[0], lo[1], -n_ll * length_scale],
                         [hi[0], hi[1], n_ll * length_scale]])
    return np.stack([lo[:2], hi[:2]])


def _vis_grid(LL, n=100):
    x1t = np.linspace(LL[0, 0], LL[1, 0], n)
    x2t = np.linspace(LL[0, 1], LL[1, 1], n)
    X1, X2 = np.meshgrid(x1t, x2t)
    cols = [X1.ravel(), X2.ravel()]
    if LL.shape[1] == 3:
        cols.append(np.zeros_like(cols[0]))
    return x1t, x2t, np.stack(cols, axis=-1)


def _grid_values(LL, m_sim, weights, is_6d, chunk=2000) -> dict:
    """The visualization grid and the noise-free field on it, from the
    drawn ``weights``: f (the potential for 6-D), and for 6-D also df, the
    field. Points go through the basis in chunks, which bounds the
    [chunk, 3, 3 + m_sim] gradient blocks."""
    x1t, x2t, xt = _vis_grid(LL)
    x = torch.as_tensor(xt - domain_center(LL), dtype=weights.dtype)
    basis = hypercube_basis(m_sim, LL)
    sp = ScalarPotentialBasis(basis)
    f, df = [], []
    for xc in torch.split(x, chunk):
        if is_6d:
            f.append(sp.potential_row(xc) @ weights)
            df.append(torch.einsum("nij,j->ni", sp.grad_blocks(xc), weights))
        else:
            f.append(basis.phi(xc) @ weights)
    grid = {"x1t": x1t, "x2t": x2t, "f": torch.cat(f).numpy()}
    if is_6d:
        grid["df"] = torch.cat(df).numpy()
    return grid


_HEADING_FAMILIES = ("line_3D", "square_3D", "line_3D_withPos")


def simulate_dense_dataset(traj_type: str, theta, Q, dt: float,
                           dynamics: Callable, m_sim: int = 2000,
                           n_ll: float = 2.0,
                           traj_kwargs: Optional[dict] = None,
                           field_weights=None, with_grid: bool = True, *,
                           generator: Optional[torch.Generator] = None,
                           normals=None,
                           dtype: torch.dtype = torch.float32) -> DenseDataset:
    """Simulate one dense dataset.

    ``dynamics(w, xn, u, dt, Q)`` with w a standard-normal [nw] draw
    returns ``(xn', dq)`` for 6-D families
    (models.mag3d.dynamics_with_increment) and ``xn'`` for planar and
    heading families. ``field_weights`` reuses a previously drawn scalar
    field (new measurement and odometry noise only: the nMC > 1 path,
    run_dense2D_withHeading.m:156-161); that path has no grid, as in the
    JAX package. ``with_grid`` adds ``grid``: the 100 x 100 visualization
    grid over the domain (``x1t``, ``x2t``) with the drawn field's
    noise-free values ``f`` [10000] there, and for 6-D also ``df``
    [10000, 3]. The standard normals are
    ``normals = (z_w, z_n, w_odo)``: field weights [m_sim] (3 + m_sim for
    6-D; unused with ``field_weights``), measurement noise [T] ([T, 3]),
    odometry [T-1, nw]; entries that are None, or all of them without
    ``normals``, are drawn from ``generator`` in that order. ``dtype`` is
    that of the simulation (the points, rotations, field, noise and
    odometry) and of every tensor returned.
    """
    traj = generate_trajectory(traj_type, **(traj_kwargs or {}))
    is_6d = traj.quat is not None
    z_w, z_n, w_odo = normals if normals is not None else (None, None, None)
    T = traj.n_steps
    pts = torch.as_tensor(traj.pos, dtype=dtype)
    if is_6d:
        LL = _domain_bounds(traj.pos, float(theta[1]), n_ll, three_d=True)
        draw = draw_scalar_potential_field(pts, m_sim, LL, theta,
                                           generator=generator, z_w=z_w,
                                           z_n=z_n)
        Rn = quat_to_rmat(torch.as_tensor(traj.quat, dtype=dtype))
        y = torch.einsum("tij,tj->ti", Rn.transpose(-1, -2), draw.y[:T])
        weights = draw.weights
    else:
        LL = _domain_bounds(traj.pos, float(theta[0]), n_ll, three_d=False)
        if field_weights is not None:
            # keep the same field, redraw the measurement noise
            basis = hypercube_basis(m_sim, LL)
            weights = torch.as_tensor(field_weights, dtype=dtype)
            f = basis.phi(pts - torch.as_tensor(domain_center(LL),
                                                dtype=dtype)) @ weights
            if z_n is None:
                z_n = torch.randn((T,), generator=generator, dtype=dtype)
            y = f + _sqrt_in(float(theta[2]), f) \
                * torch.as_tensor(z_n, dtype=dtype)
        else:
            draw_s = draw_scalar_field(pts, m_sim, LL, theta,
                                       generator=generator, z_w=z_w, z_n=z_n)
            y, weights = draw_s.y, draw_s.weights
        y = y[:, None]
    grid = (_grid_values(LL, m_sim, weights, is_6d)
            if with_grid and (is_6d or field_weights is None) else None)

    # --- odometry corruption via the model's own dynamics ---
    Q = torch.as_tensor(Q, dtype=dtype)
    Qt = Q.expand((T - 1,) + Q.shape) if Q.dim() == 2 else Q
    dx_clean = torch.as_tensor(traj.dx, dtype=dtype)
    x = torch.as_tensor(traj.init_state, dtype=dtype)
    if w_odo is None:
        w_odo = torch.randn((T - 1, Qt.shape[-1]), generator=generator,
                            dtype=dtype)
    w_odo = torch.as_tensor(w_odo, dtype=dtype)
    path, dqs = [x], []
    for t in range(T - 1):
        x = dynamics(w_odo[t], x, dx_clean[t], dt, Qt[t])
        if is_6d:
            x, dq = x
            dqs.append(dq)
        path.append(x)
    path = torch.stack(path)
    if is_6d:
        dx = torch.cat([torch.diff(path[:, :3], dim=0), torch.stack(dqs)],
                       dim=-1)
    elif traj_type in _HEADING_FAMILIES:
        dx = torch.cat([dx_clean[:, :2],
                        torch.diff(path[:, 2], dim=0)[:, None]], dim=-1)
    else:
        dx = torch.diff(path, dim=0)
    return DenseDataset(
        dx=dx,
        init_state=path[0],
        y=y,
        pos=traj.pos,
        quat=traj.quat,
        LL=LL,
        Q=Qt,
        odometry_path=path.numpy(),
        grid=grid,
        field_weights=weights,
    )
