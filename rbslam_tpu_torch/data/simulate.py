"""Dense-workload dataset simulation, 6-D branch (port of
rbslam_tpu/data/simulate.py; examples/slam-dense-radio/generateData_dense.m).

1. ground-truth trajectory (data/trajectories.py);
2. domain LL = trajectory bounds padded by nLL * lengthScale (:226-231);
3. curl-free field draw with m_sim basis functions at the trajectory
   points, rotated per step to the body frame (:252-257);
4. odometry corruption (:294-323): run the model's own sampled dynamics
   forward from the initial state; the odometry is the differenced noisy
   path plus the noisy quaternion increments actually applied (:303-309).

Host-side float32 torch; the random draws come from one CPU
``torch.Generator``. The visualization grid of the reference package is
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..math.quaternions import quat_to_rmat
from .fields import draw_scalar_potential_field
from .trajectories import generate_trajectory


@dataclass
class DenseDataset:
    dx: torch.Tensor             # noisy odometry [T-1, 7]
    init_state: torch.Tensor     # [7]
    y: torch.Tensor              # body-frame measurements [T, 3]
    pos: np.ndarray              # ground-truth positions [T, 3]
    quat: np.ndarray             # ground-truth quaternions [T, 4]
    LL: np.ndarray               # domain bounds [2, 3]
    Q: torch.Tensor              # process noise used [T-1, 6, 6]
    odometry_path: np.ndarray    # noisy integrated path [T, 7]
    field_weights: torch.Tensor  # true field basis weights (m_sim basis)


def _domain_bounds(pos, length_scale, n_ll):
    lo = pos.min(0) - n_ll * length_scale
    hi = pos.max(0) + n_ll * length_scale
    return np.stack([[lo[0], lo[1], -n_ll * length_scale],
                     [hi[0], hi[1], n_ll * length_scale]])


def simulate_dense_dataset(traj_type: str, theta, Q, dt: float,
                           dynamics: Callable, m_sim: int = 2000,
                           n_ll: float = 2.0,
                           traj_kwargs: Optional[dict] = None, *,
                           generator: torch.Generator) -> DenseDataset:
    """Simulate one 6-D dense dataset.

    ``dynamics(w, xn, u, dt, Q) -> (xn', dq)`` with w a standard-normal
    [6] draw (models.mag3d.dynamics_with_increment). Draw order from
    ``generator``: field weights, measurement noise, then one [6] draw per
    odometry step.
    """
    traj = generate_trajectory(traj_type, **(traj_kwargs or {}))
    if traj.quat is None:
        raise NotImplementedError(
            "planar dataset families are not ported yet (ROADMAP queue 1 "
            "item 11)"
        )
    f32 = torch.float32
    T = traj.n_steps
    LL = _domain_bounds(traj.pos, float(theta[1]), n_ll)
    pts = torch.as_tensor(traj.pos, dtype=f32)
    draw = draw_scalar_potential_field(pts, m_sim, LL, theta,
                                       generator=generator)
    Rn = quat_to_rmat(torch.as_tensor(traj.quat, dtype=f32))
    y = torch.einsum("tij,tj->ti", Rn.transpose(-1, -2), draw.y[:T])

    Q = torch.as_tensor(Q, dtype=f32)
    Qt = Q.expand((T - 1,) + Q.shape) if Q.dim() == 2 else Q
    dx_clean = torch.as_tensor(traj.dx, dtype=f32)
    x = torch.as_tensor(traj.init_state, dtype=f32)
    w = torch.randn((T - 1, 6), generator=generator, dtype=f32)
    path, dqs = [x], []
    for t in range(T - 1):
        x, dq = dynamics(w[t], x, dx_clean[t], dt, Qt[t])
        path.append(x)
        dqs.append(dq)
    path = torch.stack(path)
    dx = torch.cat([torch.diff(path[:, :3], dim=0), torch.stack(dqs)], dim=-1)
    return DenseDataset(
        dx=dx,
        init_state=path[0],
        y=y,
        pos=traj.pos,
        quat=traj.quat,
        LL=LL,
        Q=Qt,
        odometry_path=path.numpy(),
        field_weights=draw.weights,
    )
