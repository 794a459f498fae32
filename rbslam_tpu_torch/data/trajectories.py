"""Ground-truth trajectory generators (port of rbslam_tpu/data/trajectories.py;
examples/slam-dense-radio/generateData_dense.m:67-214).

All nine trajectory families of the reference's data generator:
circle_2D, bean_2D, square_3D, line_{2D,3D,3D_withPos}, line_6D,
circle_6D, bean_6D. "3D" = planar position + heading; "6D" = 3-D position
+ quaternion. Deterministic geometry computed with numpy on the host; the
quaternion steps run in float32 torch, as the reference computes them in
float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..math.quaternions import qinv, qmul, rmat_to_quat


@dataclass(frozen=True)
class Trajectory:
    """Ground truth: positions [T, 2|3], optional quaternions [T, 4],
    initial full state, and noiseless odometry increments [T-1, ...]."""

    pos: np.ndarray
    quat: Optional[np.ndarray]
    init_state: np.ndarray
    dx: np.ndarray

    @property
    def n_steps(self) -> int:
        return int(self.pos.shape[0])


def _heading_from_diffs(u, v):
    th = np.arctan2(np.diff(v), np.diff(u))
    return np.append(th, th[-1])


def _yaw_rmats(psi):
    """Body-from-nav rotations (generateData_dense.m:196-198):
    R = [[c, s, 0], [-s, c, 0], [0, 0, 1]]."""
    R = np.zeros((psi.shape[0], 3, 3))
    R[:, 0, 0] = np.cos(psi)
    R[:, 0, 1] = np.sin(psi)
    R[:, 1, 0] = -np.sin(psi)
    R[:, 1, 1] = np.cos(psi)
    R[:, 2, 2] = 1.0
    return R


def _quat_increments(quat):
    """dq_t = q_t^{-1} ⊗ q_{t+1} (generateData_dense.m:211-213)."""
    q = torch.as_tensor(quat, dtype=torch.float32)
    return qmul(qinv(q[:-1]), q[1:]).numpy()


def _bean_curve(n_laps, n_per_lap, a):
    psi = np.linspace(0.0, n_laps * np.pi, n_laps * n_per_lap)
    r = a * np.sin(psi) ** 3 + a * np.cos(psi) ** 3
    return r * np.cos(psi) - 0.3, r * np.sin(psi) - 0.3


def circle_2d(radius=2.0, n_laps=3, dpsi_deg=5.0) -> Trajectory:
    psi = np.arange(0.0, 360.0 * n_laps, dpsi_deg) * np.pi / 180.0
    pos = np.stack([radius * np.cos(psi), radius * np.sin(psi)], axis=-1)
    return Trajectory(pos, None, pos[0].copy(), np.diff(pos, axis=0))


def bean_2d(n_laps=3, n_per_lap=63, a=5.0) -> Trajectory:
    psi = np.linspace(0.0, np.pi, n_per_lap)
    r = a * np.sin(psi) ** 3 + a * np.cos(psi) ** 3
    pos = np.stack([r * np.cos(psi) - 0.3, r * np.sin(psi) - 0.3], axis=-1)
    pos = pos - (pos.min(0) + pos.max(0)) / 2.0
    pos = np.concatenate([pos] + [pos[1:]] * (n_laps - 1), axis=0)
    return Trajectory(pos, None, pos[0].copy(), np.diff(pos, axis=0))


def square_3d(n=48, side=2.0) -> Trajectory:
    q = n // 4
    pos = np.stack(
        [
            np.concatenate(
                [np.zeros(q), np.linspace(0, side, q), side * np.ones(q),
                 np.linspace(side, 0, q)]
            ),
            np.concatenate(
                [np.linspace(0, side, q), side * np.ones(q),
                 np.linspace(side, 0, q), np.zeros(q)]
            ),
        ],
        axis=-1,
    )
    pos = pos - pos.mean(0)
    init = np.append(pos[0], 0.0)
    dx = np.concatenate([np.diff(pos, axis=0), np.zeros((n - 1, 1))], axis=-1)
    return Trajectory(pos, None, init, dx)


def line_path(n=32, length=3.0, with_heading=True) -> Trajectory:
    pos = np.stack(
        [
            np.zeros(n),
            np.concatenate(
                [np.linspace(0, length, n // 2),
                 np.linspace(length, 0, n - n // 2)]
            ),
        ],
        axis=-1,
    )
    pos = pos - pos.mean(0)
    dx = np.diff(pos, axis=0)
    if with_heading:
        init = np.append(pos[0], 0.0)
        dx = np.concatenate([dx, np.zeros((n - 1, 1))], axis=-1)
    else:
        init = pos[0].copy()
    return Trajectory(pos, None, init, dx)


def _quat_of_yaw(psi) -> np.ndarray:
    return rmat_to_quat(
        torch.as_tensor(_yaw_rmats(psi), dtype=torch.float32)).numpy()


def _six_d(pos, quat) -> Trajectory:
    init = np.concatenate([pos[0], quat[0]])
    dx = np.concatenate(
        [np.diff(pos, axis=0), _quat_increments(quat)], axis=-1
    )
    return Trajectory(pos, quat, init, dx)


def line_6d(n=32, length=3.0) -> Trajectory:
    pos = np.stack(
        [
            np.zeros(n),
            np.concatenate(
                [np.linspace(0, length, n // 2),
                 np.linspace(length, 0, n - n // 2)]
            ),
            np.zeros(n),
        ],
        axis=-1,
    )
    pos = pos - pos.mean(0)
    quat = np.concatenate(
        [np.tile([1.0, 0, 0, 0], (n // 2, 1)),
         np.tile([0.0, 0, 0, -1.0], (n - n // 2, 1))],
        axis=0,
    )
    return _six_d(pos, quat)


def circle_6d(radius=2.0, n_laps=2, dpsi_deg=5.0) -> Trajectory:
    psi = np.tile(np.arange(0.0, 360.0, dpsi_deg) * np.pi / 180.0, n_laps)
    pos = np.stack(
        [radius * np.cos(psi), radius * np.sin(psi), np.zeros_like(psi)],
        axis=-1,
    )
    return _six_d(pos, _quat_of_yaw(psi))


def bean_6d(n_laps=3, n_per_lap=64, a=15.0) -> Trajectory:
    u, v = _bean_curve(n_laps, n_per_lap, a)
    th = _heading_from_diffs(u, v)
    pos = np.stack([u, v, np.zeros_like(u)], axis=-1)
    pos = pos - (pos.min(0) + pos.max(0)) / 2.0
    return _six_d(pos, _quat_of_yaw(th))


TRAJECTORY_TYPES = {
    "circle_2D": circle_2d,
    "bean_2D": bean_2d,
    "square_3D": square_3d,
    "line_2D": lambda **kw: line_path(with_heading=False, **kw),
    "line_3D": lambda **kw: line_path(with_heading=True, **kw),
    "line_3D_withPos": lambda **kw: line_path(with_heading=True, **kw),
    "line_6D": line_6d,
    "circle_6D": circle_6d,
    "bean_6D": bean_6d,
}


def generate_trajectory(traj_type: str, **kwargs) -> Trajectory:
    try:
        fn = TRAJECTORY_TYPES[traj_type]
    except KeyError:
        raise ValueError(
            f"unknown trajectory type {traj_type!r}; "
            f"options: {sorted(TRAJECTORY_TYPES)}"
        ) from None
    return fn(**kwargs)
