"""Dense magnetic-field SLAM data made by the benchmark from a seed: the
bean-shaped 6-D trajectory, a curl-free field drawn from the GP prior,
body-frame magnetometer readings and noisy odometry (the semantics of the
reference's generateData_dense.m:181-213 and
gp_rnd_scalar_potential_fast.m, frozen here so that no change to the
program moves the yardstick). Everything is drawn on the run's device
from one generator and returned as float32 arrays, which both the program
and the plain reference are handed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..reference.basis import (
    Basis, domain, expq, qinv, qmul, rmat, yaw_quat)


class DenseMagData(NamedTuple):
    dx: torch.Tensor       # [T-1, 7] noisy odometry: position step, dq
    y: torch.Tensor        # [T, 3] body-frame field readings
    x0: torch.Tensor       # [7] initial pose
    Q: torch.Tensor        # [6, 6] process noise
    R: torch.Tensor        # [3, 3] measurement noise
    dt: float
    LL: np.ndarray         # [2, 3] domain bounds
    theta: tuple
    m: int                 # basis functions of the filter's map


def bean_6d(n_laps: int, n_per_lap: int, a: float = 15.0):
    """Positions [T, 3] and headings [T] of the bean curve
    r = a (sin^3 psi + cos^3 psi), n_laps half-turns of n_per_lap points,
    centred, at z = 0 (generateData_dense.m:181-213)."""
    psi = np.linspace(0.0, n_laps * np.pi, n_laps * n_per_lap)
    r = a * np.sin(psi) ** 3 + a * np.cos(psi) ** 3
    u, v = r * np.cos(psi) - 0.3, r * np.sin(psi) - 0.3
    th = np.arctan2(np.diff(v), np.diff(u))
    th = np.append(th, th[-1])
    pos = np.stack([u, v, np.zeros_like(u)], axis=-1)
    return pos - (pos.min(0) + pos.max(0)) / 2.0, th


def process_noise(params: dict) -> np.ndarray:
    """Q = blkdiag(diag(pos_std^2), diag((ori_std_deg pi / 180)^2))
    (main.m:22)."""
    pos = np.asarray(params["q_pos_std"], np.float64) ** 2
    ori = (np.asarray(params["q_ori_std_deg"], np.float64) * np.pi / 180) ** 2
    return np.diag(np.concatenate([pos, ori]))


def make(config: dict, generator: torch.Generator, device) -> DenseMagData:
    """Simulate one dataset of ``config["data"]`` on ``device``: field
    weights [3 + m_sim], readings noise [T, 3] and odometry noise [T-1, 6]
    are drawn from ``generator`` (on ``device``), in that order."""
    p = config["data"]
    if p["trajectory"] != "bean_6D":
        raise ValueError(f"no simulation of trajectory {p['trajectory']!r}")
    f64 = torch.float64
    theta = tuple(float(t) for t in p["theta"])
    pos, th = bean_6d(p["n_laps"], p["n_per_lap"], p["a"])
    T = pos.shape[0]
    LL = domain(pos, theta[1], p["n_ll"])
    field = Basis(LL, p["m_sim"])
    z_w = torch.randn(field.n_lin, generator=generator, device=device,
                      dtype=f64)
    z_n = torch.randn((T, 3), generator=generator, device=device, dtype=f64)
    z_o = torch.randn((T - 1, 6), generator=generator, device=device,
                      dtype=f64)
    weights = torch.as_tensor(np.sqrt(field.prior(theta)), device=device) * z_w
    x = torch.as_tensor(pos, device=device)
    q = yaw_quat(torch.as_tensor(th, device=device))
    y_nav = field.grad_rows(x) @ weights + math.sqrt(theta[3]) * z_n
    y = torch.einsum("tji,tj->ti", rmat(q), y_nav)          # R(q)' y_nav
    # a constant disturbance of the readings (main.m:40)
    y = y + torch.as_tensor(p["mag_disturbance"], dtype=f64, device=device)
    Q = process_noise(p)
    dt = float(p["dt"])
    Lp = torch.as_tensor(np.sqrt(dt * np.diag(Q)[:3]), device=device)
    Lq = torch.as_tensor(np.sqrt(dt * np.diag(Q)[3:]), device=device)
    dq = qmul(qmul(qinv(q[:-1]), q[1:]), expq(z_o[:, 3:] * Lq))
    dx = torch.cat([x[1:] - x[:-1] + z_o[:, :3] * Lp, dq], dim=-1)
    f32 = torch.float32
    return DenseMagData(
        dx=dx.to(f32), y=y.to(f32), x0=torch.cat([x[0], q[0]]).to(f32),
        Q=torch.as_tensor(Q, dtype=f32, device=device),
        R=theta[3] * torch.eye(3, dtype=f32, device=device),
        dt=dt, LL=LL, theta=theta, m=int(config["m_basis"]))


def build(config: dict, seed: int, device):
    """The cell's dataset, simulated from ``seed`` on ``device``, and the
    program's problem made of the same arrays: (data, basis, problem)."""
    from rbslam_tpu_torch.utils.interop import problem_from_numpy

    from ..traffic import stream_seed

    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "data"))
    data = make(config, g, device)
    basis = Basis(data.LL, data.m)

    def host(t):
        return t.cpu().numpy()

    problem = problem_from_numpy(
        basis.NN.astype(np.int32), basis.L, basis.eigenvalues,
        basis.center.astype(np.float32),
        basis.prior(data.theta).astype(np.float32), host(data.Q),
        host(data.R), data.dt, host(data.dx), host(data.y), host(data.x0),
        device=device)
    return data, basis, problem
