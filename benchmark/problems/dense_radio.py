"""Dense radio-SLAM data made by the benchmark from a seed: the square
degeneracy path (planar position and heading), a scalar field drawn from
the squared-exponential GP prior, noisy signal-strength readings and
odometry whose heading noise spikes at the corners (the semantics of the
reference's generateData_dense.m and run_dense2D_withHeading.m:64-91,
frozen here so that no change to the program moves the yardstick).
Everything is drawn on the run's device from one generator and returned as
float32 arrays, which both the program and the plain reference are
handed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..reference.basis2d import Basis2D, domain


class DenseRadioData(NamedTuple):
    dx: torch.Tensor       # [T-1, 3] odometry: nav-frame step, heading step
    y: torch.Tensor        # [T, 1] field readings
    x0: torch.Tensor       # [3] initial pose
    Q: torch.Tensor        # [T-1, 1, 1] heading process noise
    R: torch.Tensor        # [1, 1] measurement noise
    dt: float
    LL: np.ndarray         # [2, 2] domain bounds
    theta: tuple           # (length scale, magnitude, noise variance)
    m: int                 # basis functions of the smoother's map
    truth: torch.Tensor    # [T, 2] true positions


def square_path(n: int, side: float) -> np.ndarray:
    """Positions [n, 2] of the square degeneracy path: four sides of n/4
    points each, counter-clockwise from the origin, centred."""
    q = n // 4
    up, down = np.linspace(0.0, side, q), np.linspace(side, 0.0, q)
    pos = np.stack([
        np.concatenate([np.zeros(q), up, side * np.ones(q), down]),
        np.concatenate([up, side * np.ones(q), down, np.zeros(q)]),
    ], axis=-1)
    return pos - pos.mean(0)


def heading_noise(p: dict) -> np.ndarray:
    """Heading process-noise variances [T-1]: the base value at every step
    and spike_std^2 at the three corners, steps n/4 (j + 1) - 1
    (run_dense2D_withHeading.m:82-88)."""
    n = int(p["n_steps"])
    q = np.full(n, float(p["q_heading_base"]))
    for j in range(3):
        q[n // 4 * (j + 1) - 1] = float(p["q_heading_spike_std"]) ** 2
    return q[: n - 1]


def make(config: dict, generator: torch.Generator,
         device) -> DenseRadioData:
    """Simulate one dataset of ``config["data"]`` on ``device``: field
    weights [m_sim], reading noise [T] and heading noise [T-1] are drawn
    from ``generator`` (on ``device``), in that order. The odometry
    integrates the true steps rotated into the noisy heading and reports
    the clean steps with the differenced noisy heading
    (generateData_dense.m:294-319)."""
    p = config["data"]
    if p["trajectory"] != "square_3D":
        raise ValueError(f"no simulation of trajectory {p['trajectory']!r}")
    f64 = torch.float64
    theta = tuple(float(t) for t in p["theta"])
    pos = square_path(int(p["n_steps"]), float(p["side"]))
    T = pos.shape[0]
    LL = domain(pos, theta[0], float(p["n_ll"]))
    field = Basis2D(LL, int(p["m_sim"]))
    z_w = torch.randn(field.m, generator=generator, device=device, dtype=f64)
    z_n = torch.randn(T, generator=generator, device=device, dtype=f64)
    z_o = torch.randn(T - 1, generator=generator, device=device, dtype=f64)
    weights = torch.as_tensor(np.sqrt(field.prior(theta)), device=device) * z_w
    x = torch.as_tensor(pos, device=device)
    y = field.phi(x) @ weights + math.sqrt(theta[2]) * z_n
    dt = float(p["dt"])
    q = torch.as_tensor(heading_noise(p), device=device)
    steps = x[1:] - x[:-1]
    heading = [torch.zeros((), dtype=f64, device=device)]
    for t in range(T - 1):
        heading.append(heading[-1] + torch.sqrt(dt * q[t]) * z_o[t])
    heading = torch.stack(heading)
    dx = torch.cat([steps, torch.diff(heading)[:, None]], dim=-1)
    f32 = torch.float32
    return DenseRadioData(
        dx=dx.to(f32), y=y[:, None].to(f32),
        x0=torch.cat([x[0], heading[:1]]).to(f32),
        Q=q.to(f32).reshape(-1, 1, 1),
        R=torch.full((1, 1), theta[2], dtype=f32, device=device),
        dt=dt, LL=LL, theta=theta, m=int(config["m_basis"]),
        truth=x.to(f32))


def build(config: dict, seed: int, device):
    """The cell's dataset, simulated from ``seed`` on ``device``, and the
    program's problem made of the same arrays: (data, basis, problem)."""
    from rbslam_tpu_torch.utils.interop import radio_problem_from_numpy

    from ..traffic import stream_seed

    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "data"))
    data = make(config, g, device)
    basis = Basis2D(data.LL, data.m)

    def host(t):
        return t.cpu().numpy()

    problem = radio_problem_from_numpy(
        basis.NN.astype(np.int32), basis.L, basis.eigenvalues,
        basis.center.astype(np.float32),
        basis.prior(data.theta).astype(np.float32), host(data.Q),
        host(data.R), data.dt, host(data.dx), host(data.y), host(data.x0),
        device=device)
    return data, basis, problem
