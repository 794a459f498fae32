"""Magnetic-map localization data made by the benchmark from a seed: a
curl-free field drawn from the GP prior, noisy field readings along a
lawnmower mapping path (the data the map is fitted to), and a test loop
with its body-frame readings and odometry, on which a robot localizes
from a uniform cloud over the mapped area (upstream
examples/mag-localization-mapping/run_localization.m:27-30,150-161, with
the synthetic environment of the port's workloads/mag_localization.py
frozen here, so that no change to the program moves the yardstick).
Everything is drawn on the run's device from one generator and handed
as float32 arrays to the program and to the plain reference alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..reference.basis import Basis, qinv, qmul, rmat, yaw_quat
from .dense_mag import process_noise


class LocalizationData(NamedTuple):
    x_map: torch.Tensor    # [n_map, 3] mapping positions
    y_map: torch.Tensor    # [n_map, 3] navigation-frame readings on them
    LL: np.ndarray         # [2, 3] bounds of the map's domain
    theta: tuple           # (linear var, length scale, magnitude, noise var)
    m: int                 # basis functions of the map
    dx: torch.Tensor       # [T-1, 7] odometry: position step, dq
    y: torch.Tensor        # [T, 3] body-frame readings on the test loop
    x0: torch.Tensor       # [7] true initial pose
    truth: torch.Tensor    # [T, 3] true positions of the test loop
    lo: torch.Tensor       # [2] corner of the mapped area (the cloud's)
    hi: torch.Tensor       # [2] opposite corner
    Q: torch.Tensor        # [6, 6] process noise
    dt: float
    mode: str              # "sum" (run_localization.m:270) or "product"


def lawnmower(extent: float, n_lines: int, pts_per_line: int) -> np.ndarray:
    """[n_lines * pts_per_line, 3] positions: n_lines passes along y over
    [-extent, extent]^2, alternating direction, at z = 0."""
    rows = []
    for i, x in enumerate(np.linspace(-extent, extent, n_lines)):
        ys = np.linspace(-extent, extent, pts_per_line)
        rows.append(np.stack([np.full_like(ys, x), ys[::-1] if i % 2 else ys],
                             -1))
    path = np.concatenate(rows, 0)
    return np.concatenate([path, np.zeros((len(path), 1))], -1)


def loop_path(extent: float, n_steps: int) -> np.ndarray:
    """[n_steps, 3] positions of a figure-eight loop at z = 0."""
    t = np.linspace(0, 2 * np.pi, n_steps)
    r = 0.6 * extent
    return np.stack([r * np.cos(t), 0.7 * r * np.sin(2 * t),
                     np.zeros_like(t)], -1)


def make(config: dict, generator: torch.Generator,
         device) -> LocalizationData:
    """Simulate one environment of ``config["data"]`` on ``device``: the
    field's weights [3 + m_sim] and the readings' noise [n_map + T, 3] are
    drawn from ``generator``, in that order."""
    p = config["data"]
    f64, f32 = torch.float64, torch.float32
    theta = tuple(float(t) for t in p["theta"])
    e = float(p["extent"])
    x_map = lawnmower(e, p["n_map_lines"], p["pts_per_line"])
    x_test = loop_path(e, p["n_test_steps"])
    pad, z = float(p["sim_pad"]), float(p["sim_z"])
    field = Basis(np.array([[-e - pad, -e - pad, -z], [e + pad, e + pad, z]]),
                  p["m_sim"])
    z_w = torch.randn(field.n_lin, generator=generator, device=device,
                      dtype=f64)
    n_all = len(x_map) + len(x_test)
    z_n = torch.randn((n_all, 3), generator=generator, device=device,
                      dtype=f64)
    weights = torch.as_tensor(np.sqrt(field.prior(theta)), device=device) * z_w
    x_all = torch.as_tensor(np.concatenate([x_map, x_test]), device=device)
    y_nav = field.grad_rows(x_all) @ weights + math.sqrt(theta[3]) * z_n
    y_map, y_test = y_nav[:len(x_map)], y_nav[len(x_map):]
    # the heading of the loop; q rotates the body frame into the
    # navigation frame (yaw_quat(-psi) is a rotation by +psi about z)
    d = np.diff(x_test[:, :2], axis=0)
    psi = np.arctan2(d[:, 1], d[:, 0])
    psi = np.append(psi, psi[-1])
    q = yaw_quat(-torch.as_tensor(psi, device=device))
    y_body = torch.einsum("tji,tj->ti", rmat(q), y_test)     # R(q)' y_nav
    xt = torch.as_tensor(x_test, device=device)
    dx = torch.cat([xt[1:] - xt[:-1], qmul(qinv(q[:-1]), q[1:])], dim=-1)
    # the map's domain: the mapped area padded by a share of its extent
    lo, hi = x_map.min(0), x_map.max(0)
    rng = hi - lo
    mpad = float(p["map_pad"]) * float(np.min(rng[rng > 0]))
    return LocalizationData(
        x_map=torch.as_tensor(x_map, dtype=f32, device=device),
        y_map=y_map.to(f32), LL=np.stack([lo - mpad, hi + mpad]),
        theta=theta, m=int(config["m_basis"]), dx=dx.to(f32),
        y=y_body.to(f32), x0=torch.cat([xt[0], q[0]]).to(f32),
        truth=xt.to(f32),
        lo=torch.as_tensor(lo[:2], dtype=f32, device=device),
        hi=torch.as_tensor(hi[:2], dtype=f32, device=device),
        Q=torch.as_tensor(process_noise(p), dtype=f32, device=device),
        dt=float(p["dt"]), mode=str(config["weight_mode"]))


def initial_cloud(data: LocalizationData, u: torch.Tensor) -> torch.Tensor:
    """[N, 7] float32 poses from uniforms u [N, 2]: positions spread
    uniformly over the mapped area (run_localization.m:156-161), the
    height and orientation of the true initial pose."""
    x0 = data.x0.expand(u.shape[0], -1)
    return torch.cat([data.lo + (data.hi - data.lo) * u, x0[:, 2:]], dim=-1)


def build(config: dict, seed: int, device) -> LocalizationData:
    """The cell's environment, simulated from ``seed`` on ``device``."""
    from ..traffic import stream_seed

    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "data"))
    return make(config, g, device)
