"""Sparse visual-SLAM dataset: the 20-landmark bean curve seen by a 1D
pinhole camera (port of rbslam_tpu/data/sparse_visual.py;
examples/slam-sparse-visual/load_data.m).

The trajectory and observation fixture ``curve-x2.mat`` ships with the
reference repository and is vendored unmodified at
``rbslam_tpu/data/assets/curve-x2.mat``; this module reads it by path.
The loader reproduces the reference's corruption: odometry noise and a
position-drift bias (:80-87), fresh observation noise (:90) and optional
swaps of adjacent landmark ids (:109-129). The draws come from a
``torch.Generator`` (CPU), or from ``draws`` when given, so a test can
inject the JAX package's.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.pinhole2d import PinholeCamera

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "rbslam_tpu", "data", "assets",
    "curve-x2.mat")


class SparseVisualData(NamedTuple):
    y: torch.Tensor           # [T, M] noisy projections (NaN = not visible)
    u: torch.Tensor           # [T-1, 3] noisy odometry (dPos, dTheta)
    landmarks: np.ndarray     # [M, 2] true map
    ground_truth: np.ndarray  # [T, 3] true (p1, p2, theta)
    init_pos: np.ndarray      # [2]
    init_theta: float
    camera: PinholeCamera


class SparseVisualDraws(NamedTuple):
    """The loader's random draws: standard normals z_pos [T-1, 2],
    z_theta [T-1, 1], z_y [T, M]; and per shuffle (``n_shuffle`` of them)
    the time index t_shuffle and the first landmark id j_shuffle of the
    swapped pair."""

    z_pos: np.ndarray
    z_theta: np.ndarray
    z_y: np.ndarray
    t_shuffle: np.ndarray
    j_shuffle: np.ndarray


def draw_corruption(generator: torch.Generator, T: int, M: int,
                    n_shuffle: int = 0) -> SparseVisualDraws:
    """The loader's draws from ``generator`` (a CPU generator)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator).numpy()

    return SparseVisualDraws(
        z_pos=normal(T - 1, 2), z_theta=normal(T - 1, 1), z_y=normal(T, M),
        t_shuffle=torch.randint(0, T, (n_shuffle,),
                                generator=generator).numpy(),
        j_shuffle=torch.randint(0, M // 2 - 1, (n_shuffle,),
                                generator=generator).numpy(),
    )


def load_sparse_visual(generator: Optional[torch.Generator] = None,
                       pos_var: float = 0.04**2, pos_bias: float = 0.01,
                       angle_var: float = (0.001**2) ** 2,
                       obs_noise_std: float = 0.01, n_shuffle: int = 0,
                       path: Optional[str] = None,
                       draws: Optional[SparseVisualDraws] = None, *,
                       device="cuda") -> SparseVisualData:
    """Read the fixture and corrupt it with the draws of ``generator`` (or
    ``draws``); y and u come back as float32 tensors on ``device``."""
    import scipy.io as sio

    d = sio.loadmat(path or ASSET)
    p = d["p"]              # [2, T]
    th = d["th"].ravel()    # [T]
    Yclean = d["Yclean"]    # [M, T]
    landmarks = d["map"].T  # [M, 2]
    M, T = Yclean.shape
    if draws is None:
        if generator is None:
            raise ValueError("give a torch.Generator or the draws")
        draws = draw_corruption(generator, T, M, n_shuffle)

    dpos = np.diff(p, axis=1).T                  # [T-1, 2]
    dth = np.diff(np.unwrap(th))[:, None]        # [T-1, 1]
    u = np.concatenate([dpos, dth], axis=-1)
    u = u + np.concatenate(
        [np.sqrt(pos_var) * np.asarray(draws.z_pos) + pos_bias,
         np.sqrt(angle_var) * np.asarray(draws.z_theta)], axis=-1)
    y = Yclean.T + obs_noise_std * np.asarray(draws.z_y)
    # corrupt some observations by swapping adjacent landmark ids
    # (:109-129), in time order
    order = np.argsort(np.asarray(draws.t_shuffle), kind="stable")
    for i in order:
        t, j = int(draws.t_shuffle[i]), int(draws.j_shuffle[i])
        y[t, [j, j + 1]] = y[t, [j + 1, j]]

    device = torch.device(device)
    return SparseVisualData(
        y=torch.as_tensor(y, dtype=torch.float32, device=device),
        u=torch.as_tensor(u, dtype=torch.float32, device=device),
        landmarks=landmarks,
        ground_truth=np.concatenate([p.T, th[:, None]], axis=-1),
        init_pos=p[:, 0].copy(),
        init_theta=float(th[0]),
        camera=PinholeCamera(f=1.5, fp=0.0, fw=1.0),  # load_data.m:60-64
    )
