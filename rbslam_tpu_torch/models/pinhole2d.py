"""Sparse visual-SLAM model: 2D pose + heading, pinhole landmark camera
(port of rbslam_tpu/models/pinhole2d.py; examples/slam-sparse-visual/).

- state xn = [p1, p2, theta]; linear state xl = the flattened landmark
  positions [2 M] (pfslam.m:90-92);
- dynamics: a random walk driven by odometry, xn' = xn + u + sqrt(dt Q) xi
  (pfslam.m:81);
- measurement (measurement.m:44-79): the 1D pinhole projection of each
  landmark, u = K [R' | -R' p] [m; 1], y_j = u1_j / u2_j, with its
  derivatives with respect to the landmark coordinates (the onlyLin path);
- visibility: landmarks behind the camera or out of the field of view are
  NaN in the data, and the engines mask on ``isfinite(y_t)``
  (src/particleFilter.m:134-136); ``not_visible`` from the predicted
  geometry serves data simulation.

Every function broadcasts over leading axes: the filter passes the
ensemble [N, ...], the smoother's future weights the ensemble against
the whole reference trajectory [N, T, ...].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import SparseModel


class PinholeCamera(NamedTuple):
    f: float   # focal length (load_data.m:62)
    fp: float  # principal point
    fw: float  # image half-width (field of view bound)


def project(camera: PinholeCamera, xn, landmarks):
    """Project landmarks [..., M, 2] through the camera at poses
    xn [..., 3] = [p, theta]. Returns (y [..., M], not_visible [..., M])."""
    p, th = xn[..., None, :2], xn[..., 2:3]
    c, s = torch.cos(th), torch.sin(th)
    # rows of K [R' | -R' p] with R = [[c, -s], [s, c]]
    rel = landmarks - p
    cam0 = c * rel[..., 0] + s * rel[..., 1]
    cam1 = -s * rel[..., 0] + c * rel[..., 1]
    u1 = camera.f * cam0 + camera.fp * cam1
    y = u1 / cam1
    not_visible = (cam1 < 0) | (torch.abs(y) > camera.fw)
    return y, not_visible


def landmark_jacobian(camera: PinholeCamera, xn, landmarks):
    """d y_j / d m_j [..., M, 2] (measurement.m:72-79), the diagonal blocks
    of the [M, 2M] measurement matrix."""
    p0, p1, th = xn[..., 0:1], xn[..., 1:2], xn[..., 2:3]
    m1, m2 = landmarks[..., 0], landmarks[..., 1]
    div = (m2 * torch.cos(th) - p1 * torch.cos(th)
           - m1 * torch.sin(th) + p0 * torch.sin(th)) ** 2
    dym1 = camera.f * (m2 - p1) / div
    dym2 = -camera.f * (m1 - p0) / div
    return torch.stack([dym1, dym2], dim=-1)


def make_pinhole2d_model(camera: PinholeCamera,
                         n_landmarks: int) -> SparseModel:
    M = n_landmarks

    def dynamics(w, xn, u, dt, Q):
        L = torch.sqrt(torch.as_tensor(dt)) * torch.sqrt(torch.diagonal(Q))
        return xn + u + L * w

    def measure(xn, xl):
        landmarks = xl.reshape(xl.shape[:-1] + (M, 2))
        yhat, _ = project(camera, xn, landmarks)
        dm = landmark_jacobian(camera, xn, landmarks)       # [..., M, 2]
        # the block-diagonal [M, 2M] matrix, H[j, 2j + c] = dm[j, c]: the
        # diagonal of a zero [..., M, M, 2] block, written as a view
        H = dm.new_zeros(dm.shape[:-2] + (M, M, 2))
        torch.diagonal(H, dim1=-3, dim2=-2).copy_(dm.transpose(-1, -2))
        return yhat, H.reshape(dm.shape[:-2] + (M, 2 * M))

    return SparseModel(
        dynamics=dynamics,
        dyn_residual=None,  # Euclidean default (psslam.m:118)
        measure=measure,
        n_nonlin=3, n_lin=2 * M, ny=M, n_noise=3,
        dynamics_batch=dynamics,
    )
