"""Procrustes alignment: scale + rotation/reflection + translation (port of
rbslam_tpu/math/procrustes.py).

Reproduces MATLAB ``procrustes(X, Y)`` as used for the reference's ATE
metrics (run_dense3D_magfield.m:155-160, calc_rmses.m:35-55): find scale
``b``, orthogonal ``T`` (reflections allowed) and translation ``c``
minimizing ``||X - b*Y*T - c||_F``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ProcrustesTransform(NamedTuple):
    b: torch.Tensor  # scalar scale
    T: torch.Tensor  # [d, d] orthogonal (right-multiplies row vectors)
    c: torch.Tensor  # [d] translation


def procrustes(X: torch.Tensor, Y: torch.Tensor):
    """Align Y (rows = points) onto X. Returns (Z, transform) with
    ``Z = b * Y @ T + c``."""
    muX = X.mean(dim=0)
    muY = Y.mean(dim=0)
    X0 = X - muX
    Y0 = Y - muY
    normX = torch.linalg.matrix_norm(X0)
    normY = torch.linalg.matrix_norm(Y0)
    A = (X0 / normX).T @ (Y0 / normY)
    U, s, Vt = torch.linalg.svd(A, full_matrices=False)
    T = Vt.T @ U.T
    b = torch.sum(s) * normX / normY
    c = muX - b * muY @ T
    return b * Y @ T + c, ProcrustesTransform(b=b, T=T, c=c)


def procrustes_transform(points: torch.Tensor, tf: ProcrustesTransform):
    """Apply a previously computed transform to new points (calc_rmses.m:38-46)."""
    return tf.b * points @ tf.T + tf.c
