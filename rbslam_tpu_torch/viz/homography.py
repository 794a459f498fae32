"""DLT homography estimation for camera-overlay visualization (port of
rbslam_tpu/viz/homography.py, NumPy only).

Reference: tools/homography_estimation.m:38-44 — least-squares estimate
of the projective map y = A x / (c x) from point correspondences, used
by the mag-localization workload to overlay particle clouds on camera
frames.
"""

from __future__ import annotations

import numpy as np


def estimate_homography(src, dst):
    """Fit dst ~ (A [src;1]) / (c [src;1]).

    src, dst: [n, 2] corresponding points. Returns (A [2,3], c [3])
    with the normalization c[2] pinned through the homogeneous scale.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    ones = np.ones((n, 1))
    X = np.concatenate([src, ones], axis=1)          # [n, 3]
    # rows: [X 0 -x' X ; 0 X -y' X] h = 0 with h = [A1; A2; c]
    rows = []
    for i in range(n):
        rows.append(np.concatenate([X[i], np.zeros(3), -dst[i, 0] * X[i]]))
        rows.append(np.concatenate([np.zeros(3), X[i], -dst[i, 1] * X[i]]))
    M = np.stack(rows)
    _, _, Vt = np.linalg.svd(M)
    h = Vt[-1]
    A = h[:6].reshape(2, 3)
    c = h[6:]
    return A, c


def apply_homography(A, c, pts):
    """Map [n, 2] points through the homography."""
    pts = np.asarray(pts, np.float64)
    X = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    num = X @ A.T
    den = X @ c
    return num / den[:, None]
