"""The reduced-rank scalar field of dense radio SLAM, in plain PyTorch and
NumPy: the Laplacian eigenbasis on a planar box with Dirichlet boundaries
(Solin and Sarkka, "Hilbert space methods for reduced-rank Gaussian process
regression", Stat. Comput. 2020) and the spectral density of the
squared-exponential kernel in two dimensions. Written for the benchmark
from those definitions; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .basis import select_indices


def domain(pos: np.ndarray, length_scale: float, n_ll: float) -> np.ndarray:
    """Bounds [2, 2] (rows min, max) of the box around planar positions
    [T, 2], padded by n_ll length scales on every side."""
    pad = n_ll * length_scale
    return np.stack([pos.min(0) - pad, pos.max(0) + pad])


class Basis2D:
    """m eigenfunctions phi_n(x) = prod_j L_j^-1/2 sin(pi n_j (x_j + L_j)
    / (2 L_j)) on the box of half-widths L centred at ``center``: the map
    state is the m basis weights."""

    def __init__(self, LL: np.ndarray, m: int):
        LL = np.asarray(LL, np.float64)
        self.center = LL.mean(0)
        self.L = (LL[1] - LL[0]) / 2.0
        self.NN, self.eigenvalues = select_indices(m, self.L)
        self.m = self.n_lin = m

    def prior(self, theta) -> np.ndarray:
        """Prior variances [m] for theta = (length scale, magnitude, noise
        variance): the 2-D squared-exponential spectral density
        magn 2 pi ell^2 exp(-lambda ell^2 / 2) at sqrt(eigenvalue)."""
        ell, magn = float(theta[0]), float(theta[1])
        return magn * 2.0 * math.pi * ell ** 2 \
            * np.exp(-self.eigenvalues * ell ** 2 / 2.0)

    def phi(self, x: torch.Tensor) -> torch.Tensor:
        """The eigenfunctions at planar positions x [..., 2] (not
        centred): [..., m], in x's dtype."""
        NN = torch.as_tensor(self.NN, dtype=x.dtype, device=x.device)
        L = torch.as_tensor(self.L, dtype=x.dtype, device=x.device)
        c = torch.as_tensor(self.center, dtype=x.dtype, device=x.device)
        a = math.pi * NN * ((x - c) + L)[..., None, :] / (2.0 * L)
        scale = float(np.prod(1.0 / np.sqrt(self.L)))
        return scale * torch.sin(a[..., 0]) * torch.sin(a[..., 1])
