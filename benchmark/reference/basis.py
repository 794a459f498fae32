"""The reduced-rank curl-free field of dense magnetic SLAM, in plain PyTorch
and NumPy: the Laplacian eigenbasis on a box with Dirichlet boundaries
(Solin and Sarkka, "Hilbert space methods for reduced-rank Gaussian process
regression", Stat. Comput. 2020), its gradient, the spectral prior of the
linear-plus-squared-exponential potential, and the quaternion algebra of
the pose. Written for the benchmark from those definitions; it imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def domain(pos: np.ndarray, length_scale: float, n_ll: float) -> np.ndarray:
    """Bounds [2, 3] (rows min, max) of the box around planar positions
    [T, 3]: the x-y extent padded by n_ll length scales, z within +-n_ll
    length scales."""
    pad = n_ll * length_scale
    lo = pos.min(0) - pad
    hi = pos.max(0) + pad
    return np.array([[lo[0], lo[1], -pad], [hi[0], hi[1], pad]])


def select_indices(m: int, L: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The m multi-indices n (each entry >= 1) with the smallest
    eigenvalues sum_j (pi n_j / (2 L_j))^2, in a stable sort of the
    lexicographic grid. Returns (NN [m, d] int64, eigenvalues [m])."""
    L = np.asarray(L, np.float64)
    N = np.ceil(m ** (1.0 / L.size) * L / L.min()).astype(int)
    grids = np.meshgrid(*[np.arange(1, n + 1) for n in N], indexing="ij")
    NN = np.stack([g.ravel() for g in grids], axis=-1)
    lam = np.sum((np.pi * NN / (2.0 * L)) ** 2, axis=-1)
    order = np.argsort(lam, kind="stable")[:m]
    return NN[order], lam[order]


class Basis:
    """m eigenfunctions phi_n(x) = prod_j L_j^-1/2 sin(pi n_j (x_j + L_j)
    / (2 L_j)) on the box of half-widths L centred at ``center``, with
    the three linear-kernel states in front: the map state is
    [3 linear weights, m basis weights]."""

    def __init__(self, LL: np.ndarray, m: int):
        LL = np.asarray(LL, np.float64)
        self.center = LL.mean(0)
        self.L = (LL[1] - LL[0]) / 2.0
        self.NN, self.eigenvalues = select_indices(m, self.L)
        self.m = m
        self.n_lin = 3 + m

    def prior(self, theta) -> np.ndarray:
        """Prior variances [3 + m] for theta = (linear variance, length
        scale, magnitude, noise variance): the linear variance three
        times, then the 3-D squared-exponential spectral density at
        sqrt(eigenvalue)."""
        lin, ell, magn = float(theta[0]), float(theta[1]), float(theta[2])
        se = magn * (2.0 * math.pi) ** 1.5 * ell ** 3 \
            * np.exp(-self.eigenvalues * ell ** 2 / 2.0)
        return np.concatenate([np.full(3, lin), se])

    def grad_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[I_3 | d phi / dx] at positions x [..., 3] (not centred): the
        navigation-frame field rows [..., 3, 3 + m], in x's dtype."""
        NN = torch.as_tensor(self.NN, dtype=x.dtype, device=x.device)
        L = torch.as_tensor(self.L, dtype=x.dtype, device=x.device)
        c = torch.as_tensor(self.center, dtype=x.dtype, device=x.device)
        fac = math.pi * NN / (2.0 * L)                       # [m, 3]
        a = fac * ((x - c) + L)[..., None, :]                # [..., m, 3]
        s, co = torch.sin(a), torch.cos(a)
        scale = float(np.prod(1.0 / np.sqrt(self.L)))
        rows = []
        for i in range(3):
            prod = co[..., i]
            for j in range(3):
                if j != i:
                    prod = prod * s[..., j]
            rows.append(scale * fac[:, i] * prod)
        g = torch.stack(rows, dim=-2)                        # [..., 3, m]
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(
            g.shape[:-1] + (3,))
        return torch.cat([eye, g], dim=-1)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of scalar-first quaternions [..., 4]."""
    w1, v1 = a[..., :1], a[..., 1:]
    w2, v2 = b[..., :1], b[..., 1:]
    v1, v2 = torch.broadcast_tensors(v1, v2)
    w = w1 * w2 - (v1 * v2).sum(-1, keepdim=True)
    return torch.cat([w, w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2)],
                     dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def expq(phi: torch.Tensor) -> torch.Tensor:
    """exp of a pure quaternion: [cos|phi|, phi sin|phi| / |phi|], with a
    non-negative scalar part."""
    mag = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
    sinc = torch.where(mag > 0, torch.sin(mag) / torch.where(mag > 0, mag, 1),
                       torch.ones_like(mag))
    q = torch.cat([torch.cos(mag), phi * sinc], dim=-1)
    return torch.where(q[..., :1] < 0, -q, q)


def logq(q: torch.Tensor) -> torch.Tensor:
    """log of a unit quaternion [..., 4] -> [..., 3], taken on the
    hemisphere of a non-negative scalar part (the inverse of expq)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    na = torch.acos(torch.clamp(q[..., :1], -1.0, 1.0))
    s = torch.sin(na)
    return q[..., 1:] * torch.where(na > 0, na / torch.where(s > 0, s, 1),
                                    torch.ones_like(na))


def rmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] of the unit quaternion q (navigation from
    body)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
        2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z,
        2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x),
        w * w - x * x - y * y + z * z,
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def yaw_quat(psi: torch.Tensor) -> torch.Tensor:
    """Quaternion of the body-from-navigation yaw matrix [[c, s, 0],
    [-s, c, 0], [0, 0, 1]] at heading psi in (-pi, pi]: a rotation by
    -psi about z."""
    z = torch.zeros_like(psi)
    return torch.stack([torch.cos(psi / 2), z, z, -torch.sin(psi / 2)], -1)


def propagate(xn: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
              Lp: torch.Tensor, Lq: torch.Tensor) -> torch.Tensor:
    """Pose transition of run_dense3D_magfield.m:301-308 from standard
    normals w [N, 6]: p' = p + u_p + Lp w_p, q' = q (u_q exp(Lq w_q))."""
    p = xn[:, :3] + u[:3] + w[:, :3] @ Lp.T
    dq = qmul(u[3:7], expq(w[:, 3:] @ Lq.T))
    return torch.cat([p, qmul(xn[:, 3:7], dq)], dim=-1)
