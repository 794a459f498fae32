"""Laplacian eigenbasis on a centered hypercube with Dirichlet boundaries
(port of rbslam_tpu/basis/laplace.py; tools/domain_cartesian_dx.m).

- eigenvalues  ``lambda(n) = sum_j (pi * n_j / (2 L_j))^2``  (:40)
- eigenfunctions ``phi_n(x) = prod_j L_j^{-1/2} sin(pi n_j (x_j + L_j)/(2 L_j))``
  (:88-93), with analytic first derivatives (:146-170).

The index set is static data chosen on the host with numpy; evaluation
works on torch tensors of any device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


def _ndgrid_indices(N: np.ndarray) -> np.ndarray:
    """All index combinations 1..N_j per dimension (domain_cartesian_dx.m:174-218)."""
    axes = [np.arange(1, n + 1) for n in N]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def select_indices(m: int, L: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pick the m index tuples with smallest eigenvalues (stable order,
    as MATLAB's sort of the over-generated grid, domain_cartesian_dx.m:43).
    Returns ``(NN [m, d] int32, eigenvalues [m] float64)``."""
    L = np.asarray(L, dtype=np.float64).reshape(-1)
    d = L.shape[0]
    N = np.ceil(m ** (1.0 / d) * L / np.min(L)).astype(int)
    NN = _ndgrid_indices(N)
    lam = np.sum((np.pi * NN / (2.0 * L)) ** 2, axis=-1)
    order = np.argsort(lam, kind="stable")[:m]
    return NN[order].astype(np.int32), lam[order]


@dataclass(frozen=True)
class LaplaceBasis:
    """Static eigenbasis: index set NN, half-widths L, eigenvalues."""

    NN: np.ndarray           # [m, d] int32
    L: np.ndarray            # [d] float64 half-widths
    eigenvalues: np.ndarray  # [m] float64
    # NN and L as tensors, by (device, dtype): copying them from the host
    # at every evaluation is a host-device sync on a CUDA device
    _tensors: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    @property
    def m(self) -> int:
        return int(self.NN.shape[0])

    @property
    def d(self) -> int:
        return int(self.NN.shape[1])

    def _args(self, x: torch.Tensor):
        """Phase arguments a[..., m, d] = pi n_j (x_j + L_j) / (2 L_j)."""
        key = (x.device, x.dtype)
        if key not in self._tensors:
            self._tensors[key] = (
                torch.as_tensor(self.NN, dtype=x.dtype, device=x.device),
                torch.as_tensor(self.L, dtype=x.dtype, device=x.device))
        NN, L = self._tensors[key]
        shifted = (x + L)[..., None, :]
        return math.pi * NN * shifted / (2.0 * L), NN, L

    def phi(self, x: torch.Tensor) -> torch.Tensor:
        """Eigenfunctions at x [..., d] -> [..., m]."""
        a, _, L = self._args(x)
        scale = torch.prod(1.0 / torch.sqrt(L))
        return scale * torch.prod(torch.sin(a), dim=-1)

    def grad_phi(self, x: torch.Tensor) -> torch.Tensor:
        """All first derivatives stacked: [..., d, m] (one sin and one cos
        pass over the phase array, shared by the d outputs)."""
        a, NN, L = self._args(x)
        scale = torch.prod(1.0 / torch.sqrt(L))
        s = torch.sin(a)
        c = torch.cos(a)
        fac = math.pi * NN / (2.0 * L)
        if self.d == 1:
            return (scale * fac[:, 0] * c[..., 0])[..., None, :]
        rows = []
        for i in range(self.d):
            prod = c[..., i]
            for j in range(self.d):
                if j != i:
                    prod = prod * s[..., j]
            rows.append(scale * fac[:, i] * prod)
        return torch.stack(rows, dim=-2)

    def hess_phi(self, x: torch.Tensor) -> torch.Tensor:
        """Second derivatives d^2 phi / (dx_i dx_j): [..., d, d, m], the
        pose block of the dense EKF's measurement Jacobian
        (tools/JacobianPhi3D.m:43-64)."""
        a, NN, L = self._args(x)
        scale = torch.prod(1.0 / torch.sqrt(L))
        s = torch.sin(a)
        c = torch.cos(a)
        fac = math.pi * NN / (2.0 * L)
        rows = []
        for i in range(self.d):
            cols = []
            for j in range(self.d):
                if i == j:
                    val = -(fac[:, i] ** 2) * torch.prod(s, dim=-1)
                else:
                    prod = c[..., i] * c[..., j]
                    for k in range(self.d):
                        if k != i and k != j:
                            prod = prod * s[..., k]
                    val = fac[:, i] * fac[:, j] * prod
                cols.append(scale * val)
            rows.append(torch.stack(cols, dim=-2))
        return torch.stack(rows, dim=-3)


def hypercube_basis(m: int, LL) -> LaplaceBasis:
    """Basis from half-widths ``[d]`` or bounds ``[2, d]`` (rows min, max;
    the domain is then centered, domain_cartesian_dx.m:27-29)."""
    LL = np.asarray(LL, dtype=np.float64)
    L = (LL[1] - LL[0]) / 2.0 if LL.ndim > 1 else LL
    NN, lam = select_indices(m, L)
    return LaplaceBasis(NN=NN, L=np.asarray(L), eigenvalues=lam)


def domain_center(LL) -> np.ndarray:
    """Center of a (min, max) bounds array [2, d]."""
    return np.mean(np.asarray(LL, dtype=np.float64), axis=0)
