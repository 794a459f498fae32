"""Curl-free (scalar-potential) field basis (port of
rbslam_tpu/basis/potential.py; gp_rnd_scalar_potential_fast.m:63-68).

The field is the gradient of a potential ``f ~ GP(0, k_lin + k_SE)``;
each measurement row is ``[I_3 | grad phi(x)]`` and the map state is
``xl = [linear weights (3); basis weights (m)]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .laplace import LaplaceBasis


@dataclass(frozen=True)
class ScalarPotentialBasis:
    """Gradient-observation basis with linear-kernel prepend (nLin = 3 + m)."""

    basis: LaplaceBasis

    @property
    def n_lin(self) -> int:
        return 3 + self.basis.m

    def grad_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """C(x): [..., 3, 3+m] — rows are [I_3 | grad phi(x)]."""
        g = self.basis.grad_phi(x)
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(
            g.shape[:-1] + (3,)
        )
        return torch.cat([eye, g], dim=-1)

    def potential_row(self, x: torch.Tensor) -> torch.Tensor:
        """[x | phi(x)] row of the potential itself: [..., 3+m]."""
        return torch.cat([x, self.basis.phi(x)], dim=-1)

    def hess_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """d C / d x: [..., 3, 3, 3+m], the Hessian of the field with
        respect to position: zero for the three linear columns, the basis
        Hessian for the others (run_dense3D_magfield.m:292-296)."""
        H = self.basis.hess_phi(x)
        zeros = torch.zeros(H.shape[:-1] + (3,), dtype=x.dtype,
                            device=x.device)
        return torch.cat([zeros, H], dim=-1)
