"""Build the port's problem from plain numpy arrays, so that both packages
can be handed exactly the same inputs."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..basis.laplace import LaplaceBasis
from ..basis.potential import ScalarPotentialBasis
from ..models.base import DenseModel
from ..models.mag3d import make_mag3d_model


class Problem(NamedTuple):
    """A dense-mag filtering problem, every tensor float32 on one device."""

    model: DenseModel
    potential: ScalarPotentialBasis
    dx: torch.Tensor          # [T-1, 7]
    y: torch.Tensor           # [T, 3]
    x0_nonlin: torch.Tensor   # [7]
    x0_lin: torch.Tensor      # [n_lin]
    P0_lin: torch.Tensor      # [n_lin, n_lin] = diag(k)
    Q: torch.Tensor           # [6, 6] or [T-1, 6, 6]
    R: torch.Tensor           # [3, 3]
    dt: float

    def rbpf_args(self) -> tuple:
        """The positional arguments of engines.rbpf.run_rbpf before config."""
        return (self.model, self.dx, self.y, self.x0_nonlin, self.x0_lin,
                self.P0_lin, self.Q, self.R, self.dt)


def problem_from_numpy(NN, L, eigenvalues, center, k, Q, R, dt, dx, y,
                       init_state, *, device) -> Problem:
    """Port-side basis, mag3d model and filter inputs from numpy arrays:
    the basis (NN [m, 3], L [3], eigenvalues [m]), the domain center [3],
    the prior diagonal k [3 + m], Q, R, dt, and the data (dx, y,
    init_state)."""
    device = torch.device(device)

    def t(a):
        return torch.tensor(np.array(a, np.float32), device=device)

    basis = LaplaceBasis(
        NN=np.asarray(NN, np.int32),
        L=np.asarray(L, np.float64).reshape(-1),
        eigenvalues=np.asarray(eigenvalues, np.float64),
    )
    potential = ScalarPotentialBasis(basis)
    model = make_mag3d_model(potential, center=t(center), device=device)
    k = t(k)
    return Problem(
        model=model, potential=potential, dx=t(dx), y=t(y),
        x0_nonlin=t(init_state),
        x0_lin=torch.zeros(potential.n_lin, device=device),
        P0_lin=torch.diag(k), Q=t(Q), R=t(R), dt=float(dt),
    )
