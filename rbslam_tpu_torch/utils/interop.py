"""Build the port's problem from plain numpy arrays, so that both packages
can be handed exactly the same inputs."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..basis.laplace import LaplaceBasis
from ..basis.potential import ScalarPotentialBasis
from ..models.base import DenseModel
from ..models.mag3d import make_mag3d_model
from ..models.radio2d import make_radio2d_model


class Problem(NamedTuple):
    """A dense filtering and smoothing problem (dense-mag or dense-radio),
    every tensor float32 on one device."""

    model: DenseModel
    potential: Optional[ScalarPotentialBasis]   # dense-mag only
    dx: torch.Tensor          # [T-1, n_u]
    y: torch.Tensor           # [T, ny]
    x0_nonlin: torch.Tensor   # [n_nonlin]
    x0_lin: torch.Tensor      # [n_lin]
    P0_lin: torch.Tensor      # [n_lin, n_lin] = diag(k)
    Q: torch.Tensor           # [nw, nw] or [T-1, nw, nw]
    R: torch.Tensor           # [ny, ny]
    dt: float

    def rbpf_args(self) -> tuple:
        """The positional arguments before config of engines.run_rbpf,
        run_rbps and run_rbps_information_form."""
        return (self.model, self.dx, self.y, self.x0_nonlin, self.x0_lin,
                self.P0_lin, self.Q, self.R, self.dt)


def _basis_from_numpy(NN, L, eigenvalues) -> LaplaceBasis:
    return LaplaceBasis(
        NN=np.asarray(NN, np.int32),
        L=np.asarray(L, np.float64).reshape(-1),
        eigenvalues=np.asarray(eigenvalues, np.float64),
    )


def _problem(model, potential, k, Q, R, dt, dx, y, init_state,
             device) -> Problem:
    def t(a):
        return torch.tensor(np.array(a, np.float32), device=device)

    return Problem(
        model=model, potential=potential, dx=t(dx), y=t(y),
        x0_nonlin=t(init_state),
        x0_lin=torch.zeros(model.n_lin, device=device),
        P0_lin=torch.diag(t(k)), Q=t(Q), R=t(R), dt=float(dt),
    )


def problem_from_numpy(NN, L, eigenvalues, center, k, Q, R, dt, dx, y,
                       init_state, *, device) -> Problem:
    """Port-side basis, mag3d model and filter inputs from numpy arrays:
    the basis (NN [m, 3], L [3], eigenvalues [m]), the domain center [3],
    the prior diagonal k [3 + m], Q, R, dt, and the data (dx, y,
    init_state)."""
    device = torch.device(device)
    potential = ScalarPotentialBasis(_basis_from_numpy(NN, L, eigenvalues))
    model = make_mag3d_model(
        potential, center=np.array(center, np.float32), device=device)
    return _problem(model, potential, k, Q, R, dt, dx, y, init_state, device)


def radio_problem_from_numpy(NN, L, eigenvalues, center, k, Q, R, dt, dx, y,
                             init_state, *, device) -> Problem:
    """As :func:`problem_from_numpy` for the dense-radio workload: the 2-D
    basis (NN [m, 2], L [2]), the domain center [2], the prior diagonal k
    [m], Q [T-1, 1, 1], R [1, 1], and the data (dx [T-1, 3], y [T, 1],
    init_state [3])."""
    device = torch.device(device)
    model = make_radio2d_model(
        _basis_from_numpy(NN, L, eigenvalues),
        center=np.array(center, np.float32), device=device)
    return _problem(model, None, k, Q, R, dt, dx, y, init_state, device)


def ekf_inputs(problem: Problem, center):
    """(x0 [6 + n_lin], q0 [4], P0 [n, n]) of the dense EKF
    (engines.run_ekf_dense) on a dense-mag problem: the initial position
    relative to the domain ``center`` [3], zero orientation error and map,
    and the prior covariance on the map block only."""
    device = problem.y.device
    center = torch.as_tensor(np.asarray(center, np.float32), device=device)
    n_lin = problem.model.n_lin
    x0 = torch.cat([problem.x0_nonlin[:3] - center,
                    torch.zeros(3 + n_lin, device=device)])
    P0 = torch.zeros((6 + n_lin, 6 + n_lin), device=device)
    P0[6:, 6:] = problem.P0_lin
    return x0, problem.x0_nonlin[3:7], P0
