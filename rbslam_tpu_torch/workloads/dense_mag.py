"""Dense 3D magnetic-field SLAM workload, filter side (port of
rbslam_tpu/workloads/dense_mag.py and bench.py::_build_problem).

Reference config (run_dense3D_magfield.m, main.m): bean_6D trajectory,
dt=0.01, Q = blkdiag(10^2 diag[.05^2,.05^2,.01^2], diag([.01 .01 .3] deg)^2),
theta=[650;1.2;200;10].
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import ScalarPotentialBasis, hypercube_basis
from ..basis.laplace import domain_center
from ..basis.spectral import linear_plus_se_spectral
from ..data import DenseDataset, simulate_dense_dataset
from ..models.mag3d import dynamics_with_increment
from ..utils.interop import Problem, problem_from_numpy

THETA = (650.0, 1.2, 200.0, 10.0)
DT = 0.01


def default_Q() -> torch.Tensor:
    """main.m:22: blkdiag(10^2 diag[.05,.05,.01].^2, diag([.01 .01 .3]deg).^2)."""
    qpos = 10.0**2 * np.array([0.05**2, 0.05**2, 0.01**2])
    qori = (np.array([0.01, 0.01, 0.3]) * np.pi / 180.0) ** 2
    return torch.as_tensor(np.diag(np.concatenate([qpos, qori])),
                           dtype=torch.float32)


def build_problem(m_basis: int, n_steps: int, seed: int = 1,
                  m_sim: int = 512, *,
                  device) -> tuple[Problem, DenseDataset]:
    """The flagship filtering problem: a bean_6D dataset of ``n_steps``
    steps (laps of 64, as the benchmark builds it) simulated on the host
    from ``seed`` with an m_sim-function field, and an m_basis-function
    filter model on ``device``. Returns (problem, dataset)."""
    Q = default_Q()
    n_laps = max(1, n_steps // 64)
    data = simulate_dense_dataset(
        "bean_6D", THETA, Q, DT, dynamics_with_increment, m_sim=m_sim,
        traj_kwargs={"n_laps": n_laps, "n_per_lap": n_steps // n_laps},
        generator=torch.Generator().manual_seed(seed),
    )
    basis = hypercube_basis(m_basis, data.LL)
    k = linear_plus_se_spectral(
        torch.as_tensor(np.sqrt(basis.eigenvalues), dtype=torch.float32),
        THETA[0], THETA[1], THETA[2], 3,
    )
    problem = problem_from_numpy(
        basis.NN, basis.L, basis.eigenvalues,
        domain_center(data.LL).astype(np.float32), k.numpy(), Q.numpy(),
        THETA[3] * np.eye(3), DT, data.dx.numpy(), data.y.numpy(),
        data.init_state.numpy(), device=device,
    )
    return problem, data
