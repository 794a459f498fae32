"""Batch reduced-rank GP regression with ML-II hyperparameter fitting (port
of rbslam_tpu/gp/regression.py; tools/gp_scalar_potential_fast.m).

The scalar-potential magnetic map of the localization workload:

- gradient-observation design matrix Phi = [dPhi_x; dPhi_y; dPhi_z] with
  the linear-kernel columns prepended (:98-106),
- reduced-rank negative log marginal likelihood (:242-247):
      NLL = 1/2 (y'y - v'v)/sigma2
          + 1/2 [(n-m) log sigma2 + sum log k + 2 sum log diag L]
          + n/2 log 2pi,    L = chol(Phi'Phi + diag(sigma2/k))
- posterior solve through the same Cholesky (:190-207).

The NLL is one torch function of the log-hyperparameters; its gradient
comes from autograd and feeds scipy's L-BFGS-B on the host, as the JAX
package feeds ``jax.value_and_grad`` to the same call. Everything else
runs on ``device``. The products are float32 matmuls: on a CUDA device
they need ``torch.backends.cuda.matmul.allow_tf32`` off, which this
module never turns on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..basis.laplace import domain_center, hypercube_basis
from ..basis.potential import ScalarPotentialBasis
from ..basis.spectral import linear_plus_se_spectral, se_spectral_density

_LOG2PI = math.log(2.0 * math.pi)


@dataclass
class ReducedRankGP:
    """Fitted map: posterior over [linear(3); basis(m)] weights."""

    potential: ScalarPotentialBasis
    center: np.ndarray           # domain center (inputs are shifted by it)
    theta: np.ndarray            # [linSigma2, lengthScale, magnSigma2, sigma2]
    mean_weights: torch.Tensor   # [n_lin] posterior mean ("foo", :190-207)
    chol: torch.Tensor           # [n_lin, n_lin] lower chol of Phi'Phi + diag(sigma2/k)
    nll: float

    def _row_variance(self, rows: torch.Tensor) -> torch.Tensor:
        """sigma2 * diag(rows A^-1 rows') for rows [..., n_lin]: one
        triangular solve over all rows."""
        flat = rows.reshape(-1, rows.shape[-1])
        V = torch.linalg.solve_triangular(self.chol, flat.T, upper=False)
        return (float(self.theta[3]) * torch.sum(V * V, dim=0)) \
            .reshape(rows.shape[:-1])

    def _centered(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=self.mean_weights.device)
        return x - torch.as_tensor(self.center, dtype=x.dtype,
                                   device=x.device)

    def predict_gradient(self, x):
        """Posterior mean and per-axis variance of grad f at x [.., 3]."""
        C = self.potential.grad_blocks(self._centered(x))
        return C @ self.mean_weights, self._row_variance(C)

    def predict_potential(self, x):
        """Posterior mean and variance of the potential f at x [.., 3]."""
        row = self.potential.potential_row(self._centered(x))
        return row @ self.mean_weights, self._row_variance(row)


def scalar_potential_nll(log_theta, sqrt_lambda, PhiPhi, Phiy, yy,
                         n_obs: int) -> torch.Tensor:
    """Reduced-rank NLL as a function of the log hyperparameters
    (:242-247); differentiable in ``log_theta``. NaN where
    Phi'Phi + diag(sigma2/k) is not positive definite, as the reference's
    Cholesky gives NaN there."""
    lin_s2, ell, magn_s2, sigma2 = torch.exp(log_theta)
    # linear_plus_se_spectral with a tensor linSigma2 that autograd follows
    k = torch.cat([lin_s2.expand(3),
                   se_spectral_density(sqrt_lambda, ell, magn_s2, 3)])
    m = Phiy.shape[0]
    A = PhiPhi + torch.diag(sigma2 / k)
    L, info = torch.linalg.cholesky_ex(A)
    v = torch.linalg.solve_triangular(L, Phiy[:, None], upper=False)[:, 0]
    yiQy = (yy - v @ v) / sigma2
    logdetQ = ((n_obs - m) * torch.log(sigma2) + torch.sum(torch.log(k))
               + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    nll = 0.5 * yiQy + 0.5 * logdetQ + 0.5 * n_obs * _LOG2PI
    return torch.where(info == 0, nll, torch.nan)


def fit_scalar_potential_gp(x, y, m: int, LL, theta0, optimize: bool = True,
                            maxiter: int = 100, *,
                            device="cuda") -> ReducedRankGP:
    """Fit the curl-free magnetic map on ``device``.

    x: [n, 3] positions; y: [n, 3] field observations; LL: [2, 3] domain
    bounds; theta0: initial [linSigma2, lengthScale, magnSigma2, sigma2].
    With ``optimize`` the hyperparameters are ML-II fitted by scipy's
    L-BFGS-B on the float32 NLL and its autograd gradient (one
    device-to-host read of both a function evaluation).
    """
    device = torch.device(device)
    f32 = torch.float32
    LL = np.asarray(LL, dtype=np.float64)
    center = domain_center(LL)
    potential = ScalarPotentialBasis(hypercube_basis(m, LL))
    xc = torch.as_tensor(np.asarray(x), dtype=f32, device=device) \
        - torch.as_tensor(center, dtype=f32, device=device)
    yt = torch.as_tensor(np.asarray(y), dtype=f32, device=device)

    # design matrix: the three gradient components stacked (:138-140)
    C = potential.grad_blocks(xc)                      # [n, 3, n_lin]
    Phi = torch.cat([C[:, 0], C[:, 1], C[:, 2]], dim=0)
    yvec = torch.cat([yt[:, 0], yt[:, 1], yt[:, 2]])
    PhiPhi = Phi.T @ Phi
    Phiy = Phi.T @ yvec
    yy = yvec @ yvec
    n_obs = int(yvec.shape[0])
    sqrt_lambda = torch.as_tensor(np.sqrt(potential.basis.eigenvalues),
                                  dtype=f32, device=device)
    del C, Phi

    theta = np.asarray(theta0, dtype=np.float64)
    if optimize:
        from scipy.optimize import minimize

        def fun(w):
            lt = torch.tensor(w, dtype=f32, device=device, requires_grad=True)
            v = scalar_potential_nll(lt, sqrt_lambda, PhiPhi, Phiy, yy, n_obs)
            (g,) = torch.autograd.grad(v, lt)
            return float(v.detach()), g.double().cpu().numpy()

        out = minimize(fun, np.log(theta), jac=True, method="L-BFGS-B",
                       options={"maxiter": maxiter})
        theta = np.exp(out.x)

    lin_s2, ell, magn_s2, sigma2 = (float(t) for t in theta)
    k = linear_plus_se_spectral(sqrt_lambda, lin_s2, ell, magn_s2, 3)
    A = PhiPhi + torch.diag(torch.tensor(sigma2, dtype=f32, device=device)
                            / k)
    L = torch.linalg.cholesky(A)
    v = torch.linalg.solve_triangular(L, Phiy[:, None], upper=False)
    mean_w = torch.linalg.solve_triangular(L.T, v, upper=True)[:, 0]
    nll = float(scalar_potential_nll(
        torch.tensor(np.log(theta), dtype=f32, device=device),
        sqrt_lambda, PhiPhi, Phiy, yy, n_obs))
    return ReducedRankGP(potential=potential, center=center, theta=theta,
                         mean_weights=mean_w, chol=L, nll=nll)
