"""Random GP field draws for simulation (port of rbslam_tpu/data/fields.py;
tools/gp_rnd_SE1D_fast.m: scalar SE field, f = Phi diag(sqrt k) z; and
tools/gp_rnd_scalar_potential_fast.m: curl-free 3D field).

Inputs are shifted to the centered domain here. The standard-normal
draws come from ``generator`` unless given explicitly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..basis.laplace import domain_center, hypercube_basis
from ..basis.potential import ScalarPotentialBasis
from ..basis.spectral import linear_plus_se_spectral, se_spectral_density


class ScalarFieldDraw(NamedTuple):
    f: torch.Tensor        # [n] field values
    y: torch.Tensor        # [n] noisy observations
    weights: torch.Tensor  # [m] basis weights of the drawn field


class PotentialFieldDraw(NamedTuple):
    f: torch.Tensor        # [n] potential values
    df: torch.Tensor       # [n, 3] gradient (the field)
    y: torch.Tensor        # [n, 3] noisy gradient observations
    weights: torch.Tensor  # [3 + m] weights (linear + basis)


def _normal(z, shape, generator, like: torch.Tensor) -> torch.Tensor:
    """The standard-normal draw ``z`` as a tensor like ``like``, drawn from
    ``generator`` when not given."""
    if z is None:
        return torch.randn(shape, generator=generator, dtype=like.dtype)
    if isinstance(z, np.ndarray):
        z = np.array(z)
    return torch.as_tensor(z, dtype=like.dtype, device=like.device)


def _sqrt_in(value: float, like: torch.Tensor) -> torch.Tensor:
    """sqrt(value) computed in like's dtype, as the reference computes
    the noise scale in the points' dtype."""
    return torch.sqrt(torch.tensor(value, dtype=like.dtype))


def draw_scalar_field(x, m: int, LL, theta, *,
                      generator: Optional[torch.Generator] = None,
                      z_w=None, z_n=None) -> ScalarFieldDraw:
    """Scalar SE-kernel GP draw at points x [n, d].

    theta = [lengthScale, magnSigma2, sigma2] (gp_rnd_SE1D_fast.m:73-85).
    ``z_w`` [m] and ``z_n`` [n] are the standard-normal draws for the
    weights and the measurement noise; each is drawn from ``generator``
    when not given.
    """
    LL = np.asarray(LL, dtype=np.float64)
    x = torch.as_tensor(x)
    x = x - torch.as_tensor(domain_center(LL), dtype=x.dtype, device=x.device)
    basis = hypercube_basis(m, LL)
    length_scale, magn_sigma2, sigma2 = (float(t) for t in theta)
    k = se_spectral_density(
        torch.as_tensor(np.sqrt(basis.eigenvalues), dtype=x.dtype,
                        device=x.device),
        length_scale, magn_sigma2, basis.d,
    )
    w = torch.sqrt(k) * _normal(z_w, (m,), generator, x)
    f = basis.phi(x) @ w
    y = f + _sqrt_in(sigma2, x) * _normal(z_n, (x.shape[0],), generator, x)
    return ScalarFieldDraw(f=f, y=y, weights=w)


def draw_scalar_potential_field(x, m: int, LL, theta, *,
                                generator: Optional[torch.Generator] = None,
                                z_w=None, z_n=None) -> PotentialFieldDraw:
    """Curl-free 3D field draw: y = grad f + noise, f ~ GP(0, k_lin + k_SE).

    theta = [linSigma2, lengthScale, magnSigma2, sigma2]
    (gp_rnd_scalar_potential_fast.m:84-102). ``z_w`` [3 + m] and ``z_n``
    [n, 3] are the standard-normal draws for the weights and the
    measurement noise; each is drawn from ``generator`` when not given.
    """
    LL = np.asarray(LL, dtype=np.float64)
    x = torch.as_tensor(x)
    x = x - torch.as_tensor(domain_center(LL), dtype=x.dtype, device=x.device)
    sp = ScalarPotentialBasis(hypercube_basis(m, LL))
    lin_sigma2, length_scale, magn_sigma2, sigma2 = (float(t) for t in theta)
    k = linear_plus_se_spectral(
        torch.as_tensor(np.sqrt(sp.basis.eigenvalues), dtype=x.dtype,
                        device=x.device),
        lin_sigma2, length_scale, magn_sigma2, sp.basis.d,
    )
    z_w = _normal(z_w, (sp.n_lin,), generator, x)
    z_n = _normal(z_n, (x.shape[0], 3), generator, x)
    w = torch.sqrt(k) * z_w
    f = sp.potential_row(x) @ w
    df = torch.einsum("nij,j->ni", sp.grad_blocks(x), w)
    y = df + _sqrt_in(sigma2, x) * z_n
    return PotentialFieldDraw(f=f, df=df, y=y, weights=w)
