"""Random curl-free GP field draws for simulation (port of
rbslam_tpu/data/fields.py; tools/gp_rnd_scalar_potential_fast.m).

Inputs are shifted to the centered domain here. The standard-normal
draws come from ``generator`` unless given explicitly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..basis.laplace import domain_center, hypercube_basis
from ..basis.potential import ScalarPotentialBasis
from ..basis.spectral import linear_plus_se_spectral


class PotentialFieldDraw(NamedTuple):
    f: torch.Tensor        # [n] potential values
    df: torch.Tensor       # [n, 3] gradient (the field)
    y: torch.Tensor        # [n, 3] noisy gradient observations
    weights: torch.Tensor  # [3 + m] weights (linear + basis)


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
    if z_w is None:
        z_w = torch.randn((sp.n_lin,), generator=generator, dtype=x.dtype)
    if z_n is None:
        z_n = torch.randn((x.shape[0], 3), generator=generator, dtype=x.dtype)
    z_w = torch.as_tensor(np.array(z_w) if isinstance(z_w, np.ndarray)
                          else z_w, dtype=x.dtype, device=x.device)
    z_n = torch.as_tensor(np.array(z_n) if isinstance(z_n, np.ndarray)
                          else z_n, dtype=x.dtype, device=x.device)
    w = torch.sqrt(k) * z_w
    f = sp.potential_row(x) @ w
    df = torch.einsum("nij,j->ni", sp.grad_blocks(x), w)
    y = df + float(np.sqrt(np.float32(sigma2))) * z_n
    return PotentialFieldDraw(f=f, df=df, y=y, weights=w)
