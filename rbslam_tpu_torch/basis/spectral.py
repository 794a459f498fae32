"""Spectral densities for the reduced-rank GP priors (port of
rbslam_tpu/basis/spectral.py; run_dense3D_magfield.m:103-107)."""

from __future__ import annotations

import math

import torch


def se_spectral_density(w: torch.Tensor, length_scale, magn_sigma2, d: int):
    """S_SE(w) = magnSigma2 (2 pi)^{d/2} l^d exp(-w^2 l^2 / 2), w = |omega|."""
    return (
        magn_sigma2
        * math.sqrt(2.0 * math.pi) ** d
        * length_scale**d
        * torch.exp(-(w**2) * length_scale**2 / 2.0)
    )


def linear_plus_se_spectral(w: torch.Tensor, lin_sigma2, length_scale,
                            magn_sigma2, d: int):
    """Prior variances for [3 linear-kernel states; m SE basis weights]
    (``S = [linSigma2;linSigma2;linSigma2; Sse(w)]``)."""
    se = se_spectral_density(w, length_scale, magn_sigma2, d)
    lin = torch.full((3,), lin_sigma2, dtype=se.dtype, device=se.device)
    return torch.cat([lin, se])
