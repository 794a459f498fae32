from .regression import (
    ReducedRankGP,
    fit_scalar_potential_gp,
    scalar_potential_nll,
)

__all__ = [
    "ReducedRankGP",
    "fit_scalar_potential_gp",
    "scalar_potential_nll",
]
