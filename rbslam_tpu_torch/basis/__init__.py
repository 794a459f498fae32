from .laplace import LaplaceBasis, domain_center, hypercube_basis
from .potential import ScalarPotentialBasis
from .spectral import linear_plus_se_spectral, se_spectral_density

__all__ = [
    "LaplaceBasis", "domain_center", "hypercube_basis",
    "ScalarPotentialBasis",
    "linear_plus_se_spectral", "se_spectral_density",
]
