"""Model protocol: state-space models as NamedTuples of callables (port of
rbslam_tpu/models/base.py).

Noise enters every sampled transition as an explicit standard-normal
tensor drawn by the caller (from a ``torch.Generator``, or injected by
the tests), never inside the model. The sparse path's visibility comes
from the data: the engines mask on ``isfinite(y_t)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class DenseModel(NamedTuple):
    """Conditionally linear measurement: y = C(xn) @ xl + r.

    dynamics:      (w, xn, u, dt, Q) -> xn'     one particle, w [n_noise]
                   standard normal
    dyn_residual:  (xn_ref [dn], xn [..., dn], u, dt, Q) -> e [..., ne], the
                   whitened residual of the transition xn -> xn_ref, so
                   that log p(xn_ref | xn) = -0.5 |e|^2 + const; it
                   broadcasts over leading axes of xn (the smoothers pass
                   the whole ensemble). None: the Euclidean default
                   chol(dt Q)^-1 (xn_ref - xn - u)
    meas_jacobian: (xn) -> C [ny, n_lin]
    n_nonlin, n_lin, ny: static dimensions
    n_noise:       how many standard normals one transition takes (the
                   width of w)
    meas_jacobian_batch:      (xn [P, dn]) -> C [P, ny, n_lin]
    dynamics_batch:           (w [P, nw], xn [P, dn], u, dt, Q) -> xn' [P, dn]
    meas_jacobian_batch_rows: (xn [P, dn], nl_pad, dtype) ->
                              C [P, ny, nl_pad] in ``dtype`` (the fused
                              rows-layout Jacobian the lowrank update consumes)
    """

    dynamics: Callable
    dyn_residual: Optional[Callable]
    meas_jacobian: Callable
    n_nonlin: int
    n_lin: int
    ny: int
    n_noise: int
    meas_jacobian_batch: Optional[Callable] = None
    dynamics_batch: Optional[Callable] = None
    meas_jacobian_batch_rows: Optional[Callable] = None


class SparseModel(NamedTuple):
    """Conditionally linearized (EKF) measurement, NaN-masked observations.

    dynamics:       (w, xn, u, dt, Q) -> xn', w [..., n_noise] standard
                    normals; broadcasts over leading axes of xn
    dyn_residual:   as DenseModel's (None: the Euclidean default)
    measure:        (xn [..., dn], xl [..., n_lin]) -> (yhat [..., ny],
                    H [..., ny, n_lin]), the linearization at each
                    particle's current map (src/particleFilter.m:129),
                    over any leading axes the two share
    n_nonlin, n_lin, ny, n_noise: static dimensions
    dynamics_batch: (w [P, nw], xn [P, dn], u, dt, Q) -> xn' [P, dn]
    """

    dynamics: Callable
    dyn_residual: Optional[Callable]
    measure: Callable
    n_nonlin: int
    n_lin: int
    ny: int
    n_noise: int
    dynamics_batch: Optional[Callable] = None
