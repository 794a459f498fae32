"""Per-particle Kalman measurement updates, dense and masked (port of
rbslam_tpu/ops/kalman.py): one particle's forms, and the whole ensemble's.

Dense path (src/particleFilter.m:137-150,181-198): per particle i,

    S_i = C_i P_i C_i' + R          (ny x ny, ny <= 3)
    logw_i = log N(e_i; 0, S_i)
    K_i = P_i C_i' S_i^{-1}
    xl_i += K_i e_i ;  P_i -= K_i S_i K_i'

For ny <= 3 the ny x ny algebra is closed-form and elementwise over the
batch (the "small" form); for ny > 3 it goes through
``torch.linalg`` (the "lax" form). All contractions accumulate in float32
whatever the covariance storage dtype. The downdate is formed in float32
(an [N, nl, nl] float32 temporary) and subtracted in the storage dtype,
so bf16 storage rounds where the reference rounds.

Sparse path (src/particleFilter.m:127-136,164-180; rbslam_tpu/ops/
kalman.py:74-104,327-355): the reference strips NaN-masked rows to a
dynamic size; here masked rows stay at fixed width and are neutralized
exactly (innovation zeroed, unit diagonal and zero couplings in S), which
leaves the Cholesky, the log-density (with n_obs = sum(mask)), the gain
and the covariance update equal to the stripped computation. S is
[N, M, M] with M the number of landmarks, so it is factored by
:func:`psd_cholesky`, float32 throughout.

Map axis (parallel/map_axis.py): given ``axis``, P is this rank's row
block [N, nl/S, nl] of each covariance and the update returns the row
block of P'. The contraction of P's last axis (C P' in the small form, P
H' in the masked one) gives the rows of P C' whole on each rank, which one
all-gather over the ``map`` group completes; the lax form contracts P's
first axis, so its partial products are all-reduced. The gain, the
weights and xl' are then whole on every rank, the downdate of the row
block is local, and the symmetrization takes the row block of P'^T by one
all-to-all of [N, nl/S, nl/S] tiles. The Joseph form takes the row block
the same way (:func:`_finish`). With ``axis`` None, or one rank on
``map``, the arithmetic is that of the unsharded update.
"""

from __future__ import annotations

import math

import torch

from ..math.linalg import (
    gaussian_logpdf_chol,
    half_logdet,
    psd_cholesky,
    solve_psd,
    symmetrize,
)

_LOG2PI = math.log(2.0 * math.pi)


def innovation_cov(C, P, R):
    """S = C P C' + R for one particle: C [ny, nl], P [nl, nl]. Returns
    (S, CP)."""
    CP = C @ P
    return CP @ C.T + R, CP


def dense_log_weights(C, P, xl, y, R, jitter: float):
    """Marginal innovation log-likelihood of one particle
    (src/particleFilter.m:137-150). Returns (logw, e, L, CP, retried)."""
    e = y - C @ xl
    S, CP = innovation_cov(C, P, R)
    L, retried = psd_cholesky(S, jitter)
    return gaussian_logpdf_chol(e, L), e, L, CP, retried


def kalman_update_dense(C, P, xl, y, R, jitter: float, joseph: bool = False):
    """One particle's KF measurement update: C [ny, nl], P [nl, nl], xl
    [nl], y [ny]. Returns (xl', P', logw, retried).

    ``joseph=True`` takes the Joseph-stabilized covariance update
    (I - KC) P (I - KC)' + K R K', an option the float64 reference did
    not need. The whole ensemble at once: :func:`kalman_update_dense_batched`.
    """
    logw, e, L, CP, retried = dense_log_weights(C, P, xl, y, R, jitter)
    # K = P C' S^-1 by two triangular solves on (C P)' = P C'
    K = solve_psd(L, CP).T                                   # [nl, ny]
    xl_new = xl + K @ e
    if joseph:
        IKC = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device) - K @ C
        P_new = IKC @ P @ IKC.T + K @ R @ K.T
    else:
        S = CP @ C.T + R
        P_new = P - K @ S @ K.T
    return xl_new, symmetrize(P_new), logw, retried


def _chol_small_batched(S: torch.Tensor, jitter: float):
    """Closed-form batched Cholesky for ny <= 3: S [N, ny, ny].

    Where any pivot fails, the particle's S gets a scale-aware jitter
    (jitter times the mean diagonal, at least 1) before factoring — the
    reference's retry (src/particleFilter.m:145-148) kept meaningful
    under reduced precision. Returns (L, bad).
    """
    ny = S.shape[-1]

    def pivots(Sm):
        l11s = Sm[:, 0, 0]
        piv = [l11s]
        if ny >= 2:
            l11 = torch.sqrt(torch.clamp(l11s, min=1e-30))
            l21 = Sm[:, 1, 0] / l11
            piv.append(Sm[:, 1, 1] - l21**2)
        if ny >= 3:
            l31 = Sm[:, 2, 0] / l11
            l22 = torch.sqrt(torch.clamp(piv[1], min=1e-30))
            l32 = (Sm[:, 2, 1] - l31 * l21) / l22
            piv.append(Sm[:, 2, 2] - l31**2 - l32**2)
        return piv

    bad = torch.zeros(S.shape[0], dtype=torch.bool, device=S.device)
    for p in pivots(S):
        bad = bad | (p <= 0)
    eye = torch.eye(ny, dtype=S.dtype, device=S.device)
    diag_scale = torch.clamp(
        torch.diagonal(S, dim1=-2, dim2=-1).mean(dim=-1), min=1.0
    )
    S = torch.where(
        bad[:, None, None], S + (jitter * diag_scale)[:, None, None] * eye, S
    )

    cols = []
    zero = torch.zeros_like(S[:, 0, 0])
    l11 = torch.sqrt(S[:, 0, 0])
    if ny == 1:
        return l11[:, None, None], bad
    l21 = S[:, 1, 0] / l11
    l22 = torch.sqrt(S[:, 1, 1] - l21**2)
    if ny == 2:
        cols = [[l11, zero], [l21, l22]]
    else:
        l31 = S[:, 2, 0] / l11
        l32 = (S[:, 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(S[:, 2, 2] - l31**2 - l32**2)
        cols = [[l11, zero, zero], [l21, l22, zero], [l31, l32, l33]]
    L = torch.stack([torch.stack(r, dim=-1) for r in cols], dim=-2)
    return L, bad


def _tri_solve_small_batched(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward-substitute L v = b, batched, ny <= 3 (elementwise)."""
    ny = L.shape[-1]
    v0 = b[:, 0] / L[:, 0, 0]
    vs = [v0]
    if ny >= 2:
        vs.append((b[:, 1] - L[:, 1, 0] * v0) / L[:, 1, 1])
    if ny >= 3:
        vs.append(
            (b[:, 2] - L[:, 2, 0] * vs[0] - L[:, 2, 1] * vs[1]) / L[:, 2, 2]
        )
    return torch.stack(vs, dim=-1)


def _Li_from_chol_small_batched(L: torch.Tensor) -> torch.Tensor:
    """L^-1 (lower), batched, ny <= 3 (elementwise)."""
    ny = L.shape[-1]
    zero = torch.zeros_like(L[:, 0, 0])
    i00 = 1.0 / L[:, 0, 0]
    if ny == 1:
        return i00[:, None, None]
    i11 = 1.0 / L[:, 1, 1]
    i10 = -L[:, 1, 0] * i00 / L[:, 1, 1]
    if ny == 2:
        rows = [[i00, zero], [i10, i11]]
    else:
        i22 = 1.0 / L[:, 2, 2]
        i21 = -L[:, 2, 1] * i11 / L[:, 2, 2]
        i20 = -(L[:, 2, 0] * i00 + L[:, 2, 1] * i10) / L[:, 2, 2]
        rows = [[i00, zero, zero], [i10, i11, zero], [i20, i21, i22]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _inv_from_chol_small_batched(L: torch.Tensor) -> torch.Tensor:
    """S^-1 = L^-T L^-1, batched, ny <= 3 (elementwise)."""
    Li = _Li_from_chol_small_batched(L)
    return torch.einsum("pki,pkj->pij", Li, Li)


def kalman_update_dense_batched(C, P, xl, y, R, jitter: float,
                                joseph: bool = False,
                                symmetrize_out: bool = True, axis=None):
    """Whole-ensemble dense KF update: C [N,ny,nl], P [N,nl,nl] (any
    storage dtype; the row block [N,nl/S,nl] with a map ``axis``), xl
    [N,nl]. Returns (xl', P', logw [N], retried [N]).
    See :func:`kalman_update_dense_batched_hld`."""
    return kalman_update_dense_batched_hld(
        C, P, xl, y, R, jitter, joseph, symmetrize_out, axis
    )[:4]


def kalman_update_dense_batched_hld(C, P, xl, y, R, jitter: float,
                                    joseph: bool = False,
                                    symmetrize_out: bool = True, axis=None):
    """As :func:`kalman_update_dense_batched` but additionally returns
    ``hld_S [N] = sum log diag chol(S)``, the innovation half-log-det that
    the information-form smoother's ``halfLogDetP`` recursion consumes
    (src/particleSmootherInformationForm.m:298). ny <= 3 takes the small
    form, ny > 3 the lax form.

    The downdate is formed in float32 and subtracted in P's storage dtype,
    and a float32 C against a bf16 P is promoted to float32. ``joseph``
    takes the Joseph form (:func:`_finish`), with or without a map
    ``axis``.
    """
    if C.shape[1] <= 3:
        return _kalman_update_dense_batched_small(
            C, P, xl, y, R, jitter, joseph, symmetrize_out, axis)
    return _kalman_update_dense_batched_lax(
        C, P, xl, y, R, jitter, joseph, symmetrize_out, axis)


def _rows(axis):
    """This rank's rows of the map axis (all rows without one)."""
    return slice(None) if axis is None else axis.rows


def _symmetrize(A, axis):
    return symmetrize(A) if axis is None else axis.symmetrize(A)


def _finish(K, Cf, CP, P, R, downdate, joseph, symmetrize_out, axis=None):
    """P' from the gain K [N, nl, ny] and CP = C P [N, ny, nl], both whole
    on every rank: P minus the float32 ``downdate()`` rounded to P's dtype,
    or the Joseph form (I - KC) P (I - KC)' + K R K' in float32; then the
    optional symmetrization.

    The Joseph form is taken on this rank's rows of P (all rows without a
    map ``axis``) by rank-ny products, never forming I - KC:

        A = P_rows - K_rows CP                 (the rows of (I - KC) P)
        P'_rows = A - (A C' - K_rows R) K'

    so no collective beyond those the gain needed. On one ``map`` rank the
    rows are all rows and the operations those of the unsharded form:
    equal to it bit for bit. Against the reference's (I - KC) P (I - KC)'
    (rbslam_tpu/ops/kalman.py:263-269, 309-315) it is equal within float32
    rounding of the products' order."""
    f32 = torch.float32
    if joseph:
        Kr = K[:, _rows(axis)]
        A = torch.baddbmm(P.to(f32), Kr, CP, alpha=-1.0)
        P_new = torch.baddbmm(A, A @ Cf.transpose(-1, -2) - Kr @ R,
                              K.transpose(-1, -2), alpha=-1.0)
    else:
        P_new = P - downdate().to(P.dtype)
    if symmetrize_out:
        P_new = _symmetrize(P_new, axis)
    return P_new.to(P.dtype)


def _kalman_update_dense_batched_small(C, P, xl, y, R, jitter, joseph,
                                       symmetrize_out=True, axis=None):
    """The ny <= 3 form: closed-form ny x ny algebra. As the reference
    path, the contractions use P's LAST axis (exact for the symmetric
    covariance), so a row block of P gives a column block of C P'."""
    f32 = torch.float32
    Cf = C.to(f32)
    rows = _rows(axis)
    e = y[None, :] - torch.einsum("pij,pj->pi", Cf, xl.to(f32))
    CP = torch.einsum("pij,pkj->pik", Cf, P.to(f32))
    if axis is not None:
        CP = axis.gather(CP, 2)
    S = torch.einsum("pik,pjk->pij", CP, Cf) + R
    L, retried = _chol_small_batched(S, jitter)
    v = _tri_solve_small_batched(L, e)
    ny = e.shape[-1]
    hld = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    logw = -hld - 0.5 * torch.sum(v * v, dim=-1) - 0.5 * ny * _LOG2PI
    Sinv = _inv_from_chol_small_batched(L)
    K = torch.einsum("pji,pjk->pik", CP, Sinv)              # [N, nl, ny]
    xl_new = xl + torch.einsum("pij,pj->pi", K, e)

    def downdate():
        # P - K S K' == P - (CP)' Sinv (CP): rank-ny sum of broadcasts
        X = torch.einsum("pij,pjk->pik", Sinv, CP)
        return sum(CP[:, j][:, rows, None] * X[:, j][:, None, :]
                   for j in range(ny))

    P_new = _finish(K, Cf, CP, P, R, downdate, joseph, symmetrize_out,
                    axis)
    return xl_new, P_new, logw, retried, hld


def _kalman_update_dense_batched_lax(C, P, xl, y, R, jitter, joseph,
                                     symmetrize_out=True, axis=None):
    """The ny > 3 form (rbslam_tpu/ops/kalman.py:292-324): the innovation
    covariance is factored by :func:`psd_cholesky` (per-particle jitter
    retry and Gershgorin repair) and the gain comes from two triangular
    solves. As written there, C P contracts P's FIRST matrix axis
    ('pij,pjk'), where the small form contracts its last; the two agree
    for a symmetric P. With a map ``axis`` the row block of P gives a
    partial C P, all-reduced."""
    f32 = torch.float32
    Cf = C.to(f32)
    rows = _rows(axis)
    e = y[None, :] - torch.einsum("pij,pj->pi", Cf, xl.to(f32))
    CP = torch.einsum("pij,pjk->pik", Cf[:, :, rows], P.to(f32))
    if axis is not None:
        CP = axis.reduce(CP)
    S = torch.einsum("pik,pjk->pij", CP, Cf) + R
    L, retried = psd_cholesky(S, jitter)
    logw = gaussian_logpdf_chol(e, L)
    hld = half_logdet(L)
    K = solve_psd(L, CP).transpose(-1, -2)                  # [N, nl, ny]
    xl_new = xl + torch.einsum("pij,pj->pi", K, e)
    P_new = _finish(
        K, Cf, CP, P, R,
        lambda: torch.einsum("pij,pjk,plk->pil", K[:, rows], S, K),
        joseph, symmetrize_out, axis)
    return xl_new, P_new, logw, retried, hld


def _mask_system(e, S, mask):
    """Neutralize masked observation rows and columns exactly: mask [ny]
    float (1 = observed); masked entries get e = 0 and a unit diagonal in
    S with zero couplings, so they add nothing to the Cholesky log-det,
    the whitened residual or the gain. e [..., ny], S [..., ny, ny]."""
    m = mask
    return e * m, S * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)


def masked_log_weights(yhat, H, P, y, R, mask, jitter: float):
    """Sparse (EKF) innovation log-likelihood with visibility masking:
    yhat [..., ny], H [..., ny, nl] from the linearized model, P
    [..., nl, nl], mask [ny] from ``isfinite(y)``
    (src/particleFilter.m:134-136). Returns (logw, e_m, L, Hm, retried)."""
    Hm = H * mask[:, None]
    e = torch.nan_to_num(y) - yhat
    S = Hm @ P @ Hm.transpose(-1, -2) + R * (mask[:, None] * mask[None, :])
    e_m, S_m = _mask_system(e, S, mask)
    L, retried = psd_cholesky(S_m, jitter)
    logw = gaussian_logpdf_chol(e_m, L, n_obs=torch.sum(mask))
    return logw, e_m, L, Hm, retried


def kalman_update_masked_batched(yhat, H, P, xl, y, R, mask, jitter: float,
                                 axis=None):
    """Whole-ensemble masked (sparse/EKF) update: yhat [N, ny], H
    [N, ny, nl], P [N, nl, nl] (the row block [N, nl/S, nl] with a map
    ``axis``), xl [N, nl], y [ny] (NaN allowed), mask [ny]. Returns
    (xl', P', logw [N], retried [N])."""
    m = mask
    rows = _rows(axis)
    Hm = H * m[None, :, None]
    e = (torch.nan_to_num(y)[None, :] - yhat) * m[None, :]
    R_m = R * (m[:, None] * m[None, :])
    PHt = P @ Hm.transpose(-1, -2)                       # [N, nl, ny]
    if axis is not None:
        PHt = axis.gather(PHt, 1)
    S = torch.einsum("pij,pjk->pik", Hm, PHt) + R_m + torch.diag(1.0 - m)
    L, retried = psd_cholesky(S, jitter)
    logw = gaussian_logpdf_chol(e, L, n_obs=torch.sum(m))
    K = solve_psd(L, PHt.transpose(-1, -2)).transpose(-1, -2)
    xl_new = xl + torch.einsum("pij,pj->pi", K, e)
    P_new = P - K[:, rows] @ S @ K.transpose(-1, -2)
    return xl_new, _symmetrize(P_new, axis), logw, retried


def kalman_update_masked(yhat, H, P, xl, y, R, mask, jitter: float):
    """One particle's masked measurement update: yhat [ny], H [ny, nl], P
    [nl, nl], xl [nl]. Returns (xl', P', logw, retried)."""
    logw, e_m, L, Hm, retried = masked_log_weights(
        yhat, H, P, y, R, mask, jitter)
    PHt = P @ Hm.T                     # [nl, ny]; masked columns are zero
    K = solve_psd(L, PHt.T).T          # the block structure keeps them zero
    xl_new = xl + K @ e_m
    S_m = Hm @ PHt + R * (mask[:, None] * mask[None, :]) \
        + torch.diag(1.0 - mask)
    P_new = P - K @ S_m @ K.T
    return xl_new, symmetrize(P_new), logw, retried
