"""Information-form RBPS: the scalable ancestor-weight computation (port of
rbslam_tpu/engines/rbps_info.py).

The same smoother as engines/rbps.py, but the future-measurement ancestor
weights are computed in information form
(src/particleSmootherInformationForm.m): per particle maintain

    ivec = P0^-1 x0 + sum_j C_j' R^-1 y_j,
    Imat = P0^-1    + sum_j C_j' R^-1 C_j,
    halfLogDetP (recursed through the KF: :298)

and once per sweep pre-accumulate the whole-trajectory suffix pair
(ivecAdd, ImatAdd) along the reference (:132-146), downdating one term
per time step (:194-201). The ancestor weight then costs one n_lin^3
Cholesky per particle independent of T (:224-236):

    logwMeas = -1/2 ivec' P ivec - halfLogDetP
               - sum log diag chol(ImatEnd) + 1/2 ||chol^-1 ivecEnd||^2

or, in the Woodbury form, no factorization at all: W = ImatEnd^-1 and its
half-log-det are carried and moved by exact rank-ny updates.

Dense features only, like the reference (:77-80). Importance weights and
KF updates use the standard innovation form. Like the reference
(:110-113), P0_lin is assumed diagonal when forming the initial
information pair.

Every contraction here must run in full float32 (W is maintained by
cancellation): the port never turns TF32 on, and
:func:`run_rbps_information_form` refuses to run with it on.

Memory traffic: the rank-ny corrections of P (ops/kalman.py) and of W
(:func:`_woodbury_rank_ny`) are sums of ny broadcast outer products
formed as [N, nl, nl] float32 temporaries before the subtraction in the
storage dtype, which keeps the reference's rounding points; with bf16
storage, W and P are also promoted to float32 copies for their
contractions. Fusing those passes is left to a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..math.linalg import (
    half_logdet,
    logsumexp_normalize,
    psd_cholesky,
    tril_solve,
)
from ..models.base import DenseModel
from ..ops.kalman import (
    _chol_small_batched,
    _inv_from_chol_small_batched,
    kalman_update_dense_batched_hld,
)
from ..ops.resampling import resample_indices, sample_categorical
from .rbpf import (
    _DTYPES,
    _dynamics_batch,
    _init_linear,
    _jacobian_batch,
    refuse_tf32,
)
from .rbps import (
    RBPSConfig,
    RBPSResult,
    SweepDraws,
    SweepOut,
    _check_supported,
    _dyn_log_weights,
    _ess,
    _finish_sweep,
    _run_sweeps,
)

_F32 = torch.float32


def _info_future_log_weights(ivec, Imat, P, halfLogDetP, ivec_add, Imat_add,
                             jitter):
    """Ancestor measurement weights, information form (:224-236), batched
    over the ensemble (one [N, nl, nl] Cholesky; storage dtypes are
    promoted to float32 for the factorization). Returns (logw, retried)."""
    # no symmetrize: the factorization reads only the lower triangle
    Imat_end = Imat.to(_F32) + Imat_add[None]
    L, retried = psd_cholesky(Imat_end, jitter)
    v = tril_solve(L, ivec + ivec_add[None])
    Pv = torch.einsum("pij,pj->pi", P.to(_F32), ivec)
    quad0 = torch.sum(ivec * Pv, dim=-1)
    logw = (-0.5 * quad0 - halfLogDetP - half_logdet(L)
            + 0.5 * torch.sum(v * v, dim=-1))
    return logw, retried


def _woodbury_rank_ny(W, hldM, U, sign: float, jitter):
    """Exact rank-ny update of (W = M^-1, hldM = 0.5 log|M|) under
    M' = M + sign * U U' (sign = +1 update / -1 downdate).

        W'    = W - sign * G Bpos^-1 G',   G = W U,
        Bpos  = I + sign * U' G            (SPD in both directions
                                            while M' stays SPD),
        hldM' = hldM + 0.5 log|Bpos|.

    U [N, nl, ny]; W [N, nl, nl] in its storage dtype. G is float32; the
    correction is the sum over l = 0..ny-1, in that order, of broadcast
    outer products in float32, cast to W's dtype before the subtraction.
    Returns (W', hldM', retried).
    """
    ny = U.shape[-1]
    G = torch.einsum("pij,pjk->pik", W.to(_F32), U)
    Bpos = torch.eye(ny, dtype=_F32, device=U.device) \
        + sign * torch.einsum("pji,pjk->pik", U, G)
    if ny <= 3:
        L, retried = _chol_small_batched(Bpos, jitter)
        Binv = _inv_from_chol_small_batched(L)
    else:
        L, retried = psd_cholesky(Bpos, jitter)
        Binv = torch.cholesky_solve(
            torch.eye(ny, dtype=_F32, device=U.device).expand_as(L), L)
    hldM_new = hldM + half_logdet(L)
    GB = torch.einsum("pik,pkl->pil", G, Binv)
    corr = sum(
        GB[..., l][:, :, None] * G[..., l][:, None, :] for l in range(ny)
    )
    W_new = W - (sign * corr).to(W.dtype)
    return W_new, hldM_new, retried


def _woodbury_future_log_weights(ivec, W, P, hldp, hldM, ivec_add):
    """Ancestor measurement weights from the maintained inverse:
    :func:`_info_future_log_weights` with chol(Imat_end) replaced by
    (W, hldM): logw = -1/2 ivec'P ivec - hldp - hldM
    + 1/2 (ivec+ivecAdd)' W (ivec+ivecAdd)."""
    ivec_end = ivec + ivec_add[None]
    Wv = torch.einsum("pij,pj->pi", W.to(_F32), ivec_end)
    quadW = torch.sum(ivec_end * Wv, dim=-1)
    Pv = torch.einsum("pij,pj->pi", P.to(_F32), ivec)
    quad0 = torch.sum(ivec * Pv, dim=-1)
    return -0.5 * quad0 - hldp - hldM + 0.5 * quadW


def _kf_info_update_batched(C, P, xl, ivec, Imat, hldp, y_t, R, Rinv,
                            half_logdet_R, jitter, joseph,
                            symmetrize_out=True, update_imat=True):
    """Whole-ensemble KF update + information-pair update (:316-335) and
    halfLogDetP recursion (:298). C [N, ny, nl]; P and Imat may be stored
    in a reduced dtype (accumulation stays float32). ``update_imat=False``
    passes the Imat slot through untouched (the Woodbury form carries W
    there and maintains it separately). Returns
    (xl', P', ivec', Imat', hldp', logw, retried)."""
    xl_new, P_new, logw, retried, hld_S = kalman_update_dense_batched_hld(
        C, P, xl, y_t, R, jitter, joseph, symmetrize_out
    )
    CtRinv = torch.einsum("pki,kl->pil", C, Rinv)            # [N, nl, ny]
    ivec_new = ivec + torch.einsum("pil,l->pi", CtRinv, y_t)
    if update_imat:
        dI = torch.einsum("pil,plj->pij", CtRinv, C)
        Imat_new = Imat + dI.to(Imat.dtype)
    else:
        Imat_new = Imat
    # halfLogDetP' = -sum log diag chol(S) + 0.5 log|R| + halfLogDetP
    hldp_new = -hld_S + half_logdet_R + hldp
    return xl_new, P_new, ivec_new, Imat_new, hldp_new, logw, retried


def _info_sweep(model: DenseModel, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                config: RBPSConfig, xnk, is_first: bool,
                draws: SweepDraws) -> SweepOut:
    """One information-form sweep over tensors already on the run's device
    (see engines/rbps.py::_cpf_as_sweep for the arguments)."""
    n_p = config.n_particles
    T, ny = y.shape
    device = y.device
    n_lin = model.n_lin
    cov_dtype = _DTYPES[config.cov_dtype]
    Rinv = torch.linalg.inv(R)

    xn = x0_nonlin.expand(n_p, -1).clone()
    if not is_first:
        xn[n_p - 1] = xnk[0]
    xl0, P0_lin = _init_linear(x0_lin, P0_lin, n_p, device)

    # initial information pair; P0 treated as diagonal (:110-115)
    p0_diag = torch.diagonal(P0_lin)
    Imat0_single = torch.diag(1.0 / p0_diag)
    ivec0 = xl0 / p0_diag[None, :]
    hldp0 = (0.5 * torch.sum(torch.log(p0_diag))).expand(n_p)
    P0 = P0_lin.to(cov_dtype).expand(n_p, n_lin, n_lin)
    Imat0 = Imat0_single.to(cov_dtype).expand(n_p, n_lin, n_lin)
    half_logdet_R = 0.5 * torch.linalg.slogdet(R)[1]

    woodbury = config.ancestor_form == "woodbury"
    precomp = config.suffix_precompute and not is_first
    ivec_add = Imat_add = None
    if not is_first:
        C_ref = _jacobian_batch(model, xnk)                  # [T, ny, n_lin]
        # whole-trajectory suffix pair (:132-146)
        terms_iv = torch.einsum("tik,ij,tj->tk", C_ref, Rinv, y)
        ivec_add = torch.sum(terms_iv, dim=0)
        Imat_add = torch.einsum("tki,kl,tlj->ij", C_ref, Rinv, C_ref)
        if precomp:
            # suffix sums for every t at once: ivec_adds[t] =
            # sum_{j >= t} C_j' R^-1 y_j (one reverse cumulative sum per
            # sweep instead of T sequential downdates)
            ivec_adds = torch.flip(
                torch.cumsum(torch.flip(terms_iv, (0,)), dim=0), (0,))
            if not woodbury:
                terms_im = torch.einsum("tki,kl,tlj->tij", C_ref, Rinv, C_ref)
                Imat_adds = torch.flip(
                    torch.cumsum(torch.flip(terms_im, (0,)), dim=0), (0,))
                del terms_im

    # Woodbury ancestor form: carry W = (Imat+ImatAdd)^-1 in the Imat slot
    # and hldM = 0.5 log|Imat+ImatAdd| alongside, maintained by exact
    # rank-ny transitions instead of per-step factorizations
    use_wood = woodbury and not is_first
    RiT = torch.linalg.inv(torch.linalg.cholesky(R)).T       # U = C' L_R^-T

    def meas_all(xn, xl, P, ivec, Imat, hldp, y_t):
        C = _jacobian_batch(model, xn)
        return (C,) + _kf_info_update_batched(
            C, P, xl, ivec, Imat, hldp, y_t, R, Rinv, half_logdet_R,
            config.jitter, config.joseph, config.symmetrize_cov,
            update_imat=not use_wood,
        )

    # t = 0
    C0, xl, P, ivec, Imat, hldp, logw1, retried0 = meas_all(
        xn, xl0, P0, ivec0, Imat0, hldp0, y[0]
    )
    retries = retried0.sum()
    _, logw_n, _ = logsumexp_normalize(logw1)

    if use_wood:
        # W(1) = (Imat(0 post) + ImatAdd_[1:T))^-1. All rows of xn are the
        # broadcast initial state except the pinned reference particle
        # (the last), so two nl x nl factorizations cover the ensemble.
        C2 = torch.stack([C0[0], C0[n_p - 1]])               # [2, ny, nl]
        D2 = torch.einsum("pki,kl,plj->pij", C2, Rinv, C2)
        Add1 = Imat_add - C_ref[0].T @ Rinv @ C_ref[0]
        M2 = Imat0_single[None] + D2 + Add1[None]
        L2, retried_w1 = psd_cholesky(M2, config.jitter)
        W2 = torch.cholesky_solve(
            torch.eye(n_lin, device=device).expand(2, n_lin, n_lin), L2)
        hld2 = half_logdet(L2)
        Imat = W2[0].to(cov_dtype).expand(n_p, n_lin, n_lin).clone()
        Imat[n_p - 1] = W2[1].to(cov_dtype)
        hldM = hld2[0].expand(n_p).clone()
        hldM[n_p - 1] = hld2[1]
        retries = retries + retried_w1.sum()
    else:
        hldM = torch.zeros((n_p,), device=device)

    xn_hist = torch.empty((T, n_p, xn.shape[-1]), device=device)
    xn_hist[0] = xn
    ancestors = torch.empty((T - 1, n_p), dtype=torch.int32, device=device)
    ess = torch.empty((T,), device=device)
    ess[0] = _ess(logw_n)

    for t in range(1, T):
        i = t - 1
        u_res, w_dyn, u_anc = draws.step(i)
        ai = resample_indices(u_res, torch.exp(logw_n), n_p,
                              config.resampling)
        if not is_first:
            if precomp:
                ivec_add = ivec_adds[t]
                if not use_wood:
                    Imat_add = Imat_adds[t]
            else:
                # downdate the suffix pair by the (t-1) term (:194-201)
                CtRinv_prev = C_ref[t - 1].T @ Rinv
                ivec_add = ivec_add - CtRinv_prev @ y[t - 1]
                Imat_add = Imat_add - CtRinv_prev @ C_ref[t - 1]

            logw_dyn = _dyn_log_weights(model, xnk[t], xn, dx[i], dt[i], Q[i])
            if use_wood:
                logw_meas = _woodbury_future_log_weights(
                    ivec, Imat, P, hldp, hldM, ivec_add
                )
            else:
                logw_meas, retried = _info_future_log_weights(
                    ivec, Imat, P, hldp, ivec_add, Imat_add, config.jitter
                )
                retries = retries + retried.sum()
            pa, _, _ = logsumexp_normalize(logw_n + logw_dyn + logw_meas)
            ai[n_p - 1] = sample_categorical(u_anc, pa)

        xn = _dynamics_batch(model, w_dyn, xn[ai], dx[i], dt[i], Q[i])
        if not is_first:
            xn[n_p - 1] = xnk[t]
        hldM = hldM[ai]
        C_t, xl, P, ivec, Imat, hldp, logw, retried_kf = meas_all(
            xn, xl[ai], P[ai], ivec[ai], Imat[ai], hldp[ai], y[t]
        )
        retries = retries + retried_kf.sum()
        if use_wood:
            # W: M(t) -> M(t+1) = M(t) + C_t' R^-1 C_t - C_ref' R^-1 C_ref
            U = torch.einsum("pki,km->pim", C_t, RiT)
            Imat, hldM, r_u = _woodbury_rank_ny(Imat, hldM, U, 1.0,
                                                config.jitter)
            Vb = (C_ref[t].T @ RiT)[None].expand(n_p, n_lin, ny)
            Imat, hldM, r_d = _woodbury_rank_ny(Imat, hldM, Vb, -1.0,
                                                config.jitter)
            retries = retries + r_u.sum() + r_d.sum()
        _, logw_n, _ = logsumexp_normalize(logw)
        xn_hist[t] = xn
        ancestors[i] = ai
        ess[t] = _ess(logw_n)

    return _finish_sweep(xn_hist, ancestors, logw_n, xl, P, ess, retries,
                         draws)


def run_rbps_information_form(model: DenseModel, dx, y, x0_nonlin, x0_lin,
                              P0_lin, Q, R, dt, config: RBPSConfig, *,
                              generator: Optional[torch.Generator], device,
                              noise=None, mask=None,
                              checkpoint_dir: Optional[str] = None,
                              mesh=None) -> RBPSResult:
    """N_K information-form CPF-AS sweeps on ``device`` (dense features
    only, :77-80). Arguments, ``generator`` and ``noise`` as
    :func:`rbslam_tpu_torch.engines.rbps.run_rbps`; ``mask`` is ignored
    (dense models have no visibility masking)."""
    del mask
    if not isinstance(model, DenseModel):
        raise ValueError(
            "the information-form smoother supports dense features only "
            "(as the reference, src/particleSmootherInformationForm.m:77-80);"
            " use run_rbps for sparse models")
    _check_supported(model, config, mesh)
    refuse_tf32(device, "the information-form smoother (it maintains W "
                "by cancellation)")
    return _run_sweeps(_info_sweep, model, dx, y, x0_nonlin, x0_lin, P0_lin,
                       Q, R, dt, config, generator, device, noise,
                       checkpoint_dir)
