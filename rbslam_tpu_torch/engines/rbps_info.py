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

With a device ``mesh`` (parallel/) each rank runs its block of particles
and holds a row block of P and of Imat (or W) over the ``map`` axis; the
ancestor weights, the resampling CDF and the reference particle's
ancestor draw come from the whole ensemble's log-weights, gathered, and
the reference particle (the last) lives on the last particle rank.
"""

from __future__ import annotations

from functools import partial
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
from ..ops.resampling import sample_categorical
from ..parallel.map_axis import quad_partial
from ..utils.profiling import phase_annotation
from .rbpf import (
    _DTYPES,
    Ensemble,
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
                             jitter, axis=None):
    """Ancestor measurement weights, information form (:224-236), batched
    over the ensemble (one [N, nl, nl] Cholesky; storage dtypes are
    promoted to float32 for the factorization). With a map ``axis``, Imat
    and P are row blocks; the matrix to factor is gathered whole on every
    rank of the ``map`` group. Returns (logw, retried)."""
    rows = slice(None) if axis is None else axis.rows
    # no symmetrize: the factorization reads only the lower triangle
    Imat_end = Imat.to(_F32) + Imat_add[None, rows]
    if axis is not None:
        Imat_end = axis.gather(Imat_end, 1)
    L, retried = psd_cholesky(Imat_end, jitter)
    v = tril_solve(L, ivec + ivec_add[None])
    quad0 = quad_partial(ivec, P, axis)
    if axis is not None:
        quad0 = axis.reduce(quad0)
    logw = (-0.5 * quad0 - halfLogDetP - half_logdet(L)
            + 0.5 * torch.sum(v * v, dim=-1))
    return logw, retried


def _woodbury_rank_ny(W, hldM, U, sign: float, jitter, axis=None):
    """Exact rank-ny update of (W = M^-1, hldM = 0.5 log|M|) under
    M' = M + sign * U U' (sign = +1 update / -1 downdate).

        W'    = W - sign * G Bpos^-1 G',   G = W U,
        Bpos  = I + sign * U' G            (SPD in both directions
                                            while M' stays SPD),
        hldM' = hldM + 0.5 log|Bpos|.

    U [N, nl, ny]; W [N, nl, nl] in its storage dtype. G is float32; the
    correction is the sum over l = 0..ny-1, in that order, of broadcast
    outer products in float32, cast to W's dtype before the subtraction.
    With a map ``axis`` W is this rank's row block [N, nl/S, nl]: G's rows
    are local, Bpos is completed by one all-reduce and the correction's
    other factor by one all-gather of G (the collectives of
    parallel/map_axis.py). Returns (W', hldM', retried).
    """
    ny = U.shape[-1]
    rows = slice(None) if axis is None else axis.rows
    G = torch.einsum("pij,pjk->pik", W.to(_F32), U)
    B = torch.einsum("pji,pjk->pik", U[:, rows], G)
    Bpos = torch.eye(ny, dtype=_F32, device=U.device) \
        + sign * (B if axis is None else axis.reduce(B))
    if ny <= 3:
        L, retried = _chol_small_batched(Bpos, jitter)
        Binv = _inv_from_chol_small_batched(L)
    else:
        L, retried = psd_cholesky(Bpos, jitter)
        Binv = torch.cholesky_solve(
            torch.eye(ny, dtype=_F32, device=U.device).expand_as(L), L)
    hldM_new = hldM + half_logdet(L)
    GB = torch.einsum("pik,pkl->pil", G, Binv)
    G_all = G if axis is None else axis.gather(G, 1)
    corr = sum(
        GB[..., l][:, :, None] * G_all[..., l][:, None, :] for l in range(ny)
    )
    W_new = W - (sign * corr).to(W.dtype)
    return W_new, hldM_new, retried


def _woodbury_future_log_weights(ivec, W, P, hldp, hldM, ivec_add,
                                 axis=None):
    """Ancestor measurement weights from the maintained inverse:
    :func:`_info_future_log_weights` with chol(Imat_end) replaced by
    (W, hldM): logw = -1/2 ivec'P ivec - hldp - hldM
    + 1/2 (ivec+ivecAdd)' W (ivec+ivecAdd). With a map ``axis`` (W and P
    row blocks) both quadratic forms share one all-reduce of [N, 2]."""
    ivec_end = ivec + ivec_add[None]
    quads = torch.stack([quad_partial(ivec_end, W, axis),
                         quad_partial(ivec, P, axis)])
    if axis is not None:
        quads = axis.reduce(quads)
    quadW, quad0 = quads[0], quads[1]
    return -0.5 * quad0 - hldp - hldM + 0.5 * quadW


def _kf_info_update_batched(C, P, xl, ivec, Imat, hldp, y_t, R, Rinv,
                            half_logdet_R, jitter, joseph,
                            symmetrize_out=True, update_imat=True,
                            axis=None):
    """Whole-ensemble KF update + information-pair update (:316-335) and
    halfLogDetP recursion (:298). C [N, ny, nl]; P and Imat may be stored
    in a reduced dtype (accumulation stays float32). ``update_imat=False``
    passes the Imat slot through untouched (the Woodbury form carries W
    there and maintains it separately). With a map ``axis`` P and Imat
    are row blocks (ops/kalman.py). Returns
    (xl', P', ivec', Imat', hldp', logw, retried)."""
    xl_new, P_new, logw, retried, hld_S = kalman_update_dense_batched_hld(
        C, P, xl, y_t, R, jitter, joseph, symmetrize_out, axis
    )
    CtRinv = torch.einsum("pki,kl->pil", C, Rinv)            # [N, nl, ny]
    ivec_new = ivec + torch.einsum("pil,l->pi", CtRinv, y_t)
    if update_imat:
        rows = slice(None) if axis is None else axis.rows
        dI = torch.einsum("pil,plj->pij", CtRinv[:, rows], C)
        Imat_new = Imat + dI.to(Imat.dtype)
    else:
        Imat_new = Imat
    # halfLogDetP' = -sum log diag chol(S) + 0.5 log|R| + halfLogDetP
    hldp_new = -hld_S + half_logdet_R + hldp
    return xl_new, P_new, ivec_new, Imat_new, hldp_new, logw, retried


def _info_sweep(model: DenseModel, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                config: RBPSConfig, xnk, is_first: bool,
                draws: SweepDraws, mesh=None) -> SweepOut:
    """One information-form sweep over tensors already on the run's device
    (see engines/rbps.py::_cpf_as_sweep for the arguments), on this rank's
    particles and map rows where ``mesh`` is given."""
    n_p = config.n_particles
    T, ny = y.shape
    device = y.device
    with phase_annotation("setup", memory_of=device):
        n_lin = model.n_lin
        cov_dtype = _DTYPES[config.cov_dtype]
        Rinv = torch.linalg.inv(R)
        if mesh is None:
            ens = Ensemble(n_p)
        else:
            from ..parallel.sharded import ShardedEnsemble

            ens = ShardedEnsemble(n_p, mesh, n_lin)
        axis, rows, n_loc = ens.map, ens.map_rows, ens.n_local
        # the reference particle (the last) on this process: its local index
        ref = n_p - 1 - ens.start
        has_ref = 0 <= ref < n_loc

        xn = ens.local(x0_nonlin.expand(n_p, -1)).clone()
        if not is_first and has_ref:
            xn[ref] = xnk[0]
        xl0, P0_lin = _init_linear(x0_lin, P0_lin, n_p, device)
        xl0 = ens.local(xl0)

        # initial information pair; P0 treated as diagonal (:110-115)
        p0_diag = torch.diagonal(P0_lin)
        Imat0_single = torch.diag(1.0 / p0_diag)
        ivec0 = xl0 / p0_diag[None, :]
        hldp0 = (0.5 * torch.sum(torch.log(p0_diag))).expand(n_loc)
        P0 = P0_lin.to(cov_dtype)[rows]
        P0 = P0.expand((n_loc,) + P0.shape)
        Imat0 = Imat0_single.to(cov_dtype)[rows]
        Imat0 = Imat0.expand((n_loc,) + Imat0.shape)
        half_logdet_R = 0.5 * torch.linalg.slogdet(R)[1]

        woodbury = config.ancestor_form == "woodbury"
        precomp = config.suffix_precompute and not is_first
        ivec_add = Imat_add = None
        if not is_first:
            C_ref = _jacobian_batch(model, xnk)          # [T, ny, n_lin]
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
                    terms_im = torch.einsum("tki,kl,tlj->tij", C_ref, Rinv,
                                            C_ref)
                    Imat_adds = torch.flip(
                        torch.cumsum(torch.flip(terms_im, (0,)), dim=0), (0,))
                    del terms_im

        # Woodbury ancestor form: carry W = (Imat+ImatAdd)^-1 in the Imat slot
        # and hldM = 0.5 log|Imat+ImatAdd| alongside, maintained by exact
        # rank-ny transitions instead of per-step factorizations
        use_wood = woodbury and not is_first
        RiT = torch.linalg.inv(torch.linalg.cholesky(R)).T   # U = C' L_R^-T

        def meas_all(xn, xl, P, ivec, Imat, hldp, y_t):
            C = _jacobian_batch(model, xn)
            return (C,) + _kf_info_update_batched(
                C, P, xl, ivec, Imat, hldp, y_t, R, Rinv, half_logdet_R,
                config.jitter, config.joseph, config.symmetrize_cov,
                update_imat=not use_wood, axis=axis,
            )

        # t = 0
        C0, xl, P, ivec, Imat, hldp, logw1, retried0 = meas_all(
            xn, xl0, P0, ivec0, Imat0, hldp0, y[0]
        )
        retries = retried0.sum()
        # factorizations every process does alike (counted once)
        retries_shared = torch.zeros((), dtype=retries.dtype, device=device)
        _, logw_n, _, logw_all = ens.normalize(logw1)

        if use_wood:
            # W(1) = (Imat(0 post) + ImatAdd_[1:T))^-1. All rows of xn are the
            # broadcast initial state except the pinned reference particle
            # (the last), so two nl x nl factorizations cover the ensemble.
            C2 = ens.rows_at(C0, torch.tensor([0, n_p - 1], device=device))
            D2 = torch.einsum("pki,kl,plj->pij", C2, Rinv, C2)
            Add1 = Imat_add - C_ref[0].T @ Rinv @ C_ref[0]
            M2 = Imat0_single[None] + D2 + Add1[None]
            L2, retried_w1 = psd_cholesky(M2, config.jitter)
            W2 = torch.cholesky_solve(
                torch.eye(n_lin, device=device).expand(2, n_lin, n_lin), L2)
            hld2 = half_logdet(L2)
            Imat = W2[0, rows].to(cov_dtype).expand(n_loc, -1, -1).clone()
            hldM = hld2[0].expand(n_loc).clone()
            if has_ref:
                Imat[ref] = W2[1, rows].to(cov_dtype)
                hldM[ref] = hld2[1]
            retries_shared = retries_shared + retried_w1.sum()
        else:
            hldM = torch.zeros((n_loc,), device=device)

        xn_hist = torch.empty((T, n_loc, xn.shape[-1]), device=device)
        xn_hist[0] = xn
        ancestors = torch.empty((T - 1, n_loc), dtype=torch.int32,
                                device=device)
        ess = torch.empty((T,), device=device)
        ess[0] = _ess(logw_all)

    for t in range(1, T):
        with phase_annotation("step", memory_of=device, t=t):
            i = t - 1
            with phase_annotation("resample"):
                u_res, w_dyn, u_anc = draws.step(i)
                ai, _ = ens.resample(u_res, torch.exp(logw_n),
                                     config.resampling)
            if not is_first:
                with phase_annotation("ancestor"):
                    if precomp:
                        ivec_add = ivec_adds[t]
                        if not use_wood:
                            Imat_add = Imat_adds[t]
                    else:
                        # downdate the suffix pair by the (t-1) term
                        # (:194-201)
                        CtRinv_prev = C_ref[t - 1].T @ Rinv
                        ivec_add = ivec_add - CtRinv_prev @ y[t - 1]
                        Imat_add = Imat_add - CtRinv_prev @ C_ref[t - 1]

                    logw_dyn = _dyn_log_weights(model, xnk[t], xn, dx[i],
                                                dt[i], Q[i])
                    if use_wood:
                        logw_meas = _woodbury_future_log_weights(
                            ivec, Imat, P, hldp, hldM, ivec_add, axis
                        )
                    else:
                        logw_meas, retried = _info_future_log_weights(
                            ivec, Imat, P, hldp, ivec_add, Imat_add,
                            config.jitter, axis
                        )
                        retries = retries + retried.sum()
                    pa_all = ens.normalize(logw_n + logw_dyn + logw_meas)[3]
                    anc = sample_categorical(u_anc, torch.exp(pa_all))
                    if has_ref:
                        ai[ref] = anc

            with phase_annotation("dynamics"):
                xn = _dynamics_batch(model, ens.local(w_dyn),
                                     ens.take(xn, ai), dx[i], dt[i], Q[i])
                if not is_first and has_ref:
                    xn[ref] = xnk[t]
            with phase_annotation("update"):
                hldM = ens.take(hldM, ai)
                C_t, xl, P, ivec, Imat, hldp, logw, retried_kf = meas_all(
                    xn, ens.take(xl, ai), ens.take(P, ai),
                    ens.take(ivec, ai), ens.take(Imat, ai),
                    ens.take(hldp, ai), y[t]
                )
                retries = retries + retried_kf.sum()
            if use_wood:
                with phase_annotation("woodbury"):
                    # W: M(t) -> M(t+1) = M(t) + C_t' R^-1 C_t
                    #                           - C_ref' R^-1 C_ref
                    U = torch.einsum("pki,km->pim", C_t, RiT)
                    Imat, hldM, r_u = _woodbury_rank_ny(
                        Imat, hldM, U, 1.0, config.jitter, axis)
                    Vb = (C_ref[t].T @ RiT)[None].expand(n_loc, n_lin, ny)
                    Imat, hldM, r_d = _woodbury_rank_ny(
                        Imat, hldM, Vb, -1.0, config.jitter, axis)
                    retries = retries + r_u.sum() + r_d.sum()
            with phase_annotation("weights"):
                _, logw_n, _, logw_all = ens.normalize(logw)
                xn_hist[t] = xn
                ancestors[i] = ai
                ess[t] = _ess(logw_all)

    with phase_annotation("finish", memory_of=device):
        return _finish_sweep(xn_hist, ancestors, logw_all, xl, P, ess,
                             retries, draws, ens, retries_shared)


def run_rbps_information_form(model: DenseModel, dx, y, x0_nonlin, x0_lin,
                              P0_lin, Q, R, dt, config: RBPSConfig, *,
                              generator: Optional[torch.Generator], device,
                              noise=None, mask=None,
                              checkpoint_dir: Optional[str] = None,
                              mesh=None) -> RBPSResult:
    """N_K information-form CPF-AS sweeps on ``device`` (dense features
    only, :77-80). Arguments, ``generator`` and ``noise`` as
    :func:`rbslam_tpu_torch.engines.rbps.run_rbps`; ``mask`` is ignored
    (dense models have no visibility masking).

    ``mesh`` (parallel.make_mesh) shards each sweep's ensemble over its
    ("particles", "map") dims: N/S_p particles and n_lin/S_map rows of P
    and Imat (or W) a rank. Every rank passes the same arguments (the
    same ``noise``, or a generator seeded the same, whose global draws it
    cuts to its particles). Result on every rank: XNK, XLK, PK, ess,
    chol_retries and kept are the whole run's, equal to the unsharded
    run's; ``ancestors`` holds the rank's particles' columns (global
    indices). Per-sweep checkpoints (``checkpoint_dir``, one directory
    that every rank sees) and the Joseph form run on the mesh too; a
    mesh checkpoint has the single-process layout, every rank's ancestors
    included (engines/rbps.py::_run_sweeps).
    """
    del mask
    if not isinstance(model, DenseModel):
        raise ValueError(
            "the information-form smoother supports dense features only "
            "(as the reference, src/particleSmootherInformationForm.m:77-80);"
            " use run_rbps for sparse models")
    _check_supported(model, config)
    refuse_tf32(device, "the information-form smoother (it maintains W "
                "by cancellation)")
    sweep = _info_sweep if mesh is None else partial(_info_sweep, mesh=mesh)
    return _run_sweeps(sweep, model, dx, y, x0_nonlin, x0_lin, P0_lin,
                       Q, R, dt, config, generator, device, noise,
                       checkpoint_dir, mesh)
