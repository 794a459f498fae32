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

One function runs a step (:func:`_info_step`): it reads the step index
from a tensor on the device and writes the carried state back in place,
so that on one CUDA device a sweep's steps can run as replays of one
captured CUDA graph (:class:`_StepGraphs`, where :func:`_graphs_engage`
allows) instead of several hundred launches from the host each; the
eager loop runs the same function.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import NamedTuple, Optional

import torch

from ..kernels import _lib
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


def _woodbury_rank_ny(W, hldM, U, sign: float, jitter, axis=None, out=None):
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
    parallel/map_axis.py). W' is written into ``out`` where given (a
    tensor other than W). Returns (W', hldM', retried).
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
    W_new = torch.sub(W, (sign * corr).to(W.dtype), out=out)
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


class _Sweep(NamedTuple):
    """What a step of one sweep reads besides tensors."""

    model: DenseModel
    config: RBPSConfig
    ens: Ensemble
    is_first: bool
    precomp: bool       # the suffix sums precomputed (else carried, downdated)
    use_wood: bool      # the Woodbury ancestor form (W carried in "Imat")
    has_ref: bool       # the reference particle is on this process
    ref: int            # its local index
    draws: SweepDraws


def _sweep_setup(model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                 config: RBPSConfig, xnk, is_first: bool, draws: SweepDraws,
                 mesh):
    """A sweep up to its first transition: the ensemble's state after the
    update at t = 0, the tensors every step reads, and the step's other
    arguments. Returns (sweep, state, io, retries_shared): ``state`` the
    carried tensors, ``io`` the inputs, ``retries_shared`` the retries of
    the factorizations every process does alike (counted once)."""
    n_p = config.n_particles
    T, ny = y.shape
    device = y.device
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
    half_logdet_R = 0.5 * torch.linalg.slogdet(R)[1]

    woodbury = config.ancestor_form == "woodbury"
    precomp = config.suffix_precompute and not is_first
    # Woodbury ancestor form: carry W = (Imat+ImatAdd)^-1 in the Imat slot
    # and hldM = 0.5 log|Imat+ImatAdd| alongside, maintained by exact
    # rank-ny transitions instead of per-step factorizations. The first
    # sweep weighs no ancestor, so it carries neither Imat nor W.
    use_wood = woodbury and not is_first
    carry_imat = not (woodbury or is_first)
    io = {"R": R, "Rinv": Rinv, "half_logdet_R": half_logdet_R, "y": y,
          "dx": dx, "dt": dt, "Q": Q}
    if draws.tables is not None:
        io.update(zip(("u", "w", "u_anc"), draws.tables))
    state = {}
    if not is_first:
        io["xnk"] = xnk
        C_ref = _jacobian_batch(model, xnk)          # [T, ny, n_lin]
        # whole-trajectory suffix pair (:132-146)
        terms_iv = torch.einsum("tik,ij,tj->tk", C_ref, Rinv, y)
        ivec_add = torch.sum(terms_iv, dim=0)
        Imat_add = torch.einsum("tki,kl,tlj->ij", C_ref, Rinv, C_ref)
        if precomp:
            # suffix sums for every t at once: ivec_adds[t] =
            # sum_{j >= t} C_j' R^-1 y_j (one reverse cumulative sum per
            # sweep instead of T sequential downdates)
            io["ivec_adds"] = torch.flip(
                torch.cumsum(torch.flip(terms_iv, (0,)), dim=0), (0,))
            if not woodbury:
                terms_im = torch.einsum("tki,kl,tlj->tij", C_ref, Rinv,
                                        C_ref)
                io["Imat_adds"] = torch.flip(
                    torch.cumsum(torch.flip(terms_im, (0,)), dim=0), (0,))
                del terms_im
        else:
            # the suffix pair carried and downdated a step at a time
            io["C_ref"] = C_ref
            state["ivec_add"] = ivec_add
            if not woodbury:
                state["Imat_add"] = Imat_add
    RiT = torch.linalg.inv(torch.linalg.cholesky(R)).T   # U = C' L_R^-T
    if use_wood:
        io["RiT"] = RiT
        # the downdate's factor C_ref[t]' L_R^-T of every step
        io["Vb"] = C_ref.transpose(-1, -2) @ RiT            # [T, n_lin, ny]

    # t = 0
    C0 = _jacobian_batch(model, xn)
    Imat0 = None
    if carry_imat:
        Imat0 = Imat0_single.to(cov_dtype)[rows]
        Imat0 = Imat0.expand((n_loc,) + Imat0.shape)
    xl, P, ivec, Imat, hldp, logw1, retried0 = _kf_info_update_batched(
        C0, P0, xl0, ivec0, Imat0, hldp0, y[0], R, Rinv, half_logdet_R,
        config.jitter, config.joseph, config.symmetrize_cov,
        update_imat=carry_imat, axis=axis)
    retries = retried0.sum()
    retries_shared = torch.zeros((), dtype=retries.dtype, device=device)
    _, logw_n, _, logw_all = ens.normalize(logw1)
    state.update(xn=xn, xl=xl, P=P, ivec=ivec, hldp=hldp, logw_n=logw_n,
                 retries=retries)
    if logw_all is not logw_n:          # the whole ensemble's, on a mesh
        state["logw_all"] = logw_all
    if carry_imat:
        state["Imat"] = Imat

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
        W = W2[0, rows].to(cov_dtype).expand(n_loc, -1, -1).clone()
        hldM = hld2[0].expand(n_loc).clone()
        if has_ref:
            W[ref] = W2[1, rows].to(cov_dtype)
            hldM[ref] = hld2[1]
        state["Imat"], state["hldM"] = W, hldM
        retries_shared = retries_shared + retried_w1.sum()
    sweep = _Sweep(model, config, ens, is_first, precomp, use_wood, has_ref,
                   ref, draws)
    return sweep, state, io, retries_shared


def _info_step(sw: _Sweep, s: dict, io: dict, phase=phase_annotation):
    """Transition t-1 -> t of an information-form sweep, in place.

    Reads the carried state ``s`` and the sweep's inputs ``io`` at the
    step index io["ti"] = (t, t - 1), a tensor on the run's device: every
    read of t is an ``index_select`` and every write an ``index_copy_``,
    so one capture of the step serves every step of its sweep kind
    (:class:`_StepGraphs`). Each new value is written back into its tensor
    of ``s`` as soon as the old one has been read for the last time (P
    after the update, W by the second rank-ny update), then io["ti"]
    advances. ``phase`` names the child phases."""
    model, cfg, ens = sw.model, sw.config, sw.ens
    axis = ens.map
    t, i = io["ti"][:1], io["ti"][1:]

    def at(name, idx):
        return io[name].index_select(0, idx)[0]

    with phase("resample"):
        if "u" in io:
            u_res, w_dyn, u_anc = at("u", i), at("w", i), at("u_anc", i)
        else:
            u_res, w_dyn, u_anc = sw.draws.step(i)
        ai, _ = ens.resample(u_res, torch.exp(s["logw_n"]), cfg.resampling)
    dx_i, dt_i, Q_i = at("dx", i), at("dt", i), at("Q", i)
    if not sw.is_first:
        with phase("ancestor"):
            xnk_t = at("xnk", t)
            Imat_add = None
            if sw.precomp:
                ivec_add = at("ivec_adds", t)
                if not sw.use_wood:
                    Imat_add = at("Imat_adds", t)
            else:
                # downdate the suffix pair by the (t-1) term (:194-201)
                C_prev = at("C_ref", i)
                CtRinv_prev = C_prev.T @ io["Rinv"]
                ivec_add = s["ivec_add"] - CtRinv_prev @ at("y", i)
                s["ivec_add"].copy_(ivec_add)
                if not sw.use_wood:
                    Imat_add = s["Imat_add"] - CtRinv_prev @ C_prev
                    s["Imat_add"].copy_(Imat_add)

            logw_dyn = _dyn_log_weights(model, xnk_t, s["xn"], dx_i, dt_i,
                                        Q_i)
            if sw.use_wood:
                logw_meas = _woodbury_future_log_weights(
                    s["ivec"], s["Imat"], s["P"], s["hldp"], s["hldM"],
                    ivec_add, axis
                )
            else:
                logw_meas, retried = _info_future_log_weights(
                    s["ivec"], s["Imat"], s["P"], s["hldp"], ivec_add,
                    Imat_add, cfg.jitter, axis
                )
                s["retries"].add_(retried.sum())
            pa_all = ens.normalize(s["logw_n"] + logw_dyn + logw_meas)[3]
            anc = sample_categorical(u_anc, torch.exp(pa_all))
            if sw.has_ref:
                ai[sw.ref] = anc

    with phase("dynamics"):
        xn = _dynamics_batch(model, ens.local(w_dyn), ens.take(s["xn"], ai),
                             dx_i, dt_i, Q_i)
        if not sw.is_first and sw.has_ref:
            xn[sw.ref] = xnk_t
        s["xn"].copy_(xn)
    with phase("update"):
        carry_imat = "Imat" in s and not sw.use_wood
        C_t = _jacobian_batch(model, xn)
        xl, P, ivec, Imat, hldp, logw, retried = _kf_info_update_batched(
            C_t, ens.take(s["P"], ai), ens.take(s["xl"], ai),
            ens.take(s["ivec"], ai),
            ens.take(s["Imat"], ai) if carry_imat else None,
            ens.take(s["hldp"], ai), at("y", t), io["R"], io["Rinv"],
            io["half_logdet_R"], cfg.jitter, cfg.joseph, cfg.symmetrize_cov,
            update_imat=carry_imat, axis=axis,
        )
        s["retries"].add_(retried.sum())
        for name, new in (("xl", xl), ("P", P), ("ivec", ivec),
                          ("hldp", hldp), ("Imat", Imat)):
            if new is not None:
                s[name].copy_(new)
        del P, Imat
    if sw.use_wood:
        with phase("woodbury"):
            # W: M(t) -> M(t+1) = M(t) + C_t' R^-1 C_t
            #                           - C_ref' R^-1 C_ref
            U = torch.einsum("pki,km->pim", C_t, io["RiT"])
            W, hldM, r_u = _woodbury_rank_ny(
                ens.take(s["Imat"], ai), ens.take(s["hldM"], ai), U, 1.0,
                cfg.jitter, axis)
            Vb = at("Vb", t)[None].expand((ens.n_local,) + U.shape[1:])
            _, hldM, r_d = _woodbury_rank_ny(W, hldM, Vb, -1.0, cfg.jitter,
                                             axis, out=s["Imat"])
            s["hldM"].copy_(hldM)
            s["retries"].add_(r_u.sum() + r_d.sum())
    with phase("weights"):
        _, logw_n, _, logw_all = ens.normalize(logw)
        s["logw_n"].copy_(logw_n)
        if "logw_all" in s:
            s["logw_all"].copy_(logw_all)
        io["xn_hist"].index_copy_(0, t, xn[None])
        io["ancestors"].index_copy_(0, i, ai[None])
        io["ess"].index_copy_(0, t, _ess(logw_all)[None])
    io["ti"].add_(1)


_QUIET = contextlib.nullcontext()


def _no_phase(name, **attrs):
    """A phase that records nothing: the child phases of a captured step
    (a replay keeps only its ``step`` span)."""
    return _QUIET


def _graphs_engage(device, mesh, ny: int, ancestor_form: str,
                   is_first: bool, injected: bool) -> bool:
    """Whether a sweep's steps run as replays of a captured CUDA graph.
    Only where the step reads nothing back to the host: one CUDA device
    and no mesh (NCCL collectives), the small-ny update (for ny > 3 the
    update and the rank-ny inverse factor with psd_cholesky, which reads a
    failure flag), the first sweep or the Woodbury ancestor form (the
    Cholesky form factors with psd_cholesky every step), and draws that
    are ``injected`` or come from a generator this torch can register
    with a capture."""
    if torch.device(device).type != "cuda" or mesh is not None or ny > 3:
        return False
    if not is_first and ancestor_form != "woodbury":
        return False
    return injected or hasattr(torch.cuda.CUDAGraph,
                               "register_generator_state")


class _EagerSteps:
    """The eager runner: every step launched from the host, on tensors of
    the sweep's own."""

    @staticmethod
    def static(name, value):
        """A tensor of the sweep's own holding ``value`` (which may be a
        view the step must not write through)."""
        return value.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def buffer(name, shape, dtype, device):
        return torch.empty(shape, dtype=dtype, device=device)

    @staticmethod
    def run(step, T, device, kind):
        for t in range(1, T):
            with phase_annotation("step", memory_of=device, t=t, graph=False):
                step(phase_annotation)


_side_streams: dict = {}   # device -> the stream of every warm-up and capture


def _side_stream(device) -> "torch.cuda.Stream":
    """One stream a device for every warm-up and capture of the process (a
    capture needs a stream other than the default one, and cuBLAS keeps a
    workspace, 32 MiB on Hopper, for each stream it has run on)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class _StepGraphs:
    """The graph runner of one run_rbps_information_form call.

    A step of each sweep kind (the first sweep; the conditioned ones) runs
    eagerly once to warm its kernels, is captured into a CUDA graph at the
    next step, and that graph is replayed for every later step of its kind
    in the call. The graphs read and write one set of static buffers for
    the call: the carried state, the sweep's inputs (refilled by each
    sweep's set-up) and its outputs. Warm-ups and captures run on
    :func:`_side_stream`, replays on the caller's stream. A replay counts
    the launches its capture counted (kernels/_lib.py::count_replay).
    :meth:`release` drops the graphs, their memory pools and the buffers.
    """

    def __init__(self, generator=None):
        self.generator = generator      # registered with every capture
        self._buffers = {}
        self._graphs = {}               # kind -> (replay, launches)

    def static(self, name, value):
        """The call's buffer ``name``, filled with ``value``."""
        buf = self._buffers.get(name)
        if buf is None:
            buf = self._buffers[name] = torch.empty_like(
                value, memory_format=torch.contiguous_format)
        return buf.copy_(value)

    def buffer(self, name, shape, dtype, device):
        """The call's buffer ``name`` (an output, written by the steps)."""
        if name not in self._buffers:
            self._buffers[name] = torch.empty(shape, dtype=dtype,
                                              device=device)
        return self._buffers[name]

    def run(self, step, T, device, kind):
        """Steps 1..T-1 of a sweep of ``kind``: ``step(phase)`` runs one."""
        for t in range(1, T):
            graph = self._graphs.get(kind)
            warm = graph is None and t == 1
            with phase_annotation("step", memory_of=device, t=t,
                                  graph=not warm):
                if warm:
                    self._on_side_stream(device,
                                         lambda: step(phase_annotation))
                elif graph is None:
                    before = _lib.launch_counts()
                    replay = self._capture(device, lambda: step(_no_phase))
                    self._graphs[kind] = (replay, {
                        k: n - before[k]
                        for k, n in _lib.launch_counts().items()
                        if n != before[k]})
                    replay()    # the capture counted this step's launches
                else:
                    graph[0]()
                    _lib.count_replay(graph[1])

    def release(self):
        self._graphs.clear()
        self._buffers.clear()

    @staticmethod
    def _on_side_stream(device, fn):
        side = _side_stream(device)
        caller = torch.cuda.current_stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            fn()
        caller.wait_stream(side)

    def _capture(self, device, fn):
        """``fn``'s launches captured into a CUDA graph: its replay."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)

        def capture():
            graph.capture_begin()
            try:
                fn()
            finally:
                graph.capture_end()

        self._on_side_stream(device, capture)
        return graph.replay


def _info_sweep(model: DenseModel, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                config: RBPSConfig, xnk, is_first: bool,
                draws: SweepDraws, mesh=None, graphs=None) -> SweepOut:
    """One information-form sweep over tensors already on the run's device
    (see engines/rbps.py::_cpf_as_sweep for the arguments), on this rank's
    particles and map rows where ``mesh`` is given. Its steps run as
    replays of the call's ``graphs`` (:class:`_StepGraphs`) where
    :func:`_graphs_engage` allows, else eagerly."""
    T, ny = y.shape
    device = y.device
    steps = _EagerSteps
    if graphs is not None and _graphs_engage(
            device, mesh, ny, config.ancestor_form, is_first,
            draws.tables is not None):
        steps = graphs
    with phase_annotation("setup", memory_of=device):
        sw, state, io, retries_shared = _sweep_setup(
            model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt, config, xnk,
            is_first, draws, mesh)
        state = {k: steps.static(k, v) for k, v in state.items()}
        io = {k: steps.static(k, v) for k, v in io.items()}
        io["ti"] = steps.static("ti", torch.arange(1, -1, -1, device=device))
        n_loc, n_nonlin = state["xn"].shape
        io["xn_hist"] = steps.buffer("xn_hist", (T, n_loc, n_nonlin),
                                     torch.float32, device)
        io["ancestors"] = steps.buffer("ancestors", (T - 1, n_loc),
                                       torch.int32, device)
        io["ess"] = steps.buffer("ess", (T,), torch.float32, device)
        logw_all = state.get("logw_all", state["logw_n"])
        io["xn_hist"][0] = state["xn"]
        io["ess"][0] = _ess(logw_all)

    steps.run(partial(_info_step, sw, state, io), T, device, is_first)

    with phase_annotation("finish", memory_of=device):
        return _finish_sweep(io["xn_hist"], io["ancestors"].clone(),
                             logw_all, state["xl"], state["P"],
                             io["ess"].clone(), state["retries"], draws,
                             sw.ens, retries_shared)


def run_rbps_information_form(model: DenseModel, dx, y, x0_nonlin, x0_lin,
                              P0_lin, Q, R, dt, config: RBPSConfig, *,
                              generator: Optional[torch.Generator], device,
                              noise=None, mask=None,
                              checkpoint_dir: Optional[str] = None,
                              mesh=None) -> RBPSResult:
    """N_K information-form CPF-AS sweeps on ``device`` (dense features
    only, :77-80). Arguments, ``generator`` and ``noise`` as
    :func:`rbslam_tpu_torch.engines.rbps.run_rbps`; ``mask`` is ignored
    (dense models have no visibility masking). On one CUDA device a
    sweep's steps run as replays of a captured CUDA graph wherever the
    step reads nothing back to the host (:func:`_graphs_engage`), with the
    eager loop's results bit for bit.

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
    graphs = _StepGraphs(None if noise is not None else generator)
    try:
        return _run_sweeps(partial(_info_sweep, mesh=mesh, graphs=graphs),
                           model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                           config, generator, device, noise, checkpoint_dir,
                           mesh)
    finally:
        graphs.release()
