"""Rao-Blackwellized particle smoother: conditional particle filter with
ancestor sampling (CPF-AS; port of rbslam_tpu/engines/rbps.py; the paper's
Alg. 2, src/particleSmoother.m).

N_K sweeps of a conditional RBPF. Sweep 1 is a plain RBPF; in sweeps
k > 1 particle N_P-1 is pinned to the reference trajectory sampled from
the previous sweep (:92-96,110-113) and its ancestor index is sampled from

    p(a) ∝ w_a · p(x'_t | x_a) · p(y_{t:T} | map_a)        (:171-233)

where the future-measurement likelihood evaluates the reference
trajectory's future observations against each particle's map posterior.
For a dense model the stacked future system (:188-193) is built at fixed
width [T*ny, T*ny] with a time mask (rows ti < t neutralized exactly),
batched over the ensemble as one [N, T*ny, T*ny] factorization per step.
For a sparse model the reference stacks per-step EKF linearizations into
an O((ny(T-t))^3) Cholesky (:194-218); here the same Gaussian is
evaluated through the matrix-inversion lemma in n_lin-dimensional
information form, with the model linearized along the whole reference
trajectory for every particle in one batched call [N, T, ny, n_lin], and
the measurement updates are the masked EKF update (visibility mask from
``isfinite(y)``). The sparse path refuses TF32 matmuls on a CUDA device.

Randomness enters through one seam. Per step: the resampling uniforms,
one [N, model.n_noise] standard normal for the dynamics, and one uniform
for the pinned particle's ancestor; per sweep: one uniform for the
trajectory that is kept. They come from ``generator`` or from ``noise =
(u, w, u_anc, u_pick)`` with a leading sweep axis: u [N_K, T-1] (systematic)
or [N_K, T-1, N], w [N_K, T-1, N, n_noise], u_anc [N_K, T-1], u_pick [N_K].

With ``checkpoint_dir`` each sweep ends by saving the kept trajectory, the
outputs so far and the generator's state (``utils/checkpoint.py``); a call
given a directory that holds checkpoints resumes after the latest one, and
its result equals an unbroken run's bit for bit. As in the JAX package,
``run_rbps`` takes no device mesh; the information-form smoother does
(engines/rbps_info.py).
"""

from __future__ import annotations

import math
import warnings
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..math.linalg import (
    gaussian_logpdf_chol,
    half_logdet,
    logsumexp_normalize,
    psd_cholesky,
    tril_solve,
)
from ..models.base import SparseModel
from ..ops.kalman import (
    kalman_update_dense_batched,
    kalman_update_masked_batched,
)
from ..ops.resampling import _SCHEMES, resample_indices, sample_categorical
from ..utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
from ..utils.profiling import phase_annotation, spanned
from .rbpf import (
    _DTYPES,
    Ensemble,
    _as,
    _broadcast_time,
    _check_noise,
    _dynamics_batch,
    _init_linear,
    _jacobian_batch,
    reconstruct_trajectories,
    refuse_tf32,
)

_LOG2PI = math.log(2.0 * math.pi)


class RBPSConfig(NamedTuple):
    n_particles: int
    n_sweeps: int
    resampling: str = "multinomial"
    jitter: float = 1e-2              # src/particleSmoother.m:70
    joseph: bool = False
    cov_dtype: str = "float32"        # bf16 covariance carry
    symmetrize_cov: bool = True       # see RBPFConfig.symmetrize_cov
    # info-form ancestor weights: "woodbury" maintains
    # W = (Imat+ImatAdd)^-1 and its log-det via exact rank-ny
    # updates/downdates (O(nl^2 ny) per particle-step, no factorization
    # in the loop); "cholesky" factorizes Imat+ImatAdd per particle per
    # step (the reference's structure, O(nl^3))
    ancestor_form: str = "woodbury"
    # precompute the suffix information pairs for all t as one reverse
    # cumulative sum per sweep ([T, nl, nl] memory on the cholesky form);
    # False carries and downdates them instead (:194-201)
    suffix_precompute: bool = True


class RBPSResult(NamedTuple):
    XNK: torch.Tensor   # [N_K, T, n_nonlin] sampled trajectories
    XLK: torch.Tensor   # [N_K, n_lin] sampled map means
    PK: torch.Tensor    # [N_K, n_lin, n_lin] sampled map covariances
    ess: torch.Tensor   # [N_K, T]
    chol_retries: torch.Tensor  # [N_K]
    ancestors: torch.Tensor     # [N_K, T-1, N_P] int32, as sampled per sweep
    kept: torch.Tensor          # [N_K] index of the trajectory kept per sweep


class SweepDraws(NamedTuple):
    """The random draws of one sweep: ``step(i)`` -> (u_res, w_dyn, u_anc)
    for transition i -> i+1, ``pick()`` -> the uniform that selects the
    kept trajectory (called once, after the last step). ``tables``, where
    the draws are injected: the sweep's (u, w, u_anc) with the transition
    on the first axis, for a step that indexes it on the device."""

    step: Callable
    pick: Callable
    tables: Optional[tuple] = None


class SweepOut(NamedTuple):
    xnk: torch.Tensor       # [T, n_nonlin] kept trajectory
    xlk: torch.Tensor       # [n_lin]
    Pk: torch.Tensor        # [n_lin, n_lin] float32
    ess: torch.Tensor       # [T]
    retries: torch.Tensor   # scalar
    ancestors: torch.Tensor  # [T-1, N_P] int32
    kept: torch.Tensor      # scalar int64


def _euclidean_residual(xn_ref, xn, u, dt, Q):
    """Default whitened dynamics residual (src/particleSmoother.m:175-180);
    xn [..., dn]."""
    L = torch.linalg.cholesky_ex(dt * Q)[0]     # no host-side error check
    e = xn_ref - xn - u[: xn.shape[-1]]
    return tril_solve(L, e[..., None])[..., 0]


def _dyn_log_weights(model, xnk_t, xn, u, dt_t, Q_t):
    """-0.5 ||e_dyn||^2 per particle (:175-182), the residual evaluated on
    the whole ensemble xn [N, dn] at once."""
    res = model.dyn_residual or _euclidean_residual
    e = res(xnk_t, xn, u, dt_t, Q_t)
    return -0.5 * torch.sum(e * e, dim=-1)


def _dense_future_log_weights(C_stack, y_stack, t_idx, xl, P, R, T, ny,
                              jitter):
    """log N(y_{t:T}; C xl, C P C' + I⊗R) at fixed width with a time mask,
    for the whole ensemble.

    C_stack [T*ny, n_lin] Jacobians along the reference; y_stack [T*ny];
    xl [N, n_lin]; P [N, n_lin, n_lin]. Rows with ti < t are neutralized
    (zero row, unit diagonal, zero innovation), exactly equivalent to the
    reference's dynamic slice (src/particleSmoother.m:163-193). Returns
    (logw [N], retried [N]).
    """
    f32 = torch.float32
    step_ids = torch.arange(T, device=C_stack.device).repeat_interleave(ny)
    rmask = (step_ids >= t_idx).to(C_stack.dtype)            # [T*ny]
    Cm = C_stack * rmask[:, None]
    R_blk = torch.kron(torch.eye(T, dtype=C_stack.dtype,
                                 device=C_stack.device), R)
    outer = rmask[:, None] * rmask[None, :]
    CP = torch.einsum("ai,pij->paj", Cm, P.to(f32))
    S = torch.einsum("paj,bj->pab", CP, Cm) + R_blk * outer \
        + torch.diag(1.0 - rmask)
    e = (y_stack[None, :] - xl.to(f32) @ Cm.T) * rmask[None, :]
    L, retried = psd_cholesky(S, jitter)
    return gaussian_logpdf_chol(e, L, n_obs=torch.sum(rmask)), retried


def _sparse_future_log_weights(model, xnk, y, mask, t_idx, xl, P, R,
                               jitter):
    """Future-measurement log-likelihood of a sparse model, information
    form (exact), for the whole ensemble.

    Every particle's map xl [N, n_lin] linearizes the model along the
    whole reference xnk [T, dn] in one batched call (as
    src/particleSmoother.m:194-218 does step by step); with the masked
    sums over ti >= t_idx Lambda = sum H'R^-1H, iota = sum H'R^-1 e,
    se = sum e'R^-1 e,

      log N = -0.5 (se - iota' (P^-1 + Lambda)^-1 iota)
              - 0.5 log|I + P Lambda| - 0.5 sum log|R_ti| - n_obs/2 log 2pi

    through B = I + L_P' Lambda L_P (one n_lin Cholesky of P and one of B
    a particle). y [T, ny] (NaN as 0), mask [T, ny]. Returns
    (logw [N], retried [N]).
    """
    n_p, n_lin = xl.shape
    T = xnk.shape[0]
    r_diag = torch.diagonal(R)
    yhat, H = model.measure(xnk.expand(n_p, -1, -1),
                            xl[:, None, :].expand(-1, T, -1))
    active = (torch.arange(T, device=xl.device) >= t_idx).to(xl.dtype)
    m = mask * active[:, None]                            # [T, ny]
    Hm = H * m[None, :, :, None]                          # [N, T, ny, nl]
    e = (y[None] - yhat) * m[None]                        # [N, T, ny]
    Lam = torch.einsum("ntkj,k,ntki->nji", Hm, 1.0 / r_diag, Hm)
    iota = torch.einsum("ntkj,k,ntk->nj", Hm, 1.0 / r_diag, e)
    se = torch.sum(e * e / r_diag, dim=(1, 2))
    n_obs = torch.sum(m)
    logdetR = torch.sum(m * torch.log(r_diag)[None, :])
    Lp, r1 = psd_cholesky(P, jitter)
    B = torch.eye(n_lin, dtype=xl.dtype, device=xl.device) \
        + Lp.transpose(-1, -2) @ Lam @ Lp
    Lb, r2 = psd_cholesky(B, jitter)
    v = tril_solve(Lb, torch.einsum("nji,nj->ni", Lp, iota))
    quad = se - torch.sum(v * v, dim=-1)
    logw = (-0.5 * quad - half_logdet(Lb) - 0.5 * logdetR
            - 0.5 * n_obs * _LOG2PI)
    return logw, r1 | r2


def _ess(logw_n):
    return torch.exp(-torch.logsumexp(2.0 * logw_n, dim=-1))


def _cpf_as_sweep(model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                  config: RBPSConfig, xnk, is_first: bool,
                  draws: SweepDraws, mask=None) -> SweepOut:
    """One conditional-particle-filter sweep over tensors already on the
    run's device; Q [T-1, nw, nw], dt [T-1]; xnk [T, n_nonlin] the
    reference trajectory (ignored if ``is_first``); mask [T, ny] the
    visibility of a sparse model's observations. Each transition is a
    ``step`` span (``t``) with ``resample``, ``ancestor`` (conditioned
    sweeps; ``rows`` = (T - t) ny live rows of the future system, ``width``
    = T ny, ``n_lin``, ``n`` the particles), ``dynamics``, ``update`` and
    ``weights`` inside."""
    n_p = config.n_particles
    T, ny = y.shape
    device = y.device
    sparse = isinstance(model, SparseModel)
    xn = x0_nonlin.expand(n_p, -1).clone()
    if not is_first:
        xn[n_p - 1] = xnk[0]                               # pin (:92-96)
    xl0, P0 = _init_linear(x0_lin, P0_lin, n_p, device)
    P0 = P0.to(_DTYPES[config.cov_dtype]).expand((n_p,) + P0.shape)

    if not is_first and not sparse:
        C_ref = _jacobian_batch(model, xnk)     # [T, ny, n_lin] (:119-121)
        C_stack = C_ref.reshape(T * ny, C_ref.shape[-1])
        y_stack = y.reshape(T * ny)

    def update(t, xn, xl, P):
        if sparse:
            yhat, H = model.measure(xn, xl)
            return kalman_update_masked_batched(yhat, H, P, xl, y[t], R,
                                                mask[t], config.jitter)
        return kalman_update_dense_batched(
            _jacobian_batch(model, xn), P, xl, y[t], R, config.jitter,
            config.joseph, config.symmetrize_cov)

    def future_log_weights(t, xl, P):
        if sparse:
            return _sparse_future_log_weights(model, xnk, y, mask, t, xl, P,
                                              R, config.jitter)
        return _dense_future_log_weights(C_stack, y_stack, t, xl, P, R, T,
                                         ny, config.jitter)

    # --- t = 0: importance weights + KF update only ---
    xl, P, logw1, retried0 = update(0, xn, xl0, P0)
    retries = retried0.sum()
    _, logw_n, _ = logsumexp_normalize(logw1)

    xn_hist = torch.empty((T, n_p, xn.shape[-1]), device=device)
    xn_hist[0] = xn
    ancestors = torch.empty((T - 1, n_p), dtype=torch.int32, device=device)
    ess = torch.empty((T,), device=device)
    ess[0] = _ess(logw_n)

    n_lin = xl0.shape[-1]
    for t in range(1, T):
        i = t - 1
        with phase_annotation("step", t=t):
            with phase_annotation("resample"):
                u_res, w_dyn, u_anc = draws.step(i)
                ai = resample_indices(u_res, torch.exp(logw_n), n_p,
                                      config.resampling)
            if not is_first:
                # ancestor sampling for the pinned particle (:159-244)
                with phase_annotation("ancestor", rows=(T - t) * ny,
                                      width=T * ny, n_lin=n_lin, n=n_p):
                    logw_dyn = _dyn_log_weights(model, xnk[t], xn, dx[i],
                                                dt[i], Q[i])
                    logw_meas, retried = future_log_weights(t, xl, P)
                    pa, _, _ = logsumexp_normalize(logw_n + logw_dyn
                                                   + logw_meas)
                    ai[n_p - 1] = sample_categorical(u_anc, pa)
                    retries = retries + retried.sum()
            with phase_annotation("dynamics"):
                xn = _dynamics_batch(model, w_dyn, xn[ai], dx[i], dt[i],
                                     Q[i])
                if not is_first:
                    xn[n_p - 1] = xnk[t]          # keep the reference state
            with phase_annotation("update"):
                xl, P, logw, retried_kf = update(t, xn, xl[ai], P[ai])
            with phase_annotation("weights"):
                _, logw_n, _ = logsumexp_normalize(logw)
                retries = retries + retried_kf.sum()
                xn_hist[t] = xn
                ancestors[i] = ai
                ess[t] = _ess(logw_n)

    return _finish_sweep(xn_hist, ancestors, logw_n, xl, P, ess, retries,
                         draws)


def _finish_sweep(xn_hist, ancestors, logw_f, xl_f, P_f, ess, retries,
                  draws: SweepDraws, ens: Optional[Ensemble] = None,
                  retries_shared=0) -> SweepOut:
    """Rebuild the trajectories and sample the one that is kept, with its
    map (:346-354). ``logw_f`` is the whole ensemble's final normalized
    log-weight vector; with a sharded ``ens`` the other per-particle
    arguments are the rank's block, ``retries`` its particles' count and
    ``retries_shared`` the count of the factorizations every rank did
    alike."""
    if ens is None:
        ens = Ensemble(logw_f.shape[0])
    xn_traj = reconstruct_trajectories(ens.whole(xn_hist, 1),
                                       ens.whole(ancestors, 1))
    ak = sample_categorical(draws.pick(), torch.exp(logw_f)).reshape(1)
    return SweepOut(
        xnk=xn_traj.index_select(1, ak)[:, 0],
        xlk=ens.row(xl_f, ak[0]),
        Pk=ens.whole_rows(ens.row(P_f, ak[0]).to(torch.float32), 0),
        ess=ess, retries=ens.sum(retries) + retries_shared,
        ancestors=ancestors, kept=ak[0],
    )


def _check_supported(model, config: RBPSConfig) -> None:
    if isinstance(model, SparseModel) and config.cov_dtype != "float32":
        raise ValueError("sparse models carry the covariance in float32")
    if config.resampling not in _SCHEMES:
        raise ValueError(f"unknown resampling scheme {config.resampling!r}; "
                         f"options: {sorted(_SCHEMES)}")
    if config.cov_dtype not in _DTYPES:
        raise ValueError(f"cov_dtype must be one of {sorted(_DTYPES)}")
    if config.ancestor_form not in ("woodbury", "cholesky"):
        raise ValueError(
            f"unknown ancestor_form {config.ancestor_form!r}: expected "
            "'woodbury' or 'cholesky'"
        )


def _sweeps_like(device, with_generator: bool) -> dict:
    """The structure of a sweep checkpoint, with each leaf's dtype and
    device (values and shapes are not read)."""
    def empty(dtype):
        return torch.empty(0, dtype=dtype, device=device)

    f32 = torch.float32
    like = {"xnk": empty(f32), "sweeps": SweepOut(
        xnk=empty(f32), xlk=empty(f32), Pk=empty(f32), ess=empty(f32),
        retries=empty(torch.int64), ancestors=empty(torch.int32),
        kept=empty(torch.int64))}
    if with_generator:
        like["generator"] = torch.empty(0, dtype=torch.uint8)
    return like


@spanned("rbps")
def _run_sweeps(sweep_fn, model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                config: RBPSConfig, generator, device, noise,
                checkpoint_dir: Optional[str], mesh=None) -> RBPSResult:
    """Shared sweep loop: moves the inputs to ``device`` once, then runs
    ``config.n_sweeps`` sweeps, each conditioned on the trajectory the
    previous one kept. With ``checkpoint_dir``, each sweep k saves
    ckpt_{k+1}: the kept trajectory, every output so far (the port's
    ``ancestors`` and ``kept`` included) and, with a generator, its state
    (uint8; 16 bytes for a CUDA generator); a call that finds checkpoints
    there starts at min(latest step, n_sweeps) (rbslam_tpu/engines/
    rbps.py:325-390), restoring the generator, or at ``noise[start]``.

    With a ``mesh`` (the sweep function's) the outputs are whole on every
    rank but ``ancestors``, a rank's columns: the checkpoint holds all of
    them (one all-gather over ``particles`` a sweep), the rank at mesh
    coordinates (0, 0) writes it, and the ranks meet at a barrier before
    the next sweep. On resume every rank reads the same file, keeps its
    own columns and restores the same generator state (every rank draws
    the global tensors)."""
    if mesh is None:
        ens, writer = Ensemble(config.n_particles), True
    else:
        from ..parallel.sharded import ShardedEnsemble

        # the particles and the map rows divide over the mesh, or ValueError
        ens = ShardedEnsemble(config.n_particles, mesh, model.n_lin)
        writer = ens.ax.part_rank == 0 and ens.ax.map_rank == 0
    device = torch.device(device)
    y = torch.nan_to_num(_as(y, device))
    T = y.shape[0]
    dx = _as(dx, device)
    Q, dt = _broadcast_time(Q, dt, T, device)
    R = _as(R, device)
    x0_nonlin = _as(x0_nonlin, device)
    n_p, n_noise = config.n_particles, model.n_noise
    u_shape = () if config.resampling == "systematic" else (n_p,)
    if noise is None and generator is None:
        raise ValueError("give a torch.Generator or injected noise")
    if noise is not None:
        noise = tuple(_as(a, device) for a in noise)
        if len(noise) != 4 or any(a.shape[0] != config.n_sweeps
                                  for a in noise):
            raise ValueError(
                "smoother noise is (u, w, u_anc, u_pick), each with a "
                f"leading axis of n_sweeps={config.n_sweeps}"
            )
        _check_noise([a[0] for a in noise], T, n_p, n_noise,
                     config.resampling, extra=((T - 1,), ()))

    def draws_of(k: int) -> SweepDraws:
        if noise is not None:
            u, w, u_anc, u_pick = (a[k] for a in noise)
            return SweepDraws(step=lambda i: (u[i], w[i], u_anc[i]),
                              pick=lambda: u_pick, tables=(u, w, u_anc))

        def step(i):
            return (
                torch.rand(u_shape, generator=generator, device=device),
                torch.randn((n_p, n_noise), generator=generator,
                            device=device),
                torch.rand((), generator=generator, device=device),
            )

        return SweepDraws(
            step=step,
            pick=lambda: torch.rand((), generator=generator, device=device),
        )

    def stacked(outs):
        return SweepOut(*(torch.stack([getattr(o, f) for o in outs])
                          for f in SweepOut._fields))

    xnk = torch.zeros((T, model.n_nonlin), device=device)
    outs, saved = [], []     # saved: the outputs with every rank's ancestors
    start_k = 0
    if checkpoint_dir is not None:
        step = latest_step(checkpoint_dir)
        if step is not None and step > 0:
            st = load_checkpoint(checkpoint_dir, step,
                                 _sweeps_like(device, noise is None))
            if noise is None:
                generator.set_state(st["generator"])
            xnk = st["xnk"]
            saved = [SweepOut(*(v[k] for v in st["sweeps"]))
                     for k in range(step)]
            outs = [o._replace(ancestors=ens.local(o.ancestors, 1))
                    for o in saved]
            start_k = min(step, config.n_sweeps)

    for k in range(start_k, config.n_sweeps):
        with phase_annotation("sweep", k=k):
            out = sweep_fn(model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
                           config, xnk, k == 0, draws_of(k))
        xnk = out.xnk
        outs.append(out)
        if checkpoint_dir is None:
            continue
        with phase_annotation("checkpoint", k=k):
            saved.append(out._replace(ancestors=ens.whole(out.ancestors, 1)))
            tree = {"xnk": xnk, "sweeps": stacked(saved)}
            if noise is None:
                tree["generator"] = generator.get_state()
            if writer:
                save_checkpoint(checkpoint_dir, k + 1, tree)
            if mesh is not None:
                # (p, m) waits for (0, m), which waited for (0, 0)
                torch.distributed.barrier(group=ens.ax.map_group)
                torch.distributed.barrier(group=ens.ax.part_group)
    res = stacked(outs)
    return RBPSResult(XNK=res.xnk, XLK=res.xlk, PK=res.Pk, ess=res.ess,
                      chol_retries=res.retries, ancestors=res.ancestors,
                      kept=res.kept)


def run_rbps(model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
             config: RBPSConfig, *, generator: Optional[torch.Generator],
             device, noise=None, mask=None,
             checkpoint_dir: Optional[str] = None) -> RBPSResult:
    """Run N_K CPF-AS sweeps on ``device`` (src/particleSmoother.m:88).

    dx [T-1, n_u]; y [T, ny] (NaN becomes 0); Q [nw, nw] or [T-1, nw, nw];
    dt scalar or [T-1]. A sparse model masks its updates and future
    weights with ``mask`` [T, ny] (1 = observed), by default
    ``isfinite(y)``; for a dense model ``mask`` is ignored, as in the
    reference package. See the module docstring for ``generator`` and
    ``noise``.

    COST WARNING: the naive ancestor weights factorize the full
    fixed-width [T*ny, T*ny] masked stacked system per particle per step,
    O(N_K N_T N_P (T ny)^3) in total, the cost the information form exists
    to remove (src/particleSmoother.m:221-229). Beyond small T (e.g. the
    dense-mag T=192, ny=3 config) use
    :func:`rbslam_tpu_torch.engines.rbps_info.run_rbps_information_form`.
    """
    _check_supported(model, config)
    if isinstance(model, SparseModel):
        refuse_tf32(device, "the sparse (masked EKF) smoother")
        y = _as(y, device)
        mask = (torch.isfinite(y).to(torch.float32) if mask is None
                else _as(mask, device))
        return _run_sweeps(partial(_cpf_as_sweep, mask=mask), model, dx, y,
                           x0_nonlin, x0_lin, P0_lin, Q, R, dt, config,
                           generator, device, noise, checkpoint_dir)
    n_stack = int(torch.as_tensor(y).shape[0]) * model.ny
    if n_stack > 256:
        warnings.warn(
            f"run_rbps dense ancestor weights factorize a [{n_stack}]^2 "
            "stacked system per particle per step (O((T ny)^3)); use "
            "run_rbps_information_form at this scale",
            stacklevel=2,
        )
    return _run_sweeps(_cpf_as_sweep, model, dx, y, x0_nonlin, x0_lin,
                       P0_lin, Q, R, dt, config, generator, device, noise,
                       checkpoint_dir)
