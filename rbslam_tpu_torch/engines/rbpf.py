"""Rao-Blackwellized particle filter (port of rbslam_tpu/engines/rbpf.py).

Reproduces the semantics of the reference filter (src/particleFilter.m):
per step, (1) resample ancestors from the previous weights and propagate
the nonlinear states (:103-113), (2) per-particle log-weights from the
marginal innovation likelihood (:126-151), (3) log-sum-exp normalize
(:153-156), (4) per-particle Kalman measurement update of the map
(:163-204). Ancestor indices are stored and the trajectories rebuilt
once at the end; ``P_mean`` is the correct weighted accumulation (the
reference assigns inside its loop, :228-230).

Three Kalman-update paths (``RBPFConfig.kf_kernel``) for dense models;
the two kernel paths take ny <= 3, and a model with more observation rows
runs the xla path (with the ny > 3 form of the update) whatever the
config names:

- ``"xla"`` (the JAX package's default): per step, gather P[ai] and run
  the dense small-ny update (ops/kalman.py) in plain torch; the Jacobian
  comes from the basis-gradient kernel K4.
- ``"block_gather"``: per step, the CUDA kernel K5 runs the whole dense
  update with the gather of P fused in (one read and one write of the
  covariance ensemble); Jacobian from K4.
- ``"lowrank"``: the covariance is carried as P = P_base[bidx] - Wt^T Wt;
  per step the kernels build the rows-layout Jacobian (K1) and the
  gathered C P contraction (K2) and ny new factor rows are placed; every
  r steps the base is rebuilt (K3).

Step 0 runs the dense update with the K4 Jacobian on every path. With
``ess_threshold < 1`` a step resamples only where the ESS of the carried
weights is at most ``ess_threshold * N``, which the host reads from the
device once per step; a step that does not resample keeps ai = identity,
skips the state and covariance gathers and accumulates the log-weights.

Sparse models (the pinhole camera of the sparse visual workload) run the
masked EKF update (``ops/kalman.py``) on every step, whatever
``kf_kernel`` names, with the visibility mask from ``isfinite(y)``
(rbslam_tpu/engines/rbpf.py:174-188,388-389). The update's float32
products need full precision (the JAX package forces it after silent NaN
weights on the TPU), so on a CUDA device the sparse path refuses to run
with TF32 matmuls on.

Under a device mesh (``mesh``, parallel/) the xla path runs on each
rank's particles and covariance rows with explicit collectives; see
:func:`run_rbpf` for what a rank's result holds.

Randomness enters through one seam: per step the resampling uniforms
(one ``u0`` for systematic, N for multinomial and stratified) and one
[N, model.n_noise] standard normal for the dynamics, drawn from
``generator`` or taken from ``noise``. Every size comes from the model
(``n_nonlin``, ``n_noise``, ``ny``), so the same loop serves the mag3d,
radio2d and pinhole2d families.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import torch

from ..math.linalg import ess_from_logw, logsumexp_normalize
from ..models.base import SparseModel
from ..ops.kalman import (
    kalman_update_dense_batched,
    kalman_update_masked_batched,
)
from ..ops.resampling import _SCHEMES, resample_indices
from ..utils.profiling import phase_annotation, spanned
from ..kernels.kf_update import (
    kf_rebase,
    kf_update_block_gather,
    kf_update_lowrank,
)


class RBPFConfig(NamedTuple):
    n_particles: int
    resampling: str = "multinomial"
    jitter: float = 1e-3
    joseph: bool = False
    store_trajectories: bool = True
    kf_kernel: str = "xla"
    ess_threshold: float = 1.0
    lowrank_period: int = 8
    cov_dtype: str = "float32"
    allow_bf16_large_nl: bool = False
    dist_resampling: str = "replicated_cdf"
    symmetrize_cov: bool = True


class RBPFResult(NamedTuple):
    traj_max: torch.Tensor          # [T, n_nonlin] max-weight particle per step
    traj_mean: torch.Tensor         # [T, n_nonlin] weighted mean per step
    xl_max: torch.Tensor            # [n_lin] final max-weight map
    xl_mean: torch.Tensor           # [n_lin] final weighted-mean map
    P_max: torch.Tensor             # [n_lin, n_lin]
    P_mean: torch.Tensor            # [n_lin, n_lin] (correct accumulation)
    traj_sample_iwmax: torch.Tensor  # [T, n_nonlin] ancestral path of final best
    xn_traj: torch.Tensor           # [T, N_P, n_nonlin] reconstructed trajectories
    xn_hist: torch.Tensor           # [T, N_P, n_nonlin] raw per-step cloud
    ancestors: torch.Tensor         # [T-1, N_P] int32
    logw: torch.Tensor              # [N_P] final normalized log-weights
    xn: torch.Tensor                # [N_P, n_nonlin] final particles
    xl: torch.Tensor                # [N_P, n_lin] final maps
    P: torch.Tensor                 # [N_P, n_lin, n_lin] final covariances
    ess: torch.Tensor               # [T] effective sample size per step
    log_evidence: torch.Tensor      # scalar: sum_t log(1/N sum w~)
    chol_retries: torch.Tensor      # scalar: total jitter-retry count


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reconstruct_trajectories(xn_hist, ancestors):
    """Rebuild per-particle ancestral trajectories.

    xn_hist [T, N_P, dn]; ancestors [T-1, N_P] (ancestors[t-1, i] = parent
    of particle i at step t). Returns [T, N_P, dn] where column i is the
    full history of final particle i (src/particleFilter.m:117-118).
    """
    T, n_p, _ = xn_hist.shape
    idx = torch.arange(n_p, device=xn_hist.device)
    rows = [idx]
    for t in range(T - 2, -1, -1):
        idx = ancestors[t].long()[idx]
        rows.append(idx)
    idx_full = torch.stack(rows[::-1])                     # [T, N_P]
    return torch.gather(
        xn_hist, 1, idx_full[:, :, None].expand(-1, -1, xn_hist.shape[-1])
    )


def _check_supported(model, config: RBPFConfig, mesh) -> None:
    if config.kf_kernel not in ("xla", "block_gather", "lowrank"):
        raise ValueError(
            f"unknown kf_kernel {config.kf_kernel!r}: expected 'xla', "
            "'block_gather' or 'lowrank'"
        )
    if mesh is not None and config.kf_kernel != "xla":
        raise ValueError(
            "the KF kernel paths are single-device; use kf_kernel='xla' "
            "with mesh"
        )
    if config.dist_resampling not in ("replicated_cdf", "prefix", "local"):
        raise ValueError(
            f"unknown dist_resampling {config.dist_resampling!r}: expected "
            "'replicated_cdf', 'prefix' or 'local'")
    if config.resampling not in _SCHEMES:
        raise ValueError(f"unknown resampling scheme {config.resampling!r}; "
                         f"options: {sorted(_SCHEMES)}")
    if config.cov_dtype not in _DTYPES:
        raise ValueError(f"cov_dtype must be one of {sorted(_DTYPES)}")
    if isinstance(model, SparseModel) and config.cov_dtype != "float32":
        raise ValueError("sparse models carry the covariance in float32")


class Ensemble:
    """The particle axis of a whole ensemble held by one process: the
    reductions, gathers and resampling of the filters and smoothers.
    parallel/sharded.py::ShardedEnsemble runs the same methods on a rank's
    block of particles, with collectives; ``map`` is then the map axis of
    the [nl, nl] matrices (parallel/map_axis.py), here None (whole rows).
    """

    map = None
    map_rows = slice(None)   # this process's rows of the [nl, nl] matrices

    def __init__(self, n_particles: int):
        self.n = self.n_local = n_particles
        self.start = 0

    def local(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This process's particles of a global tensor (along ``axis``)."""
        return x

    def whole(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The global tensor from every process's particles."""
        return x

    def whole_rows(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every map row block of ``x`` concatenated along ``axis``."""
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Complete a sum over particles."""
        return x

    def normalize(self, logw: torch.Tensor):
        """Log-sum-exp normalization over the ensemble: (w, logw_n, logZ)
        of this process's particles and the whole normalized vector."""
        w, logw_n, logz = logsumexp_normalize(logw)
        return w, logw_n, logz, logw_n

    def take(self, x: torch.Tensor, ai: torch.Tensor) -> torch.Tensor:
        """Rows of the ancestors ``ai`` (global indices) of this process's
        children."""
        return x[ai]

    def rows_at(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows of the global particles ``idx`` (1-D), on every process,
        without a host read."""
        return x.index_select(0, idx)

    def row(self, x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Row of global particle ``i`` (0-d tensor)."""
        return self.rows_at(x, i.reshape(1))[0]

    def top_and_mean(self, x, w, logw_all):
        """x of the particle with the largest weight (the first such) and
        the weighted mean of x."""
        return _row_at_max(x, logw_all), torch.sum(x * w[:, None], dim=0)

    def u_shape(self, scheme: str) -> tuple:
        """Shape of one step's resampling uniforms (global)."""
        return () if scheme == "systematic" else (self.n,)

    def resample(self, u, w, scheme: str):
        """Ancestors (int32, global) of this process's children and the
        log-weights they restart from (None: the uniform -log N)."""
        return resample_indices(u, w, self.n, scheme).to(torch.int32), None


def refuse_tf32(device, what: str) -> None:
    """Raise on a CUDA device while TF32 matmuls are on: ``what`` needs full
    float32 products."""
    if torch.device(device).type == "cuda" \
            and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"torch.backends.cuda.matmul.allow_tf32 is on: {what} needs "
            "full float32 matmuls")


def _as(x, device, dtype=torch.float32):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _pad_last(x, n):
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _broadcast_time(Q, dt, T, device):
    """Q [nw, nw] or [T-1, nw, nw] and dt scalar or [T-1] as float32
    tensors on ``device`` with a leading time axis (views, no copies)."""
    Q = _as(Q, device)
    if Q.dim() == 2:
        Q = Q.expand((T - 1,) + Q.shape)
    dt = _as(dt, device)
    if dt.dim() == 0:
        dt = dt.expand(T - 1)
    return Q, dt


def _init_linear(x0_lin, P0_lin, n_particles, device):
    """The ensemble's initial map: x0_lin [n_lin] broadcast, or per-particle
    [N_P, n_lin] as given; P0_lin [n_lin, n_lin] (not yet expanded)."""
    x0_lin = _as(x0_lin, device)
    xl = x0_lin.expand(n_particles, -1) if x0_lin.dim() == 1 else x0_lin
    return xl, _as(P0_lin, device)


def _jacobian_batch(model, xn):
    """Whole-ensemble measurement Jacobian [N, ny, n_lin]: the model's
    fused-kernel hook when it has one, else the per-particle Jacobian
    stacked."""
    if model.meas_jacobian_batch is not None:
        return model.meas_jacobian_batch(xn)
    return torch.stack([model.meas_jacobian(x) for x in xn])


def _dynamics_batch(model, w, xn, u, dt, Q):
    """Whole-ensemble transition from w [N, n_noise] standard normals."""
    if model.dynamics_batch is not None:
        return model.dynamics_batch(w, xn, u, dt, Q)
    return torch.stack([model.dynamics(w[i], xn[i], u, dt, Q)
                        for i in range(xn.shape[0])])


def _check_noise(noise, T, n_p, n_noise, resampling, extra=(),
                 u_shape=None):
    """Shapes of injected draws: u [T-1] (systematic) or [T-1, N] (or
    [T-1, *u_shape]), w [T-1, N, n_noise], then ``extra`` shapes for any
    further entries."""
    if u_shape is None:
        u_shape = () if resampling == "systematic" else (n_p,)
    want = [(T - 1,) + u_shape, (T - 1, n_p, n_noise), *extra]
    got = [tuple(a.shape) for a in noise]
    if got != want:
        raise ValueError(
            f"injected noise has shapes {got}, expected {want} for "
            f"{resampling} resampling")


@spanned("rbpf")
def run_rbpf(model, dx, y, x0_nonlin, x0_lin, P0_lin, Q, R, dt,
             config: RBPFConfig, *, generator: Optional[torch.Generator],
             device, noise=None, mask=None, mesh=None) -> RBPFResult:
    """Run the RBPF on ``device``.

    dx [T-1, n_u] odometry; y [T, ny] observations; Q [nw, nw] or
    [T-1, nw, nw]; dt scalar or [T-1]. ``generator`` (a torch.Generator
    on ``device``) supplies every random draw unless ``noise = (u, w)`` is
    given: u [T-1] (systematic) or [T-1, N] (multinomial, stratified) the
    resampling uniforms, w [T-1, N, model.n_noise] the dynamics' standard
    normals. On
    a CUDA device every kernel wrapper launches its kernel; on the CPU the
    wrappers run their plain versions.

    The kernel paths (block_gather, lowrank) reject NaN or masked y. On
    the xla path NaN becomes 0 and, for a dense model, the mask is
    ignored, as the JAX package's dense update does. A sparse model masks
    the update with ``mask`` [T, ny] (1 = observed), by default
    ``isfinite(y)``.

    ``mesh`` (parallel.make_mesh: a DeviceMesh with dims ("particles",
    "map")) runs the xla path on this rank's block of N/S_p particles and
    of n_lin/S_map covariance rows, with ``config.dist_resampling``
    (parallel/resampling.py) and explicit collectives, the Joseph form
    included; the kernel paths raise ValueError. Every rank passes the same
    arguments: the same ``noise``, or a generator seeded the same, from
    which it draws the global tensors and keeps its own rows (with
    ``dist_resampling="local"``, u is [T-1, S_p] for systematic: one
    uniform a particle shard). Result on every rank: ``traj_max``,
    ``traj_mean``, ``traj_sample_iwmax``, ``xl_max``, ``xl_mean``,
    ``P_max``, ``P_mean``, ``ess``, ``log_evidence`` and ``chol_retries``
    are those of the whole ensemble, as the unsharded run's; ``xn``,
    ``xl``, ``logw``, the columns of ``ancestors`` (global indices),
    ``xn_hist`` and ``xn_traj`` are the rank's particles, and ``P`` its
    particles' row block [N/S_p, n_lin/S_map, n_lin]
    (parallel.gather_particles collects them).
    """
    _check_supported(model, config, mesh)
    sparse = isinstance(model, SparseModel)
    if sparse:
        refuse_tf32(device, "the sparse (masked EKF) update")
    device = torch.device(device)
    n_p = config.n_particles
    f32 = torch.float32
    y = _as(y, device)
    T = y.shape[0]
    # the kernels take dense models with ny <= 3: any other model runs the
    # xla path whatever kf_kernel says, as in the JAX package
    kernel_model = not sparse and model.ny <= 3
    if config.kf_kernel != "xla" and not kernel_model:
        warnings.warn(
            f"kf_kernel={config.kf_kernel!r} takes dense models with ny <= "
            f"3; this model ({type(model).__name__}, ny={model.ny}) runs "
            "the 'xla' path, which launches none of the Kalman update "
            "kernels",
            stacklevel=3,      # the caller's line, past @spanned's frame
        )
    block_gather = config.kf_kernel == "block_gather" and kernel_model
    # T == 1 has no steps: the lowrank config runs step 0 as the xla path
    lowrank = config.kf_kernel == "lowrank" and kernel_model and T > 1
    if config.kf_kernel != "xla":
        # the kernel paths have no observation-mask support: NaN-masked
        # measurements would enter the update as y=0 observations
        if mask is not None:
            if not bool(torch.all(_as(mask, device) != 0)):
                raise ValueError(
                    "the KF kernel paths do not support masked "
                    "observations; use kf_kernel='xla'"
                )
        elif not bool(torch.all(torch.isfinite(y))):
            raise ValueError(
                "y contains NaN but a KF kernel path is selected; NaN rows "
                "are only masked correctly on kf_kernel='xla'"
            )
    if sparse:
        mask = (torch.isfinite(y).to(f32) if mask is None
                else _as(mask, device))
    y = torch.nan_to_num(y)
    dx = _as(dx, device)
    Q, dt = _broadcast_time(Q, dt, T, device)
    R = _as(R, device)
    dn, n_noise = model.n_nonlin, model.n_noise
    if mesh is None:
        ens = Ensemble(n_p)
    else:
        from ..parallel.sharded import ShardedEnsemble

        ens = ShardedEnsemble(n_p, mesh, model.n_lin,
                              config.dist_resampling)

    def jacobian(xn):
        """The dense Jacobian of xn padded to the map's width (nl_pad); a
        sparse model's comes with its prediction inside the update
        (None)."""
        if sparse:
            return None
        return _pad_last(_jacobian_batch(model, xn), nl_pad)

    def dense_update(t, C, xn, xl, P, symmetrize_out):
        """Step t's measurement update (the xla path): the dense update
        with the Jacobian C, or the masked update of a sparse model.
        Returns (xl', P', logw, retried)."""
        if sparse:
            yhat, H = model.measure(xn, xl)
            return kalman_update_masked_batched(
                yhat, H, P, xl, y[t], R, mask[t], config.jitter, ens.map)
        return kalman_update_dense_batched(
            C, P, xl, y[t], R, config.jitter, config.joseph,
            symmetrize_out=symmetrize_out, axis=ens.map)

    u_shape = ens.u_shape(config.resampling)
    if noise is None and generator is None:
        raise ValueError("give a torch.Generator or injected noise")
    if noise is not None:
        u_all, w_all = (_as(a, device) for a in noise)
        _check_noise((u_all, w_all), T, n_p, n_noise, config.resampling,
                     u_shape=u_shape)

    def draw(t):
        """Step t's uniforms (global) and this process's dynamics normals."""
        if noise is not None:
            return u_all[t], ens.local(w_all[t])
        u = torch.rand(u_shape, generator=generator, device=device)
        w = torch.randn((n_p, n_noise), generator=generator, device=device)
        return u, ens.local(w)

    gated = config.ess_threshold < 1.0

    def resample(u, logw_n, logw_all):
        """(ancestors (int32), restart log-weights) of this step; (None,
        None) where the ESS gate keeps the particles (one device-to-host
        read per step, the same on every rank)."""
        if gated and not bool(ess_from_logw(logw_all)
                               <= config.ess_threshold * n_p):
            return None, None
        return ens.resample(u, torch.exp(logw_n), config.resampling)

    xn0 = ens.local(_as(x0_nonlin, device).expand(n_p, -1)).contiguous()
    xl0, P0_lin = _init_linear(x0_lin, P0_lin, n_p, device)
    xl0 = ens.local(xl0)
    n_lin = xl0.shape[-1]
    cov_dtype = _DTYPES[config.cov_dtype]
    if (not lowrank and cov_dtype == torch.bfloat16 and n_lin > 256
            and not config.allow_bf16_large_nl):
        raise ValueError(
            f"cov_dtype='bfloat16' at n_lin={n_lin} > 256 destabilizes the "
            "per-step filter paths; use float32, kf_kernel='lowrank' (T > "
            "1), or allow_bf16_large_nl=True"
        )
    P0 = P0_lin.to(cov_dtype)
    nl_pad = n_lin
    if block_gather or lowrank:
        # zero-pad the map to a multiple of 128 (zero rows and columns
        # are exact) and slice back at the end
        nl_pad = -(-n_lin // 128) * 128
        xl0 = _pad_last(xl0, nl_pad)
        pad = nl_pad - n_lin
        P0 = torch.nn.functional.pad(P0, (0, pad, 0, pad))
    P0 = P0[ens.map_rows]
    P0 = P0.expand((ens.n_local,) + P0.shape)

    # --- step t = 0: no prediction (src/particleFilter.m:103) ---
    with phase_annotation("step0", memory_of=device):
        xl, P, logw1, retried0 = dense_update(
            0, jacobian(xn0), xn0, xl0, P0,
            block_gather or lowrank or config.symmetrize_cov)
        del P0
        retries = retried0.sum()
        w1, logw1n, logz0, logw1_all = ens.normalize(logw1)
    logw_n, logw_all = logw1n, logw1_all
    log_np = math.log(n_p)

    n_steps = T - 1
    n_loc = ens.n_local
    ar = torch.arange(ens.start, ens.start + n_loc, dtype=torch.int32,
                      device=device)
    ancestors = torch.empty((n_steps, n_loc), dtype=torch.int32,
                            device=device)
    traj_max_t = torch.empty((n_steps, dn), device=device)
    traj_mean_t = torch.empty((n_steps, dn), device=device)
    ess_t = torch.empty((n_steps,), device=device)
    logz_t = torch.empty((n_steps,), device=device)
    xn_hist = (torch.empty((T, n_loc, dn), device=device)
               if config.store_trajectories else None)
    if xn_hist is not None:
        xn_hist[0] = xn0
    xn = xn0

    def record(t, ai, logw_prev, logw, logw_n):
        """Weights and per-step outputs of step t; returns the normalized
        log-weights, this process's and the whole vector. A step that
        resampled to the uniform reset (logw_prev None: -log N) takes its
        update's logw as the new weight as it stands; one that did not
        carries logw_n, and the island resampler log W_o - log n_local."""
        if ai is not None:
            ancestors[t] = ai
        else:
            ancestors[t] = ar
            logw_prev = logw_n
        if logw_prev is not None:
            logw = logw_prev + log_np + logw
        w_new, logw_n, logz, logw_all = ens.normalize(logw)
        traj_max_t[t], traj_mean_t[t] = ens.top_and_mean(xn, w_new, logw_all)
        ess_t[t] = ess_from_logw(logw_all)
        logz_t[t] = logz - log_np
        if xn_hist is not None:
            xn_hist[t + 1] = xn
        return logw_n, logw_all

    with phase_annotation("loop", memory_of=device):
        if lowrank:
            # --- low-rank factored covariance loop --------------------
            ny = model.ny
            r = config.lowrank_period
            P_base = P
            t = 0
            while t < n_steps:
                length = min(r, n_steps - t)
                Wt = torch.zeros((n_p, ny * length, nl_pad),
                                 dtype=cov_dtype, device=device)
                bidx = ar
                for phase in range(length):
                    with phase_annotation("step", t=t + 1):
                        with phase_annotation("resample"):
                            u, w_dyn = draw(t)
                            ai, logw_prev = resample(u, logw_n, logw_all)
                            xn_a, xl_a = xn, xl
                            if ai is not None:
                                xn_a, xl_a = xn[ai], xl[ai]
                                bidx = bidx[ai]
                                Wt = Wt[ai]
                        with phase_annotation("dynamics"):
                            xn = _dynamics_batch(model, w_dyn, xn_a, dx[t],
                                                 dt[t], Q[t])
                        with phase_annotation("jacobian"):
                            if model.meas_jacobian_batch_rows is not None:
                                C = model.meas_jacobian_batch_rows(
                                    xn, nl_pad, cov_dtype)
                            else:
                                C = jacobian(xn).to(cov_dtype)
                        with phase_annotation("update"):
                            # the rows of later phases are still zero: K2
                            # skips them
                            xl, wnew, logw, bad = kf_update_lowrank(
                                bidx, C, xl_a, Wt, P_base, y[t + 1], R,
                                config.jitter, live_rows=ny * phase,
                            )
                            # this phase's factor rows are still zero
                            # (gathers permute particles, not rows): write
                            # the new rows in place
                            Wt[:, ny * phase:ny * phase + ny] = wnew
                            retries = retries + bad.sum()
                        with phase_annotation("weights"):
                            logw_n, logw_all = record(t, ai, logw_prev, logw,
                                                      logw_n)
                    t += 1
                with phase_annotation("rebase", t=t):
                    P_base = kf_rebase(bidx, Wt, P_base)
            P = P_base
        else:
            # --- dense per-step loop: xla or block_gather ---------------
            for t in range(n_steps):
                with phase_annotation("step", t=t + 1):
                    with phase_annotation("resample"):
                        u, w_dyn = draw(t)
                        ai, logw_prev = resample(u, logw_n, logw_all)
                        xn_a, xl_a = ((xn, xl) if ai is None
                                      else (ens.take(xn, ai),
                                            ens.take(xl, ai)))
                        if ai is not None and not block_gather:
                            P = ens.take(P, ai)   # K5 gathers P itself
                    with phase_annotation("dynamics"):
                        xn = _dynamics_batch(model, w_dyn, xn_a, dx[t],
                                             dt[t], Q[t])
                    with phase_annotation("jacobian"):
                        C = jacobian(xn)
                    with phase_annotation("update"):
                        if block_gather:
                            xl, P, logw, bad = kf_update_block_gather(
                                ar if ai is None else ai, C, xl_a, P,
                                y[t + 1], R, config.jitter,
                            )
                        else:
                            xl, P, logw, bad = dense_update(
                                t + 1, C, xn, xl_a, P,
                                config.symmetrize_cov)
                        retries = retries + bad.sum()
                    with phase_annotation("weights"):
                        logw_n, logw_all = record(t, ai, logw_prev, logw,
                                                  logw_n)

    with phase_annotation("finish", memory_of=device):
        # prepend step-0 outputs
        top0, mean0 = ens.top_and_mean(xn0, w1, logw1_all)
        traj_max = torch.cat([top0[None], traj_max_t])
        traj_mean = torch.cat([mean0[None], traj_mean_t])
        ess = torch.cat([ess_from_logw(logw1_all)[None], ess_t])
        log_evidence = (logz0 - log_np) + torch.sum(logz_t)

        iw_max = torch.argmax(logw_all)
        if xn_hist is not None:
            xn_traj = reconstruct_trajectories(ens.whole(xn_hist, 1),
                                               ens.whole(ancestors, 1))
            traj_sample_iwmax = xn_traj.index_select(
                1, iw_max.reshape(1))[:, 0]
            xn_traj = ens.local(xn_traj, 1)
        else:
            xn_hist = torch.zeros((0,), device=device)
            xn_traj = traj_sample_iwmax = torch.zeros((0,), device=device)

        xl_f = xl[..., :n_lin]
        P_f = P[..., :n_lin]
        if nl_pad != n_lin:
            P_f = P_f[:, :n_lin]
        if config.store_trajectories:
            P_f = P_f.to(f32)
        w_f = torch.exp(logw_n)
        xl_mean = ens.sum(torch.sum(xl_f * w_f[:, None], dim=0))
        dev = xl_mean[None, :] - xl_f
        P_mean = ens.whole_rows(
            ens.sum(_weighted_sum(w_f.to(P_f.dtype), P_f))
            + ens.sum(torch.einsum("p,pi,pj->ij", w_f, dev[:, ens.map_rows],
                                   dev)),
            0)
        return RBPFResult(
            traj_max=traj_max,
            traj_mean=traj_mean,
            xl_max=ens.row(xl_f, iw_max),
            xl_mean=xl_mean,
            P_max=ens.whole_rows(ens.row(P_f, iw_max).to(f32), 0),
            P_mean=P_mean,
            traj_sample_iwmax=traj_sample_iwmax,
            xn_traj=xn_traj,
            xn_hist=xn_hist,
            ancestors=ancestors,
            logw=logw_n,
            xn=xn,
            xl=xl_f,
            P=P_f,
            ess=ess,
            log_evidence=log_evidence,
            chol_retries=ens.sum(retries),
        )


def _row_at_max(x, logw):
    """x[argmax(logw)], gathered on the device: indexing by a 0-d tensor
    would read the index on the host (a device sync)."""
    return x.index_select(0, torch.argmax(logw).reshape(1))[0]


def _weighted_sum(w, P, chunk_bytes: int = 1 << 28):
    """sum_p w[p] P[p] accumulated in float32, chunked over particles so a
    float32 copy of a bf16 ensemble is never materialized whole."""
    n = P.shape[0]
    per = max(1, chunk_bytes // (P[0].numel() * 4))
    acc = torch.zeros(P.shape[1:], dtype=torch.float32, device=P.device)
    for s in range(0, n, per):
        acc += torch.einsum("p,pij->ij", w[s:s + per].float(),
                            P[s:s + per].float())
    return acc
