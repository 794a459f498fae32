"""Plain (non-Rao-Blackwellized) particle filter for terrain-matching
localization on a fixed map (port of rbslam_tpu/engines/pf.py;
examples/mag-localization-mapping/particleFilterLocalization.m: resample +
propagate :91-95, vectorized weights :110, normalize + store
trajectories :118-131).

Log-domain weights throughout, configurable resampling, and trajectories
rebuilt from the stored ancestor indices. The per-particle state is 7
floats with no covariance, so this is the engine that scales to millions
of particles.

The ESS gate (``ess_threshold < 1``) never reads the device from the
host: every step draws its resampling uniforms and computes the indices,
and ``torch.where`` keeps the identity where the ESS is above the
threshold. The draws are those of the JAX package's ``lax.cond`` either
way, so the results are the same, and a step makes no host-device sync.

Randomness enters through one seam: per step the resampling uniforms
(one for systematic, N for multinomial and stratified) and one
[N, n_noise] standard normal for the dynamics, drawn from ``generator``
or taken from ``noise = (u, w)``: u [T-1] or [T-1, N], w [T-1, N,
n_noise]. The terrain models take n_noise = 6, the position draws then
the orientation draws.

The log evidence sums log sum_i W_i p(y_t | x_t^i) over the steps, W the
weights each step starts from: -log N each after a resampling, the
carried normalized weights otherwise. (The JAX package subtracts log N
once more a step.)

Phase spans (``utils.profiling``): ``pf`` > ``step0``, ``loop`` >
``step`` (``t``) > ``resample``, ``dynamics``, ``weights``; then
``finish``. The exact terrain model's weight adds its own spans inside
``weights`` (models/terrain.py).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..math.linalg import ess_from_logw, logsumexp_normalize
from ..ops.resampling import _SCHEMES, resample_indices
from ..utils.profiling import phase_annotation, spanned
from .rbpf import (
    _as,
    _broadcast_time,
    _check_noise,
    _row_at_max,
    reconstruct_trajectories,
)


class PFConfig(NamedTuple):
    n_particles: int
    resampling: str = "multinomial"
    store_trajectories: bool = False
    # resample only when ESS <= ess_threshold * N, accumulating the
    # log-weights in between; 1.0 resamples every step as the reference
    # (particleFilterLocalization.m:91-95)
    ess_threshold: float = 0.5


class PFResult(NamedTuple):
    traj_max: torch.Tensor      # [T, dn]
    traj_mean: torch.Tensor     # [T, dn]
    xn: torch.Tensor            # [N_P, dn] final particles
    logw: torch.Tensor          # [N_P] final normalized log-weights
    ess: torch.Tensor           # [T]
    log_evidence: torch.Tensor  # scalar
    xn_traj: torch.Tensor       # [T, N_P, dn] if store_trajectories else [0]
    xn_hist: torch.Tensor       # [T, N_P, dn] raw per-step cloud (same flag)
    ancestors: torch.Tensor     # [T-1, N_P] int32


@spanned("pf")
def run_pf_localization(dynamics: Callable, log_weight: Callable, dx, y,
                        x0_nonlin, Q, dt, config: PFConfig, *, n_noise: int,
                        generator: Optional[torch.Generator], device,
                        noise=None) -> PFResult:
    """Run the PF on ``device``.

    dynamics (w [N, n_noise], xn [N, dn], u, dt, Q) -> xn' [N, dn];
    log_weight (y_t, xn [N, dn]) -> [N]; dx [T-1, n_u]; y [T, ny];
    x0_nonlin [dn] (every particle starts there) or [N, dn] (a spread
    initial cloud, run_localization.m:156-161); Q [nw, nw] or
    [T-1, nw, nw]; dt scalar or [T-1]. See the module docstring for
    ``generator`` and ``noise``.
    """
    if config.resampling not in _SCHEMES:
        raise ValueError(f"unknown resampling scheme {config.resampling!r}; "
                         f"options: {sorted(_SCHEMES)}")
    device = torch.device(device)
    n_p = config.n_particles
    y = _as(y, device)
    T = y.shape[0]
    dx = _as(dx, device)
    Q, dt = _broadcast_time(Q, dt, T, device)
    u_shape = () if config.resampling == "systematic" else (n_p,)
    if noise is None and generator is None:
        raise ValueError("give a torch.Generator or injected noise")
    if noise is not None:
        u_all, w_all = (_as(a, device) for a in noise)
        _check_noise((u_all, w_all), T, n_p, n_noise, config.resampling)

    def draw(t):
        if noise is not None:
            return u_all[t], w_all[t]
        return (torch.rand(u_shape, generator=generator, device=device),
                torch.randn((n_p, n_noise), generator=generator,
                            device=device))

    x0 = _as(x0_nonlin, device)
    xn0 = x0.expand(n_p, -1) if x0.dim() == 1 else x0
    dn = xn0.shape[-1]
    log_np = math.log(n_p)
    gated = config.ess_threshold < 1.0
    ident = torch.arange(n_p, device=device)
    uniform = torch.full((n_p,), -log_np, device=device)

    n_steps = T - 1
    ancestors = torch.empty((n_steps, n_p), dtype=torch.int32, device=device)
    traj_max = torch.empty((T, dn), device=device)
    traj_mean = torch.empty((T, dn), device=device)
    ess = torch.empty((T,), device=device)
    logz_t = torch.empty((n_steps,), device=device)
    xn_hist = (torch.empty((T, n_p, dn), device=device)
               if config.store_trajectories else None)

    def record(t, xn, w, logw_n):
        """Step t's estimates of the cloud xn under its normalized
        weights."""
        traj_max[t] = _row_at_max(xn, logw_n)
        traj_mean[t] = torch.sum(xn * w[:, None], dim=0)
        ess[t] = ess_from_logw(logw_n)
        if xn_hist is not None:
            xn_hist[t] = xn

    with phase_annotation("step0", memory_of=device):
        w0, logw_n, logz0 = logsumexp_normalize(log_weight(y[0], xn0))
        record(0, xn0, w0, logw_n)

    xn = xn0
    with phase_annotation("loop", memory_of=device):
        for t in range(n_steps):
            with phase_annotation("step", t=t + 1):
                with phase_annotation("resample"):
                    u, w_dyn = draw(t)
                    ai = resample_indices(u, torch.exp(logw_n), n_p,
                                          config.resampling)
                    if gated:
                        # the port's lax.cond: indices drawn every step,
                        # the identity kept where the carried weights' ESS
                        # is above the threshold
                        do_resample = (ess_from_logw(logw_n)
                                       <= config.ess_threshold * n_p)
                        ai = torch.where(do_resample, ai, ident)
                        logw_prev = torch.where(do_resample, uniform,
                                                logw_n)
                    else:
                        logw_prev = uniform
                    ancestors[t] = ai
                with phase_annotation("dynamics"):
                    xn = dynamics(w_dyn, xn.index_select(0, ai), dx[t],
                                  dt[t], Q[t])
                with phase_annotation("weights"):
                    w_new, logw_n, logz_t[t] = logsumexp_normalize(
                        logw_prev + log_weight(y[t + 1], xn))
                    record(t + 1, xn, w_new, logw_n)

    with phase_annotation("finish", memory_of=device):
        if xn_hist is not None:
            xn_traj = reconstruct_trajectories(xn_hist, ancestors)
        else:
            xn_hist = torch.zeros((0,), device=device)
            xn_traj = torch.zeros((0,), device=device)
        return PFResult(
            traj_max=traj_max, traj_mean=traj_mean, xn=xn, logw=logw_n,
            ess=ess, log_evidence=(logz0 - log_np) + torch.sum(logz_t),
            xn_traj=xn_traj, xn_hist=xn_hist, ancestors=ancestors,
        )
