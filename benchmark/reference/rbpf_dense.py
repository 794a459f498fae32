"""A plain dense Rao-Blackwellized particle filter for dense magnetic SLAM,
to judge a filter run (src/particleFilter.m of the reference: resample,
propagate the poses, weight by the marginal innovation likelihood, and
update each particle's Kalman filter of the map).

It follows the judged run's ancestors, as a served model's reference reads
the served tokens, and checks each of them against the systematic
resampling of its own weights. Everything else it works out itself, from
the benchmark's data and draws: the basis, the prior, the poses, every
particle's map mean and covariance, the weights and the evidence. The
covariances are float32 (with TF32 off), every other number float64.

The judged run's outputs come in ``kept``: ``ancestors`` [T-1, N],
``xn_hist`` [T, N, 7], ``ess`` [T], ``logw`` [N] (final, normalized),
``log_evidence``, ``xl`` [N, n_lin] (final maps), ``P_sample`` [S, n_lin,
n_lin] (the final covariances of the particles ``sample``).
"""

from __future__ import annotations

import math

import torch

from .basis import Basis, propagate, rmat

_LOG2PI = math.log(2.0 * math.pi)


def systematic_gap(w: torch.Tensor, u0: torch.Tensor,
                   a: torch.Tensor) -> torch.Tensor:
    """How far the systematic comb points (j + u0) / N lie outside the CDF
    interval [cdf[a_j - 1], cdf[a_j]) of the ancestors ``a`` given for
    them, under the normalized weights ``w``: the largest distance over j,
    in units of 1/N (0 where every ancestor is the one resampling
    picks)."""
    n = w.shape[0]
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    v = (torch.arange(n, dtype=w.dtype, device=w.device)
         + u0.to(w.dtype)) / n
    hi = cdf[a]
    lo = torch.where(a > 0, cdf[(a - 1).clamp(min=0)], torch.zeros_like(hi))
    return torch.clamp(torch.maximum(lo - v, v - hi), min=0).max() * n


def kf_update(P, xl, C, y, R):
    """Dense Kalman update of every particle: P [N, n, n] float32, xl
    [N, n] and C [N, ny, n] float64. Returns (P', xl', logw)."""
    f32, f64 = torch.float32, torch.float64
    PCt = torch.bmm(P, C.to(f32).transpose(1, 2))           # [N, n, ny]
    PCt64 = PCt.to(f64)
    S = C @ PCt64 + R
    L = torch.linalg.cholesky(S)
    e = y - (C @ xl[..., None])[..., 0]
    z = torch.linalg.solve_triangular(L, e[..., None], upper=False)[..., 0]
    logw = (-0.5 * (z * z).sum(-1)
            - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * e.shape[-1] * _LOG2PI)
    K = PCt64 @ torch.cholesky_inverse(L)                   # P C' S^-1
    xl = xl + (K @ e[..., None])[..., 0]
    # P - K S K' = P - K (P C')'
    P = torch.baddbmm(P, K.to(f32), PCt.transpose(1, 2), alpha=-1.0)
    return P, xl, logw


def judge(data, u: torch.Tensor, w: torch.Tensor, kept: dict,
          sample: torch.Tensor) -> dict:
    """Follow a filter run of ``data`` (problems/dense_mag.py) with the
    systematic uniforms u [T-1] and dynamics normals w [T-1, N, 6] along
    its ancestors, and return the largest gaps between it and ``kept``:

    - ``anc_gap``: an ancestor's distance from the CDF interval systematic
      resampling of these weights gives it, in units of 1/N;
    - ``pose_err``: a pose entry (position in m, quaternion component);
    - ``ess_err``: the effective sample size of a step, over N;
    - ``w_tv``: total variation between the final weights;
    - ``evidence_err``: the log evidence (nats);
    - ``map_err``: a particle's final map mean, in norm, over the RMS norm
      of the reference's maps;
    - ``cov_err``: a sampled particle's final covariance, in Frobenius
      norm, over the reference's.
    """
    f32, f64 = torch.float32, torch.float64
    dev = u.device
    T, n = data.y.shape[0], w.shape[1]
    basis = Basis(data.LL, data.m)
    k = torch.as_tensor(basis.prior(data.theta), device=dev)
    sd = torch.sqrt(data.dt * torch.diagonal(data.Q.to(f64)))
    Lp, Lq = torch.diag(sd[:3]), torch.diag(sd[3:])
    R, y, dx = data.R.to(f64), data.y.to(f64), data.dx.to(f64)
    anc = kept["ancestors"].long()
    xn = data.x0.to(f64).expand(n, -1)
    xl = torch.zeros((n, basis.n_lin), dtype=f64, device=dev)
    P = torch.diag(k).to(f32).expand(n, -1, -1)
    worst = {"anc_gap": 0.0, "pose_err": 0.0, "ess_err": 0.0}
    log_z = 0.0
    wn = None
    for t in range(T):
        if t > 0:
            a = anc[t - 1]
            worst["anc_gap"] = max(worst["anc_gap"],
                                   float(systematic_gap(wn, u[t - 1], a)))
            xn = propagate(xn[a], w[t - 1].to(f64), dx[t - 1], Lp, Lq)
            xl, P = xl[a], P[a]
        worst["pose_err"] = max(worst["pose_err"], float(
            (kept["xn_hist"][t].to(f64) - xn).abs().max()))
        C = rmat(xn[:, 3:]).transpose(1, 2) @ basis.grad_rows(xn[:, :3])
        P, xl, logw = kf_update(P, xl, C, y[t], R)
        lse = torch.logsumexp(logw, 0)
        wn = torch.exp(logw - lse)
        log_z += float(lse) - math.log(n)
        ess = 1.0 / float((wn * wn).sum())
        worst["ess_err"] = max(worst["ess_err"],
                               abs(float(kept["ess"][t]) - ess) / n)
    w_prog = torch.exp(kept["logw"].to(f64))
    xl_prog = kept["xl"].to(f64)
    rms = torch.sqrt((xl * xl).sum(-1).mean())
    P_ref = P[sample].to(f64)
    cov = (torch.linalg.matrix_norm(kept["P_sample"].to(f64) - P_ref)
           / torch.linalg.matrix_norm(P_ref))
    worst.update(
        w_tv=0.5 * float((w_prog - wn).abs().sum()),
        evidence_err=abs(float(kept["log_evidence"]) - log_z),
        map_err=float(torch.linalg.vector_norm(xl_prog - xl, dim=-1).max()
                      / rms),
        cov_err=float(cov.max()),
        ess_final_over_n=1.0 / float((wn * wn).sum()) / n,   # not compared
    )
    return worst
