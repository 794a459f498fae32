"""A plain particle filter for localization on a fixed magnetic map with
the exact GP predictive, to judge a localization run (upstream
examples/mag-localization-mapping/run_localization.m:150-161,241-281 and
particleFilterLocalization.m:84-132: fit the map, then at every step
resample, propagate the poses and weight each by the predictive density
of the body-frame reading at its position).

It follows the judged run's ancestors, as a served model's reference
reads the served tokens, and checks each of them against multinomial
resampling of its own weights with the run's uniforms. Everything else it
works out itself, in float64, from the benchmark's data and draws: the
map's posterior (Phi'Phi + diag(sigma2 / k), its Cholesky, the mean
weights), the basis gradients, the poses, the predictive means and
variances and the weights. It imports nothing of the program, and sets
both TF32 flags to False.

Departures from upstream, each of the same semantics:

- weights in the log domain: ``sum`` is log sum_k N(y_k; mu_k, s2_k),
  the sum of the per-axis densities (:270) through a logsumexp, where
  upstream sums linear densities; ``product`` the joint log density;
- the predictive variance sigma2 diag(C A^-1 C') at the particle's own
  position, from one triangular solve (upstream evaluates the same
  quantity);
- the hyperparameters are given, not ML-II optimized (main.m:117);
- the log evidence sums log sum_i W_i p(y_t | x_t^i), W the weights each
  step starts from (1/N after a resampling), which upstream does not
  report.

The judged run's outputs come in ``kept``: ``ancestors`` [T-1, N],
``ess`` [T], ``logw`` [N] (final, normalized), ``log_evidence``,
``traj_mean`` [T, 7], ``xn`` [N, 7] (final poses).
"""

from __future__ import annotations

import math

import torch

from .basis import Basis, expq, qmul, rmat

_LOG2PI = math.log(2.0 * math.pi)


def posterior(data):
    """(basis, mean weights [n_lin], lower Cholesky [n_lin, n_lin]) of the
    map fitted to the mapping readings, in float64
    (tools/gp_scalar_potential_fast.m:138-140,190-207)."""
    f64 = torch.float64
    dev = data.y.device
    basis = Basis(data.LL, data.m)
    x = data.x_map.to(f64)
    y = data.y_map.to(f64)
    C = basis.grad_rows(x)                               # [n, 3, n_lin]
    Phi = C.transpose(0, 1).reshape(-1, basis.n_lin)     # axes stacked
    yv = y.T.reshape(-1)
    k = torch.as_tensor(basis.prior(data.theta), device=dev)
    A = Phi.T @ Phi + torch.diag(data.theta[3] / k)
    L = torch.linalg.cholesky(A)
    v = torch.linalg.solve_triangular(L, (Phi.T @ yv)[:, None], upper=False)
    w = torch.linalg.solve_triangular(L.T, v, upper=True)[:, 0]
    return basis, w, L


def log_weights(basis, w_map, L, sigma2: float, y_t, xn, mode: str):
    """Log density [N] of the body-frame reading y_t [3] at poses xn
    [N, 7] under the predictive N(C w, sigma2 diag(C A^-1 C')) of the
    navigation-frame field, rotated into each body frame."""
    C = basis.grad_rows(xn[:, :3])                       # [N, 3, n_lin]
    mean = C @ w_map
    V = torch.linalg.solve_triangular(L, C.reshape(-1, C.shape[-1]).T,
                                      upper=False)
    var = sigma2 * (V * V).sum(0).reshape(C.shape[:-1])
    mean_body = torch.einsum("nji,nj->ni", rmat(xn[:, 3:]), mean)
    s2 = var + sigma2
    log_pdfs = -0.5 * ((y_t - mean_body) ** 2 / s2 + torch.log(s2) + _LOG2PI)
    if mode == "product":
        return log_pdfs.sum(-1)
    if mode == "sum":
        return torch.logsumexp(log_pdfs, -1)
    raise ValueError(f"no weight mode {mode!r}")


def propagate(xn, w, u, Lp, Lq):
    """Localization dynamics (run_localization.m:274-281) from standard
    normals w [N, 6]: p' = p + u_p + Lp w_p, q' = (u_q q) exp(Lq w_q)."""
    p = xn[:, :3] + u[:3] + w[:, :3] @ Lp.T
    q = qmul(qmul(u[3:7], xn[:, 3:7]), expq(w[:, 3:] @ Lq.T))
    return torch.cat([p, q], dim=-1)


def multinomial_gaps(w, u, a) -> torch.Tensor:
    """Distances [N] of the uniforms u [N] from the CDF intervals
    [cdf[a - 1], cdf[a]) of the ancestors a [N] drawn with them, under the
    normalized weights w, in units of 1/N (0 where an ancestor is the one
    inverse-CDF resampling picks)."""
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    hi = cdf[a]
    lo = torch.where(a > 0, cdf[(a - 1).clamp(min=0)], torch.zeros_like(hi))
    u = u.to(w.dtype)
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0) * w.shape[0]


def judge(data, x0, u, w, kept: dict) -> dict:
    """Follow a run on ``data`` (problems/mag_localization.py) from the
    initial cloud x0 [N, 7], with the multinomial uniforms u [T-1, N] and
    dynamics normals w [T-1, N, 6], along its ancestors, and return the
    gaps between it and ``kept``:

    - ``anc_mean``: the ancestors' mean distance from the CDF intervals
      that multinomial resampling of these weights gives their uniforms,
      over every step, in 1/N;
    - ``pose_err``: an entry of a final pose or of the weighted mean pose
      of a step (position in m, quaternion component);
    - ``w_tv``: total variation between the final weights;

    and, reported beside them: ``anc_gap``, the largest such distance;
    ``anc_share``, the share of ancestors outside their intervals;
    ``ess_err``, the largest gap of a step's effective sample size, over N;
    ``evidence_err``, the log evidence's, in nats; ``loc_err_m``, the
    reference's mean distance from the true path over the last two
    thirds of the steps.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f64 = torch.float64
    T, n = data.y.shape[0], x0.shape[0]
    basis, w_map, L = posterior(data)
    sigma2 = float(data.theta[3])
    sd = torch.sqrt(data.dt * torch.diagonal(data.Q.to(f64)))
    Lp, Lq = torch.diag(sd[:3]), torch.diag(sd[3:])
    y, dx = data.y.to(f64), data.dx.to(f64)
    anc = kept["ancestors"].long()
    xn = x0.to(f64)
    worst = {"anc_gap": 0.0, "pose_err": 0.0, "ess_err": 0.0}
    gap_sum = outside = 0.0
    log_z = 0.0
    wn = None
    means = []
    for t in range(T):
        if t > 0:
            a = anc[t - 1]
            gaps = multinomial_gaps(wn, u[t - 1], a)
            worst["anc_gap"] = max(worst["anc_gap"], float(gaps.max()))
            gap_sum += float(gaps.sum())
            outside += float((gaps > 0).sum())
            xn = propagate(xn[a], w[t - 1].to(f64), dx[t - 1], Lp, Lq)
        logw = log_weights(basis, w_map, L, sigma2, y[t], xn, data.mode)
        lse = torch.logsumexp(logw, 0)
        wn = torch.exp(logw - lse)
        log_z += float(lse) - math.log(n)
        ess = 1.0 / float((wn * wn).sum())
        worst["ess_err"] = max(worst["ess_err"],
                               abs(float(kept["ess"][t]) - ess) / n)
        means.append((xn * wn[:, None]).sum(0))
    means = torch.stack(means)
    w_prog = torch.exp(kept["logw"].to(f64))
    dist = torch.linalg.vector_norm(means[:, :3] - data.truth.to(f64), dim=-1)
    worst.update(
        pose_err=max(
            float((kept["traj_mean"].to(f64) - means).abs().max()),
            float((kept["xn"].to(f64) - xn).abs().max())),
        w_tv=0.5 * float((w_prog - wn).abs().sum()),
        evidence_err=abs(float(kept["log_evidence"]) - log_z),
        anc_mean=gap_sum / ((T - 1) * n), anc_share=outside / ((T - 1) * n),
        loc_err_m=float(dist[T // 3:].mean()),
    )
    return worst
