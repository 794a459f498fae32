"""A plain Rao-Blackwellized particle smoother for dense radio SLAM: the
conditional particle filter with ancestor sampling of the reference's
src/particleSmoother.m (the paper's Alg. 2; N_K sweeps, each conditioned on
the trajectory the previous one kept), to judge a smoother run, and, run
free in a lower precision, as the control in its place.

Per sweep and step it resamples the particles (multinomial, from one
uniform a particle), draws the pinned particle's ancestor from the filter
weight times the heading density of the reference pose times the
likelihood of the readings still to come along the reference, propagates
the poses and runs each particle's Kalman update of its map. The future
term is the reference's dynamic slice (:163-193): the stacked system of the
(T - t) ny rows still to come, C the basis rows along the reference,
log N(y_t:T; C m, C P C' + R I) from one Cholesky of that true width a
particle. After the last step it keeps one trajectory, drawn from the
final weights.

``follow`` (a judged run's outputs: ``XNK`` [N_K, T, 3], ``XLK`` [N_K, m],
``PK`` [N_K, m, m], ``ess`` [N_K, T], ``ancestors`` [N_K, T-1, N],
``kept`` [N_K]) makes every random choice the run's, conditions each sweep
on the trajectory the run kept, and measures how far each choice lies from
the CDF interval of this reference's weights. Weights and covariances are
float64 when judging. It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from .basis2d import Basis2D
from .pf_localization_exact import multinomial_gaps as _gaps
from .rbps_info_dense import _cdf, _pick

_LOG2PI = math.log(2.0 * math.pi)


def _chol(S, jitter: float):
    """Lower Cholesky of a batch, with the reference's one retry at
    S + jitter I (src/particleSmoother.m:70) where a factorization
    fails."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = info != 0
    if bool(bad.any()):
        eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        L = torch.where(bad[..., None, None],
                        torch.linalg.cholesky(S + jitter * eye), L)
    return L


def future_log_lik(xl, P, C, y, r: float, jitter: float,
                   dtype=torch.float64):
    """log N(y; C xl, C P C' + r I) [N] of the rows still to come, at
    their true width: C [rows, m] the basis rows along the reference, y
    [rows], a particle's map N(xl [N, m], P [N, m, m]); computed in
    ``dtype``."""
    xl, P, C, y = (a.to(dtype) for a in (xl, P, C, y))
    rows = C.shape[0]
    PCt = P @ C.T                                         # [N, m, rows]
    S = C @ PCt + r * torch.eye(rows, dtype=dtype, device=P.device)
    L = _chol(S, jitter)
    e = y - xl @ C.T                                      # [N, rows]
    v = torch.linalg.solve_triangular(L, e[..., None], upper=False)[..., 0]
    logdet = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    return -logdet - 0.5 * (v * v).sum(1) - 0.5 * rows * _LOG2PI


def _stored(x, dtype):
    """x with each value rounded to ``dtype``, kept in x's dtype (x itself
    where they are one)."""
    return x if dtype == x.dtype else x.to(dtype).to(x.dtype)


def _draw(w, u, dtype):
    """Inverse-CDF draws of w [N] at uniforms u, with the weights, their
    CDF and the uniforms stored in ``dtype``."""
    if dtype == w.dtype:
        return _pick(w, u)
    cdf = _stored(_cdf(_stored(w, dtype)), dtype)
    v = _stored(u.to(w.dtype), dtype).reshape(-1)
    idx = torch.searchsorted(cdf, v, right=True)
    return idx.clamp(max=w.shape[0] - 1).reshape(u.shape)


def _update(P, xl, C, y_t, r: float):
    """One scalar reading's Kalman update of every particle's map: (P',
    xl', log N(y_t; C xl, C P C' + r)); P' symmetrized, in P's dtype."""
    Cp = C.to(P.dtype)
    PC = (P @ Cp[..., None])[..., 0]                      # [N, m]
    s = (PC * Cp).sum(-1).to(torch.float64) + r
    e = y_t - (C * xl).sum(-1)
    K = PC / s[:, None].to(P.dtype)
    P = torch.baddbmm(P, K[..., None], PC[:, None, :], alpha=-1.0)
    P = 0.5 * (P + P.transpose(1, 2))
    xl = xl + K.to(xl.dtype) * e[:, None]
    logw = -0.5 * (torch.log(s) + e * e / s + _LOG2PI)
    return P, xl, logw


def _propagate(xn, w, u, sigma):
    """Heading-frame transition (run_dense2D_withHeading.m:75-77): the
    odometry step rotated by R(theta)' into the particle's heading, noise
    of standard deviation ``sigma`` on the heading alone."""
    c, s = torch.cos(xn[:, 2]), torch.sin(xn[:, 2])
    return torch.stack([xn[:, 0] + c * u[0] + s * u[1],
                        xn[:, 1] - s * u[0] + c * u[1],
                        xn[:, 2] + u[2] + sigma * w[:, 0]], dim=-1)


def sweeps(data, noise, n_sweeps: int, jitter: float, follow=None,
           cov_dtype=torch.float64, weights_dtype=torch.float64,
           state_dtype=torch.float64, future=future_log_lik):
    """Run the smoother on ``data`` (problems/dense_radio.py) with the draws
    ``noise`` = (u [N_K, T-1, N], w [N_K, T-1, N, 1], u_anc [N_K, T-1],
    u_pick [N_K]). Returns (outputs in the judged run's format, the gaps to
    ``follow``): ``anc_gap`` and ``anc_mean``, the largest and the mean
    distance of a resampling ancestor from its multinomial CDF interval;
    ``as_gap``, the largest of the pinned particle's ancestor draw from
    its interval under this reference's ancestor weights; ``pick_gap``,
    the kept trajectory's under the final weights (all in 1/N);
    ``as_nats``, how far this reference's ancestor log-weight of a drawn
    ancestor lies below the largest; ``pose_err``, an entry of a kept
    trajectory (m, rad); ``ess_err`` (over N); ``map_err`` and ``cov_err``
    (relative norms of the kept map's mean and covariance).
    ``cov_dtype`` is the covariances' precision, ``weights_dtype`` that
    of the future term ``future`` and ``state_dtype`` the one in which the
    poses, the normalized weights, their CDFs and the uniforms drawn
    against them are stored (arithmetic in float64; the control sets all
    three lower; a planted fault replaces ``future``)."""
    f64 = torch.float64
    u_all, w_all, ua_all, up_all = noise
    dev = u_all.device
    T, n = data.y.shape[0], u_all.shape[-1]
    ref = n - 1
    basis = Basis2D(data.LL, data.m)
    k0 = torch.as_tensor(basis.prior(data.theta), device=dev)
    r = float(data.R[0, 0])
    sigma = torch.sqrt(data.dt * data.Q[:, 0, 0].to(f64))
    y, dx = data.y[:, 0].to(f64), data.dx.to(f64)

    def rows(xn):
        return basis.phi(xn[:, :2])                        # [N, m] float64

    out = {"XNK": [], "XLK": [], "PK": [], "ess": [], "ancestors": [],
           "kept": []}
    worst = dict.fromkeys(("anc_gap", "as_gap", "as_nats", "pick_gap",
                           "pose_err", "ess_err", "map_err", "cov_err"), 0.0)
    gap_sum = gap_count = 0.0
    xnk = None
    for k in range(n_sweeps):
        first = k == 0
        if not first:
            xnk = (follow["XNK"][k - 1] if follow is not None
                   else out["XNK"][-1]).to(f64)
            C_ref = rows(xnk)                               # [T, m]
        xn = _stored(data.x0.to(f64), state_dtype).expand(n, -1).clone()
        if not first:
            xn[ref] = xnk[0]
        xl = torch.zeros((n, basis.m), dtype=f64, device=dev)
        P = torch.diag(k0).to(cov_dtype).expand(n, -1, -1)
        P, xl, logw = _update(P, xl, rows(xn), y[0], r)
        wn = _stored(torch.softmax(logw, 0), state_dtype)
        hist, ancs, ess = [xn], [], [1.0 / (wn * wn).sum()]
        for t in range(1, T):
            u, w_dyn = u_all[k, t - 1], w_all[k, t - 1]
            if follow is not None:
                a = follow["ancestors"][k, t - 1].long()
                live = slice(None) if first else slice(0, ref)
                g = _gaps(wn, u[live], a[live])
                worst["anc_gap"] = max(worst["anc_gap"], float(g.max()))
                gap_sum += float(g.sum())
                gap_count += g.numel()
            else:
                a = _draw(wn, u, state_dtype)
            if not first:
                e = (xnk[t, 2] - xn[:, 2] - dx[t - 1, 2]) / sigma[t - 1]
                logpa = (torch.log(wn) - 0.5 * e * e
                         + future(xl, P, C_ref[t:], y[t:], r, jitter,
                                  weights_dtype).to(f64))
                pa = _stored(torch.softmax(logpa, 0), state_dtype)
                if follow is not None:
                    worst["as_gap"] = max(worst["as_gap"], float(
                        _gaps(pa, ua_all[k, t - 1][None], a[ref:]).max()))
                    worst["as_nats"] = max(worst["as_nats"], float(
                        logpa.max() - logpa[a[ref]]))
                else:
                    a = a.clone()
                    a[ref] = _draw(pa, ua_all[k, t - 1], state_dtype)
            xn = _stored(_propagate(xn[a], w_dyn.to(f64), dx[t - 1],
                                    sigma[t - 1]), state_dtype)
            if not first:
                xn[ref] = xnk[t]
            P, xl, logw = _update(P[a], xl[a], rows(xn), y[t], r)
            wn = _stored(torch.softmax(logw, 0), state_dtype)
            hist.append(xn)
            ancs.append(a)
            ess.append(1.0 / (wn * wn).sum())
        if follow is not None:
            ak = follow["kept"][k].long()
            worst["pick_gap"] = max(worst["pick_gap"], float(
                _gaps(wn, up_all[k][None], ak[None]).max()))
        else:
            ak = _draw(wn, up_all[k], state_dtype)
        idx, traj = ak, []
        for t in range(T - 1, -1, -1):
            traj.append(hist[t][idx])
            if t > 0:
                idx = ancs[t - 1][idx]
        traj = torch.stack(traj[::-1])
        ess = torch.stack(ess)
        # a 0-d index gives a view: copy, so that the ensemble is freed
        xl_k, P_k = xl[ak].clone(), P[ak].to(f64, copy=True)
        out["XNK"].append(traj)
        out["XLK"].append(xl_k)
        out["PK"].append(P_k)
        out["ess"].append(ess)
        out["ancestors"].append(torch.stack(ancs).to(torch.int32))
        out["kept"].append(ak)
        if follow is not None:
            f = {key: follow[key][k].to(f64)
                 for key in ("XNK", "XLK", "PK", "ess")}
            worst["pose_err"] = max(worst["pose_err"],
                                    float((f["XNK"] - traj).abs().max()))
            worst["ess_err"] = max(worst["ess_err"],
                                   float((f["ess"] - ess).abs().max()) / n)
            worst["map_err"] = max(worst["map_err"], float(
                torch.linalg.vector_norm(f["XLK"] - xl_k)
                / torch.linalg.vector_norm(xl_k)))
            worst["cov_err"] = max(worst["cov_err"], float(
                torch.linalg.matrix_norm(f["PK"] - P_k)
                / torch.linalg.matrix_norm(P_k)))
        del P, xl
    out = {key: torch.stack(v) for key, v in out.items()}
    worst["anc_mean"] = gap_sum / max(gap_count, 1)
    return out, worst


def judge(data, noise, kept: dict, jitter: float) -> dict:
    """The largest gaps between a smoother run's outputs ``kept`` and this
    reference following its choices, TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return sweeps(data, noise, kept["XNK"].shape[0], jitter,
                      follow=kept)[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
