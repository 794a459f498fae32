"""A plain information-form Rao-Blackwellized particle smoother for dense
magnetic SLAM (src/particleSmootherInformationForm.m of the reference:
conditional particle filter sweeps with ancestor sampling, N_K sweeps each
conditioned on the trajectory the previous one kept), to judge a smoother
run, and, run free in a lower precision, as the control in its place.

Per sweep and step it resamples the particles (multinomial, from one
uniform a particle), draws the reference particle's ancestor from the
filter weight times the dynamics density of the reference pose times the
likelihood of the measurements still to come along the reference (taken
in the whitened information form: with L L' = P, z = L^-1 m, A and b the
suffix sums of C' R^-1 C and C' R^-1 y along the reference,
B = I + L' A L: log p = -1/2 (z'z - c' B^-1 c) - 1/2 log|B|, c = z + L' b,
up to terms common to every particle), propagates, and runs each
particle's Kalman update. After the last step it keeps one trajectory,
drawn from the final weights.

``follow`` (a judged run's outputs: ``XNK`` [N_K, T, 7], ``XLK``, ``PK``,
``ess`` [N_K, T], ``ancestors`` [N_K, T-1, N], ``kept`` [N_K]) makes every
random choice the run's, conditions each sweep on the trajectory the run
kept, and measures how far each choice lies from the CDF interval of this
reference's weights. The covariances are float32 (TF32 as the caller
sets it), every other number float64. It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from .basis import Basis, logq, propagate, qinv, qmul, rmat
from .rbpf_dense import kf_update


def _cdf(w):
    c = torch.cumsum(w, -1)
    return c / c[..., -1:]


def _pick(w, u):
    """Inverse-CDF draws of w [N] at uniforms u (any shape)."""
    idx = torch.searchsorted(_cdf(w), u.to(w.dtype).reshape(-1), right=True)
    return idx.clamp(max=w.shape[0] - 1).reshape(u.shape)


def _gap(w, u, a):
    """Largest distance of uniforms u from the CDF intervals of the choices
    a under weights w, in units of 1/N."""
    cdf = _cdf(w)
    hi = cdf[a]
    lo = torch.where(a > 0, cdf[(a - 1).clamp(min=0)], torch.zeros_like(hi))
    u = u.to(w.dtype)
    return float(torch.clamp(torch.maximum(lo - u, u - hi), min=0).max()
                 * w.shape[0])


def _future_log_lik(xl, P, A, b, dtype=torch.float64):
    """log p(y_t:T | particle map N(xl, P)) up to a common constant, from
    the suffix information (A, b) of the reference, whitened, computed in
    ``dtype``."""
    xl, A, b = xl.to(dtype), A.to(dtype), b.to(dtype)
    L = torch.linalg.cholesky(P.to(dtype))
    z = torch.linalg.solve_triangular(L, xl[..., None], upper=False)
    LtA = L.transpose(1, 2) @ A
    B = torch.eye(A.shape[-1], dtype=dtype, device=A.device) + LtA @ L
    LB = torch.linalg.cholesky(B)
    c = z + L.transpose(1, 2) @ b[:, None]
    v = torch.linalg.solve_triangular(LB, c, upper=False)
    quad = (z * z).sum((1, 2)) - (v * v).sum((1, 2))
    return -0.5 * quad - torch.log(torch.diagonal(LB, dim1=1, dim2=2)).sum(1)


def sweeps(data, noise, n_sweeps: int, follow=None,
           weights_dtype=torch.float64, future=_future_log_lik):
    """Run the smoother on ``data`` (problems/dense_mag.py) with the draws
    ``noise`` = (u [N_K, T-1, N], w [N_K, T-1, N, 6], u_anc [N_K, T-1],
    u_pick [N_K]). Returns (outputs in the judged run's format, the
    largest gaps to ``follow``: ``anc_gap``, ``as_gap``, ``pick_gap`` in
    1/N; ``as_nats``, how far this reference's ancestor log-weight of the
    run's ancestor draw lies below its largest (the served-token gap of a
    sampled draw: the float32 ancestor weights of the information form can
    be a few nats off, which moves ``as_gap`` by whole intervals);
    ``as_xent``, the mean over those draws of their surprise under this
    reference's ancestor weights less the weights' entropy (0 on average
    for draws from these weights);
    ``pose_err``, ``ess_err`` (over N), ``map_err`` and ``cov_err``
    (relative)). ``weights_dtype`` is the precision of the ancestor
    weights' future term ``future`` (the control's and a witness's
    readings set it lower, or plant a fault in it)."""
    f32, f64 = torch.float32, torch.float64
    u_all, w_all, ua_all, up_all = noise
    dev = u_all.device
    T, n = data.y.shape[0], u_all.shape[-1]
    ref = n - 1
    basis = Basis(data.LL, data.m)
    nl = basis.n_lin
    k0 = torch.as_tensor(basis.prior(data.theta), device=dev)
    Q = data.Q.to(f64)
    sd = torch.sqrt(data.dt * torch.diagonal(Q))
    Lp, Lq = torch.diag(sd[:3]), torch.diag(sd[3:])
    Ldyn = torch.linalg.cholesky(data.dt * Q)
    R, y, dx = data.R.to(f64), data.y.to(f64), data.dx.to(f64)
    Rinv = torch.linalg.inv(R)

    def jac(xn):
        return rmat(xn[:, 3:]).transpose(1, 2) @ basis.grad_rows(xn[:, :3])

    def update(P, xl, xn, t):
        P, xl, logw = kf_update(P, xl, jac(xn), y[t], R)
        return 0.5 * (P + P.transpose(1, 2)), xl, logw

    out = {"XNK": [], "XLK": [], "PK": [], "ess": [], "ancestors": [],
           "kept": []}
    worst = dict.fromkeys(("anc_gap", "as_gap", "as_nats", "as_xent",
                           "pick_gap", "pose_err", "ess_err", "map_err",
                           "cov_err"), 0.0)
    draws = 0
    xnk = None
    for k in range(n_sweeps):
        first = k == 0
        if not first:
            xnk = (follow["XNK"][k - 1] if follow is not None
                   else out["XNK"][-1]).to(f64)
            C = jac(xnk)                                     # [T, 3, nl]
            CtRi = C.transpose(1, 2) @ Rinv
            A_suf = torch.flip(torch.cumsum(torch.flip(CtRi @ C, (0,)), 0),
                               (0,))
            b_suf = torch.flip(torch.cumsum(torch.flip(
                (CtRi @ y[:, :, None])[..., 0], (0,)), 0), (0,))
        xn = data.x0.to(f64).expand(n, -1).clone()
        if not first:
            xn[ref] = xnk[0]
        xl = torch.zeros((n, nl), dtype=f64, device=dev)
        P = torch.diag(k0).to(f32).expand(n, -1, -1)
        P, xl, logw = update(P, xl, xn, 0)
        wn = torch.softmax(logw, 0)
        hist, ancs, ess = [xn], [], [1.0 / (wn * wn).sum()]
        for t in range(1, T):
            u, w_dyn = u_all[k, t - 1], w_all[k, t - 1]
            u_anc = ua_all[k, t - 1]
            if follow is not None:
                a = follow["ancestors"][k, t - 1].long()
                rows = slice(None) if first else slice(0, ref)
                worst["anc_gap"] = max(worst["anc_gap"],
                                       _gap(wn, u[rows], a[rows]))
            else:
                a = _pick(wn, u)
            if not first:
                e = torch.cat([xnk[t, :3] - xn[:, :3] - dx[t - 1, :3], logq(
                    qmul(qmul(qinv(dx[t - 1, 3:]), qinv(xn[:, 3:])),
                         xnk[t, 3:]))], -1)
                e = torch.linalg.solve_triangular(Ldyn, e[..., None],
                                                  upper=False)[..., 0]
                logpa = (torch.log(wn) - 0.5 * (e * e).sum(-1)
                         + future(xl, P, A_suf[t], b_suf[t], weights_dtype)
                         .to(f64))
                pa = torch.softmax(logpa, 0)
                if follow is not None:
                    worst["as_gap"] = max(worst["as_gap"],
                                          _gap(pa, u_anc[None], a[ref:]))
                    worst["as_nats"] = max(worst["as_nats"], float(
                        logpa.max() - logpa[a[ref]]))
                    lp = torch.log_softmax(logpa, 0)
                    worst["as_xent"] += float(
                        (lp.exp() * lp).sum() - lp[a[ref]])
                    draws += 1
                else:
                    a = a.clone()
                    a[ref] = _pick(pa, u_anc)
            xn = propagate(xn[a], w_dyn.to(f64), dx[t - 1], Lp, Lq)
            if not first:
                xn[ref] = xnk[t]
            P, xl, logw = update(P[a], xl[a], xn, t)
            wn = torch.softmax(logw, 0)
            hist.append(xn)
            ancs.append(a)
            ess.append(1.0 / (wn * wn).sum())
        if follow is not None:
            ak = follow["kept"][k].long()
            worst["pick_gap"] = max(worst["pick_gap"],
                                    _gap(wn, up_all[k][None], ak[None]))
        else:
            ak = _pick(wn, up_all[k])
        idx, traj = ak, []
        for t in range(T - 1, -1, -1):
            traj.append(hist[t][idx])
            if t > 0:
                idx = ancs[t - 1][idx]
        traj = torch.stack(traj[::-1])
        ess = torch.stack(ess)
        out["XNK"].append(traj)
        out["XLK"].append(xl[ak])
        out["PK"].append(P[ak].to(f64))
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
                torch.linalg.vector_norm(f["XLK"] - xl[ak])
                / torch.linalg.vector_norm(xl[ak])))
            worst["cov_err"] = max(worst["cov_err"], float(
                torch.linalg.matrix_norm(f["PK"] - P[ak].to(f64))
                / torch.linalg.matrix_norm(P[ak].to(f64))))
    out = {key: torch.stack(v) for key, v in out.items()}
    worst["as_xent"] /= max(draws, 1)
    return out, worst


def judge(data, noise, kept: dict) -> dict:
    """The largest gaps between a smoother run's outputs ``kept`` and this
    reference following its choices."""
    return sweeps(data, noise, kept["XNK"].shape[0], follow=kept)[1]
