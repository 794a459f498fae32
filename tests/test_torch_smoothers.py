"""The port's smoothers (CPF-AS and information form) and what they stand on,
against the JAX package on the same numpy inputs and JAX's own random
draws, on the CPU.

Pieces: psd_cholesky (PD, jitter stage, Gershgorin stage), the triangular
solves and Gaussian log-density, logq, the small-ny Kalman update with
its half-log-det, sample_categorical, the mag3d dynamics residual, the
Woodbury rank-ny transition chained as tests/test_rbps.py does, and the
two forms of the future-measurement ancestor weights.

Slice: run_rbps_information_form on the mag3d problem of
bench._build_problem(29, 16, 12) (n_lin 32, T=12), N_P=16, 3 sweeps,
systematic resampling, in the woodbury and cholesky forms, with
suffix_precompute off, and with bf16 storage against JAX's bf16 run.
JAX's draws are replayed from its key flow (rbslam_tpu/engines/
rbps.py:366, rbps_info.py:351,439,461) and injected through ``noise``.
The same cases through the step's CUDA-graph runner, its capture replaced
by the captured Python: bit-equal to the eager loop.

Tolerances: XNK atol 1e-4, XLK atol 1e-3, PK 1e-3 of its scale, ess rtol
1e-3, retry counts equal. The JAX result does not expose its ancestors;
equal XNK at 1e-4 pins the sampled ancestors and the kept trajectory,
because another ancestor changes the trajectory by the particle spread.
Ancestor sampling is an inverse CDF against one uniform, so an edge
within float noise of u would flip an index: ``test_seed_margins`` prints
the smallest |cdf - u| of the runs' draws and holds the ancestor and
kept-trajectory draws above 1e-3 and the resampling draws above 1e-5
(the two packages' weights differ by ~1e-6).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rbslam_tpu.basis.laplace import domain_center  # noqa: E402
from rbslam_tpu.engines import RBPSConfig as JSConfig  # noqa: E402
from rbslam_tpu.engines import (  # noqa: E402
    run_rbps_information_form as jrun_info,
)
from rbslam_tpu.engines import rbps as jrbps  # noqa: E402
from rbslam_tpu.engines import rbps_info as jinfo  # noqa: E402
from rbslam_tpu.math import linalg as jlinalg  # noqa: E402
from rbslam_tpu.math.quaternions import logq as jlogq  # noqa: E402
from rbslam_tpu.ops import kalman as jkalman  # noqa: E402
from rbslam_tpu.ops.resampling import (  # noqa: E402
    sample_categorical as jsample_categorical,
)
from rbslam_tpu_torch.engines import (  # noqa: E402
    RBPSConfig,
    run_rbps,
    run_rbps_information_form,
)
from rbslam_tpu_torch.engines import rbps as trbps  # noqa: E402
from rbslam_tpu_torch.engines import rbps_info as tinfo  # noqa: E402
from rbslam_tpu_torch.math import linalg as tlinalg  # noqa: E402
from rbslam_tpu_torch.math.quaternions import logq  # noqa: E402
from rbslam_tpu_torch.ops import kalman as tkalman  # noqa: E402
from rbslam_tpu_torch.ops import resampling as tresampling  # noqa: E402
from rbslam_tpu_torch.utils import problem_from_numpy  # noqa: E402

N_P, T_STEPS, N_K = 16, 12, 3


def t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- JAX's draws, replayed ------------------------------------------------

def dyn_normals(k_dyn, n, n_noise):
    """The dynamics' standard normals of one step: mag3d's dynamics_batch
    draws normal(k_dyn, (n, 6)); a model without dynamics_batch (radio2d)
    gets split(k_dyn, n) and one scalar normal per particle
    (rbslam_tpu/engines/rbps.py:271-280)."""
    if n_noise == 6:
        return np.asarray(jax.random.normal(k_dyn, (n, 6), jnp.float32))
    keys = jax.random.split(k_dyn, n)
    z = jax.vmap(lambda kk: jax.random.normal(kk, (), jnp.float32))(keys)
    return np.asarray(z)[:, None]


def smoother_noise(key, n_sweeps, T, n, n_noise, scheme, info_form):
    """(u, w, u_anc, u_pick) as the JAX smoothers draw them. Per sweep
    key, sub = split(key); the CPF-AS sweep then splits sub once more
    (rbps.py:233) where the information-form sweep does not; per step
    k_res, k_dyn, k_anc = split(k, 3); the kept trajectory's uniform comes
    from fold_in(sweep key, 7)."""
    shape = () if scheme == "systematic" else (n,)
    U, W, UA, UP = [], [], [], []
    for _ in range(n_sweeps):
        key, k = jax.random.split(key)
        if not info_form:
            k, _ = jax.random.split(k)
        u, w, ua = [], [], []
        for ks in jax.random.split(k, T - 1):
            k_res, k_dyn, k_anc = jax.random.split(ks, 3)
            u.append(np.asarray(jax.random.uniform(k_res, shape)))
            w.append(dyn_normals(k_dyn, n, n_noise))
            ua.append(np.asarray(jax.random.uniform(k_anc, ())))
        U.append(np.stack(u))
        W.append(np.stack(w))
        UA.append(np.stack(ua))
        UP.append(np.asarray(
            jax.random.uniform(jax.random.fold_in(k, 7), ())))
    return np.stack(U), np.stack(W), np.stack(UA), np.stack(UP)


@contextlib.contextmanager
def record_margins():
    """Record, for every inverse-CDF lookup of the port, the smallest
    distance between a uniform and a CDF edge: 'pick' for one uniform
    (ancestor sampling, kept trajectory), 'resample' for a vector or the
    systematic comb (in units of probability)."""
    margins = {"pick": [], "resample": []}
    inverse_cdf = tresampling._inverse_cdf
    systematic = tresampling._SCHEMES["systematic"]

    def rec_inverse_cdf(w, u):
        cdf = torch.cumsum(w, dim=0)
        cdf = cdf / cdf[-1]
        gap = (cdf[:-1, None] - u.reshape(1, -1)).abs().min()
        margins["pick" if u.dim() == 0 else "resample"].append(float(gap))
        return inverse_cdf(w, u)

    def rec_systematic(u0, w, n):
        cdf = torch.cumsum(w, dim=0)
        x = n * (cdf / cdf[-1])[:-1] - u0
        margins["resample"].append(float((x - torch.round(x)).abs().min())
                                   / n)
        return systematic(u0, w, n)

    tresampling._inverse_cdf = rec_inverse_cdf
    tresampling._SCHEMES["systematic"] = rec_systematic
    try:
        yield margins
    finally:
        tresampling._inverse_cdf = inverse_cdf
        tresampling._SCHEMES["systematic"] = systematic


def assert_margins(margins, what):
    pick, res = min(margins["pick"]), min(margins["resample"])
    print(f"{what}: smallest |cdf - u| over {len(margins['pick'])} ancestor "
          f"and kept-trajectory draws {pick:.3e}, over "
          f"{len(margins['resample'])} resampling steps {res:.3e}")
    assert pick > 1e-3, what
    assert res > 1e-5, what


def assert_smoothers_match(port, ref, pk_rel=1e-3):
    assert port.XNK.shape == ref.XNK.shape
    np.testing.assert_allclose(_np(port.XNK), _np(ref.XNK), atol=1e-4)
    np.testing.assert_allclose(_np(port.XLK), _np(ref.XLK), atol=1e-3)
    scale = float(np.abs(_np(ref.PK)).max())
    np.testing.assert_allclose(_np(port.PK), _np(ref.PK),
                               atol=pk_rel * scale)
    np.testing.assert_allclose(_np(port.ess), _np(ref.ess), rtol=1e-3)
    np.testing.assert_array_equal(_np(port.chol_retries),
                                  _np(ref.chol_retries))


# --- math -------------------------------------------------------------------

def _psd_case(case):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    if case == "pd":
        return S
    if case == "jitter":
        # elements 1 and 3 singular-negative by less than the jitter
        for i in (1, 3):
            w, V = np.linalg.eigh(S[i].astype(np.float64))
            w[0] = -5e-3
            S[i] = (V * w) @ V.T
        return S
    # gershgorin: element 2 strongly indefinite, element 4 jitter-only
    w, V = np.linalg.eigh(S[2].astype(np.float64))
    w[:2] = (-3.0, -0.7)
    S[2] = (V * w) @ V.T
    w, V = np.linalg.eigh(S[4].astype(np.float64))
    w[0] = -5e-3
    S[4] = (V * w) @ V.T
    return S


@pytest.mark.parametrize("case", ["pd", "jitter", "gershgorin"])
def test_psd_cholesky_matches_jax(case):
    """Every stage of the repair; ``retried`` equal per element; the
    factors agree to 1e-4 of their scale (the jitter and Gershgorin
    stages factor nearly singular matrices)."""
    S = _psd_case(case)
    L, retried = tlinalg.psd_cholesky(t(S), 1e-2)
    Lj, rj = jlinalg.psd_cholesky(jnp.asarray(S), 1e-2)
    np.testing.assert_array_equal(retried.numpy(), np.asarray(rj))
    expected = {"pd": [], "jitter": [1, 3], "gershgorin": [2, 4]}[case]
    assert np.flatnonzero(retried.numpy()).tolist() == expected
    assert bool(torch.isfinite(L).all())
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-4,
                               atol=1e-4 * float(np.abs(Lj).max()))


def test_psd_cholesky_nan_input_flags():
    S = _psd_case("pd")
    S[0, 2, 2] = np.nan
    _, retried = tlinalg.psd_cholesky(t(S), 1e-2)
    _, rj = jlinalg.psd_cholesky(jnp.asarray(S), 1e-2)
    np.testing.assert_array_equal(retried.numpy(), np.asarray(rj))


def test_solves_and_logpdf_match_jax():
    """tril_solve, solve_psd, half_logdet, gaussian_logpdf_chol: rtol 1e-5."""
    rng = np.random.default_rng(1)
    S = _psd_case("pd")
    L = np.linalg.cholesky(S.astype(np.float64)).astype(np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    B = rng.normal(size=(5, 6, 3)).astype(np.float32)
    for tf, jf, args in (
        (tlinalg.tril_solve, jlinalg.tril_solve, (L, b)),
        (tlinalg.tril_solve, jlinalg.tril_solve, (L, B)),
        (tlinalg.solve_psd, jlinalg.solve_psd, (L, b)),
        (tlinalg.solve_psd, jlinalg.solve_psd, (L, B)),
        (tlinalg.half_logdet, jlinalg.half_logdet, (L,)),
        (tlinalg.gaussian_logpdf_chol, jlinalg.gaussian_logpdf_chol, (b, L)),
    ):
        np.testing.assert_allclose(
            tf(*map(t, args)).numpy(),
            np.asarray(jf(*map(jnp.asarray, args))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlinalg.gaussian_logpdf_chol(t(b), t(L), n_obs=4).numpy(),
        np.asarray(jlinalg.gaussian_logpdf_chol(jnp.asarray(b),
                                                jnp.asarray(L), n_obs=4)),
        rtol=1e-5)


def test_logq_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1] = [-1.0, 0.0, 0.0, 0.0]
    np.testing.assert_allclose(logq(t(q)).numpy(),
                               np.asarray(jlogq(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ny", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kalman_hld_matches_jax(ny, dtype):
    """The dense update with its half-log-det: 1e-5 relative in float32;
    with bf16 storage one bf16 rounding (8e-3) of P's scale."""
    rng = np.random.default_rng(ny)
    n, nl = 7, 20
    A = (0.3 * rng.normal(size=(n, nl, nl))).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + np.eye(nl, dtype=np.float32)
    C = rng.normal(size=(n, ny, nl)).astype(np.float32)
    xl = rng.normal(size=(n, nl)).astype(np.float32)
    y = rng.normal(size=(ny,)).astype(np.float32)
    R = (0.4 * np.eye(ny)).astype(np.float32)
    port = tkalman.kalman_update_dense_batched_hld(
        t(C), t(P).to(getattr(torch, dtype)), t(xl), t(y), t(R), 1e-3)
    ref = jkalman.kalman_update_dense_batched_hld(
        jnp.asarray(C), jnp.asarray(P).astype(jnp.dtype(dtype)),
        jnp.asarray(xl), jnp.asarray(y), jnp.asarray(R), 1e-3)
    assert port[1].dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 8e-3
    for a, b in zip(port, ref):
        b = np.asarray(b.astype(jnp.float32) if b.dtype != bool else b)
        a = a.numpy() if a.dtype == torch.bool else a.float().numpy()
        np.testing.assert_allclose(
            a, b, rtol=tol, atol=tol * max(1.0, float(np.abs(b).max())))


def test_sample_categorical_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.uniform(size=23).astype(np.float32)
    w /= w.sum()
    for i in range(20):
        key = jax.random.PRNGKey(i)
        u = np.asarray(jax.random.uniform(key, ()))
        port = tresampling.sample_categorical(t(u), t(w))
        assert port.dim() == 0
        assert int(port) == int(jsample_categorical(key, jnp.asarray(w)))


# --- the mag3d problem of both packages ----------------------------------------

@pytest.fixture(scope="module")
def mag():
    data, model, potential, k, Q, R = bench._build_problem(
        29, N_P, T_STEPS, pallas_basis=True)
    b = potential.basis
    center = np.asarray(jnp.asarray(domain_center(data.LL), jnp.float32))
    prob = problem_from_numpy(
        b.NN, b.L, b.eigenvalues, center, np.asarray(k), np.asarray(Q),
        np.asarray(R), 0.01, np.asarray(data.dx), np.asarray(data.y),
        np.asarray(data.init_state), device="cpu",
    )
    jargs = (model, data.dx, data.y, data.init_state,
             jnp.zeros(potential.n_lin), jnp.diag(k), Q, R, 0.01)
    return {"prob": prob, "jargs": jargs}


def test_mag3d_dyn_residual_matches_jax(mag):
    """The whitened residual of the whole ensemble against the reference's
    per-particle residual: atol 1e-3 on values of order 1 to 100 (the
    orientation noise of 1e-4 rad whitens float32 rounding of the
    quaternion product)."""
    jmodel, tmodel = mag["jargs"][0], mag["prob"].model
    rng = np.random.default_rng(4)
    xn = np.concatenate([rng.uniform(-1, 1, (9, 3)),
                         rng.normal(size=(9, 4))], axis=1).astype(np.float32)
    xn[:, 3:] /= np.linalg.norm(xn[:, 3:], axis=1, keepdims=True)
    u = np.asarray(mag["jargs"][1])[0]
    Q = np.asarray(mag["jargs"][6])
    w = rng.normal(size=(9, 6)).astype(np.float32)
    nxt = tmodel.dynamics_batch(t(w), t(xn), t(u), torch.tensor(0.01), t(Q))
    xn_ref = nxt[4].numpy()
    port = tmodel.dyn_residual(t(xn_ref), t(xn), t(u), torch.tensor(0.01),
                               t(Q))
    ref = jax.vmap(lambda x: jmodel.dyn_residual(
        jnp.asarray(xn_ref), x, jnp.asarray(u), 0.01, jnp.asarray(Q)))(
            jnp.asarray(xn))
    assert port.shape == (9, 6)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-3)
    # the particle the reference came from: the residual is the noise
    np.testing.assert_allclose(port[4].numpy(), w[4], atol=5e-2)
    logw = trbps._dyn_log_weights(tmodel, t(xn_ref), t(xn), t(u),
                                  torch.tensor(0.01), t(Q))
    jlogw = jrbps._dyn_log_weights(jmodel, jnp.asarray(xn_ref),
                                   jnp.asarray(xn), jnp.asarray(u), 0.01,
                                   jnp.asarray(Q))
    np.testing.assert_allclose(logw.numpy(), np.asarray(jlogw), rtol=1e-3)


def test_euclidean_residual_matches_jax():
    rng = np.random.default_rng(5)
    xn = rng.normal(size=(6, 3)).astype(np.float32)
    xr = rng.normal(size=(3,)).astype(np.float32)
    u = rng.normal(size=(4,)).astype(np.float32)
    Q = np.diag([0.1, 0.2, 0.3]).astype(np.float32)
    port = trbps._euclidean_residual(t(xr), t(xn), t(u), 0.5, t(Q))
    ref = jax.vmap(lambda x: jrbps._euclidean_residual(
        jnp.asarray(xr), x, jnp.asarray(u), 0.5, jnp.asarray(Q)))(
            jnp.asarray(xn))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# --- ancestor weights -----------------------------------------------------------

def _ancestor_state(seed=0, n_p=5, n_lin=12, ny=2, T=9):
    rng = np.random.default_rng(seed)
    A = (0.3 * rng.normal(size=(n_p, n_lin, n_lin))).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n_lin, dtype=np.float32)
    xl = rng.normal(size=(n_p, n_lin)).astype(np.float32)
    C_ref = (0.7 * rng.normal(size=(T, ny, n_lin))).astype(np.float32)
    y = rng.normal(size=(T, ny)).astype(np.float32)
    R = (0.3 * np.eye(ny)).astype(np.float32)
    return P, xl, C_ref, y, R


def test_dense_future_log_weights_match_jax():
    """The batched [N, T*ny, T*ny] masked system against the reference's
    vmapped one: atol 1e-3 on log-weights of order 10 to 100."""
    P, xl, C_ref, y, R = _ancestor_state()
    T, ny, n_lin = C_ref.shape
    for t_idx in (1, 3, T - 1):
        port, retried = trbps._dense_future_log_weights(
            t(C_ref.reshape(T * ny, n_lin)), t(y.reshape(T * ny)), t_idx,
            t(xl), t(P), t(R), T, ny, 1e-9)
        ref, rj = jrbps._dense_future_log_weights(
            jnp.asarray(C_ref.reshape(T * ny, n_lin)),
            jnp.asarray(y.reshape(T * ny)), t_idx, jnp.asarray(xl),
            jnp.asarray(P), jnp.asarray(R), T, ny, 1e-9)
        np.testing.assert_array_equal(retried.numpy(), np.asarray(rj))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-3)


def test_ancestor_weights_info_equals_naive():
    """For a consistent (xl, P) <-> (ivec, Imat) state the two ancestor
    weights differ only by a particle-independent constant (atol 2e-2, as
    tests/test_rbps.py), and the port's information form equals the JAX
    package's (atol 1e-3)."""
    P, xl, C_ref, y, R = _ancestor_state()
    T, ny, n_lin = C_ref.shape
    t_idx = 3
    naive, _ = trbps._dense_future_log_weights(
        t(C_ref.reshape(T * ny, n_lin)), t(y.reshape(T * ny)), t_idx, t(xl),
        t(P), t(R), T, ny, 1e-9)
    Pinv = np.linalg.inv(P.astype(np.float64))
    ivec = np.einsum("pij,pj->pi", Pinv, xl).astype(np.float32)
    hldp = (0.5 * np.linalg.slogdet(P.astype(np.float64))[1]
            ).astype(np.float32)
    Rinv = np.linalg.inv(R)
    m = (np.arange(T) >= t_idx).astype(np.float32)
    ivec_add = np.einsum("t,tik,ij,tj->k", m, C_ref, Rinv, y)
    Imat_add = np.einsum("t,tki,kl,tlj->ij", m, C_ref, Rinv, C_ref)
    Pinv = Pinv.astype(np.float32)
    info, retried = tinfo._info_future_log_weights(
        t(ivec), t(Pinv), t(P), t(hldp), t(ivec_add), t(Imat_add), 1e-9)
    assert not bool(retried.any())
    diff = (naive - info).numpy()
    np.testing.assert_allclose(diff - diff[0], 0.0, atol=2e-2)
    ref, _ = jinfo._info_future_log_weights(
        *map(jnp.asarray, (ivec, Pinv, P, hldp, ivec_add, Imat_add)), 1e-9)
    np.testing.assert_allclose(info.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    # the Woodbury form from W = Imat_end^-1 and its half-log-det
    M = Pinv.astype(np.float64) + Imat_add[None]
    W = np.linalg.inv(M).astype(np.float32)
    hldM = (0.5 * np.linalg.slogdet(M)[1]).astype(np.float32)
    wood = tinfo._woodbury_future_log_weights(
        t(ivec), t(W), t(P), t(hldp), t(hldM), t(ivec_add))
    jwood = jinfo._woodbury_future_log_weights(
        *map(jnp.asarray, (ivec, W, P, hldp, hldM, ivec_add)))
    np.testing.assert_allclose(wood.numpy(), np.asarray(jwood), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(wood.numpy(), info.numpy(), atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_woodbury_rank_ny_chained_matches_jax(dtype):
    """Chained rank-ny updates and downdates of (W, hldM), as
    tests/test_rbps.py:108-133: each step equals the JAX package's (1e-5
    of W's scale in float32; in bf16 storage one rounding, 8e-3), and the
    float32 chain tracks the freshly inverted matrix (atol 5e-4)."""
    rng = np.random.default_rng(0)
    n_p, nl, ny = 4, 24, 3
    A = (0.2 * rng.normal(size=(n_p, nl, nl))).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 3.0 * np.eye(nl)).astype(np.float64)
    W0 = np.linalg.inv(M).astype(np.float32)
    h0 = (0.5 * np.linalg.slogdet(M)[1]).astype(np.float32)
    W, hld = t(W0).to(getattr(torch, dtype)), t(h0)
    Wj, hldj = jnp.asarray(W0).astype(jnp.dtype(dtype)), jnp.asarray(h0)
    tol = 1e-5 if dtype == "float32" else 8e-3
    for i in range(4):
        U = (0.5 * rng.normal(size=(n_p, nl, ny))).astype(np.float32)
        sign = 1.0 if i % 2 == 0 else -1.0
        if sign < 0:
            U = 0.2 * U                         # keep M - UU' SPD
        M = M + sign * np.einsum("pik,pjk->pij", U, U)
        W, hld, retried = tinfo._woodbury_rank_ny(W, hld, t(U), sign, 1e-9)
        Wj, hldj, rj = jinfo._woodbury_rank_ny(Wj, hldj, jnp.asarray(U),
                                               sign, 1e-9)
        assert W.dtype == getattr(torch, dtype)
        assert not bool(retried.any()) and not bool(jnp.any(rj))
        ref = np.asarray(Wj.astype(jnp.float32))
        np.testing.assert_allclose(W.float().numpy(), ref, rtol=tol,
                                   atol=tol * float(np.abs(ref).max()))
        np.testing.assert_allclose(hld.numpy(), np.asarray(hldj), rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(W.numpy(), np.linalg.inv(M), atol=5e-4)
        np.testing.assert_allclose(hld.numpy(),
                                   0.5 * np.linalg.slogdet(M)[1], rtol=1e-4)


# --- the slice: information-form smoother on mag3d ----------------------------

MAG_CASES = {
    "woodbury": dict(ancestor_form="woodbury"),
    "cholesky": dict(ancestor_form="cholesky"),
    "woodbury_no_precompute": dict(ancestor_form="woodbury",
                                   suffix_precompute=False),
    "cholesky_no_precompute": dict(ancestor_form="cholesky",
                                   suffix_precompute=False),
    "woodbury_bf16": dict(ancestor_form="woodbury", cov_dtype="bfloat16"),
}


def _mag_config(cls, **kw):
    return cls(n_particles=N_P, n_sweeps=N_K, resampling="systematic", **kw)


@pytest.fixture(scope="module")
def mag_noise():
    return smoother_noise(jax.random.PRNGKey(0), N_K, T_STEPS, N_P, 6,
                          "systematic", info_form=True)


@pytest.mark.parametrize("case", sorted(MAG_CASES))
def test_slice_mag3d_info_form_matches_jax(mag, mag_noise, case):
    kw = MAG_CASES[case]
    ref = jrun_info(jax.random.PRNGKey(0), *mag["jargs"],
                    _mag_config(JSConfig, **kw))
    port = run_rbps_information_form(
        *mag["prob"].rbpf_args(), _mag_config(RBPSConfig, **kw),
        generator=None, device="cpu", noise=mag_noise)
    assert port.XNK.shape == (N_K, T_STEPS, 7)
    assert port.PK.dtype == torch.float32
    assert port.ancestors.shape == (N_K, T_STEPS - 1, N_P)
    assert port.ancestors.dtype == torch.int32
    for field in port:
        assert bool(torch.isfinite(field.float()).all())
    # bf16 storage: PK within one bf16 rounding of its scale
    assert_smoothers_match(port, ref,
                           pk_rel=2 ** -8 if "bf16" in case else 1e-3)


@pytest.mark.parametrize("case", sorted(MAG_CASES))
def test_slice_mag3d_info_form_replayed_steps(mag, mag_noise, case,
                                              monkeypatch):
    """The same cases through the CUDA-graph runner of the step, its capture
    replaced by the captured Python (tests/test_torch_step_graphs.py): the
    step function driven at the device-side index over static buffers
    gives the eager loop's arrays bit for bit, and so JAX's (above); the
    Cholesky form's conditioned sweeps stay eager."""
    from test_torch_step_graphs import PythonGraphs, _engage_as_on_a_card

    cfg = _mag_config(RBPSConfig, **MAG_CASES[case])

    def run():
        return run_rbps_information_form(
            *mag["prob"].rbpf_args(), cfg, generator=None, device="cpu",
            noise=mag_noise)

    eager = run()
    monkeypatch.setattr(tinfo, "_StepGraphs", PythonGraphs)
    monkeypatch.setattr(tinfo, "_graphs_engage", _engage_as_on_a_card)
    replayed = run()
    for field, a, b in zip(eager._fields, eager, replayed):
        assert a.dtype == b.dtype and torch.equal(a, b), field


def test_seed_margins(mag, mag_noise):
    with record_margins() as margins:
        for kw in (MAG_CASES["woodbury"], MAG_CASES["cholesky"]):
            run_rbps_information_form(
                *mag["prob"].rbpf_args(), _mag_config(RBPSConfig, **kw),
                generator=None, device="cpu", noise=mag_noise)
    assert_margins(margins, "mag3d information form, PRNGKey(0)")


def test_forms_sample_the_same_ancestors(mag, mag_noise):
    """The woodbury and cholesky forms compute the same ancestor weights:
    on the same draws they sample the same ancestors and keep the same
    trajectories."""
    runs = [run_rbps_information_form(
        *mag["prob"].rbpf_args(), _mag_config(RBPSConfig, ancestor_form=f),
        generator=None, device="cpu", noise=mag_noise)
        for f in ("woodbury", "cholesky")]
    assert torch.equal(runs[0].ancestors, runs[1].ancestors)
    assert torch.equal(runs[0].kept, runs[1].kept)
    # the pinned particle's ancestor is sampled, not always itself
    pinned = runs[0].ancestors[1:, :, N_P - 1]
    assert int((pinned != N_P - 1).sum()) > 0


def test_generator_draws_are_reproducible(mag):
    prob = mag["prob"]
    runs = [run_rbps_information_form(
        *prob.rbpf_args(), _mag_config(RBPSConfig),
        generator=torch.Generator().manual_seed(5), device="cpu")
        for _ in range(2)]
    assert torch.equal(runs[0].XNK, runs[1].XNK)
    assert torch.equal(runs[0].ancestors, runs[1].ancestors)
    assert bool(torch.isfinite(runs[0].XLK).all())


@pytest.mark.parametrize("ancestor_form", ["woodbury", "cholesky"])
def test_dense_ny4_info_form_matches_jax(mag, mag_noise, ancestor_form):
    """A dense model with ny = 4: the lax-form update in the filter pass and
    psd_cholesky in the rank-ny inverse maintenance."""
    from test_torch_rbpf import ny4_problem

    targs, jargs4 = ny4_problem(mag["prob"], mag["jargs"])
    kw = dict(ancestor_form=ancestor_form)
    ref = jrun_info(jax.random.PRNGKey(0), *jargs4,
                    _mag_config(JSConfig, **kw))
    port = run_rbps_information_form(
        *targs, _mag_config(RBPSConfig, **kw), generator=None, device="cpu",
        noise=mag_noise)
    assert_smoothers_match(port, ref)


def test_dense_ny4_cpf_as_matches_jax(mag):
    from test_torch_rbpf import ny4_problem

    targs, jargs4 = ny4_problem(mag["prob"], mag["jargs"])
    noise = smoother_noise(jax.random.PRNGKey(0), N_K, T_STEPS, N_P, 6,
                           "systematic", info_form=False)
    ref = jrbps.run_rbps(jax.random.PRNGKey(0), *jargs4,
                         _mag_config(JSConfig))
    port = run_rbps(*targs, _mag_config(RBPSConfig), generator=None,
                    device="cpu", noise=noise)
    assert_smoothers_match(port, ref)


@pytest.mark.parametrize("entry", ["run_rbps", "run_rbps_information_form"])
@pytest.mark.parametrize("case", ["sparse_model", "checkpoint_dir", "mesh"])
def test_unported_smoother_paths_raise(mag, mag_noise, entry, case,
                                       tmp_path):
    """``run_rbps`` takes no mesh, as the JAX package's (a TypeError, for a
    dense model and a sparse one); ``run_rbps_information_form`` takes one
    and refuses particles that do not divide over it (15 on 2 gloo ranks;
    the mesh path itself: tests/test_torch_parallel.py). The information
    form takes dense features only and rejects a sparse model, as the JAX
    package does. Per-sweep checkpoints are ported: a run with
    ``checkpoint_dir`` saves one a sweep and returns the run's result
    (tests/test_torch_checkpoint.py holds the resume)."""
    from rbslam_tpu_torch.models import PinholeCamera, make_pinhole2d_model
    from rbslam_tpu_torch.utils import latest_step

    fn = {"run_rbps": run_rbps,
          "run_rbps_information_form": run_rbps_information_form}[entry]
    prob = mag["prob"]
    args = list(prob.rbpf_args())
    if case == "checkpoint_dir":
        ck = str(tmp_path / "ck")
        runs = [fn(*args, _mag_config(RBPSConfig), generator=None,
                   device="cpu", noise=mag_noise, **kw)
                for kw in ({}, {"checkpoint_dir": ck})]
        assert latest_step(ck) == N_K
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        return
    if case == "sparse_model":
        args[0] = make_pinhole2d_model(PinholeCamera(1.5, 0.0, 1.0), 6)
        if entry == "run_rbps_information_form":
            with pytest.raises(ValueError, match="dense features only"):
                fn(*args, _mag_config(RBPSConfig), generator=None,
                   device="cpu", noise=mag_noise)
            return
    if entry == "run_rbps_information_form":
        from torch_ranks import Ranks

        ranks = Ranks(tmp_path / "ranks", 2, (2, 1), ["info_size_mismatch"],
                      {}).results()
        for rank in ranks:
            assert "15 particles do not divide over 2 'particles' ranks" \
                in rank["info_size_mismatch"]
        return
    with pytest.raises(TypeError, match="mesh"):
        fn(*args, _mag_config(RBPSConfig), generator=None, device="cpu",
           noise=mag_noise, mesh=object())


def test_bad_config_and_noise_rejected(mag, mag_noise):
    prob = mag["prob"]
    with pytest.raises(ValueError, match="ancestor_form"):
        run_rbps_information_form(
            *prob.rbpf_args(), _mag_config(RBPSConfig, ancestor_form="qr"),
            generator=None, device="cpu", noise=mag_noise)
    with pytest.raises(ValueError, match="noise"):
        run_rbps_information_form(
            *prob.rbpf_args(), _mag_config(RBPSConfig), generator=None,
            device="cpu", noise=tuple(a[:2] for a in mag_noise))
    with pytest.raises(ValueError, match="Generator"):
        run_rbps_information_form(
            *prob.rbpf_args(), _mag_config(RBPSConfig), generator=None,
            device="cpu")


def test_run_rbps_warns_of_its_cost(mag):
    """T * ny > 256 warns before any work (here the run is then refused by
    a noise tuple of the wrong length)."""
    prob = mag["prob"]
    args = list(prob.rbpf_args())
    args[2] = torch.zeros((90, 3))
    with pytest.warns(UserWarning, match="run_rbps_information_form"):
        with pytest.raises(ValueError, match="noise"):
            run_rbps(*args, _mag_config(RBPSConfig), generator=None,
                     device="cpu", noise=(np.zeros(1),))
