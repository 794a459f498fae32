"""The dense EKF of the port and the pieces it needs, against the JAX
package on the same numpy inputs, on the CPU.

The dataset is the JAX package's own (bench._build_problem(27, ., 16):
n_lin 30, n = 36, T = 16); B = 3 batch members differ by measurement
noise and a constant disturbance. Tolerances: the basis Hessian, mcross
and the orientation RMSE 1e-5; the ny = 4 Kalman update 1e-4 of each
output's scale; the EKF x_traj 1e-3, q_traj 1e-4, P_final 1e-3 of its
scale, chol_retries equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rbslam_tpu.basis.laplace import domain_center  # noqa: E402
from rbslam_tpu.engines import run_ekf_dense as jrun_ekf  # noqa: E402
from rbslam_tpu.engines import (  # noqa: E402
    run_ekf_dense_batched as jrun_ekf_batched,
)
from rbslam_tpu.math.linalg import psd_cholesky as jpsd_cholesky  # noqa: E402
from rbslam_tpu.math.quaternions import mcross as jmcross  # noqa: E402
from rbslam_tpu.metrics import (  # noqa: E402
    orientation_rmse_deg as jorientation_rmse_deg,
)
from rbslam_tpu.metrics import rms as jrms  # noqa: E402
from rbslam_tpu.ops.kalman import (  # noqa: E402
    _kalman_update_dense_batched_lax as jlax,
)
from rbslam_tpu.ops.kalman import (  # noqa: E402
    kalman_update_dense_batched_hld as jhld,
)
from rbslam_tpu.ops import kalman as jkalman  # noqa: E402
from rbslam_tpu_torch.engines import (  # noqa: E402
    run_ekf_dense,
    run_ekf_dense_batched,
)
from rbslam_tpu_torch.math import mcross, psd_cholesky  # noqa: E402
from rbslam_tpu_torch.metrics import orientation_rmse_deg, rms  # noqa: E402
from rbslam_tpu_torch.ops import kalman as tkalman  # noqa: E402
from rbslam_tpu_torch.ops.kalman import (  # noqa: E402
    _kalman_update_dense_batched_lax,
    kalman_update_dense_batched_hld,
)
from rbslam_tpu_torch.utils import ekf_inputs, problem_from_numpy  # noqa: E402

B = 3


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def ekf():
    """One JAX dataset, both packages' EKF inputs, and B batch members."""
    data, _, potential, k, Q, R = bench._build_problem(27, 4, 16)
    b = potential.basis
    center = np.asarray(jnp.asarray(domain_center(data.LL), jnp.float32))
    prob = problem_from_numpy(
        b.NN, b.L, b.eigenvalues, center, np.asarray(k), np.asarray(Q),
        np.asarray(R), 0.01, np.asarray(data.dx), np.asarray(data.y),
        np.asarray(data.init_state), device="cpu",
    )
    n_lin = potential.n_lin
    jx0 = jnp.concatenate([data.init_state[:3] - jnp.asarray(center),
                           jnp.zeros(3 + n_lin)])
    jq0 = data.init_state[3:7]
    jP0 = jnp.zeros((6 + n_lin, 6 + n_lin)).at[6:, 6:].set(jnp.diag(k))
    rng = np.random.default_rng(3)
    dx_b = np.stack([np.asarray(data.dx)] * B)
    dx_b[:, :, :3] += 0.01 * rng.normal(size=(B, dx_b.shape[1], 3))
    y_b = np.asarray(data.y)[None] + rng.normal(size=(B, 16, 3)) \
        + np.array([[[0.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]], [[0.0, 5.0, 0.0]]])
    return {"data": data, "potential": potential, "prob": prob,
            "center": center, "jargs": (jx0, jq0, jP0, Q, R, 0.01),
            "dx_b": dx_b.astype(np.float32), "y_b": y_b.astype(np.float32)}


def test_hessians_match_jax(ekf):
    rng = np.random.default_rng(0)
    L = np.asarray(ekf["potential"].basis.L)
    x = (rng.uniform(-0.9, 0.9, size=(5, 3)) * L).astype(np.float32)
    port = ekf["prob"].potential
    ref = ekf["potential"]
    H = port.basis.hess_phi(_t(x))
    assert H.shape == (5, 3, 3, port.basis.m)
    np.testing.assert_allclose(_np(H), _np(ref.basis.hess_phi(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    Hb = port.hess_blocks(_t(x))
    assert Hb.shape == (5, 3, 3, port.n_lin)
    np.testing.assert_allclose(_np(Hb), _np(ref.hess_blocks(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    assert not bool(Hb[..., :3].any())
    # the Hessian is the derivative of the gradient (central differences
    # in float64)
    x64 = torch.tensor(x[0], dtype=torch.float64)
    h = 1e-6
    for j in range(3):
        d = torch.zeros(3, dtype=torch.float64)
        d[j] = h
        fd = (port.basis.grad_phi(x64 + d) - port.basis.grad_phi(x64 - d)) \
            / (2 * h)
        np.testing.assert_allclose(_np(port.basis.hess_phi(x64)[:, j]),
                                   _np(fd), rtol=1e-5, atol=1e-6)


def test_mcross_matches_jax():
    v = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    M = mcross(_t(v))
    np.testing.assert_allclose(_np(M), _np(jmcross(jnp.asarray(v))), atol=1e-7)
    w = _t(v[::-1].copy())
    np.testing.assert_allclose(_np(torch.einsum("bij,bj->bi", M, w)),
                               _np(torch.linalg.cross(_t(v), w)), atol=1e-6)


def test_orientation_rmse_matches_jax(ekf):
    rng = np.random.default_rng(2)
    truth = np.asarray(ekf["data"].quat, np.float32)
    est = truth + 0.02 * rng.normal(size=truth.shape).astype(np.float32)
    est /= np.linalg.norm(est, axis=-1, keepdims=True)
    port = orientation_rmse_deg(truth, _t(est))
    assert port.shape == (3,)
    np.testing.assert_allclose(
        _np(port), _np(jorientation_rmse_deg(jnp.asarray(truth),
                                             jnp.asarray(est))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_rms_axis_matches_jax(axis):
    """rms(x, axis=...) as JAX's, on a tensor and on a numpy array, and
    rms(x, dim=...) the same: rtol 1e-6."""
    x = np.random.default_rng(3).normal(size=(5, 7, 3)).astype(np.float32)
    ref = np.asarray(jrms(jnp.asarray(x), axis=axis))
    for port in (rms(_t(x), axis=axis), rms(x, axis=axis), rms(_t(x), axis),
                 rms(_t(x), dim=axis)):
        np.testing.assert_allclose(_np(port), ref, rtol=1e-6)
    np.testing.assert_allclose(_np(rms(_t(x))), np.asarray(jrms(x)),
                               rtol=1e-6)


def test_psd_cholesky_repairs_per_batch_member():
    """One indefinite and one definite matrix in a batch: the definite
    member keeps the factor it has alone and only the other is flagged, as
    under jax.vmap in the JAX package's batched EKF."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(4, 4)).astype(np.float32)
    good = A @ A.T + 4 * np.eye(4, dtype=np.float32)
    slightly = good.copy()
    slightly[0, 0] = -1e-4           # repaired by the fixed jitter
    bad = -good                       # needs the Gershgorin shift
    for other in (slightly, bad):
        batch = _t(np.stack([other, good]))
        L, retried = psd_cholesky(batch, 1e-3)
        L_alone, r_alone = psd_cholesky(_t(good), 1e-3)
        assert retried.tolist() == [True, False] and not bool(r_alone)
        assert torch.equal(L[1], L_alone)
        assert bool(torch.isfinite(L).all())
        jL, jret = jpsd_cholesky(jnp.asarray(np.stack([other, good])), 1e-3)
        assert np.asarray(jret).tolist() == [True, False]
        np.testing.assert_allclose(_np(L), _np(jL), rtol=1e-4, atol=1e-5)


def _ny4_inputs(dtype, seed=5, n=6, nl=12, ny=4):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, nl, nl)).astype(np.float32)
    P = 0.1 * (A @ A.transpose(0, 2, 1)) + np.eye(nl, dtype=np.float32)
    C = (0.5 * rng.normal(size=(n, ny, nl))).astype(np.float32)
    xl = rng.normal(size=(n, nl)).astype(np.float32)
    y = rng.normal(size=(ny,)).astype(np.float32)
    R = (0.3 * np.eye(ny)).astype(np.float32)
    return C, P, xl, y, R


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("joseph", [False, True])
@pytest.mark.parametrize("symmetrize_out", [True, False])
def test_lax_update_matches_jax_at_ny4(dtype, joseph, symmetrize_out):
    C, P, xl, y, R = _ny4_inputs(dtype)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    port = _kalman_update_dense_batched_lax(
        _t(C), _t(P).to(td), _t(xl), _t(y), _t(R), 1e-3, joseph,
        symmetrize_out)
    ref = jlax(jnp.asarray(C), jnp.asarray(P).astype(dtype), jnp.asarray(xl),
               jnp.asarray(y), jnp.asarray(R), 1e-3, joseph, symmetrize_out)
    assert port[1].dtype == td
    tol = 1e-4 if dtype == "float32" else 2.0**-7
    for name, a, b in zip(("xl", "P", "logw", "retried", "hld"), port, ref):
        a = _np(a.float() if a.dtype != torch.bool else a)
        b = np.asarray(b.astype("float32") if b.dtype != bool else b)
        if name == "retried":
            assert np.array_equal(a, b)
            continue
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0), name


def _one_particle(ny, indefinite):
    """One particle's C [ny, 12], P, xl, y, R (float32); ``indefinite``
    makes R strongly negative so that S = C P C' + R is not positive
    definite and the factorization takes the jitter retry."""
    C, P, xl, y, R = _ny4_inputs("float32", seed=11, n=1, ny=ny)
    if indefinite:
        R = R - 50.0 * np.eye(ny, dtype=np.float32)
    return C[0], P[0], xl[0], y, R


@pytest.mark.parametrize("ny", [3, 4])
@pytest.mark.parametrize("indefinite", [False, True])
def test_one_particle_dense_forms_match_jax(ny, indefinite):
    """innovation_cov and dense_log_weights (the one-particle forms of
    rbslam_tpu/ops/kalman.py:37-51) against JAX's: 1e-5 of each output's
    scale, retried equal (True with the indefinite S)."""
    C, P, xl, y, R = _one_particle(ny, indefinite)
    S, CP = tkalman.innovation_cov(_t(C), _t(P), _t(R))
    jS, jCP = jkalman.innovation_cov(*map(jnp.asarray, (C, P, R)))
    port = tkalman.dense_log_weights(*map(_t, (C, P, xl, y, R)), 1e-3)
    ref = jkalman.dense_log_weights(*map(jnp.asarray, (C, P, xl, y, R)),
                                    1e-3)
    assert bool(port[4]) == bool(ref[4]) == indefinite
    for name, a, b in zip(("S", "CP", "logw", "e", "L", "CP"),
                          (S, CP) + port[:4], (jS, jCP) + ref[:4]):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("joseph", [False, True])
@pytest.mark.parametrize("indefinite", [False, True])
def test_kalman_update_dense_matches_jax_and_batched(joseph, indefinite):
    """kalman_update_dense (one particle, ny = 3) against JAX's at 1e-4 of
    each output's scale, retried equal; and against row 0 of the port's
    batched update, which shares its arithmetic up to the order of the
    products (1e-4 of the scale), where S needs no retry (the batched
    form's closed-form retry scales its jitter by S's diagonal)."""
    C, P, xl, y, R = _one_particle(3, indefinite)
    port = tkalman.kalman_update_dense(*map(_t, (C, P, xl, y, R)), 1e-3,
                                       joseph=joseph)
    ref = jkalman.kalman_update_dense(*map(jnp.asarray, (C, P, xl, y, R)),
                                      1e-3, joseph=joseph)
    assert bool(port[3]) == bool(ref[3]) == indefinite
    assert port[1].shape == (12, 12) and port[0].shape == (12,)
    for name, a, b in zip(("xl", "P", "logw"), port[:3], ref[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)
    if not indefinite:
        batched = tkalman.kalman_update_dense_batched(
            _t(C[None]), _t(P[None]), _t(xl[None]), _t(y), _t(R), 1e-3,
            joseph)
        for name, a, b in zip(("xl", "P", "logw"), port[:3], batched[:3]):
            b = _np(b[0])
            np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(b).max(), 1.0),
                                       err_msg=name)


def test_dispatch_by_observation_rows():
    """ny <= 3 takes the small form, ny = 4 the lax form, in both
    packages; the lax form's retry repairs an indefinite S."""
    C, P, xl, y, R = _ny4_inputs("float32")
    port = kalman_update_dense_batched_hld(_t(C), _t(P), _t(xl), _t(y),
                                           _t(R), 1e-3)
    lax = _kalman_update_dense_batched_lax(_t(C), _t(P), _t(xl), _t(y),
                                           _t(R), 1e-3, False, True)
    for a, b in zip(port, lax):
        assert torch.equal(a, b)
    ref = jhld(jnp.asarray(C), jnp.asarray(P), jnp.asarray(xl),
               jnp.asarray(y), jnp.asarray(R), 1e-3)
    np.testing.assert_allclose(_np(port[2]), _np(ref[2]), atol=1e-4)
    # indefinite S on particle 0: flagged there and nowhere else, finite
    Pbad = _t(P).clone()
    Pbad[0] = -Pbad[0]
    out = kalman_update_dense_batched_hld(_t(C), Pbad, _t(xl), _t(y), _t(R),
                                          1e-3)
    jout = jhld(jnp.asarray(C), jnp.asarray(_np(Pbad)), jnp.asarray(xl),
                jnp.asarray(y), jnp.asarray(R), 1e-3)
    assert out[3].tolist() == np.asarray(jout[3]).tolist()
    assert out[3][0] and not bool(out[3][1:].any())
    assert bool(torch.isfinite(out[2]).all())


def _assert_ekf_close(port, ref):
    np.testing.assert_allclose(_np(port.x_traj), _np(ref.x_traj), atol=1e-3)
    np.testing.assert_allclose(_np(port.q_traj), _np(ref.q_traj), atol=1e-4)
    scale = float(np.abs(_np(ref.P_final)).max())
    np.testing.assert_allclose(_np(port.P_final), _np(ref.P_final),
                               atol=1e-3 * scale)
    np.testing.assert_array_equal(_np(port.chol_retries),
                                  _np(ref.chol_retries))


def test_ekf_matches_jax(ekf):
    prob, data = ekf["prob"], ekf["data"]
    x0, q0, P0 = ekf_inputs(prob, ekf["center"])
    port = run_ekf_dense(prob.potential, prob.dx, prob.y, x0, q0, P0,
                         prob.Q, prob.R, prob.dt, device="cpu")
    ref = jrun_ekf(ekf["potential"], data.dx, data.y, *ekf["jargs"])
    n = 6 + prob.potential.n_lin
    assert port.x_traj.shape == (16, n) and port.q_traj.shape == (16, 4)
    assert port.P_final.shape == (n, n) and port.chol_retries.shape == ()
    assert not bool(port.x_traj[:, 3:6].any())
    _assert_ekf_close(port, ref)


@pytest.mark.parametrize("per_member_x0", [False, True])
def test_batched_ekf_matches_jax(ekf, per_member_x0):
    prob = ekf["prob"]
    x0, q0, P0 = ekf_inputs(prob, ekf["center"])
    jx0, jq0, jP0, Q, R, dt = ekf["jargs"]
    if per_member_x0:
        shift = np.zeros((B, x0.shape[0]), np.float32)
        shift[:, :3] = 0.05 * np.arange(B)[:, None]
        x0 = x0[None] + _t(shift)
        jx0 = jx0[None] + jnp.asarray(shift)
        q0 = q0.expand(B, 4)
        jq0 = jnp.broadcast_to(jq0, (B, 4))
    port = run_ekf_dense_batched(prob.potential, ekf["dx_b"], ekf["y_b"], x0,
                                 q0, P0, prob.Q, prob.R, prob.dt,
                                 device="cpu")
    ref = jrun_ekf_batched(ekf["potential"], jnp.asarray(ekf["dx_b"]),
                           jnp.asarray(ekf["y_b"]), jx0, jq0, jP0, Q, R, dt)
    assert port.x_traj.shape == (B, 16, x0.shape[-1])
    assert port.chol_retries.shape == (B,)
    assert port.chol_retries.dtype == torch.int32
    _assert_ekf_close(port, ref)


def test_batched_ekf_equals_sequential(ekf):
    prob = ekf["prob"]
    x0, q0, P0 = ekf_inputs(prob, ekf["center"])
    args = (x0, q0, P0, prob.Q, prob.R, prob.dt)
    batched = run_ekf_dense_batched(prob.potential, ekf["dx_b"], ekf["y_b"],
                                    *args, device="cpu")
    for i in range(B):
        one = run_ekf_dense(prob.potential, ekf["dx_b"][i], ekf["y_b"][i],
                            *args, device="cpu")
        for a, b in zip(one, batched):
            np.testing.assert_allclose(_np(a), _np(b[i]), rtol=1e-5,
                                       atol=1e-5)


def test_time_varying_noise_and_bad_shapes(ekf):
    """Q [T-1, 6, 6] and dt [T-1] give what the constant ones give; wrong
    shapes raise."""
    prob = ekf["prob"]
    x0, q0, P0 = ekf_inputs(prob, ekf["center"])
    const = run_ekf_dense(prob.potential, prob.dx, prob.y, x0, q0, P0,
                          prob.Q, prob.R, prob.dt, device="cpu")
    varying = run_ekf_dense(
        prob.potential, prob.dx, prob.y, x0, q0, P0, prob.Q.expand(15, 6, 6),
        prob.R, torch.full((15,), prob.dt), device="cpu")
    assert torch.equal(const.x_traj, varying.x_traj)
    with pytest.raises(ValueError, match="dx must be"):
        run_ekf_dense_batched(prob.potential, prob.dx, prob.y, x0, q0, P0,
                              prob.Q, prob.R, prob.dt, device="cpu")


@pytest.mark.gpu
def test_ekf_rejects_tf32_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the TF32 switch only matters "
                    "there")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            run_ekf_dense_batched(None, torch.zeros(1, 1, 7),
                                  torch.zeros(1, 2, 3), torch.zeros(9),
                                  torch.zeros(4), torch.zeros(9, 9),
                                  torch.eye(6), torch.eye(3), 0.01)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
