"""The port's foundations (math, basis, small-ny Kalman algebra) against the
JAX package on the same numpy inputs.

Tolerances: float32 results agree to rtol 1e-5 (the two frameworks order
float32 sums differently); a bf16 covariance agrees within one bf16
rounding of the output's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rbslam_tpu import basis as jbasis  # noqa: E402
from rbslam_tpu.basis import spectral as jspectral  # noqa: E402
from rbslam_tpu.math import linalg as jlinalg  # noqa: E402
from rbslam_tpu.math import quaternions as jquat  # noqa: E402
from rbslam_tpu.ops import kalman as jkalman  # noqa: E402
from rbslam_tpu_torch import basis as tbasis  # noqa: E402
from rbslam_tpu_torch.basis import spectral as tspectral  # noqa: E402
from rbslam_tpu_torch.math import linalg as tlinalg  # noqa: E402
from rbslam_tpu_torch.math import quaternions as tquat  # noqa: E402
from rbslam_tpu_torch.ops import kalman as tkalman  # noqa: E402

RTOL = 1e-5


def t(a):
    return torch.tensor(np.asarray(a))


def close(port, ref, rtol=RTOL, atol=None):
    ref = np.asarray(ref, np.float64)
    port = port.double().numpy() if isinstance(port, torch.Tensor) else port
    if atol is None:
        atol = rtol * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_logsumexp_normalize_and_ess():
    rng = np.random.default_rng(0)
    logw = (3.0 * rng.normal(size=(4, 257))).astype(np.float32)
    logw[0, :5] = -np.inf                     # dead particles stay finite
    for p, r in zip(tlinalg.logsumexp_normalize(t(logw)),
                    jlinalg.logsumexp_normalize(jnp.asarray(logw))):
        r = np.asarray(r)
        fin = np.isfinite(r)
        assert np.array_equal(np.isfinite(p.numpy()), fin)
        close(p.numpy()[fin], r[fin])
    close(tlinalg.ess_from_logw(t(logw)),
          jlinalg.ess_from_logw(jnp.asarray(logw)))


def test_symmetrize():
    A = np.random.default_rng(1).normal(size=(3, 9, 9)).astype(np.float32)
    close(tlinalg.symmetrize(t(A)), jlinalg.symmetrize(jnp.asarray(A)))


@pytest.mark.parametrize("fn", ["qmul", "qinv", "expq", "quat_to_rmat",
                                "rmat_to_quat", "qleft", "qright"])
def test_quaternions(fn):
    rng = np.random.default_rng(2)
    q1, q2 = unit_quats(rng, 64), unit_quats(rng, 64)
    phi = (0.7 * rng.normal(size=(64, 3))).astype(np.float32)
    phi[0] = 0.0                               # the sinc branch at |phi| = 0
    args = {
        "qmul": (q1, q2), "qinv": (q1,), "expq": (phi,),
        "quat_to_rmat": (q1,), "qleft": (q1,), "qright": (q1,),
        "rmat_to_quat": (np.asarray(jquat.quat_to_rmat(jnp.asarray(q1))),),
    }[fn]
    port = getattr(tquat, fn)(*map(t, args))
    ref = getattr(jquat, fn)(*map(jnp.asarray, args))
    close(port, ref)


def test_broadcast_qmul():
    rng = np.random.default_rng(3)
    q1, q2 = unit_quats(rng, 1)[0], unit_quats(rng, 16)
    close(tquat.qmul(t(q1)[None], t(q2)),
          jquat.qmul(jnp.asarray(q1)[None], jnp.asarray(q2)))


def _bases(m=29):
    LL = np.array([[-9.0, -7.5, -2.4], [8.0, 6.5, 2.4]])
    return tbasis.hypercube_basis(m, LL), jbasis.hypercube_basis(m, LL), LL


def test_product_matrices_batched():
    """qleft(q) @ p == qmul(q, p) and qright(q) @ p == qmul(p, q) over two
    leading axes, and each equals JAX's matrix; rtol 1e-5."""
    rng = np.random.default_rng(4)
    q = t(unit_quats(rng, 12).reshape(3, 4, 4))
    p = t(unit_quats(rng, 12).reshape(3, 4, 4))
    left, right = tquat.qleft(q), tquat.qright(q)
    assert left.shape == right.shape == (3, 4, 4, 4)
    close(torch.einsum("...ij,...j->...i", left, p), tquat.qmul(q, p))
    close(torch.einsum("...ij,...j->...i", right, p), tquat.qmul(p, q))
    close(left, jquat.qleft(jnp.asarray(q.numpy())))
    close(right, jquat.qright(jnp.asarray(q.numpy())))


def test_basis_index_selection():
    tb, jb, LL = _bases(61)
    np.testing.assert_array_equal(tb.NN, jb.NN)
    np.testing.assert_array_equal(tb.eigenvalues, jb.eigenvalues)
    np.testing.assert_array_equal(tbasis.domain_center(LL),
                                  jbasis.laplace.domain_center(LL))


@pytest.mark.parametrize("fn", ["phi", "grad_phi", "grad_blocks",
                                "potential_row"])
def test_basis_evaluation(fn):
    tb, jb, _ = _bases()
    x = np.random.default_rng(4).uniform(
        -6.0, 6.0, size=(33, 3)).astype(np.float32)
    if fn in ("phi", "grad_phi"):
        port = getattr(tb, fn)(t(x))
        ref = getattr(jb, fn)(jnp.asarray(x))
    else:
        port = getattr(tbasis.ScalarPotentialBasis(tb), fn)(t(x))
        ref = getattr(jbasis.ScalarPotentialBasis(jb), fn)(jnp.asarray(x))
    close(port, ref)


def test_spectral_densities():
    w = np.sqrt(_bases()[1].eigenvalues).astype(np.float32)
    close(tspectral.se_spectral_density(t(w), 1.2, 200.0, 3),
          jspectral.se_spectral_density(jnp.asarray(w), 1.2, 200.0, 3))
    close(tspectral.linear_plus_se_spectral(t(w), 650.0, 1.2, 200.0, 3),
          jspectral.linear_plus_se_spectral(jnp.asarray(w), 650.0, 1.2,
                                            200.0, 3))


def _spd_batch(rng, n, ny, indefinite=False):
    A = rng.normal(size=(n, ny, ny)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(ny, dtype=np.float32)
    if indefinite:
        S[: n // 2] -= 4.0 * np.eye(ny, dtype=np.float32)
    return S


@pytest.mark.parametrize("ny", [1, 2, 3])
@pytest.mark.parametrize("indefinite", [False, True])
def test_small_cholesky_solve_inverse(ny, indefinite):
    rng = np.random.default_rng(5 + ny)
    S = _spd_batch(rng, 64, ny, indefinite)
    b = rng.normal(size=(64, ny)).astype(np.float32)
    Lt, bad_t = tkalman._chol_small_batched(t(S), 1e-3)
    Lj, bad_j = jkalman._chol_small_batched(jnp.asarray(S), 1e-3)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert bad_t.any().item() == indefinite
    ok = np.isfinite(np.asarray(Lj)).all(axis=(1, 2))
    close(Lt.numpy()[ok], np.asarray(Lj)[ok])
    Lok = np.asarray(Lj)[ok]
    close(tkalman._tri_solve_small_batched(t(Lok), t(b[ok])),
          jkalman._tri_solve_small_batched(jnp.asarray(Lok),
                                           jnp.asarray(b[ok])))
    close(tkalman._Li_from_chol_small_batched(t(Lok)),
          jkalman._Li_from_chol_small_batched(jnp.asarray(Lok)))
    close(tkalman._inv_from_chol_small_batched(t(Lok)),
          jkalman._inv_from_chol_small_batched(jnp.asarray(Lok)))


@pytest.mark.parametrize("ny", [1, 3])
@pytest.mark.parametrize("cov_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetrize_out", [True, False])
def test_kalman_update_dense_batched(ny, cov_dtype, symmetrize_out):
    """The small-ny dense update (step 0 of the lowrank path): f32 C against
    an f32 or bf16 covariance, contracting P's last axis."""
    rng = np.random.default_rng(11 + ny)
    N, nl = 16, 40
    A = (0.2 * rng.normal(size=(N, nl, nl))).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + np.eye(nl, dtype=np.float32)
    xl = rng.normal(size=(N, nl)).astype(np.float32)
    C = (0.5 * rng.normal(size=(N, ny, nl))).astype(np.float32)
    y = rng.normal(size=(ny,)).astype(np.float32)
    R = (0.5 * np.eye(ny)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cov_dtype]
    Pt = t(P).to(tdt)
    Pj = jnp.asarray(P).astype(jnp.dtype(cov_dtype))
    port = tkalman.kalman_update_dense_batched(
        t(C), Pt, t(xl), t(y), t(R), 1e-3, symmetrize_out=symmetrize_out)
    ref = jkalman.kalman_update_dense_batched(
        jnp.asarray(C), Pj, jnp.asarray(xl), jnp.asarray(y), jnp.asarray(R),
        1e-3, symmetrize_out=symmetrize_out)
    assert port[1].dtype == tdt
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    if cov_dtype == "float32":
        for p, r in zip(port[:3], ref[:3]):
            close(p, r)
    else:
        # one bf16 rounding of P's scale, carried into the f32 outputs
        scale = float(np.abs(P).max())
        close(port[1].float(), np.asarray(ref[1].astype(jnp.float32)),
              atol=2 ** -7 * scale)
        close(port[0], ref[0], rtol=1e-4)
        close(port[2], ref[2], rtol=1e-4)


def test_kalman_update_joseph():
    rng = np.random.default_rng(17)
    N, nl, ny = 8, 24, 3
    A = (0.2 * rng.normal(size=(N, nl, nl))).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + np.eye(nl, dtype=np.float32)
    xl = rng.normal(size=(N, nl)).astype(np.float32)
    C = (0.5 * rng.normal(size=(N, ny, nl))).astype(np.float32)
    y = rng.normal(size=(ny,)).astype(np.float32)
    R = (0.5 * np.eye(ny)).astype(np.float32)
    port = tkalman.kalman_update_dense_batched(
        t(C), t(P), t(xl), t(y), t(R), 1e-3, joseph=True)
    ref = jkalman.kalman_update_dense_batched(
        *map(jnp.asarray, (C, P, xl, y, R)), 1e-3, joseph=True)
    for p, r in zip(port[:3], ref[:3]):
        close(p, r, rtol=1e-4)
