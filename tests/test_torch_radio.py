"""The dense-radio slice of the port against the JAX package, on the CPU.

Kernels: phi_basis (K6) at d in {2, 3} against phi_basis_pallas,
grad_basis (K4) at d in {1, 2} against grad_basis_pallas, mag3d_jacobian
(K7) against mag3d_jacobian_pallas (the Pallas entries run in interpret
mode on the CPU; atol 1e-4 / 1e-3 as tests/test_kernels.py, the port's
plain versions in fact agree to 1e-5). On the CPU each wrapper runs its
plain version; the CUDA kernels are held to the plain versions on the
card (tests/test_torch_kernels.py, marker gpu).

Model, data and metrics: radio2d's dynamics, residual and Jacobian; the
line and square trajectories; the scalar field draw and the heading
family of simulate_dense_dataset given JAX's own normals; Procrustes and
the aligned RMSE.

Slice: line_3D, T=12, m=32, N_P=16, multinomial resampling, heading spike
at T/2; the filter, run_rbps (3 sweeps) and run_rbps_information_form
(woodbury, cholesky, suffix_precompute off) with JAX's draws injected.
The JAX model runs with use_pallas_basis=True, so its Jacobians go
through the Pallas phi kernel as the port's go through K6. Tolerances as
tests/test_torch_smoothers.py: XNK 1e-4, XLK 1e-3, PK 1e-3 of its scale,
ess rtol 1e-3; the filter as tests/test_torch_rbpf.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rbslam_tpu.basis import hypercube_basis as jhypercube_basis  # noqa: E402
from rbslam_tpu.basis import se_spectral_density as jse_density  # noqa: E402
from rbslam_tpu.basis.laplace import domain_center  # noqa: E402
from rbslam_tpu.data import generate_trajectory as jgenerate  # noqa: E402
from rbslam_tpu.data import simulate_dense_dataset as jsimulate  # noqa: E402
from rbslam_tpu.data.fields import draw_scalar_field as jdraw  # noqa: E402
from rbslam_tpu.engines import RBPFConfig as JFConfig  # noqa: E402
from rbslam_tpu.engines import RBPSConfig as JSConfig  # noqa: E402
from rbslam_tpu.engines import run_rbpf as jrun_rbpf  # noqa: E402
from rbslam_tpu.engines import run_rbps as jrun_rbps  # noqa: E402
from rbslam_tpu.engines import (  # noqa: E402
    run_rbps_information_form as jrun_info,
)
from rbslam_tpu.kernels import (  # noqa: E402
    grad_basis_pallas,
    mag3d_jacobian_pallas,
    phi_basis_pallas,
)
from rbslam_tpu.math.procrustes import procrustes as jprocrustes  # noqa: E402
from rbslam_tpu.metrics import (  # noqa: E402
    aligned_position_rmse as jaligned_rmse,
)
from rbslam_tpu.models import make_radio2d_model as jmake_radio  # noqa: E402
from rbslam_tpu.workloads import dense_radio as jworkload  # noqa: E402
from rbslam_tpu_torch.basis import hypercube_basis  # noqa: E402
from rbslam_tpu_torch.data import (  # noqa: E402
    draw_scalar_field,
    generate_trajectory,
    simulate_dense_dataset,
)
from rbslam_tpu_torch.engines import (  # noqa: E402
    RBPFConfig,
    RBPSConfig,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from rbslam_tpu_torch.kernels import (  # noqa: E402
    grad_basis,
    mag3d_jacobian,
    mag3d_jacobian_rows,
    pack_basis_constants,
    phi_basis,
)
from rbslam_tpu_torch.math.procrustes import procrustes  # noqa: E402
from rbslam_tpu_torch.metrics import aligned_position_rmse  # noqa: E402
from rbslam_tpu_torch.models import make_radio2d_model  # noqa: E402
from rbslam_tpu_torch.utils import radio_problem_from_numpy  # noqa: E402
from rbslam_tpu_torch.workloads import dense_radio as tworkload  # noqa: E402

from test_torch_smoothers import (  # noqa: E402
    assert_margins,
    assert_smoothers_match,
    dyn_normals,
    record_margins,
    smoother_noise,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THETA = (0.25, 2.0, 0.01)
N_P, T_STEPS, N_K, M_EST = 16, 12, 3, 32
# the key of the slice runs: of PRNGKey(0..29) the one whose ancestor draws
# stay furthest from a CDF edge in every smoother case (printed per test)
SEED = 20
LL_BY_D = {1: np.array([2.0]), 2: np.array([2.0, 1.5]),
           3: np.array([2.0, 2.0, 1.0])}


def t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- kernels ------------------------------------------------------------------

@pytest.mark.parametrize("d,m,n", [(2, 128, 100), (2, 40, 37), (3, 61, 53),
                                   (1, 17, 9)])
def test_phi_basis_matches_jax(d, m, n):
    L = LL_BY_D[d]
    x = np.random.default_rng(d).uniform(-1.0, 1.0, size=(n, d)) * L
    x = x.astype(np.float32)
    basis = hypercube_basis(m, L)
    port = phi_basis(pack_basis_constants(basis, "cpu"), t(x))
    ref = np.asarray(phi_basis_pallas(jhypercube_basis(m, L), jnp.asarray(x)))
    assert port.shape == (n, m) and port.dtype == torch.float32
    try:
        np.testing.assert_allclose(port.numpy(), ref, atol=1e-4)
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    except AssertionError as e:
        # say which side moved: both against a float64 evaluation
        exact = basis.phi(t(x).double()).numpy()
        far = {side: float(np.abs(v.astype(np.float64) - exact).max())
               for side, v in (("port", port.numpy()), ("jax", ref))}
        raise AssertionError(
            f"{e}\nmax |value - float64 evaluation|: port {far['port']:.3e}"
            f", jax {far['jax']:.3e} (the side further from it moved)"
        ) from None
    # and the basis' own evaluation (another rounding of the phase)
    np.testing.assert_allclose(port.numpy(), basis.phi(t(x)).numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d,m,n", [(2, 40, 37), (1, 17, 9)])
def test_grad_basis_low_dim_matches_jax(d, m, n):
    L = LL_BY_D[d]
    x = np.random.default_rng(10 + d).uniform(-1.0, 1.0, size=(n, d)) * L
    x = x.astype(np.float32)
    basis = hypercube_basis(m, L)
    port = grad_basis(pack_basis_constants(basis, "cpu"), t(x))
    ref = np.asarray(grad_basis_pallas(jhypercube_basis(m, L),
                                       jnp.asarray(x)))
    assert port.shape == (n, d, m)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), basis.grad_phi(t(x)).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mag3d_jacobian_matches_jax():
    rng = np.random.default_rng(7)
    n, m = 37, 61
    pos = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    consts = pack_basis_constants(hypercube_basis(m, LL_BY_D[3]), "cpu")
    port = mag3d_jacobian(consts, t(pos), t(q), 128)
    ref = np.asarray(mag3d_jacobian_pallas(
        jhypercube_basis(m, LL_BY_D[3]), jnp.asarray(pos), jnp.asarray(q),
        128))
    assert port.shape == (3, n, 128) and port.is_contiguous()
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-3)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port[:, :, 3 + m:].numpy(), 0.0)
    # the rows layout (K1) transposed, bit for bit
    rows = mag3d_jacobian_rows(consts, t(pos), t(q), 128)
    assert torch.equal(port, rows.transpose(0, 1))
    # any nl_pad >= 3 + m is served (the reference needs a multiple of 128)
    assert mag3d_jacobian(consts, t(pos), t(q), 3 + m).shape == (3, n, 3 + m)


def test_basis_kernel_arguments_checked():
    consts2 = pack_basis_constants(hypercube_basis(8, LL_BY_D[2]), "cpu")
    consts3 = pack_basis_constants(hypercube_basis(8, LL_BY_D[3]), "cpu")
    with pytest.raises(ValueError, match="shape"):
        phi_basis(consts2, torch.zeros((4, 3)))
    with pytest.raises(TypeError, match="float32"):
        phi_basis(consts2, torch.zeros((4, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="3-D basis"):
        mag3d_jacobian(consts2, torch.zeros((4, 3)), torch.zeros((4, 4)), 16)
    with pytest.raises(ValueError, match="nl_pad"):
        mag3d_jacobian(consts3, torch.zeros((4, 3)), torch.zeros((4, 4)), 8)
    assert phi_basis(consts2, torch.zeros((0, 2))).shape == (0, 8)


# --- math, data ------------------------------------------------------------------

def test_procrustes_and_aligned_rmse_match_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 2)).astype(np.float32)
    th = 0.7
    Rm = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    Y = (1.7 * X @ Rm + np.array([0.3, -2.0])
         + 0.05 * rng.normal(size=X.shape)).astype(np.float32)
    Z, tf = procrustes(t(X), t(Y))
    Zj, tfj = jprocrustes(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(Z.numpy(), np.asarray(Zj), atol=1e-5)
    np.testing.assert_allclose(float(tf.b), float(tfj.b), rtol=1e-5)
    np.testing.assert_allclose(tf.T.numpy(), np.asarray(tfj.T), atol=1e-5)
    np.testing.assert_allclose(tf.c.numpy(), np.asarray(tfj.c), atol=1e-5)
    for per_axis in (False, True):
        np.testing.assert_allclose(
            _np(aligned_position_rmse(X, t(Y), per_axis=per_axis)),
            np.asarray(jaligned_rmse(jnp.asarray(X), jnp.asarray(Y),
                                     per_axis=per_axis)), rtol=1e-4)


@pytest.mark.parametrize("traj_type,kw", [("line_3D", {}),
                                          ("line_3D", {"n": 12}),
                                          ("square_3D", {}),
                                          ("square_3D", {"n": 16}),
                                          ("circle_2D", {}),
                                          ("bean_2D", {}),
                                          ("line_2D", {}),
                                          ("line_3D_withPos", {}),
                                          ("line_6D", {}),
                                          ("circle_6D", {}),
                                          ("bean_6D", {})])
def test_heading_trajectories_match_jax(traj_type, kw):
    """Every one of the nine TRAJECTORY_TYPES: positions and the initial
    state exact; the quaternions and their increments, float32 in both
    packages, within 1e-6 (as test_torch_rbpf.py::test_bean_6d_matches_jax),
    the rest of dx exact."""
    from rbslam_tpu.data import TRAJECTORY_TYPES as JTYPES
    from rbslam_tpu_torch.data import TRAJECTORY_TYPES

    assert list(TRAJECTORY_TYPES) == list(JTYPES)
    port, ref = generate_trajectory(traj_type, **kw), jgenerate(traj_type,
                                                                **kw)
    np.testing.assert_array_equal(port.pos, ref.pos)
    np.testing.assert_array_equal(port.init_state, ref.init_state)
    if ref.quat is None:
        assert port.quat is None
        np.testing.assert_array_equal(port.dx, ref.dx)
        return
    np.testing.assert_allclose(port.quat, ref.quat, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(port.dx[:, :3], ref.dx[:, :3])
    np.testing.assert_allclose(port.dx, ref.dx, rtol=1e-6, atol=1e-7)


def test_scalar_field_draw_matches_jax():
    """Given JAX's own normals (kw, kn = split(key)) the port's scalar SE
    field draw equals the JAX package's: 1e-5 of each output's scale."""
    LL = np.array([[-1.0, -2.5], [1.0, 2.5]])
    x = np.random.default_rng(1).uniform(-0.9, 0.9, size=(40, 2)) \
        * np.array([1.0, 2.5])
    x = x.astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jdraw(key, jnp.asarray(x), 64, LL, THETA)
    kw, kn = jax.random.split(key)
    z_w = np.asarray(jax.random.normal(kw, (64,), jnp.float32))
    z_n = np.asarray(jax.random.normal(kn, (40,), jnp.float32))
    port = draw_scalar_field(t(x), 64, LL, THETA, z_w=z_w, z_n=z_n)
    for field in ("weights", "f", "y"):
        r = np.asarray(getattr(ref, field))
        np.testing.assert_allclose(getattr(port, field).numpy(), r,
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=field)


def _process_noise(T):
    Qvec = 1e-6 * np.ones(T)
    Qvec[T // 2 - 1] = 0.3**2
    return Qvec[: T - 1].reshape(-1, 1, 1).astype(np.float32)


def _jax_dataset(T, m_sim=64, seed=1):
    gen = jmake_radio(jhypercube_basis(4, np.array([1.0, 1.0])))
    return jsimulate(jax.random.PRNGKey(seed), "line_3D", THETA,
                     jnp.asarray(_process_noise(T)), 1.0, gen.dynamics,
                     m_sim=m_sim, traj_kwargs={"n": T}, with_grid=False)


def test_heading_dataset_matches_jax():
    """simulate_dense_dataset, heading family, given JAX's normals
    (key_field, key_meas, key_odo = split(key, 3); the field splits
    key_field again; one scalar normal per odometry step from
    split(key_odo, T-1)): the noisy odometry, the measurements and the
    field weights agree to 1e-5."""
    T, m_sim = 12, 64
    ref = _jax_dataset(T, m_sim)
    key_field, _, key_odo = jax.random.split(jax.random.PRNGKey(1), 3)
    kw, kn = jax.random.split(key_field)
    z_w = np.asarray(jax.random.normal(kw, (m_sim,), jnp.float32))
    z_n = np.asarray(jax.random.normal(kn, (T,), jnp.float32))
    w_odo = np.stack([np.asarray(jax.random.normal(k, (), jnp.float32))
                      for k in jax.random.split(key_odo, T - 1)])[:, None]
    gen = make_radio2d_model(hypercube_basis(4, np.array([1.0, 1.0])),
                             device="cpu")
    port = simulate_dense_dataset(
        "line_3D", THETA, _process_noise(T), 1.0, gen.dynamics, m_sim=m_sim,
        traj_kwargs={"n": T}, normals=(z_w, z_n, w_odo))
    assert port.dx.shape == (T - 1, 3) and port.y.shape == (T, 1)
    np.testing.assert_array_equal(port.pos, ref.pos)
    np.testing.assert_allclose(port.LL, ref.LL, rtol=1e-12)
    for field in ("dx", "y", "init_state", "odometry_path", "field_weights",
                  "Q"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    # the same field again with new noise (the nMC > 1 path)
    again = simulate_dense_dataset(
        "line_3D", THETA, _process_noise(T), 1.0, gen.dynamics, m_sim=m_sim,
        traj_kwargs={"n": T}, field_weights=port.field_weights,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.field_weights, port.field_weights)
    assert float((again.y - port.y).abs().max()) < 1.0
    assert not torch.equal(again.y, port.y)


# --- the radio problem of both packages ------------------------------------------

@pytest.fixture(scope="module")
def radio():
    data = _jax_dataset(T_STEPS)
    basis = jhypercube_basis(M_EST, data.LL)
    center = jnp.asarray(domain_center(data.LL), jnp.float32)
    model = jmake_radio(basis, center=center, use_pallas_basis=True)
    k = jse_density(jnp.asarray(np.sqrt(basis.eigenvalues), jnp.float32),
                    THETA[0], THETA[1], 2)
    Q = jnp.asarray(_process_noise(T_STEPS))
    R = jnp.array([[THETA[2]]], jnp.float32)
    jargs = (model, data.dx, data.y, data.init_state, jnp.zeros(basis.m),
             jnp.diag(k), Q, R, 1.0)
    prob = radio_problem_from_numpy(
        basis.NN, basis.L, basis.eigenvalues, np.asarray(center),
        np.asarray(k), np.asarray(Q), np.asarray(R), 1.0,
        np.asarray(data.dx), np.asarray(data.y),
        np.asarray(data.init_state), device="cpu")
    return {"prob": prob, "jargs": jargs, "data": data}


def test_radio2d_model_matches_jax(radio):
    """Dynamics from the same normal, the whitened heading residual, the
    per-particle Jacobian and the K6-backed ensemble Jacobian."""
    jmodel, tmodel = radio["jargs"][0], radio["prob"].model
    assert (tmodel.n_nonlin, tmodel.n_lin, tmodel.ny, tmodel.n_noise) == \
        (3, M_EST, 1, 1)
    rng = np.random.default_rng(2)
    xn = rng.uniform(-1, 1, size=(9, 3)).astype(np.float32)
    u = np.array([0.1, -0.2, 0.05], np.float32)
    Q = np.array([[0.09]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 9)
    w = np.stack([np.asarray(jax.random.normal(k, (), jnp.float32))
                  for k in keys])[:, None]
    ref = jax.vmap(lambda k, x: jmodel.dynamics(k, x, jnp.asarray(u), 1.0,
                                                jnp.asarray(Q)))(
        keys, jnp.asarray(xn))
    port = tmodel.dynamics_batch(t(w), t(xn), t(u), torch.tensor(1.0), t(Q))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tmodel.dynamics(t(w[0]), t(xn[0]), t(u), 1.0, t(Q)).numpy(),
        np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    res = tmodel.dyn_residual(t(xn[4]), t(xn), t(u), torch.tensor(1.0), t(Q))
    jres = jax.vmap(lambda x: jmodel.dyn_residual(
        jnp.asarray(xn[4]), x, jnp.asarray(u), 1.0, jnp.asarray(Q)))(
            jnp.asarray(xn))
    assert res.shape == (9, 1)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tmodel.meas_jacobian(t(xn[0])).numpy(),
        np.asarray(jmodel.meas_jacobian(jnp.asarray(xn[0]))), rtol=1e-4,
        atol=1e-5)
    C = tmodel.meas_jacobian_batch(t(xn))
    assert C.shape == (9, 1, M_EST)
    np.testing.assert_allclose(
        C.numpy(), np.asarray(jmodel.meas_jacobian_batch(jnp.asarray(xn))),
        rtol=1e-5, atol=1e-5)


def filter_noise(key, T, n, n_noise, scheme):
    """The draws of JAX's filter (rbslam_tpu/engines/rbpf.py:436,453,523)."""
    key, _ = jax.random.split(key)
    shape = () if scheme == "systematic" else (n,)
    u, w = [], []
    for k in jax.random.split(key, T - 1):
        k_res, k_dyn = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_res, shape)))
        w.append(dyn_normals(k_dyn, n, n_noise))
    return np.stack(u), np.stack(w)


@pytest.mark.parametrize("scheme", ["multinomial", "systematic"])
def test_slice_radio_filter_matches_jax(radio, scheme):
    """run_rbpf on radio2d (ny=1, time-varying Q [T-1, 1, 1]): ancestors and
    retries equal; trajectories atol 1e-4; map 1e-3; ess rtol 1e-3."""
    key = jax.random.PRNGKey(SEED)
    ref = jrun_rbpf(key, *radio["jargs"],
                    JFConfig(n_particles=N_P, resampling=scheme))
    port = run_rbpf(*radio["prob"].rbpf_args(),
                    RBPFConfig(n_particles=N_P, resampling=scheme),
                    generator=None, device="cpu",
                    noise=filter_noise(key, T_STEPS, N_P, 1, scheme))
    assert port.traj_mean.shape == (T_STEPS, 3)
    assert port.xn_traj.shape == (T_STEPS, N_P, 3)
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))
    assert int(port.chol_retries) == int(ref.chol_retries)
    for field in ("traj_mean", "xn_traj", "xn_hist"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=1e-4,
                                   err_msg=field)
    # traj_max at the step right after the heading spike is left out: the
    # new headings are not observable yet, every particle still shares its
    # position to ~1e-3, the weights tie to float noise and the last ulp
    # decides which particle is "the max"
    keep = np.arange(T_STEPS) != T_STEPS // 2
    np.testing.assert_allclose(_np(port.traj_max)[keep],
                               _np(ref.traj_max)[keep], atol=1e-4)
    for field in ("xl_mean", "P_mean", "xl", "P", "logw"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=1e-3,
                                   err_msg=field)
    np.testing.assert_allclose(_np(port.ess), _np(ref.ess), rtol=1e-3)
    np.testing.assert_allclose(float(port.log_evidence),
                               float(ref.log_evidence), atol=1e-2)


@pytest.mark.parametrize("kf_kernel", ["block_gather", "lowrank"])
def test_radio_filter_kernel_paths_match_xla(radio, kf_kernel):
    """radio2d has no rows-layout Jacobian hook: the kernel paths pad its
    K6 Jacobian themselves (ny=1, n_lin 32 padded to 128) and equal the
    xla path on the same draws: ancestors equal, traj_mean 1e-3, xl_mean
    and P_mean 5e-3 (the tolerances of tests/test_torch_rbpf.py)."""
    noise = filter_noise(jax.random.PRNGKey(SEED), T_STEPS, N_P, 1,
                         "systematic")
    runs = {k: run_rbpf(*radio["prob"].rbpf_args(),
                        RBPFConfig(n_particles=N_P, resampling="systematic",
                                   kf_kernel=k, symmetrize_cov=False),
                        generator=None, device="cpu", noise=noise)
            for k in ("xla", kf_kernel)}
    a, b = runs["xla"], runs[kf_kernel]
    assert b.P.shape == (N_P, M_EST, M_EST)
    assert torch.equal(a.ancestors, b.ancestors)
    np.testing.assert_allclose(b.traj_mean.numpy(), a.traj_mean.numpy(),
                               atol=1e-3)
    for field in ("xl_mean", "P_mean"):
        np.testing.assert_allclose(getattr(b, field).numpy(),
                                   getattr(a, field).numpy(), atol=5e-3,
                                   err_msg=field)


def _cfg(cls, **kw):
    return cls(n_particles=N_P, n_sweeps=N_K, **kw)


def test_slice_radio_rbps_matches_jax(radio):
    key = jax.random.PRNGKey(SEED)
    ref = jrun_rbps(key, *radio["jargs"], _cfg(JSConfig))
    noise = smoother_noise(key, N_K, T_STEPS, N_P, 1, "multinomial",
                           info_form=False)
    with record_margins() as margins:
        port = run_rbps(*radio["prob"].rbpf_args(), _cfg(RBPSConfig),
                        generator=None, device="cpu", noise=noise)
    assert port.XNK.shape == (N_K, T_STEPS, 3)
    assert_smoothers_match(port, ref)
    assert_margins(margins, f"radio run_rbps, PRNGKey({SEED})")
    pinned = port.ancestors[1:, :, N_P - 1]
    assert int((pinned != N_P - 1).sum()) > 0


INFO_CASES = {
    "woodbury": dict(ancestor_form="woodbury"),
    "cholesky": dict(ancestor_form="cholesky"),
    "woodbury_no_precompute": dict(ancestor_form="woodbury",
                                   suffix_precompute=False),
    "cholesky_bf16": dict(ancestor_form="cholesky", cov_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(INFO_CASES))
def test_slice_radio_info_form_matches_jax(radio, case):
    kw = INFO_CASES[case]
    key = jax.random.PRNGKey(SEED)
    ref = jrun_info(key, *radio["jargs"], _cfg(JSConfig, **kw))
    noise = smoother_noise(key, N_K, T_STEPS, N_P, 1, "multinomial",
                           info_form=True)
    with record_margins() as margins:
        port = run_rbps_information_form(
            *radio["prob"].rbpf_args(), _cfg(RBPSConfig, **kw),
            generator=None, device="cpu", noise=noise)
    assert_smoothers_match(port, ref,
                           pk_rel=2 ** -8 if "bf16" in case else 1e-3)
    assert_margins(margins, f"radio information form {case}, PRNGKey({SEED})")


def test_radio_smoothers_share_their_first_sweep(radio):
    """Sweep 1 of both smoothers is the same plain filter: on the same
    draws it samples the same ancestors and keeps the same trajectory.
    (Later sweeps weigh ancestors by two forms that agree up to a constant
    only to ~1e-2 in float32, tests/test_torch_smoothers.py.)"""
    noise = smoother_noise(jax.random.PRNGKey(SEED), N_K, T_STEPS, N_P, 1,
                           "multinomial", info_form=True)
    a = run_rbps(*radio["prob"].rbpf_args(), _cfg(RBPSConfig),
                 generator=None, device="cpu", noise=noise)
    b = run_rbps_information_form(*radio["prob"].rbpf_args(),
                                  _cfg(RBPSConfig), generator=None,
                                  device="cpu", noise=noise)
    assert torch.equal(a.ancestors[0], b.ancestors[0])
    assert torch.equal(a.kept[0], b.kept[0])
    np.testing.assert_allclose(a.XNK[0].numpy(), b.XNK[0].numpy(), atol=1e-6)


# --- the workload ----------------------------------------------------------------

@pytest.mark.parametrize("traj_type,n", [("line_3D", 32), ("square_3D", 48)])
def test_process_noise_matches_jax(traj_type, n):
    port = tworkload._process_noise(
        tworkload.DenseRadioConfig(traj_type=traj_type, n_steps=n))
    ref = jworkload._process_noise(
        jworkload.DenseRadioConfig(traj_type=traj_type, n_steps=n))
    assert port.shape == (n - 1, 1, 1) and port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_workload_runs_and_smooths():
    """The port's own workload at the quick size on the CPU: the shapes of
    the JAX workload's report, finite errors, and the smoother under the
    reference test's gate of 0.6 m."""
    cfg = tworkload.DenseRadioConfig(n_particles=20, n_sweeps=3, m_basis=32,
                                     m_sim=256, n_mc=2)
    out = tworkload.run(cfg, device="cpu")
    assert out["workload"] == "slam-dense-radio" and out["device"] == "cpu"
    assert len(out["rmse_filter_all"]) == 2
    assert len(out["rmse_smoother_per_sweep"]) == 3
    assert np.all(np.isfinite(out["rmse_smoother_per_sweep"]))
    assert np.all(np.isfinite(out["rmse_filter_max_mean"]))
    assert min(out["rmse_smoother_per_sweep"][1:]) < 0.6
    info = tworkload.run(
        tworkload.DenseRadioConfig(n_particles=20, n_sweeps=2, m_basis=32,
                                   m_sim=256, smoother="info_form",
                                   traj_type="square_3D", n_steps=48),
        device="cpu")
    assert np.all(np.isfinite(info["rmse_smoother_per_sweep"]))


def test_workload_cli(tmp_path):
    """The workload's command line at the quick size; with --plots it writes
    the four figures where matplotlib is installed and fails, naming it,
    where it is not."""
    import importlib.util

    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "rbslam_tpu_torch.workloads.dense_radio",
           "--quick", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["traj_type"] == "line_3D"
    assert len(report["rmse_smoother_per_sweep"]) == 3
    figs = tmp_path / "figs"
    plots = subprocess.run(cmd + ["--plots", str(figs)], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
    if importlib.util.find_spec("matplotlib") is None:
        assert plots.returncode != 0 and "matplotlib" in plots.stderr
        return
    assert plots.returncode == 0, plots.stderr
    # the grid draws nothing: the same seed gives the same numbers
    assert json.loads(plots.stdout.strip().splitlines()[-1])[
        "rmse_smoother_per_sweep"] == report["rmse_smoother_per_sweep"]
    for kind in ("odometry", "filter", "map", "degeneracy"):
        assert (figs / f"line_3D-{kind}.png").stat().st_size > 1000
