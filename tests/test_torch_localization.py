"""The port's localization slice (plain PF, terrain models, GP map fit and
the mag-localization workload) against the JAX package on the same numpy
inputs and JAX's own random draws, on the CPU.

JAX's draws are replayed from its key flow: the PF splits its key into
T-1 step keys, each into k_res, k_dyn (rbslam_tpu/engines/pf.py:87,108,
123); k_res gives the resampling uniforms, k_dyn one key a particle, and
the terrain dynamics split a particle's key again into the position and
orientation draws (rbslam_tpu/models/terrain.py:79-86,174-182). They are
injected through the port's ``noise = (u, w)``, w [T-1, N, 6] the position
normals then the orientation normals.

Tolerances: ancestors equal; traj_mean and logw atol 1e-4; log_evidence
rtol 1e-5 (the JAX package's, which subtracts log N once more a step,
plus those (T-1) log N); terrain weights and dynamics atol 1e-4 (rtol
1e-5 on weights of magnitude over 10); the GP's NLL and gradient at a fixed theta rtol 1e-4;
its posterior mean weights within 1e-3 of their largest magnitude; its
ML-II theta rtol 1e-2 (the two float32 L-BFGS paths differ, so theta is
held to a stated tolerance, not bit for bit). The workloads are held to
the gates of tests/test_workloads.py.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rbslam_tpu.workloads.mag_localization as JML  # noqa: E402
from rbslam_tpu.basis import hypercube_basis as jhypercube  # noqa: E402
from rbslam_tpu.basis import ScalarPotentialBasis as JPotential  # noqa: E402
from rbslam_tpu.data.fields import (  # noqa: E402
    draw_scalar_potential_field as jdraw,
)
from rbslam_tpu.engines import PFConfig as JPFConfig  # noqa: E402
from rbslam_tpu.engines import run_pf_localization as jrun_pf  # noqa: E402
from rbslam_tpu.gp import fit_scalar_potential_gp as jfit  # noqa: E402
from rbslam_tpu.gp import scalar_potential_nll as jnll  # noqa: E402
from rbslam_tpu.models import terrain as jterrain  # noqa: E402
from rbslam_tpu_torch.basis import ScalarPotentialBasis  # noqa: E402
from rbslam_tpu_torch.engines import PFConfig, run_pf_localization  # noqa: E402
from rbslam_tpu_torch.gp import fit_scalar_potential_gp  # noqa: E402
from rbslam_tpu_torch.gp import scalar_potential_nll  # noqa: E402
from rbslam_tpu_torch.models import terrain  # noqa: E402
from rbslam_tpu_torch.workloads import mag_localization as ML  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "rbslam_tpu", "data", "assets",
                       "aaltoml_fixture")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


# --- JAX's draws, replayed ------------------------------------------------

def pf_noise(key, T, n, scheme, dyn_draw):
    """(u, w) as run_pf_localization draws them; ``dyn_draw(k)`` is one
    particle's normals from its key k."""
    shape = () if scheme == "systematic" else (n,)
    u, w = [], []
    for k in jax.random.split(key, T - 1):
        k_res, k_dyn = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_res, shape)))
        w.append(np.asarray(jax.vmap(dyn_draw)(jax.random.split(k_dyn, n))))
    return np.stack(u), np.stack(w)


def terrain_draw(k):
    """A terrain particle's normals: split into position, orientation."""
    kp, kq = jax.random.split(k)
    return jnp.concatenate([jax.random.normal(kp, (3,), jnp.float32),
                            jax.random.normal(kq, (3,), jnp.float32)])


def assert_pf_match(port, ref):
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))
    np.testing.assert_allclose(_np(port.traj_mean), _np(ref.traj_mean),
                               atol=1e-4)
    np.testing.assert_allclose(_np(port.logw), _np(ref.logw), atol=1e-4)
    n_steps, n = _np(ref.ancestors).shape
    np.testing.assert_allclose(float(port.log_evidence),
                               float(ref.log_evidence) + n_steps * np.log(n),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(port.ess), _np(ref.ess), rtol=1e-4)


# --- the PF on the toy map (tests/test_engines_more.py:17-69) -------------

def _jfield(p):
    return jnp.sin(2.0 * p[0]) + jnp.cos(3.0 * p[1]) + 0.5 * p[0]


def _tfield(p):
    return torch.sin(2.0 * p[:, 0]) + torch.cos(3.0 * p[:, 1]) + 0.5 * p[:, 0]


TOY_CASES = {
    # tracking a path on the toy field, ESS-gated systematic resampling
    "tracks_gated": dict(T=40, n=400, ess=0.5, scheme="systematic"),
    # every-step multinomial resampling, the reference's semantics
    "every_step": dict(T=10, n=64, ess=1.0, scheme="multinomial"),
}


@pytest.mark.parametrize("case", sorted(TOY_CASES))
def test_pf_toy_map_matches_jax(case):
    c = TOY_CASES[case]
    T, n = c["T"], c["n"]
    truth = jnp.stack([jnp.linspace(-1, 1, T),
                       jnp.sin(jnp.linspace(0, 3, T))], -1)
    y = jax.vmap(_jfield)(truth) + 0.05 * jax.random.normal(
        jax.random.PRNGKey(0), (T,))
    u = jnp.diff(truth, axis=0)
    init = jax.random.uniform(jax.random.PRNGKey(1), (n, 2), minval=-1.5,
                              maxval=1.5)

    def jdyn(key, xn, u_t, dt, Q):
        return xn + u_t + 0.02 * jax.random.normal(key, xn.shape)

    def jlogw(y_t, xn):
        return -0.5 * jnp.sum(((y_t - _jfield(xn)) / 0.1) ** 2)

    key = jax.random.PRNGKey(2)
    ref = jrun_pf(key, jdyn, jlogw, u, y[:, None], init, jnp.eye(2), 1.0,
                  JPFConfig(n_particles=n, resampling=c["scheme"],
                            ess_threshold=c["ess"]))
    noise = pf_noise(key, T, n, c["scheme"],
                     lambda k: jax.random.normal(k, (2,), jnp.float32))

    def tdyn(w, xn, u_t, dt, Q):
        return xn + u_t + 0.02 * w

    def tlogw(y_t, xn):
        return -0.5 * torch.sum(((y_t - _tfield(xn)[:, None]) / 0.1) ** 2,
                                dim=-1)

    port = run_pf_localization(
        tdyn, tlogw, t32(u), t32(y[:, None]), t32(init), torch.eye(2), 1.0,
        PFConfig(n_particles=n, resampling=c["scheme"],
                 ess_threshold=c["ess"]),
        n_noise=2, generator=None, device="cpu", noise=noise)
    assert_pf_match(port, ref)
    resampled = sum(not np.array_equal(a, np.arange(n))
                    for a in _np(port.ancestors))
    if c["ess"] < 1.0:
        assert 0 < resampled < T - 1, resampled
    if case == "tracks_gated":
        err = np.linalg.norm(_np(port.traj_mean) - np.asarray(truth), axis=-1)
        assert float(err[T // 2:].mean()) < 0.3


def test_pf_stores_trajectories_like_jax():
    """store_trajectories: the raw cloud and the rebuilt ancestral paths."""
    T, n = 8, 32

    def jdyn(key, xn, u_t, dt, Q):
        return xn + 0.1 * jax.random.normal(key, xn.shape)

    def jlogw(y_t, xn):
        return -0.5 * jnp.sum((xn - y_t) ** 2)

    init = jax.random.normal(jax.random.PRNGKey(5), (n, 2))
    key = jax.random.PRNGKey(6)
    cfg = dict(n_particles=n, resampling="stratified", ess_threshold=0.8,
               store_trajectories=True)
    ref = jrun_pf(key, jdyn, jlogw, jnp.zeros((T - 1, 2)), jnp.zeros((T, 2)),
                  init, jnp.eye(2), 1.0, JPFConfig(**cfg))
    noise = pf_noise(key, T, n, "stratified",
                     lambda k: jax.random.normal(k, (2,), jnp.float32))
    port = run_pf_localization(
        lambda w, xn, u_t, dt, Q: xn + 0.1 * w,
        lambda y_t, xn: -0.5 * torch.sum((xn - y_t) ** 2, dim=-1),
        torch.zeros(T - 1, 2), torch.zeros(T, 2), t32(init), torch.eye(2),
        1.0, PFConfig(**cfg), n_noise=2, generator=None, device="cpu",
        noise=noise)
    assert_pf_match(port, ref)
    for field in ("xn_hist", "xn_traj", "traj_max", "xn"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=1e-4,
                                   err_msg=field)


def test_pf_generator_runs_and_rejects_bad_noise():
    cfg = PFConfig(n_particles=16, resampling="systematic")

    def dyn(w, xn, u, dt, Q):
        return xn + 0.1 * w

    def logw(y_t, xn):
        return -0.5 * torch.sum((xn - y_t) ** 2, dim=-1)

    args = (dyn, logw, torch.zeros(5, 2), torch.zeros(6, 2), torch.zeros(2),
            torch.eye(2), 1.0, cfg)
    res = run_pf_localization(*args, n_noise=2, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    assert res.traj_mean.shape == (6, 2) and res.ancestors.dtype == torch.int32
    assert torch.isfinite(res.logw).all()
    with pytest.raises(ValueError, match="shapes"):
        run_pf_localization(*args, n_noise=2, device="cpu", generator=None,
                            noise=(torch.zeros(5), torch.zeros(5, 16, 3)))
    with pytest.raises(ValueError, match="resampling"):
        run_pf_localization(*args[:-1], cfg._replace(resampling="bogus"),
                            n_noise=2, device="cpu", generator=None)


# --- the GP map: NLL, gradient, posterior, ML-II --------------------------

@pytest.fixture(scope="module")
def gp_data():
    """tests/test_engines_more.py:188-208's setting: a drawn curl-free
    field at 200 points in a [4, 4, 1] box."""
    LL = np.array([[-2.0, -2.0, -0.5], [2.0, 2.0, 0.5]])
    key = jax.random.PRNGKey(1)
    xs = jax.random.uniform(key, (200, 3), minval=-1.8, maxval=1.8)
    d = jdraw(key, xs, 256, LL, (5.0, 0.8, 20.0, 0.5))
    return np.asarray(xs), np.asarray(d.y), LL


def _normal_equations(x, y, m, LL):
    """(Phi'Phi, Phi'y, y'y, n_obs, sqrt_lambda) as numpy float32 from the
    JAX package's basis, as fit_scalar_potential_gp builds them."""
    from rbslam_tpu.basis.laplace import domain_center

    pot = JPotential(jhypercube(m, LL))
    xc = jnp.asarray(x, jnp.float32) - jnp.asarray(domain_center(LL),
                                                   jnp.float32)
    C = pot.grad_blocks(xc)
    Phi = jnp.concatenate([C[:, 0], C[:, 1], C[:, 2]], axis=0)
    yv = jnp.concatenate([jnp.asarray(y)[:, k] for k in range(3)])
    sl = np.sqrt(pot.basis.eigenvalues).astype(np.float32)
    return (np.asarray(Phi.T @ Phi), np.asarray(Phi.T @ yv),
            np.asarray(yv @ yv), int(yv.shape[0]), sl)


@pytest.mark.parametrize("theta", [(5.0, 0.8, 20.0, 0.5),
                                   (5.0, 0.3, 5.0, 2.0)])
def test_nll_and_gradient_match_jax(gp_data, theta):
    x, y, LL = gp_data
    PhiPhi, Phiy, yy, n_obs, sl = _normal_equations(x, y, 64, LL)
    lt = np.log(np.asarray(theta, np.float32))
    v_j, g_j = jax.value_and_grad(
        lambda a: jnll(a, jnp.asarray(sl), jnp.asarray(PhiPhi),
                       jnp.asarray(Phiy), jnp.asarray(yy), n_obs))(
        jnp.asarray(lt))
    lt_t = torch.tensor(lt, requires_grad=True)
    v_t = scalar_potential_nll(lt_t, t32(sl), t32(PhiPhi), t32(Phiy),
                               t32(yy), n_obs)
    (g_t,) = torch.autograd.grad(v_t, lt_t)
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-4)
    np.testing.assert_allclose(_np(g_t), np.asarray(g_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(g_j).max()))


def test_gp_fit_matches_jax(gp_data):
    """Fixed theta: the posterior mean weights, the Cholesky, the NLL and
    the predictive mean and variance of the field."""
    x, y, LL = gp_data
    theta = (5.0, 0.8, 20.0, 0.5)
    ref = jfit(x, y, 64, LL, theta, optimize=False)
    gp = fit_scalar_potential_gp(x, y, 64, LL, theta, optimize=False,
                                 device="cpu")
    np.testing.assert_array_equal(gp.center, ref.center)
    w_ref = np.asarray(ref.mean_weights)
    scale = float(np.abs(w_ref).max())
    np.testing.assert_allclose(_np(gp.mean_weights), w_ref, atol=1e-3 * scale)
    np.testing.assert_allclose(gp.nll, ref.nll, rtol=1e-4)
    mean_t, var_t = gp.predict_gradient(x[:50])
    mean_j, var_j = ref.predict_gradient(jnp.asarray(x[:50], jnp.float32))
    np.testing.assert_allclose(_np(mean_t), np.asarray(mean_j),
                               atol=1e-3 * float(np.abs(mean_j).max()))
    np.testing.assert_allclose(_np(var_t), np.asarray(var_j), rtol=1e-3)
    pm_t, pv_t = gp.predict_potential(x[:10])
    pm_j, pv_j = ref.predict_potential(jnp.asarray(x[:10], jnp.float32))
    np.testing.assert_allclose(_np(pm_t), np.asarray(pm_j),
                               atol=1e-3 * float(np.abs(pm_j).max()))
    np.testing.assert_allclose(_np(pv_t), np.asarray(pv_j), rtol=1e-3)


def test_ml2_theta_matches_jax(gp_data):
    """ML-II from a poor start (tests/test_engines_more.py:188-208): both
    packages reach the same optimum within rtol 1e-2 and improve the
    NLL."""
    x, y, LL = gp_data
    theta_bad = (5.0, 0.3, 5.0, 2.0)
    ref = jfit(x, y, 64, LL, theta_bad, optimize=True)
    gp0 = fit_scalar_potential_gp(x, y, 64, LL, theta_bad, optimize=False,
                                  device="cpu")
    gp = fit_scalar_potential_gp(x, y, 64, LL, theta_bad, optimize=True,
                                 device="cpu")
    np.testing.assert_allclose(gp.theta, ref.theta, rtol=1e-2)
    np.testing.assert_allclose(gp.nll, ref.nll, rtol=1e-3)
    assert gp.nll < gp0.nll - 1.0


# --- the terrain models ----------------------------------------------------

@pytest.fixture(scope="module")
def terrain_setup():
    """A map fitted by the JAX package (m = 64) on a lawnmower path over a
    drawn field, the gridded form of it, particles over the domain, and
    one particle exactly on a grid edge and one on the far boundary."""
    theta = (10.0, 1.0, 25.0, 4.0)
    x_train = JML._lawnmower(4.0, 7, 20)
    LLs = np.stack([[-4.5, -4.5, -1.0], [4.5, 4.5, 1.0]])
    d = jdraw(jax.random.PRNGKey(1), jnp.asarray(x_train, jnp.float32), 128,
              LLs, theta)
    lo, hi = x_train.min(0), x_train.max(0)
    LL = np.stack([lo - 1.6, hi + 1.6])
    gp = jfit(x_train, np.asarray(d.y), 64, LL, theta, optimize=False)
    grid = jterrain.gridify_gp(gp, LL[0], LL[1], n=(48, 40))
    rng = np.random.default_rng(3)
    n = 40
    xn = np.zeros((n, 7), np.float32)
    xn[:, :2] = rng.uniform(-4.5, 4.5, (n, 2))
    xn[:, 2] = rng.uniform(-0.2, 0.2, n)
    q = rng.normal(size=(n, 4))
    xn[:, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    glo, gsp = np.asarray(grid[2]), np.asarray(grid[3])
    # centered frame: on the edge of cell (7, 11), and past the far corner
    xn[0, :2] = glo + np.array([7, 11], np.float32) * gsp
    xn[1, :2] = glo + np.array([47, 39], np.float32) * gsp
    return dict(gp=gp, grid=[np.asarray(a) for a in grid], xn=xn,
                y=np.array([3.0, -20.0, 41.0], np.float32), theta=theta)


def _port_exact_model(gp, mode):
    b = gp.potential.basis
    from rbslam_tpu_torch.basis.laplace import LaplaceBasis

    pot = ScalarPotentialBasis(LaplaceBasis(NN=np.asarray(b.NN),
                                            L=np.asarray(b.L),
                                            eigenvalues=b.eigenvalues))
    return terrain.make_terrain_model(
        pot, t32(gp.mean_weights), t32(gp.chol), float(gp.theta[3]),
        mode=mode)


@pytest.mark.parametrize("mode", ["product", "sum"])
@pytest.mark.parametrize("kind", ["exact", "gridded"])
def test_terrain_log_weight_matches_jax(terrain_setup, kind, mode):
    s = terrain_setup
    sigma2 = float(s["gp"].theta[3])
    if kind == "exact":
        jm = jterrain.make_terrain_model(s["gp"].potential,
                                         s["gp"].mean_weights, s["gp"].chol,
                                         sigma2, mode=mode)
        tm = _port_exact_model(s["gp"], mode)
    else:
        jm = jterrain.make_gridded_terrain_model(*s["grid"], sigma2,
                                                 mode=mode)
        tm = terrain.make_gridded_terrain_model(
            *[t32(a) for a in s["grid"]], sigma2, mode=mode)
    ref = np.asarray(jax.jit(jax.vmap(lambda x: jm.log_weight(
        jnp.asarray(s["y"]), x)))(jnp.asarray(s["xn"])))
    got = _np(tm.log_weight(t32(s["y"]), t32(s["xn"])))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    mean_j, var_j = jax.jit(jax.vmap(jm.predict_field))(
        jnp.asarray(s["xn"][:, :3]))
    mean_t, var_t = tm.predict_field(t32(s["xn"][:, :3]))
    np.testing.assert_allclose(_np(mean_t), np.asarray(mean_j), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(var_t), np.asarray(var_j), atol=1e-5,
                               rtol=1e-4)


def test_gridded_edge_particles_pick_jax_cells(terrain_setup):
    """A particle exactly on a grid edge and one past the far boundary:
    the same cell, weights and interpolated field as the JAX package."""
    s = terrain_setup
    sigma2 = float(s["gp"].theta[3])
    jm = jterrain.make_gridded_terrain_model(*s["grid"], sigma2)
    tm = terrain.make_gridded_terrain_model(*[t32(a) for a in s["grid"]],
                                            sigma2)
    for i in (0, 1):
        p = s["xn"][i, :3]
        mean_j, var_j = jm.predict_field(jnp.asarray(p))
        mean_t, var_t = tm.predict_field(t32(p))
        np.testing.assert_allclose(_np(mean_t), np.asarray(mean_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(var_t), np.asarray(var_j),
                                   rtol=1e-6, atol=1e-6)
    # the edge particle sits on the grid node itself: its interpolated
    # field is that node's value
    np.testing.assert_allclose(_np(tm.predict_field(t32(s["xn"][0, :3]))[0]),
                               s["grid"][0][7, 11], rtol=1e-5, atol=1e-5)


def test_gridded_model_against_exact(terrain_setup):
    """The gridded map agrees with the exact predictive at test points
    (tests/test_engines_more.py:241-250 holds the JAX pair to 0.3)."""
    s = terrain_setup
    sigma2 = float(s["gp"].theta[3])
    tm_g = terrain.make_gridded_terrain_model(*[t32(a) for a in s["grid"]],
                                              sigma2)
    tm_e = _port_exact_model(s["gp"], "product")
    pts = t32(s["xn"][2:, :3])
    pts[:, 2] = 0.0
    np.testing.assert_allclose(_np(tm_g.predict_field(pts)[0]),
                               _np(tm_e.predict_field(pts)[0]), atol=0.3)


@pytest.mark.parametrize("kind", ["exact", "gridded"])
def test_terrain_dynamics_match_jax(terrain_setup, kind):
    s = terrain_setup
    sigma2 = float(s["gp"].theta[3])
    if kind == "exact":
        jm = jterrain.make_terrain_model(s["gp"].potential,
                                         s["gp"].mean_weights, s["gp"].chol,
                                         sigma2)
        tm = _port_exact_model(s["gp"], "product")
    else:
        jm = jterrain.make_gridded_terrain_model(*s["grid"], sigma2)
        tm = terrain.make_gridded_terrain_model(
            *[t32(a) for a in s["grid"]], sigma2)
    Q = np.asarray(JML.default_Q()) * 50.0
    u = np.array([0.05, -0.02, 0.0, 0.99, 0.05, -0.1, 0.02], np.float32)
    u[3:] /= np.linalg.norm(u[3:])
    keys = jax.random.split(jax.random.PRNGKey(9), s["xn"].shape[0])
    ref = jax.jit(jax.vmap(lambda k, x: jm.dynamics(
        k, x, jnp.asarray(u), 0.1, jnp.asarray(Q))))(keys,
                                                     jnp.asarray(s["xn"]))
    w = np.asarray(jax.vmap(terrain_draw)(keys))
    got = tm.dynamics(t32(w), t32(s["xn"]), t32(u), torch.tensor(0.1),
                      t32(Q))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)


def test_gridded_terrain_pf_matches_jax():
    """The 1M-particle path in small: bench.py:125-195's gridded terrain
    PF (systematic, ESS 0.5) at N = 256, T = 24, JAX's draws injected."""
    theta = (10.0, 1.0, 25.0, 4.0)
    extent, n_grid, T, n = 4.0, 24, 24, 256
    xs = np.linspace(-extent, extent, n_grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    grid_pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    path = JML._test_loop(extent * 0.9, T)
    LLs = np.stack([[-extent - 1, -extent - 1, -1.0],
                    [extent + 1, extent + 1, 1.0]])
    d = jdraw(jax.random.PRNGKey(0),
              jnp.asarray(np.concatenate([grid_pts, path]), jnp.float32),
              128, LLs, theta)
    mean_grid = np.asarray(d.df[:X.size]).reshape(n_grid, n_grid, 3)
    var_grid = np.full((n_grid, n_grid, 3), 0.3, np.float32)
    lo = np.array([xs[0], xs[0]], np.float32)
    sp = np.array([xs[1] - xs[0]] * 2, np.float32)
    jm = jterrain.make_gridded_terrain_model(mean_grid, var_grid, lo, sp,
                                             theta[3])
    tm = terrain.make_gridded_terrain_model(t32(mean_grid), t32(var_grid),
                                            t32(lo), t32(sp), theta[3])
    _, Rm = ML._heading_quats(path)
    quat = ML._quat(Rm.transpose(0, 2, 1))
    y_body = np.einsum("tij,tj->ti", Rm, np.asarray(d.y[X.size:]))
    from rbslam_tpu.math.quaternions import qinv, qmul

    dquat = np.asarray(qmul(qinv(jnp.asarray(quat[:-1])),
                            jnp.asarray(quat[1:])))
    u = np.concatenate([np.diff(path, axis=0), dquat], -1).astype(np.float32)
    init = np.concatenate([
        np.random.default_rng(1).uniform(-extent, extent, (n, 2)),
        np.zeros((n, 1)), np.tile(quat[0], (n, 1))], -1).astype(np.float32)
    Q = np.asarray(JML.default_Q())
    key = jax.random.PRNGKey(2)
    cfg = dict(n_particles=n, resampling="systematic", ess_threshold=0.5)
    ref = jrun_pf(key, jm.dynamics, jm.log_weight, jnp.asarray(u),
                  jnp.asarray(y_body, jnp.float32), jnp.asarray(init),
                  jnp.asarray(Q), 0.1, JPFConfig(**cfg))
    port = run_pf_localization(
        tm.dynamics, tm.log_weight, u, y_body, init, t32(Q), 0.1,
        PFConfig(**cfg), n_noise=tm.n_noise, generator=None, device="cpu",
        noise=pf_noise(key, T, n, "systematic", terrain_draw))
    assert_pf_match(port, ref)
    resampled = sum(not np.array_equal(a, np.arange(n))
                    for a in _np(port.ancestors))
    assert 0 < resampled < T - 1, resampled


# --- the workload ----------------------------------------------------------

def test_workload_helpers_match_jax():
    np.testing.assert_array_equal(ML._lawnmower(4.0, 11),
                                  JML._lawnmower(4.0, 11))
    np.testing.assert_array_equal(ML._test_loop(4.0, 60),
                                  JML._test_loop(4.0, 60))
    np.testing.assert_array_equal(_np(ML.default_Q()),
                                  np.asarray(JML.default_Q()))
    path = JML._test_loop(4.0, 30)
    q_t, R_t = ML._heading_quats(path)
    q_j, R_j = JML._heading_quats(path)
    np.testing.assert_array_equal(R_t, R_j)
    np.testing.assert_allclose(q_t, np.asarray(q_j), atol=1e-6)
    for a, b in zip(ML._load_real_data(FIXTURE),
                    JML._load_real_data(FIXTURE)):
        np.testing.assert_array_equal(a, b)


def test_mag_localization_workload_quick():
    """tests/test_workloads.py:44-58's configuration and gates."""
    out = ML.run(ML.MagLocalizationConfig(
        n_particles=300, m_basis=128, m_sim=256, n_test_steps=80,
        optimize_hyperparams=False), device="cpu")
    assert out["data"] == "synthetic" and out["device"] == "cpu"
    assert out["gp"]["test_rmse"] < 4.0
    assert out["pf"]["final_err"] < 1.5, out["pf"]


def test_mag_localization_real_data_layout(tmp_path):
    """tests/test_workloads.py:59-111: a tiny .mat in the reference's layout
    (x [n, 2], y [n, 3], s [n] segment ids) drives the --data pipeline."""
    import scipy.io as sio

    lines = []
    for i, xv in enumerate(np.linspace(-2.0, 2.0, 6)):
        ys = np.linspace(-2.0, 2.0, 90)
        lines.append(np.stack([np.full_like(ys, xv),
                               ys[::-1] if i % 2 else ys], -1))
    x_train = np.concatenate(lines)
    th = np.linspace(0, 2 * np.pi, 320)
    x_test = 1.3 * np.stack([np.cos(th), np.sin(th)], -1)
    x_all = np.concatenate([x_train, x_test])
    s = np.concatenate([np.ones(180), 2 * np.ones(180), 4 * np.ones(180),
                        3 * np.ones(320)])
    field = np.stack([10.0 * np.sin(0.9 * x_all[:, 0]) + 30.0,
                      8.0 * np.cos(0.7 * x_all[:, 1]),
                      6.0 * np.sin(0.5 * (x_all[:, 0] + x_all[:, 1])) - 40.0],
                     -1)
    y_all = field + 0.5 * np.random.default_rng(0).normal(size=field.shape)
    path = tmp_path / "tiny_aaltoml.mat"
    sio.savemat(path, {"x": x_all, "y": y_all, "s": s})
    out = ML.run(ML.MagLocalizationConfig(
        n_particles=64, m_basis=64, data_path=str(path),
        optimize_hyperparams=False), device="cpu")
    assert out["data"] == "aaltoml-magnetic-data"
    assert np.isfinite(out["gp"]["nll"]) and np.isfinite(out["gp"]["test_rmse"])
    assert np.isfinite(out["pf"]["mean_err_after_burnin"])
    assert out["pf"]["ess_min"] > 0


def test_mag_localization_vendored_fixture():
    """tests/test_workloads.py:114-136: the vendored fixture in the AaltoML
    repository layout, with the reference-default ML-II fit."""
    out = ML.run(ML.MagLocalizationConfig(
        n_particles=64, m_basis=48, data_path=FIXTURE,
        optimize_hyperparams=True), device="cpu")
    assert out["data"] == "aaltoml-magnetic-data"
    assert np.isfinite(out["gp"]["nll"]) and np.isfinite(out["gp"]["test_rmse"])
    assert np.all(np.isfinite(out["gp"]["theta"]))
    assert np.isfinite(out["pf"]["mean_err_after_burnin"])


def test_mag_localization_video_not_ported(tmp_path, capsys):
    """--video is ported: it writes the localization GIF, one frame a step,
    where matplotlib is installed, and raises an ImportError naming it
    before any work where it is not."""
    import importlib.util

    gif = tmp_path / "x.gif"
    argv = ["--quick", "--device", "cpu", "--video", str(gif)]
    if importlib.util.find_spec("matplotlib") is None:
        with pytest.raises(ImportError, match="matplotlib"):
            ML.main(argv)
        return
    ML.main(argv)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["pf"]["video"] == {"path": str(gif), "frames": 60}
    assert gif.stat().st_size > 1000


def test_new_workloads_never_import_jax():
    """The localization and sparse visual workloads (GP fit, terrain PF,
    sparse filter and smoother) with JAX made unimportable."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)  # small ops: no thread contention with
                                  # the suite's other workers
        from rbslam_tpu_torch.workloads import mag_localization as ML
        from rbslam_tpu_torch.workloads import sparse_visual as SV
        from rbslam_tpu_torch.models import gridify_gp
        import rbslam_tpu_torch.gp
        out = ML.run(ML.MagLocalizationConfig(
            n_particles=16, m_basis=16, m_sim=32, n_test_steps=8,
            n_map_lines=3), device="cpu")
        assert out["pf"]["n_particles"] == 16
        out = SV.run(SV.SparseVisualConfig(
            n_particles_pf=4, n_particles_ps=3, n_sweeps=2), device="cpu")
        assert out["n_steps"] == 197 and "ps" in out
        assert not any(m == "jax" or m.startswith("jax.")
                       or m == "rbslam_tpu" or m.startswith("rbslam_tpu.")
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
