"""The port's dataset simulator beyond the heading families, against the JAX
package given JAX's own normals, on the CPU: the fully planar families
(circle_2D, bean_2D, line_2D) with a plain random-walk dynamics written
for each package, line_3D_withPos counted with the heading families, and
the visualization grid (``with_grid``) of a scalar and a 6-D field.

JAX's key flow (rbslam_tpu/data/simulate.py:113-186 and data/fields.py):
key_field, key_meas, key_odo = split(key, 3); kw, kn = split(key_field);
the field's measurement noise is drawn over the T trajectory points and
the 10,000 grid points together, and the port takes its first T; one
odometry key a step from split(key_odo, T-1). The port computes the
grid's noise-free field from the drawn weights and draws nothing for it.

Tolerances: 1e-5 of each output's scale (float32 products over m_sim
basis functions in another order); the trajectory and the domain exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rbslam_tpu.basis import hypercube_basis as jhypercube_basis  # noqa: E402
from rbslam_tpu.data import simulate_dense_dataset as jsimulate  # noqa: E402
from rbslam_tpu.models import make_radio2d_model as jmake_radio  # noqa: E402
from rbslam_tpu.models.mag3d import (  # noqa: E402
    dynamics_with_increment as jdyn_6d,
)
from rbslam_tpu_torch.basis import hypercube_basis  # noqa: E402
from rbslam_tpu_torch.data import simulate_dense_dataset  # noqa: E402
from rbslam_tpu_torch.models import make_radio2d_model  # noqa: E402
from rbslam_tpu_torch.models.mag3d import dynamics_with_increment  # noqa: E402

N_GRID = 100 * 100
M_SIM = 64
THETA_2D = (0.25, 2.0, 0.01)
THETA_6D = (650.0, 1.2, 200.0, 10.0)
SMALL = {"circle_2D": {"n_laps": 1, "dpsi_deg": 30.0},
         "bean_2D": {"n_laps": 2, "n_per_lap": 8},
         "line_2D": {"n": 12},
         "line_3D_withPos": {"n": 12},
         "bean_6D": {"n_laps": 1, "n_per_lap": 12}}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(port), ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def jax_walk(key, x, u, dt, Q):
    return x + u + jnp.sqrt(dt) * jnp.linalg.cholesky(Q) @ jax.random.normal(
        key, x.shape, x.dtype)


def torch_walk(w, x, u, dt, Q):
    return x + u + float(np.sqrt(dt)) * torch.linalg.cholesky(Q) @ w


def _case(traj_type):
    """(JAX dynamics, port dynamics, Q, theta, JAX odometry normal of one
    step key) for a family."""
    if traj_type.endswith("6D"):
        Q = np.diag([1e-4] * 3 + [1e-5] * 3).astype(np.float32)

        def odo(k):
            kp, kq = jax.random.split(k)
            return np.concatenate([
                np.asarray(jax.random.normal(kp, (3,), jnp.float32)),
                np.asarray(jax.random.normal(kq, (3,), jnp.float32))])

        return jdyn_6d, dynamics_with_increment, Q, THETA_6D, odo
    if traj_type in ("line_3D", "line_3D_withPos"):
        jgen = jmake_radio(jhypercube_basis(4, np.array([1.0, 1.0])))
        tgen = make_radio2d_model(hypercube_basis(4, np.array([1.0, 1.0])),
                                  device="cpu")
        Q = np.full((1, 1), 0.05, np.float32)
        return (jgen.dynamics, tgen.dynamics, Q, THETA_2D,
                lambda k: np.asarray(jax.random.normal(k, (1,),
                                                       jnp.float32)))
    Q = (0.01 * np.eye(2)).astype(np.float32)
    return (jax_walk, torch_walk, Q, THETA_2D,
            lambda k: np.asarray(jax.random.normal(k, (2,), jnp.float32)))


def _jax_normals(key, traj_type, T, with_grid):
    key_field, _, key_odo = jax.random.split(key, 3)
    kw, kn = jax.random.split(key_field)
    six_d = traj_type.endswith("6D")
    n_w = 3 + M_SIM if six_d else M_SIM
    n_pts = T + (N_GRID if with_grid else 0)
    z_w = np.asarray(jax.random.normal(kw, (n_w,), jnp.float32))
    z_n = np.asarray(jax.random.normal(
        kn, (n_pts, 3) if six_d else (n_pts,), jnp.float32))[:T]
    odo = _case(traj_type)[4]
    w_odo = np.stack([odo(k) for k in jax.random.split(key_odo, T - 1)])
    return z_w, z_n, w_odo


def _both(traj_type, with_grid, seed=3):
    jdyn, tdyn, Q, theta, _ = _case(traj_type)
    kw = SMALL[traj_type]
    key = jax.random.PRNGKey(seed)
    ref = jsimulate(key, traj_type, theta, jnp.asarray(Q), 1.0, jdyn,
                    m_sim=M_SIM, traj_kwargs=kw, with_grid=with_grid)
    T = ref.pos.shape[0]
    port = simulate_dense_dataset(
        traj_type, theta, Q, 1.0, tdyn, m_sim=M_SIM, traj_kwargs=kw,
        with_grid=with_grid,
        normals=_jax_normals(key, traj_type, T, with_grid))
    return port, ref


@pytest.mark.parametrize("traj_type", ["circle_2D", "bean_2D", "line_2D",
                                       "line_3D_withPos"])
def test_planar_dataset_matches_jax(traj_type):
    """The planar branch (dx = diff of the noisy path) and line_3D_withPos
    (clean position increments, differenced noisy heading)."""
    port, ref = _both(traj_type, with_grid=False)
    T = ref.pos.shape[0]
    n_u = 3 if traj_type == "line_3D_withPos" else 2
    assert port.dx.shape == (T - 1, n_u) and port.y.shape == (T, 1)
    assert port.grid is None and ref.grid is None
    np.testing.assert_array_equal(port.pos, ref.pos)
    np.testing.assert_array_equal(port.LL, ref.LL)
    for field in ("dx", "y", "init_state", "odometry_path", "field_weights",
                  "Q"):
        _close(getattr(port, field), getattr(ref, field), field)
    if traj_type == "line_3D_withPos":
        np.testing.assert_array_equal(
            _np(port.dx)[:, :2], np.diff(port.pos, axis=0).astype(np.float32))
    else:
        _close(port.dx, np.diff(port.odometry_path, axis=0), "diff")


@pytest.mark.parametrize("traj_type", ["circle_2D", "bean_6D"])
def test_grid_matches_jax(traj_type):
    """with_grid=True: the 100 x 100 grid over the domain and the noise-free
    field there (f; for 6-D the potential f and the field df) equal JAX's,
    and so does the rest of the dataset."""
    port, ref = _both(traj_type, with_grid=True)
    assert set(port.grid) == set(ref.grid)
    for k in ("x1t", "x2t"):
        np.testing.assert_array_equal(port.grid[k], ref.grid[k])
    assert port.grid["f"].shape == (N_GRID,)
    for k in set(ref.grid) - {"x1t", "x2t"}:
        _close(port.grid[k], ref.grid[k], k)
    if traj_type == "bean_6D":
        assert port.grid["df"].shape == (N_GRID, 3)
    for field in ("dx", "y", "field_weights", "odometry_path"):
        _close(getattr(port, field), getattr(ref, field), field)


@pytest.mark.parametrize("traj_type", ["line_3D", "bean_6D", "line_2D"])
def test_grid_draws_nothing(traj_type):
    """The same generator seed gives the same dataset with and without the
    grid, bit for bit; the repeated-field path (field_weights) has no grid,
    as in the JAX package."""
    _, tdyn, Q, theta, _ = _case(traj_type)
    kw = SMALL.get(traj_type, {"n": 12})
    runs = [simulate_dense_dataset(
        traj_type, theta, Q, 1.0, tdyn, m_sim=M_SIM, traj_kwargs=kw,
        with_grid=g, generator=torch.Generator().manual_seed(1))
        for g in (False, True)]
    assert runs[0].grid is None and runs[1].grid is not None
    for field in ("dx", "y", "field_weights", "init_state", "Q"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field))
    np.testing.assert_array_equal(runs[0].odometry_path,
                                  runs[1].odometry_path)
    if not traj_type.endswith("6D"):
        again = simulate_dense_dataset(
            traj_type, theta, Q, 1.0, tdyn, m_sim=M_SIM, traj_kwargs=kw,
            field_weights=runs[1].field_weights,
            generator=torch.Generator().manual_seed(2))
        assert again.grid is None


@pytest.mark.parametrize("traj_type", ["circle_2D", "bean_6D"])
def test_dtype_float64_matches_jax(traj_type):
    """dtype=float64 in both packages (JAX with 64-bit mode on for the call,
    its normals drawn in float64 from the same keys): every tensor of the
    dataset and the grid comes back float64 and equals JAX's to 1e-10 of
    its scale, 1e-6 for bean_6D (in 64-bit mode JAX's trajectory generator
    rounds the initial quaternion otherwise, by 4e-8, and the odometry
    carries it); the default stays float32."""
    jdyn, tdyn, Q, theta, _ = _case(traj_type)
    kw, key = SMALL[traj_type], jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        ref = jsimulate(key, traj_type, theta, jnp.asarray(Q, jnp.float64),
                        1.0, jdyn, m_sim=M_SIM, traj_kwargs=kw,
                        with_grid=True, dtype=jnp.float64)
        T = ref.pos.shape[0]
        key_field, _, key_odo = jax.random.split(key, 3)
        kwk, kn = jax.random.split(key_field)
        six_d = traj_type.endswith("6D")
        f64 = jnp.float64
        z_w = jax.random.normal(kwk, (3 + M_SIM if six_d else M_SIM,), f64)
        z_n = jax.random.normal(kn, ((T + N_GRID, 3) if six_d
                                     else (T + N_GRID,)), f64)[:T]
        odo = []
        for k in jax.random.split(key_odo, T - 1):
            if six_d:
                kp, kq = jax.random.split(k)
                odo.append(jnp.concatenate([jax.random.normal(kp, (3,), f64),
                                            jax.random.normal(kq, (3,), f64)]))
            else:
                odo.append(jax.random.normal(k, (2,), f64))
        normals = tuple(np.asarray(a) for a in (z_w, z_n, jnp.stack(odo)))
    port = simulate_dense_dataset(
        traj_type, theta, Q, 1.0, tdyn, m_sim=M_SIM, traj_kwargs=kw,
        with_grid=True, normals=normals, dtype=torch.float64)
    tol = 1e-6 if six_d else 1e-10
    for field in ("dx", "y", "init_state", "field_weights", "Q"):
        a, b = getattr(port, field), np.asarray(getattr(ref, field))
        assert a.dtype == torch.float64 and b.dtype == np.float64, field
        np.testing.assert_allclose(_np(a), b, rtol=tol,
                                   atol=tol * max(1.0, np.abs(b).max()),
                                   err_msg=field)
    for k in set(ref.grid) - {"x1t", "x2t"}:
        assert port.grid[k].dtype == np.float64, k
        np.testing.assert_allclose(port.grid[k], ref.grid[k], rtol=tol,
                                   atol=tol * np.abs(ref.grid[k]).max(),
                                   err_msg=k)
    assert port.odometry_path.dtype == np.float64
    default = simulate_dense_dataset(
        traj_type, theta, Q, 1.0, tdyn, m_sim=M_SIM, traj_kwargs=kw,
        with_grid=False, generator=torch.Generator().manual_seed(0))
    assert default.dx.dtype == default.y.dtype == torch.float32
