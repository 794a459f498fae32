"""The port's sparse visual-SLAM slice (masked EKF update, pinhole model,
the sparse filter and CPF-AS smoother, the dataset loader, the map and
path RMSE, the workload) against the JAX package on the same numpy inputs
and JAX's own random draws, on the CPU.

The problem is tests/test_engines_more.py:71-125's ``_sparse_toy``: six
landmarks, T = 30 around a circle, NaN where a landmark is not visible.
JAX's draws are replayed from its key flow (rbslam_tpu/engines/rbpf.py:
436,523,549 and rbps.py:233,264,271-280,347): the pinhole model has no
batched dynamics, so each particle draws its three normals from its own
key of split(k_dyn, N). They are injected through ``noise``.

Tolerances: the masked update atol 1e-5 (1e-4 on log-weights); the
future log-weights of the smoother rtol 1e-5 against JAX where few
readings are in view, and atol 0.1 against a float64 evaluation for both
packages where most are (the float32 cancellation in se - |v|^2); the
filter's ancestors equal, xl_mean and logw atol 1e-4; the smoother as
tests/test_torch_smoothers.py holds the dense one (XNK atol 1e-4, XLK
atol 1e-3, PK 1e-3 of its scale, ess rtol 1e-3, retry counts equal); the
workload to tests/test_workloads.py:21-30's gates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rbslam_tpu.data.sparse_visual import (  # noqa: E402
    load_sparse_visual as jload,
)
from rbslam_tpu.engines import RBPFConfig as JRConfig  # noqa: E402
from rbslam_tpu.engines import RBPSConfig as JSConfig  # noqa: E402
from rbslam_tpu.engines import run_rbpf as jrun_rbpf  # noqa: E402
from rbslam_tpu.engines import run_rbps as jrun_rbps  # noqa: E402
from rbslam_tpu.metrics import map_and_path_rmse as jmap_rmse  # noqa: E402
from rbslam_tpu.models import PinholeCamera as JCamera  # noqa: E402
from rbslam_tpu.models import make_pinhole2d_model as jmake  # noqa: E402
from rbslam_tpu.models.pinhole2d import project as jproject  # noqa: E402
from rbslam_tpu.ops import kalman as jkalman  # noqa: E402
from rbslam_tpu_torch.data.sparse_visual import (  # noqa: E402
    SparseVisualDraws,
    load_sparse_visual,
)
from rbslam_tpu_torch.engines import (  # noqa: E402
    RBPFConfig,
    RBPSConfig,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from rbslam_tpu_torch.metrics import map_and_path_rmse  # noqa: E402
from rbslam_tpu_torch.models import PinholeCamera  # noqa: E402
from rbslam_tpu_torch.models import make_pinhole2d_model  # noqa: E402
from rbslam_tpu_torch.models.pinhole2d import project  # noqa: E402
from rbslam_tpu_torch.ops import kalman as tkalman  # noqa: E402
from rbslam_tpu_torch.workloads import sparse_visual as SV  # noqa: E402

CAM = (1.5, 0.0, 1.0)
M, T_TOY, N_PF, N_PS = 6, 30, 30, 10


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


# --- JAX's draws, replayed ------------------------------------------------

def dyn_normals(k_dyn, n):
    """One key a particle, three normals each."""
    return np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (3,), jnp.float32))(
        jax.random.split(k_dyn, n)))


def filter_noise(key, T, n):
    """(u, w) of run_rbpf with multinomial resampling."""
    key, _ = jax.random.split(key)
    u, w = [], []
    for k in jax.random.split(key, T - 1):
        k_res, k_dyn = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_res, (n,))))
        w.append(dyn_normals(k_dyn, n))
    return np.stack(u), np.stack(w)


def smoother_noise(key, n_sweeps, T, n):
    """(u, w, u_anc, u_pick) of run_rbps (CPF-AS) with multinomial
    resampling."""
    U, W, UA, UP = [], [], [], []
    for _ in range(n_sweeps):
        key, k = jax.random.split(key)
        k, _ = jax.random.split(k)
        u, w, ua = [], [], []
        for ks in jax.random.split(k, T - 1):
            k_res, k_dyn, k_anc = jax.random.split(ks, 3)
            u.append(np.asarray(jax.random.uniform(k_res, (n,))))
            w.append(dyn_normals(k_dyn, n))
            ua.append(np.asarray(jax.random.uniform(k_anc, ())))
        U.append(np.stack(u))
        W.append(np.stack(w))
        UA.append(np.stack(ua))
        UP.append(np.asarray(
            jax.random.uniform(jax.random.fold_in(k, 7), ())))
    return np.stack(U), np.stack(W), np.stack(UA), np.stack(UP)


# --- the toy problem (tests/test_engines_more.py:71-125) ------------------

def _make_toy(heading_offset):
    key = jax.random.PRNGKey(3)
    cam = JCamera(*CAM)
    k1, k2, _ = jax.random.split(key, 3)
    landmarks = jax.random.uniform(k1, (M, 2), minval=-2.0, maxval=2.0)
    th = jnp.linspace(0, 2 * jnp.pi, T_TOY)
    pos = 3.0 * jnp.stack([jnp.cos(th), jnp.sin(th)], -1)
    truth = jnp.concatenate([pos, (th + heading_offset)[:, None]], -1)

    def obs(xn):
        y, nv = jproject(cam, xn, landmarks)
        return jnp.where(nv, jnp.nan, y)

    y = jax.vmap(obs)(truth) + 0.01 * jax.random.normal(k2, (T_TOY, M))
    x0_lin = landmarks.reshape(-1)[None, :] + 0.3 * jax.random.normal(
        jax.random.PRNGKey(4), (N_PF, 2 * M))
    Q = np.diag([0.05**2, 0.05**2, 0.01**2]).astype(np.float32)
    R = (0.01 * np.eye(M)).astype(np.float32)
    P0 = (0.5 * np.eye(2 * M)).astype(np.float32)
    return dict(landmarks=np.asarray(landmarks), truth=np.asarray(truth),
                y=np.asarray(y), u=np.asarray(jnp.diff(truth, axis=0)),
                x0_lin=np.asarray(x0_lin), Q=Q, R=R, P0=P0,
                in_view=int(np.isfinite(np.asarray(y)).sum()))


@pytest.fixture(scope="module")
def toy():
    """The reference test's problem: heading th + pi, which leaves 4 of
    the 180 readings in view."""
    return _make_toy(jnp.pi)


@pytest.fixture(scope="module", params=["reference_heading",
                                        "facing_center"])
def toys(request):
    """The reference test's problem, and the same problem with the camera
    facing the circle's center (heading th + pi/2), where most readings
    are in view and the masked update does real work."""
    return _make_toy(jnp.pi if request.param == "reference_heading"
                     else jnp.pi / 2)


def _args(toy, n, jax_side):
    if jax_side:
        model = jmake(JCamera(*CAM), M)
        conv = jnp.asarray
    else:
        model = make_pinhole2d_model(PinholeCamera(*CAM), M)
        conv = t32
    return (model, conv(toy["u"]), conv(toy["y"]), conv(toy["truth"][0]),
            conv(toy["x0_lin"][:n]), conv(toy["P0"]), conv(toy["Q"]),
            conv(toy["R"]), 1.0)


def test_toys_have_masked_and_observed_readings(toys):
    """Steps with landmarks out of view and steps with landmarks in view."""
    nan = np.isnan(toys["y"])
    assert nan.any(axis=1).sum() > 0 and (~nan).any(axis=1).sum() > 0


def test_sparse_filter_matches_jax(toys):
    toy = toys
    key = jax.random.PRNGKey(5)
    ref = jrun_rbpf(key, *_args(toy, N_PF, True), JRConfig(n_particles=N_PF))
    port = run_rbpf(*_args(toy, N_PF, False), RBPFConfig(n_particles=N_PF),
                    generator=None, device="cpu",
                    noise=filter_noise(key, T_TOY, N_PF))
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))
    assert int(port.chol_retries) == int(ref.chol_retries)
    for field in ("xl_mean", "logw", "traj_mean", "xl_max"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=1e-4,
                                   err_msg=field)
    np.testing.assert_allclose(_np(port.P_mean), _np(ref.P_mean), atol=1e-4)
    np.testing.assert_allclose(float(port.log_evidence),
                               float(ref.log_evidence), rtol=1e-5)
    # the reference test's gate: the map converges
    err = np.linalg.norm(_np(port.xl_mean).reshape(M, 2) - toy["landmarks"],
                         axis=-1)
    assert float(err.mean()) < 0.5, err


def test_sparse_smoother_matches_jax(toys):
    toy = toys
    """CPF-AS, N = 10, 2 sweeps: the information-form future weights of the
    EKF-linearized path drive the pinned particle's ancestors."""
    key = jax.random.PRNGKey(6)
    cfg = dict(n_particles=N_PS, n_sweeps=2)
    ref = jrun_rbps(key, *_args(toy, N_PS, True), JSConfig(**cfg))
    port = run_rbps(*_args(toy, N_PS, False), RBPSConfig(**cfg),
                    generator=None, device="cpu",
                    noise=smoother_noise(key, 2, T_TOY, N_PS))
    np.testing.assert_allclose(_np(port.XNK), _np(ref.XNK), atol=1e-4)
    np.testing.assert_allclose(_np(port.XLK), _np(ref.XLK), atol=1e-3)
    pk = _np(ref.PK)
    np.testing.assert_allclose(_np(port.PK), pk, atol=1e-3 * np.abs(pk).max())
    np.testing.assert_allclose(_np(port.ess), _np(ref.ess), rtol=1e-3)
    np.testing.assert_array_equal(_np(port.chol_retries),
                                  _np(ref.chol_retries))
    assert np.all(np.isfinite(_np(port.XNK)))


def test_sparse_future_weights_match_jax(toys):
    toy = toys
    """The information-form future log-likelihood of every particle at each
    t, against the JAX package's per-particle function."""
    from rbslam_tpu.engines import rbps as jrbps
    from rbslam_tpu_torch.engines import rbps as trbps

    rng = np.random.default_rng(0)
    n, nl = 5, 2 * M
    xl = toy["x0_lin"][:n]
    A = rng.normal(size=(n, nl, nl)).astype(np.float32)
    P = (0.05 * A @ A.transpose(0, 2, 1) + 0.2 * np.eye(nl)).astype(
        np.float32)
    y = toy["y"]
    mask = np.isfinite(y).astype(np.float32)
    jfuture = jax.jit(jrbps._sparse_future_log_weights,
                      static_argnums=(0, 8))
    for t in (1, 13, T_TOY - 1):
        lw_j, r_j = jfuture(
            jmake(JCamera(*CAM), M), jnp.asarray(toy["truth"]),
            jnp.asarray(y), jnp.asarray(mask), t, jnp.asarray(xl),
            jnp.asarray(P), jnp.asarray(toy["R"]), 1e-2)
        lw_t, r_t = trbps._sparse_future_log_weights(
            make_pinhole2d_model(PinholeCamera(*CAM), M), t32(toy["truth"]),
            t32(np.nan_to_num(y)), t32(mask), t, t32(xl), t32(P),
            t32(toy["R"]), 1e-2)
        lw_64, _ = trbps._sparse_future_log_weights(
            make_pinhole2d_model(PinholeCamera(*CAM), M),
            *(torch.tensor(np.asarray(a), dtype=torch.float64) for a in (
                toy["truth"], np.nan_to_num(y), mask)), t,
            *(torch.tensor(np.asarray(a), dtype=torch.float64)
              for a in (xl, P, toy["R"])), 1e-2)
        # both float32 evaluations against the float64 one. With most
        # readings in view, se - |v|^2 cancels: the float32 values of both
        # packages are off the float64 one by up to 0.065 (one particle
        # of five), so they are held at atol 0.1 there; with few readings
        # the two packages agree to 1e-5
        in_view = toy["in_view"] >= 10
        for lw in (_np(lw_t), np.asarray(lw_j)):
            np.testing.assert_allclose(lw, _np(lw_64), rtol=1e-5,
                                       atol=0.1 if in_view else 1e-3)
        if not in_view:
            np.testing.assert_allclose(_np(lw_t), np.asarray(lw_j),
                                       rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(_np(r_t), np.asarray(r_j))


# --- the pieces -----------------------------------------------------------

@pytest.mark.parametrize("case", ["no_mask", "partly_masked", "fully_masked"])
def test_masked_update_matches_jax(case):
    rng = np.random.default_rng({"no_mask": 0, "partly_masked": 1,
                                 "fully_masked": 2}[case])
    n, ny, nl = 4, 5, 8
    mask = {"no_mask": np.ones(ny), "partly_masked": np.array([1, 0, 1, 1, 0]),
            "fully_masked": np.zeros(ny)}[case].astype(np.float32)
    yhat = rng.normal(size=(n, ny)).astype(np.float32)
    H = rng.normal(size=(n, ny, nl)).astype(np.float32)
    A = rng.normal(size=(n, nl, nl)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) / nl + np.eye(nl)).astype(np.float32)
    xl = rng.normal(size=(n, nl)).astype(np.float32)
    y = rng.normal(size=ny).astype(np.float32)
    y[mask == 0] = np.nan
    R = (0.1 * np.eye(ny)).astype(np.float32)
    ref = jax.jit(jkalman.kalman_update_masked_batched, static_argnums=7)(
        *(jnp.asarray(a) for a in (yhat, H, P, xl, y, R, mask)), 1e-3)
    got = tkalman.kalman_update_masked_batched(
        *(t32(a) for a in (yhat, H, P, xl, y, R, mask)), 1e-3)
    for g, r, tol in zip(got[:3], ref[:3], (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=tol, rtol=1e-5)
    np.testing.assert_array_equal(_np(got[3]), np.asarray(ref[3]))
    if case == "fully_masked":
        np.testing.assert_array_equal(_np(got[0]), xl)
        np.testing.assert_allclose(_np(got[2]), 0.0, atol=1e-6)
    # one particle: the unbatched update and its log-weight
    one = tkalman.kalman_update_masked(
        *(t32(a) for a in (yhat[0], H[0], P[0], xl[0], y, R, mask)), 1e-3)
    one_j = jax.jit(jkalman.kalman_update_masked, static_argnums=7)(
        *(jnp.asarray(a) for a in (yhat[0], H[0], P[0], xl[0], y, R, mask)),
        1e-3)
    for g, r in zip(one[:3], one_j[:3]):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=1e-4,
                                   rtol=1e-5)
    lw = tkalman.masked_log_weights(
        *(t32(a) for a in (yhat[0], H[0], P[0], y, R, mask)), 1e-3)[0]
    np.testing.assert_allclose(float(lw), float(one_j[2]), atol=1e-4,
                               rtol=1e-5)


def test_pinhole_model_matches_jax(toy):
    rng = np.random.default_rng(4)
    n = 7
    xn = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                         rng.uniform(-np.pi, np.pi, (n, 1))], -1) \
        .astype(np.float32)
    xl = toy["x0_lin"][:n]
    jm = jmake(JCamera(*CAM), M)
    tm = make_pinhole2d_model(PinholeCamera(*CAM), M)
    yhat_j, H_j = jax.jit(jax.vmap(jm.measure))(jnp.asarray(xn),
                                                jnp.asarray(xl))
    yhat_t, H_t = tm.measure(t32(xn), t32(xl))
    np.testing.assert_allclose(_np(yhat_t), np.asarray(yhat_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(H_t), np.asarray(H_j), rtol=1e-5,
                               atol=1e-5)
    lm = xl.reshape(n, M, 2)
    y_j, nv_j = jax.vmap(lambda a, b: jproject(JCamera(*CAM), a, b))(
        jnp.asarray(xn), jnp.asarray(lm))
    y_t, nv_t = project(PinholeCamera(*CAM), t32(xn), t32(lm))
    np.testing.assert_array_equal(_np(nv_t), np.asarray(nv_j))
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    u = np.array([0.1, -0.2, 0.05], np.float32)
    ref = jax.vmap(lambda k, x: jm.dynamics(k, x, jnp.asarray(u), 1.0,
                                            jnp.asarray(toy["Q"])))(
        keys, jnp.asarray(xn))
    w = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,)))(keys))
    got = tm.dynamics(t32(w), t32(xn), t32(u), 1.0, t32(toy["Q"]))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


def test_loader_matches_jax_with_its_draws():
    """curve-x2.mat corrupted with JAX's own draws (load_data.m:80-129),
    four id swaps included."""
    key = jax.random.PRNGKey(11)
    n_shuffle = 4
    ref = jload(key, n_shuffle=n_shuffle)
    T, Mv = ref.y.shape
    k_u, k_th, k_y, k_s = jax.random.split(key, 4)
    sw_keys = jax.random.split(jax.random.fold_in(k_s, 1), n_shuffle)
    draws = SparseVisualDraws(
        z_pos=np.asarray(jax.random.normal(k_u, (T - 1, 2))),
        z_theta=np.asarray(jax.random.normal(k_th, (T - 1, 1))),
        z_y=np.asarray(jax.random.normal(k_y, (T, Mv))),
        t_shuffle=np.sort(np.asarray(
            jax.random.randint(k_s, (n_shuffle,), 0, T))),
        j_shuffle=np.array([int(jax.random.randint(k, (), 0, Mv // 2 - 1))
                            for k in sw_keys]),
    )
    got = load_sparse_visual(n_shuffle=n_shuffle, draws=draws, device="cpu")
    np.testing.assert_array_equal(_np(got.y), np.asarray(ref.y))
    np.testing.assert_array_equal(_np(got.u), np.asarray(ref.u))
    np.testing.assert_array_equal(got.landmarks, ref.landmarks)
    np.testing.assert_array_equal(got.ground_truth, ref.ground_truth)
    assert got.camera == tuple(ref.camera) and got.init_theta == ref.init_theta


def test_map_and_path_rmse_matches_jax(toy):
    rng = np.random.default_rng(5)
    map_est = toy["landmarks"] + 0.1 * rng.normal(size=(M, 2))
    traj_est = toy["truth"] + 0.1 * rng.normal(size=toy["truth"].shape)
    got = map_and_path_rmse(toy["landmarks"], t32(map_est), toy["truth"],
                            t32(traj_est))
    ref = jmap_rmse(toy["landmarks"], map_est.astype(np.float32),
                    toy["truth"], traj_est.astype(np.float32))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-4)


def test_sparse_visual_workload_quick(tmp_path):
    """tests/test_workloads.py:21-30's configuration and gates; with
    ``plot_dir`` the PF's landmark map figure where matplotlib is installed,
    and an ImportError naming it before any work where it is not."""
    import importlib.util

    cfg = SV.SparseVisualConfig(n_particles_pf=15, n_particles_ps=5,
                                n_sweeps=2)
    if importlib.util.find_spec("matplotlib") is None:
        with pytest.raises(ImportError, match="matplotlib"):
            SV.run(cfg, device="cpu", plot_dir=str(tmp_path))
        out = SV.run(cfg, device="cpu")
    else:
        out = SV.run(cfg, device="cpu", plot_dir=str(tmp_path))
        assert (tmp_path / "sparse-visual-pf-map.png").stat().st_size > 1000
    assert out["n_landmarks"] == 20 and out["n_steps"] == 197
    assert np.isfinite(out["pf"]["rmse_path"])
    assert out["pf"]["rmse_map"] < 2.0
    assert np.isfinite(out["ps"]["rmse_map"])


# --- what the sparse path refuses -------------------------------------------

def test_sparse_path_refuses_tf32_on_cuda(toy, monkeypatch):
    """On a CUDA device with TF32 matmuls on, the sparse filter and smoother
    refuse to start (the JAX package forces full-f32 matmuls there,
    rbslam_tpu/engines/rbpf.py:231-242). The check comes before any tensor
    reaches the device, so it runs here without a card."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    args = _args(toy, 4, False)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        run_rbpf(*args, RBPFConfig(n_particles=4), generator=None,
                 device="cuda")
    with pytest.raises(RuntimeError, match="allow_tf32"):
        run_rbps(*args, RBPSConfig(n_particles=4, n_sweeps=1),
                 generator=None, device="cuda")
    # on the CPU the flag does not matter
    res = run_rbpf(*args, RBPFConfig(n_particles=4), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(res.logw).all()


def test_sparse_path_rejections(toy):
    args = _args(toy, 4, False)
    gen = torch.Generator().manual_seed(0)
    # NaN observations on a kernel path (as the JAX package's wrapper)
    with pytest.raises(ValueError, match="NaN"):
        run_rbpf(*args, RBPFConfig(n_particles=4, kf_kernel="lowrank"),
                 generator=gen, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        run_rbpf(*args, RBPFConfig(n_particles=4, cov_dtype="bfloat16"),
                 generator=gen, device="cpu")
    with pytest.raises(ValueError, match="dense features only"):
        run_rbps_information_form(*args, RBPSConfig(n_particles=4,
                                                    n_sweeps=1),
                                  generator=gen, device="cpu")
