"""The whole slice: the port's lowrank RBPF against the JAX package's on the
same problem and the same random draws, on the CPU.

The problem is bench._build_problem(29, 16, 12, pallas_basis=True): n_lin
32 (padded to 128), T=12, i.e. one full rebase period of 8 plus a
remainder of 3. JAX's own draws (its key flow, rbslam_tpu/engines/
rbpf.py:436,523,549) are injected into the port through ``noise``.

Tolerances (as the JAX package's lowrank-vs-block test): ancestors and
retry counts equal; traj_mean atol 1e-3; xl_mean and P_mean atol 5e-3;
logw and log_evidence atol 1e-2.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rbslam_tpu.basis.laplace import domain_center  # noqa: E402
from rbslam_tpu.engines import RBPFConfig as JConfig  # noqa: E402
from rbslam_tpu.engines import run_rbpf as jrun_rbpf  # noqa: E402
from rbslam_tpu.engines.rbpf import (  # noqa: E402
    reconstruct_trajectories as jreconstruct,
)
from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf  # noqa: E402
from rbslam_tpu_torch.engines.rbpf import reconstruct_trajectories  # noqa: E402
from rbslam_tpu_torch.utils import problem_from_numpy  # noqa: E402

N_P = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_noise(T, n, seed=0, scheme="systematic"):
    """The draws JAX's filter makes: key, k0 = split(key); step_keys =
    split(key, T-1); per step k_res, k_dyn = split(k); the resampling
    uniforms uniform(k_res, ()) for systematic or uniform(k_res, (n,))
    for multinomial and stratified; w = normal(k_dyn, (n, 6))."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    shape = () if scheme == "systematic" else (n,)
    u, w = [], []
    for k in jax.random.split(key, T - 1):
        k_res, k_dyn = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_res, shape)))
        w.append(np.asarray(jax.random.normal(k_dyn, (n, 6), jnp.float32)))
    return (np.stack(u).reshape((T - 1,) + shape),
            np.stack(w).reshape(T - 1, n, 6))


def build_slice_problem():
    """bench._build_problem(29, 16, 12, pallas_basis=True) for both
    packages: (port Problem, JAX run_rbpf arguments before config, T)."""
    data, model, potential, k, Q, R = bench._build_problem(
        29, N_P, 12, pallas_basis=True
    )
    b = potential.basis
    center = np.asarray(jnp.asarray(domain_center(data.LL), jnp.float32))
    prob = problem_from_numpy(
        b.NN, b.L, b.eigenvalues, center, np.asarray(k), np.asarray(Q),
        np.asarray(R), 0.01, np.asarray(data.dx), np.asarray(data.y),
        np.asarray(data.init_state), device="cpu",
    )
    jargs = (model, data.dx, data.y, data.init_state,
             jnp.zeros(potential.n_lin), jnp.diag(k), Q, R, 0.01)
    return prob, jargs, int(data.y.shape[0])


def assert_runs_match(port, ref, map_rtol=0.0):
    """The slice tolerances: ancestors and retry counts equal; traj_mean
    atol 1e-3; xl_mean and P_mean 5e-3 (plus ``map_rtol`` of the value);
    logw and log_evidence 1e-2."""
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))
    assert int(port.chol_retries) == int(ref.chol_retries)
    np.testing.assert_allclose(_np(port.traj_mean), _np(ref.traj_mean),
                               atol=1e-3)
    for field in ("xl_mean", "P_mean"):
        assert getattr(port, field).shape == getattr(ref, field).shape
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=5e-3,
                                   rtol=map_rtol, err_msg=field)
    np.testing.assert_allclose(_np(port.logw), _np(ref.logw), atol=1e-2)
    np.testing.assert_allclose(float(port.log_evidence),
                               float(ref.log_evidence), atol=1e-2)


def _config(cfg_cls, **kw):
    base = dict(n_particles=N_P, resampling="systematic",
                symmetrize_cov=False, kf_kernel="lowrank")
    base.update(kw)
    return cfg_cls(**base)


@pytest.fixture(scope="module")
def slice_run():
    prob, jargs, T = build_slice_problem()
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs, _config(JConfig))
    noise = jax_noise(T, N_P)
    port = run_rbpf(*prob.rbpf_args(), _config(RBPFConfig), generator=None,
                    device="cpu", noise=noise)
    return {"ref": ref, "port": port, "prob": prob, "jargs": jargs,
            "noise": noise, "T": T}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_slice_ancestors_equal(slice_run):
    port, ref = slice_run["port"], slice_run["ref"]
    assert port.ancestors.dtype == torch.int32
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))


def test_slice_trajectories(slice_run):
    port, ref = slice_run["port"], slice_run["ref"]
    for field in ("traj_mean", "traj_max", "traj_sample_iwmax", "xn_traj",
                  "xn_hist", "xn"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=1e-3,
                                   err_msg=field)


@pytest.mark.parametrize("field", ["xl_mean", "P_mean", "xl_max", "P_max",
                                   "xl", "P"])
def test_slice_map(slice_run, field):
    port, ref = slice_run["port"], slice_run["ref"]
    assert getattr(port, field).shape == getattr(ref, field).shape
    np.testing.assert_allclose(_np(getattr(port, field)),
                               _np(getattr(ref, field)), atol=5e-3)


def test_slice_weights_and_counters(slice_run):
    port, ref = slice_run["port"], slice_run["ref"]
    np.testing.assert_allclose(_np(port.logw), _np(ref.logw), atol=1e-2)
    np.testing.assert_allclose(float(port.log_evidence),
                               float(ref.log_evidence), atol=1e-2)
    np.testing.assert_allclose(_np(port.ess), _np(ref.ess), rtol=1e-3)
    assert int(port.chol_retries) == int(ref.chol_retries)


def test_slice_bf16_matches_jax_bf16(slice_run):
    """bf16 covariance storage: the port's run equals the JAX package's bf16
    run on the same draws, and departs from the f32 run exactly as the
    JAX package's bf16 run departs from its own f32 run (by up to ~0.09 in
    traj_mean at T=12 on this problem, through resampling decisions that
    bf16 rounding changes)."""
    prob, jargs = slice_run["prob"], slice_run["jargs"]
    port = run_rbpf(*prob.rbpf_args(),
                    _config(RBPFConfig, cov_dtype="bfloat16"),
                    generator=None, device="cpu", noise=slice_run["noise"])
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs,
                    _config(JConfig, cov_dtype="bfloat16"))
    for field in ("traj_mean", "xl_mean", "P_mean", "logw"):
        assert bool(torch.isfinite(getattr(port, field)).all()), field
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))
    np.testing.assert_allclose(_np(port.traj_mean), _np(ref.traj_mean),
                               atol=1e-3)
    np.testing.assert_allclose(_np(port.xl_mean), _np(ref.xl_mean),
                               atol=5e-3)
    scale = float(np.abs(_np(ref.P_mean)).max())
    np.testing.assert_allclose(_np(port.P_mean), _np(ref.P_mean),
                               atol=2 ** -8 * scale)
    gap_port = _np(port.traj_mean) - _np(slice_run["port"].traj_mean)
    gap_ref = _np(ref.traj_mean) - _np(slice_run["ref"].traj_mean)
    np.testing.assert_allclose(gap_port, gap_ref, atol=1e-3)


def test_slice_generator_draws(slice_run):
    """Without injected noise the filter draws from the generator: the same
    seed gives the same run."""
    prob = slice_run["prob"]
    runs = [run_rbpf(*prob.rbpf_args(), _config(RBPFConfig),
                     generator=torch.Generator().manual_seed(3),
                     device="cpu") for _ in range(2)]
    assert torch.equal(runs[0].ancestors, runs[1].ancestors)
    assert torch.equal(runs[0].traj_mean, runs[1].traj_mean)
    assert bool(torch.isfinite(runs[0].xl_mean).all())


def test_T1_matches_jax(slice_run):
    prob = slice_run["prob"]
    jargs = slice_run["jargs"]
    model, dx, y = jargs[:3]
    ref = jrun_rbpf(jax.random.PRNGKey(0), model, dx[:0], y[:1], *jargs[3:],
                    _config(JConfig, n_particles=8))
    port = run_rbpf(prob.model, prob.dx[:0], prob.y[:1], *prob.rbpf_args()[3:],
                    _config(RBPFConfig, n_particles=8), generator=None,
                    device="cpu", noise=(np.zeros(0), np.zeros((0, 8, 6))))
    assert port.ancestors.shape == (0, 8)
    np.testing.assert_allclose(_np(port.xl_mean), _np(ref.xl_mean),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(port.logw), _np(ref.logw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(port.P_mean), _np(ref.P_mean), atol=5e-3)


def test_mag3d_model_matches_jax(slice_run):
    """The model's hooks: batched dynamics from the same standard normals,
    the per-particle Jacobian, the K4-backed batch Jacobian and the
    K1-backed rows Jacobian."""
    jmodel = slice_run["jargs"][0]
    tmodel = slice_run["prob"].model
    rng = np.random.default_rng(2)
    xn = np.concatenate([rng.uniform(-5, 5, (16, 3)),
                         rng.normal(size=(16, 4))], axis=1).astype(np.float32)
    xn[:, 3:] /= np.linalg.norm(xn[:, 3:], axis=1, keepdims=True)
    u = np.asarray(slice_run["jargs"][1])[0]
    Q = np.asarray(slice_run["jargs"][6])
    key = jax.random.PRNGKey(9)
    w = np.asarray(jax.random.normal(key, (16, 6), jnp.float32))
    ref = jmodel.dynamics_batch(key, jnp.asarray(xn), jnp.asarray(u), 0.01,
                                jnp.asarray(Q))
    port = tmodel.dynamics_batch(torch.tensor(w), torch.tensor(xn),
                                 torch.tensor(u), torch.tensor(0.01),
                                 torch.tensor(Q))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tmodel.meas_jacobian(torch.tensor(xn[0])).numpy(),
        np.asarray(jmodel.meas_jacobian(jnp.asarray(xn[0]))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tmodel.meas_jacobian_batch(torch.tensor(xn)).numpy(),
        np.asarray(jmodel.meas_jacobian_batch(jnp.asarray(xn))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tmodel.meas_jacobian_batch_rows(torch.tensor(xn), 128,
                                        torch.float32).numpy(),
        np.asarray(jmodel.meas_jacobian_batch_rows(jnp.asarray(xn), 128,
                                                   jnp.float32)),
        rtol=1e-5, atol=1e-5)


def test_reconstruct_trajectories_matches_jax():
    rng = np.random.default_rng(0)
    T, n = 9, 12
    hist = rng.normal(size=(T, n, 7)).astype(np.float32)
    anc = rng.integers(0, n, size=(T - 1, n)).astype(np.int32)
    port = reconstruct_trajectories(torch.tensor(hist), torch.tensor(anc))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jreconstruct(jnp.asarray(hist),
                                              jnp.asarray(anc))))


def test_masked_or_nan_y_rejected(slice_run):
    prob = slice_run["prob"]
    y_nan = prob.y.clone()
    y_nan[3, 0] = float("nan")
    args = list(prob.rbpf_args())
    args[2] = y_nan
    with pytest.raises(ValueError, match="NaN"):
        run_rbpf(*args, _config(RBPFConfig), generator=None, device="cpu",
                 noise=slice_run["noise"])
    mask = torch.ones_like(prob.y)
    mask[2, 0] = 0.0
    with pytest.raises(ValueError, match="mask"):
        run_rbpf(*prob.rbpf_args(), _config(RBPFConfig), generator=None,
                 device="cpu", noise=slice_run["noise"], mask=mask)


def ny4_problem(prob, jargs):
    """A dense model with four observation rows for both packages: the
    mag3d rows and the mean of the first two as a fourth, y and R
    extended to match. Returns (port run_rbpf arguments, JAX arguments)."""
    def extend(C, cat):
        return cat([C, 0.5 * (C[..., 0:1, :] + C[..., 1:2, :])], -2)

    jmodel = jargs[0]
    jmodel4 = jmodel._replace(
        ny=4, meas_jacobian_batch=None,
        meas_jacobian=lambda xn: extend(jmodel.meas_jacobian(xn),
                                        jnp.concatenate))
    tmodel = prob.model
    tmodel4 = tmodel._replace(
        ny=4, meas_jacobian_batch=None, meas_jacobian_batch_rows=None,
        meas_jacobian=lambda xn: extend(tmodel.meas_jacobian(xn), torch.cat))
    y = np.asarray(jargs[2])
    y4 = np.concatenate([y, 0.5 * (y[:, 0:1] + y[:, 1:2]) + 0.1], axis=-1)
    R4 = np.diag([10.0, 10.0, 10.0, 5.0]).astype(np.float32)
    targs = list(prob.rbpf_args())
    targs[0], targs[2], targs[7] = tmodel4, torch.tensor(y4), torch.tensor(R4)
    jargs4 = list(jargs)
    jargs4[0], jargs4[2], jargs4[7] = jmodel4, jnp.asarray(y4), jnp.asarray(R4)
    return targs, jargs4


@pytest.mark.parametrize("kf_kernel", ["xla", "block_gather", "lowrank"])
@pytest.mark.parametrize("symmetrize_cov", [True, False])
def test_dense_ny4_filter_matches_jax(slice_run, kf_kernel, symmetrize_cov,
                                      monkeypatch, recwarn):
    """A dense model with ny = 4 runs the lax-form update on the xla path,
    whatever kf_kernel names (the kernels take ny <= 3), as in the JAX
    package: none of the Kalman update wrappers (K1-K3 through
    kf_update_lowrank and kf_rebase, K5) is called, and a kernel path that
    was asked for says so in a warning."""
    from rbslam_tpu_torch.engines import rbpf as rbpf_module

    def not_on_this_path(*args, **kwargs):
        raise AssertionError("a Kalman update kernel wrapper was called")

    for name in ("kf_update_block_gather", "kf_update_lowrank", "kf_rebase"):
        monkeypatch.setattr(rbpf_module, name, not_on_this_path)
    targs, jargs4 = ny4_problem(slice_run["prob"], slice_run["jargs"])
    kw = dict(kf_kernel=kf_kernel, symmetrize_cov=symmetrize_cov)
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs4, _config(JConfig, **kw))
    recwarn.clear()
    port = run_rbpf(*targs, _config(RBPFConfig, **kw), generator=None,
                    device="cpu", noise=slice_run["noise"])
    said = [str(w.message) for w in recwarn.list
            if "runs the 'xla' path" in str(w.message)]
    assert len(said) == (0 if kf_kernel == "xla" else 1)
    assert all(repr(kf_kernel) in msg and "ny=4" in msg for msg in said)
    assert port.P.shape == (N_P, 32, 32)
    # P_mean entries of magnitude 400 differ by 2.6e-5 of their value (the
    # LAPACK factor-and-solve of S against XLA's, in float32): rtol 1e-4
    assert_runs_match(port, ref, map_rtol=1e-4)


@pytest.mark.parametrize("case", ["mesh", "sparse_model"])
def test_unported_paths_raise(slice_run, case):
    """A mesh with a KF kernel path (here lowrank) raises ValueError, for a
    dense model and for a sparse (EKF-linearized) one, as the JAX package
    does: the kernel paths are single-device (the mesh path itself:
    tests/test_torch_parallel.py)."""
    from rbslam_tpu_torch.models import PinholeCamera, make_pinhole2d_model

    prob = slice_run["prob"]
    args = list(prob.rbpf_args())
    kw = {"mesh": object()}
    if case == "sparse_model":
        args[0] = make_pinhole2d_model(PinholeCamera(1.5, 0.0, 1.0), 6)
    with pytest.raises(ValueError, match="single-device"):
        run_rbpf(*args, _config(RBPFConfig), generator=None, device="cpu",
                 noise=slice_run["noise"], **kw)


def test_unknown_kf_kernel_rejected(slice_run):
    prob = slice_run["prob"]
    with pytest.raises(ValueError, match="kf_kernel"):
        run_rbpf(*prob.rbpf_args(), _config(RBPFConfig, kf_kernel="block"),
                 generator=None, device="cpu", noise=slice_run["noise"])


def test_bean_6d_matches_jax():
    from rbslam_tpu.data import generate_trajectory as jgen
    from rbslam_tpu_torch.data import generate_trajectory as tgen

    for kw in ({}, {"n_laps": 1, "n_per_lap": 12}):
        port, ref = tgen("bean_6D", **kw), jgen("bean_6D", **kw)
        np.testing.assert_array_equal(port.pos, ref.pos)
        np.testing.assert_allclose(port.quat, ref.quat, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port.dx, ref.dx, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port.init_state, ref.init_state,
                                   rtol=1e-6, atol=1e-7)


def test_potential_field_draw_matches_jax():
    """Given the same standard-normal vectors (JAX's own draws), the port's
    curl-free field draw equals the JAX package's."""
    from rbslam_tpu.data.fields import draw_scalar_potential_field as jdraw
    from rbslam_tpu_torch.data import draw_scalar_potential_field as tdraw

    theta = (650.0, 1.2, 200.0, 10.0)
    LL = np.array([[-17.0, -9.0, -2.4], [15.0, 8.0, 2.4]])
    x = np.random.default_rng(1).uniform(-8, 8, size=(40, 3)
                                          ).astype(np.float32)
    x[:, 2] = 0.0
    key = jax.random.PRNGKey(4)
    ref = jdraw(key, jnp.asarray(x), 64, LL, theta)
    kw, kn = jax.random.split(key)
    z_w = np.asarray(jax.random.normal(kw, (67,), jnp.float32))
    z_n = np.asarray(jax.random.normal(kn, (40, 3), jnp.float32))
    port = tdraw(torch.tensor(x), 64, LL, theta, z_w=z_w, z_n=z_n)
    for field in ("weights", "f", "df", "y"):
        r = np.asarray(getattr(ref, field))
        np.testing.assert_allclose(getattr(port, field).numpy(), r,
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=field)


def test_port_builds_its_own_problem():
    """The port simulates the flagship dataset itself (no JAX on the card)
    and runs the filter on it."""
    from rbslam_tpu_torch.workloads.dense_mag import build_problem

    prob, data = build_problem(29, 12, seed=1, m_sim=64, device="cpu")
    assert prob.dx.shape == (11, 7) and prob.y.shape == (12, 3)
    assert data.pos.shape == (12, 3)
    assert bool(torch.isfinite(prob.y).all())
    res = run_rbpf(*prob.rbpf_args(), _config(RBPFConfig, n_particles=8),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    assert res.traj_mean.shape == (12, 7)
    assert bool(torch.isfinite(res.P_mean).all())


def test_package_never_imports_jax():
    """Import every module of the port with JAX and the JAX package made
    unimportable and run 2-step lowrank and block_gather filters, the radio
    workload with both smoothers, the dense-mag workload (EKF included),
    the kernel-part profile, a checkpointed smoother resumed, a trace, the
    CLI's usage, a planar dataset with its grid and, where matplotlib is
    installed, a figure."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["rbslam_tpu"] = None
        import importlib, pkgutil, tempfile
        import torch
        import rbslam_tpu_torch
        for mod in pkgutil.walk_packages(rbslam_tpu_torch.__path__,
                                         "rbslam_tpu_torch."):
            importlib.import_module(mod.name)
        from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf
        from rbslam_tpu_torch.workloads.dense_mag import build_problem
        import rbslam_tpu_torch.kernels, rbslam_tpu_torch.data
        prob, _ = build_problem(13, 2, seed=1, m_sim=32, device="cpu")
        for kf_kernel in ("lowrank", "block_gather"):
            res = run_rbpf(*prob.rbpf_args(),
                           RBPFConfig(n_particles=4, resampling="systematic",
                                      kf_kernel=kf_kernel),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
            assert res.traj_mean.shape == (2, 7)
        from rbslam_tpu_torch.workloads import dense_radio
        for smoother in ("cpf_as", "info_form"):
            out = dense_radio.run(
                dense_radio.DenseRadioConfig(
                    n_steps=6, n_particles=4, n_sweeps=2, m_basis=8,
                    m_sim=16, smoother=smoother), device="cpu")
            assert len(out["rmse_smoother_per_sweep"]) == 2
        from rbslam_tpu_torch.workloads import dense_mag, profile_kernel_parts
        out = dense_mag.run(dense_mag.DenseMagConfig(
            n_particles=4, n_sweeps=1, m_basis=8, m_sim=16, n_laps=1,
            n_per_lap=6), device="cpu")
        assert out["n_steps"] == 6 and "rmse_ekf_pos" in out
        prof = profile_kernel_parts.run("cpu", (4, 5, "float32"), reps=1)
        assert len(prof["rows"]) == 27
        from rbslam_tpu_torch import __main__ as cli
        from rbslam_tpu_torch.data import simulate_dense_dataset
        from rbslam_tpu_torch.engines import (
            RBPSConfig, run_rbps, run_rbps_information_form)
        from rbslam_tpu_torch.utils import latest_step, phase_annotation
        from rbslam_tpu_torch.utils import trace_to
        tmp = tempfile.mkdtemp()
        radio, _ = dense_radio.build_problem(
            dense_radio.DenseRadioConfig(n_steps=6, m_basis=8, m_sim=16),
            torch.Generator().manual_seed(1), device="cpu")
        with trace_to(tmp + "/trace"), phase_annotation("smoother"):
            for n in (1, 2):
                res = run_rbps(*radio.rbpf_args(), RBPSConfig(4, n),
                               generator=torch.Generator().manual_seed(n),
                               device="cpu", checkpoint_dir=tmp + "/ck")
        assert latest_step(tmp + "/ck") == 2 and res.XNK.shape[0] == 2
        try:
            cli.main(["--help"])
        except SystemExit as e:
            assert e.code == 0
        walk = lambda w, x, u, dt, Q: x + u + 0.1 * w
        data = simulate_dense_dataset(
            "circle_2D", (0.25, 2.0, 0.01), 0.01 * torch.eye(2), 1.0, walk,
            m_sim=16, traj_kwargs={"n_laps": 1, "dpsi_deg": 45.0},
            generator=torch.Generator().manual_seed(0))
        assert data.grid["f"].shape == (10000,) and data.dx.shape == (7, 2)
        import torch.distributed as dist
        from rbslam_tpu_torch.parallel import (
            collective_counts, gather_particles, make_mesh)
        dist.init_process_group("gloo", init_method="file://" + tmp
                                + "/store", rank=0, world_size=1)
        mesh = make_mesh(1, 1, device_type="cpu")
        for mode in ("replicated_cdf", "prefix", "local"):
            res = run_rbpf(*prob.rbpf_args(),
                           RBPFConfig(n_particles=4, resampling="systematic",
                                      dist_resampling=mode),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", mesh=mesh)
            assert gather_particles(res, mesh).P.shape == (4, 16, 16)
        res = run_rbps_information_form(
            *radio.rbpf_args(), RBPSConfig(4, 2),
            generator=torch.Generator().manual_seed(0), device="cpu",
            mesh=mesh)
        assert res.XNK.shape[0] == 2 and collective_counts()["all_gather"]
        dist.destroy_process_group()
        if importlib.util.find_spec("matplotlib") is not None:
            from rbslam_tpu_torch.viz import plot_trajectories
            plot_trajectories(tmp + "/t.png", truth=data.pos)
        assert not any(m == "jax" or m.startswith("jax.")
                       or m == "rbslam_tpu" or m.startswith("rbslam_tpu.")
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_slice_no_trajectories_bf16_matches_jax(slice_run):
    """store_trajectories=False on lowrank bf16 (the 131,072-particle bench
    row's configuration) at the slice's size: no [T, N, dn] history in
    either package (xn_hist and xn_traj empty), and P_mean summed with the
    weights cast to the bf16 storage dtype (the JAX package's quirk,
    rbslam_tpu/engines/rbpf.py:724-738). Tolerances of the r = 8 run:
    ancestors equal; traj_mean and traj_max atol 1e-3; xl_mean 5e-3;
    logw 1e-2; P_mean 2^-8 of its largest entry, as the bf16 run above."""
    prob, jargs = slice_run["prob"], slice_run["jargs"]
    kw = dict(cov_dtype="bfloat16", store_trajectories=False)
    port = run_rbpf(*prob.rbpf_args(), _config(RBPFConfig, **kw),
                    generator=None, device="cpu", noise=slice_run["noise"])
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs, _config(JConfig, **kw))
    for field in ("xn_hist", "xn_traj"):
        assert getattr(port, field).numel() == 0
        assert np.asarray(getattr(ref, field)).size == 0
    np.testing.assert_array_equal(_np(port.ancestors), _np(ref.ancestors))
    for field in ("traj_mean", "traj_max"):
        np.testing.assert_allclose(_np(getattr(port, field)),
                                   _np(getattr(ref, field)), atol=1e-3,
                                   err_msg=field)
    np.testing.assert_allclose(_np(port.xl_mean), _np(ref.xl_mean),
                               atol=5e-3)
    np.testing.assert_allclose(_np(port.logw), _np(ref.logw), atol=1e-2)
    scale = float(np.abs(_np(ref.P_mean)).max())
    np.testing.assert_allclose(_np(port.P_mean), _np(ref.P_mean),
                               atol=2 ** -8 * scale)


@pytest.mark.parametrize("period", [4, 16])
def test_slice_rebase_period_matches_jax(slice_run, period):
    """lowrank_period other than 8 (scripts/sweep_lowrank.py's r = 4 and
    16, factor widths rw = 12 and 48): at r = 4 the 11 steps are two full
    periods and a remainder of 3, at r = 16 one remainder period of 11.
    The r = 8 run's tolerances (assert_runs_match, and traj_max atol
    1e-3)."""
    prob, jargs = slice_run["prob"], slice_run["jargs"]
    port = run_rbpf(*prob.rbpf_args(),
                    _config(RBPFConfig, lowrank_period=period),
                    generator=None, device="cpu", noise=slice_run["noise"])
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs,
                    _config(JConfig, lowrank_period=period))
    assert_runs_match(port, ref)
    np.testing.assert_allclose(_np(port.traj_max), _np(ref.traj_max),
                               atol=1e-3)


@pytest.mark.parametrize("cov_dtype", ["float32", "bfloat16"])
def test_slice_live_rows_equal_all_rows(slice_run, monkeypatch, cov_dtype):
    """The lowrank loop passes K2 ``live_rows`` = ny times the phase of the
    rebase period (the later rows of Wt are still zero): the run equals,
    bit for bit in every result field, the same run with every factor row
    read (``live_rows`` dropped)."""
    import rbslam_tpu_torch.engines.rbpf as engine

    prob = slice_run["prob"]
    cfg = _config(RBPFConfig, cov_dtype=cov_dtype)
    live = run_rbpf(*prob.rbpf_args(), cfg, generator=None, device="cpu",
                    noise=slice_run["noise"])
    update = engine.kf_update_lowrank
    seen = []

    def all_rows(*args, live_rows=None, **kw):
        seen.append(live_rows)
        return update(*args, **kw)

    monkeypatch.setattr(engine, "kf_update_lowrank", all_rows)
    full = run_rbpf(*prob.rbpf_args(), cfg, generator=None, device="cpu",
                    noise=slice_run["noise"])
    assert seen == [3 * (t % 8) for t in range(slice_run["T"] - 1)]
    for field, a in live._asdict().items():
        assert torch.equal(a, getattr(full, field)), field
