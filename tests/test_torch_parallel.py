"""The port's mesh path (rbslam_tpu_torch/parallel/ and the ``mesh``
argument of run_rbpf and run_rbps_information_form) against the JAX
package's 8-device mesh runs, case for case as tests/test_sharding.py, and
against the port's unsharded runs, on the CPU.

The port runs on 8 gloo ranks of CPU processes (tests/torch_ranks.py;
the children import torch and the port only), started once per mesh
shape, (8, 1) and (4, 2), while this process runs JAX on the 8 virtual CPU
devices of tests/conftest.py; JAX's draws (its key flow) are injected into
the port. Tolerances are test_sharding.py's: the step xn atol 1e-5, logw
1e-4, xl 1e-3, ess rtol 1e-4; the full filter ancestors equal, traj_mean
atol 1e-5, xl_mean 1e-4, log_evidence and ess rtol 1e-4; the ESS-gated
run traj_mean 1e-5; the information-form smoother XNK 1e-4, XLK 1e-3; the
resamplers index for index at N=256; Woodbury atol 1e-5, hldM rtol 1e-5,
the quadratic form rtol 1e-4; the island resampler's children on their
shards, its mass atol 3e-3 over 200 draws. The Joseph form on the mesh
(the port's row-block algebra against JAX's (I - KC) P (I - KC)') is held
at the same tolerances as the runs without it; a resumed mesh smoother
equals the unbroken one bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from rbslam_tpu.basis import hypercube_basis as jhypercube_basis  # noqa: E402
from rbslam_tpu.engines import RBPFConfig as JFConfig  # noqa: E402
from rbslam_tpu.engines import RBPSConfig as JSConfig  # noqa: E402
from rbslam_tpu.engines import run_rbpf as jrun_rbpf  # noqa: E402
from rbslam_tpu.engines import (  # noqa: E402
    run_rbps_information_form as jrun_info,
)
from rbslam_tpu.engines.rbps_info import (  # noqa: E402
    _woodbury_rank_ny as jwoodbury,
)
from rbslam_tpu.ops.resampling import resample_indices as jresample  # noqa: E402
from rbslam_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from rbslam_tpu.parallel import sharded_step_fn as jstep_fn  # noqa: E402
from rbslam_tpu.parallel.resampling import (  # noqa: E402
    sharded_resample_indices as jsharded_resample,
)
from rbslam_tpu.parallel.resampling import (  # noqa: E402
    sharded_resample_local as jsharded_local,
)
from rbslam_tpu.parallel.sharded import (  # noqa: E402
    ShardedParticleState as JState,
)
from rbslam_tpu.parallel.sharded import (  # noqa: E402
    shard_rbpf_state as jshard_state,
)
from rbslam_tpu_torch.engines import (  # noqa: E402
    RBPFConfig,
    RBPSConfig,
    run_rbpf,
    run_rbps_information_form,
)
from rbslam_tpu_torch.engines.rbps_info import _woodbury_rank_ny  # noqa: E402
from rbslam_tpu_torch.ops.resampling import resample_indices  # noqa: E402
from rbslam_tpu_torch.parallel import initialize_distributed  # noqa: E402

from test_rbpf import THETA, _radio_setup  # noqa: E402
from test_torch_sparse import CAM  # noqa: E402
from test_torch_sparse import _args as sparse_args  # noqa: E402
from test_torch_sparse import _make_toy  # noqa: E402
from test_torch_sparse import filter_noise as sparse_noise  # noqa: E402
from test_torch_radio import filter_noise  # noqa: E402
from test_torch_smoothers import dyn_normals, smoother_noise  # noqa: E402
from torch_ranks import Ranks, radio_problem  # noqa: E402

SCHEMES = ("systematic", "stratified", "multinomial")
T_RADIO = 32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _devices(shape):
    return jmake_mesh(*shape, devices=jax.devices()[:8])


# --- JAX's draws ---------------------------------------------------------------

def step_draws(key, n):
    """The sharded step's draws: k_res, k_dyn = split(key); the systematic
    u0 = uniform(k_res, ()); per particle split(k_dyn, n)[i] -> kp, kq
    and mag3d's normal(kp, (3,)), normal(kq, (3,))."""
    k_res, k_dyn = jax.random.split(key)
    w = []
    for kk in jax.random.split(k_dyn, n):
        kp, kq = jax.random.split(kk)
        w.append(np.concatenate([np.asarray(jax.random.normal(kp, (3,))),
                                 np.asarray(jax.random.normal(kq, (3,)))]))
    return np.asarray(jax.random.uniform(k_res, ())), np.stack(w)


def island_noise(key, T, n, n_shards):
    """The filter's draws under dist_resampling='local' (systematic): per
    step and shard s the offset uniform(fold_in(k_res, s), ())
    (rbslam_tpu/parallel/resampling.py:176), and the dynamics' normals."""
    key, _ = jax.random.split(key)
    u, w = [], []
    for k in jax.random.split(key, T - 1):
        k_res, k_dyn = jax.random.split(k)
        u.append([np.asarray(jax.random.uniform(jax.random.fold_in(k_res, s),
                                                ()))
                  for s in range(n_shards)])
        w.append(dyn_normals(k_dyn, n, 1))
    return np.asarray(u, np.float32), np.stack(w)


# --- both packages' runs ------------------------------------------------------

def _inputs():
    """Every case's inputs as numpy arrays, with JAX's problems and draws."""
    model, state0, (y_t, u, Q, R) = graft._build(m_basis=29, n_particles=16)
    b = jhypercube_basis(29, np.array([1.5, 1.5, 1.0]))
    step = {"NN": b.NN, "L": b.L, "eig": b.eigenvalues,
            **{k: np.asarray(v) for k, v in zip(("xn", "xl", "P", "logw"),
                                                 state0)},
            "y_t": np.asarray(y_t), "u": np.asarray(u), "Q": np.asarray(Q),
            "R": np.asarray(R),
            "draws": [step_draws(jax.random.PRNGKey(0), 16)],
            "chain_draws": [step_draws(jax.random.fold_in(
                jax.random.PRNGKey(1), i), 16) for i in range(3)]}
    data, _, basis, center, k, Qr = _radio_setup()
    radio = {"NN": basis.NN, "L": basis.L, "eig": basis.eigenvalues,
             "center": np.asarray(center), "k": np.asarray(k),
             "Q": np.asarray(Qr), "R": np.array([[THETA[2]]], np.float32),
             "dx": np.asarray(data.dx), "y": np.asarray(data.y),
             "init_state": np.asarray(data.init_state)}
    key = jax.random.PRNGKey(7)
    w = jax.random.uniform(jax.random.PRNGKey(8), (256,))
    resample = {"w": np.asarray(w / w.sum()), "u": {
        "systematic": np.asarray(jax.random.uniform(key, ())),
        "stratified": np.asarray(jax.random.uniform(key, (256,))),
        "multinomial": np.asarray(jax.random.uniform(key, (256,)))}}
    w = jax.random.uniform(jax.random.PRNGKey(5), (256,))
    keys = [jax.random.PRNGKey(0)] + [jax.random.PRNGKey(100 + i)
                                      for i in range(200)]
    island = {"w": np.asarray(w / w.sum()), "u": [
        np.asarray(jax.vmap(lambda s, kk=kk: jax.random.uniform(
            jax.random.fold_in(kk, s), ()))(jnp.arange(8)))
        for kk in keys]}

    def rbpf(key, **cfg):
        u, wn = filter_noise(jax.random.PRNGKey(key), T_RADIO,
                             cfg["n_particles"], 1, "systematic")
        return {"config": {"resampling": "systematic", **cfg}, "u": u,
                "w": wn, "key": key}

    u_loc, w_loc = island_noise(jax.random.PRNGKey(4), T_RADIO, 64, 8)
    info_noise = smoother_noise(jax.random.PRNGKey(3), 2, T_RADIO, 16, 1,
                                "multinomial", info_form=True)
    wkey = jax.random.PRNGKey(0)
    A = 0.2 * jax.random.normal(wkey, (8, 64, 64))
    M = jnp.einsum("pij,pkj->pik", A, A) + 3.0 * jnp.eye(64)
    Us = [0.4 * jax.random.normal(jax.random.fold_in(wkey, i), (8, 64, 3))
          for i in range(2)]
    rng = np.random.default_rng(10)
    A = rng.normal(size=(16, 32, 32))
    kalman = {"P": (A @ A.transpose(0, 2, 1) / 32 + np.eye(32))
              .astype(np.float32),
              "xl": rng.normal(size=(16, 32)).astype(np.float32)}
    for form, ny in (("small", 3), ("lax", 4)):
        kalman[form] = {
            "C": rng.normal(size=(16, ny, 32)).astype(np.float32),
            "y": rng.normal(size=ny).astype(np.float32),
            "R": (0.5 * np.eye(ny)).astype(np.float32)}
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    y = rng.normal(size=5).astype(np.float32)
    y[mask == 0] = np.nan
    kalman["masked"] = {
        "yhat": rng.normal(size=(16, 5)).astype(np.float32),
        "H": rng.normal(size=(16, 5, 32)).astype(np.float32), "y": y,
        "R": (0.3 * np.eye(5)).astype(np.float32), "mask": mask}
    toy = _make_toy(jnp.pi / 2)       # camera facing the circle's center
    u_sp, w_sp = sparse_noise(jax.random.PRNGKey(5), toy["y"].shape[0], 16)
    sparse = {"camera": CAM, "M": 6, "n": 16, "toy": toy, "u": u_sp,
              "w": w_sp, "args": [np.asarray(a) for a in
                                  sparse_args(toy, 16, True)[1:-1]]}
    return {
        "kalman": kalman, "sparse": sparse,
        "step": step, "radio": radio, "resample": resample, "island": island,
        "rbpf_full": rbpf(0, n_particles=16),
        "rbpf_joseph": rbpf(6, n_particles=16, joseph=True),
        "rbpf_ess": rbpf(2, n_particles=16, ess_threshold=0.5),
        "rbpf_local": {"config": {"n_particles": 64,
                                  "resampling": "systematic",
                                  "dist_resampling": "local"},
                       "u": u_loc, "w": w_loc, "key": 4},
        "info": {"config": {"n_particles": 16, "n_sweeps": 2},
                 "noise": info_noise},
        "info_joseph": {"config": {"n_particles": 16, "n_sweeps": 2,
                                   "joseph": True},
                        "noise": info_noise},
        "woodbury": {"W": np.asarray(jnp.linalg.inv(M)),
                     "hldM": np.asarray(0.5 * jnp.linalg.slogdet(M)[1]),
                     "U": [np.asarray(Us[0]), np.asarray(0.2 * Us[1])],
                     "sign": [1.0, -1.0],
                     "v": np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                                       (8, 64)))},
    }


def _jax_runs(inp):
    """The JAX package's runs of test_sharding.py on the 8 virtual
    devices."""
    s = inp["step"]
    model, state0, (y_t, u, Q, R) = graft._build(m_basis=29, n_particles=16)
    state0, mask = JState(*state0), jnp.ones_like(y_t)
    out = {}
    for shape in ((8, 1), (4, 2)):
        mesh = _devices(shape)
        st = jshard_state(state0, mesh, shard_map_axis=shape[1] > 1)
        out["step", shape] = jstep_fn(model, mesh, R)(
            jax.random.PRNGKey(0), st, y_t, mask, u, Q, jnp.asarray(0.01))
    mesh42 = _devices((4, 2))
    step, st = jstep_fn(model, mesh42, R), jshard_state(state0, mesh42)
    for i in range(3):
        st, ess = step(jax.random.fold_in(jax.random.PRNGKey(1), i), st, y_t,
                       mask, u, Q, jnp.asarray(0.01))
    out["chain"] = (st, ess)
    del s

    data, jmodel, basis, center, k, Qr = _radio_setup()
    args = (jmodel, data.dx, data.y, data.init_state, jnp.zeros(basis.m),
            jnp.diag(k), Qr, jnp.array([[THETA[2]]]), 1.0)
    for name, shape in (("rbpf_full", (8, 1)), ("rbpf_full", (4, 2)),
                        ("rbpf_ess", (8, 1)), ("rbpf_local", (8, 1)),
                        ("rbpf_joseph", (8, 1)), ("rbpf_joseph", (4, 2))):
        r = inp[name]
        out[name, shape] = jrun_rbpf(jax.random.PRNGKey(r["key"]), *args,
                                     JFConfig(**r["config"]),
                                     mesh=_devices(shape))
    toy = inp["sparse"]["toy"]
    out["sparse"] = jrun_rbpf(jax.random.PRNGKey(5), *sparse_args(toy, 16, True),
                              JFConfig(n_particles=16), mesh=mesh42)
    for name in ("info", "info_joseph"):
        out[name] = jrun_info(jax.random.PRNGKey(3), *args,
                              JSConfig(**inp[name]["config"]), mesh=mesh42)
    mesh81 = _devices((8, 1))
    r = inp["resample"]
    for mode in ("replicated_cdf", "prefix"):
        for scheme in SCHEMES:
            out["resample", mode, scheme] = np.asarray(jsharded_resample(
                jax.random.PRNGKey(7), jnp.asarray(r["w"]), mesh81, scheme,
                mode))
    out["island"] = jsharded_local(jax.random.PRNGKey(0),
                                   jnp.asarray(inp["island"]["w"]), mesh81)
    r = inp["woodbury"]
    W, hldM = jnp.asarray(r["W"]), jnp.asarray(r["hldM"])
    for U, sign in zip(r["U"], r["sign"]):
        W, hldM, _ = jwoodbury(W, hldM, jnp.asarray(U), sign, 1e-9)
    v = jnp.asarray(r["v"])
    out["woodbury"] = (W, hldM, jnp.einsum("pi,pij,pj->p", v, W, v))
    return out


def _port_runs(inp):
    """The port's unsharded runs on the same inputs and draws."""
    out = {}
    args = radio_problem(inp["radio"]).rbpf_args()
    for name in ("rbpf_full", "rbpf_ess", "rbpf_joseph"):
        r = inp[name]
        out[name] = run_rbpf(*args, RBPFConfig(**r["config"]),
                             generator=None, device="cpu",
                             noise=(r["u"], r["w"]))
    out["global_64"] = run_rbpf(
        *args, RBPFConfig(n_particles=64, resampling="systematic"),
        generator=None, device="cpu",
        noise=filter_noise(jax.random.PRNGKey(4), T_RADIO, 64, 1,
                           "systematic"))
    r = inp["sparse"]
    out["sparse"] = run_rbpf(*sparse_args(r["toy"], 16, False),
                             RBPFConfig(n_particles=16), generator=None,
                             device="cpu", noise=(r["u"], r["w"]))
    for name in ("info", "info_joseph"):
        out[name] = run_rbps_information_form(
            *args, RBPSConfig(**inp[name]["config"]), generator=None,
            device="cpu", noise=inp[name]["noise"])
    r = inp["woodbury"]
    W, hldM = torch.tensor(r["W"]), torch.tensor(r["hldM"])
    for U, sign in zip(r["U"], r["sign"]):
        W, hldM, _ = _woodbury_rank_ny(W, hldM, torch.tensor(U), sign, 1e-9)
    out["woodbury"] = (W, hldM)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both rank groups, run JAX and the port's unsharded runs
    meanwhile, then collect every rank's results."""
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("ranks")
    ranks = {
        (8, 1): Ranks(tmp / "m81", 8, (8, 1), [
            "step", "resamplers", "island", "rbpf_full", "rbpf_ess",
            "rbpf_local", "rbpf_joseph", "kernel_refusal", "hybrid",
            "validation"], inp),
        (4, 2): Ranks(tmp / "m42", 8, (4, 2), [
            "step", "chain", "info", "info_joseph", "info_resume",
            "rbpf_full", "rbpf_joseph", "woodbury", "sparse",
            "kalman_forms"],
            inp),
    }
    ref = _jax_runs(inp)
    port = _port_runs(inp)
    got = {shape: r.results() for shape, r in ranks.items()}
    return {"inp": inp, "jax": ref, "port": port, "ranks": got}


def _rank0(runs, shape):
    return runs["ranks"][shape][0]


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_step_matches_single_device(runs, mesh_shape):
    out = _rank0(runs, mesh_shape)["step"]
    ref, ess_ref = runs["jax"]["step", mesh_shape]
    np.testing.assert_allclose(_np(out["xn"]), np.asarray(ref.xn), atol=1e-5)
    np.testing.assert_allclose(_np(out["logw"]), np.asarray(ref.logw),
                               atol=1e-4)
    np.testing.assert_allclose(_np(out["xl"]), np.asarray(ref.xl), atol=1e-3)
    np.testing.assert_allclose(float(out["ess"]), float(ess_ref), rtol=1e-4)
    # (8, 1) keeps whole rows on each rank: the same P as the (4, 2) ranks'
    # row blocks gathered
    other = _rank0(runs, (4, 2) if mesh_shape == (8, 1) else (8, 1))["step"]
    np.testing.assert_allclose(_np(out["P"]), _np(other["P"]), rtol=1e-5,
                               atol=1e-5)


def test_multi_step_sharded_chain(runs):
    """Three steps on (4, 2): finite, and JAX's chain at the step test's
    tolerances."""
    out = _rank0(runs, (4, 2))["chain"]
    ref, ess_ref = runs["jax"]["chain"]
    assert bool(torch.isfinite(out["logw"]).all())
    assert float(out["ess"]) > 0
    np.testing.assert_allclose(_np(out["xn"]), np.asarray(ref.xn), atol=1e-5)
    np.testing.assert_allclose(_np(out["logw"]), np.asarray(ref.logw),
                               atol=1e-4)
    np.testing.assert_allclose(float(out["ess"]), float(ess_ref), rtol=1e-4)


def test_mesh_validation(runs):
    for rank in runs["ranks"][(8, 1)]:
        assert "3 x 2 != 8" in rank["validation"]


def _assert_info_run(runs, mesh_shape, name):
    ranks = runs["ranks"][mesh_shape]
    out, ref, port = ranks[0][name], runs["jax"][name], runs["port"][name]
    for field, atol in (("XNK", 1e-4), ("XLK", 1e-3)):
        np.testing.assert_allclose(_np(out[field]),
                                   np.asarray(getattr(ref, field)),
                                   atol=atol, err_msg=field)
        np.testing.assert_allclose(_np(out[field]),
                                   _np(getattr(port, field)), atol=atol,
                                   err_msg=field)
    assert torch.equal(out["ancestors"], port.ancestors)
    assert torch.equal(out["kept"], port.kept)
    # replicated on every rank
    assert all(torch.equal(r[name]["XNK"], out["XNK"]) for r in ranks)


@pytest.mark.parametrize("mesh_shape", [(4, 2)])
def test_sharded_info_smoother_matches_single_device(runs, mesh_shape):
    _assert_info_run(runs, mesh_shape, "info")


def test_sharded_info_smoother_joseph_matches_single_device(runs):
    """joseph=True on (4, 2) (the row-block Joseph form of ops/kalman.py in
    the forward pass) against JAX's mesh run and the port's unsharded run,
    at the smoother's tolerances."""
    _assert_info_run(runs, (4, 2), "info_joseph")


def test_sharded_info_smoother_resumes_bit_equal(runs):
    """On (4, 2), 1 sweep checkpointed and a resume to 2 (a generator seeded
    otherwise, its state from the checkpoint) equal the unbroken 2-sweep
    run in every field, bit for bit, on every rank; the checkpoint holds
    every rank's ancestors, and each rank resumes with its own columns."""
    for rank, r in enumerate(runs["ranks"][(4, 2)]):
        out = r["info_resume"]
        assert out["steps"] == [1, 2]
        for field, a in out["unbroken"].items():
            assert torch.equal(out["resumed"][field], a), (rank, field)
        assert torch.equal(out["first"]["XNK"][0], out["unbroken"]["XNK"][0])
        part = rank // 2
        assert torch.equal(out["saved"][:, :, 4 * part:4 * part + 4],
                           out["unbroken"]["ancestors"])


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mode", ["replicated_cdf", "prefix"])
def test_sharded_resampler_matches_single_device(runs, scheme, mode):
    out = _np(_rank0(runs, (8, 1))["resamplers"][mode, scheme])
    r = runs["inp"]["resample"]
    np.testing.assert_array_equal(out, runs["jax"]["resample", mode, scheme])
    np.testing.assert_array_equal(out, np.asarray(jresample(
        jax.random.PRNGKey(7), jnp.asarray(r["w"]), 256, scheme)))
    np.testing.assert_array_equal(out, _np(resample_indices(
        torch.tensor(r["u"][scheme]), torch.tensor(r["w"]), 256, scheme)))


def test_local_island_resampler_mass_preserving(runs):
    out = _rank0(runs, (8, 1))["island"]
    n, n_local = 256, 32
    w = runs["inp"]["island"]["w"]
    ai, logw_prev = _np(out["ai"][0]), _np(out["logw"][0])
    ai_ref, logw_ref = runs["jax"]["island"]
    np.testing.assert_array_equal(ai, np.asarray(ai_ref))
    np.testing.assert_allclose(logw_prev, np.asarray(logw_ref), rtol=1e-6)
    assert (ai // n_local == np.arange(n) // n_local).all(), \
        "children crossed shards"
    np.testing.assert_allclose(np.exp(logw_prev).sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.exp(logw_prev).reshape(8, n_local).sum(-1),
                               w.reshape(8, n_local).sum(-1), rtol=1e-5)
    # unbiasedness over 200 draws: E[#children of i] * child weight == w_i
    mass = np.zeros(n)
    np.add.at(mass, _np(out["ai"][1:]).ravel(),
              np.exp(_np(out["logw"][1:])).ravel())
    np.testing.assert_allclose(mass / 200, w, atol=3e-3)


def test_rbpf_mesh_local_resampling_runs(runs):
    out = _rank0(runs, (8, 1))["rbpf_local"]["whole"]
    ref = runs["jax"]["rbpf_local", (8, 1)]
    assert bool(torch.isfinite(out["logw"]).all())
    assert bool(torch.isfinite(out["traj_mean"]).all())
    anc = _np(out["ancestors"])
    assert (anc // 8 == (np.arange(64) // 8)[None, :]).all()
    np.testing.assert_array_equal(anc, np.asarray(ref.ancestors))
    np.testing.assert_allclose(_np(out["traj_mean"]),
                               np.asarray(ref.traj_mean), atol=1e-5)
    err = float((out["traj_mean"] - runs["port"]["global_64"].traj_mean)
                .abs().max())
    assert err < 0.5, f"island filter diverged from global: {err}"


def _assert_full_run(out, ref, atol_traj=1e-5):
    np.testing.assert_array_equal(_np(out["ancestors"]),
                                  _np(ref.ancestors))
    np.testing.assert_allclose(_np(out["traj_mean"]), _np(ref.traj_mean),
                               atol=atol_traj)
    np.testing.assert_allclose(_np(out["xl_mean"]), _np(ref.xl_mean),
                               atol=1e-4)
    np.testing.assert_allclose(float(out["log_evidence"]),
                               float(ref.log_evidence), rtol=1e-4)
    np.testing.assert_allclose(_np(out["ess"]), _np(ref.ess), rtol=1e-4)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_full_rbpf_mesh_matches_single_device(runs, mesh_shape):
    """The whole filter on the mesh equals JAX's mesh run and the port's
    unsharded run; the replicated fields are equal on every rank, and a
    step makes the collectives it should (T=32, symmetrized: per step
    six all-gathers (weights for the CDF, the ancestors' xn, xl and P
    rows, P C' over the map, the log-weights), one all-reduce (the best
    particle's row with the weighted mean), one all-to-all (P'^T))."""
    ranks = runs["ranks"][mesh_shape]
    out = ranks[0]["rbpf_full"]
    _assert_full_run(out["whole"], runs["jax"]["rbpf_full", mesh_shape])
    port = runs["port"]["rbpf_full"]
    _assert_full_run(out["whole"], port)
    for field in ("P_mean", "P_max", "xl_max", "traj_max",
                  "traj_sample_iwmax", "xn_traj", "P", "xn", "logw"):
        np.testing.assert_allclose(_np(out["whole"][field]),
                                   _np(getattr(port, field)), atol=1e-4,
                                   err_msg=field)
    assert int(out["rank"]["chol_retries"]) == int(port.chol_retries)
    for r in ranks:
        for field in ("traj_mean", "xl_mean", "P_mean", "ess"):
            assert torch.equal(r["rbpf_full"]["rank"][field],
                               out["rank"][field]), field
    n_steps = T_RADIO - 1
    assert out["counts"] == {
        "all_gather": 6 * n_steps + 2 + 4, "all_reduce": n_steps + 7,
        "reduce_scatter": 0, "all_to_all": n_steps + 1}


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_joseph_rbpf_mesh_matches_single_device(runs, mesh_shape):
    """run_rbpf with joseph=True on the mesh (the row-block Joseph form of
    ops/kalman.py) against JAX's mesh run and the port's unsharded run, at
    the full filter's tolerances; the same collectives as without it."""
    ranks = runs["ranks"][mesh_shape]
    out = ranks[0]["rbpf_joseph"]
    _assert_full_run(out["whole"], runs["jax"]["rbpf_joseph", mesh_shape])
    port = runs["port"]["rbpf_joseph"]
    _assert_full_run(out["whole"], port)
    np.testing.assert_allclose(_np(out["whole"]["P"]), _np(port.P),
                               atol=1e-4)
    assert out["counts"] == ranks[0]["rbpf_full"]["counts"]


def test_sparse_rbpf_mesh_matches_single_device(runs):
    """A sparse model (pinhole camera, masked EKF update) on (4, 2): the
    JAX package runs it there too (GSPMD), so the port's masked update
    takes the map axis (row blocks of P, P H' all-gathered, the
    symmetrization by all-to-all). Against JAX's (4, 2) run and the port's
    unsharded run, the sparse filter's tolerances
    (tests/test_torch_sparse.py)."""
    out = _rank0(runs, (4, 2))["sparse"]
    for ref in (runs["jax"]["sparse"], runs["port"]["sparse"]):
        np.testing.assert_array_equal(_np(out["ancestors"]),
                                      _np(ref.ancestors))
        for field in ("xl_mean", "logw", "traj_mean", "xl_max", "P_mean"):
            np.testing.assert_allclose(_np(out[field]),
                                       _np(getattr(ref, field)), atol=1e-4,
                                       err_msg=field)
        np.testing.assert_allclose(float(out["log_evidence"]),
                                   float(ref.log_evidence), rtol=1e-5)


@pytest.mark.parametrize("form", ["small", "lax", "masked"])
def test_map_axis_kalman_updates_match_unsharded(runs, form):
    """ops/kalman.py on (4, 2): the dense update's small form (ny = 3; C P'
    all-gathered by rows), its lax form (ny = 4; partial C P
    all-reduced) and the masked update (P H' all-gathered), each
    symmetrized by all-to-all, against the port's unsharded update (equal
    up to the order of the partial sums: 1e-5 of the scale) and JAX's (the
    tolerances of tests/test_torch_sparse.py)."""
    from rbslam_tpu.ops import kalman as jkalman
    from rbslam_tpu_torch.ops import kalman as tkalman

    out = _rank0(runs, (4, 2))["kalman_forms"][form]
    r = runs["inp"]["kalman"]
    if form == "masked":
        m = r["masked"]
        args = (m["yhat"], m["H"], r["P"], r["xl"], m["y"], m["R"],
                m["mask"])
        port = tkalman.kalman_update_masked_batched(
            *(torch.tensor(a) for a in args), 1e-3)
        ref = jax.jit(jkalman.kalman_update_masked_batched,
                      static_argnums=7)(*(jnp.asarray(a) for a in args), 1e-3)
    else:
        f = r[form]
        args = (f["C"], r["P"], r["xl"], f["y"], f["R"])
        port = tkalman.kalman_update_dense_batched_hld(
            *(torch.tensor(a) for a in args), 1e-3)
        ref = jkalman.kalman_update_dense_batched_hld(
            *(jnp.asarray(a) for a in args), 1e-3)
    for i, (o, p, j) in enumerate(zip(out, port, ref)):
        if o.dtype == torch.bool:
            assert torch.equal(o, p) and (_np(o) == np.asarray(j)).all()
            continue
        scale = float(p.abs().max())
        np.testing.assert_allclose(_np(o), _np(p), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=str(i))
        np.testing.assert_allclose(_np(o), np.asarray(j), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(i))


def test_rbpf_mesh_ess_adaptive_matches(runs):
    out = _rank0(runs, (8, 1))["rbpf_ess"]["whole"]
    for ref in (runs["jax"]["rbpf_ess", (8, 1)], runs["port"]["rbpf_ess"]):
        np.testing.assert_allclose(_np(out["traj_mean"]),
                                   _np(ref.traj_mean), atol=1e-5)
        np.testing.assert_array_equal(_np(out["ancestors"]),
                                      _np(ref.ancestors))


def test_rbpf_mesh_rejects_kernel_paths(runs):
    for rank in runs["ranks"][(8, 1)]:
        assert "single-device" in rank["kernel_refusal"]


@pytest.mark.parametrize("n_map", [2])
def test_woodbury_rowsharded_matches_unsharded(runs, n_map):
    out = _rank0(runs, (8 // n_map, n_map))["woodbury"]
    W, hldM, q = runs["jax"]["woodbury"]
    assert not any(out["retried"])
    np.testing.assert_allclose(_np(out["W"]), np.asarray(W), atol=1e-5)
    np.testing.assert_allclose(_np(out["hldM"]), np.asarray(hldM), rtol=1e-5)
    np.testing.assert_allclose(_np(out["q"]), np.asarray(q), rtol=1e-4)
    Wp, hldMp = runs["port"]["woodbury"]
    np.testing.assert_allclose(_np(out["W"]), _np(Wp), atol=1e-6)
    np.testing.assert_allclose(_np(out["hldM"]), _np(hldMp), rtol=1e-6)


def test_hybrid_mesh_single_process(runs):
    """This test process is a single-process launch: initialize_distributed
    does nothing. On the ranks (one host): map=2 gives (4, 2), map=3 is
    refused."""
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    for rank in runs["ranks"][(8, 1)]:
        h = rank["hybrid"]
        assert h["initialized"] is True
        assert h["shape"] == (4, 2) and h["names"] == ("particles", "map")
        assert "map=3" in h["refused"]


def test_ranks_never_import_jax(runs):
    for shape, ranks in runs["ranks"].items():
        for rank in ranks:
            assert rank["imported_jax"] == [], shape
