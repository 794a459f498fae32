"""The dense ``xla`` filter path of the port, its resampling schemes and its
ESS gate, against the JAX package on the slice problem with JAX's draws
injected (bench._build_problem(29, 16, 12, pallas_basis=True), N_P=16,
T=12), and the path-level contracts: NaN observations on ``xla``
against the kernel paths, and the bf16 fence.

Tolerances are the slice's (tests/test_torch_rbpf.py): ancestors and
retry counts equal; traj_mean 1e-3; xl_mean and P_mean 5e-3; logw and
log_evidence 1e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from rbslam_tpu.engines import RBPFConfig as JConfig  # noqa: E402
from rbslam_tpu.engines import run_rbpf as jrun_rbpf  # noqa: E402
from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf  # noqa: E402
from rbslam_tpu_torch.workloads.dense_mag import build_problem  # noqa: E402

from test_torch_rbpf import (  # noqa: E402
    N_P,
    assert_runs_match,
    build_slice_problem,
    jax_noise,
)


@pytest.fixture(scope="module")
def problem():
    return build_slice_problem()


def _cfg(cls, **kw):
    base = dict(n_particles=N_P, resampling="systematic", kf_kernel="xla")
    base.update(kw)
    return cls(**base)


def _both(problem, y=None, **kw):
    prob, jargs, T = problem
    cfg = _cfg(RBPFConfig, **kw)
    args, jargs = list(prob.rbpf_args()), list(jargs)
    if y is not None:
        args[2], jargs[2] = torch.tensor(y), y
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs, _cfg(JConfig, **kw))
    port = run_rbpf(*args, cfg, generator=None, device="cpu",
                    noise=jax_noise(T, N_P, scheme=cfg.resampling))
    return port, ref


@pytest.mark.parametrize("resampling,symmetrize", [
    ("systematic", True), ("systematic", False),
    ("multinomial", True), ("stratified", True),
])
def test_xla_path_matches_jax(problem, resampling, symmetrize):
    """The JAX package's default path; multinomial every step is the
    reference's own scheme (tools/sample.m)."""
    port, ref = _both(problem, resampling=resampling,
                      symmetrize_cov=symmetrize)
    assert port.P.shape == (N_P, 32, 32)
    assert_runs_match(port, ref)
    np.testing.assert_allclose(port.ess.numpy(), np.asarray(ref.ess),
                               rtol=1e-3)


def test_xla_ess_gated_matches_jax(problem):
    """ESS-gated resampling (threshold 0.7): the P gather runs only on
    resampling steps; the same steps skip as in the JAX package."""
    port, ref = _both(problem, ess_threshold=0.7)
    ident = np.arange(N_P)
    skipped = [bool((a == ident).all()) for a in port.ancestors.numpy()]
    assert any(skipped), "expected at least one ESS-skipped step"
    assert not all(skipped), "expected at least one resampling step"
    assert_runs_match(port, ref)


def test_xla_nan_y_matches_jax_quirk(problem):
    """On the dense xla path a NaN observation enters the update as 0 (the
    JAX package's nan_to_num; its dense update ignores the mask), while
    the kernel paths reject it."""
    prob, jargs, T = problem
    y = np.asarray(jargs[2]).copy()
    y[3, 0] = np.nan
    port, ref = _both(problem, y=y)
    assert_runs_match(port, ref)
    args = list(prob.rbpf_args())
    args[2] = torch.tensor(y)
    for kf_kernel in ("block_gather", "lowrank"):
        with pytest.raises(ValueError, match="NaN"):
            run_rbpf(*args, _cfg(RBPFConfig, kf_kernel=kf_kernel),
                     generator=None, device="cpu",
                     noise=jax_noise(T, N_P))


@pytest.mark.parametrize("kf_kernel", ["xla", "block_gather"])
def test_bf16_fence_on_per_step_paths(kf_kernel):
    """bf16 covariance at n_lin > 256 raises on the per-step paths unless
    allowed; the lowrank path is exempt."""
    prob, _ = build_problem(254, 3, seed=1, m_sim=32, device="cpu")
    cfg = dict(n_particles=2, resampling="systematic",
               cov_dtype="bfloat16", kf_kernel=kf_kernel)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="bfloat16"):
        run_rbpf(*prob.rbpf_args(), RBPFConfig(**cfg), generator=gen,
                 device="cpu")
    for ok in (RBPFConfig(**cfg, allow_bf16_large_nl=True),
               RBPFConfig(**dict(cfg, kf_kernel="lowrank"))):
        res = run_rbpf(*prob.rbpf_args(), ok, generator=gen, device="cpu")
        assert res.xl_mean.shape == (257,)


def test_noise_shape_follows_the_scheme(problem):
    """Injected uniforms are [T-1] for systematic and [T-1, N] for
    multinomial and stratified; the generator draws the same shapes."""
    prob, _, T = problem
    with pytest.raises(ValueError, match="multinomial"):
        run_rbpf(*prob.rbpf_args(), _cfg(RBPFConfig, resampling="multinomial"),
                 generator=None, device="cpu", noise=jax_noise(T, N_P))
    runs = [run_rbpf(*prob.rbpf_args(),
                     _cfg(RBPFConfig, resampling="stratified"),
                     generator=torch.Generator().manual_seed(5),
                     device="cpu") for _ in range(2)]
    assert torch.equal(runs[0].ancestors, runs[1].ancestors)
    with pytest.raises(ValueError, match="resampling scheme"):
        run_rbpf(*prob.rbpf_args(), _cfg(RBPFConfig, resampling="residual"),
                 generator=None, device="cpu", noise=jax_noise(T, N_P))
