"""Kernel K5 (the gathered dense KF update) and the ``block_gather`` filter
path of the port, against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode (as
tests/test_fused_kf.py does); the port's wrapper runs its plain PyTorch
version on CPU tensors. Inputs and draws are made from a seed.

Tolerances: the closed-form inverse and log-det 1e-3 of the output's
scale (the later pivots are differences of terms up to cond(S) = 1e4
larger, so float32 rounding in another operation order, or a fused
multiply-add, moves them by up to ~1e4 ulp), with equal repair flags;
the update at JAX's own kernel tolerances (float32 P 1e-5, xl and logw
1e-4; bfloat16 5e-2); whole filter runs at the slice tolerances of
tests/test_torch_rbpf.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rbslam_tpu.engines import RBPFConfig as JConfig  # noqa: E402
from rbslam_tpu.engines import run_rbpf as jrun_rbpf  # noqa: E402
from rbslam_tpu.kernels.kf_update import _spd_inv_logdet  # noqa: E402
from rbslam_tpu.kernels.kf_update import (  # noqa: E402
    kf_update_block_gather as jblock_gather,
)
from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf  # noqa: E402
from rbslam_tpu_torch.kernels import (  # noqa: E402
    block_gather_plain,
    kf_update_block_gather,
    launch_counts,
    reset_launch_counts,
    spd_inv_logdet_plain,
)

from test_torch_rbpf import (  # noqa: E402
    N_P,
    assert_runs_match,
    build_slice_problem,
    jax_noise,
)


def _S(kind, ny, rng):
    if kind == "pd":
        # conditioning from 1 to 1e4
        Qm, _ = np.linalg.qr(rng.normal(size=(64, ny, ny)))
        d = np.geomspace(1.0, 1e4, ny)[None, :] * np.ones((64, 1))
        return np.einsum("bij,bj,bkj->bik", Qm, d, Qm).astype(np.float32)
    if kind == "indefinite":
        A = rng.normal(size=(32, ny, ny)).astype(np.float32)
        return A @ A.transpose(0, 2, 1) - 5.0 * np.eye(ny, dtype=np.float32)
    return np.zeros((8, ny, ny), np.float32)


@pytest.mark.parametrize("kind", ["pd", "indefinite", "zero"])
@pytest.mark.parametrize("ny", [1, 2, 3])
def test_spd_inv_logdet_matches_jax(ny, kind):
    """Same inverse, log-det, whitener and repair flags as the JAX
    kernel's closed form; always finite, repaired where S is not PD."""
    S = _S(kind, ny, np.random.default_rng(ny))
    Sinv, logdet, bad, Linv = spd_inv_logdet_plain(torch.tensor(S), 1e-3)
    rSinv, rlogdet, rbad, rLinv = map(
        np.asarray, _spd_inv_logdet(jnp.asarray(S), ny, 1e-3))
    for port, ref in ((Sinv, rSinv), (logdet, rlogdet), (Linv, rLinv)):
        port = port.numpy()
        assert np.isfinite(port).all()
        ref = ref.reshape(port.shape)
        np.testing.assert_allclose(port, ref, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(ref).max(), 1.0))
    np.testing.assert_array_equal(bad.numpy(), rbad.reshape(-1))
    assert bad.any() == (kind != "pd")


def _update_inputs(ny, seed=0, N=16, nl=128):
    rng = np.random.default_rng(seed)
    A = (0.2 * rng.normal(size=(N, nl, nl))).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + np.eye(nl, dtype=np.float32)
    xl = rng.normal(size=(N, nl)).astype(np.float32)
    C = (0.5 * rng.normal(size=(N, ny, nl))).astype(np.float32)
    y = rng.normal(size=(ny,)).astype(np.float32)
    R = (0.5 * np.eye(ny)).astype(np.float32)
    ai = rng.integers(0, N, size=N).astype(np.int32)
    return ai, C, xl[ai], P, y, R


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ny", [1, 2, 3])
def test_block_gather_matches_jax(ny, dtype):
    """The wrapper's CPU route and block_gather_plain itself against the
    JAX kernel (interpret mode) on the same storage-dtype covariances."""
    ai, C, xlg, P, y, R = _update_inputs(ny)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    Ps = np.asarray(jnp.asarray(P).astype(jdt).astype(jnp.float32))
    ref = jblock_gather(jnp.asarray(ai), jnp.asarray(C), jnp.asarray(xlg),
                        jnp.asarray(Ps).astype(jdt), jnp.asarray(y),
                        jnp.asarray(R))
    ref = [np.asarray(jnp.asarray(r).astype(jnp.float32)) for r in ref[:3]] \
        + [np.asarray(ref[3])]
    Pt = torch.tensor(Ps).to(tdt)
    out = kf_update_block_gather(torch.tensor(ai), torch.tensor(C),
                                 torch.tensor(xlg), Pt, torch.tensor(y),
                                 torch.tensor(R))
    e = torch.tensor(y)[None] - torch.einsum("pij,pj->pi", torch.tensor(C),
                                             torch.tensor(xlg))
    plain = block_gather_plain(torch.tensor(ai), torch.tensor(C), e,
                               torch.tensor(xlg), Pt, torch.tensor(R), 1e-3)
    tol = {"float32": (1e-4, 1e-5, 1e-4), "bfloat16": (5e-2,) * 3}[dtype]
    for res in (out, plain):
        assert res[1].dtype == tdt and res[1].shape == (16, 128, 128)
        for got, want, atol in zip(res[:3], ref[:3], tol):
            np.testing.assert_allclose(got.float().numpy(), want, atol=atol)
        np.testing.assert_array_equal(res[3].numpy(), ref[3])


def test_block_gather_repair_matches_jax():
    """S = 0 (P = 0, R = 0): every particle takes the Gershgorin repair,
    with finite weights and the same flags as the JAX kernel."""
    N, ny, nl = 8, 3, 128
    C = (0.3 * np.random.default_rng(0).normal(size=(N, ny, nl))
         ).astype(np.float32)
    args = (np.arange(N, dtype=np.int32), C, np.zeros((N, nl), np.float32),
            np.zeros((N, nl, nl), np.float32), np.ones(ny, np.float32),
            np.zeros((ny, ny), np.float32))
    out = kf_update_block_gather(*map(torch.tensor, args))
    ref = jblock_gather(*map(jnp.asarray, args))
    assert bool(out[3].all())
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert np.isfinite(out[2].numpy()).all()
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-5)


def test_block_gather_rejects_bad_inputs_and_counts_nothing_on_cpu():
    ai, C, xlg, P, y, R = map(torch.tensor, _update_inputs(3, N=4))
    with pytest.raises(TypeError, match="int32"):
        kf_update_block_gather(ai.long(), C, xlg, P, y, R)
    with pytest.raises(ValueError, match="multiple of 128"):
        kf_update_block_gather(ai, C[:, :, :64], xlg[:, :64],
                               P[:, :64, :64].contiguous(), y, R)
    with pytest.raises(TypeError, match="P_all"):
        kf_update_block_gather(ai, C, xlg, P.double(), y, R)
    with pytest.raises(ValueError, match="ny"):
        kf_update_block_gather(ai, torch.cat([C, C], 1), xlg, P,
                               torch.cat([y, y]), torch.eye(6))
    reset_launch_counts()
    kf_update_block_gather(ai, C, xlg, P, y, R)
    assert launch_counts()["block_gather"] == 0


@pytest.fixture(scope="module")
def problem():
    return build_slice_problem()


def _cfg(cls, **kw):
    base = dict(n_particles=N_P, resampling="systematic",
                symmetrize_cov=False, kf_kernel="block_gather")
    base.update(kw)
    return cls(**base)


def _both(problem, **kw):
    prob, jargs, T = problem
    cfg = _cfg(RBPFConfig, **kw)
    ref = jrun_rbpf(jax.random.PRNGKey(0), *jargs, _cfg(JConfig, **kw))
    port = run_rbpf(*prob.rbpf_args(), cfg, generator=None, device="cpu",
                    noise=jax_noise(T, N_P, scheme=cfg.resampling))
    return port, ref


def test_filter_block_gather_systematic_matches_jax(problem):
    """The block_gather path (n_lin 32 padded to 128) with systematic
    resampling every step, on JAX's draws."""
    port, ref = _both(problem)
    assert port.xl_mean.shape == (32,) and port.P.shape == (N_P, 32, 32)
    assert_runs_match(port, ref)


def _assert_gated(port):
    ident = np.arange(N_P)
    skipped = [bool((a == ident).all()) for a in port.ancestors.numpy()]
    assert any(skipped), "expected at least one ESS-skipped step"
    assert not all(skipped), "expected at least one resampling step"


@pytest.mark.parametrize("kf_kernel", ["block_gather", "lowrank"])
def test_filter_ess_gated_matches_jax(problem, kf_kernel):
    """ESS-gated resampling (threshold 0.7) on the kernel paths: the same
    steps skip resampling as in the JAX package, and the runs agree."""
    port, ref = _both(problem, kf_kernel=kf_kernel, ess_threshold=0.7)
    _assert_gated(port)
    assert_runs_match(port, ref)
