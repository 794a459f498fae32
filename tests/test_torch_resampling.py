"""The port's resampling against the JAX package: given the same weights and
the same uniforms, the ancestors are equal.

The systematic resampler's histogram form can differ from another
summation order only at float32 knife-edge ties (n cdf_i - u0 within an
ulp of an integer, rbslam_tpu/ops/resampling.py:57-62): zero mismatches
are required at n=128, and at most 0.1% at n=16384 (the blocked-cumsum
branch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rbslam_tpu.ops import resampling as jres  # noqa: E402
from rbslam_tpu_torch.ops import resampling as tres  # noqa: E402


def _weights(rng, n, spread):
    logw = spread * rng.normal(size=n)
    w = np.exp(logw - logw.max())
    return (w / w.sum()).astype(np.float32)


def test_systematic_fuzz_n128_exact():
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(0), 100)
    mismatches = 0
    for i in range(100):
        w = _weights(rng, 128, spread=[0.5, 2.0, 5.0][i % 3])
        u0 = np.asarray(jax.random.uniform(keys[i], ()))
        ref = np.asarray(jres.systematic_resample(keys[i], jnp.asarray(w),
                                                  128))
        port = tres.systematic_resample(torch.tensor(u0), torch.tensor(w),
                                        128).numpy()
        mismatches += int(np.sum(ref != port))
    assert mismatches == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_blocked_cumsum_n16384(seed):
    n = 16384
    rng = np.random.default_rng(100 + seed)
    w = _weights(rng, n, spread=2.0)
    key = jax.random.PRNGKey(seed)
    u0 = np.asarray(jax.random.uniform(key, ()))
    ref = np.asarray(jres.systematic_resample(key, jnp.asarray(w), n))
    port = tres.systematic_resample(torch.tensor(u0), torch.tensor(w),
                                    n).numpy()
    assert port.dtype == np.int64 and port.shape == (n,)
    assert np.sum(ref != port) <= n // 1000
    # a valid comb: nondecreasing and in range
    assert np.all(np.diff(port) >= 0) and port.min() >= 0 and port.max() < n


def test_blocked_cumsum_matches_plain_cumsum():
    x = np.random.default_rng(3).random(8192).astype(np.float32)
    port = tres._cumsum_1d(torch.tensor(x)).numpy()
    np.testing.assert_allclose(port, np.cumsum(x.astype(np.float64)),
                               rtol=1e-5)
    ints = torch.arange(8192)
    np.testing.assert_array_equal(tres._cumsum_1d(ints).numpy(),
                                  np.cumsum(np.arange(8192)))


@pytest.mark.parametrize("scheme", ["multinomial", "stratified"])
def test_iid_schemes_given_uniforms(scheme):
    n = 512
    rng = np.random.default_rng(7)
    w = _weights(rng, n, spread=1.5)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (n,)))
    ref = np.asarray(jres.resample_indices(key, jnp.asarray(w), n, scheme))
    port = tres.resample_indices(torch.tensor(u), torch.tensor(w), n,
                                 scheme).numpy()
    assert np.sum(ref != port) <= 1


def test_unknown_scheme_rejected():
    w = torch.full((8,), 1.0 / 8)
    with pytest.raises(ValueError, match="scheme"):
        tres.resample_indices(torch.tensor(0.5), w, 8, "residual")


@pytest.mark.parametrize("n,at", [(128, 0), (128, 77), (128, 127),
                                  (1000, 500), (4200, 4199)])
def test_systematic_degenerate_weights_match_jax(n, at):
    """All the mass on one particle: the particles after it fall in
    bucket n, which the scatter-add histogram drops as JAX's does, and
    every ancestor is that particle. n = 1000 and 4200 are not multiples
    of 128 (the plain cumsum branch)."""
    w = np.zeros(n, np.float32)
    w[at] = 1.0
    key = jax.random.PRNGKey(n + at)
    u0 = np.asarray(jax.random.uniform(key, ()))
    ref = np.asarray(jres.systematic_resample(key, jnp.asarray(w), n))
    port = tres.systematic_resample(torch.tensor(u0), torch.tensor(w),
                                    n).numpy()
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, np.full(n, at))


@pytest.mark.parametrize("n", [100, 1000, 4200])
def test_systematic_n_not_multiple_of_128_matches_jax(n):
    """The scatter-add histogram at ensemble sizes that are not multiples
    of 128, on ten weight draws each: equal to JAX's at n < 4096; at 4200
    the two packages' 1-D cumsums sum in different orders, so, as at
    n=16384 above, at most 0.1% of the ancestors may differ at f32
    knife-edge ties, and the comb stays valid."""
    rng = np.random.default_rng(n)
    keys = jax.random.split(jax.random.PRNGKey(n), 10)
    for i, key in enumerate(keys):
        w = _weights(rng, n, spread=[0.5, 2.0, 5.0][i % 3])
        u0 = np.asarray(jax.random.uniform(key, ()))
        ref = np.asarray(jres.systematic_resample(key, jnp.asarray(w), n))
        port = tres.systematic_resample(torch.tensor(u0), torch.tensor(w),
                                        n).numpy()
        if n < 4096:
            np.testing.assert_array_equal(port, ref)
        else:
            assert np.sum(ref != port) <= n // 1000
        assert np.all(np.diff(port) >= 0) and 0 <= port.min() \
            and port.max() < n


@pytest.mark.parametrize("n", [4096, 1 << 16, (1 << 19) + 100])
def test_cdf_helper_matches_torch_cumsum(n):
    """The CDF helper every resampler sums with (``_cumsum_1d``): blocked
    from 4096 entries, zero-padded to whole rows of 128 and its row
    offsets blocked again above 2^19, it equals ``torch.cumsum`` on
    normalized weights to one unit in the last place at 1 (2^-23), and
    the float64 CDF to 1.5 units (one more rounding of the offsets)."""
    rng = np.random.default_rng(n)
    w = torch.tensor(_weights(rng, n, spread=2.0))
    cdf = tres._cumsum_1d(w)
    assert cdf.shape == (n,) and cdf.dtype == torch.float32
    np.testing.assert_allclose(cdf.numpy(), torch.cumsum(w, 0).numpy(),
                               rtol=0, atol=2.0**-23)
    np.testing.assert_allclose(cdf.double().numpy(),
                               torch.cumsum(w.double(), 0).numpy(), rtol=0,
                               atol=1.5 * 2.0**-23)
