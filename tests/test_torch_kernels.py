"""Kernels K1-K5 of the port (K6, K7 and K4 at d < 3 against the JAX
package: tests/test_torch_radio.py; all seven on the card: here).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas entry points (interpret mode on the CPU)
on the same numpy inputs, mirroring tests/test_kernels.py and
tests/test_fused_kf.py. ``TestOnCard`` (marker ``gpu``) compares each
CUDA kernel with its plain version and skips without a card; it needs no
JAX.

Tolerances: float32 Jacobians atol 1e-5 (plus rtol 1e-5 of the value);
the factored update 1e-4 relative to the outputs' scale, tighter than
the 5e-2 of the JAX package's own kernel-vs-XLA test; bf16 outputs one
bf16 rounding (8e-3) of the output's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu_torch.basis import hypercube_basis  # noqa: E402
from rbslam_tpu_torch.kernels import (  # noqa: E402
    block_gather_plain,
    gather_cp,
    gather_cp_plain,
    grad_basis,
    grad_basis_plain,
    kf_rebase,
    kf_update_block_gather,
    kf_update_lowrank,
    launch_counts,
    mag3d_jacobian,
    mag3d_jacobian_plain,
    mag3d_jacobian_rows,
    mag3d_jacobian_rows_plain,
    pack_basis_constants,
    phi_basis,
    phi_basis_plain,
    rebase_plain,
    reset_launch_counts,
)

LL = np.array([2.0, 2.0, 1.0])


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel entry points (imported only where needed,
    so the on-card tests run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rbslam_tpu.basis import hypercube_basis as jhb
    from rbslam_tpu.kernels import grad_basis_pallas
    from rbslam_tpu.kernels.basis_eval import mag3d_jacobian_rows_pallas
    from rbslam_tpu.kernels.kf_update import kf_rebase as jrebase
    from rbslam_tpu.kernels.kf_update import kf_update_lowrank as jlowrank

    return {
        "jnp": jnp, "hypercube_basis": jhb, "grad": grad_basis_pallas,
        "rows": mag3d_jacobian_rows_pallas, "rebase": jrebase,
        "lowrank": jlowrank,
    }


def t(a):
    return torch.tensor(np.asarray(a))


def _points(n=37, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return pos, q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobian_rows_matches_jax(jx, dtype):
    jnp = jx["jnp"]
    pos, q = _points()
    consts = pack_basis_constants(hypercube_basis(61, LL), "cpu")
    tdt = getattr(torch, dtype)
    port = mag3d_jacobian_rows(consts, t(pos), t(q), 128, tdt)
    ref = np.asarray(jx["rows"](jx["hypercube_basis"](61, LL),
                                jnp.asarray(pos), jnp.asarray(q), 128,
                                jnp.dtype(dtype)).astype(jnp.float32))
    assert port.shape == (37, 3, 128) and port.dtype == tdt
    np.testing.assert_array_equal(port[:, :, 3 + 61:].float().numpy(), 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(port.float().numpy(), ref, rtol=8e-3,
                                   atol=8e-3 * float(np.abs(ref).max()))


def test_grad_basis_matches_jax(jx):
    jnp = jx["jnp"]
    pos, _ = _points(53, seed=3)
    consts = pack_basis_constants(hypercube_basis(61, LL), "cpu")
    port = grad_basis(consts, t(pos))
    ref = np.asarray(jx["grad"](jx["hypercube_basis"](61, LL),
                                jnp.asarray(pos)))
    assert port.shape == (53, 3, 61)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_grad_basis_matches_basis_gradient():
    """K4's plain version equals LaplaceBasis.grad_phi (the jnp-style path)."""
    basis = hypercube_basis(40, LL)
    pos, _ = _points(20, seed=5)
    consts = pack_basis_constants(basis, "cpu")
    np.testing.assert_allclose(grad_basis(consts, t(pos)).numpy(),
                               basis.grad_phi(t(pos)).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---- the table form of K1, K4 and K7 (its host side and arithmetic) ----
BOUNDS3 = [[-20.0, -20.0, -2.4], [20.0, 20.0, 2.4]]
HALF = [9.0, 6.0, 2.4]


def _basis(m, d):
    return hypercube_basis(m, BOUNDS3 if d == 3 else HALF[:d])


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("m", [125, 509, 512, 128, 2000])
def test_packed_table_matches_packed_rows(d, m):
    """Each column's (freq, phase, fac) triplet equals exactly one of its
    dimension's distinct triplets in the table, bit for bit, and every
    table entry serves some column; the column codes hold the table
    offsets (the counts of the dimensions before plus that entry's index)
    a byte a dimension where the counts fit them."""
    consts = pack_basis_constants(_basis(m, d), "cpu")
    assert consts.table.shape == (3 * d, max(consts.counts))
    offset = 0
    for j, u in enumerate(consts.counts):
        bits = consts.table[j::d, :u].T.contiguous().view(torch.int32)
        cols = consts.packed[j::d].T.contiguous().view(torch.int32)
        match = (cols[:, None, :] == bits[None, :, :]).all(-1)   # [m, u]
        assert torch.equal(match.sum(1), torch.ones(m, dtype=torch.long))
        index = match.int().argmax(1)
        assert torch.equal(torch.unique(index), torch.arange(u))
        if sum(consts.counts) <= 256:
            field = (consts.col_codes[3:3 + m] >> (8 * j)) & 255
            assert torch.equal(field, index + offset)
        offset += u


@pytest.mark.parametrize("d,m", [(1, 17), (2, 128), (3, 125), (3, 509),
                                 (3, 512)])
def test_table_evaluation_equals_plain_bitwise(d, m):
    """The plain mirror of the table form (sin and fac * cos of the
    distinct phases, read through the kernels' position and column codes)
    equals the plain versions of K4 and, at d = 3, of K1 in both dtypes:
    torch.equal."""
    from rbslam_tpu_torch.kernels.basis_eval import (
        _table_grad_plain,
        _table_rows_plain,
    )

    consts = pack_basis_constants(_basis(m, d), "cpu")
    rng = np.random.default_rng(m + d)
    half = np.array([20.0, 20.0, 2.4] if d == 3 else HALF[:d], np.float32)
    x = t((rng.uniform(-0.9, 0.9, size=(67, d)) * half).astype(np.float32))
    assert torch.equal(_table_grad_plain(consts, x),
                       grad_basis_plain(consts, x))
    if d == 3:
        _, q = _points(67, seed=m)
        nl_pad = -(-(3 + m) // 128) * 128
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(
                _table_rows_plain(consts, x, t(q), nl_pad, dtype),
                mag3d_jacobian_rows_plain(consts, x, t(q), nl_pad, dtype))


@pytest.mark.parametrize("jac,n,d,m,nl_pad,itemsize,counts,plan", [
    # K1 bf16 headline: 16 stores of 16 bytes a row, 32 particles a block
    (True, 16384, 3, 125, 128, 2, (13, 13, 1), (1, 32)),
    # K1 f32 reference shape: 128 stores a row, 4 particles a block
    (True, 4096, 3, 509, 512, 4, (21, 21, 2), (1, 4)),
    # fewer particles a block, so that 1001 particles make 264 blocks
    (True, 1001, 3, 125, 128, 4, (13, 13, 1), (1, 3)),
    # K4: a block's flat range starts 16-byte aligned (d m = 375 is odd:
    # a multiple of four particles a block; 150: of two), and 4096 floats
    # a block at most
    (False, 16384, 3, 125, 0, 4, (13, 13, 1), (1, 8)),
    (False, 16384, 2, 128, 0, 4, (16, 11), (1, 16)),
    (False, 1103, 2, 75, 0, 4, (9, 8), (1, 4)),
    # too few particles to fill the card (the smoothers' 100, K7 at the
    # smoothed trajectory's 192): the direct form
    (False, 100, 3, 512, 0, 4, (21, 21, 2), (0, 0)),
    (True, 192, 3, 512, 640, 4, (21, 21, 2), (0, 0)),
    # 256 distinct values in all dimensions: the table form still
    (False, 16384, 1, 256, 0, 4, (256,), (1, 16)),
    # over 256 (a table offset is a byte): the direct form
    (False, 16384, 1, 257, 0, 4, (257,), (0, 0)),
    (False, 100, 1, 2000, 0, 4, (2000,), (0, 0)),
    (True, 100, 3, 1100, 1152, 4, (1100, 1, 1), (0, 0)),
])
def test_basis_planner_choices(jac, n, d, m, nl_pad, itemsize, counts, plan):
    """The Python mirror of basis_plan (csrc/basis_eval.cu), whose choice
    the C entries check before they launch."""
    from rbslam_tpu_torch.kernels.basis_eval import _basis_plan, _basis_smem

    got = _basis_plan(jac, n, d, m, nl_pad, itemsize, counts)
    assert got == plan
    if got[0] == 1:
        assert _basis_smem(jac, sum(counts), got[1]) <= 48 * 1024
        if not jac:
            assert got[1] * d * m % 4 == 0


def _factored(ny, seed=3, N=32, nl=128, rw=None):
    rng = np.random.default_rng(seed)
    rw = 8 * ny if rw is None else rw
    A = (0.2 * rng.normal(size=(N, nl, nl))).astype(np.float32)
    P_base = A @ A.transpose(0, 2, 1) + 2.0 * np.eye(nl, dtype=np.float32)
    Wt = np.zeros((N, rw, nl), np.float32)
    Wt[:, :2 * ny] = 0.1 * rng.normal(size=(N, 2 * ny, nl))
    C = (0.3 * rng.normal(size=(N, ny, nl))).astype(np.float32)
    xl = rng.normal(size=(N, nl)).astype(np.float32)
    y = rng.normal(size=(ny,)).astype(np.float32)
    R = (0.5 * np.eye(ny)).astype(np.float32)
    bidx = rng.integers(0, N, size=N).astype(np.int32)
    return bidx, C, xl, Wt, P_base, y, R


def _scaled_close(port, ref, rel):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=rel,
                               atol=rel * max(float(np.abs(ref).max()), 1.0))


@pytest.mark.parametrize("ny", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowrank_update_and_rebase_match_jax(jx, ny, dtype):
    jnp = jx["jnp"]
    bidx, C, xl, Wt, P_base, y, R = _factored(ny)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    # the storage-dtype inputs both packages see
    Cs, Wts, Ps = (np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))
                   for a in (C, Wt, P_base))
    port = kf_update_lowrank(t(bidx), t(Cs).to(tdt), t(xl), t(Wts).to(tdt),
                             t(Ps).to(tdt), t(y), t(R))
    ref = jx["lowrank"](jnp.asarray(bidx), jnp.asarray(Cs).astype(jdt),
                        jnp.asarray(xl), jnp.asarray(Wts).astype(jdt),
                        jnp.asarray(Ps).astype(jdt), jnp.asarray(y),
                        jnp.asarray(R))
    rel = 1e-4 if dtype == "float32" else 8e-3
    assert port[1].dtype == tdt
    _scaled_close(port[0].numpy(), ref[0], rel)
    _scaled_close(port[1].float().numpy(),
                  np.asarray(ref[1].astype(jnp.float32)), rel)
    _scaled_close(port[2].numpy(), ref[2], rel)
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))

    P_new = kf_rebase(t(bidx), t(Wts).to(tdt), t(Ps).to(tdt))
    P_ref = jx["rebase"](jnp.asarray(bidx), jnp.asarray(Wts).astype(jdt),
                         jnp.asarray(Ps).astype(jdt))
    assert P_new.dtype == tdt
    _scaled_close(P_new.float().numpy(),
                  np.asarray(P_ref.astype(jnp.float32)), rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ny,k", [(1, 0), (1, 5), (2, 24), (3, 6), (3, 17)])
def test_gather_cp_live_rows_equal_all_rows(dtype, ny, k):
    """K2's plain version with ``rows=k`` on a Wt [N, 24, nl] whose rows
    from k on are zero gives the bits of all rows, and of Wt[:, :k]: the
    correction is summed one factor row at a time, so zero rows add
    exact zeros."""
    rng = np.random.default_rng(10 * ny + k)
    N, nl, rw = 40, 136, 24
    tdt = getattr(torch, dtype)
    P = t(rng.normal(size=(N, nl, nl)).astype(np.float32)).to(tdt)
    C = t((0.3 * rng.normal(size=(N, ny, nl))).astype(np.float32)).to(tdt)
    Wt = np.zeros((N, rw, nl), np.float32)
    Wt[:, :k] = 0.1 * rng.normal(size=(N, k, nl))
    Wt = t(Wt).to(tdt)
    bidx = t(rng.integers(0, N, size=N).astype(np.int32))
    live = gather_cp(bidx, C, Wt, P, rows=k)
    assert torch.equal(live, gather_cp(bidx, C, Wt, P))
    assert torch.equal(live, gather_cp_plain(bidx, C,
                                             Wt[:, :k].contiguous(), P))
    with pytest.raises(ValueError, match="rows"):
        gather_cp(bidx, C, Wt, P, rows=rw + 1)


@pytest.mark.parametrize("ny", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowrank_live_rows_match_jax(jx, ny, dtype):
    """``kf_update_lowrank(..., live_rows=2 ny)`` (the factor rows of two
    steps; _factored leaves the rest zero) against the JAX package's
    kf_update_lowrank, which reads every row, at the tolerances of
    test_lowrank_update_and_rebase_match_jax; and bit-equal to the port's
    all-rows update."""
    jnp = jx["jnp"]
    bidx, C, xl, Wt, P_base, y, R = _factored(ny)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    Cs, Wts, Ps = (np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))
                   for a in (C, Wt, P_base))
    args = (t(bidx), t(Cs).to(tdt), t(xl), t(Wts).to(tdt), t(Ps).to(tdt),
            t(y), t(R))
    port = kf_update_lowrank(*args, live_rows=2 * ny)
    ref = jx["lowrank"](jnp.asarray(bidx), jnp.asarray(Cs).astype(jdt),
                        jnp.asarray(xl), jnp.asarray(Wts).astype(jdt),
                        jnp.asarray(Ps).astype(jdt), jnp.asarray(y),
                        jnp.asarray(R))
    rel = 1e-4 if dtype == "float32" else 8e-3
    _scaled_close(port[0].numpy(), ref[0], rel)
    _scaled_close(port[1].float().numpy(),
                  np.asarray(ref[1].astype(jnp.float32)), rel)
    _scaled_close(port[2].numpy(), ref[2], rel)
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    for a, b in zip(port, kf_update_lowrank(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rw", [8, 24, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rebase_matches_jax_at_any_factor_width(jx, rw, dtype):
    """K3's plain version against the JAX package's kf_rebase (interpret
    mode) with every factor row filled, at widths that are and are not
    multiples of 16. float32 1e-4 of the scale (order of the f32 sum);
    bf16 one bf16 rounding (8e-3) of the scale."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(rw)
    bidx, _, _, _, P_base, _, _ = _factored(3, seed=rw, N=16, rw=rw)
    Wt = (0.1 * rng.normal(size=(16, rw, 128))).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    Wts, Ps = (np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))
               for a in (Wt, P_base))
    P_new = kf_rebase(t(bidx), t(Wts).to(tdt), t(Ps).to(tdt))
    P_ref = jx["rebase"](jnp.asarray(bidx), jnp.asarray(Wts).astype(jdt),
                         jnp.asarray(Ps).astype(jdt))
    assert P_new.dtype == tdt and P_new.shape == (16, 128, 128)
    _scaled_close(P_new.float().numpy(),
                  np.asarray(P_ref.astype(jnp.float32)),
                  1e-4 if dtype == "float32" else 8e-3)
    assert torch.equal(P_new, rebase_plain(t(bidx), t(Wts).to(tdt),
                                           t(Ps).to(tdt)))


def test_lowrank_jitter_retry_matches_jax(jx):
    """S = 0 (P_base = 0, R = 0): every particle takes the scale-aware
    jitter retry, with finite weights, as in the JAX package."""
    jnp = jx["jnp"]
    N, ny, nl, rw = 8, 3, 128, 24
    C = (0.3 * np.random.default_rng(0).normal(size=(N, ny, nl))
         ).astype(np.float32)
    args = (np.arange(N, dtype=np.int32), C, np.zeros((N, nl), np.float32),
            np.zeros((N, rw, nl), np.float32),
            np.zeros((N, nl, nl), np.float32), np.ones(ny, np.float32),
            np.zeros((ny, ny), np.float32))
    port = kf_update_lowrank(*map(t, args))
    ref = jx["lowrank"](*map(jnp.asarray, args))
    assert bool(port[3].all())
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    assert np.isfinite(port[2].numpy()).all()
    _scaled_close(port[2].numpy(), ref[2], 1e-4)


def test_lowrank_update_equals_dense_update():
    """The factored update equals the dense small-ny update on the
    materialized covariance P_base[bidx] - Wt^T Wt (port only)."""
    from rbslam_tpu_torch.ops.kalman import kalman_update_dense_batched

    bidx, C, xl, Wt, P_base, y, R = map(t, _factored(3, seed=9))
    P_eff = P_base[bidx.long()] - torch.einsum("pri,prj->pij", Wt, Wt)
    ref = kalman_update_dense_batched(C, P_eff, xl, y, R, 1e-3,
                                      symmetrize_out=False)
    xl_new, wnew, logw, bad = kf_update_lowrank(bidx, C, xl, Wt, P_base, y, R)
    _scaled_close(xl_new.numpy(), ref[0].numpy(), 1e-4)
    _scaled_close(logw.numpy(), ref[2].numpy(), 1e-4)
    Wt2 = Wt.clone()
    Wt2[:, 6:9] = wnew
    _scaled_close(kf_rebase(bidx, Wt2, P_base).numpy(), ref[1].numpy(), 1e-4)


def test_wrappers_reject_bad_inputs():
    consts = pack_basis_constants(hypercube_basis(20, LL), "cpu")
    pos, q = map(t, _points(4))
    with pytest.raises(TypeError):
        grad_basis(consts, pos.double())
    with pytest.raises(ValueError, match="contiguous"):
        mag3d_jacobian_rows(consts, t(np.zeros((3, 4), np.float32)).T, q[:4],
                            128)
    with pytest.raises(ValueError, match="nl_pad"):
        mag3d_jacobian_rows(consts, pos, q, 16)
    bidx, C, xl, Wt, P_base, y, R = map(t, _factored(1, N=4))
    with pytest.raises(TypeError, match="int32"):
        gather_cp(bidx.long(), C, Wt, P_base)
    with pytest.raises(TypeError):
        kf_rebase(bidx, Wt.to(torch.bfloat16), P_base)
    with pytest.raises(ValueError, match="contiguous"):
        kf_rebase(bidx, Wt, P_base.transpose(1, 2))
    with pytest.raises(ValueError):
        gather_cp(bidx, C[:, :, :64].contiguous(), Wt, P_base)


def test_cpu_tensors_take_plain_version_and_count_nothing():
    reset_launch_counts()
    consts = pack_basis_constants(hypercube_basis(20, LL), "cpu")
    pos, q = map(t, _points(6))
    grad_basis(consts, pos)
    mag3d_jacobian_rows(consts, pos, q, 128)
    bidx, C, xl, Wt, P_base, y, R = map(t, _factored(3, N=4))
    kf_update_lowrank(bidx, C, xl, Wt, P_base, y, R)
    kf_rebase(bidx, Wt, P_base)
    kf_update_block_gather(bidx, C, xl, P_base, y, R)
    phi_basis(consts, pos)
    mag3d_jacobian(consts, pos, q, 128)
    counts = launch_counts()
    assert {"grad_basis", "jac3d_rows", "gather_cp", "rebase",
            "block_gather", "phi_basis", "jac3d"} <= set(counts)
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("dtype,nl,direct,counts", [
    (torch.float32, 640, False, True), (torch.float32, 512, False, True),
    (torch.float32, 640, True, False), (torch.bfloat16, 128, False, False)])
def test_gather_cp_passes_a_counter_only_while_recording(monkeypatch, dtype,
                                                         nl, direct, counts):
    """K2's float32 form gets a device counter (the ``reads`` argument of
    ``rbs_gather_cp``) inside a recorded span and a null pointer with
    recording off; the direct and bf16 forms count nothing. The CPU has no
    kernel: the launch is faked."""
    from types import SimpleNamespace

    from rbslam_tpu_torch.kernels import _lib, kf_update
    from rbslam_tpu_torch.utils import phase_annotation, recording

    passed = []
    fake = SimpleNamespace(rbs_gather_cp=lambda *a: passed.append(a[-2]) or 0)
    monkeypatch.setattr(kf_update, "_on_cpu", lambda _: False)
    monkeypatch.setattr(_lib, "lib", lambda: fake)
    monkeypatch.setattr(_lib, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_lib, "_launches",
                        dict.fromkeys(_lib.KERNEL_NAMES, 0))
    n, rw = 6, 24
    args = (torch.zeros(n, dtype=torch.int32),
            torch.zeros((n, 3, nl), dtype=dtype),
            torch.zeros((n, rw, nl), dtype=dtype),
            torch.zeros((2, nl, nl), dtype=dtype))
    kf_update._gather_cp(*args, None, direct)
    with recording() as rec:
        with phase_annotation("update"):
            kf_update._gather_cp(*args, None, direct)
    assert passed[0] == 0 and bool(passed[1]) == counts
    # nothing was added: the faked kernel counts nothing
    assert rec.spans[0].k2_p_reads == (0 if counts else None)
    assert _lib.launch_counts()["gather_cp"] == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a): the CUDA kernels have "
                    "no CPU mode; their plain versions are tested above")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
class TestOnCard:
    """Each CUDA kernel against its plain version on the card, at small
    and at the main path's widths. f32: 1e-4 of the output's max
    magnitude, and elementwise rtol 1e-4 with an absolute floor of 1e-6
    of that magnitude; bf16: 2e-2 of the max magnitude."""

    @staticmethod
    def _check(kernel_out, plain_out, dtype):
        assert kernel_out.shape == plain_out.shape
        assert kernel_out.dtype == plain_out.dtype
        a, b = kernel_out.float(), plain_out.float()
        assert bool(torch.isfinite(a).all())
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale
        if dtype == torch.float32:
            assert torch.allclose(a, b, rtol=tol, atol=1e-6 * scale)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n,m", [(37, 61), (4096, 125)])
    def test_basis_kernels(self, card, dtype, n, m):
        g = torch.Generator(device=card).manual_seed(n)
        consts = pack_basis_constants(hypercube_basis(m, [[-20, -20, -2.4],
                                                          [20, 20, 2.4]]),
                                      card)
        pos = 30 * (torch.rand((n, 3), generator=g, device=card) - 0.5)
        q = torch.randn((n, 4), generator=g, device=card)
        q = q / q.norm(dim=-1, keepdim=True)
        before = launch_counts()
        self._check(mag3d_jacobian_rows(consts, pos, q, 128 * (1 + m // 128),
                                        dtype),
                    mag3d_jacobian_rows_plain(consts, pos, q,
                                              128 * (1 + m // 128), dtype),
                    dtype)
        self._check(grad_basis(consts, pos), grad_basis_plain(consts, pos),
                    torch.float32)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["jac3d_rows"] == before["jac3d_rows"] + 1
        assert after["grad_basis"] == before["grad_basis"] + 1

    @pytest.mark.parametrize("d,m,n", [(1, 17, 9), (2, 128, 100),
                                       (2, 128, 16384), (3, 509, 4096)])
    def test_phi_and_grad_kernels_any_dim(self, card, d, m, n):
        """K6 and K4 at d in {1, 2, 3}, at the radio path's shapes among
        others."""
        g = torch.Generator(device=card).manual_seed(n + d)
        half = torch.tensor([9.0, 6.0, 2.4][:d], device=card)
        consts = pack_basis_constants(
            hypercube_basis(m, half.cpu().numpy()), card)
        x = (2 * torch.rand((n, d), generator=g, device=card) - 1) * half
        before = launch_counts()
        self._check(phi_basis(consts, x), phi_basis_plain(consts, x),
                    torch.float32)
        self._check(grad_basis(consts, x), grad_basis_plain(consts, x),
                    torch.float32)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["phi_basis"] == before["phi_basis"] + 1
        assert after["grad_basis"] == before["grad_basis"] + 1

    @pytest.mark.parametrize("n,m,nl_pad", [(37, 61, 64), (16384, 125, 128),
                                            (4096, 509, 512)])
    def test_jac3d_kernel(self, card, n, m, nl_pad):
        """K7 against its plain version, and bit-equal to K1's float32
        output transposed."""
        g = torch.Generator(device=card).manual_seed(n)
        consts = pack_basis_constants(hypercube_basis(m, [[-20, -20, -2.4],
                                                          [20, 20, 2.4]]),
                                      card)
        pos = 30 * (torch.rand((n, 3), generator=g, device=card) - 0.5)
        q = torch.randn((n, 4), generator=g, device=card)
        q = q / q.norm(dim=-1, keepdim=True)
        before = launch_counts()["jac3d"]
        out = mag3d_jacobian(consts, pos, q, nl_pad)
        self._check(out, mag3d_jacobian_plain(consts, pos, q, nl_pad),
                    torch.float32)
        assert torch.equal(
            out, mag3d_jacobian_rows(consts, pos, q, nl_pad).transpose(0, 1))
        torch.cuda.synchronize()
        assert launch_counts()["jac3d"] == before + 1

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("ny,nl,rw", [(1, 128, 8), (3, 128, 24),
                                          (3, 512, 21), (3, 128, 40),
                                          (3, 512, 40), (3, 136, 24)])
    def test_factored_kernels(self, card, dtype, ny, nl, rw):
        g = torch.Generator(device=card).manual_seed(nl + ny)
        n = 256
        B = torch.randn((n, nl, nl), generator=g, device=card)
        P_base = (0.05 * (B + B.transpose(1, 2))
                  + 2 * torch.eye(nl, device=card)).to(dtype)
        Wt = (0.1 * torch.randn((n, rw, nl), generator=g, device=card)
              ).to(dtype)
        C = (0.3 * torch.randn((n, ny, nl), generator=g, device=card)
             ).to(dtype)
        bidx = torch.randint(0, n, (n,), generator=g, device=card,
                             dtype=torch.int32)
        self._check(gather_cp(bidx, C, Wt, P_base),
                    gather_cp_plain(bidx, C, Wt, P_base), dtype)
        self._check(kf_rebase(bidx, Wt, P_base),
                    rebase_plain(bidx, Wt, P_base), dtype)
        torch.cuda.synchronize()

    @staticmethod
    def _block_inputs(card, n, ny, nl, dtype, seed):
        g = torch.Generator(device=card).manual_seed(seed)
        B = torch.randn((n, nl, nl), generator=g, device=card)
        P = (0.05 * (B + B.transpose(1, 2))
             + 2 * torch.eye(nl, device=card)).to(dtype)
        del B
        C = 0.3 * torch.randn((n, ny, nl), generator=g, device=card)
        xl = torch.randn((n, nl), generator=g, device=card)
        y = torch.randn((ny,), generator=g, device=card)
        R = 0.5 * torch.eye(ny, device=card)
        ai = torch.randint(0, n, (n,), generator=g, device=card,
                           dtype=torch.int32)
        return ai, C, xl, P, y, R

    @staticmethod
    def _block_plain(ai, C, xl, P, y, R):
        e = y[None] - torch.einsum("pij,pj->pi", C, xl)
        return block_gather_plain(ai, C, e, xl, P, R, 1e-3)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("ny,nl", [(1, 128), (3, 128), (1, 512),
                                       (3, 512), (1, 1024), (3, 1024)])
    def test_block_gather_kernel(self, card, dtype, ny, nl):
        """Every form of K5 (P resident in the block at nl=128, streamed at
        bf16 beyond, two passes at f32 beyond), on unsorted ancestors with
        repeats; a second launch on the same inputs gives the same bits
        (no atomics)."""
        n = 256 if nl < 1024 else 64
        args = self._block_inputs(card, n, ny, nl, dtype, nl + ny)
        before = launch_counts()["block_gather"]
        out = kf_update_block_gather(*args)
        again = kf_update_block_gather(*args)
        ref = self._block_plain(*args)
        torch.cuda.synchronize()
        assert launch_counts()["block_gather"] == before + 2
        for a, b in zip(out[:3], ref[:3]):
            self._check(a, b, dtype if a.dim() == 3 else torch.float32)
        assert torch.equal(out[3], ref[3])
        for a, b in zip(out, again):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("nl", [128, 512, 1024])
    def test_block_gather_bad_ancestor_writes_nan(self, card, nl):
        """An ancestor index out of range writes NaN (P', xl', logw) for
        that particle instead of reading out of bounds, in every form."""
        ai, C, xl, P, y, R = self._block_inputs(card, 8, 3, nl,
                                                torch.float32, 0)
        ai[2] = 8
        ai[5] = -1
        xl_new, P_new, logw, _ = kf_update_block_gather(ai, C, xl, P, y, R)
        torch.cuda.synchronize()
        for i in range(8):
            bad = i in (2, 5)
            for out in (P_new[i], xl_new[i], logw[i]):
                assert bool(torch.isnan(out).all()) == bad
                assert bool(torch.isfinite(out).all()) != bad

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nl", [16, 136, 512])
    @pytest.mark.parametrize("rw", [8, 24, 40])
    def test_gather_cp_kernel_widths(self, card, dtype, nl, rw):
        """K2 at map widths that give one, a few and many row groups and at
        three factor widths, on unsorted indices with repeats; a bad index
        writes NaN; a second launch gives the same bits."""
        g = torch.Generator(device=card).manual_seed(nl * rw)
        n, ny = 300, 3
        P_base = torch.randn((n, nl, nl), generator=g, device=card).to(dtype)
        Wt = (0.1 * torch.randn((n, rw, nl), generator=g, device=card)
              ).to(dtype)
        C = (0.3 * torch.randn((n, ny, nl), generator=g, device=card)
             ).to(dtype)
        bidx = torch.randint(0, n, (n,), generator=g, device=card,
                             dtype=torch.int32)
        out = gather_cp(bidx, C, Wt, P_base)
        self._check(out, gather_cp_plain(bidx, C, Wt, P_base), dtype)
        assert torch.equal(out, gather_cp(bidx, C, Wt, P_base))
        bidx[7], bidx[11] = -1, n
        out = gather_cp(bidx, C, Wt, P_base)
        assert bool(torch.isnan(out[[7, 11]]).all())
        good = torch.ones(n, dtype=torch.bool, device=card)
        good[[7, 11]] = False
        assert bool(torch.isfinite(out[good]).all())

    @staticmethod
    def _runs_inputs(card, n, nl, rw, live, dtype, seed):
        """P_base [n, nl, nl], Wt [n, rw, nl] with rows from ``live`` on
        zero, C [n, 3, nl], all in ``dtype``."""
        g = torch.Generator(device=card).manual_seed(seed)
        P_base = torch.randn((n, nl, nl), generator=g, device=card).to(dtype)
        Wt = torch.zeros((n, rw, nl), device=card, dtype=dtype)
        Wt[:, :live] = (0.1 * torch.randn((n, live, nl), generator=g,
                                          device=card)).to(dtype)
        C = (0.3 * torch.randn((n, 3, nl), generator=g, device=card)
             ).to(dtype)
        return g, P_base, Wt, C

    @staticmethod
    def _pattern(name, n, g, card):
        """Base indices: the main path's non-decreasing runs, runs that
        cross the kernel's 32-particle tiles, one run over all particles,
        runs of one, and unsorted indices with repeats."""
        if name == "sorted_runs":
            idx = torch.randint(0, n // 6, (n,), generator=g, device=card)
            return torch.sort(idx).values.to(torch.int32)
        if name == "runs_over_tile_edges":
            return ((torch.arange(n, device=card) + 29) // 7).to(torch.int32)
        if name == "one_run":
            return torch.full((n,), 5, dtype=torch.int32, device=card)
        if name == "runs_of_one":
            return torch.arange(n, dtype=torch.int32, device=card)
        return torch.randint(0, n, (n,), generator=g, device=card,
                             dtype=torch.int32)

    # K2's runs forms: bf16 at the headline width; f32 at the benchmark
    # cell's width (nl 640, rw 24) and at the reference width
    RUNS_SHAPES = [(torch.bfloat16, 128), (torch.float32, 640),
                   (torch.float32, 512)]

    @pytest.mark.parametrize("dtype,nl", RUNS_SHAPES)
    @pytest.mark.parametrize("pattern", ["sorted_runs",
                                         "runs_over_tile_edges", "one_run",
                                         "runs_of_one", "unsorted"])
    def test_gather_cp_runs_index_patterns(self, card, pattern, dtype, nl):
        """K2's runs forms (one read of P a run of equal base indices; at
        f32 runs longer than four particles are cut, and the blocks' shares
        of the pieces cut runs too) and K8 against their plain versions on
        every index pattern; two launches give the same bits, K8 those of
        K2 with Wt = 0, and the direct form agrees with the plain
        version."""
        from rbslam_tpu_torch.kernels.kf_update import _gather_cp
        from rbslam_tpu_torch.kernels.probes import (
            probe_gather_cp,
            probe_gather_cp_plain,
        )

        n, rw = 1000, 24
        g, P_base, Wt, C = self._runs_inputs(card, n, nl, rw, rw, dtype, 17)
        bidx = self._pattern(pattern, n, g, card)
        out = gather_cp(bidx, C, Wt, P_base)
        self._check(out, gather_cp_plain(bidx, C, Wt, P_base), dtype)
        assert torch.equal(out, gather_cp(bidx, C, Wt, P_base))
        self._check(_gather_cp(bidx, C, Wt, P_base, None, direct=True),
                    gather_cp_plain(bidx, C, Wt, P_base), dtype)
        k8 = probe_gather_cp(bidx, C.float(), P_base)
        self._check(k8, probe_gather_cp_plain(bidx, C.float(), P_base),
                    dtype)
        assert torch.equal(k8, gather_cp(bidx, C, torch.zeros_like(Wt),
                                         P_base))
        assert torch.equal(k8, probe_gather_cp(bidx, C.float(), P_base))

    @pytest.mark.parametrize("dtype,nl", RUNS_SHAPES)
    def test_gather_cp_runs_bad_index_inside_a_run(self, card, dtype, nl):
        """An index outside [0, n_base) in the middle of a run writes NaN
        for that particle alone; its neighbours in the run are unchanged."""
        n, rw = 500, 24
        g, P_base, Wt, C = self._runs_inputs(card, n, nl, rw, 12, dtype, 5)
        bidx = self._pattern("sorted_runs", n, g, card)
        good = gather_cp(bidx, C, Wt, P_base, rows=12)
        bad_at = [40, 41, 77, 300]
        bidx[40], bidx[41], bidx[77], bidx[300] = -1, n, -7, n + 3
        out = gather_cp(bidx, C, Wt, P_base, rows=12)
        keep = torch.ones(n, dtype=torch.bool, device=card)
        keep[bad_at] = False
        assert bool(torch.isnan(out[bad_at]).all())
        assert torch.equal(out[keep], good[keep])

    @pytest.mark.parametrize("dtype,nl", RUNS_SHAPES)
    @pytest.mark.parametrize("live", [0, 5, 16, 17])
    def test_gather_cp_runs_live_rows_bit_equal(self, card, live, dtype, nl):
        """``rows=k`` gives the bits of all 24 rows where the rows from k on
        are zero, in the runs forms and in the direct form."""
        from rbslam_tpu_torch.kernels.kf_update import _gather_cp

        n, rw = 700, 24
        g, P_base, Wt, C = self._runs_inputs(card, n, nl, rw, live, dtype,
                                             live)
        bidx = self._pattern("sorted_runs", n, g, card)
        out = gather_cp(bidx, C, Wt, P_base, rows=live)
        self._check(out, gather_cp_plain(bidx, C, Wt, P_base, live), dtype)
        assert torch.equal(out, gather_cp(bidx, C, Wt, P_base))
        assert torch.equal(_gather_cp(bidx, C, Wt, P_base, live, True),
                           _gather_cp(bidx, C, Wt, P_base, None, True))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("nl", [16, 136, 512])
    @pytest.mark.parametrize("rw", [12, 48, 96, 192])
    def test_gather_cp_runs_widths(self, card, nl, rw, dtype):
        """The runs forms at factor widths 12-192 (the rebase-period sweep)
        and map widths of one n8 pair, a ragged 136 and 512, on sorted runs
        with all but 5 rows live: against the plain version, live rows bit
        for bit against all rows."""
        n = 300
        g, P_base, Wt, C = self._runs_inputs(card, n, nl, rw, rw - 5,
                                             dtype, nl + rw)
        bidx = self._pattern("sorted_runs", n, g, card)
        out = gather_cp(bidx, C, Wt, P_base, rows=rw - 5)
        self._check(out, gather_cp_plain(bidx, C, Wt, P_base), dtype)
        assert torch.equal(out, gather_cp(bidx, C, Wt, P_base))

    def test_empty_inputs_launch_nothing(self, card):
        """An empty ensemble returns an empty output without a launch, so
        the counters count launches only."""
        consts = pack_basis_constants(hypercube_basis(20, LL), card)
        pos = torch.zeros((0, 3), device=card)
        q = torch.zeros((0, 4), device=card)
        bidx = torch.zeros((0,), dtype=torch.int32, device=card)
        Wt = torch.zeros((0, 8, 128), device=card)
        C = torch.zeros((0, 3, 128), device=card)
        P_base = torch.zeros((4, 128, 128), device=card)
        before = launch_counts()
        assert grad_basis(consts, pos).shape == (0, 3, consts.m)
        assert phi_basis(consts, pos).shape == (0, consts.m)
        assert mag3d_jacobian(consts, pos, q, 128).shape == (3, 0, 128)
        assert mag3d_jacobian_rows(consts, pos, q, 128).shape == (0, 3, 128)
        assert gather_cp(bidx, C, Wt, P_base).shape == (0, 3, 128)
        assert kf_rebase(bidx, Wt, P_base).shape == (0, 128, 128)
        out = kf_update_block_gather(bidx, C, torch.zeros((0, 128),
                                                          device=card),
                                     P_base, torch.zeros(3, device=card),
                                     torch.eye(3, device=card))
        assert out[1].shape == (0, 128, 128) and out[2].shape == (0,)
        assert launch_counts() == before

    def test_offsets_beyond_int32(self, card):
        """N=131072, nl=128: N*nl*nl = 2.1e9 elements, past 2^31. The
        kernels' last particles (reading the last ancestor rows) are
        checked against the plain version on those particles only: K2, K3
        and K5."""
        n, nl, rw, ny = 131072, 128, 24, 3
        g = torch.Generator(device=card).manual_seed(1)
        P_base = torch.empty((n, nl, nl), dtype=torch.bfloat16, device=card)
        P_base.normal_(generator=g)
        Wt = (0.1 * torch.randn((n, rw, nl), generator=g, device=card)
              ).to(torch.bfloat16)
        C = (0.3 * torch.randn((n, ny, nl), generator=g, device=card)
             ).to(torch.bfloat16)
        bidx = torch.arange(n, device=card, dtype=torch.int32).flip(0)
        bidx[-64:] = n - 1 - torch.arange(64, device=card, dtype=torch.int32)
        tail = slice(n - 64, n)
        self._check(gather_cp(bidx, C, Wt, P_base)[tail],
                    gather_cp_plain(bidx[tail], C[tail], Wt[tail], P_base),
                    torch.bfloat16)
        out = kf_rebase(bidx, Wt, P_base)
        self._check(out[tail], rebase_plain(bidx[tail], Wt[tail], P_base),
                    torch.bfloat16)
        del out, Wt
        xl = torch.randn((n, nl), generator=g, device=card)
        y = torch.randn((ny,), generator=g, device=card)
        R = 200 * torch.eye(ny, device=card)   # S stays PD: P_base is noise
        C = C.float()
        got = kf_update_block_gather(bidx, C, xl, P_base, y, R)
        want = self._block_plain(bidx[tail], C[tail], xl[tail], P_base, y, R)
        for a, b in zip(got[:3], want[:3]):
            self._check(a[tail], b,
                        torch.bfloat16 if a.dim() == 3 else torch.float32)
        assert torch.equal(got[3][tail], want[3])
        torch.cuda.synchronize()

    @pytest.mark.parametrize("kernel,n,d,m,nl_pad,dtype,form", [
        # K1: the headline and reference shapes, n not a multiple of the
        # block's particles, a row that is not a whole number of 16-byte
        # stores (bf16 nl_pad 132, f32 nl_pad 131)
        ("jac3d_rows", 16384, 3, 125, 128, torch.bfloat16, 1),
        ("jac3d_rows", 4096, 3, 509, 512, torch.float32, 1),
        ("jac3d_rows", 1001, 3, 125, 128, torch.float32, 1),
        ("jac3d_rows", 777, 3, 125, 132, torch.bfloat16, 1),
        ("jac3d_rows", 555, 3, 128, 131, torch.float32, 1),
        # K7 at the headline shape and at an odd width; at the smoothed
        # trajectory's shape (192 particles) the direct form
        ("jac3d", 16384, 3, 125, 128, torch.float32, 1),
        ("jac3d", 333, 3, 61, 67, torch.float32, 1),
        ("jac3d", 192, 3, 512, 640, torch.float32, 0),
        # K4 at d = 1, 2, 3; d m odd (four particles a block), n odd; at
        # the smoothers' 100 particles the direct form
        ("grad_basis", 16384, 3, 125, None, torch.float32, 1),
        ("grad_basis", 16384, 2, 128, None, torch.float32, 1),
        ("grad_basis", 1103, 2, 75, None, torch.float32, 1),
        ("grad_basis", 1999, 1, 17, None, torch.float32, 1),
        ("grad_basis", 600, 1, 250, None, torch.float32, 1),
        ("grad_basis", 100, 3, 512, None, torch.float32, 0),
    ])
    def test_table_form_bit_equal_to_direct_form(self, card, kernel, n, d, m,
                                                 nl_pad, dtype, form):
        """K1, K7 and K4 in the form the planner picks against their plain
        versions, twice for equal bits, and bit-equal to their direct form
        on the same constants (the direct form runs where the counts say
        the dimensions have more than 256 distinct values in all)."""
        from rbslam_tpu_torch.kernels.basis_eval import _basis_plan

        g = torch.Generator(device=card).manual_seed(n + m)
        consts = pack_basis_constants(_basis(m, d), card)
        half = torch.tensor([18.0, 18.0, 2.0] if d == 3 else HALF[:d],
                            device=card)
        x = (2 * torch.rand((n, d), generator=g, device=card) - 1) * half
        q = torch.randn((n, 4), generator=g, device=card)
        q = q / q.norm(dim=-1, keepdim=True)
        jac = kernel != "grad_basis"
        item = torch.tensor([], dtype=dtype).element_size()
        assert _basis_plan(jac, n, d, m, nl_pad or 0, item,
                           consts.counts)[0] == form
        direct = consts._replace(counts=(257,) * d)

        def run(c):
            if kernel == "jac3d_rows":
                return mag3d_jacobian_rows(c, x, q, nl_pad, dtype)
            if kernel == "jac3d":
                return mag3d_jacobian(c, x, q, nl_pad)
            return grad_basis(c, x)

        before = launch_counts()[kernel]
        out = run(consts)
        plain = {"jac3d_rows": lambda: mag3d_jacobian_rows_plain(
                     consts, x, q, nl_pad, dtype),
                 "jac3d": lambda: mag3d_jacobian_plain(consts, x, q, nl_pad),
                 "grad_basis": lambda: grad_basis_plain(consts, x)}[kernel]()
        self._check(out, plain, dtype)
        assert torch.equal(run(consts), out)
        assert torch.equal(run(direct), out)
        torch.cuda.synchronize()
        assert launch_counts()[kernel] == before + 3

    @pytest.mark.parametrize("kernel", ["jac3d_rows", "jac3d", "grad_basis"])
    def test_direct_form_where_a_dimension_has_many_values(self, card,
                                                           kernel):
        """Over 256 distinct values in all dimensions: the planner picks
        the direct form, which still serves the shape; a plan that
        disagrees with the C entry's own is refused."""
        from rbslam_tpu_torch.kernels import _lib
        from rbslam_tpu_torch.kernels.basis_eval import _table_args

        d = 1 if kernel == "grad_basis" else 3
        basis = (hypercube_basis(2000, [9.0]) if d == 1
                 else hypercube_basis(1100, [1000.0, 1.0, 1.0]))
        consts = pack_basis_constants(basis, card)
        assert sum(consts.counts) > 256
        g = torch.Generator(device=card).manual_seed(3)
        n = 50
        x = (2 * torch.rand((n, d), generator=g, device=card) - 1) \
            * (0.9 * torch.tensor(basis.L, dtype=torch.float32, device=card))
        q = torch.randn((n, 4), generator=g, device=card)
        q = q / q.norm(dim=-1, keepdim=True)
        nl_pad = 1152
        if kernel == "jac3d_rows":
            out = mag3d_jacobian_rows(consts, x, q, nl_pad)
            plain = mag3d_jacobian_rows_plain(consts, x, q, nl_pad)
        elif kernel == "jac3d":
            out = mag3d_jacobian(consts, x, q, nl_pad)
            plain = mag3d_jacobian_plain(consts, x, q, nl_pad)
        else:
            out, plain = grad_basis(consts, x), grad_basis_plain(consts, x)
        self._check(out, plain, torch.float32)
        # the table form asked for where the C planner says direct
        bad = torch.empty_like(out)
        args = _table_args(consts, consts.grad_codes, (1, 1))
        if kernel == "grad_basis":
            code = _lib.lib().rbs_grad_basis(
                x.data_ptr(), consts.packed.data_ptr(), consts.scale,
                bad.data_ptr(), n, consts.m, d, *args, _lib.stream_ptr())
        else:
            code = getattr(_lib.lib(), f"rbs_{kernel}")(
                x.data_ptr(), q.data_ptr(), consts.packed.data_ptr(),
                consts.scale, bad.data_ptr(), n, consts.m, nl_pad,
                *((0,) if kernel == "jac3d_rows" else ()), *args,
                _lib.stream_ptr())
        assert code != 0
