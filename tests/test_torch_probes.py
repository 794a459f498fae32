"""The kernel-part probes K8-K11 of the port.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the jnp expression that the probe's TPU script itself uses as its
reference (scripts/profile_gather_cp.py, profile_rebase_parts.py,
profile_gather_kernel.py, profile_block_mxu.py), evaluated with JAX on the
CPU on the same numpy inputs. The scripts run on import and pass no
interpret flag, so the expressions are written out here. ``TestOnCard``
(marker ``gpu``) compares each CUDA kernel with its plain version, repeats
the cross-checks on the kernels, and skips without a card; it needs no JAX.

Tolerances: float32 1e-5 of the output's scale; bf16 one bf16 rounding
(2^-8) of the scale; the bare gather exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu_torch.kernels import (  # noqa: E402
    block_gather_plain,
    gather_cp,
    gather_cp_plain,
    kf_rebase,
    kf_update_block_gather,
    launch_counts,
    probe_block_products,
    probe_block_products_plain,
    probe_gather,
    probe_gather_cp,
    probe_gather_cp_plain,
    probe_gather_plain,
    probe_rebase_parts,
    probe_rebase_parts_plain,
    reset_launch_counts,
)

TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
SHAPES = [(32, 16), (32, 24)]          # (N, nl)
VARIANTS = [(True, False), (False, True), (True, True), (False, False)]


def _inputs(n, nl, rw=8, ny=3, seed=0):
    """bidx/ai (with duplicates), C, Wt, P as float32 numpy arrays."""
    rng = np.random.default_rng(seed + 17 * nl)
    P = rng.normal(size=(n, nl, nl)).astype(np.float32)
    Wt = (0.1 * rng.normal(size=(n, rw, nl))).astype(np.float32)
    C = (0.3 * rng.normal(size=(n, ny, nl))).astype(np.float32)
    idx = np.sort(rng.integers(0, n, size=n)).astype(np.int32)
    return idx, C, Wt, P


def _t(a, dtype=None):
    x = torch.tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def _close(port, ref, dtype):
    """port (torch) against ref (a JAX array), both shown in float32."""
    a = port.float().numpy()
    b = np.asarray(ref.astype("float32"))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL[dtype] * max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return jnp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nl", SHAPES)
def test_gather_cp_probe_matches_jax(jnp, n, nl, dtype):
    import jax

    bidx, C, _, P = _inputs(n, nl)
    Pj = jnp.asarray(P).astype(dtype)
    # the script's reference (profile_gather_cp.py:86-88), with its gather
    ref = jax.lax.dot_general(
        jnp.asarray(C).astype(dtype), jnp.take(Pj, bidx, axis=0),
        (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32)
    out = probe_gather_cp(_t(bidx), _t(C), _t(P, TDTYPE[dtype]))
    assert out.dtype == torch.float32
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("do_gather,do_dot", VARIANTS)
@pytest.mark.parametrize("n,nl,rw", [(32, 16, 8), (32, 24, 8), (32, 24, 24),
                                     (16, 136, 40)])
def test_rebase_parts_probe_matches_jax(jnp, n, nl, rw, do_gather, do_dot,
                                        dtype):
    import jax

    bidx, _, Wt, P = _inputs(n, nl, rw=rw)
    Pj = jnp.asarray(P).astype(dtype)
    Wj = jnp.asarray(Wt).astype(dtype)
    src = jnp.take(Pj, bidx, axis=0) if do_gather else jnp.zeros_like(Pj)
    if do_dot:
        dd = jax.lax.dot_general(Wj, Wj, (((1,), (1,)), ((0,), (0,))),
                                 preferred_element_type=jnp.float32)
        ref = src - dd.astype(Pj.dtype)
    else:
        ref = src
    td = TDTYPE[dtype]
    out = probe_rebase_parts(_t(bidx), _t(Wt, td), _t(P, td), do_gather,
                             do_dot)
    assert out.dtype == td
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nl", SHAPES)
def test_gather_probe_equals_jnp_take(jnp, n, nl, dtype):
    ai, _, _, P = _inputs(n, nl)
    Pj = jnp.asarray(P).astype(dtype)
    ref = np.asarray(jnp.take(Pj, ai, axis=0).astype("float32"))
    out = probe_gather(_t(ai), _t(P, TDTYPE[dtype]))
    assert out.dtype == TDTYPE[dtype]
    assert np.array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nl", SHAPES)
def test_block_products_probe_matches_jax(jnp, n, nl, dtype):
    import jax

    _, C, _, P = _inputs(n, nl)
    Pj = jnp.asarray(P).astype(dtype)
    # _kernel with _products_batched (profile_block_mxu.py:45-56, 77-81)
    Pf = Pj.astype(jnp.float32)
    Cf = jnp.asarray(C)
    CP = jax.lax.dot_general(Cf, Pf, (((2,), (1,)), ((0,), (0,))),
                             preferred_element_type=jnp.float32)
    dd = jax.lax.dot_general(CP, 0.7 * CP, (((1,), (1,)), ((0,), (0,))),
                             preferred_element_type=jnp.float32)
    ref = (Pf - dd).astype(Pj.dtype)
    out = probe_block_products(_t(C), _t(P, TDTYPE[dtype]))
    assert out.dtype == TDTYPE[dtype]
    _close(out, ref, dtype)


def _cross_checks(device, dtype, n, nl, rw=8):
    """The four identities that tie the probes to K2, K3 and to each other,
    through the wrappers (plain versions on the CPU, kernels on a card)."""
    bidx, C, Wt, P = _inputs(n, nl, rw=rw)
    td = TDTYPE[dtype]
    bidx = _t(bidx).to(device)
    P = _t(P, td).to(device)
    Wt = _t(Wt, td).to(device)
    C_st = _t(C, td).to(device)            # C already in P's dtype
    # K10 against the one PyTorch call that computes it
    g = probe_gather(bidx, P)
    assert torch.equal(g, torch.index_select(P, 0, bidx.long()))
    # K9(gather, no dot) is K10
    assert torch.equal(probe_rebase_parts(bidx, Wt, P, True, False), g)
    # K9(gather, dot) is K3
    assert torch.equal(probe_rebase_parts(bidx, Wt, P, True, True),
                       kf_rebase(bidx, Wt, P))
    # K8 is K2 with Wt = 0
    assert torch.equal(probe_gather_cp(bidx, C_st.float(), P),
                       gather_cp(bidx, C_st, torch.zeros_like(Wt), P))
    # write only is zeros, dot + write is the negated rounded product
    assert not bool(probe_rebase_parts(bidx, Wt, P, False, False).any())
    assert torch.equal(
        probe_rebase_parts(bidx, Wt, P, False, True),
        probe_rebase_parts(bidx, Wt, torch.zeros_like(P), True, True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nl,rw", [(32, 16, 8), (32, 24, 8), (32, 24, 24),
                                     (16, 136, 40)])
def test_cross_checks_hold_on_plain_versions(n, nl, rw, dtype):
    _cross_checks("cpu", dtype, n, nl, rw=rw)


def test_cpu_tensors_take_plain_version_and_count_nothing():
    reset_launch_counts()
    bidx, C, Wt, P = map(_t, _inputs(8, 16))
    assert torch.equal(probe_gather_cp(bidx, C, P),
                       probe_gather_cp_plain(bidx, C, P))
    assert torch.equal(probe_rebase_parts(bidx, Wt, P),
                       probe_rebase_parts_plain(bidx, Wt, P))
    assert torch.equal(probe_gather(bidx, P), probe_gather_plain(bidx, P))
    assert torch.equal(probe_block_products(C, P),
                       probe_block_products_plain(C, P))
    assert set(launch_counts().values()) == {0}


def test_wrappers_reject_bad_inputs():
    bidx, C, Wt, P = map(_t, _inputs(8, 16))
    with pytest.raises(TypeError, match="int32"):
        probe_gather(bidx.long(), P)
    with pytest.raises(TypeError, match="int32"):
        probe_gather_cp(bidx[:4], C, P)
    with pytest.raises(TypeError, match="float32"):
        probe_gather_cp(bidx, C.bfloat16(), P)
    with pytest.raises(ValueError, match="ny <= 3"):
        probe_block_products(torch.zeros(8, 4, 16), P)
    with pytest.raises(TypeError, match="Wt must be"):
        probe_rebase_parts(bidx, Wt.bfloat16(), P)
    with pytest.raises(TypeError, match="P must be"):
        probe_gather(bidx, P.double())
    with pytest.raises(ValueError, match="contiguous"):
        probe_gather(bidx, P.transpose(1, 2))
    with pytest.raises(RuntimeError, match="no kernel for device"):
        probe_gather(bidx.to("meta"), P.to("meta"))


def test_kernel_paths_need_aligned_tensors_and_a_tile_that_fits():
    """What the wrappers decide before a launch (on CPU tensors the helpers
    are called directly: a wrapper takes the plain version there): a view
    that does not start on a 16-byte boundary is copied for the bulk
    copies, and the rebase runs its ring with the staged factor where both
    fit the 227 KB a block may use, else its wide form."""
    from rbslam_tpu_torch.kernels.kf_update import (
        _aligned,
        _rebase_smem,
        _rebase_variant,
    )

    base = torch.zeros(4 * 16 * 16 + 2)
    view = base[:1024].view(4, 16, 16)
    assert _aligned(view) is view
    shifted = base[1:1025].view(4, 16, 16)          # 4 bytes past 16
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    copied = _aligned(shifted)
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, shifted)
    # the main shapes and the widest factor fit, with room for 3 and 2
    # blocks an SM
    assert _rebase_smem(24, 128, 2) == 59904
    assert _rebase_smem(24, 512, 4) == 114688
    assert _rebase_variant("kf_rebase", 40, 512, 4) == 0
    assert _rebase_variant("probe_rebase_parts", 40, 512, 2, False, True) == 0
    # without the product only the gather's 2 KB piece, or nothing
    assert _rebase_smem(24, 512, 4, True, False) == 2048
    assert _rebase_smem(24, 512, 4, False, False) == 0
    with pytest.raises(ValueError, match="multiple of 8"):
        _rebase_variant("kf_rebase", 8, 20, 4)
    # nl = 2048 (and a factor too wide to stage) take the wide form
    assert _rebase_variant("kf_rebase", 24, 2048, 4) == 1
    assert _rebase_variant("kf_rebase", 24, 2048, 2) == 1
    assert _rebase_variant("probe_rebase_parts", 512, 512, 2, False, True) == 1
    # a copy needs no room for the factor
    assert _rebase_variant("probe_rebase_parts", 512, 512, 2, True, False) == 0


# (ny, nl, itemsize) -> (form, stage rows, shared memory bytes) of
# csrc/kf_block.cuh:block_gather_plan: P resident in one block up to 64 KB
# (form 1), else streamed at bf16 (2), else the two-pass form (0)
@pytest.mark.parametrize("ny,nl,itemsize,plan", [
    (3, 128, 2, (1, 32, 51200)),       # headline K5: 4 blocks an SM
    (3, 128, 4, (1, 16, 83968)),       # f32 nl=128: 2 blocks an SM
    (1, 128, 4, (1, 16, 71680)),
    (3, 512, 4, (0, 0, 24576)),        # reference K5
    (3, 512, 2, (2, 0, 49152)),
    (3, 1024, 4, (0, 0, 49152)),
    (1, 1024, 2, (2, 0, 24576)),
    (3, 2048, 4, (0, 0, 96 * 1024)),
    (3, 16, 4, (1, 16, 3328)),         # probe shapes
    (3, 136, 4, (0, 0, 9792)),
    (3, 136, 2, (1, 30, 68000)),
])
def test_block_plan_mirror(ny, nl, itemsize, plan):
    from rbslam_tpu_torch.kernels.kf_update import _block_plan

    assert _block_plan(ny, nl, itemsize) == plan


# (ny, rw, nl, itemsize, factor) -> csrc/kf_common.cuh:gather_cp_plan: 0 one
# read of P a piece of a run of equal indices through the ring (f32, rows
# of at most 256 16-byte units), 2 direct, 3 one read of P a run of equal
# indices (bf16 up to 512 columns)
@pytest.mark.parametrize("ny,rw,nl,itemsize,factor,plan", [
    (3, 24, 128, 2, True, 3), (3, 24, 512, 4, True, 0),
    (3, 40, 512, 4, True, 0), (3, 24, 512, 4, False, 0),
    (3, 24, 128, 4, True, 0), (3, 24, 2048, 4, True, 2),
    (3, 40, 4096, 2, True, 2), (3, 24, 640, 4, True, 0),
    (3, 24, 640, 2, True, 2), (3, 24, 1024, 4, True, 0),
    (3, 192, 512, 4, True, 0), (3, 24, 1032, 4, True, 2),
])
def test_gather_cp_plan_mirror(ny, rw, nl, itemsize, factor, plan):
    from rbslam_tpu_torch.kernels.kf_update import _gather_cp_plan

    assert _gather_cp_plan(ny, rw, nl, itemsize, factor) == plan


# the factor widths rw = 3 r of workloads/sweep_lowrank.py (r = 4 ... 64) at
# the headline and reference map widths, worked out by hand from
# csrc/kf_common.cuh: (K2 gather_cp_plan, K3 rebase_variant). At f32 nl=512
# K3's staged factor stops fitting from rw = 96 (it takes its wide form), at
# bf16 nl=512 from rw = 192; K2 streams the factor rows (through its ring
# at f32, in 16-row chunks at bf16), so rw does not move it
SWEEP_FORMS = {
    (128, 2): [(3, 0)] * 5,
    (128, 4): [(0, 0)] * 5,
    (512, 2): [(3, 0)] * 4 + [(3, 1)],
    (512, 4): [(0, 0)] * 3 + [(0, 1)] * 2,
}


@pytest.mark.parametrize("nl,itemsize", list(SWEEP_FORMS))
@pytest.mark.parametrize("i,rw", list(enumerate((12, 24, 48, 96, 192))))
def test_sweep_factor_widths_plan(nl, itemsize, i, rw):
    from rbslam_tpu_torch.kernels.kf_update import (
        _gather_cp_plan,
        _rebase_variant,
    )

    assert (_gather_cp_plan(3, rw, nl, itemsize),
            _rebase_variant("kf_rebase", rw, nl, itemsize)) == \
        SWEEP_FORMS[nl, itemsize][i]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a): the CUDA kernels have "
                    "no CPU mode; their plain versions are tested above")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
class TestOnCard:
    """Each probe kernel against its plain version on the card: f32 1e-4
    of the output's max magnitude and elementwise rtol 1e-4 with a floor
    of 1e-6 of that magnitude; bf16 2e-2 of the max magnitude; the gather
    exact."""

    @staticmethod
    def _check(kernel_out, plain_out, dtype):
        assert kernel_out.shape == plain_out.shape
        assert kernel_out.dtype == plain_out.dtype
        a, b = kernel_out.float(), plain_out.float()
        assert bool(torch.isfinite(a).all())
        tol = 1e-4 if dtype == "float32" else 2e-2
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale
        if dtype == "float32":
            assert torch.allclose(a, b, rtol=tol, atol=1e-6 * scale)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,nl,rw", [(32, 16, 8), (32, 24, 8),
                                         (256, 128, 24), (64, 512, 21),
                                         (300, 128, 8), (40, 512, 40),
                                         (64, 136, 40), (16, 512, 24)])
    def test_probe_kernels(self, card, dtype, n, nl, rw):
        # (16, 512, 24) in f32: dot + write asks for exactly 48 KB of
        # dynamic shared memory beside the kernel's static barriers
        bidx, C, Wt, P = _inputs(n, nl, rw=rw)
        td = TDTYPE[dtype]
        bidx, C = _t(bidx).to(card), _t(C).to(card)
        Wt, P = _t(Wt, td).to(card), _t(P, td).to(card)
        before = launch_counts()
        self._check(probe_gather_cp(bidx, C, P),
                    probe_gather_cp_plain(bidx, C, P), dtype)
        for do_gather, do_dot in VARIANTS:
            self._check(
                probe_rebase_parts(bidx, Wt, P, do_gather, do_dot),
                probe_rebase_parts_plain(bidx, Wt, P, do_gather, do_dot),
                dtype)
        assert torch.equal(probe_gather(bidx, P), probe_gather_plain(bidx, P))
        self._check(probe_block_products(C, P),
                    probe_block_products_plain(C, P), dtype)
        torch.cuda.synchronize()
        after = launch_counts()
        grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert grew == {"probe_gather_cp": 1, "probe_rebase_parts": 4,
                        "probe_gather": 1, "probe_block_products": 1}

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,nl,rw", [(32, 16, 8), (256, 128, 8),
                                         (64, 512, 8), (256, 128, 24),
                                         (64, 136, 40)])
    def test_cross_checks_hold_on_kernels(self, card, dtype, n, nl, rw):
        _cross_checks(card, dtype, n, nl, rw=rw)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("nl", [16, 136, 512])
    def test_bad_index_writes_nan(self, card, dtype, nl):
        bidx, C, Wt, P = _inputs(8, nl)
        bidx = _t(bidx).to(card)
        bidx[2], bidx[5] = -1, 8
        td = TDTYPE[dtype]
        C = _t(C).to(card)
        Wt, P = _t(Wt, td).to(card), _t(P, td).to(card)
        good = torch.ones(8, dtype=torch.bool, device=card)
        good[2] = good[5] = False
        for out in (probe_gather(bidx, P), probe_gather_cp(bidx, C, P),
                    probe_rebase_parts(bidx, Wt, P),
                    probe_rebase_parts(bidx, Wt, P, True, False)):
            flat = out.reshape(8, -1)
            assert bool(torch.isnan(flat[~good]).all())
            assert bool(torch.isfinite(flat[good]).all())
        # without the gather the index is never read
        assert bool(torch.isfinite(
            probe_rebase_parts(bidx, Wt, P, False, True)).all())

    def test_empty_inputs_launch_nothing(self, card):
        before = launch_counts()
        e_i = torch.zeros(0, dtype=torch.int32, device=card)
        P = torch.zeros((4, 16, 16), device=card)
        assert probe_gather(e_i, P).shape == (0, 16, 16)
        assert probe_gather_cp(e_i, torch.zeros((0, 3, 16), device=card),
                               P).shape == (0, 3, 16)
        assert probe_rebase_parts(e_i, torch.zeros((0, 8, 16), device=card),
                                  P).shape == (0, 16, 16)
        assert probe_block_products(
            torch.zeros((0, 3, 16), device=card), P[:0]).shape == (0, 16, 16)
        assert launch_counts() == before

    def test_misaligned_tensors_raise(self, card):
        """A contiguous view that starts 4 bytes past a 16-byte boundary:
        the bulk copies cannot take it, so each wrapper copies it and
        launches once; the result equals the plain version's."""
        bidx, C, Wt, P = _inputs(8, 16)
        bidx, C, Wt = _t(bidx).to(card), _t(C).to(card), _t(Wt).to(card)
        flat = torch.zeros(8 * 16 * 16 + 1, device=card)
        shifted = flat[1:].view(8, 16, 16)
        shifted.copy_(_t(P))
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        wflat = torch.zeros(Wt.numel() + 1, device=card)
        wshift = wflat[1:].view(Wt.shape)
        wshift.copy_(Wt)
        calls = [
            ("probe_gather", lambda: probe_gather(bidx, shifted),
             lambda: probe_gather_plain(bidx, shifted)),
            ("probe_rebase_parts", lambda: probe_rebase_parts(bidx, wshift,
                                                              shifted),
             lambda: probe_rebase_parts_plain(bidx, wshift, shifted)),
            ("rebase", lambda: kf_rebase(bidx, wshift, shifted),
             lambda: probe_rebase_parts_plain(bidx, wshift, shifted)),
            ("probe_gather_cp", lambda: probe_gather_cp(bidx, C, shifted),
             lambda: probe_gather_cp_plain(bidx, C, shifted)),
            ("gather_cp", lambda: gather_cp(bidx, C, wshift, shifted),
             lambda: gather_cp_plain(bidx, C, wshift, shifted)),
            ("probe_block_products",
             lambda: probe_block_products(C, shifted),
             lambda: probe_block_products_plain(C, shifted)),
        ]
        # K5 takes nl a multiple of 128: its own shifted covariances
        n, ny, nl = 4, 3, 128
        g = torch.Generator(device=card).manual_seed(3)
        B = torch.randn((n, nl, nl), generator=g, device=card)
        pflat = torch.zeros(n * nl * nl + 1, device=card)
        P_all = pflat[1:].view(n, nl, nl)
        P_all.copy_(0.05 * (B + B.transpose(1, 2)) + 2 * torch.eye(nl,
                                                                   device=card))
        assert P_all.is_contiguous() and P_all.data_ptr() % 16
        Ck = 0.3 * torch.randn((n, ny, nl), generator=g, device=card)
        xl = torch.randn((n, nl), generator=g, device=card)
        y = torch.randn((ny,), generator=g, device=card)
        R = 0.5 * torch.eye(ny, device=card)
        ai = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=card)
        e = y[None] - torch.einsum("pij,pj->pi", Ck, xl)
        calls.append((
            "block_gather",
            lambda: kf_update_block_gather(ai, Ck, xl, P_all, y, R, 1e-3)[1],
            lambda: block_gather_plain(ai, Ck, e, xl, P_all, R, 1e-3)[1]))
        for name, kernel, plain in calls:
            before = launch_counts()
            self._check(kernel(), plain(), "float32")
            torch.cuda.synchronize()
            after = launch_counts()
            assert {k: after[k] - before[k] for k in after
                    if after[k] != before[k]} == {name: 1}

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tile_that_does_not_fit_raises(self, card, dtype):
        """nl = 2048: the rebase's ring and staged factor do not fit a
        block, so kf_rebase and probe_rebase_parts run the wide form on the
        card and equal their plain versions."""
        g = torch.Generator(device=card).manual_seed(5)
        td = TDTYPE[dtype]
        n, nl, rw = 4, 2048, 24
        P = torch.randn((n, nl, nl), generator=g, device=card).to(td)
        Wt = (0.1 * torch.randn((n, rw, nl), generator=g, device=card)).to(td)
        bidx = torch.tensor([2, 0, 2, 3], dtype=torch.int32, device=card)
        before = launch_counts()
        self._check(kf_rebase(bidx, Wt, P),
                    probe_rebase_parts_plain(bidx, Wt, P), dtype)
        for do_gather in (True, False):
            self._check(probe_rebase_parts(bidx, Wt, P, do_gather, True),
                        probe_rebase_parts_plain(bidx, Wt, P, do_gather, True),
                        dtype)
        # the copies need no room for the factor
        assert torch.equal(probe_rebase_parts(bidx, Wt, P, True, False),
                           probe_gather(bidx, P))
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["rebase"] == before["rebase"] + 1
        assert after["probe_rebase_parts"] == before["probe_rebase_parts"] + 3

    def test_unsorted_indices_and_many_pieces(self, card):
        """The gather walks piece-major over all matrices: an unsorted
        index vector with repeats, more matrices than one wave of blocks."""
        g = torch.Generator(device=card).manual_seed(3)
        P = torch.randn((3000, 72, 72), generator=g, device=card)
        ai = torch.randint(0, 3000, (5000,), generator=g, device=card,
                           dtype=torch.int32)
        assert torch.equal(probe_gather(ai, P),
                           torch.index_select(P, 0, ai.long()))
