"""Kalman-update kernels of the filter: the gathered dense update K5 and the
low-rank factored update K2/K3, with their plain PyTorch versions and the
small-ny algebra around K2 (port of rbslam_tpu/kernels/kf_update.py).

K5 (``kf_update_block_gather``) is one whole dense KF update per particle
with the resampling gather of P fused in: it reads each particle's
ancestor covariance P_all[ai] once and writes P' once, with the small-ny
innovation algebra (closed-form Cholesky with a Gershgorin repair,
``spd_inv_logdet_plain``) inside the kernel.

The KF downdate is additive rank-ny per step (src/particleFilter.m:194-198):

    P_t = P_base - sum_tau U_tau S_tau^-1 U_tau^T = P_base - Wt^T Wt,
    Wt rows at step tau: Y_tau = L_tau^-1 C_tau P_tau   (S = L L^T)

so the filter carries the factor Wt [rw, nl] and materializes P
("rebase") only every r steps. Per step, K2 reads each particle's
ancestor row of P_base (read-only between rebases, gathered by composed
base indices) and folds in the factor correction; the small-ny algebra
(S, closed-form Cholesky, weights, gain) stays plain torch, as the
reference left it to XLA.

Each wrapper takes the plain version for tensors on the CPU, launches its
kernel (``csrc/kf_update.cu``) for CUDA tensors, and raises for any other
device. The plain versions are public, for checking the kernels.
"""

from __future__ import annotations

import math

import torch

from ..ops.kalman import (
    _chol_small_batched,
    _Li_from_chol_small_batched,
    _tri_solve_small_batched,
)
from . import _lib

_LOG2PI = math.log(2.0 * math.pi)
_STORAGE = (torch.float32, torch.bfloat16)
_MAX_SMEM = 232448   # bytes of shared memory one block may use on Hopper


def gather_cp_plain(bidx, C, Wt, P_base, rows=None) -> torch.Tensor:
    """Plain version of K2: C[b] P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]
    in float32, with C rounded to P's dtype and C Wt^T to Wt's dtype
    (the reference's rounding points, kf_update.py:529,538), over the
    factor rows Wt[:, :rows] (all rows where ``rows`` is None). The
    correction is summed one factor row at a time, in order, so zero rows
    beyond ``rows`` would add exact zeros: ``rows=k`` equals all rows, bit
    for bit, where the rows from k on are zero."""
    f32 = torch.float32
    P = P_base[bidx.long()]
    CPb = torch.einsum("pij,pjk->pik", C.to(P.dtype).to(f32), P.to(f32))
    Cw = C.to(Wt.dtype).to(f32)
    corr = torch.zeros_like(CPb)
    for r in range(Wt.shape[1] if rows is None else rows):
        w = Wt[:, r].to(f32)                               # [N, nl]
        cw = (Cw * w[:, None, :]).sum(-1).to(Wt.dtype).to(f32)
        corr += cw[:, :, None] * w[:, None, :]
    return CPb - corr


def rebase_plain(bidx, Wt, P_base) -> torch.Tensor:
    """Plain version of K3: P_base[bidx] - round(Wt^T Wt), storage dtype."""
    Wf = Wt.to(torch.float32)
    dd = torch.einsum("pri,prj->pij", Wf, Wf)
    return P_base[bidx.long()] - dd.to(P_base.dtype)


def _check_factored(bidx, Wt, P_base) -> tuple[int, int, int]:
    if bidx.dtype != torch.int32 or bidx.dim() != 1:
        raise TypeError("bidx must be a 1-D int32 tensor")
    if P_base.dtype not in _STORAGE or Wt.dtype != P_base.dtype:
        raise TypeError(
            f"P_base and Wt must share a float32 or bfloat16 dtype, got "
            f"{P_base.dtype} and {Wt.dtype}"
        )
    n, rw, nl = Wt.shape
    if bidx.shape[0] != n:
        raise ValueError(f"bidx has {bidx.shape[0]} entries, Wt {n}")
    if P_base.dim() != 3 or tuple(P_base.shape[1:]) != (nl, nl):
        raise ValueError(f"P_base must be [n_base, {nl}, {nl}]")
    devices = {t.device for t in (bidx, Wt, P_base)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    for name, t in (("bidx", bidx), ("Wt", Wt), ("P_base", P_base)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, rw, nl


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels move P and Wt by 16-byte bulk copies, which need a
    16-byte aligned start: a contiguous view with a storage offset may not
    have one, and is copied (on its device) into a fresh tensor, which
    does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _rebase_smem(rw: int, nl: int, itemsize: int, gather: bool = True,
                 dot: bool = True) -> int:
    """Bytes of dynamic shared memory the rebase kernel needs (the mirror
    of ``rebase_smem_bytes`` in csrc/kf_common.cuh): without the product
    one 2 KB piece of the gather, or nothing; with it four stages of whole row
    blocks of P (about 8 KB each at bf16, 16 KB at f32) when P is gathered,
    and the staged factor: Wt [rw, nl] in f32, or at bf16 Wt padded to
    [round_up(rw, 16), round_up(nl, 16) + 8] plus eight [16, 72]
    accumulator tiles."""
    if not dot:
        return 2048 if gather else 0
    row_block, stage_bytes = (16, 8192) if itemsize == 2 else (4, 16384)
    rows = max(stage_bytes // (nl * itemsize) // row_block * row_block,
               row_block)
    rows = min(rows, _round_up(nl, row_block))
    ring = 4 * rows * nl * itemsize if gather else 0
    if itemsize == 4:
        return ring + 4 * rw * nl
    return ring + 2 * _round_up(rw, 16) * (_round_up(nl, 16) + 8) \
        + 8 * 16 * 72 * 2


def _rebase_variant(name, rw, nl, itemsize, gather=True, dot=True) -> int:
    """The rebase kernel's form (the mirror of ``rebase_variant`` in
    csrc/kf_common.cuh): 0 the bulk-copy ring with the staged factor, 1
    the wide form (no shared memory; Wt through L1) where the product's
    ring and factor do not fit a block's shared memory, as at nl = 2048."""
    if nl % 8:
        raise ValueError(f"{name} kernel: nl={nl} must be a multiple of 8")
    return int(dot and _rebase_smem(rw, nl, itemsize, gather, dot)
               > _MAX_SMEM)


# ---- mirrors of the planners of csrc/kf_common.cuh and kf_block.cuh ----
_SMEM_BUDGET = _MAX_SMEM - 1024     # room for a kernel's static barriers
_ROW_THREADS = 256                  # threads of the row-split pass C P
_BG_RESIDENT_BYTES = 64 * 1024      # P held by one block (kBgResidentBytes)
_CP_RUN = 4                         # particles a piece of K2 at f32 (kCpRun)


def _row_sets(nl: int, itemsize: int) -> int:
    """Sets of partial sums of the row-split pass: one a warp where a unit
    count (16-byte units a row) divides 32, else one a row group."""
    units = nl * itemsize // 16
    if units < 32 and 32 % units == 0:
        return _ROW_THREADS // 32
    return 1 if units >= _ROW_THREADS else _ROW_THREADS // units


def _gather_cp_smem(ny, rw, nl, factor) -> int:
    """Bytes of dynamic shared memory of K2's float32 form (the mirror of
    ``gather_cp_smem``): four stages of whole rows of about 8 KB, two
    buffers of a piece's C [_CP_RUN, ny, nl], one particle's sets of
    partial sums (none where a thread holds whole sums) and its
    -round(C Wt^T) [ny, rw], all float32."""
    rows = min(max(8192 // (nl * 4), 1), nl)
    units, sets = nl // 4, _row_sets(nl, 4)
    if sets == 1 and not (units < 32 and 32 % units == 0):
        sets = 0          # each thread writes whole sums of its own columns
    return (4 * rows * nl * 4 + 4 * ny * nl * (2 * _CP_RUN + sets)
            + (4 * ny * rw if factor else 0))


def _gather_cp_plan(ny, rw, nl, itemsize, factor=True) -> int:
    """K2's form (K8's with ``factor`` False), the mirror of
    ``gather_cp_plan``: at f32 0, one read of P a piece of a run of equal
    base indices (runs cut every ``_CP_RUN`` particles) through a ring of
    bulk-copied row stages, where rows have at most 256 16-byte units and
    the shared memory fits, else 2, the direct form; at bf16 3, one read
    of P a run of equal base indices (one thread a column pair), up to
    nl = 512, else 2."""
    if nl % 8:
        raise ValueError(f"gather_cp kernel: nl={nl} must be a multiple of 8")
    if itemsize == 2 and nl <= 512:
        return 3
    if itemsize == 4 and nl * itemsize // 16 <= _ROW_THREADS \
            and _gather_cp_smem(ny, rw, nl, factor) <= _SMEM_BUDGET:
        return 0
    if 4 * ny * (nl + (rw if factor else 0)) > _SMEM_BUDGET:
        raise ValueError(f"gather_cp kernel: C [{ny}, {nl}] and C Wt^T "
                         f"[{ny}, {rw}] must fit shared memory")
    return 2


def _block_plan(ny: int, nl: int, itemsize: int) -> tuple[int, int, int]:
    """K5's (and K11's) form, the mirror of ``block_gather_plan`` in
    csrc/kf_block.cuh: (form, stage rows, shared memory bytes). Form 1:
    P [nl, nl] resident in the block's shared memory (up to 64 KB; stages
    of about 8 KB); 2: streamed (bf16 beyond 64 KB), P read from memory
    once and again from L2; 0: the two-pass form (f32 beyond 64 KB, or rows
    of more than 256 16-byte units)."""
    if nl % 8:
        raise ValueError(f"block kernel: nl={nl} must be a multiple of 8")
    nbytes = nl * nl * itemsize
    extras = 4 * ny * nl * (4 + _row_sets(nl, itemsize))
    if nl * itemsize // 16 <= _ROW_THREADS:
        if nbytes <= _BG_RESIDENT_BYTES and nbytes + extras <= _SMEM_BUDGET:
            rows = min(max(8192 // (nl * itemsize), 1), nl)
            if -(-nl // rows) > 8:
                rows = -(-nl // 8)
            return 1, rows, nbytes + extras
        if itemsize == 2 and extras <= _SMEM_BUDGET:
            return 2, 0, extras
    groups = max(1, _ROW_THREADS // (nl // 2))
    smem = 4 * ny * nl * (3 + groups)
    if smem > _SMEM_BUDGET:
        raise ValueError(f"block kernel: nl={nl} is too wide for shared "
                         "memory")
    return 0, 0, smem


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return False


def gather_cp(bidx, C, Wt, P_base, rows=None) -> torch.Tensor:
    """Gather-fused effective-CP contraction (K2; replaces
    rbslam_tpu/kernels/kf_update.py:_kernel_gather_cp):
    CP[b] = C[b] (P_base[bidx[b]] - Wt[b]^T Wt[b]), [N, ny, nl] float32.

    bidx [N] int32 in [0, n_base); C [N, ny, nl], Wt [N, rw, nl] and
    P_base [n_base, nl, nl] in one storage dtype (float32 or bfloat16).
    ``rows`` (0 <= rows <= rw; None: rw) reads only the factor rows
    Wt[:, :rows]: where the rows from ``rows`` on are zero (the filter's
    rows of later steps of a rebase period), the result equals the
    all-rows one. Particles with one base index side by side read its
    P_base matrix once: at f32 (``_gather_cp_plan`` form 0) up to four of
    them, at bf16 (form 3) two. Inside ``utils.profiling.recording()`` the
    f32 form counts the P_base matrices it read into the recorded call's
    root span (``Span.k2_p_reads``).
    """
    return _gather_cp(bidx, C, Wt, P_base, rows, direct=False)


def _gather_cp(bidx, C, Wt, P_base, rows, direct: bool) -> torch.Tensor:
    """``gather_cp``; with ``direct`` the kernel runs its direct form
    whatever the plan (to time the two forms on the same inputs)."""
    n, rw, nl = _check_factored(bidx, Wt, P_base)
    rows = rw if rows is None else int(rows)
    if not 0 <= rows <= rw:
        raise ValueError(f"rows={rows} must lie in [0, {rw}]")
    if C.dim() != 3 or C.shape[0] != n or C.shape[2] != nl:
        raise ValueError(f"C must be [{n}, ny, {nl}], got {tuple(C.shape)}")
    ny = C.shape[1]
    if not 1 <= ny <= 3:
        raise ValueError(f"gather_cp supports 1 <= ny <= 3, got {ny}")
    if C.dtype != P_base.dtype or not C.is_contiguous() \
            or C.device != P_base.device:
        raise TypeError("C must be contiguous, on P_base's device and dtype")
    if _on_cpu(P_base):
        return gather_cp_plain(bidx, C, Wt, P_base, rows)
    plan = _gather_cp_plan(ny, rw, nl, P_base.element_size())
    CP = torch.empty((n, ny, nl), dtype=torch.float32, device=C.device)
    if CP.numel() == 0:
        return CP                       # nothing to launch, nothing counted
    C, Wt, P_base = _aligned(C), _aligned(Wt), _aligned(P_base)
    reads = (_lib.k2_reads_counter(C.device)
             if plan == 0 and not direct else 0)
    code = _lib.lib().rbs_gather_cp(
        bidx.data_ptr(), C.data_ptr(), Wt.data_ptr(), P_base.data_ptr(),
        CP.data_ptr(), n, P_base.shape[0], ny, rw, rows, nl, plan,
        int(direct), int(P_base.dtype == torch.bfloat16), reads,
        _lib.stream_ptr(),
    )
    _lib.check(code, "gather_cp")
    return CP


def kf_rebase(bidx, Wt, P_base) -> torch.Tensor:
    """P' [N, nl, nl] = P_base[bidx] - Wt^T Wt in the storage dtype (K3;
    replaces rbslam_tpu/kernels/kf_update.py:_kernel_rebase). Always a
    new tensor: several particles may read one ancestor row of P_base.
    nl must be a multiple of 8. The kernel moves P by 16-byte bulk copies
    through a ring in shared memory beside the staged Wt [rw, nl]; where
    those do not fit a block (``_rebase_variant``: nl = 2048) its wide
    form runs instead, with Wt read through L1."""
    n, rw, nl = _check_factored(bidx, Wt, P_base)
    if _on_cpu(P_base):
        return rebase_plain(bidx, Wt, P_base)
    variant = _rebase_variant("kf_rebase", rw, nl, P_base.element_size())
    out = torch.empty((n, nl, nl), dtype=P_base.dtype, device=P_base.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    Wt, P_base = _aligned(Wt), _aligned(P_base)
    code = _lib.lib().rbs_rebase(
        bidx.data_ptr(), Wt.data_ptr(), P_base.data_ptr(), out.data_ptr(),
        n, P_base.shape[0], rw, nl, variant,
        int(P_base.dtype == torch.bfloat16), _lib.stream_ptr(),
    )
    _lib.check(code, "rebase")
    return out


def kf_update_lowrank(bidx, C, xl_gathered, Wt_gathered, P_base, y, R,
                      jitter: float = 1e-3, live_rows=None):
    """Factored dense KF update with covariance P = P_base[bidx] - Wt^T Wt.

    C [N, ny, nl] rows-layout Jacobians in the storage dtype; xl_gathered
    [N, nl] float32; Wt_gathered [N, rw, nl] the accumulated (already
    resampled) factor rows. ``live_rows`` (None: all rw) says that only
    Wt_gathered[:, :live_rows] may be nonzero (the filter passes ny times
    the steps since the last rebase), so the rest is never read. Returns
    (xl', Wnew [N, ny, nl] storage dtype, logw [N], retried [N]) where
    Wnew = L^-1 C P are the step's whitened factor rows (Wnew^T Wnew is
    exactly the covariance downdate).
    """
    ny = C.shape[1]
    if ny > 3:
        raise ValueError("lowrank KF update supports ny <= 3")
    f32 = torch.float32
    CP = gather_cp(bidx, C, Wt_gathered, P_base, live_rows)   # [N, ny, nl]
    Cf = C.to(f32)
    S = torch.einsum("pij,pkj->pik", CP, Cf) + R.to(f32)[None]
    L, bad = _chol_small_batched(S, jitter)
    e = y[None, :].to(f32) - torch.einsum("pij,pj->pi", Cf, xl_gathered)
    z = _tri_solve_small_batched(L, e)
    logw = (
        -0.5 * torch.sum(z * z, dim=-1)
        - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        - 0.5 * ny * _LOG2PI
    )
    Li = _Li_from_chol_small_batched(L)
    # one stacked gain product: the state-gain row z'L^-1 on top of L^-1,
    # so xl' and the new factor rows come from a single pass over CP
    zLi = torch.einsum("pi,pij->pj", z, Li)
    G = torch.cat([zLi[:, None, :], Li], dim=1)            # [N, 1+ny, ny]
    out = torch.bmm(G, CP)
    xl_new = xl_gathered.to(f32) + out[:, 0]
    Wnew = out[:, 1:].to(Wt_gathered.dtype)
    return xl_new, Wnew, logw, bad


def spd_inv_logdet_plain(S, jitter: float):
    """Inverse and log-determinant of tiny SPD matrices S [N, ny, ny],
    ny <= 3, by the closed-form Cholesky with the block kernel's repair
    (the math of rbslam_tpu/kernels/kf_update.py:_spd_inv_logdet).

    scale = max(1, tr(S)/ny) (max(1, S) at ny = 1); a particle is ``bad``
    where any pivot is <= 1e-30 scale. Only there, S is shifted by
    jitter * scale plus the Gershgorin excess max_i(sum_{k != i} |S_ik| -
    S_ii) (when positive), which makes S + jI diagonally dominant; the
    shifted pivots are clamped to the floor, so every output is finite.
    This is not the repair of ops.kalman._chol_small_batched (jitter
    times the mean diagonal). Returns (S^-1 [N, ny, ny], logdet [N],
    bad [N] bool, L^-1 [N, ny, ny] lower triangular).
    """
    ny = S.shape[-1]
    if not 1 <= ny <= 3:
        raise ValueError(f"spd_inv_logdet supports 1 <= ny <= 3, got {ny}")
    S = S.to(torch.float32)
    zero = torch.zeros_like(S[:, 0, 0])
    if ny == 1:
        s = S[:, 0, 0]
        scale = torch.clamp(s, min=1.0)
        bad = s <= 1e-30 * scale
        j = torch.where(bad, jitter * scale + torch.clamp(-s, min=0.0), zero)
        ssh = torch.maximum(s + j, 1e-30 * scale)
        return ((1.0 / ssh)[:, None, None], torch.log(ssh), bad,
                torch.rsqrt(ssh)[:, None, None])

    s11, s21, s22 = S[:, 0, 0], S[:, 1, 0], S[:, 1, 1]
    s31, s32, s33 = (S[:, 2, 0], S[:, 2, 1], S[:, 2, 2]) if ny == 3 \
        else (None, None, None)
    tr = s11 + s22 + (s33 if ny == 3 else 0.0)
    scale = torch.clamp(tr / ny, min=1.0)
    floor = 1e-30 * scale

    def chol(a11, a22, a33):
        """Pivots and entries of the ny <= 3 recursion (as in the kernel,
        sqrt of a pivot clamped at 1e-30 for the next entries)."""
        l11 = torch.sqrt(torch.clamp(a11, min=1e-30))
        l21 = s21 / l11
        p2 = a22 - l21 * l21
        if ny == 2:
            return (a11, p2)
        l31 = s31 / l11
        l22 = torch.sqrt(torch.clamp(p2, min=1e-30))
        l32 = (s32 - l31 * l21) / l22
        return (a11, p2, a33 - l31 * l31 - l32 * l32)

    bad = torch.zeros_like(s11, dtype=torch.bool)
    for p in chol(s11, s22, s33):
        bad = bad | (p <= floor)
    if ny == 2:
        g = torch.maximum(s21.abs() - s11, s21.abs() - s22)
    else:
        g = torch.maximum(
            s21.abs() + s31.abs() - s11,
            torch.maximum(s21.abs() + s32.abs() - s22,
                          s31.abs() + s32.abs() - s33),
        )
    j = torch.where(bad, jitter * scale + torch.clamp(g, min=0.0), zero)
    pivs = [torch.maximum(p, floor)
            for p in chol(s11 + j, s22 + j, s33 + j if ny == 3 else None)]
    logdet = sum(torch.log(p) for p in pivs)
    l11 = torch.sqrt(pivs[0])
    l21 = s21 / l11
    l22 = torch.sqrt(pivs[1])
    m11, m22 = 1.0 / l11, 1.0 / l22
    m21 = -l21 * m11 * m22
    if ny == 2:
        Linv = torch.stack([torch.stack([m11, zero], -1),
                            torch.stack([m21, m22], -1)], -2)
    else:
        l31 = s31 / l11
        l32 = (s32 - l31 * l21) / l22
        l33 = torch.sqrt(pivs[2])
        m33 = 1.0 / l33
        m32 = -l32 * m22 * m33
        m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
        Linv = torch.stack([torch.stack([m11, zero, zero], -1),
                            torch.stack([m21, m22, zero], -1),
                            torch.stack([m31, m32, m33], -1)], -2)
    Sinv = torch.einsum("pki,pkj->pij", Linv, Linv)
    return Sinv, logdet, bad, Linv


def block_gather_plain(ai, C, e, xl_gathered, P_all, R, jitter: float):
    """Plain version of K5: the dense KF update of every particle on its
    ancestor's covariance P_all[ai], with the reference's rounding points
    (kf_update.py:_block_update_math):

        CP  = round_P(C) P[ai]            accumulated in float32
        S   = CP C^T + R                  C in float32
        logw = -1/2 e^T S^-1 e - 1/2 log|S| - ny/2 log 2 pi
        K3  = S^-1 CP;  xl' = xl + e^T K3
        P'  = P[ai] - round_P(round_P(CP)^T round_P(K3))   storage dtype

    C [N, ny, nl] and e [N, ny] float32; P_all [n_all, nl, nl] float32 or
    bfloat16. Returns (xl' [N, nl] f32, P' [N, nl, nl], logw [N], bad [N]).
    """
    f32 = torch.float32
    P = P_all[ai.long()]
    CP = torch.einsum("pij,pjk->pik", C.to(P.dtype).to(f32), P.to(f32))
    S = torch.einsum("pik,pjk->pij", CP, C.to(f32)) + R.to(f32)[None]
    Sinv, logdet, bad, _ = spd_inv_logdet_plain(S, jitter)
    quad = torch.einsum("pi,pij,pj->p", e, Sinv, e)
    ny = C.shape[1]
    logw = -0.5 * quad - 0.5 * logdet - 0.5 * ny * _LOG2PI
    K3 = torch.einsum("pij,pjk->pik", Sinv, CP)
    xl_new = xl_gathered.to(f32) + torch.einsum("pi,pik->pk", e, K3)
    dd = torch.einsum("pir,pic->prc", CP.to(P.dtype).to(f32),
                      K3.to(P.dtype).to(f32))
    return xl_new, P - dd.to(P.dtype), logw, bad


def kf_update_block_gather(ai, C, xl_gathered, P_all, y, R,
                           jitter: float = 1e-3):
    """Gathered dense KF update (K5; replaces rbslam_tpu/kernels/
    kf_update.py:_kernel_block_gather): one read of each particle's
    ancestor covariance and one write of P'.

    ai [N] int32 ancestor indices into P_all [n_all, nl, nl] (the
    covariances BEFORE resampling, float32 or bfloat16); C [N, ny, nl]
    Jacobians at the propagated particles, ny <= 3, nl a multiple of 128
    (pad upstream); xl_gathered [N, nl] the resampled maps; y [ny];
    R [ny, ny]. Returns (xl' [N, nl] f32, P' [N, nl, nl] in P_all's dtype,
    logw [N], retried [N] bool): the contract of
    ops.kalman.kalman_update_dense_batched with symmetrize_out=False, up
    to the repair and the rounding points. P' is always a new tensor. The
    kernel holds P in the block's shared memory and reads it once where
    P fits (nl=128), else streams it twice, the second time from L2 at bf16
    (``_block_plan``).
    """
    if C.dim() != 3:
        raise ValueError(f"C must be [N, ny, nl], got {tuple(C.shape)}")
    n, ny, nl = C.shape
    if not 1 <= ny <= 3:
        raise ValueError(
            f"the block KF update supports 1 <= ny <= 3, got {ny}")
    if nl % 128:
        raise ValueError(f"nl={nl} must be a multiple of 128 (pad upstream)")
    if ai.dtype != torch.int32 or tuple(ai.shape) != (n,):
        raise TypeError(f"ai must be an int32 tensor of shape ({n},)")
    if P_all.dtype not in _STORAGE or P_all.dim() != 3 \
            or tuple(P_all.shape[1:]) != (nl, nl):
        raise TypeError(f"P_all must be float32 or bfloat16 [n_all, {nl}, "
                        f"{nl}], got {P_all.dtype} {tuple(P_all.shape)}")
    if tuple(xl_gathered.shape) != (n, nl) or tuple(y.shape) != (ny,) \
            or tuple(R.shape) != (ny, ny):
        raise ValueError(f"xl_gathered must be [{n}, {nl}], y [{ny}] and R "
                         f"[{ny}, {ny}]")
    devices = {x.device for x in (ai, C, xl_gathered, P_all, y, R)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    f32 = torch.float32
    Cf = C.to(f32)
    xl = xl_gathered.to(f32)
    e = y[None, :].to(f32) - torch.einsum("pij,pj->pi", Cf, xl)
    Rf = R.to(f32)
    if _on_cpu(P_all):
        return block_gather_plain(ai, Cf, e, xl, P_all, Rf, jitter)
    if not P_all.is_contiguous():
        raise ValueError("P_all must be contiguous")
    plan = _block_plan(ny, nl, P_all.element_size())[0]
    P_all = _aligned(P_all)
    Cf, e, xl, Rf = (x.contiguous() for x in (Cf, e, xl, Rf))
    P_new = torch.empty((n, nl, nl), dtype=P_all.dtype, device=P_all.device)
    xl_new = torch.empty((n, nl), dtype=f32, device=P_all.device)
    logw = torch.empty((n,), dtype=f32, device=P_all.device)
    bad = torch.empty((n,), dtype=torch.bool, device=P_all.device)
    if n == 0:
        return xl_new, P_new, logw, bad   # nothing to launch, nothing counted
    code = _lib.lib().rbs_block_gather(
        ai.data_ptr(), Cf.data_ptr(), e.data_ptr(), xl.data_ptr(),
        P_all.data_ptr(), Rf.data_ptr(), P_new.data_ptr(), xl_new.data_ptr(),
        logw.data_ptr(), bad.data_ptr(), n, P_all.shape[0], ny, nl,
        float(jitter), plan, int(P_all.dtype == torch.bfloat16),
        _lib.stream_ptr(),
    )
    _lib.check(code, "block_gather")
    return xl_new, P_new, logw, bad
