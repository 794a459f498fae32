"""Low-rank factored Kalman update: CUDA kernels K2 and K3 with their plain
PyTorch versions, and the small-ny algebra around K2 (port of
rbslam_tpu/kernels/kf_update.py:447-746).

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


def gather_cp_plain(bidx, C, Wt, P_base) -> torch.Tensor:
    """Plain version of K2: C[b] P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]
    in float32, with C rounded to P's dtype and C Wt^T to Wt's dtype
    (the reference's rounding points, kf_update.py:529,538)."""
    f32 = torch.float32
    P = P_base[bidx.long()]
    CPb = torch.einsum("pij,pjk->pik", C.to(P.dtype).to(f32), P.to(f32))
    Wf = Wt.to(f32)
    CWt = torch.einsum("pij,prj->pir", C.to(Wt.dtype).to(f32), Wf)
    corr = torch.einsum("pir,prk->pik", CWt.to(Wt.dtype).to(f32), Wf)
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


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return False


def gather_cp(bidx, C, Wt, P_base) -> torch.Tensor:
    """Gather-fused effective-CP contraction (K2; replaces
    rbslam_tpu/kernels/kf_update.py:_kernel_gather_cp):
    CP[b] = C[b] (P_base[bidx[b]] - Wt[b]^T Wt[b]), [N, ny, nl] float32.

    bidx [N] int32 in [0, n_base); C [N, ny, nl], Wt [N, rw, nl] and
    P_base [n_base, nl, nl] in one storage dtype (float32 or bfloat16).
    """
    n, rw, nl = _check_factored(bidx, Wt, P_base)
    if C.dim() != 3 or C.shape[0] != n or C.shape[2] != nl:
        raise ValueError(f"C must be [{n}, ny, {nl}], got {tuple(C.shape)}")
    ny = C.shape[1]
    if not 1 <= ny <= 3:
        raise ValueError(f"gather_cp supports 1 <= ny <= 3, got {ny}")
    if C.dtype != P_base.dtype or not C.is_contiguous() \
            or C.device != P_base.device:
        raise TypeError("C must be contiguous, on P_base's device and dtype")
    if _on_cpu(P_base):
        return gather_cp_plain(bidx, C, Wt, P_base)
    if nl % 8 or 4 * ny * (nl + rw) > _MAX_SMEM:
        raise ValueError(f"gather_cp kernel: nl={nl} must be a multiple of "
                         f"8 and nl={nl}, rw={rw} fit shared memory")
    CP = torch.empty((n, ny, nl), dtype=torch.float32, device=C.device)
    if CP.numel() == 0:
        return CP                       # nothing to launch, nothing counted
    code = _lib.lib().rbs_gather_cp(
        bidx.data_ptr(), C.data_ptr(), Wt.data_ptr(), P_base.data_ptr(),
        CP.data_ptr(), n, P_base.shape[0], ny, rw, nl,
        int(P_base.dtype == torch.bfloat16), _lib.stream_ptr(),
    )
    _lib.check(code, "gather_cp")
    return CP


def kf_rebase(bidx, Wt, P_base) -> torch.Tensor:
    """P' [N, nl, nl] = P_base[bidx] - Wt^T Wt in the storage dtype (K3;
    replaces rbslam_tpu/kernels/kf_update.py:_kernel_rebase). Always a
    new tensor: several particles may read one ancestor row of P_base."""
    n, rw, nl = _check_factored(bidx, Wt, P_base)
    if _on_cpu(P_base):
        return rebase_plain(bidx, Wt, P_base)
    if nl % 8 or 4 * rw * nl > _MAX_SMEM:
        raise ValueError(f"kf_rebase kernel: nl={nl} must be a multiple of "
                         f"8 and Wt [{rw}, {nl}] fit shared memory")
    out = torch.empty((n, nl, nl), dtype=P_base.dtype, device=P_base.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    code = _lib.lib().rbs_rebase(
        bidx.data_ptr(), Wt.data_ptr(), P_base.data_ptr(), out.data_ptr(),
        n, P_base.shape[0], rw, nl, int(P_base.dtype == torch.bfloat16),
        _lib.stream_ptr(),
    )
    _lib.check(code, "rebase")
    return out


def kf_update_lowrank(bidx, C, xl_gathered, Wt_gathered, P_base, y, R,
                      jitter: float = 1e-3):
    """Factored dense KF update with covariance P = P_base[bidx] - Wt^T Wt.

    C [N, ny, nl] rows-layout Jacobians in the storage dtype; xl_gathered
    [N, nl] float32; Wt_gathered [N, rw, nl] the accumulated (already
    resampled) factor rows. Returns (xl', Wnew [N, ny, nl] storage dtype,
    logw [N], retried [N]) where Wnew = L^-1 C P are the step's whitened
    factor rows (Wnew^T Wnew is exactly the covariance downdate).
    """
    ny = C.shape[1]
    if ny > 3:
        raise ValueError("lowrank KF update supports ny <= 3")
    f32 = torch.float32
    CP = gather_cp(bidx, C, Wt_gathered, P_base)        # [N, ny, nl]
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
