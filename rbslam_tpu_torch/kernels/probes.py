"""Kernel-part probes K8-K11: the pieces of the Kalman update kernels K2,
K3 and K5 as kernels of their own (the gather alone, the gather with C P,
the rebase split into gather / product / write, the per-particle products
without the gather), with their plain PyTorch versions. Port of the
profiling kernels of scripts/profile_gather_cp.py,
profile_rebase_parts.py, profile_gather_kernel.py and
profile_block_mxu.py; ``workloads/profile_kernel_parts.py`` times them
beside K2, K3 and K5.

Each wrapper takes the plain version for tensors on the CPU, launches its
kernel (``csrc/probes.cu``) for CUDA tensors, and raises for any other
device. An index outside [0, n_base) writes NaN into that particle's
output. The kernels move P by 16-byte bulk copies: a view that does not
start on a 16-byte boundary is copied into a fresh tensor first.
"""

from __future__ import annotations

import torch

from . import _lib
from .kf_update import (
    _STORAGE,
    _aligned,
    _block_plan,
    _gather_cp_plan,
    _on_cpu,
    _rebase_variant,
)


def probe_gather_cp_plain(bidx, C, P) -> torch.Tensor:
    """Plain version of K8: round_P(C[b]) P[bidx[b]] accumulated in float32
    (the rounding point of scripts/profile_gather_cp.py:42-44)."""
    f32 = torch.float32
    return torch.einsum("pij,pjk->pik", C.to(P.dtype).to(f32),
                        P[bidx.long()].to(f32))


def probe_rebase_parts_plain(bidx, Wt, P, do_gather: bool = True,
                             do_dot: bool = True) -> torch.Tensor:
    """Plain version of K9: P_src - round_P(Wt^T Wt) in P's dtype, with
    P_src = P[bidx] if ``do_gather`` else 0, the product only if
    ``do_dot``."""
    n, _, nl = Wt.shape
    src = P[bidx.long()] if do_gather \
        else torch.zeros((n, nl, nl), dtype=P.dtype, device=P.device)
    if not do_dot:
        return src
    Wf = Wt.to(torch.float32)
    dd = torch.einsum("pri,prj->pij", Wf, Wf)
    return src - dd.to(P.dtype)


def probe_gather_plain(ai, P) -> torch.Tensor:
    """Plain version of K10: P[ai]."""
    return P[ai.long()]


def probe_block_products_plain(C, P) -> torch.Tensor:
    """Plain version of K11: CP = C P in float32 (C not rounded), then
    round_P(P - CP^T (0.7 CP)), rounded once
    (scripts/profile_block_mxu.py:_products_batched, :78-81)."""
    f32 = torch.float32
    Pf = P.to(f32)
    CP = torch.einsum("pij,pjk->pik", C.to(f32), Pf)
    dd = torch.einsum("pir,pic->prc", CP, 0.7 * CP)
    return (Pf - dd).to(P.dtype)


def _check_index(name, idx, n) -> None:
    if idx.dtype != torch.int32 or tuple(idx.shape) != (n,):
        raise TypeError(f"{name} must be an int32 tensor of shape ({n},)")


def _check_P(P, nl=None) -> int:
    if P.dtype not in _STORAGE or P.dim() != 3 or P.shape[1] != P.shape[2] \
            or (nl is not None and P.shape[1] != nl):
        want = "nl" if nl is None else nl
        raise TypeError(f"P must be float32 or bfloat16 [n, {want}, {want}], "
                        f"got {P.dtype} {tuple(P.shape)}")
    return P.shape[1]


def _check_inputs(*named) -> None:
    """One device, all contiguous: ``named`` is (name, tensor) pairs."""
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_nl(name, nl) -> None:
    if nl % 8:
        raise ValueError(f"{name} kernel: nl={nl} must be a multiple of 8")


def probe_gather_cp(bidx, C, P) -> torch.Tensor:
    """Gathered C P without the factor term (K8; replaces
    scripts/profile_gather_cp.py:_kernel_gcp): CP[b] = round_P(C[b])
    P[bidx[b]], [N, ny, nl] float32; P is read once and never written.

    bidx [N] int32 in [0, n_base); C [N, ny, nl] float32, 1 <= ny <= 3;
    P [n_base, nl, nl] float32 or bfloat16. K2 (``gather_cp``) with Wt = 0:
    the kernel is K2's device code with the factor term compiled out.
    """
    if C.dim() != 3 or C.dtype != torch.float32:
        raise TypeError(f"C must be float32 [N, ny, nl], got {C.dtype} "
                        f"{tuple(C.shape)}")
    n, ny, nl = C.shape
    if not 1 <= ny <= 3:
        raise ValueError(f"probe_gather_cp supports 1 <= ny <= 3, got {ny}")
    _check_index("bidx", bidx, n)
    _check_P(P, nl)
    _check_inputs(("bidx", bidx), ("C", C), ("P", P))
    if _on_cpu(P):
        return probe_gather_cp_plain(bidx, C, P)
    plan = _gather_cp_plan(ny, 0, nl, P.element_size(), factor=False)
    CP = torch.empty((n, ny, nl), dtype=torch.float32, device=P.device)
    if CP.numel() == 0:
        return CP                       # nothing to launch, nothing counted
    C, P = _aligned(C), _aligned(P)
    code = _lib.lib().rbs_probe_gather_cp(
        bidx.data_ptr(), C.data_ptr(), P.data_ptr(), CP.data_ptr(), n,
        P.shape[0], ny, nl, plan, int(P.dtype == torch.bfloat16),
        _lib.stream_ptr(),
    )
    _lib.check(code, "probe_gather_cp")
    return CP


def probe_rebase_parts(bidx, Wt, P, do_gather: bool = True,
                       do_dot: bool = True) -> torch.Tensor:
    """The rebase in parts (K9; replaces
    scripts/profile_rebase_parts.py:make_kernel): out[b] = P_src -
    round_P(Wt[b]^T Wt[b]) in P's dtype, [N, nl, nl].

    ``do_gather`` chooses P_src = P[bidx[b]]; without it P_src = 0 and
    neither P nor bidx is read (the TPU kernel reads uninitialised scratch
    memory there, so its output is unspecified; zero is this port's
    definition). ``do_dot`` chooses the product and the subtraction. The
    four variants: gather + write, dot + write (-round(Wt^T Wt)), both
    (K3, ``kf_rebase``: the same device code) and write only (zeros). Every
    variant writes all N nl nl elements.

    bidx [N] int32; Wt [N, rw, nl] and P [n_base, nl, nl] in one storage
    dtype (float32 or bfloat16).
    """
    nl = _check_P(P)
    if Wt.dim() != 3 or Wt.shape[2] != nl or Wt.dtype != P.dtype:
        raise TypeError(f"Wt must be {P.dtype} [N, rw, {nl}], got {Wt.dtype} "
                        f"{tuple(Wt.shape)}")
    n, rw, _ = Wt.shape
    _check_index("bidx", bidx, n)
    _check_inputs(("bidx", bidx), ("Wt", Wt), ("P", P))
    if _on_cpu(P):
        return probe_rebase_parts_plain(bidx, Wt, P, do_gather, do_dot)
    variant = _rebase_variant("probe_rebase_parts", rw, nl,
                              P.element_size(), do_gather, do_dot)
    out = torch.empty((n, nl, nl), dtype=P.dtype, device=P.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    Wt, P = _aligned(Wt), _aligned(P)
    code = _lib.lib().rbs_probe_rebase_parts(
        bidx.data_ptr(), Wt.data_ptr(), P.data_ptr(), out.data_ptr(), n,
        P.shape[0], rw, nl, int(do_gather), int(do_dot), variant,
        int(P.dtype == torch.bfloat16), _lib.stream_ptr(),
    )
    _lib.check(code, "probe_rebase_parts")
    return out


def probe_gather(ai, P) -> torch.Tensor:
    """The bare gather (K10; replaces
    scripts/profile_gather_kernel.py:_gather_kernel): out[b] = P[ai[b]],
    no arithmetic, bit-equal to ``torch.index_select(P, 0, ai)``.

    ai [N] int32 in [0, n_all); P [n_all, nl, nl] float32 or bfloat16.
    """
    nl = _check_P(P)
    n = ai.shape[0] if ai.dim() == 1 else -1
    _check_index("ai", ai, n)
    _check_inputs(("ai", ai), ("P", P))
    if _on_cpu(P):
        return probe_gather_plain(ai, P)
    _check_nl("probe_gather", nl)
    out = torch.empty((n, nl, nl), dtype=P.dtype, device=P.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    P = _aligned(P)
    code = _lib.lib().rbs_probe_gather(
        ai.data_ptr(), P.data_ptr(), out.data_ptr(), n, P.shape[0], nl,
        int(P.dtype == torch.bfloat16), _lib.stream_ptr(),
    )
    _lib.check(code, "probe_gather")
    return out


def probe_block_products(C, P) -> torch.Tensor:
    """The per-particle products of the block update without its gather
    (K11; replaces scripts/profile_block_mxu.py:_kernel): CP = C[b] P[b] in
    float32, out[b] = round_P(P[b] - CP^T (0.7 CP)), [N, nl, nl] in P's
    dtype, rounded once; 0.7 stands in for the gain algebra of K5. The TPU
    script's three formulations of the products are one function, computed
    once here.

    C [N, ny, nl] float32, 1 <= ny <= 3; P [N, nl, nl] float32 or bfloat16.
    """
    if C.dim() != 3 or C.dtype != torch.float32:
        raise TypeError(f"C must be float32 [N, ny, nl], got {C.dtype} "
                        f"{tuple(C.shape)}")
    n, ny, nl = C.shape
    if not 1 <= ny <= 3:
        raise ValueError(
            f"probe_block_products supports 1 <= ny <= 3, got {ny}")
    _check_P(P, nl)
    if P.shape[0] != n:
        raise ValueError(f"P has {P.shape[0]} particles, C {n}")
    _check_inputs(("C", C), ("P", P))
    if _on_cpu(P):
        return probe_block_products_plain(C, P)
    plan = _block_plan(ny, nl, P.element_size())[0]
    out = torch.empty((n, nl, nl), dtype=P.dtype, device=P.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    P = _aligned(P)
    code = _lib.lib().rbs_probe_block_products(
        C.data_ptr(), P.data_ptr(), out.data_ptr(), n, ny, nl, plan,
        int(P.dtype == torch.bfloat16), _lib.stream_ptr(),
    )
    _lib.check(code, "probe_block_products")
    return out
