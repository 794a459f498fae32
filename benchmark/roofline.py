"""The yardstick of the port's kernels: the published H100 peaks, the least
time a launch can take, and each kernel's least bytes and operations from
its shapes.

A launch's least time is the larger of its bytes over the memory's peak
and its operations over the peak rate of its dtype (NVIDIA's H100 SXM data
sheet, dense rates: 3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the
tensor cores, 989 TFLOP/s bfloat16). Bytes count each input read once, a
gathered matrix once per distinct index the launch reads, and each output
written once; operations count the multiply-adds the result needs, as two.
These are the work the inputs need whatever implements it, so a share of
this bound cannot pass 1.
"""

from __future__ import annotations

import functools
import re
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 2: 989e12}       # by storage itemsize: f32, bf16

# the port's kernels by family, as csrc/ names their __global__ functions
KERNEL_FAMILIES = {
    "K1": ("jac_table_kernel", "jac3d_kernel"),
    "K2": ("gather_cp_kernel", "gather_cp_runs_kernel",
           "gather_cp_direct_kernel"),
    "K3": ("rebase_kernel", "rebase_wide_kernel"),
    "K4": ("grad_table_kernel", "grad_basis_kernel"),
    "K5": ("block_slab_kernel", "block_two_pass_kernel"),
    "K6": ("phi_basis_kernel",),
    "K10": ("gather_kernel",),
}
_PATTERNS = [(fam, re.compile(rf"(?:^|[^A-Za-z0-9_]){name}(?:[<(]|$)"))
             for fam, names in KERNEL_FAMILIES.items() for name in names]


@functools.lru_cache(maxsize=None)
def family(kernel_name: str):
    """The family of a device event's name, or None for a kernel that is not
    the port's own."""
    for fam, pat in _PATTERNS:
        if pat.search(kernel_name):
            return fam
    return None


class Launch(NamedTuple):
    nbytes: float
    flops: float
    itemsize: int      # storage itemsize that sets the peak rate

    def least_s(self) -> float:
        return bound_ms(self.nbytes, self.flops, self.itemsize)[0] * 1e-3


def bound_ms(nbytes: float, flops: float, itemsize: int) -> tuple[float, str]:
    """Least milliseconds of a launch and what bounds it ("bytes" or
    "ops"): a copy of the port's workloads/profile_kernel_parts.py::bound_ms,
    keyed by itemsize."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")


def distinct_bases(ancestors: torch.Tensor, period: int) -> list[int]:
    """Distinct base indices of each step of a lowrank filter run, from its
    ancestors [T-1, N]: within a rebase period the base index of a particle
    is bidx = bidx[ai] from the identity at the period's start. Entry t is
    the count after step t's resampling (what K2 reads at step t)."""
    n_steps, n = ancestors.shape
    out = []
    for t in range(n_steps):
        if t % period == 0:
            bidx = torch.arange(n, device=ancestors.device)
        bidx = bidx[ancestors[t].long()]
        out.append(int(torch.unique(bidx).numel()))
    return out


def k1_jacobian_rows(n: int, nl: int, itemsize: int, ny: int = 3) -> Launch:
    """K1: rows-layout Jacobian C [n, ny, nl] of n poses (position and
    quaternion, float32) written in the storage dtype."""
    return Launch(n * 7 * 4 + n * ny * nl * itemsize,
                  2 * n * ny * nl, itemsize)


def k2_gather_cp(n: int, distinct: int, nl: int, rows: int, itemsize: int,
                 ny: int = 3) -> Launch:
    """K2: CP[b] = C[b] (P_base[bidx[b]] - Wt[b]' Wt[b]) over ``rows`` live
    factor rows: P_base read once per distinct base, C, the live rows of
    Wt and bidx read once, CP [n, ny, nl] float32 written once; C P and
    the factor correction (C Wt', then its product with Wt) as
    multiply-adds."""
    nbytes = (distinct * nl * nl * itemsize + n * ny * nl * itemsize
              + n * rows * nl * itemsize + n * 4 + n * ny * nl * 4)
    flops = 2 * n * ny * nl * nl + 4 * n * ny * rows * nl
    return Launch(nbytes, flops, itemsize)


def k3_rebase(n: int, distinct: int, nl: int, rw: int,
              itemsize: int) -> Launch:
    """K3: P'[b] = P_base[bidx[b]] - Wt[b]' Wt[b]: P_base read once per
    distinct base, Wt and bidx once, P' [n, nl, nl] written once; the
    symmetric product's nl (nl + 1) / 2 entries as multiply-adds."""
    nbytes = (distinct * nl * nl * itemsize + n * rw * nl * itemsize
              + n * 4 + n * nl * nl * itemsize)
    flops = 2 * n * rw * nl * (nl + 1) // 2
    return Launch(nbytes, flops, itemsize)


def k4_grad_basis(n: int, m: int, d: int = 3) -> Launch:
    """K4: basis gradients [n, d, m] float32 at n positions [n, d]; each
    output is a product of d factors and a scale (d multiplies)."""
    return Launch(n * d * 4 + n * d * m * 4, n * d * m * d, 4)
