"""Fused Laplacian-eigenbasis evaluation: CUDA kernels K1, K4, K6 and K7
with their plain PyTorch versions (port of rbslam_tpu/kernels/basis_eval.py).

Math (tools/domain_cartesian_dx.m:88-93,146-170):
    phi_n(x) = scale * prod_j sin(a_nj),
    d phi_n / d x_i = scale * f_ni cos(a_ni) prod_{j != i} sin(a_nj),
    a_nj = freq_nj * x_j + phase_nj,
    freq_nj = f_nj = pi n_j / (2 L_j), phase_nj = pi n_j / 2,
    scale = prod_j L_j^{-1/2}.
The +L shift of the centered position is folded into the phase.

Each wrapper takes the plain version for a tensor on the CPU, launches
its kernel (``csrc/basis_eval.cu``) for a CUDA tensor, and raises for any
other device. The plain versions are public, for checking the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _lib


class BasisConstants(NamedTuple):
    """Per-basis constants packed once per device: rows [freq; phase; fac]
    of a [3d, m] float32 tensor and the scalar scale; and, for the table
    form of K1, K4 and K7 (``csrc/basis_eval.cu``):

    - ``table`` [3d, max(counts)] float32: each dimension's distinct
      (freq, phase, fac) triplets in the rows' order (zero beyond a
      dimension's count), ``counts[j]`` of them: each column's triplet
      equals exactly one of them bit for bit;
    - ``col_codes`` [round_up(3 + m, 8)] int32 (K1, K7): at output column
      3 + b, the table offsets of column b's values, a byte a dimension
      (a dimension's offset is the counts of the dimensions before it
      plus the index of the column's triplet among its distinct ones);
    - ``grad_codes`` [g d m] int32 (K4): at flat position (q, i, b) of a
      period of g particles (g d m a multiple of 4), the table offset of
      dimension i's value, then those of the other dimensions in order,
      and q in byte 3.
    """

    packed: torch.Tensor
    scale: float
    m: int
    d: int
    table: torch.Tensor
    col_codes: torch.Tensor
    grad_codes: torch.Tensor
    counts: tuple


_CODE_BITS = 8                      # kCodeBits of csrc/basis_eval.cu


def _grad_period(dm: int) -> int:
    """Particles whose flat rows [d, m] fill whole 16-byte stores."""
    return 1 if dm % 4 == 0 else 2 if dm % 2 == 0 else 4


def pack_basis_constants(basis, device) -> BasisConstants:
    """Pack a LaplaceBasis the way the reference kernels do
    (rbslam_tpu/kernels/basis_eval.py:248-255): float64 on the host,
    rounded once to float32. The table of distinct triplets is taken from
    the rounded rows, so it holds the same float32 values."""
    NN = np.asarray(basis.NN, np.float64)
    L = np.asarray(basis.L, np.float64).reshape(-1)
    freq = (np.pi * NN / (2.0 * L)).T
    phase = (np.pi * NN / 2.0).T
    fac = (np.pi * NN / (2.0 * L)).T
    packed = np.concatenate([freq, phase, fac], axis=0).astype(np.float32)
    scale = float(np.float32(np.prod(1.0 / np.sqrt(L))))
    m, d = NN.shape
    distinct, index = [], np.zeros((d, m), np.int64)
    for j in range(d):
        triplets = packed[j::d].T                       # [m, 3]
        values, inverse = np.unique(triplets, axis=0, return_inverse=True)
        distinct.append(values)
        index[j] = inverse.reshape(-1)
    counts = tuple(len(v) for v in distinct)
    table = np.zeros((3 * d, max(counts, default=0)), np.float32)
    for j, values in enumerate(distinct):
        table[j::d, :len(values)] = values.T
    # table offsets (masked to their byte: a basis whose counts pass 256
    # in all runs the direct form, which reads no code)
    offset = (index + np.cumsum((0,) + counts[:-1])[:, None]) \
        & ((1 << _CODE_BITS) - 1)
    col_codes = np.zeros(-(-(3 + m) // 8) * 8, np.uint32)
    for j in range(d):
        col_codes[3:3 + m] |= (offset[j] << (_CODE_BITS * j)).astype(np.uint32)
    g = _grad_period(d * m)
    grad_codes = np.zeros((g, d, m), np.uint32)
    for i in range(d):
        order = [i] + [j for j in range(d) if j != i]
        for f, j in enumerate(order):
            grad_codes[:, i] |= (offset[j] << (_CODE_BITS * f)) \
                .astype(np.uint32)
    q = np.arange(g, dtype=np.uint32) << (3 * _CODE_BITS)
    grad_codes |= q[:, None, None]

    def dev(a):
        return torch.as_tensor(a, device=device).contiguous()

    return BasisConstants(
        packed=dev(packed), scale=scale, m=int(m), d=int(d),
        table=dev(table),
        col_codes=dev(col_codes.view(np.int32)),
        grad_codes=dev(grad_codes.reshape(-1).view(np.int32)),
        counts=counts,
    )


# ---- mirror of basis_plan in csrc/basis_eval.cu ----
_TABLE_ITEMS = 512                  # 16-byte stores a K1 / K7 block aims at
_GRAD_ITEMS = 1024                  # and a K4 block (lighter stores)
_TABLE_BLOCKS = 2 * 132             # blocks a launch aims at (2 an SM)
_TABLE_SMEM = 48 * 1024             # shared memory without an opt-in


def _basis_smem(jac: bool, usum: int, per_block: int) -> int:
    return per_block * (8 * usum + (36 if jac else 0))


def _basis_plan(jac: bool, n: int, d: int, m: int, nl_pad: int,
                itemsize: int, counts) -> tuple[int, int]:
    """(form, particles a block) of K4 (``jac`` False, [N, d, m] float32)
    or of K1 / K7 (``jac`` True, ``itemsize``-byte outputs of nl_pad
    columns): the mirror of ``basis_plan``. Form 1 is the table form: a
    block takes several particles, whose distinct sines and cosines it
    tabulates before it writes 16 bytes a thread; form 0 (per block 0)
    the direct form, one thread a (particle, column), where the distinct
    values of all dimensions pass 256 (a table offset is a byte) or
    the particles make fewer than ``_TABLE_BLOCKS`` blocks (a smoother's
    100: the table's extra phase would only lengthen the launch)."""
    counts = tuple(counts)[:d]
    if not counts or min(counts) < 1 or sum(counts) > 1 << _CODE_BITS:
        return 0, 0
    usum = sum(counts)
    g = 1 if jac else _grad_period(d * m)
    if -(-n // g) < _TABLE_BLOCKS:
        return 0, 0
    per = (_TABLE_ITEMS // -(-nl_pad * itemsize // 16) if jac
           else 4 * _GRAD_ITEMS // (d * m))
    per = g if per < g else per - per % g
    while per > g and -(-n // per) < _TABLE_BLOCKS:
        per -= g
    while per > g and _basis_smem(jac, usum, per) > _TABLE_SMEM:
        per -= g
    if _basis_smem(jac, usum, per) > _TABLE_SMEM:
        return 0, 0
    return 1, per


def _table_args(consts: BasisConstants, codes: torch.Tensor, plan) -> tuple:
    """The table arguments of a C entry: table, codes, three counts, the
    table's row stride, form and particles a block."""
    u = tuple(consts.counts) + (0,) * (3 - consts.d)
    return (consts.table.data_ptr(), codes.data_ptr(), *u,
            consts.table.shape[1], *plan)


def _phases(consts: BasisConstants, x: torch.Tensor):
    """The phase arguments a_j = freq_j x_j + phase_j, each [N, m]."""
    d = consts.d
    pk = consts.packed
    return [x[:, j, None] * pk[j][None, :] + pk[d + j][None, :]
            for j in range(d)]


def _trig(consts: BasisConstants, x: torch.Tensor):
    """sin/cos of the phase arguments, each [N, m], per dimension."""
    a = _phases(consts, x)
    return [torch.sin(aj) for aj in a], [torch.cos(aj) for aj in a]


def _grad_rows(consts: BasisConstants, sins, coss):
    d = consts.d
    out = []
    for i in range(d):
        prod = consts.packed[2 * d + i][None, :] * coss[i]
        for j in range(d):
            if j != i:
                prod = prod * sins[j]
        out.append(consts.scale * prod)
    return out


def grad_basis_plain(consts: BasisConstants, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: grad phi(x), [N, d] -> [N, d, m] float32."""
    sins, coss = _trig(consts, x)
    return torch.stack(_grad_rows(consts, sins, coss), dim=1)


def _table(consts: BasisConstants, x: torch.Tensor) -> torch.Tensor:
    """Phase 1 of the table form: [N, sum(counts), 2] (sin a, fac cos a)
    of each particle's distinct phases, the dimensions one after
    another."""
    d, tb = consts.d, consts.table
    parts = []
    for j, u in enumerate(consts.counts):
        a = x[:, j, None] * tb[j, :u][None, :] + tb[d + j, :u][None, :]
        parts.append(torch.stack(
            [torch.sin(a), tb[2 * d + j, :u][None, :] * torch.cos(a)], -1))
    return torch.cat(parts, dim=1)


def _fields(codes: torch.Tensor, f: int) -> torch.Tensor:
    return (codes >> (_CODE_BITS * f)) & ((1 << _CODE_BITS) - 1)


def _table_grad_plain(consts: BasisConstants, x: torch.Tensor):
    """K4 as its table form computes it, on the CPU: each element reads
    its position code, the particle's table at the code's offsets, and
    multiplies in the direct form's order. Equals grad_basis_plain bit
    for bit (the test of the table form's constants)."""
    n, d, m = x.shape[0], consts.d, consts.m
    tab = _table(consts, x)
    g = _grad_period(d * m)
    codes = consts.grad_codes.long().reshape(g, d, m) & 0xFFFFFFFF
    p = torch.arange(n)
    codes = codes[p % g]                                # [N, d, m]
    owner = (p // g * g)[:, None, None] + (codes >> (3 * _CODE_BITS))
    prod = tab[owner, _fields(codes, 0), 1]
    for f in range(1, d):
        prod = prod * tab[owner, _fields(codes, f), 0]
    return consts.scale * prod


def _table_rows_plain(consts: BasisConstants, pos: torch.Tensor,
                      quat: torch.Tensor, nl_pad: int, dtype) -> torch.Tensor:
    """K1 as its table form computes it, on the CPU: column 3 + b reads
    its column code and the particle's table at the code's offsets.
    Equals mag3d_jacobian_rows_plain bit for bit."""
    tab = _table(consts, pos)
    codes = consts.col_codes[3:3 + consts.m].long() & 0xFFFFFFFF
    s = [tab[:, _fields(codes, j), 0] for j in range(3)]
    fc = [tab[:, _fields(codes, j), 1] for j in range(3)]
    g = []
    for i in range(3):
        prod = fc[i]
        for j in range(3):
            if j != i:
                prod = prod * s[j]
        g.append(consts.scale * prod)
    return _rotated_rows(g, quat, nl_pad, dtype)


def _check_float32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(t: torch.Tensor, consts: BasisConstants) -> bool:
    if consts.packed.device != t.device:
        raise ValueError(
            f"basis constants on {consts.packed.device}, input on {t.device}"
        )
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return False


def _check_dim(consts: BasisConstants) -> None:
    if consts.d not in (1, 2, 3):
        raise ValueError(f"the basis kernels serve d in (1, 2, 3), got "
                         f"d={consts.d}")


def grad_basis(consts: BasisConstants, x: torch.Tensor) -> torch.Tensor:
    """grad phi(x): [N, d] float32 -> [N, d, m] float32, d in {1, 2, 3}
    (K4; replaces rbslam_tpu/kernels/basis_eval.py:_grad_kernel)."""
    _check_dim(consts)
    n = x.shape[0]
    _check_float32("x", x, (n, consts.d))
    if _on_cpu(x, consts):
        return grad_basis_plain(consts, x)
    out = torch.empty((n, consts.d, consts.m), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    plan = _basis_plan(False, n, consts.d, consts.m, 0, 4, consts.counts)
    code = _lib.lib().rbs_grad_basis(
        x.data_ptr(), consts.packed.data_ptr(), consts.scale, out.data_ptr(),
        n, consts.m, consts.d, *_table_args(consts, consts.grad_codes, plan),
        _lib.stream_ptr(),
    )
    _lib.check(code, "grad_basis")
    return out


def phi_basis_plain(consts: BasisConstants, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: phi(x), [N, d] -> [N, m] float32; the product
    starts from the scale and takes the sines left to right."""
    acc = None
    for aj in _phases(consts, x):
        s = torch.sin(aj)
        acc = consts.scale * s if acc is None else acc * s
    return acc


def phi_basis(consts: BasisConstants, x: torch.Tensor) -> torch.Tensor:
    """phi(x): [N, d] float32 -> [N, m] float32, d in {1, 2, 3}
    (K6; replaces rbslam_tpu/kernels/basis_eval.py:_phi_kernel)."""
    _check_dim(consts)
    n = x.shape[0]
    _check_float32("x", x, (n, consts.d))
    if _on_cpu(x, consts):
        return phi_basis_plain(consts, x)
    out = torch.empty((n, consts.m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    code = _lib.lib().rbs_phi_basis(
        x.data_ptr(), consts.packed.data_ptr(), consts.scale, out.data_ptr(),
        n, consts.m, consts.d, _lib.stream_ptr(),
    )
    _lib.check(code, "phi_basis")
    return out


def mag3d_jacobian_rows_plain(consts: BasisConstants, pos: torch.Tensor,
                              quat: torch.Tensor, nl_pad: int,
                              dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1: C [N, 3, nl_pad] = R(q)^T [I3 | grad phi(pos) | 0]
    in ``dtype`` (run_dense3D_magfield.m:265-279)."""
    return _rotated_rows(_grad_rows(consts, *_trig(consts, pos)), quat,
                         nl_pad, dtype)


def _rotated_rows(g, quat: torch.Tensor, nl_pad: int, dtype) -> torch.Tensor:
    """C [N, 3, nl_pad] = R(q)^T [I3 | g | 0] from the gradient rows g
    (3 x [N, m]), summed in the kernels' order, in ``dtype``."""
    from ..math.quaternions import quat_to_rmat

    n, m = g[0].shape
    R = quat_to_rmat(quat)                             # [N, 3, 3]
    C = torch.zeros((n, 3, nl_pad), dtype=torch.float32, device=quat.device)
    C[:, :, :3] = R.transpose(1, 2)
    for k in range(3):
        C[:, k, 3:3 + m] = (R[:, 0, k, None] * g[0] + R[:, 1, k, None] * g[1]
                            + R[:, 2, k, None] * g[2])
    return C.to(dtype)


def _check_jac3d(consts: BasisConstants, pos, quat, nl_pad: int) -> int:
    """Argument checks shared by K1 and K7; returns N."""
    if consts.d != 3:
        raise ValueError("the mag3d Jacobian kernels require a 3-D basis")
    if nl_pad < 3 + consts.m:
        raise ValueError(f"nl_pad={nl_pad} < 3 + m = {3 + consts.m}")
    n = pos.shape[0]
    _check_float32("pos", pos, (n, 3))
    _check_float32("quat", quat, (n, 4))
    if pos.device != quat.device:
        raise ValueError("pos and quat must be on one device")
    return n


def mag3d_jacobian_rows(consts: BasisConstants, pos: torch.Tensor,
                        quat: torch.Tensor, nl_pad: int,
                        dtype=torch.float32, out=None) -> torch.Tensor:
    """Fused mag3d measurement Jacobian in rows layout (K1; replaces
    rbslam_tpu/kernels/basis_eval.py:_jac3d_rows_kernel).

    pos [N, 3] float32 (already centered), quat [N, 4] float32 unit
    quaternions -> C [N, 3, nl_pad] in ``dtype`` (float32 or bfloat16);
    columns beyond 3 + m are zero. ``out``: a contiguous, 16-byte aligned
    tensor of that shape and dtype on the card to write C into (by default
    a new one).
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    n = _check_jac3d(consts, pos, quat, nl_pad)
    if _on_cpu(pos, consts):
        return mag3d_jacobian_rows_plain(consts, pos, quat, nl_pad, dtype)
    if out is None:
        out = torch.empty((n, 3, nl_pad), dtype=dtype, device=pos.device)
    elif (tuple(out.shape) != (n, 3, nl_pad) or out.dtype != dtype
          or out.device != pos.device or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous 16-byte aligned "
                         f"[{n}, 3, {nl_pad}] {dtype} tensor on {pos.device}")
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    plan = _basis_plan(True, n, 3, consts.m, nl_pad, out.element_size(),
                       consts.counts)
    code = _lib.lib().rbs_jac3d_rows(
        pos.data_ptr(), quat.data_ptr(), consts.packed.data_ptr(),
        consts.scale, out.data_ptr(), n, consts.m, nl_pad,
        int(dtype == torch.bfloat16),
        *_table_args(consts, consts.col_codes, plan), _lib.stream_ptr(),
    )
    _lib.check(code, "jac3d_rows")
    return out


def mag3d_jacobian_plain(consts: BasisConstants, pos: torch.Tensor,
                         quat: torch.Tensor, nl_pad: int) -> torch.Tensor:
    """Plain version of K7: K1's float32 C with the component axis
    leading, Ct [3, N, nl_pad]."""
    return mag3d_jacobian_rows_plain(consts, pos, quat, nl_pad) \
        .transpose(0, 1).contiguous()


def mag3d_jacobian(consts: BasisConstants, pos: torch.Tensor,
                   quat: torch.Tensor, nl_pad: int) -> torch.Tensor:
    """Fused mag3d measurement Jacobian, transposed layout (K7; replaces
    rbslam_tpu/kernels/basis_eval.py:_jac3d_kernel).

    pos [N, 3] float32 (already centered), quat [N, 4] float32 unit
    quaternions -> Ct [3, N, nl_pad] float32 with
    Ct[k, p, :] = (R(q_p)^T [I3 | grad phi(pos_p)])_k; columns beyond
    3 + m are zero. Any nl_pad >= 3 + m is served.
    """
    n = _check_jac3d(consts, pos, quat, nl_pad)
    if _on_cpu(pos, consts):
        return mag3d_jacobian_plain(consts, pos, quat, nl_pad)
    out = torch.empty((3, n, nl_pad), dtype=torch.float32, device=pos.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    plan = _basis_plan(True, n, 3, consts.m, nl_pad, 4, consts.counts)
    code = _lib.lib().rbs_jac3d(
        pos.data_ptr(), quat.data_ptr(), consts.packed.data_ptr(),
        consts.scale, out.data_ptr(), n, consts.m, nl_pad,
        *_table_args(consts, consts.col_codes, plan), _lib.stream_ptr(),
    )
    _lib.check(code, "jac3d")
    return out
