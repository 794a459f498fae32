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
    of a [3d, m] float32 tensor, and the scalar scale."""

    packed: torch.Tensor
    scale: float
    m: int
    d: int


def pack_basis_constants(basis, device) -> BasisConstants:
    """Pack a LaplaceBasis the way the reference kernels do
    (rbslam_tpu/kernels/basis_eval.py:248-255): float64 on the host,
    rounded once to float32."""
    NN = np.asarray(basis.NN, np.float64)
    L = np.asarray(basis.L, np.float64).reshape(-1)
    freq = (np.pi * NN / (2.0 * L)).T
    phase = (np.pi * NN / 2.0).T
    fac = (np.pi * NN / (2.0 * L)).T
    packed = np.concatenate([freq, phase, fac], axis=0).astype(np.float32)
    scale = float(np.float32(np.prod(1.0 / np.sqrt(L))))
    return BasisConstants(
        packed=torch.as_tensor(packed, device=device).contiguous(),
        scale=scale, m=int(NN.shape[0]), d=int(NN.shape[1]),
    )


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
    code = _lib.lib().rbs_grad_basis(
        x.data_ptr(), consts.packed.data_ptr(), consts.scale, out.data_ptr(),
        n, consts.m, consts.d, _lib.stream_ptr(),
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
    from ..math.quaternions import quat_to_rmat

    n, m = pos.shape[0], consts.m
    sins, coss = _trig(consts, pos)
    g = _grad_rows(consts, sins, coss)                 # 3 x [N, m]
    R = quat_to_rmat(quat)                             # [N, 3, 3]
    C = torch.zeros((n, 3, nl_pad), dtype=torch.float32, device=pos.device)
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
                        dtype=torch.float32) -> torch.Tensor:
    """Fused mag3d measurement Jacobian in rows layout (K1; replaces
    rbslam_tpu/kernels/basis_eval.py:_jac3d_rows_kernel).

    pos [N, 3] float32 (already centered), quat [N, 4] float32 unit
    quaternions -> C [N, 3, nl_pad] in ``dtype`` (float32 or bfloat16);
    columns beyond 3 + m are zero.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    n = _check_jac3d(consts, pos, quat, nl_pad)
    if _on_cpu(pos, consts):
        return mag3d_jacobian_rows_plain(consts, pos, quat, nl_pad, dtype)
    out = torch.empty((n, 3, nl_pad), dtype=dtype, device=pos.device)
    if out.numel() == 0:
        return out                      # nothing to launch, nothing counted
    code = _lib.lib().rbs_jac3d_rows(
        pos.data_ptr(), quat.data_ptr(), consts.packed.data_ptr(),
        consts.scale, out.data_ptr(), n, consts.m, nl_pad,
        int(dtype == torch.bfloat16), _lib.stream_ptr(),
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
    code = _lib.lib().rbs_jac3d(
        pos.data_ptr(), quat.data_ptr(), consts.packed.data_ptr(),
        consts.scale, out.data_ptr(), n, consts.m, nl_pad,
        _lib.stream_ptr(),
    )
    _lib.check(code, "jac3d")
    return out
