"""The exact GP predictive of the localization weight: CUDA kernel K12
(``csrc/predictive.cu``) with its plain PyTorch version. It replaces no
TPU kernel: the JAX package leaves this predictive to XLA's triangular
solve (rbslam_tpu/models/terrain.py).

Math. A field row at a particle is c = [e_a | g_a] (axis a, g_a [m] the
basis gradients of K4), n_lin = m + 3 columns. With L the lower Cholesky
factor of the map's posterior precision and w its mean weights,
    mean = c' w,    var = sigma2 c' (L L')^-1 c = sigma2 || L^-1 c ||^2.
:func:`pack_predictive` forms M = L^-1 once, in float64, and rounds it to
float32 (the correctly rounded inverse of the stored L): the variance is
then a product with M, where the triangular solve was sequential in the
depth. The kernel reads g straight from K4's output; C, M C' and its
square are never written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib

_TILE_COLS = 128            # kTileCols of csrc/predictive.cu
_DEPTH = 32                 # kDepth: the table's depth rows pad m to it


class PredictiveConstants(NamedTuple):
    """The packed posterior of :func:`pack_predictive`: ``table``
    [3 + round_up(m, 32), round_up(n_lin + 1, 128)] float32 with
    table[k, i] = (L^-1)[i, k] for i < n_lin and table[k, n_lin] = w[k],
    zero elsewhere; ``sigma2`` the noise variance; ``m`` the basis
    functions (n_lin = m + 3)."""

    table: torch.Tensor
    sigma2: float
    m: int


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def pack_predictive(posterior_chol, posterior_mean_weights,
                    sigma2: float) -> PredictiveConstants:
    """Pack the lower Cholesky factor L [n_lin, n_lin] and the mean weights
    w [n_lin] for :func:`gp_predictive`, on the device of w. L is inverted
    once, in float64 on the host (a triangular solve against the identity,
    at set-up), so that the card and the CPU hold the same table; its
    transpose and w are rounded once to float32."""
    w = torch.as_tensor(posterior_mean_weights)
    L = torch.as_tensor(posterior_chol).to(device="cpu", dtype=torch.float64)
    n_lin = L.shape[0]
    if L.shape != (n_lin, n_lin) or w.shape != (n_lin,) or n_lin < 4:
        raise ValueError(f"posterior_chol {tuple(L.shape)} and mean weights "
                         f"{tuple(w.shape)} must be [n_lin, n_lin] and "
                         f"[n_lin], n_lin = m + 3 > 3")
    inv = torch.linalg.solve_triangular(
        L, torch.eye(n_lin, dtype=torch.float64), upper=False)
    m = n_lin - 3
    table = torch.zeros((3 + _round_up(m, _DEPTH),
                         _round_up(n_lin + 1, _TILE_COLS)),
                        dtype=torch.float32)
    table[:n_lin, :n_lin] = inv.T.to(torch.float32)
    table[:n_lin, n_lin] = w.to(device="cpu", dtype=torch.float32)
    return PredictiveConstants(table=table.to(w.device), sigma2=float(sigma2),
                               m=m)


def gp_predictive_plain(consts: PredictiveConstants, g: torch.Tensor):
    """Mean and variance [..., 3] of the field rows [e_a | g[..., a, :]]
    of g [..., 3, m]: M c (and c w, the table's column n_lin) as one
    product with the table, its identity columns added as the table's
    row a, then the field columns squared and summed."""
    m = consts.m
    flat = g.reshape(-1, m)
    axis = torch.arange(flat.shape[0], device=g.device) % 3
    mc = flat @ consts.table[3:3 + m] + consts.table[axis]
    mean = mc[:, m + 3]
    var = consts.sigma2 * torch.sum(mc[:, :m + 3] ** 2, dim=-1)
    return mean.reshape(g.shape[:-1]), var.reshape(g.shape[:-1])


def gp_predictive(consts: PredictiveConstants, g: torch.Tensor):
    """(mean, var) [..., 3] of the exact GP predictive at the field rows
    of g [..., 3, m] float32 (K4's output): the plain version on the CPU,
    K12 on a CUDA device, one launch over all rows."""
    m = consts.m
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if g.dim() < 2 or tuple(g.shape[-2:]) != (3, m):
        raise ValueError(f"g must have shape [..., 3, {m}], got "
                         f"{tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if consts.table.device != g.device:
        raise ValueError(f"predictive constants on {consts.table.device}, "
                         f"g on {g.device}")
    if g.device.type == "cpu":
        return gp_predictive_plain(consts, g)
    if g.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {g.device}")
    mean = torch.empty(g.shape[:-1], dtype=torch.float32, device=g.device)
    var = torch.empty_like(mean)
    rows = mean.numel()
    if rows == 0:
        return mean, var                # nothing to launch, nothing counted
    table = consts.table
    code = _lib.lib().rbs_predictive(
        g.data_ptr(), table.data_ptr(), consts.sigma2, mean.data_ptr(),
        var.data_ptr(), rows, m, table.shape[1], table.shape[0],
        _lib.stream_ptr(),
    )
    _lib.check(code, "predictive")
    return mean, var
