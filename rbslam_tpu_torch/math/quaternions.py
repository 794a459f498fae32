"""Batched quaternion / rotation algebra (port of rbslam_tpu/math/quaternions.py).

Conventions: scalar-first unit quaternions ``q = [w, x, y, z]`` on the
trailing axis; canonical sign has a nonnegative scalar part
(tools/expq.m:22-38). Every function broadcasts over leading axes.
"""

from __future__ import annotations

import math

import torch


def mcross(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v x] (tools/mcross.m:33-42):
    v [..., 3] -> [..., 3, 3] with (M @ w) == cross(v, w)."""
    v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(v1)
    return torch.stack(
        [
            torch.stack([z, -v3, v2], dim=-1),
            torch.stack([v3, z, -v1], dim=-1),
            torch.stack([-v2, v1, z], dim=-1),
        ],
        dim=-2,
    )


def expq(phi: torch.Tensor) -> torch.Tensor:
    """Quaternion exponential R^3 -> S^3, canonical sign (tools/expq.m).

    Half-angle convention: ``expq(phi)`` rotates by ``2*|phi|``.
    """
    mag = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
    pos = mag > 0
    sinc = torch.where(pos, torch.sin(mag) / torch.where(pos, mag, 1.0), 1.0)
    q = torch.cat([torch.cos(mag), phi * sinc], dim=-1)
    return torch.where(q[..., :1] < 0, -q, q)


def logq(q: torch.Tensor) -> torch.Tensor:
    """Quaternion logarithm S^3 -> R^3 (tools/logq.m): q [..., 4] ->
    [..., 3]; inverse of :func:`expq` on the canonical hemisphere."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    na = torch.acos(w)
    s = torch.sin(na)
    scale = torch.where(na > 0, na / torch.where(s > 0, s, 1.0), 1.0)
    return q[..., 1:] * scale


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2, broadcasting over leading axes."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v1, v2 = torch.broadcast_tensors(v1, v2)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w, v], dim=-1)


def qleft(q: torch.Tensor) -> torch.Tensor:
    """Left multiplication matrix [..., 4, 4]: qleft(q) @ p == qmul(q, p)
    (tools/qLeft.m)."""
    w, v = q[..., :1], q[..., 1:]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w, -v], dim=-1)[..., None, :]
    bottom = torch.cat([v[..., :, None], w[..., None] * eye + mcross(v)],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def qright(q: torch.Tensor) -> torch.Tensor:
    """Right multiplication matrix [..., 4, 4]: qright(q) @ p == qmul(p, q)
    (tools/qRight.m)."""
    w, v = q[..., :1], q[..., 1:]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w, -v], dim=-1)[..., None, :]
    bottom = torch.cat([v[..., :, None], w[..., None] * eye - mcross(v)],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (tools/qInv.m)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_rmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix [..., 3, 3] (tools/quat2rmat.m)."""
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            q0**2 + q1**2 - q2**2 - q3**2,
            2 * (q1 * q2 - q0 * q3),
            2 * (q1 * q3 + q0 * q2),
            2 * (q1 * q2 + q0 * q3),
            q0**2 - q1**2 + q2**2 - q3**2,
            2 * (q2 * q3 - q0 * q1),
            2 * (q1 * q3 - q0 * q2),
            2 * (q2 * q3 + q0 * q1),
            q0**2 - q1**2 - q2**2 + q3**2,
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (canonical sign), Shepperd's method:
    four candidate reconstructions keyed on the largest of
    {1±R00±R11±R22}, selected branch-free."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = torch.stack(
        [
            1.0 + r00 + r11 + r22,
            1.0 + r00 - r11 - r22,
            1.0 - r00 + r11 - r22,
            1.0 - r00 - r11 + r22,
        ],
        dim=-1,
    )
    s = torch.sqrt(torch.clamp(t, min=1e-12))
    a = R[..., 2, 1] - R[..., 1, 2]
    b = R[..., 0, 2] - R[..., 2, 0]
    c = R[..., 1, 0] - R[..., 0, 1]
    d = R[..., 0, 1] + R[..., 1, 0]
    e = R[..., 0, 2] + R[..., 2, 0]
    f = R[..., 1, 2] + R[..., 2, 1]
    sw, sx, sy, sz = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    cand = torch.stack(
        [
            torch.stack([sw * sw, a, b, c], dim=-1) / (2.0 * sw[..., None]),
            torch.stack([a, sx * sx, d, e], dim=-1) / (2.0 * sx[..., None]),
            torch.stack([b, d, sy * sy, f], dim=-1) / (2.0 * sy[..., None]),
            torch.stack([c, e, f, sz * sz], dim=-1) / (2.0 * sz[..., None]),
        ],
        dim=-2,
    )
    best = torch.argmax(t, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> [yaw, pitch, roll] in degrees (tools/quat2euler.m:32-34)."""
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    e = torch.stack(
        [
            torch.atan2(2 * (q2 * q3 - q0 * q1), 2 * (q0**2 + q3**2) - 1.0),
            -torch.asin(torch.clamp(2 * (q1 * q3 + q0 * q2), -1.0, 1.0)),
            torch.atan2(2 * (q1 * q2 - q0 * q3), 2 * (q0**2 + q1**2) - 1.0),
        ],
        dim=-1,
    )
    return e * (180.0 / math.pi)
