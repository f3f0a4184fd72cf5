"""Rotation utilities: angle-axis (rvec) <-> matrix, Euler <-> matrix.

Port of mavmap_tpu/ops/rotation.py (reference src/base3d/projection.cc:12-55).

- ``rvec`` is an angle-axis vector (angle = ||rvec||, axis = rvec/||rvec||).
- Euler convention: ``R = Rz(rz) @ Ry(ry) @ Rx(rx)`` (ZYX).

All functions broadcast over leading batch dims, are branch-free
(torch.where), and work under torch.func transforms.
"""

import torch

from .reduce import elementwise_fixed


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_from_rvec(rvec, square=torch.matmul):
    """Angle-axis -> rotation matrix (Rodrigues). rvec: (..., 3) -> (..., 3, 3).

    Small angles use the Taylor limits of sin(t)/t and (1-cos t)/t^2.
    `square` forms K @ K: compose_proj_matrix passes ops/reduce.py's
    matmul_ordered, whose bits do not depend on the batch.
    """
    theta2 = torch.sum(rvec * rvec, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    one = torch.ones_like(theta)
    safe_theta = torch.where(small, one, theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_theta) / safe_theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_theta)) / torch.where(small, one, theta2))
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a * K + b * square(K, K)


def quat_from_rotmat(R):
    """(..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z).

    Branch-free Shepperd's method: all four candidate constructions, the one
    with the largest pivot selected.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def sq(x):
        s = torch.sqrt(torch.clamp(x, min=0.0))
        return s * s

    cand_w = torch.stack([sq(qw2), m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, sq(qx2), m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, sq(qy2), m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, sq(qz2)], dim=-1)

    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(norm, min=1e-20)
    return torch.where(q[..., 0:1] < 0, -q, q)


def rvec_from_quat(q):
    """Unit quaternion (w,x,y,z) -> angle-axis (..., 3)."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * elementwise_fixed(torch.atan2, sin_half, w)
    small = sin_half < 1e-12
    scale = torch.where(small, torch.full_like(angle, 2.0),
                        angle / torch.where(small, torch.ones_like(sin_half), sin_half))
    return v * scale[..., None]


def rvec_from_rotmat(R):
    """Rotation matrix -> angle-axis. R: (..., 3, 3) -> (..., 3), via the
    quaternion route (stable over the full angle range incl. theta ~ pi)."""
    return rvec_from_quat(quat_from_rotmat(R))


def rotmat_from_euler(rx, ry, rz):
    """Euler angles (tensors) -> R = Rz(rz) @ Ry(ry) @ Rx(rx).

    Matches reference src/base3d/projection.cc:39-55.
    """
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    rows = [
        torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], dim=-1),
        torch.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], dim=-1),
        torch.stack([-sy, cy * sx, cy * cx], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def euler_from_rotmat(R):
    """R -> (rx, ry, rz) under R = Rz Ry Rx. Matches reference projection.cc:26-37."""
    rx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ry = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    rz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return rx, ry, rz


def rvec_from_euler(roll, pitch, yaw):
    """IMU (roll, pitch, yaw) -> angle-axis rvec (reference src/base2d/image.cc:33-37)."""
    return rvec_from_rotmat(rotmat_from_euler(roll, pitch, yaw))


def rotate_points(rvec, points):
    """Rotate (..., N, 3) points by (..., 3) angle-axis: R @ p."""
    return points @ rotmat_from_rvec(rvec).transpose(-1, -2)
