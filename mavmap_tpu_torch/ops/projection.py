"""Projection-matrix utilities, reprojection errors, depths.

Port of mavmap_tpu/ops/projection.py (reference src/base3d/projection.cc).
A pose is ``(rvec, tvec)`` mapping world -> camera: ``x_cam = R x_w + t``;
``proj`` is the (..., 3, 4) matrix ``[R | t]``. Functions broadcast over
leading batch dims on the pose and a points axis N.
"""

import torch

from .reduce import matmul_ordered
from .rotation import rotmat_from_rvec, rvec_from_rotmat


def compose_proj_matrix(rvec, tvec):
    """(..., 3), (..., 3) -> (..., 3, 4) = [R(rvec) | tvec] (projection.cc:58-76),
    with R's K @ K added in a fixed order (ops/reduce.py): on the card a
    batched 3x3 matmul's bits depend on the batch, and a slot of the
    batched registration steps must not."""
    return torch.cat([rotmat_from_rvec(rvec, matmul_ordered), tvec[..., :, None]], dim=-1)


def invert_proj_matrix(proj):
    """Invert [R|t] -> [R^T | -R^T t] (projection.cc:79-87)."""
    Rt = proj[..., :3, :3].transpose(-1, -2)
    t_inv = -matmul_ordered(Rt, proj[..., :3, 3:4])
    return torch.cat([Rt, t_inv], dim=-1)


def invert_pose(rvec, tvec):
    """World->cam pose to cam->world pose (and vice versa)."""
    Rt = rotmat_from_rvec(rvec).transpose(-1, -2)
    return rvec_from_rotmat(Rt), -(Rt @ tvec[..., :, None])[..., 0]


def camera_center(rvec, tvec):
    """World coordinates of the camera center: C = -R^T t."""
    R = rotmat_from_rvec(rvec)
    return -(R.transpose(-1, -2) @ tvec[..., :, None])[..., 0]


def world_pose_from_proj(proj):
    """Cam->world (rvec, tvec) of a world->cam [R|t], for output
    (projection.cc:90-104)."""
    inv = invert_proj_matrix(proj)
    return rvec_from_rotmat(inv[..., :3, :3]), inv[..., :3, 3]


def transform_points(proj, points3D):
    """Apply [R|t] to (..., N, 3) world points -> camera-frame points."""
    R = proj[..., :3, :3]
    t = proj[..., :3, 3]
    return matmul_ordered(points3D, R.transpose(-1, -2)) + t[..., None, :]


def project_normalized(proj, points3D, eps=1e-12):
    """World points -> normalized image coords (x/z, y/z)."""
    pc = transform_points(proj, points3D)
    z = pc[..., 2:3]
    safe_z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    return pc[..., :2] / safe_z


def calc_depth(proj, points3D):
    """Signed depth (camera-frame z) of world points (projection.cc:133-149)."""
    return transform_points(proj, points3D)[..., 2]


def calc_reproj_errors(points2D, points3D, proj, eps=1e-12):
    """Euclidean reprojection error in normalized coords per point.

    points2D: (..., N, 2); points3D: (..., N, 3); proj: (..., 3, 4).
    Returns (..., N); points behind the camera get 1e6 (projection.cc:107-130).
    """
    pc = transform_points(proj, points3D)
    z = pc[..., 2]
    safe_z = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
    proj2D = pc[..., :2] / safe_z[..., None]
    err = torch.linalg.norm(proj2D - points2D, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, 1e6))
