"""7-DoF similarity transform (Umeyama) + point/pose transforms.

Port of mavmap_tpu/ops/similarity.py (reference
src/base3d/similarity_transform.{h,cc}); the slice uses it to align
trajectories for ATE.
"""

import torch

from .rotation import rotmat_from_rvec, rvec_from_rotmat


def solve_umeyama(src, dst, with_scale=True):
    """Least-squares s, R, t with dst ~ s R src + t. src, dst: (S, 3).
    Returns the (3, 4) matrix [sR | t] (Umeyama 1991)."""
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    cs = src - mu_s
    cd = dst - mu_d
    cov = (cd.T @ cs) / cs.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    det_sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    sgn = torch.ones(3, dtype=src.dtype, device=src.device)
    sgn[2] = det_sign
    R = (U * sgn[None, :]) @ Vt
    var_s = torch.mean(torch.sum(cs * cs, dim=1))
    if with_scale:
        scale = torch.sum(D * sgn) / torch.clamp(var_s, min=1e-20)
    else:
        scale = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - scale * (R @ mu_s)
    return torch.cat([scale * R, t[:, None]], dim=-1)


def solve_similarity(src, dst):
    """RANSAC estimator contract: ((1, 3, 4), (1,)) from a (S, 3) sample pair."""
    T = solve_umeyama(src, dst)
    return T[None], torch.isfinite(T).all()[None]


def transform_points(T, points):
    """Apply (3, 4) [sR|t] to (..., 3) points."""
    return points @ T[:3, :3].T + T[:3, 3]


def similarity_residuals(src, dst, T):
    """||T(src) - dst|| per point."""
    return torch.linalg.norm(transform_points(T, src) - dst, dim=-1)


def similarity_scale(T):
    """Isotropic scale s of [sR|t] (reference similarity_transform.cc:125-130)."""
    return torch.linalg.det(T[:3, :3]) ** (1.0 / 3.0)


def similarity_rvec(T):
    return rvec_from_rotmat(T[:3, :3] / similarity_scale(T))


def transform_pose(T, rvec, tvec):
    """Remap a world->cam pose under a world similarity x' = sR x + t
    (reference similarity_transform.cc:95-122)."""
    s = similarity_scale(T)
    R = T[:3, :3] / s
    Rc_new = rotmat_from_rvec(rvec) @ R.T
    return rvec_from_rotmat(Rc_new), s * tvec - Rc_new @ T[:3, 3]
