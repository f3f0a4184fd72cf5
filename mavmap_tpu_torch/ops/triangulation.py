"""Batched DLT triangulation + triangulation angles.

Port of mavmap_tpu/ops/triangulation.py (reference
src/base3d/triangulation.{h,cc}). Inputs are *normalized* image
coordinates.
"""

import torch


def _det3(M):
    """Batched 3x3 determinant, M: (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _cross4(M):
    """4-D generalized cross product of 3 row vectors, M: (..., 3, 4) ->
    (..., 4) n with M @ n = 0 exactly (cofactor expansion)."""
    cols = []
    sign = 1.0
    for j in range(4):
        keep = [k for k in range(4) if k != j]
        cols.append(sign * _det3(M[..., :, keep]))
        sign = -sign
    return torch.stack(cols, dim=-1)


def nullvec4(A):
    """Approximate null vector of a near-rank-3 4x4 system, (..., 4, 4) ->
    (..., 4): the cofactor cross product of each row triple, keeping the
    max-norm (best conditioned) candidate."""
    triples = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    cands = torch.stack([_cross4(A[..., list(t), :]) for t in triples], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cands, -2, idx)[..., 0, :]


def triangulate_points(proj1, proj2, points1, points2):
    """Two-view DLT triangulation (Hartley-Zisserman).

    proj1, proj2: (..., 3, 4); points1, points2: (..., N, 2) normalized.
    Returns (..., N, 3) world points.
    """
    rows = []
    for proj, pts in ((proj1, points1), (proj2, points2)):
        P1 = proj[..., None, 0, :]
        P2 = proj[..., None, 1, :]
        P3 = proj[..., None, 2, :]
        u = pts[..., 0:1]
        v = pts[..., 1:2]
        rows.append(u * P3 - P1)
        rows.append(v * P3 - P2)
    X = nullvec4(torch.stack(torch.broadcast_tensors(*rows), dim=-2))  # (..., N, 4, 4)
    w = X[..., 3:4]
    safe_w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / safe_w


def triangulate_points_multiview(projs, points2D, mask):
    """N-view DLT for one track, masked. projs: (V, 3, 4); points2D: (V, 2)
    normalized; mask: (V,) bool of valid observations. Returns the (3,)
    world point: the right singular vector of the smallest singular value
    of the (2V, 4) design matrix, invalid rows zeroed."""
    P1, P2, P3 = projs[:, 0, :], projs[:, 1, :], projs[:, 2, :]
    u = points2D[:, 0:1]
    v = points2D[:, 1:2]
    rows = torch.cat([u * P3 - P1, v * P3 - P2], dim=0)  # (2V, 4)
    rows = rows * torch.cat([mask, mask], dim=0)[:, None].to(rows.dtype)
    X = torch.linalg.svd(rows, full_matrices=False).Vh[-1, :]
    w = X[3]
    safe_w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[:3] / safe_w


def calc_tri_angles(proj1, proj2, points3D):
    """Angle at each 3-D point between the rays to the two camera centers
    (reference triangulation.cc:101-147). points3D (..., N, 3) -> (..., N)."""
    R1 = proj1[..., :3, :3]
    t1 = proj1[..., :3, 3]
    R2 = proj2[..., :3, :3]
    t2 = proj2[..., :3, 3]
    c1 = -(R1.transpose(-1, -2) @ t1[..., :, None])[..., 0]
    c2 = -(R2.transpose(-1, -2) @ t2[..., :, None])[..., 0]
    baseline2 = torch.sum((c1 - c2) ** 2, dim=-1)[..., None]
    ray1 = points3D - c1[..., None, :]
    ray2 = points3D - c2[..., None, :]
    d1_2 = torch.sum(ray1 * ray1, dim=-1)
    d2_2 = torch.sum(ray2 * ray2, dim=-1)
    d1 = torch.sqrt(torch.clamp(d1_2, min=1e-20))
    d2 = torch.sqrt(torch.clamp(d2_2, min=1e-20))
    cos_angle = (d1_2 + d2_2 - baseline2) / torch.clamp(2.0 * d1 * d2, min=1e-20)
    return torch.arccos(torch.clamp(cos_angle, -1.0, 1.0))
