"""Batched perspective-3-point (P3P) absolute pose solver.

Port of mavmap_tpu/ops/p3p.py: the Grunert law-of-cosines reduction to a
quartic in v (closed-form Ferrari roots), a Newton polish on the two
original quadratics, and a closed-form rigid fit of the 3 camera-frame
points. All functions take a leading trial axis; each trial consumes the
FIRST 3 correspondences of its sample to build the quartic (reference
p3p.h:35), extra rows only vote.
"""

import torch

from .polynomial import solve_quartic_real
from .projection import calc_reproj_errors
from .reduce import matmul_ordered


def _triad(Q):
    """Orthonormal frame from 3 points: Q (..., 3, 3) -> (..., 3, 3) with
    the basis vectors as columns."""
    e1 = Q[..., 1, :] - Q[..., 0, :]
    e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-12)
    u = Q[..., 2, :] - Q[..., 0, :]
    e2 = u - torch.sum(u * e1, dim=-1, keepdim=True) * e1
    e2 = e2 / torch.clamp(torch.linalg.norm(e2, dim=-1, keepdim=True), min=1e-12)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def solve_p3p(points2D, points3D):
    """P3P minimal solver, batched over a leading trial axis.

    points2D: (T, S>=3, 2) normalized coords; points3D: (T, S>=3, 3).
    Returns (models (T, 4, 3, 4) [R|t] world->cam, mask (T, 4)).
    """
    P = points3D[:, :3]
    f = torch.cat([points2D[:, :3], torch.ones_like(points2D[:, :3, :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)

    a = torch.sum((P[:, 1] - P[:, 2]) ** 2, dim=-1)  # opposite P1
    b = torch.sum((P[:, 0] - P[:, 2]) ** 2, dim=-1)  # opposite P2
    c = torch.sum((P[:, 0] - P[:, 1]) ** 2, dim=-1)  # opposite P3
    cos_alpha = torch.sum(f[:, 1] * f[:, 2], dim=-1)
    cos_beta = torch.sum(f[:, 0] * f[:, 2], dim=-1)
    cos_gamma = torch.sum(f[:, 0] * f[:, 1], dim=-1)

    b_safe = torch.clamp(b, min=1e-20)
    cb = c / b_safe
    ab = a / b_safe

    # Quadratic 1: u^2 + p1 u + q1(v) = 0; quadratic 2: u^2 + p2(v) u + q2(v).
    p1 = -2.0 * cos_gamma
    q1 = [1.0 - cb, 2.0 * cb * cos_beta, -cb]          # ascending in v
    q2 = [-ab, 2.0 * ab * cos_beta, 1.0 - ab]
    # Resultant R(v) = dq^2 - p1 dq dp + q1 dp^2 with dp = p1 - p2,
    # dq = q1 - q2 (same coefficient order as the JAX convolutions).
    dp = [p1, 2.0 * cos_alpha]
    dq = [q1[i] - q2[i] for i in range(3)]

    def conv(x, y):
        out = [None] * (len(x) + len(y) - 1)
        for i, xi in enumerate(x):
            for j, yj in enumerate(y):
                out[i + j] = xi * yj if out[i + j] is None else out[i + j] + xi * yj
        return out

    dqdq = conv(dq, dq)                         # 5 coeffs
    p1dqdp = conv([p1], conv(dq, dp)) + [torch.zeros_like(p1)]  # 4 -> 5
    q1dpdp = conv(q1, conv(dp, dp))             # 5 coeffs
    quartic = torch.stack([dqdq[k] - p1dqdp[k] + q1dpdp[k] for k in range(5)],
                          dim=-1)

    v, real_mask = solve_quartic_real(quartic)  # (T, 4)
    p1_, ca = p1[:, None], cos_alpha[:, None]
    q1_ = [t[:, None] for t in q1]
    q2_ = [t[:, None] for t in q2]
    dq_ = [t[:, None] for t in dq]
    dp_ = [t[:, None] for t in dp]

    # u via the linear elimination u = -dq(v) / dp(v).
    dq_v = dq_[0] + dq_[1] * v + dq_[2] * v * v
    dp_v = dp_[0] + dp_[1] * v
    u = -dq_v / torch.where(dp_v.abs() < 1e-12, torch.full_like(dp_v, 1e-12), dp_v)

    # Newton polish of (u, v) on the two original quadratics.
    for _ in range(3):
        Q1 = u * u + p1_ * u + (q1_[0] + q1_[1] * v + q1_[2] * v * v)
        Q2 = u * u + (-2.0 * ca * v) * u + (q2_[0] + q2_[1] * v + q2_[2] * v * v)
        J11 = 2.0 * u + p1_
        J12 = q1_[1] + 2.0 * q1_[2] * v
        J21 = 2.0 * u - 2.0 * ca * v
        J22 = -2.0 * ca * u + q2_[1] + 2.0 * q2_[2] * v
        det = J11 * J22 - J12 * J21
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        du = (Q1 * J22 - Q2 * J12) / det
        dv = (Q2 * J11 - Q1 * J21) / det
        u, v = u - du, v - dv

    denom = 1.0 + v * v - 2.0 * v * cos_beta[:, None]
    s1_sq = b[:, None] / torch.clamp(denom, min=1e-20)
    valid = real_mask & (s1_sq > 0) & (denom > 1e-12)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=0.0))
    s2 = u * s1
    s3 = v * s1
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points (T, 4, 3, 3) and the closed-form rigid fit of
    # exactly 3 points: map the world triad onto the camera triad.
    Xc = torch.stack([s1, s2, s3], dim=-1)[..., None] * f[:, None, :, :]
    Bw = _triad(P)[:, None]                          # (T, 1, 3, 3)
    # 3x3 products added in a fixed order (ops/reduce.py): on the card a
    # batched matmul's bits depend on the number of trials, and a slot of
    # the batched registration steps must not.
    R = matmul_ordered(_triad(Xc), Bw.transpose(-1, -2))            # (T, 4, 3, 3)
    t = Xc.mean(dim=-2) - matmul_ordered(R, P.mean(dim=-2)[:, None, :, None])[..., 0]
    models = torch.cat([R, t[..., None]], dim=-1)    # (T, 4, 3, 4)
    valid = valid & torch.isfinite(models).all(dim=-1).all(dim=-1)
    return models, valid


def solve_p3p_best(points2D, points3D):
    """P3P returning ONE model per trial: the candidate with the least
    total reprojection error over the whole sample (the first 3 rows build
    the quartic, the rest disambiguate; reference p3p.cc:144-159).
    Returns (models (T, 1, 3, 4), mask (T, 1))."""
    models, valid = solve_p3p(points2D, points3D)
    errs = calc_reproj_errors(points2D[:, None], points3D[:, None], models)  # (T, 4, S)
    errs = torch.nan_to_num(errs, nan=1e6, posinf=1e6)
    tot = torch.sum(torch.clamp(errs, max=1e6), dim=-1)
    tot = torch.where(valid, tot, torch.full_like(tot, float("inf")))
    best = torch.argmin(tot, dim=-1)
    idx = best[:, None, None, None].expand(-1, 1, 3, 4)
    return (torch.gather(models, 1, idx),
            torch.gather(valid, 1, best[:, None]))


def p3p_residuals(points2D, points3D, model):
    """Reprojection error in normalized coords per correspondence:
    model (..., 3, 4) -> (..., N) (reference p3p.cc:172-199)."""
    return calc_reproj_errors(points2D, points3D, model)
