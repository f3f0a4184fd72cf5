"""4-point DLT homography estimation (degeneracy gate for view pairs).

Port of mavmap_tpu/ops/homography.py (reference
src/base3d/projective_transform.{h,cc}): if too many matches fit a
homography the pair is near-degenerate for two-view geometry (reference
sfm/sequential_mapper.cc:116-158). Batched over leading dims.
"""

import torch


def solve_homography(src, dst):
    """DLT from (..., S, 2) <-> (..., S, 2) normalized points with h33 = 1
    (8x8 normal equations). Returns ((..., 1, 3, 3) models, (..., 1) mask);
    a singular sample yields a non-finite H and is masked out."""
    u, v = src[..., 0], src[..., 1]
    x, y = dst[..., 0], dst[..., 1]
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    rows1 = torch.stack([u, v, one, zero, zero, zero, -u * x, -v * x, -x], dim=-1)
    rows2 = torch.stack([zero, zero, zero, u, v, one, -u * y, -v * y, -y], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)  # (..., 2S, 9)
    AtA = A.transpose(-1, -2) @ A
    # linalg.solve raises on an exactly singular system where XLA returns
    # non-finite values; solve_ex reports it instead, and those samples are
    # masked like the JAX version's non-finite ones.
    h8, info = torch.linalg.solve_ex(AtA[..., :8, :8], -AtA[..., :8, 8])
    H = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1)
    H = H.reshape(H.shape[:-1] + (3, 3))
    ok = torch.isfinite(H).all(dim=-1).all(dim=-1) & (info == 0)
    return H[..., None, :, :], ok[..., None]


def homography_residuals(src, dst, H):
    """Transfer error ||proj(H src) - dst|| per point: src/dst (..., N, 2),
    H (..., 3, 3) -> (..., N), leading dims broadcast."""
    ones = torch.ones_like(src[..., :1])
    ph = torch.cat([src, ones], dim=-1) @ H.transpose(-1, -2)  # (..., N, 3)
    w = ph[..., 2:3]
    safe_w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.linalg.norm(ph[..., :2] / safe_w - dst, dim=-1)
