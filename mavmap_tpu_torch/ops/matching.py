"""Brute-force descriptor matching.

Port of mavmap_tpu/ops/matching.py (reference src/base2d/feature.cc:52-133):
2-NN matching in both directions with the Lowe ratio test on squared
distances, symmetric cross-check, and an optional pixel-distance prefilter
(`max_distance_mask_`, feature.cc:23-49). Descriptor buffers are padded to
a fixed capacity with validity masks; invalid rows never match.
"""

import torch


def distance_matrix_sq(d1, d2):
    """Squared L2 distances. d1: (N1, D), d2: (N2, D) -> (N1, N2)."""
    d1 = d1.float()
    d2 = d2.float()
    n1 = torch.sum(d1 * d1, dim=-1)
    n2 = torch.sum(d2 * d2, dim=-1)
    d = n1[:, None] + n2[None, :] - 2.0 * (d1 @ d2.T)
    return torch.clamp(d, min=0.0)


def match_brute_force(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                      ratio=0.9, max_distance=None, cross_check=True):
    """2-NN ratio-test matching with symmetric cross-check, as one (N1, N2)
    distance matrix in plain PyTorch (masked entries at +inf).

    Returns (matches (N1,) int32 -> index into d2 or -1, valid (N1,) bool).
    """
    N1, N2 = d1.shape[0], d2.shape[0]
    dev = d1.device
    D = distance_matrix_sq(d1, d2)
    big = torch.full_like(D, float("inf"))
    if mask1 is not None:
        D = torch.where(mask1[:, None], D, big)
    if mask2 is not None:
        D = torch.where(mask2[None, :], D, big)
    if max_distance is not None and kp1 is not None and kp2 is not None:
        kp1 = kp1.float()
        kp2 = kp2.float()
        sep = (torch.sum(kp1 * kp1, dim=-1)[:, None]
               + torch.sum(kp2 * kp2, dim=-1)[None, :] - 2.0 * (kp1 @ kp2.T))
        D = torch.where(sep <= max_distance * max_distance, D, big)

    d_best, j_best = torch.min(D, dim=1)  # first index on ties
    col_ids = torch.arange(N2, device=dev)[None, :]
    d_second = torch.where(col_ids == j_best[:, None], big, D).min(dim=1).values
    ok = (d_best < (ratio * ratio) * d_second) & torch.isfinite(d_best)

    if cross_check:
        c_best, i_best = torch.min(D, dim=0)
        row_ids = torch.arange(N1, device=dev)[:, None]
        c_second = torch.where(row_ids == i_best[None, :], big, D).min(dim=0).values
        col_ok = c_best < (ratio * ratio) * c_second
        mutual = i_best[j_best] == torch.arange(N1, device=dev)
        ok = ok & mutual & col_ok[j_best]

    matches = torch.where(ok, j_best, torch.full_like(j_best, -1))
    return matches.to(torch.int32), ok


def match_features(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                   ratio=0.9, max_distance=None):
    """The mapper's matcher: the fused kernel path (ops/cuda/match.py) —
    CUDA kernel K1 on CUDA tensors, its plain version on CPU tensors. Same
    semantics as `match_brute_force`."""
    from .cuda.match import match_brute_force_cuda

    return match_brute_force_cuda(d1, d2, mask1, mask2, kp1, kp2, ratio=ratio,
                                  max_distance=max_distance)


def match_features_batched(d1s, d2s, masks1=None, masks2=None, kps1=None, kps2=None,
                           ratio=0.9, max_distance=None):
    """`match_features` over a leading slot axis, the JAX package's
    jax.vmap of the matcher: each side is one (B, N, D) stack of
    descriptors (with (B, N) masks and (B, N, 2) keypoints) or one
    (N, D) image that every slot shares. One batched K1 launch on CUDA
    tensors, its plain version on CPU ones; the ratio test and the
    cross-check run per slot. Returns (matches (B, N1), valid (B, N1)),
    each slot equal to `match_features` on its pair."""
    from .cuda.match import match_brute_force_cuda

    if d1s.dim() != 3 and d2s.dim() != 3:
        raise ValueError("match_features_batched: neither side has a slot axis")
    return match_brute_force_cuda(d1s, d2s, masks1, masks2, kps1, kps2, ratio=ratio,
                                  max_distance=max_distance)


def median_feature_disparity(kp1, kp2, matches, valid):
    """Median keypoint displacement over matches (reference feature.cc:136-151).
    Invalid entries sort last as +inf; the median is over the first n."""
    kp2_matched = kp2[torch.clamp(matches.long(), min=0)]
    disp = torch.linalg.norm(kp2_matched - kp1, dim=-1)
    disp = torch.where(valid, disp, torch.full_like(disp, float("inf")))
    n = torch.sum(valid)
    sorted_disp = torch.sort(disp).values
    lo = sorted_disp[torch.clamp((n - 1) // 2, min=0)]
    hi = sorted_disp[torch.clamp(n // 2, min=0)]
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.zeros_like(med))
