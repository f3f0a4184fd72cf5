"""Brute-force descriptor matching.

Port of mavmap_tpu/ops/matching.py (reference src/base2d/feature.cc:52-133):
2-NN matching in both directions with the Lowe ratio test on squared
distances, symmetric cross-check, and an optional pixel-distance prefilter
(`max_distance_mask_`, feature.cc:23-49). Descriptor buffers are padded to
a fixed capacity with validity masks; invalid rows never match.
"""

import torch


MATCHER_BACKENDS = ("auto", "xla", "pallas")


def distance_matrix_sq(d1, d2):
    """Squared L2 distances. d1: (..., N1, D), d2: (..., N2, D) -> (..., N1, N2)
    (leading dims broadcast)."""
    d1 = d1.float()
    d2 = d2.float()
    n1 = torch.sum(d1 * d1, dim=-1)
    n2 = torch.sum(d2 * d2, dim=-1)
    d = n1[..., :, None] + n2[..., None, :] - 2.0 * (d1 @ d2.transpose(-1, -2))
    return torch.clamp(d, min=0.0)


def match_brute_force(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                      ratio=0.9, max_distance=None, cross_check=True):
    """2-NN ratio-test matching with symmetric cross-check, as one (N1, N2)
    distance matrix in plain PyTorch (masked entries at +inf).

    Either side may carry a leading slot axis ((B, N, D) descriptors with
    (B, N) masks and (B, N, 2) keypoints), the other then shared by every
    slot, as in match_features_batched: the JAX package's jax.vmap of this
    matcher. Returns (matches (..., N1) int32 -> index into d2 or -1,
    valid (..., N1) bool)."""
    N1, N2 = d1.shape[-2], d2.shape[-2]
    dev = d1.device
    D = distance_matrix_sq(d1, d2)
    big = torch.full_like(D, float("inf"))
    if mask1 is not None:
        D = torch.where(mask1[..., :, None], D, big)
    if mask2 is not None:
        D = torch.where(mask2[..., None, :], D, big)
    if max_distance is not None and kp1 is not None and kp2 is not None:
        kp1 = kp1.float()
        kp2 = kp2.float()
        sep = (torch.sum(kp1 * kp1, dim=-1)[..., :, None]
               + torch.sum(kp2 * kp2, dim=-1)[..., None, :]
               - 2.0 * (kp1 @ kp2.transpose(-1, -2)))
        D = torch.where(sep <= max_distance * max_distance, D, big)

    d_best, j_best = torch.min(D, dim=-1)  # first index on ties
    col_ids = torch.arange(N2, device=dev)
    d_second = torch.where(col_ids == j_best[..., None], big, D).min(dim=-1).values
    ok = (d_best < (ratio * ratio) * d_second) & torch.isfinite(d_best)

    if cross_check:
        c_best, i_best = torch.min(D, dim=-2)
        row_ids = torch.arange(N1, device=dev)
        c_second = torch.where(row_ids[:, None] == i_best[..., None, :], big,
                               D).min(dim=-2).values
        col_ok = c_best < (ratio * ratio) * c_second
        mutual = torch.gather(i_best, -1, j_best) == row_ids
        ok = ok & mutual & torch.gather(col_ok, -1, j_best)

    matches = torch.where(ok, j_best, torch.full_like(j_best, -1))
    return matches.to(torch.int32), ok


def _matcher(backend):
    """The matcher of a backend name (MATCHER_BACKENDS): 'auto' and
    'pallas' = the fused kernel path (ops/cuda/match.py: CUDA kernel K1 on
    CUDA tensors, its plain version on CPU tensors; 'pallas' is the JAX
    package's hand-kernel choice), 'xla' = match_brute_force, plain PyTorch
    ops on the tensors' own device (the JAX package's fused-ops choice).
    An unknown name raises: no choice falls back to another."""
    if backend == "xla":
        return match_brute_force
    if backend in ("auto", "pallas"):
        from .cuda.match import match_brute_force_cuda

        return match_brute_force_cuda
    raise ValueError(f"matcher backend {backend!r}: expected one of {MATCHER_BACKENDS}")


def match_features(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                   ratio=0.9, max_distance=None, backend="pallas"):
    """The mapper's matcher, by `backend` (see _matcher). Same semantics on
    every backend. Returns (matches (N1,) int32 or -1, valid (N1,))."""
    return _matcher(backend)(d1, d2, mask1, mask2, kp1, kp2, ratio=ratio,
                             max_distance=max_distance)


def match_features_batched(d1s, d2s, masks1=None, masks2=None, kps1=None, kps2=None,
                           ratio=0.9, max_distance=None, backend="pallas"):
    """`match_features` over a leading slot axis, the JAX package's
    jax.vmap of the matcher: each side is one (B, N, D) stack of
    descriptors (with (B, N) masks and (B, N, 2) keypoints) or one
    (N, D) image that every slot shares. On the kernel path one batched
    K1 launch on CUDA tensors, its plain version on CPU ones; 'xla' is
    match_brute_force over the slot axis. The ratio test and the
    cross-check run per slot. Returns (matches (B, N1), valid (B, N1)),
    each slot equal to `match_features` on its pair."""
    if d1s.dim() != 3 and d2s.dim() != 3:
        raise ValueError("match_features_batched: neither side has a slot axis")
    return _matcher(backend)(d1s, d2s, masks1, masks2, kps1, kps2, ratio=ratio,
                             max_distance=max_distance)


def median_feature_disparity(kp1, kp2, matches, valid):
    """Median keypoint displacement over matches (reference feature.cc:136-151),
    over leading slot dims: kp (..., N, 2), matches/valid (..., N) -> (...).
    Invalid entries sort last as +inf; the median is over the first n."""
    j = torch.clamp(matches.long(), min=0)
    kp2_matched = torch.gather(kp2, -2, j[..., None].expand(j.shape + (2,)))
    disp = torch.linalg.norm(kp2_matched - kp1, dim=-1)
    disp = torch.where(valid, disp, torch.full_like(disp, float("inf")))
    n = torch.sum(valid, dim=-1, keepdim=True)
    sorted_disp = torch.sort(disp, dim=-1).values
    lo = torch.gather(sorted_disp, -1, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(sorted_disp, -1, torch.clamp(n // 2, min=0))
    med = (0.5 * (lo + hi))[..., 0]
    return torch.where(n[..., 0] > 0, med, torch.zeros_like(med))
