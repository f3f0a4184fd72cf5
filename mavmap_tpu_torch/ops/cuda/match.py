"""Fused descriptor matcher: CUDA kernel K1 (csrc/match.cu) and its wrapper.

Replaces mavmap_tpu/ops/pallas/match.py (`_match_pallas_raw`, the Pallas
kernel `_match_kernel`, and its wrapper `match_brute_force_pallas`). One
pass over the distance tiles yields the 2-NN statistics of both directions
without writing the (N1, N2) distance matrix to device memory; the ratio
test and the mutual cross-check stay in PyTorch ops on the kernel's
outputs, as they stay in XLA around the pallas_call.

`match_raw` launches the kernel for CUDA tensors and runs `match_raw_plain`
(the same arithmetic over the whole matrix in PyTorch) for CPU tensors.
On an H100 the kernel is bound by its 2*N1*N2*D f32 FMAs; see
csrc/match.cu for the design.
"""

import torch

from . import build

TILE_M = 128  # row padding quantum (the TPU kernel's tile)
TILE_N = 128  # column padding quantum
BIG = 1e30    # mask penalty: "infinitely far" while staying finite in f32
_KTM = 16     # rows per block of the CUDA kernel (csrc/match.cu TM)


def match_raw_plain(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
    """Plain PyTorch version of the kernel: (row_arg, row_best, row_second,
    col_arg, col_best, col_second). Ties go to the lower index."""
    n1sq = torch.sum(d1 * d1, dim=1, keepdim=True)
    cross = d1 @ d2.T
    dist = torch.clamp(n1sq + pen2[None, :] - 2.0 * cross, min=0.0)
    dist = dist + rowpen[:, None]
    if kp1 is not None:
        k1sq = torch.sum(kp1 * kp1, dim=1, keepdim=True)
        k2sq = torch.sum(kp2 * kp2, dim=1)[None, :]
        sep = k1sq + k2sq - 2.0 * (kp1 @ kp2.T)
        dist = torch.where(sep <= maxd2, dist, torch.full_like(dist, BIG))
    inf = torch.full_like(dist, float("inf"))
    r_best, r_arg = torch.min(dist, dim=1)
    cols = torch.arange(dist.shape[1], device=dist.device)
    r_second = torch.where(cols[None, :] == r_arg[:, None], inf, dist).min(dim=1).values
    c_best, c_arg = torch.min(dist, dim=0)
    rows = torch.arange(dist.shape[0], device=dist.device)
    c_second = torch.where(rows[:, None] == c_arg[None, :], inf, dist).min(dim=0).values
    return (r_arg.to(torch.int32), r_best, r_second,
            c_arg.to(torch.int32), c_best, c_second)


def _match_raw_cuda(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
    dev = d1.device
    N1, D = d1.shape
    N2 = d2.shape[0]
    if N1 % _KTM or N2 % 64 or d2.shape[1] != D:
        raise ValueError(f"match kernel: shapes {tuple(d1.shape)} x {tuple(d2.shape)} "
                         "need N1 % 16 == 0, N2 % 64 == 0 and equal D")
    f32 = torch.float32
    for name, t, nd in (("d1", d1, 2), ("d2", d2, 2), ("rowpen", rowpen, 1),
                        ("pen2", pen2, 1)):
        build.require(t, name, f32, nd, dev)
    use_kp = kp1 is not None
    if use_kp:
        build.require(kp1, "kp1", f32, 2, dev)
        build.require(kp2, "kp2", f32, 2, dev)
    n_tiles = N1 // _KTM
    row_arg = torch.empty(N1, dtype=torch.int32, device=dev)
    row_d = torch.empty((N1, 2), dtype=f32, device=dev)
    part_d = torch.empty((n_tiles, 2, N2), dtype=f32, device=dev)
    part_arg = torch.empty((n_tiles, N2), dtype=torch.int32, device=dev)
    col_arg = torch.empty(N2, dtype=torch.int32, device=dev)
    col_d = torch.empty((2, N2), dtype=f32, device=dev)
    lib = build.library()
    stream = build.stream_ptr(dev)
    build.check(lib.mavmap_match_tiles(
        d1.data_ptr(), d2.data_ptr(), rowpen.data_ptr(), pen2.data_ptr(),
        kp1.data_ptr() if use_kp else None, kp2.data_ptr() if use_kp else None,
        float(maxd2) if use_kp else 0.0, int(use_kp), N1, N2, D,
        row_arg.data_ptr(), row_d.data_ptr(), part_d.data_ptr(),
        part_arg.data_ptr(), stream), "mavmap_match_tiles")
    build.check(lib.mavmap_match_merge_cols(
        part_d.data_ptr(), part_arg.data_ptr(), n_tiles, N2,
        col_arg.data_ptr(), col_d.data_ptr(), stream), "mavmap_match_merge_cols")
    build.launches["match"] += 1
    return row_arg, row_d[:, 0], row_d[:, 1], col_arg, col_d[0], col_d[1]


def match_raw(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
    """Both-direction 2-NN over masked, prefiltered squared distances:
    the kernel for CUDA tensors, its plain version for CPU tensors."""
    if d1.is_cuda:
        return _match_raw_cuda(d1, rowpen, d2, pen2, kp1, kp2, maxd2)
    return match_raw_plain(d1, rowpen, d2, pen2, kp1, kp2, maxd2)


def padded_operands(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                    max_distance=None):
    """The kernel's operands for one descriptor pair, as `match_raw` takes
    them: rows and columns padded to multiples of 128 (padding masked, as
    the TPU wrapper pads ragged capacities), the 1e30 mask penalties folded
    into `rowpen` and `pen2` = |d2_j|^2 + penalty, and the squared pixel
    prefilter radius (keypoints None without a prefilter)."""
    dev = d1.device
    N1_in, N2_in = d1.shape[0], d2.shape[0]
    pad1 = -(-N1_in // TILE_M) * TILE_M - N1_in
    pad2 = -(-N2_in // TILE_N) * TILE_N - N2_in
    F = torch.nn.functional
    if mask1 is None:
        mask1 = torch.ones(N1_in, dtype=torch.bool, device=dev)
    if mask2 is None:
        mask2 = torch.ones(N2_in, dtype=torch.bool, device=dev)
    d1 = F.pad(d1.float(), (0, 0, 0, pad1)).contiguous()
    d2 = F.pad(d2.float(), (0, 0, 0, pad2)).contiguous()
    mask1 = F.pad(mask1, (0, pad1))  # padding is False: BIG row penalty
    mask2 = F.pad(mask2, (0, pad2))
    zero = torch.zeros((), device=dev)
    big = torch.full((), BIG, device=dev)
    rowpen = torch.where(mask1, zero, big).contiguous()
    pen2 = (torch.sum(d2 * d2, dim=1) + torch.where(mask2, zero, big)).contiguous()
    if max_distance is None or kp1 is None or kp2 is None:
        return d1, rowpen, d2, pen2, None, None, None
    kp1 = F.pad(kp1.float(), (0, 0, 0, pad1)).contiguous()
    kp2 = F.pad(kp2.float(), (0, 0, 0, pad2)).contiguous()
    return d1, rowpen, d2, pen2, kp1, kp2, float(max_distance) ** 2


def match_brute_force_cuda(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                           ratio=0.9, max_distance=None, cross_check=True):
    """Fused drop-in for ops.matching.match_brute_force (2-NN + Lowe ratio
    both directions, symmetric cross-check, optional pixel-distance
    prefilter). Returns (matches (N1,) int32 or -1, valid (N1,))."""
    N1_in = d1.shape[0]
    ops = padded_operands(d1, d2, mask1, mask2, kp1, kp2, max_distance)
    rowpen = ops[1]
    row_arg, r_best, r_second, col_arg, c_best, c_second = match_raw(*ops)

    r2 = ratio * ratio
    ok = (r_best < r2 * r_second) & (r_best < BIG * 0.1)
    row_arg = row_arg.long()
    if cross_check:
        mutual = col_arg[row_arg] == torch.arange(row_arg.shape[0], device=d1.device)
        col_ok = c_best < r2 * c_second
        ok = ok & mutual & col_ok[row_arg]
    ok = ok & (rowpen == 0)  # masked and padding rows never match
    matches = torch.where(ok, row_arg, torch.full_like(row_arg, -1)).to(torch.int32)
    return matches[:N1_in], ok[:N1_in]
