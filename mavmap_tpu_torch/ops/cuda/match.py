"""Fused descriptor matcher: CUDA kernel K1 (csrc/match.cu) and its wrapper.

Replaces mavmap_tpu/ops/pallas/match.py (`_match_pallas_raw`, the Pallas
kernel `_match_kernel`, and its wrapper `match_brute_force_pallas`). One
pass over the distance tiles yields the 2-NN statistics of both directions
without writing the (N1, N2) distance matrix to device memory; the ratio
test and the mutual cross-check stay in PyTorch ops on the kernel's
outputs, as they stay in XLA around the pallas_call.

`match_raw` launches the kernel for CUDA tensors and runs `match_raw_plain`
(the same arithmetic over the whole matrix in PyTorch) for CPU tensors.
Given a leading slot axis on either side, `match_raw` is the TPU kernel
under jax.vmap: one launch for B pairs, each side either one set of rows
per slot or shared by every slot (plain version `match_raw_batched_plain`). On an H100 the
kernel is bound by its 2*N1*N2*D f32 FMAs per slot; see csrc/match.cu for
the design (64 x 64 register-tiled output tiles, then a merge of the
per-tile partials, blockIdx.z over the slots).
"""

import torch

from . import build

TILE_M = 128  # row padding quantum (the TPU kernel's tile)
TILE_N = 128  # column padding quantum
BIG = 1e30    # mask penalty: "infinitely far" while staying finite in f32
_BM, _BN, _BK = 64, 64, 32  # csrc/match.cu: output tile and descriptor stage


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


def match_raw_batched_plain(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
    """Plain version of the batched kernel: `match_raw_plain` slot by slot.
    A side with one more dim than its single-pair shape ((B, N, D) rows,
    (B, N) penalty, (B, N, 2) keypoints) is per slot; the other side is
    shared. Returns the six outputs with a leading slot axis."""
    B = _slots(d1, d2)

    def side(t, batched, b):
        return None if t is None else (t[b] if batched else t)

    b1, b2 = d1.dim() == 3, d2.dim() == 3
    outs = [match_raw_plain(side(d1, b1, b), side(rowpen, b1, b), side(d2, b2, b),
                            side(pen2, b2, b), side(kp1, b1, b), side(kp2, b2, b), maxd2)
            for b in range(B)]
    return tuple(torch.stack(x) for x in zip(*outs))


def _slots(d1, d2):
    if d1.dim() not in (2, 3) or d2.dim() not in (2, 3):
        raise ValueError(f"match: d1 {tuple(d1.shape)}, d2 {tuple(d2.shape)} must be 2-D "
                         f"(shared) or 3-D (one set of rows per slot)")
    sizes = {t.shape[0] for t in (d1, d2) if t.dim() == 3}
    if len(sizes) > 1:
        raise ValueError(f"match: batched sides disagree on the slot count {sorted(sizes)}")
    return sizes.pop() if sizes else 1


def _match_raw_cuda(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
    """One launch pair (tiles, merge) for a single pair or B slots: the
    single-pair call is the launch with one slot and no slot axis."""
    dev = d1.device
    b1, b2 = d1.dim() == 3, d2.dim() == 3
    B = _slots(d1, d2) if b1 or b2 else 1
    N1, D = d1.shape[-2:]
    N2 = d2.shape[-2]
    if N1 % _BM or N2 % _BN or D % _BK or d2.shape[-1] != D:
        raise ValueError(f"match kernel: shapes {tuple(d1.shape)} x {tuple(d2.shape)} "
                         f"need N1 % {_BM} == 0, N2 % {_BN} == 0, D % {_BK} == 0 and equal D")
    if rowpen.shape != d1.shape[:-1] or pen2.shape != d2.shape[:-1]:
        raise ValueError(f"match kernel: penalties {tuple(rowpen.shape)}, {tuple(pen2.shape)} "
                         f"for rows {tuple(d1.shape)}, {tuple(d2.shape)}")
    f32 = torch.float32
    for name, t, nd in (("d1", d1, 2 + b1), ("d2", d2, 2 + b2), ("rowpen", rowpen, 1 + b1),
                        ("pen2", pen2, 1 + b2)):
        build.require(t, name, f32, nd, dev)
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("match kernel: d1 and d2 must be 16-byte aligned (cp.async)")
    use_kp = kp1 is not None
    if use_kp:
        build.require(kp1, "kp1", f32, 2 + b1, dev)
        build.require(kp2, "kp2", f32, 2 + b2, dev)
        if kp1.shape[:-1] != d1.shape[:-1] or kp2.shape[:-1] != d2.shape[:-1]:
            raise ValueError(f"match kernel: keypoints {tuple(kp1.shape)}, {tuple(kp2.shape)} "
                             f"for rows {tuple(d1.shape)}, {tuple(d2.shape)}")
    # Two allocations, split into the per-tile partials and the outputs.
    n_ct, n_rt = N2 // _BN, N1 // _BM
    sizes = (B * n_ct * N1, B * n_rt * N2, B * N1, B * N2)
    row_part_d, col_part_d, row_d, col_d = torch.empty(
        2 * sum(sizes), dtype=f32, device=dev).split([2 * n for n in sizes])
    row_part_arg, col_part_arg, row_arg, col_arg = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    build.check(build.library().mavmap_match(
        d1.data_ptr(), d2.data_ptr(), rowpen.data_ptr(), pen2.data_ptr(),
        kp1.data_ptr() if use_kp else None, kp2.data_ptr() if use_kp else None,
        float(maxd2) if use_kp else 0.0, int(use_kp), B, int(b1), int(b2), N1, N2, D,
        row_part_d.data_ptr(), row_part_arg.data_ptr(), col_part_d.data_ptr(),
        col_part_arg.data_ptr(), row_arg.data_ptr(), row_d.data_ptr(), col_arg.data_ptr(),
        col_d.data_ptr(), build.stream_ptr(dev)), "mavmap_match")
    build.launches["match"] += 1
    if not (b1 or b2):
        row_d, col_d = row_d.view(N1, 2), col_d.view(2, N2)
        return row_arg, row_d[:, 0], row_d[:, 1], col_arg, col_d[0], col_d[1]
    build.launches["match_batched"] += 1
    build.slots["match_batched"] += B
    row_d, col_d = row_d.view(B, N1, 2), col_d.view(B, 2, N2)
    return (row_arg.view(B, N1), row_d[..., 0], row_d[..., 1], col_arg.view(B, N2),
            col_d[:, 0], col_d[:, 1])


def match_raw(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
    """Both-direction 2-NN over masked, prefiltered squared distances:
    the kernel for CUDA tensors, its plain version for CPU tensors. Either
    side may carry a leading slot axis (see match_raw_batched_plain): then
    one launch serves every slot and the outputs carry the slot axis."""
    if d1.is_cuda:
        return _match_raw_cuda(d1, rowpen, d2, pen2, kp1, kp2, maxd2)
    if d1.dim() == 3 or d2.dim() == 3:
        return match_raw_batched_plain(d1, rowpen, d2, pen2, kp1, kp2, maxd2)
    return match_raw_plain(d1, rowpen, d2, pen2, kp1, kp2, maxd2)


def padded_operands(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                    max_distance=None):
    """The kernel's operands for one descriptor pair, as `match_raw` takes
    them: rows and columns padded to multiples of 128 (padding masked, as
    the TPU wrapper pads ragged capacities) and the descriptor to a multiple
    of 32 dims (zeros: the distances do not change), the 1e30 mask
    penalties folded into `rowpen` and `pen2` = |d2_j|^2 + penalty, and the
    squared pixel prefilter radius (keypoints None without a prefilter).
    Either side may carry a leading slot axis ((B, N, D) descriptors,
    (B, N) mask, (B, N, 2) keypoints), as `match_raw` takes it."""
    dev = d1.device
    N1_in, N2_in = d1.shape[-2], d2.shape[-2]
    pad1 = -(-N1_in // TILE_M) * TILE_M - N1_in
    pad2 = -(-N2_in // TILE_N) * TILE_N - N2_in
    padd = -d1.shape[-1] % _BK
    F = torch.nn.functional
    if mask1 is None:
        mask1 = torch.ones(d1.shape[:-1], dtype=torch.bool, device=dev)
    if mask2 is None:
        mask2 = torch.ones(d2.shape[:-1], dtype=torch.bool, device=dev)
    d1 = F.pad(d1.float(), (0, padd, 0, pad1)).contiguous()
    d2 = F.pad(d2.float(), (0, padd, 0, pad2)).contiguous()
    mask1 = F.pad(mask1, (0, pad1))  # padding is False: BIG row penalty
    mask2 = F.pad(mask2, (0, pad2))
    zero = torch.zeros((), device=dev)
    big = torch.full((), BIG, device=dev)
    rowpen = torch.where(mask1, zero, big).contiguous()
    pen2 = (torch.sum(d2 * d2, dim=-1) + torch.where(mask2, zero, big)).contiguous()
    if max_distance is None or kp1 is None or kp2 is None:
        return d1, rowpen, d2, pen2, None, None, None
    kp1 = F.pad(kp1.float(), (0, 0, 0, pad1)).contiguous()
    kp2 = F.pad(kp2.float(), (0, 0, 0, pad2)).contiguous()
    return d1, rowpen, d2, pen2, kp1, kp2, float(max_distance) ** 2


def _ratio_cross_check(raw, rowpen, ratio, cross_check, n1):
    """The wrapper's ratio test, mutual cross-check and mask on the raw
    2-NN statistics, per slot along the last axis (as the TPU wrapper runs
    them in XLA around the pallas_call). Returns (matches int32 or -1,
    valid), cut to the n1 real rows."""
    row_arg, r_best, r_second, col_arg, c_best, c_second = raw
    r2 = ratio * ratio
    ok = (r_best < r2 * r_second) & (r_best < BIG * 0.1)
    row_arg = row_arg.long()
    if cross_check:
        rows = torch.arange(row_arg.shape[-1], device=row_arg.device)
        mutual = torch.gather(col_arg.long(), -1, row_arg) == rows
        col_ok = c_best < r2 * c_second
        ok = ok & mutual & torch.gather(col_ok, -1, row_arg)
    ok = ok & (rowpen == 0)  # masked and padding rows never match
    matches = torch.where(ok, row_arg, torch.full_like(row_arg, -1)).to(torch.int32)
    return matches[..., :n1], ok[..., :n1]


def match_brute_force_cuda(d1, d2, mask1=None, mask2=None, kp1=None, kp2=None,
                           ratio=0.9, max_distance=None, cross_check=True):
    """Fused drop-in for ops.matching.match_brute_force (2-NN + Lowe ratio
    both directions, symmetric cross-check, optional pixel-distance
    prefilter). Returns (matches (N1,) int32 or -1, valid (N1,)). With a
    leading slot axis on either side (see padded_operands) it is one
    batched K1 launch, then the ratio test and cross-check slot by slot,
    and returns (matches (B, N1), valid (B, N1))."""
    ops = padded_operands(d1, d2, mask1, mask2, kp1, kp2, max_distance)
    return _ratio_cross_check(match_raw(*ops), ops[1], ratio, cross_check, d1.shape[-2])
