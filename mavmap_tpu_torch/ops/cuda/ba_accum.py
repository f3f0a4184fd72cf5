"""BA segment sums: CUDA kernels K2/K3 (csrc/ba_accum.cu) and their wrappers.

  seg_accum_full   — out[s] = sum over o with seg_ids[o] == s of contrib[o],
                     ids in any order. Replaces the Pallas one-hot kernel
                     mavmap_tpu/ops/pallas/ba_accum.py seg_accum_full
                     (_full_kernel). Shared-memory accumulation per
                     (observation chunk, segment tile), then global atomics:
                     the order of the sums varies from run to run.
  seg_accum_sorted — the same sum for rows sorted by a gapless dense id,
                     given as CSR offsets (rows offsets[s]:offsets[s+1] form
                     segment s). Replaces the banded Pallas kernel
                     seg_accum_sorted (_sorted_kernel) and its carry/gather
                     epilogue (gather_rows_for_sorted): the host builds the
                     offsets with the problem, so the kernel is a plain
                     deterministic segmented reduction.

Both launch the kernel for CUDA tensors and run the plain PyTorch version
(index_add_) for CPU tensors. On an H100 both are bound by one read of the
(O, K) contributions (per segment tile for seg_accum_full).
"""

import numpy as np
import torch

from . import build


def offsets_from_sorted_ids(seg_ids, num_segments, num_rows=None):
    """Host: CSR offsets (num_segments + 1,) int32 of sorted segment ids.

    Only the first `num_rows` rows (default: all) belong to segments; rows
    after them (bucket padding) are left out of every segment."""
    seg_ids = np.asarray(seg_ids)
    if num_rows is not None:
        seg_ids = seg_ids[:num_rows]
    return np.searchsorted(seg_ids, np.arange(num_segments + 1),
                           side="left").astype(np.int32)


def seg_accum_full_plain(contrib, seg_ids, num_segments):
    """Plain PyTorch version of seg_accum_full (ids outside [0, S) dropped)."""
    ids = seg_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, contrib.shape[1]), dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(0, ids[keep], contrib[keep].float())


def _seg_accum_full_cuda(contrib, seg_ids, num_segments):
    dev = contrib.device
    build.require(contrib, "contrib", torch.float32, 2, dev)
    build.require(seg_ids, "seg_ids", torch.int32, 1, dev)
    O, K = contrib.shape
    if seg_ids.shape[0] != O:
        raise ValueError(f"seg_ids: {seg_ids.shape[0]} rows, contrib has {O}")
    if K > 24576:
        raise ValueError(f"seg_accum_full: K={K} exceeds the 96 KB accumulator")
    out = torch.zeros((num_segments, K), dtype=torch.float32, device=dev)
    build.check(build.library().mavmap_seg_accum_full(
        contrib.data_ptr(), seg_ids.data_ptr(), O, K, int(num_segments),
        out.data_ptr(), build.stream_ptr(dev)), "mavmap_seg_accum_full")
    build.launches["seg_accum_full"] += 1
    return out


def seg_accum_full(contrib, seg_ids, num_segments):
    """out[s, :] = sum over o with seg_ids[o] == s of contrib[o, :].

    contrib: (O, K) f32; seg_ids: (O,) int32, any order."""
    if contrib.is_cuda:
        return _seg_accum_full_cuda(contrib, seg_ids, num_segments)
    return seg_accum_full_plain(contrib, seg_ids, num_segments)


def seg_accum_sorted_plain(contrib, offsets, num_segments):
    """Plain PyTorch version of seg_accum_sorted."""
    counts = (offsets[1:] - offsets[:-1]).long()
    ids = torch.repeat_interleave(
        torch.arange(num_segments, device=contrib.device), counts)
    lo = int(offsets[0])
    rows = contrib[lo: lo + ids.shape[0]].float()
    out = torch.zeros((num_segments, contrib.shape[1]), dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(0, ids, rows)


def _seg_accum_sorted_cuda(contrib, offsets, num_segments):
    dev = contrib.device
    build.require(contrib, "contrib", torch.float32, 2, dev)
    build.require(offsets, "offsets", torch.int32, 1, dev)
    if offsets.shape[0] != num_segments + 1:
        raise ValueError(f"offsets: {offsets.shape[0]} entries for "
                         f"{num_segments} segments")
    K = contrib.shape[1]
    out = torch.empty((num_segments, K), dtype=torch.float32, device=dev)
    build.check(build.library().mavmap_seg_accum_sorted(
        contrib.data_ptr(), offsets.data_ptr(), int(num_segments), K,
        out.data_ptr(), build.stream_ptr(dev)), "mavmap_seg_accum_sorted")
    build.launches["seg_accum_sorted"] += 1
    return out


def seg_accum_sorted(contrib, offsets, num_segments):
    """Segment sums of rows grouped by CSR offsets (num_segments + 1,) int32:
    out[s] = sum of contrib[offsets[s]:offsets[s+1]]."""
    if contrib.is_cuda:
        return _seg_accum_sorted_cuda(contrib, offsets, num_segments)
    return seg_accum_sorted_plain(contrib, offsets, num_segments)
