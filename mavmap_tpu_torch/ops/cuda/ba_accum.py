"""BA segment sums: CUDA kernels K2/K3 (csrc/ba_accum.cu) and their wrappers.

  seg_accum_full   — out[s] = sum over o with seg_ids[o] == s of contrib[o],
                     ids in any order, ids outside [0, S) dropped. Replaces
                     the Pallas one-hot kernel mavmap_tpu/ops/pallas/
                     ba_accum.py seg_accum_full (_full_kernel). A host plan
                     (`make_plan`, built once per BA problem) sorts the rows
                     by id and cuts each segment into pieces of at most
                     PIECE_ROWS rows; pass 1 sums each piece, pass 2 each
                     segment's pieces, both in a fixed order: no atomics, no
                     memset, and the same bits on every run. A plan whose
                     longest segment is short for its segment count
                     (one_pass_limit: the dense steps' per-(point, block)
                     plans, the per-point plan) takes one pass instead:
                     K3's kernel with the rows gathered through the plan's
                     order, which adds them in plan order from 0.0 and so
                     gives the bits of the planned plain version run on
                     the CPU.
  seg_accum_sorted — the same sum for rows sorted by a gapless dense id,
                     given as CSR offsets (rows offsets[s]:offsets[s+1] form
                     segment s). Replaces the banded Pallas kernel
                     seg_accum_sorted (_sorted_kernel) and its carry/gather
                     epilogue (gather_rows_for_sorted): the host builds the
                     offsets with the problem; one thread per (segment,
                     column) loads the segment's rows in batches of eight,
                     all in flight, and adds them in row order, so the
                     kernel gives the bits of the plain version run on the
                     CPU.

Both launch the kernel for CUDA tensors and run the plain PyTorch version
(index_add_) for CPU tensors. Given a plan, seg_accum_full sums by the plan
alone on either device (the CPU reads each row's segment off the plan's
pieces), so the plan is the one key of every planned call. On an H100 both
are bound by one read of the (O, K) contributions.
"""

from typing import NamedTuple

import numpy as np
import torch

from ...utils.timer import sync
from . import build

PIECE_ROWS = 256  # rows per piece, one pass-1 block each (csrc/ba_accum.cu)
# The path of a plan (one_pass_limit). One pass costs ~80 ns per row of
# the longest segment (its thread adds them one after another) and two
# passes ~4.5 µs plus ~2.3 ns per segment (pass 2 gives each a block), so
# one pass is taken while the longest segment has at most
# ONE_PASS_ROWS + S // ONE_PASS_SEGMENTS_PER_ROW rows. Measured with
# benchmarks/torch_k2_paths.py (NVIDIA H100 80GB HBM3, 700.00 W), one pass
# against two, µs at K = 54: 32768 rows in segments of 32 / 64 / 128 rows
# (S = 1024 / 512 / 256) 4.31 / 6.66 / 11.67 against 5.75 / 5.26 / 5.21;
# one segment of 64 / 128 / 256 / 512 rows among ~8170 of 4 rows 6.25 /
# 10.84 / 19.66 / 37.53 against 20.23 / 20.33 / 20.18 / 20.24. At every
# plan it timed, and at every shape chip_smoke.py times, the path taken
# was the faster (PERF.md §6).
ONE_PASS_ROWS = 32
ONE_PASS_SEGMENTS_PER_ROW = 32


def one_pass_limit(num_segments):
    """The most rows a plan of `num_segments` segments may have in one
    segment and still take the one-pass path."""
    return ONE_PASS_ROWS + num_segments // ONE_PASS_SEGMENTS_PER_ROW


class SegPlan(NamedTuple):
    """The host plan of seg_accum_full for one id array: numpy arrays from
    `make_plan`; `to(device)` moves the three that the kernel reads.

    order         (N,) int32: the rows whose id lies in [0, S), stably
                  sorted by id (the JAX problem's by-image sort, img_order,
                  plays this part there);
    seg_offsets   (S + 1,) int32: segment s is order[seg_offsets[s]:
                  seg_offsets[s + 1]] (read by the one-pass kernel, so
                  moved to the device for one-pass plans only);
    piece_starts  (n_pieces + 1,) int32: piece p is order[piece_starts[p]:
                  piece_starts[p + 1]], at most PIECE_ROWS rows, never
                  across two segments;
    seg_pieces    (S + 1,) int32: segment s is pieces seg_pieces[s]:
                  seg_pieces[s + 1] (none for an empty segment);
    filled        (Z,) int32: the non-empty segments, ascending;
    filled_offsets (Z + 1,) int32: their CSR offsets into order (a
                  gapless view of seg_offsets); these two are what the
                  one-pass kernel reads on a `sparse` plan;
    num_rows      rows of the id array, which the contributions must have;
    max_pieces    the most pieces of one segment (sizes pass 2's blocks);
    one_pass      the kernel's path: True when no segment has more than
                  one_pass_limit(S) rows (one launch of the gathering
                  seg_rows_kernel), else the two passes.

    A one-pass plan is `sparse` when more than half its segments are empty:
    then the output is zeroed and the kernel runs over the filled segments
    alone (csrc/ba_accum.cu: a thread of an empty segment would wait for
    its offsets only to write a zero). Both follow from the plan alone.
    """

    order: object
    seg_offsets: object
    piece_starts: object
    seg_pieces: object
    filled: object
    filled_offsets: object
    num_rows: int
    max_pieces: int
    one_pass: bool

    @property
    def num_segments(self):
        return self.seg_pieces.shape[0] - 1

    @property
    def sparse(self):
        return self.one_pass and 2 * self.filled.shape[0] < self.num_segments

    def to(self, device):
        fields = ("order", "piece_starts", "seg_pieces") + (
            ("seg_offsets", "filled", "filled_offsets") if self.one_pass else ())
        sync(sum(getattr(self, f).size > 0 for f in fields))  # a blocking copy each
        return self._replace(**{f: torch.as_tensor(getattr(self, f), device=device)
                                for f in fields})


def make_plan(seg_ids, num_segments):
    """Host: the SegPlan of `seg_ids` (any order) into `num_segments`
    segments. Ids outside [0, num_segments) are left out."""
    ids = np.asarray(seg_ids).astype(np.int64)
    kept = np.flatnonzero((ids >= 0) & (ids < num_segments))
    key = ids[kept]
    # A stable sort; numpy's is a radix sort for 16-bit keys.
    order = kept[np.argsort(key.astype(np.uint16) if num_segments <= 1 << 16 else key,
                            kind="stable")]
    counts = np.bincount(key, minlength=num_segments)
    seg_offsets = np.concatenate([[0], np.cumsum(counts)])
    n_pieces = -(-counts // PIECE_ROWS)
    seg_pieces = np.concatenate([[0], np.cumsum(n_pieces)])
    piece_seg = np.repeat(np.arange(num_segments), n_pieces)
    rank = np.arange(len(piece_seg)) - seg_pieces[piece_seg]  # piece's rank in its segment
    piece_starts = np.append(seg_offsets[piece_seg] + rank * PIECE_ROWS, len(order))
    filled = np.flatnonzero(counts)
    return SegPlan(order=order.astype(np.int32), seg_offsets=seg_offsets.astype(np.int32),
                   piece_starts=piece_starts.astype(np.int32),
                   seg_pieces=seg_pieces.astype(np.int32), filled=filled.astype(np.int32),
                   filled_offsets=np.append(seg_offsets[filled], len(order)).astype(np.int32),
                   num_rows=len(ids),
                   max_pieces=int(n_pieces.max(initial=0)),
                   one_pass=bool(counts.max(initial=0) <= one_pass_limit(num_segments)))


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
    """Plain PyTorch version of seg_accum_full (ids outside [0, S) dropped).

    Dropped rows land on a spare last row instead of being masked out, so
    the host never waits for the device (a CUDA graph can hold the call)."""
    ids = seg_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1, contrib.shape[1]), dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(0, ids, contrib.float())[:num_segments]


def seg_accum_planned_plain(contrib, plan):
    """Plain PyTorch version of seg_accum_full keyed by a plan (tensors on
    contrib's device): each kept row's segment is read off the plan's
    pieces, the arrays that the kernel reads, and the rows are summed by
    index_add_. No host sync (the output sizes come from the shapes)."""
    dev = contrib.device
    n_pieces = plan.piece_starts.shape[0] - 1
    piece_seg = torch.repeat_interleave(torch.arange(plan.num_segments, device=dev),
                                        plan.seg_pieces.diff().long(), output_size=n_pieces)
    row_seg = torch.repeat_interleave(piece_seg, plan.piece_starts.diff().long(),
                                      output_size=plan.order.shape[0])
    out = torch.zeros((plan.num_segments, contrib.shape[1]), dtype=torch.float32, device=dev)
    return out.index_add_(0, row_seg, contrib[plan.order.long()].float())


def _seg_accum_one_pass_cuda(contrib, plan):
    dev = contrib.device
    build.require(contrib, "contrib", torch.float32, 2, dev)
    K = contrib.shape[1]
    S = plan.num_segments
    sparse = plan.sparse
    names = ("order", "filled", "filled_offsets") if sparse else ("order", "seg_offsets")
    for name in names:
        build.require(getattr(plan, name), f"plan.{name}", torch.int32, 1, dev)
    rows, offsets = (plan.filled, plan.filled_offsets) if sparse else (None, plan.seg_offsets)
    n = plan.filled.shape[0] if sparse else S
    if offsets.shape[0] != n + 1:
        raise ValueError(f"seg_accum_full: {offsets.shape[0]} segment offsets for {n} "
                         f"segments")
    if S * K >= 1 << 31:
        raise ValueError(f"seg_accum_full: {S} x {K} sums, the one-pass kernel indexes "
                         f"fewer than 2^31")
    out = torch.empty((S, K), dtype=torch.float32, device=dev)
    build.check(build.library().mavmap_seg_accum_one_pass(
        contrib.data_ptr(), plan.order.data_ptr(), offsets.data_ptr(),
        rows.data_ptr() if sparse else None, int(sparse), n, S, K, out.data_ptr(),
        build.stream_ptr(dev)),
        "mavmap_seg_accum_one_pass")
    build.launches["seg_accum_full"] += 1
    build.launches["seg_accum_full_one_pass"] += 1
    return out


def _seg_accum_full_cuda(contrib, plan):
    if plan.one_pass:
        return _seg_accum_one_pass_cuda(contrib, plan)
    dev = contrib.device
    build.require(contrib, "contrib", torch.float32, 2, dev)
    for name in ("order", "piece_starts", "seg_pieces"):
        build.require(getattr(plan, name), f"plan.{name}", torch.int32, 1, dev)
    n_pieces = plan.piece_starts.shape[0] - 1
    K = contrib.shape[1]
    S = plan.num_segments
    partial = torch.empty((n_pieces, K), dtype=torch.float32, device=dev)
    out = torch.empty((S, K), dtype=torch.float32, device=dev)
    build.check(build.library().mavmap_seg_accum_full(
        contrib.data_ptr(), plan.order.data_ptr(), plan.piece_starts.data_ptr(), n_pieces,
        plan.seg_pieces.data_ptr(), S, K, int(plan.max_pieces),
        partial.data_ptr(), out.data_ptr(), build.stream_ptr(dev)), "mavmap_seg_accum_full")
    build.launches["seg_accum_full"] += 1
    return out


def seg_accum_full(contrib, seg_ids, num_segments, plan=None):
    """out[s, :] = sum over o with seg_ids[o] == s of contrib[o, :].

    contrib: (O, K) f32; seg_ids: (O,) int32 in any order, or None with a
    plan. `plan` is the SegPlan of the ids on contrib's device
    (make_plan(...).to); given one, the sum goes by the plan alone and the
    ids are not read, on either device. A CUDA call needs the plan and
    raises without one: the sort is host work, done once per problem. A
    CPU call without one runs the plain version on the ids."""
    if plan is not None:
        if plan.num_rows != contrib.shape[0] or plan.num_segments != num_segments:
            raise ValueError(f"seg_accum_full: a plan of {plan.num_rows} rows into "
                             f"{plan.num_segments} segments for {tuple(contrib.shape)} -> "
                             f"{num_segments}")
        if contrib.is_cuda:
            return _seg_accum_full_cuda(contrib, plan)
        return seg_accum_planned_plain(contrib, plan)
    if contrib.is_cuda:
        raise ValueError("seg_accum_full: a CUDA call needs the ids' plan "
                         "(make_plan on the host, then .to(device))")
    return seg_accum_full_plain(contrib, seg_ids, num_segments)


def seg_accum_sorted_plain(contrib, offsets, num_segments):
    """Plain PyTorch version of seg_accum_sorted. Each row's segment is
    found by a search of the offsets, and index_add_ adds the rows; on the
    CPU it adds them one index after another, from 0, the kernel's order,
    so the two agree bit for bit. Rows outside offsets[0]:offsets[-1] land
    on a spare last row (no host sync, as in seg_accum_full_plain)."""
    rows = torch.arange(contrib.shape[0], device=contrib.device)
    ids = torch.searchsorted(offsets.long(), rows, right=True) - 1
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1, contrib.shape[1]), dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(0, ids, contrib.float())[:num_segments]


def _seg_accum_sorted_cuda(contrib, offsets, num_segments):
    dev = contrib.device
    build.require(contrib, "contrib", torch.float32, 2, dev)
    build.require(offsets, "offsets", torch.int32, 1, dev)
    K = contrib.shape[1]
    if num_segments * K >= 1 << 31:
        raise ValueError(f"seg_accum_sorted: {num_segments} x {K} sums, the kernel "
                         f"indexes fewer than 2^31")
    out = torch.empty((num_segments, K), dtype=torch.float32, device=dev)
    build.check(build.library().mavmap_seg_accum_sorted(
        contrib.data_ptr(), offsets.data_ptr(), int(num_segments), K,
        out.data_ptr(), build.stream_ptr(dev)), "mavmap_seg_accum_sorted")
    build.launches["seg_accum_sorted"] += 1
    return out


def seg_accum_sorted(contrib, offsets, num_segments):
    """Segment sums of rows grouped by CSR offsets (num_segments + 1,) int32:
    out[s] = sum of contrib[offsets[s]:offsets[s+1]], added in row order."""
    if offsets.shape[0] != num_segments + 1:
        raise ValueError(f"offsets: {offsets.shape[0]} entries for {num_segments} segments")
    if contrib.is_cuda:
        return _seg_accum_sorted_cuda(contrib, offsets, num_segments)
    return seg_accum_sorted_plain(contrib, offsets, num_segments)
