"""The mapper's batched fan-outs with their slots split over ranks.

Port of mavmap_tpu/parallel/dist_register.py. The back-fill pairs, the
loop-closure candidates and the closure sweeps' pairs (register_view_pairs,
register_view_batch) and the loop-closure pre-gate's match counts are
data-parallel over slots: the n slots of a step are split in rank order
into blocks of ceil(n / N); each rank runs the batched step on its block
(one K1 launch, then the geometry over its slots), and the blocks are
gathered, so every rank commits all n results. The reference pays a full
sequential process() per pair (mapper.cc:221-299,
sequential_mapper.cc:1182-1211).

RANSAC draws its samples from the mapper's generator slot by slot. Every
rank draws the uniforms of all n slots in slot order and keeps its own
block's (ops/ransac.py draw_samples, block=), so each rank's generator
advances exactly as a one-rank run's, and each slot draws what it draws
there. A slot's floats do not depend on the other slots of its step
(ops/reduce.py), so a sharded step gives every slot the unsharded step's
bits.
"""

import torch

from ..ops.matching import match_features_batched
from ..ops.ransac import draw_samples
from ..sfm.kernels import register_view_batch, register_view_pairs


# The arguments of each batched step (after the generator) that carry the
# slot axis; the others are every slot's.
SLOT_ARGS = {
    # kpp .. kparams, model_code, norm_threshold
    register_view_pairs: frozenset(range(15)) | {17},
    # the candidates' kpp, desc_p, mask_p, np_ and their track state
    register_view_batch: frozenset((0, 1, 2, 3, 8, 9, 10, 11, 12)),
}


def dist_step(mesh, step, generator, *args, p3p_trials=500, hom_trials=128, refine_iters=30,
              samples=None, matcher="pallas"):
    """`step` (register_view_pairs or register_view_batch) with its n slots
    split over `mesh`'s ranks: the arguments are given whole, each rank runs
    its block of the slot-axis ones (SLOT_ARGS) and of `samples`. A rank
    with no slot still draws every slot's samples. Returns (rows (n, F, 12),
    scalars (n, 13)) on every rank."""
    kpp = args[0]
    n, F = kpp.shape[0], kpp.shape[1]
    lo, hi = mesh.block(n)
    if hi > lo:
        slotted = SLOT_ARGS[step]
        block = [a[lo:hi] if k in slotted else a for k, a in enumerate(args)]
        rows, scalars = step(generator, *block, p3p_trials=p3p_trials, hom_trials=hom_trials,
                             refine_iters=refine_iters,
                             samples=None if samples is None else [s[lo:hi] for s in samples],
                             draw_block=(lo, n), matcher=matcher)
    else:
        if samples is None:
            none = torch.zeros((0, F), dtype=torch.bool, device=kpp.device)
            draw_samples(generator, [(hom_trials, 4, none), (p3p_trials, 4, none)], (lo, n))
        rows = torch.zeros((0, F, 12), device=kpp.device)
        scalars = torch.zeros((0, 13), device=kpp.device)
    return mesh.gather_blocks(rows, n), mesh.gather_blocks(scalars, n)


def dist_register_view_pairs(mesh, generator, *args, **kw):
    """register_view_pairs with its pairs split over `mesh`'s ranks (see
    dist_step)."""
    return dist_step(mesh, register_view_pairs, generator, *args, **kw)


def dist_register_view_batch(mesh, generator, *args, **kw):
    """register_view_batch (one current image against B candidates) with
    the candidates split over `mesh`'s ranks (see dist_step)."""
    return dist_step(mesh, register_view_batch, generator, *args, **kw)


def dist_match_counts(mesh, dq, mq, dstack, mstack, ratio, matcher="pallas"):
    """The loop-closure pre-gate's match counts of one query (dq (F, D), mq
    (F,)) against B candidates (dstack (B, F, D), mstack (B, F)), the
    candidates split over `mesh`'s ranks. Returns (B,) counts on every
    rank."""
    n = dstack.shape[0]
    lo, hi = mesh.block(n)
    if hi > lo:
        _, ok = match_features_batched(dq, dstack[lo:hi], mq, mstack[lo:hi], ratio=ratio,
                                       backend=matcher)
        counts = torch.sum(ok, dim=-1)
    else:
        counts = torch.zeros(0, dtype=torch.int64, device=dstack.device)
    return mesh.gather_blocks(counts, n)
