"""Brute-force matching of many image pairs, the pairs split over ranks.

Port of mavmap_tpu/parallel/dist_match.py: a (B, F, D) batch of
descriptor pairs is split in rank order into blocks of ceil(B / N) pairs;
each rank matches its block in one batched K1 launch (the JAX version's
vmap of the matcher under shard_map), and the blocks are gathered, so every
rank returns all B pairs' matches. A slot's matches do not depend on the
other slots of its launch, so they equal the unsharded batch's.
"""

import torch

from ..ops.matching import match_features_batched


def dist_match_pairs(mesh, d1, d2, mask1, mask2, ratio=0.9, axis="obs", matcher="pallas"):
    """d1, d2: (B, F, D) descriptor batches; masks: (B, F); axis: the
    mesh's axis name, as in the JAX package (the pairs split over the
    ranks); matcher: the matcher backend (ops/matching.py). Returns
    (matches (B, F) int32, valid (B, F) bool) on every rank."""
    if axis != mesh.axis:
        raise ValueError(f"dist_match_pairs: axis {axis!r}, the mesh's is {mesh.axis!r}")
    B, F = d1.shape[0], d1.shape[1]
    lo, hi = mesh.block(B)
    if hi > lo:
        matches, valid = match_features_batched(d1[lo:hi], d2[lo:hi], mask1[lo:hi],
                                                mask2[lo:hi], ratio=ratio, backend=matcher)
    else:
        matches = torch.zeros((0, F), dtype=torch.int32, device=d1.device)
        valid = torch.zeros((0, F), dtype=torch.bool, device=d1.device)
    return mesh.gather_blocks(matches, B), mesh.gather_blocks(valid, B)
