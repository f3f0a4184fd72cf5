"""Vocabulary tree: hierarchical k-means quantization, batched.

Port of mavmap_tpu/loop/voctree.py (reference src/loop/voc_tree.{h,cc}).
The tree is a complete K^L array — `centers[level]` has K^level * K rows —
so descent is index arithmetic plus one batched argmin per level for all
descriptors at once, on the tree's device. Training (hierarchical k-means)
and the npz / reference-binary I/O are host numpy, copied from the JAX
package so that one seed trains the same tree in both packages.

Descriptors are L2-normalized float32; distances are squared L2 through
the matmul identity, in full f32 (the package turns TF32 off).
"""

import numpy as np
import torch

from ..utils.timer import sync


class VocTree:
    def __init__(self, centers_per_level, branching, depth, device="cuda"):
        """centers_per_level: list of (K^(l+1), D) arrays, l = 0..depth-1;
        device: where the centers live and quantize runs."""
        self.branching = branching
        self.depth = depth
        self.device = torch.device(device)
        self.centers = [torch.as_tensor(np.array(c, np.float32), device=self.device)
                        for c in centers_per_level]
        self.num_words = branching**depth
        self.descriptor_dim = self.centers[0].shape[1]

    def quantize(self, descriptors, mask=None):
        """(N, D) descriptors (numpy or a tensor on any device) -> (N,) int32
        visual-word ids on the tree's device, -1 where mask is False.

        Batched tree descent (reference voc_tree.cc:95-131 does this one
        descriptor at a time)."""
        # Host inputs are copied to the device (a host sync each).
        sync(int(not torch.is_tensor(descriptors))
             + int(mask is not None and not torch.is_tensor(mask)))
        desc = torch.as_tensor(descriptors, dtype=torch.float32).to(self.device)
        node = torch.zeros(desc.shape[0], dtype=torch.int64, device=self.device)
        ks = torch.arange(self.branching, device=self.device)
        for C in self.centers:
            base = node * self.branching
            cc = C[base[:, None] + ks[None, :]]  # (N, K, D)
            d = torch.sum(cc * cc, dim=-1) - 2.0 * torch.einsum("nd,nkd->nk", desc, cc)
            node = base + torch.argmin(d, dim=-1)  # first index on ties
        if mask is not None:
            mask = torch.as_tensor(mask).to(self.device)
            node = torch.where(mask, node, torch.full_like(node, -1))
        return node.to(torch.int32)

    def save(self, path):
        np.savez(path, branching=self.branching, depth=self.depth,
                 **{f"level_{i}": c.cpu().numpy() for i, c in enumerate(self.centers)})

    @staticmethod
    def load(path, device="cuda"):
        data = np.load(path)
        depth = int(data["depth"])
        centers = [data[f"level_{i}"] for i in range(depth)]
        return VocTree(centers, int(data["branching"]), depth, device=device)

    @staticmethod
    def load_reference_binary(path, device="cuda"):
        """Load a voc-tree binary in the reference's format (--voc-tree-path,
        voc_tree.cc:28-82): int32 header (visualwords, levels, splits,
        nrcenters), nrcenters x 128 uint8 centroids in breadth-first
        complete-tree order, nrcenters uint8 cellinfo.

        uint8 centroids map back to the detector's float range with the
        inverse of the reference's conversion (detection.cc:107-110:
        floor(d * 127 + 127)); an affine map leaves every nearest-center
        decision unchanged. Only complete trees are supported (cellinfo
        early-termination flags are ignored)."""
        with open(path, "rb") as f:
            visualwords, levels, splits, nrcenters = (
                int(v) for v in np.fromfile(f, np.int32, 4))
            if not (0 < levels <= 10 and 1 < splits <= 100000):
                raise ValueError("corrupt voc-tree binary (header sanity)")
            expected = sum(splits ** (l + 1) for l in range(levels))
            if nrcenters != expected:
                raise ValueError(
                    f"corrupt voc-tree binary: nrcenters={nrcenters}, "
                    f"expected {expected} for a complete {splits}^{levels} tree")
            voc = np.fromfile(f, np.uint8, nrcenters * 128)
            if voc.size != nrcenters * 128:
                raise ValueError("corrupt voc-tree binary (truncated centers)")
        voc = (voc.reshape(nrcenters, 128).astype(np.float32) - 127.0) / 127.0
        centers = []
        pos = 0
        for l in range(int(levels)):
            n = int(splits) ** (l + 1)
            centers.append(voc[pos: pos + n])
            pos += n
        if pos != int(nrcenters):
            raise ValueError("voc-tree binary size mismatch (incomplete tree?)")
        return VocTree(centers, int(splits), int(levels), device=device)

    def save_reference_binary(self, path):
        """Write the reference's binary format (inverse of
        load_reference_binary; centers clipped to the uint8 range)."""
        flat = np.concatenate([c.cpu().numpy() for c in self.centers])
        voc = np.clip(np.floor(flat * 127.0 + 127.0), 0, 255).astype(np.uint8)
        n = voc.shape[0]
        with open(path, "wb") as f:
            np.asarray([self.num_words, self.depth, self.branching, n], np.int32).tofile(f)
            voc.tofile(f)
            np.zeros((n,), np.uint8).tofile(f)  # cellinfo: complete tree


def train_voc_tree(descriptors, branching=8, depth=3, iters=8, seed=0, device="cuda"):
    """Hierarchical k-means on (M, D) training descriptors -> VocTree on
    `device`. Host numpy, the JAX package's algorithm and draws: the same
    seed gives the same centers.

    Level-parallel Lloyd iterations: all nodes of a level are refined in one
    pass (assignments via the current partial quantization)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.float32)
    M, D = desc.shape

    centers_per_level = []
    # assignment of each training descriptor to a node index at current level
    assign = np.zeros(M, np.int64)
    num_nodes = 1
    for l in range(depth):
        K = branching
        new_centers = np.zeros((num_nodes * K, D), np.float32)
        for node in range(num_nodes):
            sel = desc[assign == node]
            if len(sel) == 0:
                new_centers[node * K: (node + 1) * K] = rng.normal(size=(K, D)).astype(
                    np.float32)
                continue
            # k-means init: random distinct samples.
            init_idx = rng.choice(len(sel), size=min(K, len(sel)), replace=False)
            C = np.zeros((K, D), np.float32)
            C[: len(init_idx)] = sel[init_idx]
            if len(init_idx) < K:
                C[len(init_idx):] = sel[rng.integers(0, len(sel), K - len(init_idx))]
            for _ in range(iters):
                d = np.sum(C * C, axis=1)[None, :] - 2.0 * sel @ C.T
                a = np.argmin(d, axis=1)
                for k in range(K):
                    pts = sel[a == k]
                    if len(pts):
                        C[k] = pts.mean(axis=0)
            new_centers[node * K: (node + 1) * K] = C
        centers_per_level.append(new_centers)
        # Re-assign all descriptors one level deeper.
        child = np.zeros(M, np.int64)
        for node in range(num_nodes):
            m = assign == node
            if not m.any():
                continue
            C = new_centers[node * K: (node + 1) * K]
            d = np.sum(C * C, axis=1)[None, :] - 2.0 * desc[m] @ C.T
            child[m] = node * K + np.argmin(d, axis=1)
        assign = child
        num_nodes *= K

    return VocTree(centers_per_level, branching, depth, device=device)
