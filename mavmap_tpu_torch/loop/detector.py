"""LoopDetector: TF-IDF image retrieval over vocabulary-tree words.

Port of mavmap_tpu/loop/detector.py (reference src/loop/{detection,
voc_tree_inv_file,voc_tree_database}.{h,cc}). Quantization runs on the
vocabulary tree's device; the scoring is host numpy f32 in both modes,
copied from the JAX package so that the rankings are the same:

- dense: bag-of-words matrix (images x words); a query is one idf-weighted
  matrix-vector product (vocabularies up to 65536 words);
- sparse: per-image posting lists scored through the query words'
  postings only — O(total postings) memory, the reference's complexity
  (voc_tree_inv_file.cc:169-328), for published ~1M-leaf trees.

Scores follow the reference's convention: 0 = identical, 2 = orthogonal
(squared L2 distance of L2-normalized tf-idf vectors,
voc_tree_inv_file.h:9-44).
"""

import numpy as np
import torch

from ..utils.timer import sync

MAX_NUM_VISUAL_WORDS = 5000  # per image, reference sequential_mapper.h:53

# Vocabularies up to this many words use the dense score path; larger ones
# use posting lists (4 bytes/word/image vs 8 bytes/posting).
DENSE_SCORE_MAX_WORDS = 1 << 16


class LoopDetector:
    def __init__(self, voc_tree, capacity_step=256, score_mode="auto"):
        self.voc_tree = voc_tree
        self.num_words = voc_tree.num_words
        self.capacity_step = capacity_step
        if score_mode == "auto":
            score_mode = "dense" if self.num_words <= DENSE_SCORE_MAX_WORDS else "sparse"
        self.score_mode = score_mode
        self._bow = np.zeros((0, self.num_words if score_mode == "dense" else 0),
                             np.float32)  # raw tf counts (dense)
        # Sparse inverted file: per-image (words, tf) postings, concatenated
        # and word-sorted lazily per query burst.
        self._post_words = []   # list of (U,) int64 unique words per image
        self._post_tfs = []     # list of (U,) f32 term frequencies
        self._df = np.zeros(self.num_words, np.int32)  # document frequency
        self._inv = None        # cached (sorted_words, img_ids, tfs)
        self._image_idxs = []
        self._idx_to_slot = {}
        # Forward file: per-image sorted unique visual words + the keypoint
        # of (the first occurrence of) each word — the reference's
        # VocTreeDatabase forward blocks (voc_tree_database.cc:84-108).
        self._forward = {}
        self._words_cache = {}
        # Images added but not quantized yet: the next query or forward
        # access quantizes all of them in batched calls.
        self._pending = {}

    @property
    def num_images(self):
        return len(self._image_idxs) + len(self._pending)

    def _quantize_raw(self, features, image_idx=None):
        """Per-keypoint visual words (-1 for masked rows), host int32,
        cached per image."""
        if image_idx is not None and image_idx in self._words_cache:
            return self._words_cache[image_idx]
        sync()  # the words' pull
        words = self.voc_tree.quantize(features.descriptors[:MAX_NUM_VISUAL_WORDS],
                                       features.mask[:MAX_NUM_VISUAL_WORDS]).cpu().numpy()
        if image_idx is not None:
            self._words_cache[image_idx] = words
        return words

    def _quantize(self, features, image_idx=None):
        words = self._quantize_raw(features, image_idx)
        return words[words >= 0]

    def _quantize_with_coords(self, features, image_idx=None):
        """(sorted unique words (U,), coords (U, 2)): the first occurrence
        of each word keeps its keypoint (voc_tree_database.cc:111-146)."""
        kp = features.keypoints[:MAX_NUM_VISUAL_WORDS]
        words = self._quantize_raw(features, image_idx)
        sel = words >= 0
        words, kp = words[sel], kp[sel]
        uw, first = np.unique(words, return_index=True)
        return uw, kp[first].astype(np.float32)

    def _bow_of(self, words):
        bow = np.zeros((self.num_words,), np.float32)
        np.add.at(bow, words, 1.0)
        return bow

    def add_image(self, image_idx, features, device_descriptors=None, device_mask=None):
        """Store an image for retrieval (reference detection.cc:36-61).

        Quantization is deferred to the next query or forward access, which
        quantizes every pending image in batched calls. `device_descriptors`
        / `device_mask` (the mapper's tensors of this image) are stacked as
        they are, so the descriptors are not uploaded again."""
        if image_idx in self._idx_to_slot or image_idx in self._pending:
            return
        self._pending[image_idx] = (features, device_descriptors, device_mask)

    # Images per quantization call.
    FLUSH_CHUNK = 32

    def _flush_pending(self):
        if not self._pending:
            return
        all_items = sorted(self._pending.items())
        self._pending = {}
        for c0 in range(0, len(all_items), self.FLUSH_CHUNK):
            self._flush_chunk(all_items[c0:c0 + self.FLUSH_CHUNK])

    def _flush_chunk(self, items):
        if all(d is not None for _, (_, d, _) in items):
            descs = torch.stack([d[:MAX_NUM_VISUAL_WORDS] for _, (_, d, _) in items])
            masks = torch.stack([m[:MAX_NUM_VISUAL_WORDS] for _, (_, _, m) in items])
        else:
            descs = np.stack([f.descriptors[:MAX_NUM_VISUAL_WORDS] for _, (f, _, _) in items])
            masks = np.stack([f.mask[:MAX_NUM_VISUAL_WORDS] for _, (f, _, _) in items])
        K, F, D = descs.shape
        sync()  # the words' pull
        words_all = self.voc_tree.quantize(descs.reshape(K * F, D),
                                           masks.reshape(K * F)).cpu().numpy().reshape(K, F)
        for (image_idx, (f, _, _)), words in zip(items, words_all):
            self._words_cache[image_idx] = words
            self._insert(image_idx, f, words)

    def _insert(self, image_idx, features, words):
        """Index an image whose per-keypoint words are already known (and
        cached in _words_cache)."""
        w = words[words >= 0]
        slot = len(self._image_idxs)
        uw, tf = np.unique(w, return_counts=True)
        self._post_words.append(uw.astype(np.int64))
        self._post_tfs.append(tf.astype(np.float32))
        self._df[uw] += 1
        self._inv = None
        if self.score_mode == "dense":
            if slot >= len(self._bow):
                extra = np.zeros((self.capacity_step, self.num_words), np.float32)
                self._bow = np.concatenate([self._bow, extra], axis=0)
            self._bow[slot] = self._bow_of(w)
        self._idx_to_slot[image_idx] = slot
        self._image_idxs.append(image_idx)
        self._forward[image_idx] = self._quantize_with_coords(features, image_idx)

    def saved_words(self):
        """Per-image quantized words for checkpointing: (image_idxs,
        {idx: per-keypoint words incl. -1 for masked rows}); they rebuild
        postings, idf, the BoW matrix and the forward files without a tree
        descent (restore_image)."""
        self._flush_pending()
        return list(self._image_idxs), dict(self._words_cache)

    def restore_image(self, image_idx, features, words):
        """Re-index a checkpointed image from its saved quantization."""
        if image_idx in self._idx_to_slot or image_idx in self._pending:
            return
        words = np.asarray(words)
        self._words_cache[image_idx] = words
        self._insert(image_idx, features, words)

    def forward_data(self, image_idx):
        """Stored (sorted unique words, coords) of an image — the
        reference's getforwarddata/getdocvw (voc_tree_database.cc:149-164)."""
        self._flush_pending()
        return self._forward[image_idx]

    def match_forward(self, image_idx, features):
        """Visual-word-intersection correspondences between a stored image
        and a query (reference VocTreeDatabase::match,
        voc_tree_database.cc:111-146): keypoints whose descriptors quantize
        to the same word are tentative matches.

        Returns (xy_db (M, 2), xy_query (M, 2))."""
        self._flush_pending()
        vw_db, xy_db = self._forward[image_idx]
        vw_q, xy_q = self._quantize_with_coords(features)
        _, ia, ib = np.intersect1d(vw_db, vw_q, assume_unique=True, return_indices=True)
        return xy_db[ia], xy_q[ib]

    def query(self, features, num_images=30, use_idf=True, image_idx=None):
        """Top-N most similar stored images: (image_idxs (N,), scores (N,))
        with scores in [0, 2], smaller = more similar (reference
        detection.cc:64-93, voc_tree_inv_file.cc:243-328)."""
        self._flush_pending()
        n = self.num_images
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        words = self._quantize(features, image_idx)
        if use_idf:
            idf = (np.log(max(n, 1) / np.maximum(self._df.astype(np.float32), 1.0))
                   + 1e-6).astype(np.float32)
        else:
            idf = np.ones(self.num_words, np.float32)

        if self.score_mode == "dense":
            scores = _score(self._bow_of(words), self._bow[:n], idf)
        else:
            scores = self._score_sparse(words, idf, n)
        k = min(num_images, n)
        top = np.argsort(scores)[:k]
        return np.asarray(self._image_idxs)[top], scores[top]

    def _inverted(self):
        """Word-sorted concatenated postings (words, image_slots, tfs)."""
        if self._inv is None:
            if self._post_words:
                w = np.concatenate(self._post_words)
                img = np.repeat(np.arange(len(self._post_words), dtype=np.int32),
                                [len(x) for x in self._post_words])
                tf = np.concatenate(self._post_tfs)
                order = np.argsort(w, kind="stable")
                self._inv = (w[order], img[order], tf[order])
            else:
                self._inv = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                             np.zeros(0, np.float32))
        return self._inv

    def _score_sparse(self, qwords, idf, n):
        """Posting-list scoring: the dot product touches only the query
        words' postings (reference voc_tree_inv_file.cc:243-328); image
        norms under the current idf are one pass over all postings, so the
        scores equal the dense path's."""
        inv_w, inv_img, inv_tf = self._inverted()
        uw, qtf = np.unique(qwords, return_counts=True)
        qv = qtf.astype(np.float32) * idf[uw]
        qn = np.linalg.norm(qv)
        qv = qv / max(qn, 1e-12)

        vals = inv_tf * idf[inv_w]
        norm2 = np.zeros(n, np.float32)
        np.add.at(norm2, inv_img, vals * vals)

        lo = np.searchsorted(inv_w, uw, side="left")
        hi = np.searchsorted(inv_w, uw, side="right")
        lens = hi - lo
        # Flat posting indices of all query words: ranges [lo, hi) unrolled.
        sel = np.repeat(lo, lens) + (np.arange(lens.sum())
                                     - np.repeat(np.cumsum(lens) - lens, lens))
        qrep = np.repeat(qv, lens)
        dot = np.zeros(n, np.float32)
        np.add.at(dot, inv_img[sel], vals[sel] * qrep)
        return 2.0 - 2.0 * dot / np.maximum(np.sqrt(norm2), 1e-12)


def _score(qbow, db, idf):
    """Squared L2 distance between L2-normalized idf-weighted tf vectors,
    host numpy f32 like the sparse path, so near-tie rankings do not flip
    at the dense/sparse switchover."""
    q = (qbow * idf).astype(np.float32)
    q = q / max(np.linalg.norm(q), 1e-12)
    d = db * idf[None, :]
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    return (2.0 - 2.0 * (d @ q)).astype(np.float32)
