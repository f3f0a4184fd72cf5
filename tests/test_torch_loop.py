"""Loop detection of the PyTorch port held against the JAX package.

  - train_voc_tree: the same centers for one seed, exactly (both are the
    same host numpy);
  - VocTree.quantize on a tree carried across with voc_tree_from_jax: the
    same words, except for descriptors whose two nearest centers at some
    level lie within 1e-5 relative of each other (f32 distances summed in
    another order may swap them);
  - LoopDetector in dense and sparse mode: the same top-N images after the
    same adds, scores within 1e-6;
  - trees saved by the JAX package (npz and the reference binary) load in
    the port and quantize alike; forward data, match_forward and the
    checkpoint words agree.
"""

import numpy as np
import pytest
import torch

from mavmap_tpu.features.provider import Features as JFeatures
from mavmap_tpu.loop import LoopDetector as JLoopDetector
from mavmap_tpu.loop import VocTree as JVocTree
from mavmap_tpu.loop import train_voc_tree as j_train

from mavmap_tpu_torch.features.provider import Features
from mavmap_tpu_torch.interop import voc_tree_from_jax
from mavmap_tpu_torch.loop import LoopDetector, VocTree, train_voc_tree

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _desc(rng, n, d=32):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _near_tie(tree, q, words, rel=1e-5):
    """Descriptors whose two nearest children at some level of their
    descent (along `words`) lie within `rel` of each other."""
    K = tree.branching
    tie = np.zeros(len(q), bool)
    for level, C in enumerate(tree.centers):
        C = np.asarray(C, np.float64)
        node = words // K ** (tree.depth - 1 - level)
        parent = node // K
        ch = C[parent[:, None] * K + np.arange(K)[None, :]]
        d = np.sum((ch - q[:, None, :].astype(np.float64)) ** 2, axis=-1)
        s = np.sort(d, axis=1)
        tie |= s[:, 1] - s[:, 0] <= rel * np.maximum(np.abs(s[:, 0]), 1e-12) + 1e-12
    return tie


@pytest.mark.parametrize("branching,depth,seed", [(8, 2, 0), (4, 3, 5)])
def test_train_voc_tree_equals_jax(rng, branching, depth, seed):
    train = _desc(rng, 3000)
    t = train_voc_tree(train, branching=branching, depth=depth, iters=3, seed=seed, device=CPU)
    j = j_train(train, branching=branching, depth=depth, iters=3, seed=seed)
    assert t.num_words == j.num_words == branching ** depth
    for ct, cj in zip(t.centers, j.centers):
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_quantize_equals_jax(rng):
    jt = j_train(_desc(rng, 4000, d=128), branching=8, depth=2, iters=3)
    t = voc_tree_from_jax(jt, CPU)
    q = _desc(rng, 2000, d=128)
    mask = rng.random(2000) > 0.1
    wt = t.quantize(q, mask).numpy()
    wj = np.asarray(jt.quantize(q, mask))
    assert wt.dtype == np.int32 and (wt[~mask] == -1).all()
    differ = wt != wj
    tie = _near_tie(t, q, np.where(mask, wj, 0))
    assert not (differ & ~tie).any(), np.where(differ & ~tie)
    assert differ.sum() <= 2
    # A tensor input on the tree's device gives the same words.
    np.testing.assert_array_equal(t.quantize(torch.as_tensor(q)).numpy()[mask], wt[mask])


def _image_sets(rng, n=8, per=150, d=32):
    base = [_desc(rng, per, d) for _ in range(n)]
    revisit = base[2] + rng.normal(size=base[2].shape).astype(np.float32) * 0.02
    revisit /= np.linalg.norm(revisit, axis=-1, keepdims=True)
    return base, revisit


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_loop_detector_query_equals_jax(rng, mode):
    """Same adds, same queries: identical top-N indices, scores at 1e-6;
    with and without idf, one query cached by its image index."""
    jt = j_train(_desc(rng, 4000), branching=4, depth=3, iters=4)
    det_t = LoopDetector(voc_tree_from_jax(jt, CPU), score_mode=mode)
    det_j = JLoopDetector(jt, score_mode=mode)
    base, revisit = _image_sets(rng)
    kp = rng.uniform(0, 100, (150, 2)).astype(np.float32)
    for i, d in enumerate(base):
        det_t.add_image(i, Features.from_arrays(kp, d, 256))
        det_j.add_image(i, JFeatures.from_arrays(kp, d, 256))
    assert det_t.num_images == det_j.num_images == len(base)
    for q, idx, use_idf in ((revisit, None, True), (revisit, None, False), (base[5], 5, True)):
        it, st = det_t.query(Features.from_arrays(kp, q, 256), num_images=5, use_idf=use_idf,
                             image_idx=idx)
        ij, sj = det_j.query(JFeatures.from_arrays(kp, q, 256), num_images=5, use_idf=use_idf,
                             image_idx=idx)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    assert it[0] == 5 and det_t.query(Features.from_arrays(kp, revisit, 256))[0][0] == 2
    # Forward file, visual-word matches and the checkpoint words agree.
    for k in (0, 3):
        for a, b in zip(det_t.forward_data(k), det_j.forward_data(k)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(det_t.match_forward(2, Features.from_arrays(kp, revisit, 256)),
                    det_j.match_forward(2, JFeatures.from_arrays(kp, revisit, 256))):
        np.testing.assert_array_equal(a, b)
    (ids_t, words_t), (ids_j, words_j) = det_t.saved_words(), det_j.saved_words()
    assert ids_t == ids_j
    for k in ids_t:
        np.testing.assert_array_equal(words_t[k], words_j[k])


def test_loop_detector_device_descriptors_and_restore(rng):
    """Deferred quantization of device descriptors (the mapper's tensors,
    stacked with torch.stack in chunks of FLUSH_CHUNK) gives the words of
    the host path; restore_image re-indexes saved words without a descent."""
    tree = train_voc_tree(_desc(rng, 2000), branching=4, depth=2, iters=3, device=CPU)
    base, revisit = _image_sets(rng, n=5)
    kp = np.zeros((150, 2), np.float32)
    host, dev = LoopDetector(tree), LoopDetector(tree)
    dev.FLUSH_CHUNK = 2  # three chunks for five images
    for i, d in enumerate(base):
        f = Features.from_arrays(kp, d, 256)
        host.add_image(i, f)
        dev.add_image(i, f, device_descriptors=torch.as_tensor(f.descriptors),
                      device_mask=torch.as_tensor(f.mask))
    dev.add_image(1, Features.from_arrays(kp, base[1], 256))  # a repeat is ignored
    assert dev.num_images == 5
    q = Features.from_arrays(kp, revisit, 256)
    for a, b in zip(host.query(q), dev.query(q)):
        np.testing.assert_array_equal(a, b)
    ids, words = dev.saved_words()
    restored = LoopDetector(tree)
    for i in ids:
        restored.restore_image(i, Features.from_arrays(kp, base[i], 256), words[i])
    for a, b in zip(host.query(q), restored.query(q)):
        np.testing.assert_array_equal(a, b)


def test_trees_saved_by_jax_load_in_the_port(rng, tmp_path):
    """An npz tree and a reference-binary tree written by the JAX package
    load in the port with the same centers and quantize alike; the port's
    own writers round-trip the same bytes."""
    jt = j_train(_desc(rng, 1500, d=128), branching=4, depth=3, iters=3, seed=1)
    jt.save(str(tmp_path / "tree.npz"))
    jt.save_reference_binary(str(tmp_path / "tree.bin"))
    q = _desc(rng, 300, d=128)
    for t, j in ((VocTree.load(str(tmp_path / "tree.npz"), device=CPU), jt),
                 (VocTree.load_reference_binary(str(tmp_path / "tree.bin"), device=CPU),
                  JVocTree.load_reference_binary(str(tmp_path / "tree.bin")))):
        assert (t.branching, t.depth, t.num_words) == (4, 3, 64)
        for ct, cj in zip(t.centers, j.centers):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        wt, wj = t.quantize(q).numpy(), np.asarray(j.quantize(q))
        assert not ((wt != wj) & ~_near_tie(t, q, wj)).any()
    t = VocTree.load_reference_binary(str(tmp_path / "tree.bin"), device=CPU)
    t.save_reference_binary(str(tmp_path / "again.bin"))
    assert (tmp_path / "again.bin").read_bytes() == (tmp_path / "tree.bin").read_bytes()
    t.save(str(tmp_path / "again.npz"))
    for ct, cj in zip(VocTree.load(str(tmp_path / "again.npz"), device=CPU).centers,
                      t.centers):
        assert torch.equal(ct, cj)
