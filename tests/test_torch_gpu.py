"""CUDA kernels of mavmap_tpu_torch against their plain PyTorch versions,
on the card. Every test is marked `gpu` and skips without a CUDA device.

This file imports neither jax nor mavmap_tpu, so it runs on a GPU machine
without JAX — without the suite's conftest.py, which imports jax:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: K1 distances 1e-5 with indices equal except at near-ties
(best and second within 1e-5: f32 dot products summed in another order
may swap them), exact ties to the lower index; K2 1e-5 of the
per-segment sum of |contrib| (its sums run in another order than
index_add_'s). K2 adds in an order fixed by its plan: repeated calls are
bitwise equal. K3 adds each segment's rows in row order, as index_add_
does on the CPU: it equals its plain version run on a CPU copy bit for
bit, and so does a dense self-calibrating bundle adjustment run twice.
K1 with a slot axis gives every slot the bits of the single-pair launch on
that slot's pair. The batched registration steps at 32 slots give every
slot the bits of register_view on the same pair with the same RANSAC
draws (their sums over a slot's rows and their per-slot 3x3 products add
in an order fixed by one slot's shapes: ops/reduce.py); the two-view step
gives its matches, inliers and counts, and its floats within
test_two_view_init_matches_jax's tolerances (the 5-point solver's GEMMs
over the trials pick their kernel by the batch). A 32-slot step repeats
bit for bit, gives the same bits whether the pose LM stops late (its
lagged flag), every iteration or never early, and syncs the host no more often than a 1-slot step; the vocabulary
tree quantizes as on the CPU except at near-ties (two centers within 1e-5
relative). The pose LM rejects a non-finite step on the card as on the
CPU. tests/test_torch_merge.py's restart-and-merge run repeats bit
for bit on the card, runs with index_add_ and accumulating index_put_
refused on CUDA tensors, and registers the same frames on the Python track
store as on the native one. Two ranks sharing the card (parallel.launch,
gloo) solve a point-sharded bundle adjustment twice with the same bits on
both ranks, and split the 32-slot registration steps with every slot
equal to the unsharded step's bits.
"""


import numpy as np
import pytest
import torch

from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
from mavmap_tpu_torch.ba import core as ba_core
from mavmap_tpu_torch.loop import train_voc_tree
from mavmap_tpu_torch.models import camera as cam
from mavmap_tpu_torch.ops.cuda import ba_accum as ka
from mavmap_tpu_torch.ops.cuda import build
from mavmap_tpu_torch.ops.cuda import match as km
from mavmap_tpu_torch.ops.matching import match_features, match_features_batched
from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec
from mavmap_tpu_torch.sfm.kernels import (
    register_view, register_view_batch, register_view_pairs, two_view_init, two_view_init_batch)
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features
from mavmap_tpu_torch.utils.timer import count_syncs

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _pair(rng, N1, N2, D=128):
    d1 = rng.normal(size=(N1, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    src = rng.integers(0, N1, N2)
    d2 = d1[src] + rng.normal(size=(N2, D)).astype(np.float32) * 0.02
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    m1 = rng.random(N1) > 0.05
    m2 = rng.random(N2) > 0.05
    kp1 = (rng.random((N1, 2)) * [800, 600]).astype(np.float32)
    kp2 = (kp1[src] + rng.normal(size=(N2, 2)) * 30).astype(np.float32)
    return d1, d2, m1, m2, kp1, kp2


def _check_match(got, ref):
    """Kernel against plain: indices equal off near-ties, distances 1e-5,
    masked distances exact."""
    for a, b, s in ((0, 1, 2), (3, 4, 5)):
        near_tie = (ref[s] - ref[b]) <= 1e-5
        assert bool(((got[a] == ref[a]) | near_tie).all())
        real = ref[b] < 1e29
        assert float((got[b] - ref[b]).abs()[real].max()) <= 1e-5
        assert torch.equal(got[b][~real], ref[b][~real])


@pytest.mark.parametrize("N1,N2", [(1024, 1024), (1000, 937)])
def test_match_kernel_vs_plain(dev, rng, N1, N2):
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, N1, N2)
    args = km.padded_operands(*[torch.as_tensor(a, device=dev)
                                for a in (d1, d2, m1, m2, kp1, kp2)], max_distance=60.0)
    before = build.launches["match"]
    got = km.match_raw(*args)
    ref = km.match_raw_plain(*args)
    torch.cuda.synchronize()
    assert build.launches["match"] == before + 1
    _check_match(got, ref)
    mk, _ = match_features(*[torch.as_tensor(a, device=dev) for a in (d1, d2, m1, m2)])
    mc, _ = match_features(*[torch.as_tensor(a) for a in (d1, d2, m1, m2)])
    assert int((mk.cpu() != mc).sum()) <= 2


@pytest.mark.parametrize("N1,N2", [(1024, 1024), (1000, 937)])
def test_match_kernel_exact_ties_go_to_lower_index(dev, rng, N1, N2):
    """Exact ties in both directions. Row r of d1 copied into columns a < b
    of d2 gives row r two equal best distances: its argmin is a, its second
    equals its best, and no row picks b. Column c of d2 copied into rows
    a < b of d1 does the same for column c. The pairs sit in different
    64-wide tiles and in the same one, so both the in-tile and the
    cross-tile merges decide."""
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, N1, N2)
    m1[:] = True
    m2[:] = True
    dup2 = {100: (3, 70), 7: (5, 9), 512: (200, 900)}    # row r -> columns a, b
    dup1 = {40: (10, 600), 300: (17, 30), 128: (64, 65)}  # column c -> rows a, b
    for r, (a, b) in dup2.items():
        d2[a], d2[b], kp2[a], kp2[b] = d1[r], d1[r], kp1[r], kp1[r]
    for c, (a, b) in dup1.items():
        d1[a], d1[b], kp1[a], kp1[b] = d2[c], d2[c], kp2[c], kp2[c]
    args = km.padded_operands(*[torch.as_tensor(x, device=dev)
                                for x in (d1, d2, m1, m2, kp1, kp2)], max_distance=60.0)
    got = km.match_raw(*args)
    _check_match(got, km.match_raw_plain(*args))
    row_arg, row_best, row_second, col_arg, col_best, col_second = (x.cpu() for x in got)
    for r, (a, b) in dup2.items():
        assert row_arg[r] == a and row_second[r] == row_best[r]
        assert not bool((row_arg[:N1] == b).any())
    for c, (a, b) in dup1.items():
        assert col_arg[c] == a and col_second[c] == col_best[c]
        assert not bool((col_arg[:N2] == b).any())


def test_match_kernel_refuses_untiled_shapes(dev):
    x = torch.zeros((100, 128), device=dev)
    pen = torch.zeros(100, device=dev)
    with pytest.raises(ValueError):
        km.match_raw(x, pen, x, pen)


def _batched_pairs(rng, B, N1, N2, shared1, ties):
    """B descriptor pairs; side 1 one image for every slot when shared1.
    With ties, every slot's pairs carry exact ties in both directions (a
    row of d1 copied into two columns of d2, a column of d2 copied into two
    rows of d1), in the same 64-wide tile and across tiles."""
    pairs = [list(_pair(rng, N1, N2)) for _ in range(B)]
    if shared1:
        for p in pairs[1:]:
            p[0], p[2], p[4] = pairs[0][0], pairs[0][2], pairs[0][4]
    if ties:
        for b, (d1, d2, m1, m2, kp1, kp2) in enumerate(pairs):
            m1[:] = True
            m2[:] = True
            for r, (a, c) in {100: (3, 70), 7: (5 + b % 3, 9 + b % 3)}.items():
                d2[a], d2[c], kp2[a], kp2[c] = d1[r], d1[r], kp1[r], kp1[r]
            if not shared1:
                for c, (a, r) in {40: (10, 600 % N1), 128: (64, 65)}.items():
                    d1[a], d1[r], kp1[a], kp1[r] = d2[c], d2[c], kp2[c], kp2[c]
    stack = [np.stack([p[i] for p in pairs]) for i in range(6)]
    if shared1:
        for i in (0, 2, 4):
            stack[i] = pairs[0][i]
    return stack


def _hold_batched(dev, arrays, B):
    """One batched K1 launch on the arrays (counted once as batched), every
    slot equal bit for bit to the single-pair launch on its pair and held to
    the plain version as the single launch is; the batched matcher's matches
    equal match_features slot by slot. Returns the raw outputs."""
    t = [torch.as_tensor(a, device=dev) for a in arrays]
    args = km.padded_operands(*t, max_distance=60.0)
    before = dict(build.launches), dict(build.slots)
    got = km.match_raw(*args)
    torch.cuda.synchronize()
    assert build.launches["match"] == before[0]["match"] + 1
    assert build.launches["match_batched"] == before[0]["match_batched"] + 1
    assert build.slots["match_batched"] == before[1]["match_batched"] + B
    assert got[0].shape == (B, args[0].shape[-2]) and got[3].shape == (B, args[2].shape[-2])
    ref = km.match_raw_batched_plain(*args)
    for b in range(B):
        one = [None if a is None else (a[b] if a.dim() == n else a)
               for a, n in zip(args[:6], (3, 2, 3, 2, 3, 3))]
        single = km.match_raw(*one, args[6])
        for g, s1 in zip(got, single):
            assert torch.equal(g[b], s1)
        _check_match([g[b] for g in got], [r[b] for r in ref])
    mb, okb = match_features_batched(*t, max_distance=60.0)
    for b in range(B):
        one = [a[b] if a.dim() == n else a for a, n in zip(t, (3, 3, 2, 2, 3, 3))]
        ms, oks = match_features(*one, max_distance=60.0)
        assert torch.equal(mb[b], ms) and torch.equal(okb[b], oks)
    return got


@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("shared1", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_match_kernel_batched_slots_equal_single_launches(dev, rng, B, shared1, ties):
    """K1 with a slot axis, the first side shared or both per slot, masks
    and exact ties included (see _hold_batched)."""
    got = _hold_batched(dev, _batched_pairs(rng, B, 1000, 937, shared1, ties), B)
    if ties:
        for b in range(B):
            assert int(got[0][b, 100]) == 3 and got[2][b, 100] == got[1][b, 100]
            if not shared1:
                assert int(got[3][b, 40]) == 10 and got[5][b, 40] == got[4][b, 40]


@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("ties", [False, True])
def test_match_kernel_batched_shared_second_side(dev, rng, B, ties):
    """register_view_batch's layout: the first side per slot and the second
    shared by every slot (the shared-first-side pairs with the sides
    swapped, so a shared row's tie becomes a tie of a shared column)."""
    d2, d1s, m2, m1s, kp2, kp1s = _batched_pairs(rng, B, 937, 1000, True, ties)
    got = _hold_batched(dev, (d1s, d2, m1s, m2, kp1s, kp2), B)
    if ties:
        for b in range(B):
            assert int(got[3][b, 100]) == 3 and got[5][b, 100] == got[4][b, 100]


def test_match_kernel_batched_refuses_mismatched_slots(dev):
    x = torch.zeros((3, 128, 128), device=dev)
    y = torch.zeros((2, 128, 128), device=dev)
    with pytest.raises(ValueError):
        km.match_raw(x, torch.zeros((3, 128), device=dev), y,
                     torch.zeros((2, 128), device=dev))
    with pytest.raises(ValueError):  # a penalty without the slot axis of its side
        km.match_raw(x, torch.zeros(128, device=dev), x,
                     torch.zeros((3, 128), device=dev))


def _register_inputs(dev, F=512, B=3):
    """One current image and B previous images of a synthetic survey, with
    each previous image's track state from the ground truth."""
    scene = make_uav_scene(num_images=B + 1, num_points=1500, relief=10.0, seed=3)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=20, seed=3, max_features=F)
    rng = np.random.default_rng(3)
    imgs, states = [], []
    for i in range(B + 1):
        kp, de = feats[i]
        k, d, m = np.zeros((F, 2), np.float32), np.zeros((F, 128), np.float32), np.zeros(F, bool)
        k[:len(kp)], d[:len(kp)], m[:len(kp)] = kp, de, True
        n = cam.image2normalized_np(k, 1, scene.cam_params[0]).astype(np.float32)
        imgs.append([torch.as_tensor(a, device=dev) for a in (k, d, m, n)])
        ids = np.full(F, -1)
        ids[:len(gt[i])] = gt[i]
        has_tri = (ids >= 0) & (rng.random(F) < 0.8)
        xyz = np.zeros((F, 3), np.float32)
        xyz[has_tri] = scene.points3D[ids[has_tri]] + rng.normal(size=(has_tri.sum(), 3)) * 0.01
        states.append([torch.as_tensor(a, device=dev) for a in (
            xyz, has_tri, has_tri & (rng.random(F) < 0.9), scene.rvecs[i], scene.tvecs[i])])
    return scene, imgs[:B], states[:B], imgs[B]


def _register_slots(dev, B=32):
    """register_view_batch's and register_view_pairs' inputs at B slots over
    _register_inputs' three previous images in turn, and the single-step
    inputs of each slot. The pairs' slots alternate PINHOLE and OPENCV
    (small nonzero distortion) cameras."""
    scene, prevs, states, curr = _register_inputs(dev)
    K = torch.as_tensor(scene.cam_params[0], device=dev)
    Ko = K.clone()
    Ko[4:8] = torch.tensor([2e-3, -1e-3, 5e-4, -5e-4], device=dev)
    slot_prev = [prevs[b % 3] for b in range(B)]
    slot_state = [states[b % 3] for b in range(B)]
    codes = [1 + b % 2 for b in range(B)]
    Ks = torch.stack([K if c == 1 else Ko for c in codes])
    nts = [(3.5 + 0.5 * (b % 3)) / 700.0 for b in range(B)]
    stack = [torch.stack([p[i] for p in slot_prev]) for i in range(4)]
    sstack = [torch.stack([st[i] for st in slot_state]) for i in range(5)]
    cstack = [c.expand((B,) + c.shape) for c in curr]
    batch = (stack + curr + sstack + [K, 1, 0.9, 1e9, 4.0 / 700.0],
             [list(slot_prev[b]) + curr + list(slot_state[b]) + [K, 1, 0.9, 1e9, 4.0 / 700.0]
              for b in range(B)])
    pairs = (stack + cstack + sstack + [Ks, codes, 0.9, 1e9, nts],
             [list(slot_prev[b]) + curr + list(slot_state[b]) + [Ks[b], codes[b], 0.9, 1e9,
                                                                  nts[b]] for b in range(B)])
    return batch, pairs


def test_register_view_batch_slots_equal_register_view(dev):
    """register_view_batch and register_view_pairs (PINHOLE and OPENCV slots)
    on the card at B = 32 against register_view per slot on the same pairs:
    with generators seeded alike, the slots draw the same RANSAC samples in
    slot order, and every output is equal bit for bit; one batched K1
    launch serves each step."""
    for step, (args, singles) in zip((register_view_batch, register_view_pairs),
                                     _register_slots(dev)):
        g1 = torch.Generator(device=dev)
        g1.manual_seed(11)
        before = build.launches["match_batched"]
        rows, scalars = step(g1, *args, p3p_trials=256)
        assert build.launches["match_batched"] == before + 1
        g2 = torch.Generator(device=dev)
        g2.manual_seed(11)
        for b, one in enumerate(singles):
            r1, s1 = register_view(g2, *one, p3p_trials=256)
            assert torch.equal(rows[b], r1) and torch.equal(scalars[b], s1), (step.__name__, b)
        assert float(scalars[:, 5].sum()) >= 16  # P3P succeeded in most slots


def test_two_view_init_batch_slots_equal_two_view_init(dev):
    """two_view_init_batch on the card at B = 32 (one first image against
    _register_inputs' three images in turn, a threshold per slot) against
    two_view_init per slot with generators seeded alike. The 5-point
    solver's matrix products over the slots' trials (its constraint
    einsums, the root polish's batched matmuls) run as cuBLAS GEMMs whose
    kernel depends on the number of trials, so a slot's floats may differ
    from the single step's in their last bits
    (benchmarks/torch_batched_geometry.py): matches, validity, inliers and
    counts exact, the floats at test_two_view_init_matches_jax's
    tolerances; and the 32-slot step repeats bit for bit."""
    scene, prevs, _, first = _register_inputs(dev)
    B = 32
    cands = [prevs[b % 3] for b in range(B)]
    stack = [torch.stack([c[i] for c in cands]) for i in range(4)]
    nts = [(3.5 + 0.5 * (b % 3)) / 700.0 for b in range(B)]
    outs = []
    for _ in range(2):
        g1 = torch.Generator(device=dev)
        g1.manual_seed(13)
        outs.append(two_view_init_batch(g1, *first, *stack, 0.9, 1e9, nts,
                                        essential_trials=256))
    rows, scalars = outs[0]
    assert torch.equal(rows, outs[1][0]) and torch.equal(scalars, outs[1][1])
    g2 = torch.Generator(device=dev)
    g2.manual_seed(13)
    for b, c in enumerate(cands):
        r1, s1 = two_view_init(g2, *first, *c, 0.9, 1e9, nts[b], essential_trials=256)
        assert torch.equal(rows[b, :, :3], r1[:, :3]), b
        assert torch.equal(scalars[b, [0, 2, 3]], s1[[0, 2, 3]]), b
        torch.testing.assert_close(scalars[b, 1], s1[1], rtol=1e-5, atol=0)
        torch.testing.assert_close(scalars[b, 6:12], s1[6:12], rtol=0, atol=1e-4)
        torch.testing.assert_close(scalars[b, 12:21], s1[12:21], rtol=0, atol=1e-5)
        torch.testing.assert_close(scalars[b, 4:6], s1[4:6], rtol=1e-3, atol=0)
        inl = r1[:, 2] > 0.5
        torch.testing.assert_close(rows[b, inl, 6:9], r1[inl, 6:9], rtol=1e-3, atol=1e-3)
    assert float(scalars[:, 3].min()) > 40  # essential-matrix inliers in every slot


def test_register_view_pairs_is_bitwise_repeatable(dev):
    """A 32-slot register_view_pairs step, run twice from generators seeded
    alike, gives the same bits."""
    (_, _), (args, _) = _register_slots(dev)
    outs = []
    for _ in range(2):
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        outs.append(register_view_pairs(g, *args, p3p_trials=256))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_pose_lm_stop_rules_give_the_same_bits(dev, monkeypatch):
    """The batched pose LM's lagged stop on the card against a stop read
    every iteration and against no early stop at all: a slot that has
    stopped stays frozen, so where the loop ends changes no bit."""
    (_, _), (args, _) = _register_slots(dev)
    rules = (ba_core._lm_stop_rule, lambda device: lambda active: not bool(active.any()),
             lambda device: lambda active: False)
    outs = []
    for rule in rules:
        monkeypatch.setattr(ba_core, "_lm_stop_rule", rule)
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        outs.append(register_view_pairs(g, *args, p3p_trials=256))
    for rows, scalars in outs[1:]:
        assert torch.equal(rows, outs[0][0]) and torch.equal(scalars, outs[0][1])


def test_batched_step_syncs_do_not_grow_with_slots(dev):
    """Host syncs of a register_view_pairs step, from the draws to the
    packed outputs, at B = 1 and at B = 32."""
    (_, _), (args, _) = _register_slots(dev)
    counts = []
    for B in (1, 32):
        sub = [a[:B] for a in args[:14]] + [args[14][:B], args[15], args[16], args[17][:B]]
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        register_view_pairs(g, *sub, p3p_trials=256)  # warm-up
        counts.append(count_syncs(lambda: register_view_pairs(g, *sub, p3p_trials=256))[0])
    assert counts[1] <= counts[0], counts


def test_voc_tree_quantize_on_the_card_equals_cpu(dev):
    """The vocabulary tree's descent on the card gives the CPU's words, but
    for descriptors whose two nearest children at some level lie within
    1e-5 relative."""
    rng = np.random.default_rng(8)
    train = rng.normal(size=(6000, 128)).astype(np.float32)
    train /= np.linalg.norm(train, axis=1, keepdims=True)
    tree_c = train_voc_tree(train, branching=8, depth=2, iters=3, device="cpu")
    tree_g = train_voc_tree(train, branching=8, depth=2, iters=3, device=dev)
    q = rng.normal(size=(32768, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = rng.random(len(q)) > 0.05
    wc = tree_c.quantize(q, mask).numpy()
    wg = tree_g.quantize(torch.as_tensor(q, device=dev), torch.as_tensor(mask, device=dev))
    assert wg.device == dev and wg.dtype == torch.int32
    wg = wg.cpu().numpy()
    differ = wg != wc
    node, tie = np.zeros(len(q), np.int64), np.zeros(len(q), bool)
    for C in tree_c.centers:  # the CPU's descent, with its margins in f64
        ch = C.numpy().astype(np.float64)[node[:, None] * 8 + np.arange(8)]
        d = np.sum((ch - q[:, None, :]) ** 2, axis=-1)
        s = np.sort(d, axis=1)
        tie |= s[:, 1] - s[:, 0] <= 1e-5 * s[:, 0]
        node = node * 8 + np.argmin(d, axis=1)
    assert not (differ & ~tie).any() and differ.sum() <= 0.001 * len(q)


@pytest.mark.parametrize("O,K,S", [(8192, 9, 17), (8192, 81, 17), (32768, 81, 289),
                                   (32768, 81, 1089), (5000, 42, 2500)])
def test_seg_accum_full_kernel_vs_plain(dev, rng, O, K, S):
    """The kernel, given the plan alone, against the plain version on the
    ids and the plain version keyed by the same plan."""
    c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
    ids = torch.as_tensor(rng.integers(0, S, O).astype(np.int32), device=dev)
    plan = ka.make_plan(ids.cpu().numpy(), S).to(dev)
    got = ka.seg_accum_full(c, None, S, plan)
    scale = ka.seg_accum_full_plain(c.abs(), ids, S)
    for ref in (ka.seg_accum_full_plain(c, ids, S), ka.seg_accum_planned_plain(c, plan)):
        assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("K,S", [(6, 200), (9, 201)])
def test_seg_accum_full_kernel_vs_plain_cg_matvec(dev, rng, K, S):
    """K2 at the CG matvec's shapes: 6 columns into the pose blocks, 9 into
    the pose + camera blocks of the self-calibrating system (both entries
    of every observation reduced together, so twice the rows)."""
    O = 40960 * (2 if K == 9 else 1)
    c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
    ids = torch.as_tensor(np.sort(rng.integers(0, S, O)).astype(np.int32), device=dev)
    plan = ka.make_plan(ids.cpu().numpy(), S).to(dev)
    before = build.launches["seg_accum_full"]
    got = ka.seg_accum_full(c, ids, S, plan)
    assert build.launches["seg_accum_full"] == before + 1
    ref = ka.seg_accum_full_plain(c, ids, S)
    scale = ka.seg_accum_full_plain(c.abs(), ids, S)
    assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("case", ["all_one_id", "half_one_id", "random", "out_of_range"])
@pytest.mark.parametrize("K", [9, 81])
def test_seg_accum_full_kernel_is_bitwise_repeatable(dev, rng, case, K):
    """Repeated calls give the same bits: every row on one id (the camera
    block's own reduction), half the rows on one id (both entries of every
    observation, the camera block taking the second half), random ids, and
    ids outside [0, S), which are dropped."""
    O, S = 151552, 201
    if case == "all_one_id":
        ids = np.full(O, 200)
    elif case == "half_one_id":
        ids = np.concatenate([rng.integers(0, 200, O // 2), np.full(O // 2, 200)])
    elif case == "random":
        ids = rng.integers(0, S, O)
    else:
        ids = rng.integers(-20, S + 20, O)
    c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
    ids = torch.as_tensor(ids.astype(np.int32), device=dev)
    plan = ka.make_plan(ids.cpu().numpy(), S).to(dev)
    outs = [ka.seg_accum_full(c, ids, S, plan) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = ka.seg_accum_full_plain(c, ids, S)
    scale = ka.seg_accum_full_plain(c.abs(), ids, S)
    assert bool(((outs[0] - ref).abs() <= 1e-5 * scale + 1e-6).all())


def test_seg_accum_full_kernel_needs_a_matching_plan(dev, rng):
    """A CUDA call without a plan raises (the sort is host work, done once
    per problem), and so does a plan of other ids' shape."""
    c = torch.zeros((64, 9), device=dev)
    ids = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ka.seg_accum_full(c, ids, 4)
    with pytest.raises(ValueError):
        ka.seg_accum_full(c, ids, 4, ka.make_plan(np.zeros(63, np.int32), 4).to(dev))
    with pytest.raises(ValueError):
        ka.seg_accum_full(c, ids, 5, ka.make_plan(np.zeros(64, np.int32), 4).to(dev))


def _sorted_call(dev, c, off):
    """K3 on the card on numpy contributions and offsets; returns (the card's
    sums, the plain version's on a CPU copy, the call's arguments on the
    card)."""
    S = len(off) - 1
    args = (torch.as_tensor(c, device=dev), torch.as_tensor(off, device=dev), S)
    before = build.launches["seg_accum_sorted"]
    got = ka.seg_accum_sorted(*args)
    torch.cuda.synchronize()
    assert build.launches["seg_accum_sorted"] == before + 1
    ref = ka.seg_accum_sorted_plain(torch.as_tensor(c), torch.as_tensor(off), S)
    return got.cpu(), ref, args


@pytest.mark.parametrize("O,K", [(8192, 12), (20480, 3), (40960, 3)])
def test_seg_accum_sorted_kernel_vs_plain(dev, rng, O, K):
    """Tracks of 2-9 rows, bucketed to 1024 segments, rows past the last
    offset: the kernel equals the plain version on a CPU copy bit for bit,
    and the plain version on the card (index_add_ with atomics) to 1e-5 of
    the per-segment sum of |contrib|."""
    lens = rng.integers(2, 10, size=O // 6)
    S = -(-len(lens) // 1024) * 1024
    off = ka.offsets_from_sorted_ids(np.repeat(np.arange(len(lens)), lens), S)
    c = rng.normal(size=(O, K)).astype(np.float32)
    got, ref, (cd, od, _) = _sorted_call(dev, c, off)
    assert torch.equal(got, ref)
    scale = ka.seg_accum_sorted_plain(cd.abs(), od, S).cpu()
    card = ka.seg_accum_sorted_plain(cd, od, S).cpu()
    assert bool(((got - card).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("K", [3, 6, 12])
@pytest.mark.parametrize("case", ["batches", "empty_runs", "empty_tail", "all_empty",
                                  "unaligned"])
def test_seg_accum_sorted_kernel_edge_cases_bitwise(dev, rng, case, K):
    """The kernel's edge cases, each equal bit for bit to the plain version
    on a CPU copy: segments either side of its two batches of eight rows
    and past them (7, 8, 9, 15, 16, 17, 40, 300 rows: the serial tail);
    runs of empty segments; a tail of empty segments from bucketing; no
    row in any segment; and contributions starting 1-3 floats past a
    16-byte boundary (a view into a larger tensor)."""
    if case == "batches":
        lens = np.array([3, 7, 8, 9, 1, 15, 16, 17, 2, 40, 300, 5])
    elif case == "empty_runs":
        lens = np.concatenate([rng.integers(1, 6, 50), np.zeros(300, np.int64),
                               rng.integers(1, 6, 70), [9]])
    elif case == "all_empty":
        lens = np.zeros(100, np.int64)
    else:
        lens = rng.integers(1, 13, size=3000)
    tail = 1024 - len(lens) % 1024 if case == "empty_tail" else 0
    off = np.concatenate([[0], np.cumsum(lens), np.full(tail, lens.sum())]).astype(np.int32)
    c = rng.normal(size=(int(off[-1]) + 5, K)).astype(np.float32)
    if case == "unaligned":
        for shift in (1, 2, 3):
            base = torch.as_tensor(rng.normal(size=c.size + shift).astype(np.float32),
                                   device=dev)
            view = base[shift:].view(c.shape)
            assert view.data_ptr() % 16 == 4 * shift
            got = ka.seg_accum_sorted(view, torch.as_tensor(off, device=dev), len(off) - 1)
            ref = ka.seg_accum_sorted_plain(view.cpu(), torch.as_tensor(off), len(off) - 1)
            assert torch.equal(got.cpu(), ref)
        return
    got, ref, _ = _sorted_call(dev, c, off)
    assert torch.equal(got, ref)
    assert bool((got[torch.as_tensor(np.diff(off) == 0)] == 0).all())


def test_seg_accum_sorted_kernel_is_bitwise_repeatable(dev, rng):
    """Repeated calls at the survey's shape give the same bits."""
    lens = np.minimum(rng.geometric(0.35, size=49000) + 1, 30)
    lens = lens[np.cumsum(lens) <= 149490]  # the survey's real rows, then padding
    off = ka.offsets_from_sorted_ids(np.repeat(np.arange(len(lens)), lens), 49152)
    c = rng.normal(size=(151552, 3)).astype(np.float32)
    _, ref, args = _sorted_call(dev, c, off)
    outs = [ka.seg_accum_sorted(*args) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0].cpu(), ref)


def test_seg_accum_sorted_kernel_refuses_bad_offsets(dev):
    """A CUDA call raises on offsets of another segment count, or not int32,
    before any launch."""
    off = ka.offsets_from_sorted_ids(np.repeat(np.arange(100), 3), 128)
    c = torch.zeros((300, 3), device=dev)
    od = torch.as_tensor(off, device=dev)
    before = build.launches["seg_accum_sorted"]
    with pytest.raises(ValueError):
        ka.seg_accum_sorted(c, od, 127)
    with pytest.raises(TypeError):
        ka.seg_accum_sorted(c, od.long(), 128)
    assert build.launches["seg_accum_sorted"] == before


def _ba_arrays(rng, I=8, P=240, per_image=140, noise=0.5, focal=(1.01, 1.01)):
    """_ba_problem's host arrays (build_problem's positional arguments) and
    pose states."""
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = (rng.normal(size=(P, 3)) * [4, 4, 2] + [0, 0, 14]).astype(np.float32)
    poses = np.concatenate([rng.normal(size=(I, 3)) * 0.03,
                            np.stack([np.arange(I) * 0.7, np.zeros(I), np.zeros(I)], 1)],
                           axis=1).astype(np.float32)
    R = rotmat_from_rvec(torch.as_tensor(poses[:, :3])).numpy()
    oi, op, uv = [], [], []
    for i in range(I):
        Xc = X @ R[i].T + poses[i, 3:]
        u = Xc[:, :2] / Xc[:, 2:] * 700.0 + [400.0, 300.0]
        sel = np.sort(rng.permutation(P)[:per_image])
        oi += [i] * len(sel)
        op += list(sel)
        uv += list(u[sel] + rng.normal(size=(len(sel), 2)) * noise)
    poses0 = poses + rng.normal(size=poses.shape).astype(np.float32) * [0.003] * 3 \
        + np.concatenate([np.zeros((I, 3)), rng.normal(size=(I, 3)) * 0.02], 1)
    poses0[:2] = poses[:2]
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    K0 = K.copy()
    K0[0, :2] *= focal
    return ((poses0.astype(np.float32), X0.astype(np.float32), K0, np.array([1], np.int32),
             np.array(oi), np.array(op), np.zeros(len(oi), np.int32), np.array(uv, np.float32)),
            [1, 2] + [0] * (I - 2))


def _ba_problem(rng, I=8, P=240, per_image=140, noise=0.5, focal=(1.01, 1.01)):
    """tests/test_torch_ba.py's scene: rotated views, 0.5 px noise, a 1 %
    focal error by default. The rotations keep focal length and depth
    apart; with pure translation along x the two trade off almost freely,
    and f32 rounding then moves the result by far more than it does here."""
    args, states = _ba_arrays(rng, I, P, per_image, noise, focal)
    return build_problem(*args, pose_states=states, bucket=True)


@pytest.mark.parametrize("selfcal", [True, False])
def test_bundle_adjust_gpu_vs_cpu(dev, rng, selfcal):
    """One BA through K2/K3 on the card vs the CPU path, 6 iterations:
    final cost and intrinsics at 1e-4 relative, poses and points at 1e-3
    relative to their scale. The scale of the scene is pinned only by
    the second view's x-translation, so the cost is nearly flat along
    it: on the CPU, moving the observations by 1e-7 relative (f32
    rounding, as summing in another order on the card does) moves the
    x-translations by up to 1.1e-4 of the scale after 6 iterations, and
    the cost and intrinsics by under 3e-5."""
    prob = _ba_problem(rng)
    opts = BAOptions(max_num_iterations=6, refine_camera_params=selfcal,
                     function_tolerance=0.0)
    before = dict(build.launches)
    pg, xg, ig = bundle_adjust(prob, opts, dev)
    assert build.launches["seg_accum_full"] > before["seg_accum_full"]
    assert build.launches["seg_accum_sorted"] > before["seg_accum_sorted"]
    pc, xc, ic = bundle_adjust(prob, opts, torch.device("cpu"))
    assert ig["iterations"] == ic["iterations"] == 6
    assert ic["final_cost"] < 0.1 * ic["initial_cost"]
    np.testing.assert_allclose(ig["final_cost"], ic["final_cost"], rtol=1e-4)
    for g, c in ((pg, pc), (xg, xc)):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-3 * np.abs(c).max())
    if selfcal:
        np.testing.assert_allclose(ig["cam_params"], ic["cam_params"], rtol=1e-4)


@pytest.mark.parametrize("selfcal", [True, False])
def test_bundle_adjust_dense_is_bitwise_repeatable(dev, rng, selfcal):
    """The dense solve run twice on the card returns the same bits: poses,
    points and (self-calibrating) intrinsics. Every sum of the step adds in
    an order fixed by a plan (K2's plans, plan_ptblk / plan_ptimg for the
    per-(point, block) aggregation) or by the offsets (K3), none by atomics."""
    prob = _ba_problem(rng)
    opts = BAOptions(max_num_iterations=6, refine_camera_params=selfcal, solver="dense",
                     function_tolerance=0.0)
    runs = [bundle_adjust(prob, opts, dev) for _ in range(2)]
    (p0, x0, i0), (p1, x1, i1) = runs
    assert i0["solver"] == "dense" and i0["iterations"] == i1["iterations"] == 6
    assert np.array_equal(p0, p1) and np.array_equal(x0, x1)
    assert i0["final_cost"] == i1["final_cost"]
    if selfcal:
        assert np.array_equal(i0["cam_params"], i1["cam_params"])


@pytest.mark.parametrize("selfcal", [False, True])
def test_bundle_adjust_cg_vs_dense_gpu(dev, rng, selfcal):
    """The CG solver against the dense one on the card (cg_tol 1e-6), as
    tests/test_ba.py holds the JAX package's, on its kind of problem: 0.3 px
    noise, and a focal error only where self-calibration can remove it (an
    uncorrected one biases the minimum along a weakly pinned direction,
    where two solvers stop apart at function_tolerance). Poses at 1e-4
    (1e-3 with self-calibration), final costs at 1e-3 relative."""
    prob = _ba_problem(rng, noise=0.3, focal=(1.02, 0.985) if selfcal else (1.0, 1.0))
    o = dict(max_num_iterations=25, refine_camera_params=selfcal)
    pd, _, infod = bundle_adjust(prob, BAOptions(**o, solver="dense"), dev)
    before = dict(build.launches)
    pc, _, infoc = bundle_adjust(prob, BAOptions(**o, solver="cg", cg_tol=1e-6), dev)
    assert infoc["solver"] == "cg" and sum(infoc["cg_iters"]) > 0
    for k in ("seg_accum_full", "seg_accum_sorted"):
        assert build.launches[k] - before[k] >= sum(infoc["cg_iters"])
    assert np.abs(pc - pd).max() < (1e-3 if selfcal else 1e-4)
    assert abs(infoc["final_cost"] - infod["final_cost"]) < \
        1e-3 * max(1.0, infod["final_cost"])


def test_point_mean_errors_is_bitwise_repeatable(dev, rng):
    """point_mean_errors sums by its K2 plan (plan_pt, no atomics): a
    second call on the card gives the same bits, and the values agree with
    the CPU's to 1e-4 px; K2 launches once per call."""
    from mavmap_tpu_torch.ba.core import point_mean_errors, problem_to_device, with_plans

    host = with_plans(_ba_problem(rng), ("plan_pt",))
    prob = problem_to_device(host, dev)
    before = build.launches["seg_accum_full"]
    a = point_mean_errors(prob, prob.poses, prob.points)
    b = point_mean_errors(prob, prob.poses, prob.points)
    assert build.launches["seg_accum_full"] - before == 2
    assert torch.equal(a, b)
    cpu = problem_to_device(host, torch.device("cpu"))
    c = point_mean_errors(cpu, cpu.poses, cpu.points)
    assert float((a.cpu() - c).abs().max()) < 1e-4


def test_detector_on_the_card_matches_cpu(dev):
    """detect_and_describe on the card against the CPU on one rendered
    frame: the same kept keypoints in the same order within 0.05 px,
    descriptor cosine above 0.999 on at least 98 % of them (cuDNN's
    convolutions sum in another order than the CPU's)."""
    from mavmap_tpu_torch.features.detector import detect_and_describe
    from mavmap_tpu_torch.utils.synthetic import render_images

    scene = make_uav_scene(num_images=2, num_points=1500, relief=10.0, rows=1, seed=21)
    img = render_images(scene, texture_contrast=0.25, seed=21)[0].astype(np.float32)
    kw = dict(hessian_threshold=1000.0, max_features=1024)
    kc, _, dc, mc, cc = detect_and_describe(torch.as_tensor(img), **kw)
    kg, _, dg, mg, cg = (x.cpu() for x in detect_and_describe(torch.as_tensor(img, device=dev),
                                                                **kw))
    assert torch.equal(mg, mc) and torch.equal(cg, cc) and int(mc.sum()) > 300
    assert float((kg - kc).abs()[mc].max()) < 0.05
    cos = (dg * dc).sum(dim=1)[mc]
    assert float((cos > 0.999).float().mean()) >= 0.98


def _restart_and_merge(dev, **mapper_kw):
    """tests/test_torch_merge.py's restart-and-merge run on `dev`: 8 frames
    of the 16-image survey (capacity 512, 128 RANSAC trials), frames 4-5
    with unrelated descriptors, one failed frame restarts a sub-map and the
    post-pass merges the two. mapper_kw goes to every SequentialMapper
    (store_backend). Returns (result, scene)."""
    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.sfm import pipeline

    scene = make_uav_scene(num_images=16, num_points=2400, relief=10.0, rows=2, extent=None,
                           seed=13)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=13)
    feats = [(k[:512], d[:512]) for k, d in feats[:8]]
    rng = np.random.default_rng(0)
    for i in (4, 5):
        d = rng.normal(size=feats[i][1].shape).astype(np.float32)
        feats[i] = (feats[i][0], d / np.linalg.norm(d, axis=1, keepdims=True))
    opts = pipeline.PipelineOptions(
        verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
        chain_len=4, ba_local_max_iters=8, essential_ransac_trials=128, p3p_ransac_trials=128,
        loop_detection=False, max_subsequent_trials=1, final_closure_sweeps=0)
    mapper_cls = pipeline.SequentialMapper

    class Mapper(mapper_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, **mapper_kw))

    pipeline.SequentialMapper = Mapper
    try:
        res = pipeline.run_pipeline(scene.image_cameras[:8], scene.cam_models, scene.cam_params,
                                    ArrayFeatureProvider(feats, capacity=512), opts, device=dev)
    finally:
        pipeline.SequentialMapper = mapper_cls
    return res, scene


def _merged_state(res, scene):
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    m = res.main_mapper
    s = m.store
    return {"frames": sorted(m.image_idx_to_id), "rvecs": s.image_rvecs.copy(),
            "tvecs": s.image_tvecs.copy(), "points": s.point3D_xyz[s.point3D_valid].copy(),
            "ate": float(mapper_ate(m, scene))}


def test_restart_and_merge_is_bitwise_repeatable(dev):
    """The restart-and-merge run twice in one process on the card: one map
    each time, with equal poses, points and ATE, bit for bit."""
    runs = []
    for _ in range(2):
        res, scene = _restart_and_merge(dev)
        assert len(res.mappers) == 1 and "merge" in res.timings
        assert res.main_mapper.report()["store_backend"] == "native"
        runs.append(_merged_state(res, scene))
    a, b = runs
    assert a["frames"] == b["frames"] and len(a["frames"]) >= 6
    for k in ("rvecs", "tvecs", "points"):
        assert np.array_equal(a[k], b[k]), k
    assert a["ate"] == b["ate"] < 0.05


def test_restart_and_merge_sums_in_fixed_order(dev, monkeypatch):
    """The same run with Tensor.index_add_ raising on a CUDA tensor, and
    Tensor.index_put_ raising there with accumulate=True: no sum on the
    merge path leaves its fixed order (the K2/K3 plain versions use
    index_add_ only on CPU tensors)."""
    index_add, index_put = torch.Tensor.index_add_, torch.Tensor.index_put_

    def no_index_add(self, *a, **kw):
        if self.is_cuda:
            raise AssertionError("index_add_ on a CUDA tensor")
        return index_add(self, *a, **kw)

    def no_accumulate(self, indices, values, accumulate=False):
        if self.is_cuda and accumulate:
            raise AssertionError("index_put_(accumulate=True) on a CUDA tensor")
        return index_put(self, indices, values, accumulate)

    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    monkeypatch.setattr(torch.Tensor, "index_put_", no_accumulate)
    res, _ = _restart_and_merge(dev)
    assert len(res.mappers) == 1 and res.main_mapper.report()["merges"] == 1


def test_restart_and_merge_on_the_python_store(dev):
    """The same run on the Python track store registers the same frames
    as on the native one and ends in one map."""
    native, scene = _restart_and_merge(dev)
    python, _ = _restart_and_merge(dev, store_backend="python")
    assert python.main_mapper.report()["store_backend"] == "python"
    assert len(python.mappers) == len(native.mappers) == 1
    assert _merged_state(python, scene)["frames"] == _merged_state(native, scene)["frames"]


def test_pose_refinement_rejects_non_finite_steps(dev, rng):
    """A 3-D point at NaN makes the pose LM's normal equations non-finite.
    Their solve gives NaN (as XLA's does; torch.linalg.solve may raise
    there on the card), every step is rejected, and the pose comes back as
    it went in, on the card as on the CPU."""
    from mavmap_tpu_torch.ba.core import pose_refinement

    X = (rng.normal(size=(64, 3)) * [3, 3, 1] + [0, 0, 10]).astype(np.float32)
    X[7] = np.nan
    uv = (X[:, :2] / X[:, 2:] * 700.0 + [400.0, 300.0]).astype(np.float32)
    K = np.array([700.0, 700.0, 400.0, 300.0, 0, 0, 0, 0, 0], np.float32)
    r0, t0 = np.array([0.01, 0.0, 0.02], np.float32), np.array([0.1, 0.0, 0.0], np.float32)
    for d in (torch.device("cpu"), dev):
        r, t, cost = pose_refinement(r0, t0, X, uv, np.ones(64, bool), K, 1, d)
        assert np.array_equal(r.cpu().numpy(), r0) and np.array_equal(t.cpu().numpy(), t0)
        assert not bool(torch.isfinite(cost))


# ------------------------------------------------- two ranks on the card


def _rank_bundle_adjust(mesh, args, states, solver):
    """A rank of the two-rank solve: its shard solved twice."""
    from mavmap_tpu_torch.parallel import dist_bundle_adjust, partition_problem

    prob, new_index, per = partition_problem(*args, mesh.size, pose_states=states, bucket=True,
                                             shard=mesh.rank)
    out = []
    for _ in range(2):
        before = dict(build.launches)
        poses, points, info = dist_bundle_adjust(
            mesh, prob, BAOptions(max_num_iterations=6, solver=solver, function_tolerance=0.0),
            per)
        out.append((poses, points[new_index], info,
                    {k: build.launches[k] - before[k] for k in before}))
    return out


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_two_rank_bundle_adjust_repeats_bit_for_bit(dev, rng, solver):
    """Two ranks sharing the card (gloo, host-staged sums in rank order)
    solve the point-sharded problem twice: both solves give the same bits
    on both ranks, K2 and K3 run in each rank's shard, and the result is
    the one-device solve's at test_bundle_adjust_gpu_vs_cpu's bounds (poses
    and points within 1e-3 of their scale; the scene's scale is pinned by
    the second view's x alone, so a sum in another order moves the
    x-translations by ~1e-4 of it after 6 iterations, the inexact CG by
    more than the dense solve)."""
    from mavmap_tpu_torch.parallel import launch

    args, states = _ba_arrays(rng)
    ranks = launch(_rank_bundle_adjust, 2, "cuda", args=(args, states, solver), timeout=300)
    ref = ranks[0][0]
    for r in ranks:
        for poses, points, info, launches in r:
            assert np.array_equal(poses, ref[0]) and np.array_equal(points, ref[1])
            assert info["iterations"] == 6 and info["solver"] == solver
            assert launches["seg_accum_full"] > 0 and launches["seg_accum_sorted"] > 0
    p1, x1, _ = bundle_adjust(build_problem(*args, pose_states=states, bucket=True),
                              BAOptions(max_num_iterations=6, solver=solver,
                                        function_tolerance=0.0), dev)
    for got, one in ((ref[0], p1), (ref[1], x1[: len(ref[1])])):
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-3 * np.abs(one).max())


def _rank_register(mesh):
    """A rank of the two-rank registration steps: _register_slots' 32-slot
    steps split over the ranks, from generators seeded 11."""
    from mavmap_tpu_torch.parallel import dist_register_view_batch, dist_register_view_pairs

    out = []
    for step, (args, _) in zip((dist_register_view_batch, dist_register_view_pairs),
                               _register_slots(mesh.device)):
        g = torch.Generator(device=mesh.device)
        g.manual_seed(11)
        before = build.launches["match_batched"]
        rows, scalars = step(mesh, g, *args, p3p_trials=256)
        out.append((rows.cpu().numpy(), scalars.cpu().numpy(),
                    build.launches["match_batched"] - before))
    return out


def test_two_rank_registration_slots_equal_unsharded(dev):
    """The 32-slot register_view_batch and register_view_pairs steps split
    over two ranks sharing the card: every slot, on both ranks, gives the
    unsharded step's bits, each rank with one batched K1 launch."""
    from mavmap_tpu_torch.parallel import launch

    ranks = launch(_rank_register, 2, "cuda", timeout=300)
    for k, (step, (args, _)) in enumerate(zip((register_view_batch, register_view_pairs),
                                              _register_slots(dev))):
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        rows, scalars = step(g, *args, p3p_trials=256)
        for r in ranks:
            got_rows, got_scalars, k1 = r[k]
            assert k1 == 1
            assert np.array_equal(got_rows, rows.cpu().numpy(), equal_nan=True)
            assert np.array_equal(got_scalars, scalars.cpu().numpy(), equal_nan=True)
