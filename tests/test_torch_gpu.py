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
K2's one-pass path (a plan whose longest segment is within its
one_pass_limit) adds in plan order from 0.0: it equals the planned plain version run on a
CPU copy bit for bit, and so does the dense steps' per-(point, block)
aggregation.
K1 with a slot axis gives every slot the bits of the single-pair launch on
that slot's pair. The batched registration steps at 32 slots give every
slot the bits of register_view on the same pair with the same RANSAC
draws (their sums over a slot's rows and their per-slot 3x3 products add
in an order fixed by one slot's shapes: ops/reduce.py); the two-view step
gives its matches, inliers and counts, and its floats within
test_two_view_init_matches_jax's tolerances (the 5-point solver's GEMMs
over the trials pick their kernel by the batch). A 32-slot step repeats
bit for bit and syncs the host no more often than a 1-slot step; the vocabulary
tree quantizes as on the CPU except at near-ties (two centers within 1e-5
relative). The pose LM rejects a non-finite step on the card as on the
CPU. Its kernel K4 against the plain loop run on the same CUDA tensors
(PINHOLE, OPENCV, CATA and mixed slots, B = 1, 3, 32, 1024 rows): the
sums over a slot's rows add in another order, so the two loops take steps
that differ in their last bits, and near the minimum each accepts or
rejects a step by comparing two costs whose rounding error may reach
(N - 1) 2^-24 of the cost (a float32 sum of N positive terms). So the
final costs agree within twice that, 2 (N - 1) 2^-24 relative; K4's pose
is as good under the plain loop's cost within the same bound; and the
poses lie within 1e-3 of each other (a gross fault, not rounding). Slots
that stop apart as on the CPU; its bits repeat and do not depend on B;
one launch per registration step, and no CUDA tensor reaches the plain
loop. tests/test_torch_merge.py's restart-and-merge run repeats bit
for bit on the card, runs with index_add_ and accumulating index_put_
refused on CUDA tensors, and registers the same frames on the Python track
store as on the native one. Two ranks sharing the card (parallel.launch,
gloo) solve a point-sharded bundle adjustment twice with the same bits on
both ranks, and split the 32-slot registration steps with every slot
equal to the unsharded step's bits.
BAOptions(backend=...): "auto" and "pallas" run K2/K3 and give the same
bits; "xla" and "pallas_interpret" (the plain sums, whose K2 version adds
with index_add_'s atomics) raise on the card, naming the fixed-order rule,
and launch nothing. render_photo_survey on the card against the CPU on
tests/test_pipeline.py's real-photo scene: at most 1 gray level on at most
0.1 % of each frame's pixels (sin/cos and the rays @ R product round
differently on the card; truncation to uint8 turns that into single gray
levels). A dispatched chain's outputs are copied to pinned host memory
behind one CUDA event, which chain_complete waits for. The mapper's own
count of host syncs equals the sync debug mode's over a chain, a process,
a window bundle adjustment and a loop detection (with the event waits,
which the mode does not see, made visible to it).
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
    register_chain, register_view, register_view_batch, register_view_pairs, two_view_init,
    two_view_init_batch)
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
    """two_view_init_batch on the card at B = 8 and 32 (one first image
    against _register_inputs' three images in turn, a threshold per slot)
    against two_view_init per slot with generators seeded alike: every
    slot's rows and scalars equal bit for bit, as register_view's do. The
    5-point solver, the Sampson residuals and the other products over the
    slots' trials add in an order fixed by one trial's shapes
    (ops/essential.py, ops/reduce.py), where a batched matmul's cuBLAS
    kernel depends on the number of trials; and the 32-slot step repeats
    bit for bit."""
    scene, prevs, _, first = _register_inputs(dev)
    for B in (8, 32):
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
            assert torch.equal(rows[b], r1) and torch.equal(scalars[b], s1), (B, b)
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


# ------------------------------------------------- the pose LM, kernel K4

_LM_CAMERAS = {cam.PINHOLE: [651.123, 655.123, 386.123, 511.123, 0, 0, 0, 0, 0],
               cam.OPENCV: [651.123, 655.123, 386.123, 511.123, -0.171, 0.023, -0.001,
                            0.001, 0],
               cam.CATA: [651.123, 655.123, 386.123, 511.123, -0.171, 0.023, -0.001, 0.001,
                          0.5]}
_LM_CODES = {"pinhole": [cam.PINHOLE], "opencv": [cam.OPENCV], "cata": [cam.CATA],
             "mixed": [cam.PINHOLE, cam.OPENCV, cam.CATA]}


def _lm_case(dev, codes, B, N=1024, seed=0):
    """B pose-LM slots as a registration step hands them over: 1024 rows,
    the last 124 padding (mask off, points at the origin); 20 % outliers up
    to 60 px off, most of them and 10 % of the rest off the inlier mask;
    0.5 px noise; starts 0.01 rad and 0.1 m from the truth. Slot b takes
    camera codes[b % len(codes)]. Returns the loop's arguments on `dev`,
    code_ids as the registration step makes them (float32)."""
    rng = np.random.default_rng(seed)
    codes = [codes[b % len(codes)] for b in range(B)]
    X = np.stack([rng.uniform(-6, 6, (B, N)), rng.uniform(-5, 5, (B, N)),
                  rng.uniform(8, 14, (B, N))], -1).astype(np.float32)
    truth = np.concatenate([rng.normal(size=(B, 3)) * 0.05, rng.normal(size=(B, 3)) * 0.5], 1)
    K = np.array([_LM_CAMERAS[c] for c in codes], np.float32)
    uv = np.stack([cam.world2image(
        torch.as_tensor(X[b]) @ rotmat_from_rvec(torch.as_tensor(truth[b, :3], dtype=torch.float32)).T
        + torch.as_tensor(truth[b, 3:], dtype=torch.float32), c, torch.as_tensor(K[b])).numpy()
        for b, c in enumerate(codes)])
    uv = uv + rng.normal(size=uv.shape) * 0.5
    out = rng.random((B, N)) < 0.2
    uv[out] += rng.uniform(-60, 60, (int(out.sum()), 2))
    mask = ((rng.random((B, N)) < 0.25) | ~out) & (rng.random((B, N)) < 0.9)
    mask[:, 900:] = False
    X[:, 900:] = 0.0
    start = truth + np.concatenate([rng.normal(size=(B, 3)) * 0.01,
                                    rng.normal(size=(B, 3)) * 0.1], 1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return ([f32(start), f32(X), f32(uv), torch.as_tensor(mask, device=dev), f32(K)], codes,
            f32(codes) if len(set(codes)) > 1 else None)


@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("models", ["pinhole", "opencv", "cata", "mixed"])
def test_pose_lm_kernel_vs_plain(dev, models, B):
    """K4 (through _pose_refine_loop on CUDA tensors) against the plain loop
    on the same tensors, 30 iterations at most, within the float32 bounds
    of the module docstring; one launch."""
    args, codes, code_ids = _lm_case(dev, _LM_CODES[models], B)
    before = build.launches["pose_lm"]
    p, cost = ba_core._pose_refine_loop(*args, codes, 1.0, 30, code_ids)
    assert build.launches["pose_lm"] == before + 1
    pp, cp = ba_core._pose_refine_plain(*args, codes, 1.0, 30, code_ids)
    assert p.dtype == torch.float32 and p.shape == (B, 6) and cost.shape == (B,)
    assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(cost).all())
    rtol = 2 * (args[1].shape[1] - 1) * 2.0 ** -24
    assert float(((cost - cp).abs() / cp).max()) <= rtol
    at_kernel_pose = ba_core._pose_refine_plain(p, *args[1:], codes, 1.0, 0, code_ids)[1]
    assert bool((at_kernel_pose <= cp * (1 + rtol)).all())
    assert float((p - pp).abs().max()) <= 1e-3, (p - pp).abs().max(dim=1)
    start_cost = ba_core._pose_refine_plain(*args, codes, 1.0, 0, code_ids)[1]
    assert bool((cost < 0.9 * start_cost).all())  # the starts were off: every slot improved


def _lm_stop_apart_slots(dev):
    """tests/test_torch_batched.py's three slots that stop apart, on the
    card: 0 starts where K4 itself is left unmoved by 30 iterations, 1 has
    a NaN pixel in an observation it uses (every step non-finite, so
    rejected), 2 starts far off (still improving after 3 iterations)."""
    from mavmap_tpu_torch.ops.cuda.pose_lm import pose_lm

    rng = np.random.default_rng(11)
    N = 64
    K = np.array([700.0, 700.0, 400.0, 300.0, 0, 0, 0, 0, 0], np.float32)
    X = np.stack([rng.uniform(-5, 5, N), rng.uniform(-4, 4, N), rng.uniform(6, 12, N)], 1)
    pose = np.array([0.02, -0.01, 0.03, 0.3, -0.2, 0.5], np.float32)
    xc = torch.as_tensor(X, dtype=torch.float32) @ rotmat_from_rvec(
        torch.as_tensor(pose[:3])).T + torch.as_tensor(pose[3:])
    uv = cam.world2image(xc, 1, torch.as_tensor(K)).numpy() + rng.normal(size=(N, 2)) * 0.3
    uv[:2] += 40.0
    mask = rng.random(N) < 0.9
    mask[3] = True
    uvs = np.stack([uv] * 3)
    uvs[1, 3, 0] = np.nan
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = [f32(np.stack([pose, pose, pose + [0.05, -0.04, 0.03, 0.5, -0.4, 0.6]])),
            f32(np.stack([X] * 3)), f32(uvs), torch.as_tensor(np.stack([mask] * 3), device=dev),
            f32(np.stack([K] * 3))]
    p0 = args[0][:1] + 1e-3
    for _ in range(10):  # accepted steps only lower the cost, so this ends
        p1 = pose_lm(p0, *[a[:1] for a in args[1:]], [1], 1.0, 30)[0]
        if torch.equal(p1, p0):
            break
        p0 = p1
    args[0][0] = p0[0]
    return args


def test_pose_lm_kernel_slots_stop_apart(dev):
    """K4 with three slots that stop apart (_lm_stop_apart_slots), as the
    CPU test holds the plain loop: 0 is left where it started, 1 rejects
    every step, keeps its start and a NaN cost and runs every iteration, 2
    still improves at the third; each slot equals its one-slot launch."""
    from mavmap_tpu_torch.ops.cuda.pose_lm import pose_lm

    args = _lm_stop_apart_slots(dev)
    (p2, c2, _), (p, cost, iters), (p4, c4, _) = (pose_lm(*args, [1, 1, 1], 1.0, n)
                                                   for n in (2, 3, 4))
    assert torch.equal(p[0], args[0][0]) and torch.equal(p4[0], p[0])
    assert torch.equal(p[1], args[0][1]) and bool(torch.isnan(cost[1]))
    assert int(iters[1]) == 3 and int(iters[2]) == 3
    assert c4[2] < cost[2] < c2[2]
    for b in range(3):
        pb, cb, ib = pose_lm(*[a[b:b + 1] for a in args], [1], 1.0, 3)
        assert torch.equal(p[b], pb[0]) and torch.equal(cost[b:b + 1].isnan(), cb.isnan())
        assert torch.equal(cost[b].nan_to_num(), cb[0].nan_to_num()) and int(ib) == int(iters[b])


def test_pose_lm_kernel_bits_repeat_and_do_not_depend_on_b(dev):
    """A 32-slot K4 launch over mixed camera models, twice, gives the same
    bits, and every slot gives the bits of its own one-slot launch."""
    from mavmap_tpu_torch.ops.cuda.pose_lm import pose_lm

    args, codes, code_ids = _lm_case(dev, _LM_CODES["mixed"], 32, seed=5)
    ids = code_ids.to(torch.int32)
    first, second = (pose_lm(*args, codes, 1.0, 30, ids) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for b in range(32):
        one = pose_lm(*[a[b:b + 1] for a in args], codes[b:b + 1], 1.0, 30)
        for big, small in zip(first, one):
            assert torch.equal(big[b:b + 1], small), b


def test_pose_lm_launches_once_per_register_step(dev, monkeypatch):
    """register_view, register_view_batch and register_view_pairs (PINHOLE
    and OPENCV slots, B = 32) each launch K4 once, and no CUDA tensor
    reaches the plain loop."""
    plain = ba_core._pose_refine_plain

    def cpu_only(pose, *a, **kw):
        assert not pose.is_cuda, "a CUDA tensor reached the plain pose LM"
        return plain(pose, *a, **kw)

    monkeypatch.setattr(ba_core, "_pose_refine_plain", cpu_only)
    (batch, singles), (pairs, _) = _register_slots(dev)
    for step, args in ((register_view, singles[0]), (register_view_batch, batch),
                       (register_view_pairs, pairs)):
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        before = build.launches["pose_lm"]
        step(g, *args, p3p_trials=256)
        assert build.launches["pose_lm"] == before + 1, step.__name__


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


def _one_pass_case(rng, case):
    """(ids, S, K) of the one-pass edge cases (tests/test_torch_ba.py's):
    the last segment empty, every segment empty, a segment of exactly
    ONE_PASS_ROWS rows and of one row more (two passes), and plan_ptblk
    of a bucketed self-calibrating problem (padding rows in no segment)."""
    if case == "ptblk":
        ids, S = ba_core.plan_ids(_ba_problem(rng), "plan_ptblk")
        return ids.astype(np.int32), S, 54
    S, L = ka.ONE_PASS_SEGMENTS_PER_ROW - 8, ka.ONE_PASS_ROWS
    if case == "empty_last":
        ids = rng.integers(0, S - 1, size=8 * S)
    elif case == "all_empty":
        ids = rng.integers(S, 2 * S, size=300) * rng.choice([-1, 1], size=300)
    else:
        others = rng.integers(0, S, size=8 * S)
        ids = np.concatenate([others[others != 7], np.full(L + (case == "past_limit"), 7)])
    return rng.permutation(ids).astype(np.int32), S, 9


@pytest.mark.parametrize("case", ["empty_last", "all_empty", "at_limit", "past_limit", "ptblk"])
def test_seg_accum_one_pass_kernel_equals_cpu_planned_plain(dev, rng, case):
    """K2's one-pass path gives the bits of the planned plain version run
    on a CPU copy (each segment's rows in plan order from 0.0), counted as
    a one-pass launch, whether the plan is sparse (zeroed, then its filled
    segments summed: plan_ptblk, and a plan whose segments are all empty)
    or not; a plan with a segment past its one_pass_limit takes the two
    passes (held at 1e-5), and the one-pass kernel forced on it still
    gives the CPU's bits."""
    ids, S, K = _one_pass_case(rng, case)
    c = rng.normal(size=(len(ids), K)).astype(np.float32) * 10.0
    host = ka.make_plan(ids, S)
    assert host.one_pass == (case != "past_limit")
    assert host.sparse == (case in ("ptblk", "all_empty"))
    ref = ka.seg_accum_planned_plain(torch.as_tensor(c), host.to(torch.device("cpu")))
    cd = torch.as_tensor(c, device=dev)
    before = dict(build.launches)
    got = ka.seg_accum_full(cd, None, S, host.to(dev))
    assert build.launches["seg_accum_full"] == before["seg_accum_full"] + 1
    assert build.launches["seg_accum_full_one_pass"] == \
        before["seg_accum_full_one_pass"] + host.one_pass
    if host.one_pass:
        assert torch.equal(got.cpu(), ref)
    else:
        scale = ka.seg_accum_planned_plain(torch.as_tensor(np.abs(c)),
                                           host.to(torch.device("cpu")))
        assert bool(((got.cpu() - ref).abs() <= 1e-5 * scale + 1e-6).all())
        forced = ka.seg_accum_full(cd, None, S, host._replace(one_pass=True).to(dev))
        assert torch.equal(forced.cpu(), ref)
    if case == "all_empty":
        assert not got.any()


def test_seg_accum_one_pass_needs_its_offsets_on_the_card(dev):
    """A one-pass plan whose segment offsets stayed on the host (a two-pass
    plan moved, then marked one-pass) raises instead of launching."""
    host = ka.make_plan(np.zeros(64, np.int32), 4)
    plan = host._replace(one_pass=False).to(dev)._replace(one_pass=True)
    with pytest.raises(TypeError):
        ka.seg_accum_full(torch.zeros((64, 9), device=dev), None, 4, plan)


def test_ptblk_agg_on_the_card_equals_cpu(dev, rng):
    """The dense steps' per-(point, block) aggregation (_ptblk_agg by
    plan_ptblk and plan_ptimg, one one-pass K2 launch each) gives on the
    card the CPU's bits; padding rows, here given values, add to nothing."""
    host = ba_core.with_plans(_ba_problem(rng), ("plan_ptblk", "plan_ptimg"))
    gpu, cpu = (ba_core.problem_to_device(host, d) for d in (dev, torch.device("cpu")))
    O = host.obs_image.shape[0]
    for name, k, n in (("plan_ptblk", 27, 2), ("plan_ptimg", 18, 1)):
        assert getattr(host, name).one_pass
        T, G = ([rng.normal(size=(O, k)).astype(np.float32) for _ in range(n)]
                for _ in range(2))
        before = build.launches["seg_accum_full_one_pass"]
        got = ba_core._ptblk_agg(gpu, getattr(gpu, name),
                                 [torch.as_tensor(t, device=dev) for t in T],
                                 [torch.as_tensor(g, device=dev) for g in G])
        assert build.launches["seg_accum_full_one_pass"] == before + 1
        ref = ba_core._ptblk_agg(cpu, getattr(cpu, name), [torch.as_tensor(t) for t in T],
                                 [torch.as_tensor(g) for g in G])
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)


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
    pg, xg, ig = bundle_adjust(prob, opts, device=dev)
    assert build.launches["seg_accum_full"] > before["seg_accum_full"]
    assert build.launches["seg_accum_sorted"] > before["seg_accum_sorted"]
    pc, xc, ic = bundle_adjust(prob, opts, device=torch.device("cpu"))
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
    runs = [bundle_adjust(prob, opts, device=dev) for _ in range(2)]
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
    pd, _, infod = bundle_adjust(prob, BAOptions(**o, solver="dense"), device=dev)
    before = dict(build.launches)
    pc, _, infoc = bundle_adjust(prob, BAOptions(**o, solver="cg", cg_tol=1e-6), device=dev)
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


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_bundle_adjust_plain_backends_raise_on_the_card(dev, rng, backend):
    """The plain sums on a CUDA device would add by index_add_'s atomics:
    the solve raises naming the fixed-order rule before any launch, and
    neither runs K2/K3 nor falls back to the CPU."""
    prob = _ba_problem(rng)
    before = dict(build.launches)
    with pytest.raises(ValueError, match="fixed-order rule"):
        bundle_adjust(prob, BAOptions(max_num_iterations=2, backend=backend), device=dev)
    assert build.launches == before


def test_bundle_adjust_pallas_backend_launches_the_kernels(dev, rng):
    """backend "pallas" runs K2 and K3 on the card and gives the bits of
    "auto"."""
    prob = _ba_problem(rng)
    runs = []
    for backend in ("pallas", "auto"):
        before = dict(build.launches)
        runs.append(bundle_adjust(prob, BAOptions(max_num_iterations=4, backend=backend,
                                                  refine_camera_params=True), device=dev))
        for k in ("seg_accum_full", "seg_accum_sorted"):
            assert build.launches[k] > before[k], (backend, k)
    (p0, x0, i0), (p1, x1, i1) = runs
    assert np.array_equal(p0, p1) and np.array_equal(x0, x1)
    assert np.array_equal(i0["cam_params"], i1["cam_params"])


def test_render_photo_survey_on_the_card_matches_cpu(dev):
    """The real-photo renderer on the card against the CPU, on
    tests/test_pipeline.py's scene from the committed photographs: at most
    1 gray level on at most 0.1 % of each frame's pixels."""
    from mavmap_tpu_torch.utils.synthetic import load_sample_photos, render_photo_survey

    scene = make_uav_scene(num_images=6, num_points=10, relief=10.0, rows=1, seed=23)
    photos = load_sample_photos(torch.device("cpu"))
    cpu = render_photo_survey(scene, 4.0, 23, photos=photos, device="cpu")
    card = render_photo_survey(scene, 4.0, 23, photos=photos, device=dev)
    counts = []
    for a, b in zip(card, cpu):
        assert a.dtype == np.uint8 and a.shape == b.shape == (600, 800)
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        counts.append((int(d.max()), int((d > 0).sum())))
    assert all(m <= 1 and n <= 1e-3 * 600 * 800 for m, n in counts), counts


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


def test_chain_complete_reads_the_copies_issued_at_dispatch(dev):
    """A chain's rows, scalars and has_tri_in are copied to pinned host
    tensors when it is dispatched, behind one recorded CUDA event, and
    chain_complete reads those copies: they equal a blocking pull of the
    same outputs, and the chain commits with one pull."""
    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions

    scene = make_uav_scene(num_images=8, num_points=1300, relief=10.0, seed=2)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=2, max_features=256)
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=256), device=dev, seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, essential_ransac_trials=128,
                                   p3p_ransac_trials=128)
    assert m.process_initial(0, 1, opts)
    tok = m.chain_dispatch([2, 3], 1, opts)
    assert isinstance(tok.ready, torch.cuda.Event)
    assert all(h.device.type == "cpu" and h.is_pinned() for h in tok.host)
    tok.ready.synchronize()
    for h, t in zip(tok.host, tok.out[:3]):
        assert torch.equal(h, t.cpu())
    pulls = m.report().get("pulls", 0)
    assert m.chain_complete(tok) == [True, True]
    assert m.report()["pulls"] == pulls + 1


def test_host_syncs_equal_the_sync_debug_modes(dev, monkeypatch):
    """The mapper's host_syncs counter (utils/timer.sync, the program's own
    count) rises over one process_chain_k, one process, one window
    adjust_bundle and one detect_loop by what CUDA's sync debug mode counts
    there (utils/timer.count_syncs). The mode does not see an event wait
    (cudaEventSynchronize), which the program counts where a chain's host
    copies are waited for: here torch.cuda.Event.synchronize warns as the
    mode does."""
    import warnings

    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.loop import LoopDetector
    from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions

    wait = torch.cuda.Event.synchronize

    def seen_wait(self):
        warnings.warn("called a synchronizing CUDA operation (cudaEventSynchronize)")
        return wait(self)

    monkeypatch.setattr(torch.cuda.Event, "synchronize", seen_wait)
    count_syncs(lambda: None)  # the mode's first use in a process may warn once, from torch
    scene = make_uav_scene(num_images=16, num_points=2400, relief=10.0, rows=2, extent=None,
                           seed=13)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=13, max_features=512)
    desc = np.concatenate([d for _, d in feats[::3]])
    tree = train_voc_tree(desc[np.random.default_rng(0).permutation(len(desc))[:4000]],
                          branching=8, depth=2, iters=3, device=dev)
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=512),
                         loop_detector=LoopDetector(tree), device=dev, seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, essential_ransac_trials=256,
                                   p3p_ransac_trials=256)
    window_ba = BAOptions(max_num_iterations=6, refine_camera_params=True)
    assert m.process_initial(0, 1, SequentialMapperOptions(
        tri_min_angle=4.0, essential_ransac_trials=256, p3p_ransac_trials=256))

    def held(name, call):
        sites = []
        before = m.counters.get("host_syncs", 0)
        n, _ = count_syncs(call, sites)
        assert m.counters.get("host_syncs", 0) - before == n, (name, n, sites)
        assert n > 0, name

    def chain():
        last = max(m.image_idx_to_id)
        return m.process_chain_k(list(range(last + 1, last + 5)), last, opts, pad_to=4)

    def window():
        w = sorted(m.image_idx_to_id)[-6:]
        return w[2:], w[:2]

    held("process_chain_k", chain)
    m.adjust_bundle(*window(), ba_options=window_ba, async_=True, defer=True)
    held("process_chain_k after a window", chain)
    held("window adjust_bundle", lambda: m.adjust_bundle(*window(), ba_options=window_ba))
    m.adjust_bundle(*window(), ba_options=window_ba, async_=True, defer=True)
    last = max(m.image_idx_to_id)
    held("process", lambda: m.process(last + 1, last, opts))
    held("detect_loop", lambda: m.detect_loop(max(m.image_idx_to_id), num_images=6,
                                              num_nh_images=15, nh_distance=3, options=opts))
    assert m.num_proc_images >= 10


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
        r, t, cost = pose_refinement(r0, t0, X, uv, np.ones(64, bool), K, 1, device=d)
        assert np.array_equal(r.cpu().numpy(), r0) and np.array_equal(t.cpu().numpy(), t0)
        assert not bool(torch.isfinite(cost))


# ------------------------------------------------- cameras of several models

# tests/test_torch_rig.py's three cameras: PINHOLE, OPENCV, CATA (OPENCV's
# parameters plus xi 0.5).
_PINHOLE = [651.123, 655.123, 386.123, 511.123]
_OPENCV = _PINHOLE + [-0.171, 0.023, -0.001, 0.001]
_CATA = _OPENCV + [0.5]


def _three_camera_arrays(rng, I=12, P=300, per_image=250, noise=0.3, focal_err=0.0):
    """tests/test_torch_rig.py's three-camera problem (image i seen by
    camera i % 3), its points projected by the port's camera models."""
    K = np.zeros((3, 9), np.float32)
    K[0, :4], K[1, :8], K[2] = _PINHOLE, _OPENCV, _CATA
    models = np.array([cam.PINHOLE, cam.OPENCV, cam.CATA], np.int32)
    X = (rng.normal(size=(P, 3)) * [8, 10, 2] + [0, 0, 14]).astype(np.float32)
    poses = np.concatenate([rng.normal(size=(I, 3)) * 0.03,
                            np.stack([np.arange(I) * 0.7, np.zeros(I), np.zeros(I)], 1)],
                           axis=1).astype(np.float32)
    R = rotmat_from_rvec(torch.as_tensor(poses[:, :3])).numpy()
    oi, op, oc, uv = [], [], [], []
    for i in range(I):
        c = i % 3
        Xc = (X @ R[i].T + poses[i, 3:]).astype(np.float32)
        u = cam.world2image(torch.as_tensor(Xc), int(models[c]), torch.as_tensor(K[c])).numpy()
        sel = np.sort(rng.permutation(P)[:per_image])
        oi += [i] * len(sel)
        op += list(sel)
        oc += [c] * len(sel)
        uv += list(u[sel] + rng.normal(size=(len(sel), 2)) * noise)
    poses0 = poses + rng.normal(size=poses.shape).astype(np.float32) * [0.003] * 3 \
        + np.concatenate([np.zeros((I, 3)), rng.normal(size=(I, 3)) * 0.02], 1)
    poses0[:2] = poses[:2]
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    K0 = K.copy()
    K0[:, :2] *= 1.0 + focal_err
    return (poses0.astype(np.float32), X0.astype(np.float32), K0, models,
            np.array(oi, np.int32), np.array(op, np.int32), np.array(oc, np.int32),
            np.array(uv, np.float32)), [1, 2] + [0] * (I - 2)


@pytest.mark.parametrize("solver,refine", [("dense", False), ("cg", False), ("dense", True),
                                           ("cg", True)])
def test_bundle_adjust_three_camera_models_gpu_vs_cpu(dev, rng, solver, refine):
    """The PINHOLE + OPENCV + CATA problem solved on the card (K2 with three
    camera blocks, K3) against the CPU path, 12 iterations. Tolerances,
    relative to each array's largest entry: poses and points at 1e-3 with
    fixed intrinsics (test_bundle_adjust_gpu_vs_cpu's), 3e-3 with refined
    ones; PINHOLE and OPENCV intrinsics at 2e-3, CATA's at 1e-2 with its
    projections within 0.25 px (its f, xi, k1 and k2 all bend the image
    radially); the final cost at 1e-4 (1e-3 for CG with refined
    intrinsics, whose forcing term sets each solve's tolerance). The card
    sums in another order than the CPU, a change of rounding: on the CPU a
    3e-7 relative change of the observations moves this problem's solve by
    up to 5e-5 of the points with fixed intrinsics and 6.6e-4 of the points
    and 4.7e-4 of the intrinsics with refined ones. A second solve on the
    card gives the same bits."""
    args, states = _three_camera_arrays(rng, focal_err=0.01 if refine else 0.0)
    prob = build_problem(*args, pose_states=states, bucket=True)
    opts = BAOptions(max_num_iterations=12, solver=solver, refine_camera_params=refine,
                     function_tolerance=0.0)
    before = dict(build.launches)
    pg, xg, ig = bundle_adjust(prob, opts, device=dev)
    assert build.launches["seg_accum_full"] > before["seg_accum_full"]
    assert build.launches["seg_accum_sorted"] > before["seg_accum_sorted"]
    pc, xc, ic = bundle_adjust(prob, opts, device=torch.device("cpu"))
    assert ig["iterations"] == ic["iterations"] == 12 and ig["solver"] == solver
    assert ic["final_cost"] < 0.1 * ic["initial_cost"]
    tol = 3e-3 if refine else 1e-3
    for g, c in ((pg, pc), (xg, xc)):
        np.testing.assert_allclose(g, c, rtol=0, atol=tol * np.abs(c).max())
    np.testing.assert_allclose(ig["final_cost"], ic["final_cost"],
                               rtol=1e-3 if (refine and solver == "cg") else 1e-4)
    if refine:
        kg, kc = ig["cam_params"], ic["cam_params"]
        for c, ctol in ((0, 2e-3), (1, 2e-3), (2, 1e-2)):
            np.testing.assert_allclose(kg[c], kc[c], rtol=0, atol=ctol * np.abs(kc[c]).max())
        grid = torch.as_tensor((rng.normal(size=(500, 3)) * [8, 10, 2]
                                + [0, 0, 14]).astype(np.float32))
        ug = cam.world2image(grid, cam.CATA, torch.as_tensor(kg[2]))
        uc = cam.world2image(grid, cam.CATA, torch.as_tensor(kc[2]))
        assert float((ug - uc).abs().max()) < 0.25
    p2, x2, i2 = bundle_adjust(prob, opts, device=dev)
    assert np.array_equal(p2, pg) and np.array_equal(x2, xg)
    assert i2["final_cost"] == ig["final_cost"]
    if refine:
        assert np.array_equal(i2["cam_params"], ig["cam_params"])


def test_register_chain_alternating_cameras_gpu_vs_cpu(dev, monkeypatch):
    """One register_chain of four frames that alternate a PINHOLE and an
    OPENCV camera (make_multi_camera_scene; each frame's model code,
    intrinsics and thresholds packed in scal), anchored on frame 1, on the
    card (K1) against the CPU path with the CPU run's RANSAC samples
    injected: match rows, counts and anchor states exactly equal, refined
    poses at 1e-4 (tests/test_torch_sfm.py's tolerances against the JAX
    package), the end state's flags exactly and its pose at 1e-4."""
    from mavmap_tpu_torch.sfm import kernels as kern
    from mavmap_tpu_torch.utils.synthetic import make_multi_camera_scene

    F, K, frames = 512, 4, [2, 3, 4, 5]
    scene = make_multi_camera_scene(num_images=6, num_points=1500, relief=10.0, seed=3)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=20, seed=3, max_features=F)
    rng = np.random.default_rng(3)

    def frame(i, d):
        kp, de = feats[i]
        k, dd, m = np.zeros((F, 2), np.float32), np.zeros((F, 128), np.float32), np.zeros(F, bool)
        k[:len(kp)], dd[:len(kp)], m[:len(kp)] = kp, de, True
        c = scene.image_cameras[i]
        n = cam.image2normalized_np(k, int(scene.cam_models[c]), scene.cam_params[c])
        return tuple(torch.as_tensor(a, device=d) for a in (k, dd, m, n.astype(np.float32)))

    ids = np.full(F, -1)
    ids[:len(gt[1])] = gt[1]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    lens = np.where(has_tri, rng.integers(2, 4, F), 0)
    track_state = np.zeros((F, 7), np.float32)
    track_state[has_tri, :3] = scene.points3D[ids[has_tri]] + rng.normal(
        size=(has_tri.sum(), 3)) * 0.01
    track_state[:, 3], track_state[:, 4] = has_tri, has_tri & (lens >= 2)
    track_state[:, 5], track_state[:, 6] = lens, -1.0
    scal = np.zeros(12 + 12 * K, np.float32)
    scal[0:3], scal[3:6] = scene.rvecs[1], scene.tvecs[1]
    scal[6], scal[7] = 0.9, 1e9
    scal[8], scal[9], scal[10], scal[11] = np.deg2rad(1.0), 2, 1, -1
    per = scal[12:].reshape(K, 12)
    for k, i in enumerate(frames):
        p = scene.cam_params[scene.image_cameras[i]]
        per[k, 0] = per[k, 1] = 8.0 / float(p[0] + p[1])
        per[k, 2] = scene.cam_models[scene.image_cameras[i]]
        per[k, 3:12] = p
    assert list(per[:, 2]) == [cam.PINHOLE, cam.OPENCV] * 2

    drawn = []
    draw = kern.draw_samples

    def recording(*a, **kw):
        drawn.append(draw(*a, **kw))
        return drawn[-1]

    monkeypatch.setattr(kern, "draw_samples", recording)
    cpu = torch.device("cpu")
    g = torch.Generator()
    g.manual_seed(5)
    out_c = [o.numpy() for o in register_chain(
        g, *frame(1, cpu), tuple(frame(i, cpu) for i in frames), track_state, scal,
        p3p_trials=256)]
    monkeypatch.setattr(kern, "draw_samples", draw)
    samples = [tuple(s[0].to(dev) for s in d) for d in drawn]
    assert len(samples) == K
    before = build.launches["match"]
    out_g = [o.cpu().numpy() for o in register_chain(
        None, *frame(1, dev), tuple(frame(i, dev) for i in frames), track_state, scal,
        p3p_trials=256, samples=samples)]
    assert build.launches["match"] == before + K
    (rows_c, sc_c, ht_c, es_c, ep_c), (rows_g, sc_g, ht_g, es_g, ep_g) = out_c, out_g
    np.testing.assert_array_equal(ht_g, ht_c)
    for k in range(K):
        np.testing.assert_array_equal(rows_g[k, :, :3], rows_c[k, :, :3])
        np.testing.assert_array_equal(sc_g[k, [0, 2, 3, 4, 5]], sc_c[k, [0, 2, 3, 4, 5]])
        assert sc_c[k, 5] == 1.0 and sc_c[k, 4] > 20
        np.testing.assert_allclose(sc_g[k, 7:13], sc_c[k, 7:13], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(es_g[:, 3:], es_c[:, 3:])
    np.testing.assert_allclose(ep_g, ep_c, rtol=0, atol=1e-4)


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
                                        function_tolerance=0.0), device=dev)
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
