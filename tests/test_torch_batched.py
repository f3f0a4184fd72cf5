"""The port's batched device steps as one batched computation (PyTorch only,
CPU tensors; the JAX comparison of the pose LM imports JAX inside its test).

  - each batched step (two_view_init_batch, register_view_batch,
    register_view_pairs) drawn from a seeded torch.Generator equals, slot
    by slot and bit for bit, its single step drawn from a generator
    seeded alike: the slots draw in slot order, as the single steps do;
  - the batched pose LM with slots that stop at different iterations
    (one stops at once, one whose normal equations are non-finite so every
    step is rejected, one still improving at max_iters) equals the loop
    at one slot bit for bit, and the JAX package's loop within 1e-5;
  - one pair and BATCH_CHUNK + 1 pairs through the mapper's chunking: the
    steps it runs (B = 1; B = 32 then 1) against the single steps on a
    generator in the same state, bit for bit;
  - the three batched steps run with vmap's per-sample fallback disabled
    (an op without a batching rule raises instead of looping per slot);
  - ops/reduce.py's elementwise_fixed gives each element of a long tensor
    the bits it has alone.
"""

import warnings

import numpy as np
import pytest
import torch

from mavmap_tpu_torch.ba.core import _pose_refine_loop
from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.models import camera as cam
from mavmap_tpu_torch.ops.projection import compose_proj_matrix, transform_points
from mavmap_tpu_torch.ops.reduce import elementwise_fixed
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import mapper as mapper_mod
from mavmap_tpu_torch.sfm.kernels import (
    register_view, register_view_batch, register_view_pairs, two_view_init,
    two_view_init_batch)
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

torch.set_num_threads(2)
F = 256
TRIALS = 64


@pytest.fixture(scope="module")
def scene_feats():
    scene = make_uav_scene(num_images=3, num_points=600, relief=10.0, seed=1)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=20, seed=1, max_features=F)
    return scene, feats, gt


def _image(scene, feats, i):
    kp, de = feats[i]
    n = len(kp)
    k = np.zeros((F, 2), np.float32)
    d = np.zeros((F, de.shape[1]), np.float32)
    m = np.zeros(F, bool)
    k[:n], d[:n], m[:n] = kp, de, True
    nrm = cam.image2normalized_np(k, 1, scene.cam_params[0]).astype(np.float32)
    return [torch.as_tensor(a) for a in (k, d, m, nrm)]


def _state(scene, gt, i, rng):
    ids = np.full(F, -1)
    ids[: len(gt[i])] = gt[i]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    stable = has_tri & (rng.random(F) < 0.9)
    xyz = np.zeros((F, 3), np.float32)
    xyz[has_tri] = scene.points3D[ids[has_tri]] + rng.normal(size=(has_tri.sum(), 3)) * 0.01
    return [torch.as_tensor(a) for a in (xyz, has_tri, stable, scene.rvecs[i].astype(np.float32),
                                         scene.tvecs[i].astype(np.float32))]


def _stack(items, k):
    return torch.stack([it[k] for it in items])


def _steps(scene, feats, gt):
    """(batched call, [single calls]) of each batched step at B = 3, as
    functions of a generator."""
    rng = np.random.default_rng(5)
    K = torch.as_tensor(scene.cam_params[0], dtype=torch.float32)
    nts = [4.0 / 700, 3.0 / 700, 5.0 / 700]
    first = _image(scene, feats, 0)
    cands = [_image(scene, feats, i) for i in (1, 2, 1)]
    two_view = (
        lambda g: two_view_init_batch(g, *first, *[_stack(cands, k) for k in range(4)], 0.9,
                                      1e9, nts, essential_trials=TRIALS),
        [lambda g, b=b: two_view_init(g, *first, *cands[b], 0.9, 1e9, nts[b],
                                      essential_trials=TRIALS) for b in range(3)])
    curr = _image(scene, feats, 2)
    prevs = [_image(scene, feats, i) for i in (1, 0, 1)]
    states = [_state(scene, gt, i, rng) for i in (1, 0, 1)]
    batch = (
        lambda g: register_view_batch(g, *[_stack(prevs, k) for k in range(4)], *curr,
                                      *[_stack(states, k) for k in range(5)], K, 1, 0.9, 1e9,
                                      nts[0], p3p_trials=TRIALS),
        [lambda g, b=b: register_view(g, *prevs[b], *curr, *states[b], K, 1, 0.9, 1e9, nts[0],
                                      p3p_trials=TRIALS) for b in range(3)])
    pairs = [(2, 1), (1, 0), (2, 0)]
    currs = [_image(scene, feats, c) for c, _ in pairs]
    prevs = [_image(scene, feats, p) for _, p in pairs]
    states = [_state(scene, gt, p, rng) for _, p in pairs]
    Ks = K.expand(3, -1).clone()
    Ks[1, 4:8] = torch.tensor([2e-3, -1e-3, 5e-4, -5e-4])
    codes = [1, 2, 1]
    pair = (
        lambda g: register_view_pairs(g, *[_stack(prevs, k) for k in range(4)],
                                      *[_stack(currs, k) for k in range(4)],
                                      *[_stack(states, k) for k in range(5)], Ks, codes, 0.9,
                                      1e9, nts, p3p_trials=TRIALS),
        [lambda g, b=b: register_view(g, *prevs[b], *currs[b], *states[b], Ks[b], codes[b],
                                      0.9, 1e9, nts[b], p3p_trials=TRIALS) for b in range(3)])
    return {"two_view_init_batch": two_view, "register_view_batch": batch,
            "register_view_pairs": pair}


@pytest.mark.parametrize("step", ["two_view_init_batch", "register_view_batch",
                                  "register_view_pairs"])
def test_batched_step_draws_equal_single_steps(scene_feats, step):
    batched, singles = _steps(*scene_feats)[step]
    rows, scalars = batched(torch.Generator().manual_seed(17))
    g = torch.Generator().manual_seed(17)
    for b, single in enumerate(singles):
        r, s = single(g)
        assert torch.equal(rows[b], r) and torch.equal(scalars[b], s), (step, b)
    assert (scalars[:, 3] > 20).all()  # E inliers / stable 2D-3D pairs


def test_batched_steps_need_no_per_sample_fallback(scene_feats):
    """torch.func.vmap (the pose LM's Jacobian runs under it) loops an op
    without a batching rule per sample and only warns; with the fallback
    disabled such an op raises."""
    steps = _steps(*scene_feats)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            for name, (batched, _) in steps.items():
                rows, scalars = batched(torch.Generator().manual_seed(3))
                assert torch.isfinite(scalars[:, :2]).all(), name
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _lm_slots():
    """Three pose-LM slots that stop apart: 0 starts at the loop's own
    converged pose (no step changes it), 1 has a NaN pixel in an
    observation it uses (every step non-finite, so rejected, to max_iters),
    2 starts far off (still improving after 3 iterations)."""
    rng = np.random.default_rng(11)
    N = 64
    K = np.array([700.0, 700.0, 400.0, 300.0, 0, 0, 0, 0, 0], np.float32)
    X = np.stack([rng.uniform(-5, 5, N), rng.uniform(-4, 4, N), rng.uniform(6, 12, N)], 1)
    pose = np.array([0.02, -0.01, 0.03, 0.3, -0.2, 0.5], np.float32)
    xc = transform_points(compose_proj_matrix(torch.as_tensor(pose[:3]),
                                              torch.as_tensor(pose[3:])),
                          torch.as_tensor(X, dtype=torch.float32))
    uv = cam.world2image(xc, 1, torch.as_tensor(K)).numpy() + rng.normal(size=(N, 2)) * 0.3
    uv[:2] += 40.0  # outliers for the Cauchy loss
    mask = rng.random(N) < 0.9
    starts = np.stack([pose, pose, pose + [0.05, -0.04, 0.03, 0.5, -0.4, 0.6]])
    slot = lambda a: np.stack([a] * 3)  # noqa: E731
    uvs = slot(uv)
    mask[3] = True
    uvs[1, 3, 0] = np.nan
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = [f32(starts), f32(slot(X)), f32(uvs), torch.as_tensor(slot(mask)), f32(slot(K))]
    # Slot 0 starts where the loop itself converges from a nearby pose.
    p0, _ = _pose_refine_loop(args[0][:1] + 1e-3, args[1][:1], args[2][:1], args[3][:1],
                              args[4][:1], [1], 1.0, 30)
    args[0][0] = p0[0]
    return args


def test_pose_refine_loop_slots_stop_apart_equal_one_slot_and_jax():
    args = _lm_slots()
    p, cost = _pose_refine_loop(*args[:5], [1, 1, 1], 1.0, 3)
    for b in range(3):
        pb, cb = _pose_refine_loop(*[a[b:b + 1] for a in args], [1], 1.0, 3)
        np.testing.assert_array_equal(p[b].numpy(), pb[0].numpy())  # NaN where NaN
        np.testing.assert_array_equal(cost[b].numpy(), cb[0].numpy())
    # The slots stop apart: 0 is left where it started, 1 rejects every step
    # and keeps its start, 2 still improves at the third iteration.
    p2, cost2 = _pose_refine_loop(*args[:5], [1, 1, 1], 1.0, 2)
    p4, cost4 = _pose_refine_loop(*args[:5], [1, 1, 1], 1.0, 4)
    assert torch.equal(p[0], args[0][0]) and torch.equal(p4[0], p[0])
    assert torch.equal(p[1], args[0][1]) and torch.isnan(cost[1])
    assert cost4[2] < cost[2] < cost2[2]

    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mavmap_tpu.ba.core import _pose_refine_loop as j_loop

    for b in range(3):
        pj, cj = j_loop(*[jnp.asarray(a[b].numpy()) for a in args], jnp.int32(1),
                        jnp.float32(1.0), 3)
        np.testing.assert_allclose(p[b].numpy(), np.asarray(pj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(cost[b].numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def small_mapper():
    scene = make_uav_scene(num_images=5, num_points=1200, relief=10.0, seed=1)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=30, seed=1, max_features=F)
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=F), device=torch.device("cpu"),
                         seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, final_cost_threshold=2.0,
                                   essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)
    assert m.process_initial(0, 1, dict_replace(opts, tri_min_angle=4.0))
    for i in range(2, 5):
        assert m.process(i, i - 1, opts)
    return m, opts


def dict_replace(opts, **kw):
    from dataclasses import replace

    return replace(opts, **kw)


@pytest.mark.parametrize("n", [1, SequentialMapper.BATCH_CHUNK + 1])
def test_mapper_chunks_equal_single_steps(small_mapper, monkeypatch, n):
    """batch_register_pairs over n closure pairs of registered images: the
    chunks it runs (B = n up to BATCH_CHUNK), and each slot against
    register_view drawn from a generator in the state its chunk started
    from, bit for bit (atan2 and pow take the CPU's scalar code for every
    element, ops/reduce.py, so a 32-slot chunk's SIMD runs change no bit).
    """
    m, opts = small_mapper
    calls = []
    real = mapper_mod.register_view_pairs

    def spy(gen, *args, **kw):
        state = gen.get_state()
        out = real(gen, *args, **kw)
        calls.append((state, args, kw, out))
        return out

    monkeypatch.setattr(mapper_mod, "register_view_pairs", spy)
    all_pairs = [(c, p) for c in range(5) for p in range(5) if abs(c - p) in (1, 2)]
    pairs = [all_pairs[k % len(all_pairs)] for k in range(n)]
    slots = m.report().get("batch_register_slots", 0)
    m.batch_register_pairs(pairs, opts, closure=True)
    assert [c[3][0].shape[0] for c in calls] == \
        ([1] if n == 1 else [SequentialMapper.BATCH_CHUNK, 1])
    assert m.report()["batch_register_slots"] == slots + n
    for state, args, kw, (rows, scalars) in calls:
        g = torch.Generator()
        g.set_state(state)
        B = rows.shape[0]
        for b in range(B):
            one = [a[b] for a in args[:14]] + [args[14][b], args[15], args[16], args[17][b]]
            r, s = register_view(g, *one, **kw)
            assert torch.equal(rows[b], r) and torch.equal(scalars[b], s)
    assert sum(int(c[3][1][:, 5].sum()) for c in calls) > 0  # some P3P succeeded


@pytest.mark.parametrize("fn, exponent", [(torch.atan2, None), (torch.pow, None),
                                          (torch.pow, 1.0 / 3.0)])
def test_elementwise_fixed_bits_do_not_depend_on_size(fn, exponent):
    """Each element of a 200-element call equals the call on that element
    alone (on the CPU, plain atan2 and pow differ in the last bit between
    the SIMD body of a long tensor and the scalar code of a short one)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.1, 3.0, 200).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=200).astype(np.float32))
    args = (x, exponent) if exponent is not None else (x, y)
    full = elementwise_fixed(fn, *args)
    for i in range(200):
        one = [a[i:i + 1] if torch.is_tensor(a) else a for a in args]
        assert torch.equal(full[i:i + 1], elementwise_fixed(fn, *one)), i
