"""The mapper's device steps and the whole per-frame slice, PyTorch port vs
JAX package.

  - two_view_init / register_view with the JAX package's RANSAC samples
    injected (jax.random and torch.Generator draw different numbers):
    match rows exactly equal, equal inlier counts, the refined pose at
    1e-4 (the two-view pose, read off an f32 SVD, at 1e-3);
  - the whole slice (tests/test_sfm.py's 8-image configuration) through
    both mappers: outcome-based, since the two PRNGs differ — both
    register 8/8 with ATE < 0.1 m, and the port's ATE is at most
    max(2 x JAX's, 0.02 m).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ba import BAOptions as JBAOptions
from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.models import camera as jcam
from mavmap_tpu.ops.ransac import sample_indices
from mavmap_tpu.sfm import SequentialMapper as JMapper, SequentialMapperOptions as JOpts
from mavmap_tpu.sfm.kernels import register_view as j_register, two_view_init as j_two_view
from mavmap_tpu.utils.synthetic import (
    make_uav_scene as j_scene, mapper_ate as j_ate, render_features as j_render)

from mavmap_tpu_torch.ba import BAOptions
from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.interop import cameras_to_device, features_to_device
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm.kernels import register_view, two_view_init
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, mapper_ate, render_features

torch.set_num_threads(2)
CPU = torch.device("cpu")
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
    nrm = jcam.image2normalized_np(k, 1, scene.cam_params[0]).astype(np.float32)
    return k, d, m, nrm


def test_synthetic_scene_matches_jax(scene_feats):
    scene, feats, gt = scene_feats
    js = j_scene(num_images=3, num_points=600, relief=10.0, seed=1)
    jf, jg = j_render(js, pixel_noise=0.3, clutter=20, seed=1, max_features=F)
    np.testing.assert_allclose(scene.rvecs, js.rvecs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(scene.points3D, js.points3D)
    for (k, d), (kj, dj), g, gj in zip(feats, jf, gt, jg):
        np.testing.assert_array_equal(g, gj)
        np.testing.assert_allclose(k, kj, rtol=0, atol=1e-3)  # px
        np.testing.assert_array_equal(d, dj)


def test_interop_features_and_cameras_from_jax(scene_feats):
    """The JAX provider's padded features and the scene's camera arrays
    convert to the port's tensors exactly."""
    scene, feats, _ = scene_feats
    jf = JProvider(feats, capacity=F).get(1)
    kp, de, m = features_to_device(jf, CPU)
    ref = ArrayFeatureProvider(feats, capacity=F).get(1)
    np.testing.assert_array_equal(kp.numpy(), ref.keypoints)
    np.testing.assert_array_equal(de.numpy(), ref.descriptors)
    np.testing.assert_array_equal(m.numpy(), ref.mask)
    assert m.dtype == torch.bool and int(m.sum()) == len(feats[1][0])
    params, models = cameras_to_device(scene.cam_params, scene.cam_models, CPU)
    assert params.dtype == torch.float32 and models.dtype == torch.int32
    np.testing.assert_array_equal(params.numpy(), np.asarray(scene.cam_params, np.float32))
    np.testing.assert_array_equal(models.numpy(), scene.cam_models)


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def test_two_view_init_matches_jax(scene_feats):
    scene, feats, _ = scene_feats
    a, b = _image(scene, feats, 0), _image(scene, feats, 1)
    nt = 4.0 / 700.0
    key = jax.random.PRNGKey(5)
    rows_j, sc_j = j_two_view(key, *map(jnp.asarray, a + b), jnp.float32(0.9),
                              jnp.float32(1e9), jnp.float32(nt), essential_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    valid = jnp.asarray(rows_j[:, 1] > 0.5)
    k_h, k_e = jax.random.split(key)
    samples = (np.asarray(sample_indices(k_h, 128, 4, F, valid)),
               np.asarray(sample_indices(k_e, TRIALS, 5, F, valid)))
    rows_t, sc_t = two_view_init(None, *_t(*(a + b)), 0.9, 1e9, nt,
                                 essential_trials=TRIALS, samples=samples)
    rows_t, sc_t = rows_t.numpy(), sc_t.numpy()
    np.testing.assert_array_equal(rows_t[:, :3], rows_j[:, :3])  # matches, valid, inliers
    np.testing.assert_array_equal(sc_t[[0, 2, 3]], sc_j[[0, 2, 3]])  # counts
    assert sc_t[3] > 40
    # rvec2 and the unit t come straight from E — an f32 eigh/SVD of the
    # 8-point normal matrix, which LAPACK and XLA round apart by ~eps*cond:
    # 1e-3 here (register_view's LM-refined pose below holds 1e-4).
    np.testing.assert_allclose(sc_t[6:12], sc_j[6:12], rtol=0, atol=1e-3)
    np.testing.assert_allclose(sc_t[1], sc_j[1], rtol=1e-5)  # median disparity
    # z-component and mean triangulation angle follow the pose: 1e-3.
    np.testing.assert_allclose(sc_t[[4, 5]], sc_j[[4, 5]], rtol=1e-3)
    inl = rows_j[:, 2] > 0.5
    np.testing.assert_allclose(rows_t[inl, 6:9], rows_j[inl, 6:9], rtol=1e-3, atol=1e-3)


def test_register_view_matches_jax(scene_feats, rng):
    scene, feats, gt = scene_feats
    p, c = _image(scene, feats, 1), _image(scene, feats, 2)
    ids = np.full(F, -1)
    ids[: len(gt[1])] = gt[1]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    stable = has_tri & (rng.random(F) < 0.9)
    xyz = np.zeros((F, 3), np.float32)
    xyz[has_tri] = scene.points3D[ids[has_tri]] + rng.normal(size=(has_tri.sum(), 3)) * 0.01
    rv, tv = scene.rvecs[1], scene.tvecs[1]
    K = scene.cam_params[0]
    nt = 4.0 / 700.0
    key = jax.random.PRNGKey(9)
    rows_j, sc_j = j_register(
        key, *map(jnp.asarray, p + c), jnp.asarray(xyz), jnp.asarray(has_tri),
        jnp.asarray(stable), jnp.asarray(rv), jnp.asarray(tv), jnp.asarray(K),
        jnp.asarray(1, jnp.int32), jnp.float32(0.9), jnp.float32(1e9), jnp.float32(nt),
        p3p_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    valid = rows_j[:, 1] > 0.5
    k_h, k_p = jax.random.split(key)
    samples = (np.asarray(sample_indices(k_h, 128, 4, F, jnp.asarray(valid))),
               np.asarray(sample_indices(k_p, TRIALS, 4, F,
                                         jnp.asarray(valid & stable & has_tri))))
    rows_t, sc_t = register_view(
        None, *_t(*(p + c)), *_t(xyz, has_tri, stable, rv, tv, K), 1, 0.9, 1e9, nt,
        p3p_trials=TRIALS, samples=samples)
    rows_t, sc_t = rows_t.numpy(), sc_t.numpy()
    np.testing.assert_array_equal(rows_t[:, :3], rows_j[:, :3])
    counts = [0, 2, 3, 4, 5]  # matches, hom/stable/P3P inliers, success
    np.testing.assert_array_equal(sc_t[counts], sc_j[counts])
    np.testing.assert_allclose(sc_t[1], sc_j[1], rtol=1e-5)  # median disparity
    assert sc_t[5] == 1.0 and sc_t[4] > 20
    np.testing.assert_allclose(sc_t[7:13], sc_j[7:13], rtol=0, atol=1e-4)  # refined pose
    np.testing.assert_allclose(sc_t[6], sc_j[6], rtol=1e-3)  # final cost (px)
    m = rows_j[:, 1] > 0.5
    np.testing.assert_allclose(rows_t[m, 3:6], rows_j[m, 3:6], rtol=1e-3, atol=1e-5)


def test_mapper_two_stage_selfcal_gcps_and_problem_arrays(scene_feats):
    """adjust_bundle's two-stage self-calibration (intrinsics refined on a
    subsample, then the full problem with them fixed), GCP pinning, and
    ba_problem_arrays, on a 3-image map with a 1 % focal error."""
    scene, feats, _ = scene_feats
    K = scene.cam_params.copy()
    K[0, :2] *= 1.01
    m = SequentialMapper(scene.image_cameras, scene.cam_models, K,
                         ArrayFeatureProvider(feats, capacity=F), CPU, seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, final_cost_threshold=2.0,
                                   essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)
    assert m.process_initial(0, 1, opts) and m.process(2, 1, opts)

    ids, poses, pids, pts, oi, op, oc, xy = m.ba_problem_arrays()
    assert ids == [0, 1, 2] and len(pids) == m.store.num_points3D
    np.testing.assert_array_equal(poses[:, :3], m.store.image_rvecs[ids].astype(np.float32))
    assert oi.max() < 3 and op.max() < len(pids) and (oc == 0).all() and len(xy) == len(oi)

    gcps = pids[:3]
    pinned = m.store.point3D_xyz[gcps].copy()
    info = m.adjust_bundle([2], [0], [1], gcp_point_ids=gcps, ba_options=BAOptions(
        refine_camera_params=True, selfcal_max_obs=len(oi) // 2, max_num_iterations=10))
    rep = m.report()
    assert rep["ba_selfcal_iters"] > 0 and rep["ba_iters"] > 0
    assert "cam_params" not in info  # stage 2 holds the intrinsics fixed
    np.testing.assert_allclose(m.cam_params[0], m.store.camera_params[0], rtol=1e-6)
    assert abs(m.cam_params[0, 0] - 700.0) < 7.0  # moved toward the truth
    np.testing.assert_array_equal(m.store.point3D_xyz[gcps], pinned)


def _run(mapper, n, opts, init_opts, ba_options_cls):
    """tests/test_sfm.py's loop: window-8 BA after each registration."""
    assert mapper.process_initial(0, 1, init_opts)
    last = 1
    for i in range(2, n):
        if mapper.process(i, last, opts):
            last = i
            window = sorted(mapper.image_idx_to_id)[-8:]
            if len(window) > 2:
                mapper.adjust_bundle(window[2:], window[:2],
                                     ba_options=ba_options_cls(max_num_iterations=8))
    mapper.adjust_global_bundle(ba_options_cls(max_num_iterations=30))


def test_sequential_mapping_slice_matches_jax():
    """tests/test_sfm.py's configuration through both mappers."""
    kw = dict(tri_min_angle=1.0, final_cost_threshold=2.0,
              essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)
    ikw = dict(kw, tri_min_angle=4.0)

    scene = make_uav_scene(num_images=8, num_points=1200, relief=10.0, seed=1)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=30, seed=1)
    cap = int(np.ceil(max(len(k) for k, _ in feats) / 256)) * 256
    mt = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                          ArrayFeatureProvider(feats, capacity=cap), CPU, seed=0)
    _run(mt, 8, SequentialMapperOptions(**kw), SequentialMapperOptions(**ikw), BAOptions)

    js = j_scene(num_images=8, num_points=1200, relief=10.0, seed=1)
    jf, _ = j_render(js, pixel_noise=0.3, clutter=30, seed=1)
    mj = JMapper(js.image_cameras, js.cam_models, js.cam_params,
                 JProvider(jf, capacity=cap), seed=0, store_backend="python")
    _run(mj, 8, JOpts(**kw), JOpts(**ikw), JBAOptions)

    ate_t, ate_j = mapper_ate(mt, scene), j_ate(mj, js)
    assert int(mt.store.image_registered.sum()) == 8
    assert int(mj.store.image_registered.sum()) == 8
    assert ate_j < 0.1 and ate_t < 0.1
    assert ate_t <= max(2.0 * ate_j, 0.02), (ate_t, ate_j)
    assert mt.store.num_points3D > 200
    assert mt.report()["ba_iters"] > 0


def test_count_time_rounds_only_on_report():
    """Deliberate divergence: the JAX mapper rounds accumulated seconds on
    every add (sfm/mapper.py:147-149), so 1000 solves of 4 ms count as 0;
    the port accumulates exactly and rounds in report()."""
    m = SequentialMapper(np.zeros(1, np.int32), np.ones(1, np.int32),
                         np.zeros((1, 9), np.float32), ArrayFeatureProvider([]), CPU)
    for _ in range(1000):
        m._count_time("ba_solve_s", 0.004)
    assert abs(m.counters["ba_solve_s"] - 4.0) < 1e-9
    assert m.report()["ba_solve_s"] == 4.0
    j = JMapper.__new__(JMapper)
    j.counters = {}
    for _ in range(1000):
        j._count_time("ba_solve_s", 0.004)
    assert j.counters["ba_solve_s"] == 0.0
