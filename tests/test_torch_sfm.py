"""The mapper's device steps and the whole per-frame slice, PyTorch port vs
JAX package.

  - two_view_init / register_view with the JAX package's RANSAC samples
    injected (jax.random and torch.Generator draw different numbers):
    match rows exactly equal, equal inlier counts, the refined pose at
    1e-4 (the two-view E, refit in f64 by the port, against an f64 refit
    at 1e-5 and the pose against the JAX package's recovery from it);
  - the whole slice (tests/test_sfm.py's 8-image configuration) through
    both mappers: outcome-based, since the two PRNGs differ — both
    register 8/8 with ATE < 0.1 m, and the port's ATE is at most
    max(2 x JAX's, 0.02 m);
  - chained registration: _derive_chain_state exactly equal on the same
    rows; register_chain (K=3) with every frame's RANSAC samples derived
    from the JAX package's in-program keys: match rows and counts exactly
    equal, refined poses at 1e-4; the chained loop with deferred window BA
    of tests/test_sfm.py through both mappers (outcome-based, as above:
    14/14 each, the port's ATE at most max(2 x JAX's, 0.02 m)); and the
    deferred/asynchronous BA schedule itself;
  - the batched steps (two_view_init_batch, register_view_batch,
    register_view_pairs) with every slot's samples derived from the JAX
    package's keys (jax.random.split(key, B), then the step's own split):
    per slot, match rows and counts exactly equal to JAX and the refined
    pose at 1e-4 (register_view's tolerances), and every slot equal bit
    for bit to the port's single-pair step on the same samples; with a
    threshold per slot, and with PINHOLE and OPENCV slots in one call.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ba import BAOptions as JBAOptions
from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.models import camera as jcam
from mavmap_tpu.ops import essential as jess
from mavmap_tpu.ops import projection as jproj
from mavmap_tpu.ops import rotation as jrot
from mavmap_tpu.ops import triangulation as jtri
from mavmap_tpu.ops.ransac import ransac as jransac
from mavmap_tpu.ops.ransac import sample_indices
from mavmap_tpu.sfm import SequentialMapper as JMapper, SequentialMapperOptions as JOpts
from mavmap_tpu.sfm.kernels import (
    _derive_chain_state as j_derive, register_chain as j_register_chain,
    register_view as j_register, register_view_batch as j_register_batch,
    register_view_pairs as j_register_pairs, two_view_init as j_two_view,
    two_view_init_batch as j_two_view_batch)
from mavmap_tpu.utils.synthetic import (
    make_uav_scene as j_scene, mapper_ate as j_ate, render_features as j_render)

from mavmap_tpu_torch.ba import BAOptions
from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.interop import cameras_to_device, features_to_device
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import mapper as mapper_mod
from mavmap_tpu_torch.sfm.kernels import (
    _derive_chain_state, register_chain, register_view, register_view_batch,
    register_view_pairs, two_view_init, two_view_init_batch)
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
    # Deliberate divergence: the 8-point refit of E solves in f64 here, in
    # f32 in the JAX package (off by up to 1e-2 of E; ops/essential.py).
    # So E is held to an f64 refit on the same RANSAC inliers at 1e-5, and
    # the pose to the JAX package's pose recovery from that E at 1e-4.
    x1, x2 = a[3], b[3][np.maximum(rows_j[:, 0].astype(int), 0)]
    inl = np.asarray(jransac(k_e, jnp.asarray(x1), jnp.asarray(x2), jess.solve_essential_5pt,
                             jess.abs_sampson_residuals, sample_size=5, num_trials=TRIALS,
                             threshold=nt, valid_mask=valid).inlier_mask).astype(np.float64)
    p, q = x1.astype(np.float64), x2.astype(np.float64)
    D = np.stack([q[:, 0] * p[:, 0], q[:, 0] * p[:, 1], q[:, 0], q[:, 1] * p[:, 0],
                  q[:, 1] * p[:, 1], q[:, 1], p[:, 0], p[:, 1], np.ones(F)], 1) * inl[:, None]
    U, sv, Vt = np.linalg.svd(np.linalg.svd(D)[2][-1].reshape(3, 3))
    E_ref = U @ np.diag([(sv[0] + sv[1]) / 2] * 2 + [0.0]) @ Vt
    E_ref /= np.linalg.norm(E_ref)
    E_t = sc_t[12:21].reshape(3, 3)
    if min(np.abs(E_t - E_ref).max(), np.abs(E_t + E_ref).max()) > 1e-5:
        E_ref = sc_j[12:21].reshape(3, 3)  # the RANSAC model won: the same in both
        np.testing.assert_allclose(E_t, E_ref, rtol=0, atol=1e-5)
    R_e, t_e, _ = jess.pose_from_essential_matrix(jnp.asarray(E_ref, jnp.float32),
                                                  jnp.asarray(x1), jnp.asarray(x2),
                                                  jnp.asarray(rows_j[:, 2] > 0.5))
    np.testing.assert_allclose(sc_t[6:9], np.asarray(jrot.rvec_from_rotmat(R_e)), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(sc_t[9:12], np.asarray(t_e), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sc_t[1], sc_j[1], rtol=1e-5)  # median disparity
    # z-component, mean triangulation angle and points follow the pose: the
    # JAX package's own functions on the reference pose, at 1e-3.
    inl = rows_j[:, 2] > 0.5
    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = jnp.concatenate([R_e, t_e[:, None]], axis=1)
    X = jtri.triangulate_points(P1, P2, jnp.asarray(x1), jnp.asarray(x2))
    ang = np.asarray(jtri.calc_tri_angles(P1, P2, X))
    angf = np.where(inl, np.minimum(ang, np.pi - ang), 0.0)
    z_comp = abs(float(jproj.invert_proj_matrix(P2)[2, 3]))
    np.testing.assert_allclose(sc_t[[4, 5]], [z_comp, np.degrees(angf.sum() / inl.sum())],
                               rtol=1e-3)
    np.testing.assert_allclose(rows_t[inl, 6:9], np.asarray(X)[inl], rtol=1e-3, atol=1e-3)


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


def test_two_view_init_batch_matches_jax(scene_feats):
    """Image 0 against candidates 1 and 2 in one batched step."""
    scene, feats, _ = scene_feats
    first = _image(scene, feats, 0)
    cands = [_image(scene, feats, i) for i in (1, 2)]
    nts = np.full(2, 4.0 / 700.0, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(21), 2)
    stack = [np.stack([c[k] for c in cands]) for k in range(4)]
    rows_j, sc_j = j_two_view_batch(keys, *map(jnp.asarray, first), *map(jnp.asarray, stack),
                                    jnp.float32(0.9), jnp.float32(1e9), jnp.asarray(nts),
                                    essential_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    samples = []
    for b in range(2):
        valid = jnp.asarray(rows_j[b, :, 1] > 0.5)
        k_h, k_e = jax.random.split(keys[b])
        samples.append((np.asarray(sample_indices(k_h, 128, 4, F, valid)),
                        np.asarray(sample_indices(k_e, TRIALS, 5, F, valid))))
    batched = tuple(np.stack([sm[k] for sm in samples]) for k in range(2))
    rows_t, sc_t = two_view_init_batch(None, *_t(*first), *_t(*stack), 0.9, 1e9, nts,
                                       essential_trials=TRIALS, samples=batched)
    assert rows_t.shape == rows_j.shape and sc_t.shape == sc_j.shape
    for b in range(2):
        np.testing.assert_array_equal(rows_t[b, :, :3].numpy(), rows_j[b, :, :3])
        np.testing.assert_array_equal(sc_t[b, [0, 2, 3]].numpy(), sc_j[b, [0, 2, 3]])
        assert sc_t[b, 3] > 40
        one = two_view_init(None, *_t(*first), *_t(*cands[b]), 0.9, 1e9, float(nts[b]),
                            essential_trials=TRIALS, samples=samples[b])
        assert torch.equal(rows_t[b], one[0]) and torch.equal(sc_t[b], one[1])


def _prev_state(scene, gt, i, rng):
    ids = np.full(F, -1)
    ids[: len(gt[i])] = gt[i]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    stable = has_tri & (rng.random(F) < 0.9)
    xyz = np.zeros((F, 3), np.float32)
    xyz[has_tri] = scene.points3D[ids[has_tri]] + rng.normal(size=(has_tri.sum(), 3)) * 0.01
    return xyz, has_tri, stable, scene.rvecs[i], scene.tvecs[i]


def _check_register_slots(rows_t, sc_t, rows_j, sc_j, singles):
    """Per slot: register_view_matches_jax's tolerances against JAX, and the
    port's single-pair step bit for bit."""
    assert rows_t.shape == rows_j.shape and sc_t.shape == sc_j.shape
    for b, one in enumerate(singles):
        r_t, s_t = rows_t[b].numpy(), sc_t[b].numpy()
        np.testing.assert_array_equal(r_t[:, :3], rows_j[b, :, :3])
        np.testing.assert_array_equal(s_t[[0, 2, 3, 4, 5]], sc_j[b, [0, 2, 3, 4, 5]])
        np.testing.assert_allclose(s_t[1], sc_j[b, 1], rtol=1e-5)
        np.testing.assert_allclose(s_t[7:13], sc_j[b, 7:13], rtol=0, atol=1e-4)
        np.testing.assert_allclose(s_t[6], sc_j[b, 6], rtol=1e-3)
        m = rows_j[b, :, 1] > 0.5
        np.testing.assert_allclose(r_t[m, 3:6], rows_j[b, m, 3:6], rtol=1e-3, atol=1e-5)
        assert torch.equal(rows_t[b], one[0]) and torch.equal(sc_t[b], one[1])
    assert (sc_t[:, 5] == 1.0).all() and (sc_t[:, 4] > 20).all()


def _register_samples(keys, rows_j, stables):
    samples = []
    for b, stable in enumerate(stables):
        valid = rows_j[b, :, 1] > 0.5
        k_h, k_p = jax.random.split(keys[b])
        samples.append((np.asarray(sample_indices(k_h, 128, 4, F, jnp.asarray(valid))),
                        np.asarray(sample_indices(k_p, TRIALS, 4, F,
                                                  jnp.asarray(valid & stable)))))
    return samples, tuple(np.stack([sm[k] for sm in samples]) for k in range(2))


def test_register_view_batch_matches_jax(scene_feats, rng):
    """Image 2 against processed candidates 1 and 0 (track states from the
    ground truth) in one batched step, the current image shared."""
    scene, feats, gt = scene_feats
    curr = _image(scene, feats, 2)
    prevs = [_image(scene, feats, i) for i in (1, 0)]
    states = [_prev_state(scene, gt, i, rng) for i in (1, 0)]
    K, nt = scene.cam_params[0], 4.0 / 700.0
    pst = [np.stack([p[k] for p in prevs]) for k in range(4)]
    sst = [np.stack([st[k] for st in states]) for k in range(5)]
    keys = jax.random.split(jax.random.PRNGKey(23), 2)
    rows_j, sc_j = j_register_batch(
        keys, *map(jnp.asarray, pst), *map(jnp.asarray, curr), *map(jnp.asarray, sst),
        jnp.asarray(K), jnp.asarray(1, jnp.int32), jnp.float32(0.9), jnp.float32(1e9),
        jnp.float32(nt), p3p_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    samples, batched = _register_samples(keys, rows_j, [st[1] & st[2] for st in states])
    rows_t, sc_t = register_view_batch(None, *_t(*pst), *_t(*curr), *_t(*sst), _t(K)[0], 1,
                                       0.9, 1e9, nt, p3p_trials=TRIALS, samples=batched)
    singles = [register_view(None, *_t(*prevs[b]), *_t(*curr), *_t(*states[b], K), 1, 0.9, 1e9,
                             nt, p3p_trials=TRIALS, samples=samples[b]) for b in range(2)]
    _check_register_slots(rows_t, sc_t, rows_j, sc_j, singles)


def test_register_view_pairs_matches_jax(scene_feats, rng):
    """Three full (current, previous) pairs, both sides per slot, with a
    norm threshold and camera per slot."""
    scene, feats, gt = scene_feats
    pairs = [(2, 1), (1, 0), (2, 0)]
    currs = [_image(scene, feats, c) for c, _ in pairs]
    prevs = [_image(scene, feats, p) for _, p in pairs]
    states = [_prev_state(scene, gt, p, rng) for _, p in pairs]
    Ks = np.stack([scene.cam_params[0]] * 3)
    codes = np.ones(3, np.int32)
    nts = np.array([4.0, 3.5, 4.5], np.float32) / 700.0
    pst = [np.stack([p[k] for p in prevs]) for k in range(4)]
    cst = [np.stack([c[k] for c in currs]) for k in range(4)]
    sst = [np.stack([st[k] for st in states]) for k in range(5)]
    keys = jax.random.split(jax.random.PRNGKey(29), 3)
    rows_j, sc_j = j_register_pairs(
        keys, *map(jnp.asarray, pst), *map(jnp.asarray, cst), *map(jnp.asarray, sst),
        jnp.asarray(Ks), jnp.asarray(codes), jnp.float32(0.9), jnp.float32(1e9),
        jnp.asarray(nts), p3p_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    samples, batched = _register_samples(keys, rows_j, [st[1] & st[2] for st in states])
    rows_t, sc_t = register_view_pairs(None, *_t(*pst), *_t(*cst), *_t(*sst), _t(Ks)[0],
                                       list(codes), 0.9, 1e9, list(nts), p3p_trials=TRIALS,
                                       samples=batched)
    singles = [register_view(None, *_t(*prevs[b]), *_t(*currs[b]), *_t(*states[b], Ks[b]),
                             1, 0.9, 1e9, float(nts[b]), p3p_trials=TRIALS,
                             samples=samples[b]) for b in range(3)]
    _check_register_slots(rows_t, sc_t, rows_j, sc_j, singles)


def test_two_view_init_batch_per_slot_thresholds_matches_jax(scene_feats):
    """Image 0 against candidates 1, 2 and 1 again, each slot with its own
    norm threshold, in one batched step."""
    scene, feats, _ = scene_feats
    first = _image(scene, feats, 0)
    cands = [_image(scene, feats, i) for i in (1, 2, 1)]
    nts = np.array([4.0, 3.5, 1.0], np.float32) / 700.0
    keys = jax.random.split(jax.random.PRNGKey(31), 3)
    stack = [np.stack([c[k] for c in cands]) for k in range(4)]
    rows_j, sc_j = j_two_view_batch(keys, *map(jnp.asarray, first), *map(jnp.asarray, stack),
                                    jnp.float32(0.9), jnp.float32(1e9), jnp.asarray(nts),
                                    essential_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    samples = []
    for b in range(3):
        valid = jnp.asarray(rows_j[b, :, 1] > 0.5)
        k_h, k_e = jax.random.split(keys[b])
        samples.append((np.asarray(sample_indices(k_h, 128, 4, F, valid)),
                        np.asarray(sample_indices(k_e, TRIALS, 5, F, valid))))
    batched = tuple(np.stack([sm[k] for sm in samples]) for k in range(2))
    rows_t, sc_t = two_view_init_batch(None, *_t(*first), *_t(*stack), 0.9, 1e9, nts,
                                       essential_trials=TRIALS, samples=batched)
    assert rows_t.shape == rows_j.shape and sc_t.shape == sc_j.shape
    for b in range(3):
        np.testing.assert_array_equal(rows_t[b, :, :3].numpy(), rows_j[b, :, :3])
        np.testing.assert_array_equal(sc_t[b, [0, 2, 3]].numpy(), sc_j[b, [0, 2, 3]])
        np.testing.assert_allclose(sc_t[b, 1].numpy(), sc_j[b, 1], rtol=1e-5)
        assert sc_t[b, 3] > 40
        one = two_view_init(None, *_t(*first), *_t(*cands[b]), 0.9, 1e9, float(nts[b]),
                            essential_trials=TRIALS, samples=samples[b])
        assert torch.equal(rows_t[b], one[0]) and torch.equal(sc_t[b], one[1])
    # Slots 0 and 2 hold the same pair: the tighter threshold keeps fewer
    # homography inliers.
    assert sc_t[2, 2] < sc_t[0, 2]


def test_register_view_pairs_mixed_models_matches_jax(scene_feats, rng):
    """register_view_pairs with PINHOLE and OPENCV slots in one call (codes
    [1, 2, 1]; the OPENCV camera with small nonzero distortion): the port
    refines each slot's pose under its own model, the JAX package under
    its vmapped lax.switch."""
    scene, feats, gt = scene_feats
    pairs = [(2, 1), (1, 0), (2, 0)]
    codes = np.array([1, 2, 1], np.int32)
    Ks = np.stack([scene.cam_params[0]] * 3).astype(np.float32)
    Ks[1, 4:8] = [2e-3, -1e-3, 5e-4, -5e-4]  # k1, k2, p1, p2

    def image(i, b):
        k, d, m, _ = _image(scene, feats, i)
        return k, d, m, jcam.image2normalized_np(k, int(codes[b]), Ks[b]).astype(np.float32)

    currs = [image(c, b) for b, (c, _) in enumerate(pairs)]
    prevs = [image(p, b) for b, (_, p) in enumerate(pairs)]
    states = [_prev_state(scene, gt, p, rng) for _, p in pairs]
    nts = np.array([4.0, 4.0, 4.5], np.float32) / 700.0
    pst = [np.stack([p[k] for p in prevs]) for k in range(4)]
    cst = [np.stack([c[k] for c in currs]) for k in range(4)]
    sst = [np.stack([st[k] for st in states]) for k in range(5)]
    keys = jax.random.split(jax.random.PRNGKey(37), 3)
    rows_j, sc_j = j_register_pairs(
        keys, *map(jnp.asarray, pst), *map(jnp.asarray, cst), *map(jnp.asarray, sst),
        jnp.asarray(Ks), jnp.asarray(codes), jnp.float32(0.9), jnp.float32(1e9),
        jnp.asarray(nts), p3p_trials=TRIALS)
    rows_j, sc_j = np.asarray(rows_j), np.asarray(sc_j)
    samples, batched = _register_samples(keys, rows_j, [st[1] & st[2] for st in states])
    rows_t, sc_t = register_view_pairs(None, *_t(*pst), *_t(*cst), *_t(*sst), _t(Ks)[0],
                                       list(codes), 0.9, 1e9, list(nts), p3p_trials=TRIALS,
                                       samples=batched)
    singles = [register_view(None, *_t(*prevs[b]), *_t(*currs[b]), *_t(*states[b], Ks[b]),
                             int(codes[b]), 0.9, 1e9, float(nts[b]), p3p_trials=TRIALS,
                             samples=samples[b]) for b in range(3)]
    _check_register_slots(rows_t, sc_t, rows_j, sc_j, singles)
    # The OPENCV slot's refinement differs from a PINHOLE refinement of it.
    pin = register_view(None, *_t(*prevs[1]), *_t(*currs[1]), *_t(*states[1], Ks[1]), 1,
                        0.9, 1e9, float(nts[1]), p3p_trials=TRIALS, samples=samples[1])
    assert not torch.equal(pin[1][7:13], sc_t[1, 7:13])


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


# ------------------------------------------------------------------- chains


def test_derive_chain_state_matches_jax(rng):
    """The device copy of the commit's track rules on the same rows and
    scalars: every output exactly equal (invalid rows dropped, matches
    scattered into the new frame's rows)."""
    rows = np.zeros((F, 12), np.float32)
    valid = rng.random(F) < 0.7
    rows[:, 0] = np.where(valid, rng.permutation(F), -1)
    rows[:, 1] = valid
    rows[:, 3:6] = rng.random((F, 3)) * 0.02
    rows[:, 6] = rng.random(F) * np.pi
    rows[:, 7:9] = rng.normal(size=(F, 2)) + 1.0
    rows[:, 9:12] = rng.normal(size=(F, 3))
    scalars = rng.normal(size=13).astype(np.float32)
    xyz = rng.normal(size=(F, 3)).astype(np.float32)
    has_tri = rng.random(F) < 0.5
    lens = rng.integers(0, 5, F).astype(np.int32) * has_tri
    tri_nt, min_ang = np.float32(0.01), np.float32(np.deg2rad(20.0))
    out_j = j_derive(jnp.asarray(rows), jnp.asarray(scalars), jnp.asarray(xyz),
                     jnp.asarray(has_tri), jnp.asarray(lens), jnp.float32(tri_nt),
                     jnp.float32(min_ang), 3)
    out_t = _derive_chain_state(*_t(rows, scalars, xyz, has_tri, lens), float(tri_nt),
                                float(min_ang), 3)
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ht = out_t[1].numpy()
    assert 0 < ht.sum() < valid.sum() and out_t[2].numpy().sum() < ht.sum()


@pytest.fixture(scope="module")
def chain_scene():
    scene = make_uav_scene(num_images=5, num_points=800, relief=10.0, seed=2)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=20, seed=2, max_features=F)
    return scene, feats, gt


def test_register_chain_matches_jax(chain_scene, rng):
    """register_chain over K=3 frames anchored on image 1, every frame's
    RANSAC samples derived from the JAX package's in-program keys
    (fold_in(base_key, counter), split(K), then register_view's split),
    with the masks from JAX's per-frame outputs: match rows exactly equal,
    counts equal, anchor has_tri states equal, refined poses at 1e-4."""
    scene, feats, gt = chain_scene
    K = 3
    ids = np.full(F, -1)
    ids[: len(gt[1])] = gt[1]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    lens = np.where(has_tri, rng.integers(2, 4, F), 0)
    track_state = np.zeros((F, 7), np.float32)
    track_state[has_tri, :3] = scene.points3D[ids[has_tri]] + rng.normal(
        size=(has_tri.sum(), 3)) * 0.01
    track_state[:, 3] = has_tri
    track_state[:, 4] = has_tri & (lens >= 2)
    track_state[:, 5] = lens
    track_state[:, 6] = -1.0
    scal = np.zeros(12 + 12 * K, np.float32)
    scal[0:3], scal[3:6] = scene.rvecs[1], scene.tvecs[1]
    scal[6], scal[7] = 0.9, 1e9
    scal[8], scal[9], scal[10], scal[11] = np.deg2rad(1.0), 2, 1, -1
    per = scal[12:].reshape(K, 12)
    per[:, 0] = per[:, 1] = 4.0 / 700.0
    per[:, 2] = 1
    per[:, 3:12] = scene.cam_params[0]
    imgs = [_image(scene, feats, i) for i in range(1, K + 2)]
    base_key = jax.random.PRNGKey(7)
    rows_j, sc_j, ht_j, _, _ = j_register_chain(
        base_key, *map(jnp.asarray, imgs[0]), tuple(tuple(map(jnp.asarray, im))
                                                     for im in imgs[1:]),
        jnp.asarray(track_state), jnp.asarray(scal), p3p_trials=TRIALS)
    rows_j, sc_j, ht_j = np.asarray(rows_j), np.asarray(sc_j), np.asarray(ht_j)

    # Each frame's samples from JAX's keys; its stable mask by replaying the
    # JAX derivation over JAX's own outputs.
    keys = jax.random.split(jax.random.fold_in(base_key, 1), K)
    xyz = jnp.asarray(track_state[:, :3])
    ht, st, ln = (jnp.asarray(track_state[:, 3] > 0.5), jnp.asarray(track_state[:, 4] > 0.5),
                  jnp.asarray(lens.astype(np.int32)))
    samples = []
    for k in range(K):
        valid = jnp.asarray(rows_j[k, :, 1] > 0.5)
        k_h, k_p = jax.random.split(keys[k])
        samples.append((np.asarray(sample_indices(k_h, 128, 4, F, valid)),
                        np.asarray(sample_indices(k_p, TRIALS, 4, F, valid & st & ht))))
        xyz, ht, st, ln, _, _ = j_derive(jnp.asarray(rows_j[k]), jnp.asarray(sc_j[k]), xyz,
                                         ht, ln, jnp.float32(per[k, 1]),
                                         jnp.float32(scal[8]), 2)

    rows_t, sc_t, ht_t = register_chain(
        None, *_t(*imgs[0]), tuple(tuple(_t(*im)) for im in imgs[1:]), track_state, scal,
        p3p_trials=TRIALS, samples=samples)
    rows_t, sc_t, ht_t = rows_t.numpy(), sc_t.numpy(), ht_t.numpy()
    assert rows_t.shape == rows_j.shape and sc_t.shape == sc_j.shape
    np.testing.assert_array_equal(ht_t, ht_j)
    for k in range(K):
        np.testing.assert_array_equal(rows_t[k, :, :3], rows_j[k, :, :3])
        np.testing.assert_array_equal(sc_t[k, [0, 2, 3, 4, 5]], sc_j[k, [0, 2, 3, 4, 5]])
        assert sc_t[k, 5] == 1.0 and sc_t[k, 4] > 20
        np.testing.assert_allclose(sc_t[k, 7:13], sc_j[k, 7:13], rtol=0, atol=1e-4)


def _run_chained(mapper, opts, init_opts, ba_options_cls):
    """tests/test_sfm.py's chained schedule: chains of 4 (pad_to=4), one
    deferred asynchronous window-8 BA per chain, flush_ba, global BA."""
    assert mapper.process_initial(0, 1, init_opts)
    last, i = 1, 2
    while i < 14:
        chain = list(range(i, min(i + 4, 14)))
        if len(chain) >= 2:
            oks = mapper.process_chain_k(chain, last, opts, pad_to=4)
            assert all(oks), oks
            last = chain[-1]
        else:
            assert mapper.process(chain[0], last, opts)
            last = chain[0]
        i = last + 1
        window = sorted(mapper.image_idx_to_id.keys())[-8:]
        if len(window) > 2:
            mapper.adjust_bundle(window[2:], window[:2],
                                 ba_options=ba_options_cls(max_num_iterations=8),
                                 async_=True, defer=True)
    mapper.flush_ba()
    mapper.adjust_global_bundle(ba_options_cls(max_num_iterations=30))


def test_chained_deferred_loop_matches_jax():
    """tests/test_sfm.py's chained loop with deferred window BA (14 images,
    chains of 4) through both mappers, held on outcomes."""
    kw = dict(final_cost_threshold=2.0, essential_ransac_trials=256,
              p3p_ransac_trials=256)
    opts, ikw = dict(kw, tri_min_angle=1.0), dict(kw, tri_min_angle=2.0)
    ikw.pop("final_cost_threshold")
    scene = make_uav_scene(num_images=14, num_points=2500, relief=10.0, rows=1, seed=34)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=34)
    cap = int(np.ceil(max(len(k) for k, _ in feats) / 256)) * 256
    mt = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                          ArrayFeatureProvider(feats, capacity=cap), CPU, seed=0)
    _run_chained(mt, SequentialMapperOptions(**opts), SequentialMapperOptions(**ikw),
                 BAOptions)

    js = j_scene(num_images=14, num_points=2500, relief=10.0, rows=1, seed=34)
    jf, _ = j_render(js, pixel_noise=0.3, clutter=20, seed=34)
    mj = JMapper(js.image_cameras, js.cam_models, js.cam_params,
                 JProvider(jf, capacity=cap), seed=0, store_backend="python")
    _run_chained(mj, JOpts(**opts), JOpts(**ikw), JBAOptions)

    ate_t, ate_j = mapper_ate(mt, scene), j_ate(mj, js)
    assert int(mt.store.image_registered.sum()) == 14
    assert int(mj.store.image_registered.sum()) == 14
    assert ate_t <= max(2.0 * ate_j, 0.02), (ate_t, ate_j)
    rep = mt.report()
    assert rep["chains"] == 3 and rep["pulls"] == 3 and rep["ba_applied"] == 3
    assert not mt._pending_ba and not mt._deferred_ba


def test_deferred_ba_schedule(chain_scene, monkeypatch):
    """The deferred/asynchronous schedule: a deferred adjust_bundle leaves
    the store untouched; process() dispatches it at its pull and it lands
    at the next pull; chain_dispatch dispatches before the chain (the
    fresh variant anchoring on the solve's output pose) and the chain's
    pull lands the pending solves in dispatch order; flush_ba lands the
    rest; a ninth deferred problem lands the eight before it."""
    scene, feats, _ = chain_scene
    solves = []

    def recording(*a, **kw):
        solves.append(mapper_mod.bundle_adjust_async.__wrapped__(*a, **kw))
        return solves[-1]

    recording.__wrapped__ = mapper_mod.bundle_adjust_async
    monkeypatch.setattr(mapper_mod, "bundle_adjust_async", recording)
    fresh = []

    def fresh_chain(*a, **kw):
        fresh.append((a[7].copy(), a[8].clone()))  # scal, the solve's poses
        return register_chain_fresh(*a, **kw)

    register_chain_fresh = mapper_mod.register_chain_fresh
    monkeypatch.setattr(mapper_mod, "register_chain_fresh", fresh_chain)

    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=F), CPU, seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, final_cost_threshold=2.0,
                                   essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)
    ba = BAOptions(max_num_iterations=3)
    assert m.process_initial(0, 1, opts) and m.process(2, 1, opts)

    def poses():
        return np.concatenate([m.store.image_rvecs[: m.store.num_images],
                               m.store.image_tvecs[: m.store.num_images]], axis=1).copy()

    def pose_of(idx):
        return poses()[m.image_idx_to_id[idx]]

    def solved(h, row):
        return h.fut[0][row].numpy()

    snap = poses()
    assert m.adjust_bundle([2], [0], [1], ba_options=ba, async_=True, defer=True) is None
    np.testing.assert_array_equal(poses(), snap)
    assert len(m._deferred_ba) == 1 and not solves
    assert m.process(3, 2, opts)  # dispatches D1 at its pull; nothing lands
    assert len(solves) == 1 and len(m._pending_ba) == 1
    np.testing.assert_array_equal(poses()[:3], snap)
    # D2 overlaps D1 (images 0-2) and covers the chain's anchor, image 3.
    m.adjust_bundle([2, 3], [0], [1], ba_options=ba, async_=True, defer=True)
    tok = m.chain_dispatch([4], 3, opts)
    assert len(solves) == 2 and len(m._pending_ba) == 2
    np.testing.assert_array_equal(poses()[:3], snap)
    # The chain anchored on D2's pose of image 3 (its row 1), not the store's.
    (scal, ba_poses), = fresh
    assert scal[11] == 1
    np.testing.assert_array_equal(ba_poses[1].numpy(), solved(solves[1], 1))
    assert np.abs(scal[:6] - solved(solves[1], 1)).max() > 0
    assert m.chain_complete(tok) == [True]
    # Both landed, in dispatch order: the images in both hold D2's values.
    np.testing.assert_array_equal(pose_of(2), solved(solves[1], 0))
    np.testing.assert_array_equal(pose_of(3), solved(solves[1], 1))
    assert not m._pending_ba and m.report()["ba_applied"] == 2

    m.adjust_bundle([3, 4], [0], [1], ba_options=ba, async_=True, defer=True)
    info = m.flush_ba()
    assert info is not None and info["iterations"] >= 1
    np.testing.assert_array_equal(pose_of(4), solved(solves[2], 1))
    assert not m._pending_ba and not m._deferred_ba and m.flush_ba() is None

    for _ in range(8):
        m.adjust_bundle([4], [0], [1], ba_options=ba, async_=True, defer=True)
    assert len(m._deferred_ba) == 8 and m.report()["ba_applied"] == 3
    m.adjust_bundle([4], [0], [1], ba_options=ba, async_=True, defer=True)
    assert len(m._deferred_ba) == 1 and m.report()["ba_applied"] == 11
    m.adjust_bundle([4], [0], [1], ba_options=ba, async_=True)  # dispatched at once
    assert len(m._pending_ba) == 1
    m.adjust_bundle([4], [0], [1], ba_options=ba)  # synchronous: lands all first
    assert not m._pending_ba and not m._deferred_ba
