"""The camera-model axis of the PyTorch port held against the JAX package:
PINHOLE, OPENCV and CATA cameras in one problem, and more than one camera in
one map (BASELINE.json config 2, "multi-camera rig with OPENCV distortion
model (mixed CAM_IDX sequence)"). The same numpy inputs, made from a seed,
go through both packages on the CPU, in the order the slice reaches them:

  - models/camera.py: world2image, image2world and image2normalized_np of
    the rig's OPENCV camera and of a CATA camera, 1e-5 relative (the
    tolerance of tests/test_torch_ops.py's camera cases), and the round trip
    image -> world -> image within 0.05 px in both packages;
  - ba/colmath.py: _world2image_multicode and residual_jacobian_cols with
    the intrinsics' columns over observations of all three models mixed,
    1e-5 relative to each column's scale;
  - ba/core.py: the self-calibration free mask per model (4 / 8 / 9
    parameters), exactly; bundle_adjust on one problem with a PINHOLE, an
    OPENCV and a CATA camera, dense and CG, with and without refined
    intrinsics (tolerances in the test); tests/test_ba.py's OPENCV problem;
  - ops/cuda/ba_accum.py: K2's planned sums (its plain version on the CPU)
    by the self-calibrating plans of that problem, whose blocks hold three
    camera blocks, against the Pallas kernel in interpret mode, 1e-5 of each
    segment's sum of |values| (the tolerance of tests/test_torch_ba.py);
  - sfm/kernels.py: two_view_init from a PINHOLE frame to an OPENCV frame,
    and register_chain over three frames that alternate cameras (per-frame
    codes and intrinsics in its packed scalars), each with the JAX
    package's RANSAC samples injected: register_view's tolerances of
    tests/test_torch_sfm.py;
  - sfm/mapper.py: each frame normalized by its own camera, 1e-5 relative;
    tests/test_sfm.py's OPENCV-distortion sequence through both mappers:
    the same frames registered, the port's ATE < min(0.15 m, 2x JAX's);
  - sfm/pipeline.py: tests/test_pipeline.py's two-camera rig through both
    run_pipelines: 8/8 registered with 2 cameras in each store, the port's
    ATE < 2x JAX's, each camera's self-calibrated parameters within 1e-3 of
    JAX's relative to their size;
  - utils/io.py, features/cache.py, sfm/outputs.py and cli.py: the rig
    written as imagedata.txt (camera 1 PINHOLE, camera 2 OPENCV, then lines
    that give only CAM_IDX) with reference-format feature dumps, mapped by
    both CLIs with --reference-cache-path and a vocabulary tree (loop
    detection every 4 frames): the same records and cameras read, the same
    features, the same frames registered, and imagedataout.txt naming both
    camera models with their parameters in both.

The reference mavmap writes a descriptor dump's rows and cols as cv::Mat's
4-byte ints; the port parses that layout and the JAX package reads 8-byte
ones (tests/test_torch_features.py holds the divergence). So the JAX CLI
gets the same arrays in the layout its reader takes.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from tests.test_torch_gpu import _three_camera_arrays
from tests.test_torch_sfm import _both_mappers, _run

from mavmap_tpu.ba import BAOptions as JBAOptions, build_problem as j_build
from mavmap_tpu.ba import bundle_adjust as j_bundle_adjust
from mavmap_tpu.ba import colmath as jcm
from mavmap_tpu.ba.core import _selfcal_cam_free as j_cam_free
from mavmap_tpu.cli import main as jax_cli
from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.features import ReferenceCacheProvider as JRefProvider
from mavmap_tpu.models import camera as jcam
from mavmap_tpu.ops import essential as jess
from mavmap_tpu.ops.pallas.ba_accum import seg_accum_full as j_full
from mavmap_tpu.ops.ransac import ransac as jransac
from mavmap_tpu.ops.ransac import sample_indices
from mavmap_tpu.ops.rotation import rotmat_from_rvec as j_rot
from mavmap_tpu.ops.rotation import rvec_from_rotmat as j_rvec
from mavmap_tpu.sfm import SequentialMapper as JMapper
from mavmap_tpu.sfm import pipeline as jpipe
from mavmap_tpu.sfm.kernels import _derive_chain_state as j_derive
from mavmap_tpu.sfm.kernels import register_chain as j_register_chain
from mavmap_tpu.sfm.kernels import two_view_init as j_two_view
from mavmap_tpu.utils import io as jio
from mavmap_tpu.utils.synthetic import make_multi_camera_scene as j_rig_scene
from mavmap_tpu.utils.synthetic import mapper_ate as j_ate
from mavmap_tpu.utils.synthetic import render_features as j_render

from mavmap_tpu_torch import cli as tcli
from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
from mavmap_tpu_torch.ba import colmath as tcm
from mavmap_tpu_torch.ba.core import _selfcal_cam_free, plan_ids
from mavmap_tpu_torch.features import ArrayFeatureProvider, ReferenceCacheProvider
from mavmap_tpu_torch.loop import train_voc_tree
from mavmap_tpu_torch.models import camera as tcam
from mavmap_tpu_torch.ops.cuda import ba_accum as ka
from mavmap_tpu_torch.sfm import SequentialMapper
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.sfm.kernels import register_chain, two_view_init
from mavmap_tpu_torch.utils import io as tio
from mavmap_tpu_torch.utils.synthetic import make_multi_camera_scene
from mavmap_tpu_torch.utils.synthetic import mapper_ate, render_features

torch.set_num_threads(2)
CPU = torch.device("cpu")
F = 256
TRIALS = 64
# tests/test_torch_ops.py's camera parameters; CATA is OPENCV's plus xi.
PINHOLE_PARAMS = [651.123, 655.123, 386.123, 511.123]
OPENCV_PARAMS = PINHOLE_PARAMS + [-0.171, 0.023, -0.001, 0.001]
CATA_PARAMS = OPENCV_PARAMS + [0.5]
# The rig's second camera (utils/synthetic.py make_multi_camera_scene).
RIG_OPENCV = [620.0, 620.0, 406.0, 296.0, -0.15, 0.03, 0.0005, -0.0005]


def _rel_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


# ------------------------------------------------------------ camera models


@pytest.mark.parametrize("code,params", [(tcam.OPENCV, RIG_OPENCV),
                                         (tcam.CATA, CATA_PARAMS)])
def test_camera_round_trip_matches_jax(rng, code, params):
    """Forward and inverse of a distorted model in both packages at 1e-5,
    and the round trip pixel -> ray -> pixel within 0.05 px in each: the
    inverse is a fixed 10-iteration undistortion (the reference's scheme),
    which leaves up to 0.032 px at the CATA camera's corners in both."""
    pj = jcam.pad_params(params)
    pt = tcam.pad_params(params, device=CPU)
    uv = (rng.random((400, 2)) * [760, 560] + [20, 20]).astype(np.float32)
    rays_t = tcam.image2world(torch.as_tensor(uv), code, pt)
    rays_j = jcam.image2world(jnp.asarray(uv), code, pj)
    _rel_close(rays_t.numpy(), np.asarray(rays_j), 1e-5)
    _rel_close(tcam.image2normalized_np(uv, code, np.asarray(pt)),
               jcam.image2normalized_np(uv, code, np.asarray(pj)), 1e-5)
    back_t = tcam.world2image(rays_t, code, pt).numpy()
    back_j = np.asarray(jcam.world2image(rays_j, code, pj))
    _rel_close(back_t, back_j, 1e-5)
    assert np.abs(back_t - uv).max() < 0.05 and np.abs(back_j - uv).max() < 0.05


def _mixed_observations(rng, O=600):
    codes = np.array([tcam.PINHOLE, tcam.OPENCV, tcam.CATA], np.int32)[rng.integers(0, 3, O)]
    params = np.zeros((O, 9), np.float32)
    for code, p in ((1, PINHOLE_PARAMS), (2, OPENCV_PARAMS), (3, CATA_PARAMS)):
        params[codes == code, :len(p)] = p
    poses = np.concatenate([rng.normal(size=(O, 3)) * 0.05,
                            rng.normal(size=(O, 3)) * 0.3], 1).astype(np.float32)
    X = (rng.normal(size=(O, 3)) * [4, 4, 1] + [0, 0, 12]).astype(np.float32)
    uv = (rng.random((O, 2)) * [760, 1000]).astype(np.float32)
    return poses, X, params, codes, uv


def test_world2image_multicode_matches_jax(rng):
    """The BA's per-observation model dispatch (all three models evaluated,
    one selected per observation) on mixed codes, at 1e-5; each observation
    equals the single-model projection of its own camera at 1e-5."""
    _, X, params, codes, _ = _mixed_observations(rng)
    got = tcm._world2image_multicode(torch.as_tensor(X), torch.as_tensor(codes),
                                     torch.as_tensor(params)).numpy()
    ref = np.asarray(jcm._world2image_multicode(jnp.asarray(X), jnp.asarray(codes),
                                                jnp.asarray(params)))
    _rel_close(got, ref, 1e-5)
    for code in (1, 2, 3):
        sel = codes == code
        one = tcam.world2image(torch.as_tensor(X[sel]), code,
                               torch.as_tensor(params[sel][0])).numpy()
        _rel_close(got[sel], one, 1e-5)


def test_residual_jacobian_cols_with_intrinsics_matches_jax(rng):
    """Residuals and the pose, point and intrinsics Jacobian columns (the
    intrinsics' through the dispatch) over mixed codes, each column at 1e-5
    of its scale; a PINHOLE observation has zero k1..xi columns, an OPENCV
    one a zero xi column."""
    poses, X, params, codes, uv = _mixed_observations(rng)
    got = tcm.residual_jacobian_cols(*_t(poses, X, params, codes, uv), with_intrinsics=True)
    ref = jcm.residual_jacobian_cols(*map(jnp.asarray, (poses, X, params, codes, uv)),
                                     with_intrinsics=True)
    r_t, jc_t, jp_t, jk_t = got
    r_j, jc_j, jp_j, jk_j = ref
    for a, b in zip(r_t, r_j):
        _rel_close(a.numpy(), np.asarray(b), 1e-5)
    for mt, mj in ((jc_t, jc_j), (jp_t, jp_j), (jk_t, jk_j)):
        for row_t, row_j in zip(mt, mj):
            for a, b in zip(row_t, row_j):
                _rel_close(a.numpy(), np.asarray(b), 1e-5)
    jk = np.stack([[c.numpy() for c in row] for row in jk_t])  # (2, 9, O)
    assert np.all(jk[:, 4:, codes == tcam.PINHOLE] == 0)
    assert np.all(jk[:, 8, codes == tcam.OPENCV] == 0)
    assert np.abs(jk[:, 8, codes == tcam.CATA]).max() > 0


# -------------------------------------------------------- bundle adjustment


def test_selfcal_cam_free_per_model(rng):
    """The free intrinsics of each camera: fx fy cx cy for PINHOLE, also k1
    k2 p1 p2 for OPENCV, also xi for CATA; the JAX package's mask exactly."""
    args, states = _three_camera_arrays(rng, I=3, per_image=20)
    prob = build_problem(*args, pose_states=states)
    got = _selfcal_cam_free(prob).numpy()
    ref = np.asarray(j_cam_free(j_build(*args, pose_states=states, host=True)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.sum(1), [4, 8, 9])


@pytest.mark.parametrize("name", ["plan_blk", "plan_hess", "plan_ptblk"])
def test_selfcal_plans_with_camera_blocks_match_jax(rng, name):
    """K2 by each self-calibrating plan of the three-camera problem (B = I
    + 3 blocks: the last three the cameras'), on random values over its
    real rows, against the Pallas kernel in interpret mode over the same
    rows: 1e-5 of each segment's sum of |values|, and every camera block
    receives rows."""
    args, states = _three_camera_arrays(rng, I=6, per_image=120)
    prob = build_problem(*args, pose_states=states, bucket=True)
    ids, S = plan_ids(prob, name)
    K = 54 if name == "plan_ptblk" else 81
    c = rng.normal(size=(len(ids), K)).astype(np.float32)
    real = ids >= 0
    got = ka.seg_accum_full(torch.as_tensor(c), torch.as_tensor(ids.astype(np.int32)), S,
                            ka.make_plan(ids, S).to(CPU)).numpy()
    ref = np.asarray(j_full(jnp.asarray(c[real]), jnp.asarray(ids[real].astype(np.int32)), S,
                            interpret=True))
    scale = np.zeros((S, K), np.float32)
    np.add.at(scale, ids[real], np.abs(c[real]))
    assert np.all(np.abs(got - ref) <= 1e-5 * scale + 1e-6)
    I, B = len(prob.poses), len(prob.poses) + 3
    blocks = (ids[real] if name == "plan_blk" else
              ids[real] % B if name == "plan_ptblk" else ids[real] // B)
    assert set(range(I, B)) <= set(blocks.tolist())


# Each case: (solver, refined intrinsics). Tolerances, relative to each
# array's largest entry: with fixed intrinsics, poses, points and the final
# cost at 1e-4 (test_lm_loop_matches_jax's). With refined intrinsics the
# CATA camera's f, xi, k1 and k2 all bend the image radially, so the solve
# moves along a shallow valley: a 1e-7 relative change of the observations
# moves the port's own solve by up to 1.9e-4 (dense) / 3.5e-3 (CG) of the
# points after 12 iterations (measured on this problem); so poses and points
# at 1e-3, PINHOLE and OPENCV intrinsics at 1e-3, CATA's at 1e-2 with its
# projection of the scene's points held within 0.25 px, the final cost at
# 1e-4 (dense) and 1e-3 (CG: its inexact-Newton forcing term sets each
# solve's tolerance).
BA_CASES = [("dense", False), ("cg", False), ("dense", True), ("cg", True)]


@pytest.mark.parametrize("solver,refine", BA_CASES)
def test_bundle_adjust_three_camera_models_matches_jax(rng, solver, refine):
    args, states = _three_camera_arrays(rng, focal_err=0.01 if refine else 0.0)
    kw = dict(max_num_iterations=12, solver=solver, refine_camera_params=refine,
              function_tolerance=0.0)
    pj, xj, ij = j_bundle_adjust(j_build(*args, pose_states=states, bucket=True, host=True),
                                 JBAOptions(**kw))
    pt, xt, it = bundle_adjust(build_problem(*args, pose_states=states, bucket=True),
                               BAOptions(**kw), device=CPU)
    assert it["solver"] == solver and it["iterations"] == int(ij["iterations"]) == 12
    assert it["final_cost"] < 0.1 * it["initial_cost"]
    tol = 1e-3 if refine else 1e-4
    _rel_close(pt, np.asarray(pj), tol)
    _rel_close(xt, np.asarray(xj), tol)
    _rel_close(it["final_cost"], float(ij["final_cost"]),
               1e-3 if (refine and solver == "cg") else 1e-4)
    if not refine:
        return
    kt, kj = it["cam_params"], np.asarray(ij["cam_params"])
    for c, ctol in ((0, 1e-3), (1, 1e-3), (2, 1e-2)):
        _rel_close(kt[c], kj[c], ctol)
    grid = (rng.normal(size=(500, 3)) * [8, 10, 2] + [0, 0, 14]).astype(np.float32)
    ut = tcam.world2image(torch.as_tensor(grid), tcam.CATA, torch.as_tensor(kt[2])).numpy()
    uj = np.asarray(jcam.world2image(jnp.asarray(grid), jcam.CATA, jnp.asarray(kj[2])))
    assert np.abs(ut - uj).max() < 0.25
    # Self-calibration moves the 1 % focal error of the two well-determined
    # cameras toward the truth.
    for c in (0, 1):
        assert abs(kt[c, 0] - PINHOLE_PARAMS[0]) < 0.5 * 0.01 * PINHOLE_PARAMS[0]


def test_bundle_adjust_opencv_model_problem_matches_jax(rng):
    """tests/test_ba.py's test_ba_opencv_model problem (4 images, 80
    points, one OPENCV camera, noise-free observations) through both
    packages: the JAX test's bounds hold for the port (final cost < 1e-2,
    poses within 2e-3 of the truth), and the poses agree at 1e-4."""
    K = np.zeros((1, 9), np.float32)
    K[0, :8] = [700.0, 700.0, 400.0, 300.0, -0.2, 0.05, 0.001, -0.001]
    P = 80
    X = rng.normal(size=(P, 3)) * np.array([3, 3, 1.5]) + np.array([0, 0, 10])
    poses_gt = np.stack([
        np.concatenate([rng.normal(size=3) * 0.03, [i * 0.7, 0, 0] + rng.normal(size=3) * 0.02])
        for i in range(4)]).astype(np.float32)
    oi, op, uv = [], [], []
    for i in range(4):
        R = np.asarray(j_rot(jnp.asarray(poses_gt[i, :3])))
        Xc = X @ R.T + poses_gt[i, 3:]
        uv += list(np.asarray(jcam.world2image(jnp.asarray(Xc, jnp.float32), jcam.OPENCV,
                                               jnp.asarray(K[0]))))
        oi += [i] * P
        op += list(range(P))
    poses0 = poses_gt.copy()
    poses0[2:] += rng.normal(size=poses0[2:].shape) * 0.01
    X0 = X + rng.normal(size=X.shape) * 0.02
    args = (poses0, X0, K, [jcam.OPENCV], np.array(oi), np.array(op),
            np.zeros(len(oi), np.int32), np.array(uv))
    states = [1, 2, 0, 0]  # BA_POSE_FIXED, BA_POSE_FIXED_X, free, free
    pj, _, ij = j_bundle_adjust(j_build(*args, pose_states=states),
                                JBAOptions(max_num_iterations=60))
    pt, _, it = bundle_adjust(build_problem(*args, pose_states=states),
                              BAOptions(max_num_iterations=60), device=CPU)
    assert float(ij["final_cost"]) < 1e-2 and it["final_cost"] < 1e-2
    assert np.abs(pt - poses_gt).max() < 2e-3
    _rel_close(pt, np.asarray(pj), 1e-4)


# ------------------------------------------------------------- device steps


@pytest.fixture(scope="module")
def rig_steps():
    """A 5-frame two-camera rig (even frames PINHOLE, odd OPENCV) at F
    features, from the JAX package's generators."""
    scene = j_rig_scene(num_images=5, num_points=800, relief=10.0, seed=2)
    feats, gt = j_render(scene, pixel_noise=0.3, clutter=20, seed=2, max_features=F)
    return scene, feats, gt


def _frame(scene, feats, i):
    """Padded keypoints, descriptors, mask and coordinates normalized by the
    frame's own camera."""
    kp, de = feats[i]
    n = len(kp)
    k = np.zeros((F, 2), np.float32)
    d = np.zeros((F, de.shape[1]), np.float32)
    m = np.zeros(F, bool)
    k[:n], d[:n], m[:n] = kp, de, True
    c = scene.image_cameras[i]
    nrm = jcam.image2normalized_np(k, int(scene.cam_models[c]), scene.cam_params[c])
    return k, d, m, nrm.astype(np.float32)


def _focal(scene, i):
    p = scene.cam_params[scene.image_cameras[i]]
    return float((p[0] + p[1]) / 2.0)


def test_rig_scene_matches_jax(rig_steps):
    scene, feats, _ = rig_steps
    ts = make_multi_camera_scene(num_images=5, num_points=800, relief=10.0, seed=2)
    np.testing.assert_array_equal(ts.cam_params, scene.cam_params)
    np.testing.assert_array_equal(ts.cam_models, scene.cam_models)
    np.testing.assert_array_equal(ts.image_cameras, scene.image_cameras)
    np.testing.assert_allclose(ts.cam_params[1, :8], RIG_OPENCV, rtol=1e-6)
    tf, _ = render_features(ts, pixel_noise=0.3, clutter=20, seed=2, max_features=F)
    for (k, d), (kj, dj) in zip(tf, feats):
        np.testing.assert_allclose(k, kj, rtol=0, atol=1e-3)  # px
        np.testing.assert_array_equal(d, dj)


def test_two_view_init_across_camera_models_matches_jax(rig_steps):
    """Frame 0 (PINHOLE) against frame 1 (OPENCV), each normalized by its own
    camera, with the JAX package's samples: test_two_view_init_matches_jax's
    checks (match rows and counts exactly; the port's f64 refit of E against
    an f64 refit on the same inliers at 1e-5, its pose against the JAX
    package's recovery from that E at 1e-4)."""
    scene, feats, _ = rig_steps
    a, b = _frame(scene, feats, 0), _frame(scene, feats, 1)
    assert scene.cam_models[scene.image_cameras[1]] == jcam.OPENCV
    nt = 4.0 / (0.5 * (_focal(scene, 0) + _focal(scene, 1)))
    key = jax.random.PRNGKey(5)
    rows_j, sc_j = map(np.asarray, j_two_view(
        key, *map(jnp.asarray, a + b), jnp.float32(0.9), jnp.float32(1e9), jnp.float32(nt),
        essential_trials=TRIALS))
    valid = jnp.asarray(rows_j[:, 1] > 0.5)
    k_h, k_e = jax.random.split(key)
    samples = (np.asarray(sample_indices(k_h, 128, 4, F, valid)),
               np.asarray(sample_indices(k_e, TRIALS, 5, F, valid)))
    rows_t, sc_t = (o.numpy() for o in two_view_init(
        None, *_t(*(a + b)), 0.9, 1e9, nt, essential_trials=TRIALS, samples=samples))
    np.testing.assert_array_equal(rows_t[:, :3], rows_j[:, :3])
    np.testing.assert_array_equal(sc_t[[0, 2, 3]], sc_j[[0, 2, 3]])
    assert sc_t[3] > 40
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
    np.testing.assert_allclose(sc_t[6:9], np.asarray(j_rvec(R_e)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sc_t[9:12], np.asarray(t_e), rtol=0, atol=1e-4)


def test_register_chain_alternating_cameras_matches_jax(rig_steps, rng):
    """register_chain over frames 2 (PINHOLE), 3 (OPENCV), 4 (PINHOLE)
    anchored on frame 1 (OPENCV), each frame's model code, intrinsics and
    thresholds packed per frame in scal, with every frame's samples from
    the JAX package's in-program keys: match rows exactly, counts exactly,
    anchor states exactly, refined poses at 1e-4; the end state's flags
    exactly and its pose at 1e-4 (test_register_chain_matches_jax's)."""
    scene, feats, gt = rig_steps
    K = 3
    frames = [2, 3, 4]
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
    for k, i in enumerate(frames):
        c = scene.image_cameras[i]
        per[k, 0] = per[k, 1] = 4.0 / _focal(scene, i)
        per[k, 2] = scene.cam_models[c]
        per[k, 3:12] = scene.cam_params[c]
    assert list(per[:, 2]) == [jcam.PINHOLE, jcam.OPENCV, jcam.PINHOLE]
    imgs = [_frame(scene, feats, i) for i in [1] + frames]
    base_key = jax.random.PRNGKey(7)
    rows_j, sc_j, ht_j, es_j, ep_j = map(np.asarray, j_register_chain(
        base_key, *map(jnp.asarray, imgs[0]), tuple(tuple(map(jnp.asarray, im))
                                                     for im in imgs[1:]),
        jnp.asarray(track_state), jnp.asarray(scal), p3p_trials=TRIALS))
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
    rows_t, sc_t, ht_t, es_t, ep_t = (o.numpy() for o in register_chain(
        None, *_t(*imgs[0]), tuple(tuple(_t(*im)) for im in imgs[1:]), track_state, scal,
        p3p_trials=TRIALS, samples=samples))
    np.testing.assert_array_equal(ht_t, ht_j)
    for k in range(K):
        np.testing.assert_array_equal(rows_t[k, :, :3], rows_j[k, :, :3])
        np.testing.assert_array_equal(sc_t[k, [0, 2, 3, 4, 5]], sc_j[k, [0, 2, 3, 4, 5]])
        assert sc_t[k, 5] == 1.0 and sc_t[k, 4] > 20
        np.testing.assert_allclose(sc_t[k, 7:13], sc_j[k, 7:13], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(es_t[:, 3:], es_j[:, 3:])
    np.testing.assert_allclose(ep_t, ep_j, rtol=0, atol=1e-4)


# ------------------------------------------------------------------ mapper


def test_mapper_normalizes_each_frame_by_its_camera(rig_steps):
    """The mapper's per-frame normalized keypoints (image2normalized_np under
    the frame's own camera) and its per-frame thresholds, against the JAX
    mapper's on the same rig: 1e-5 relative, thresholds exactly."""
    scene, feats, _ = rig_steps
    mt = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                          ArrayFeatureProvider(feats, capacity=F), device=CPU)
    mj = JMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                 JProvider(feats, capacity=F), store_backend="python")
    for i in range(len(feats)):
        _rel_close(mt._normalized(i), np.asarray(mj._normalized(i)), 1e-5)
        assert mt._norm_threshold(4.0, i) == mj._norm_threshold(4.0, i)
    assert mt._norm_threshold(4.0, 1) != mt._norm_threshold(4.0, 0)


def test_opencv_sequence_mapper_matches_jax():
    """tests/test_sfm.py's test_sequential_mapping_opencv_distortion (6
    images, one OPENCV camera, seed 3, its window-8 loop) through both
    mappers: the same frames registered, all 6, and the port's ATE
    < min(0.15 m, 2x JAX's)."""
    kw = dict(final_cost_threshold=2.0, essential_ransac_trials=256, p3p_ransac_trials=256)
    (mt, st, _, _), (mj, sj, _, _) = runs = _both_mappers(
        dict(num_images=6, num_points=1200, relief=10.0,
             distortion=[-0.25, 0.07, 0.0005, -0.0005], seed=3),
        dict(pixel_noise=0.3, clutter=20, seed=3))
    for m, scene, opts_cls, ba_cls in runs:
        assert scene.cam_models[0] == tcam.OPENCV
        _run(m, 6, opts_cls(tri_min_angle=1.0, **kw), opts_cls(tri_min_angle=4.0, **kw), ba_cls)
    assert sorted(mt.image_idx_to_id) == sorted(mj.image_idx_to_id) == list(range(6))
    ate_t, ate_j = mapper_ate(mt, st), j_ate(mj, sj)
    assert ate_t < min(0.15, 2.0 * ate_j), (ate_t, ate_j)


# ---------------------------------------------------------- pipeline, CLI

N = 8
RIG = dict(num_images=N, num_points=2000, relief=10.0, rows=1, seed=9)
PIPE = dict(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
            loop_detection=False)


@pytest.fixture(scope="module")
def rig():
    """tests/test_pipeline.py's rig (8 frames, even frames on camera 0,
    PINHOLE, odd frames on camera 1, OPENCV), made by each package, with the
    provider capacity that test gives it."""
    js = j_rig_scene(**RIG)
    jf, _ = j_render(js, pixel_noise=0.3, clutter=10, seed=9)
    ts = make_multi_camera_scene(**RIG)
    tf, _ = render_features(ts, pixel_noise=0.3, clutter=10, seed=9)
    cap = int(np.ceil(max(len(k) for k, _ in jf) / 256)) * 256
    return (ts, tf), (js, jf), cap


@pytest.fixture(scope="module")
def pipeline_runs(rig):
    (ts, tf), (js, jf), cap = rig
    rt = tpipe.run_pipeline(ts.image_cameras, ts.cam_models, ts.cam_params,
                            ArrayFeatureProvider(tf, capacity=cap), tpipe.PipelineOptions(**PIPE),
                            device=CPU)
    rj = jpipe.run_pipeline(js.image_cameras, js.cam_models, js.cam_params,
                            JProvider(jf, capacity=cap), jpipe.PipelineOptions(**PIPE))
    return rt, rj


def test_rig_pipeline_matches_jax(rig, pipeline_runs):
    """Both run_pipelines register 8/8 with both cameras in the store; the
    port's ATE < 2x JAX's; each camera's self-calibrated parameters within
    1e-3 of JAX's relative to the camera's largest parameter (the two agree
    to about 1e-5 on the CPU; the f32 solves differ in their order of
    additions)."""
    (ts, _), (js, _), _ = rig
    mt, mj = pipeline_runs[0].main_mapper, pipeline_runs[1].main_mapper
    assert mt.num_proc_images == mj.num_proc_images == N
    assert sorted(mt.image_idx_to_id) == sorted(mj.image_idx_to_id) == list(range(N))
    assert mt.store.num_cameras == mj.store.num_cameras == 2
    np.testing.assert_array_equal(mt.store.camera_models, mj.store.camera_models)
    assert list(mt.store.camera_models) == [tcam.PINHOLE, tcam.OPENCV]
    ate_t, ate_j = mapper_ate(mt, ts), j_ate(mj, js)
    assert ate_t < 2.0 * ate_j and ate_t < 0.15, (ate_t, ate_j)
    kt, kj = np.asarray(mt.store.camera_params), np.asarray(mj.store.camera_params)
    for c in range(2):
        _rel_close(kt[c], kj[c], 1e-3)
    assert not np.array_equal(kt[1], ts.cam_params[1])  # refined
    assert abs(kt[1, 4] - ts.cam_params[1, 4]) < 0.02  # k1 near the truth


@pytest.fixture(scope="module")
def cli_runs(rig, tmp_path_factory):
    """Both CLIs over the rig from reference caches, with a vocabulary tree
    trained by the port on every 4th frame (loop detection every 4 frames).
    The files are chip_smoke.py's rig phase's (write_rig_files): frame 0
    defines camera 1, PINHOLE, frame 1 camera 2, OPENCV, and every later
    line of imagedata.txt gives only its CAM_IDX."""
    _, (js, jf), cap = rig
    tmp = tmp_path_factory.mktemp("rig_cli")
    chip_smoke.write_rig_files(str(tmp / "port"), js, jf)
    chip_smoke.write_rig_files(str(tmp / "jax"), js, jf, header_int_bytes=8)
    data, ref, jref = tmp / "port" / "data", tmp / "port" / "ref", tmp / "jax" / "ref"
    desc = np.concatenate([d for _, d in jf[::4]])
    train_voc_tree(desc, branching=8, depth=2, iters=3, device=CPU).save(str(tmp / "tree.npz"))
    flags = ["--max-features", str(cap), "--min-track-len", "2",
             "--tri-min-angle", "1.0", "--init-tri-min-angle", "4.0",
             "--voc-tree-path", str(tmp / "tree.npz"), "--loop-detection-period", "4",
             "--quiet"]
    assert jax_cli(flags + ["--input-path", str(tmp / "jax" / "data"),
                            "--reference-cache-path", str(jref),
                            "--output-path", str(tmp / "jout")]) == 0
    run = tcli.run(flags + ["--input-path", str(data), "--reference-cache-path", str(ref),
                            "--output-path", str(tmp / "tout"), "--device", "cpu"])
    assert run.rc == 0
    return tmp, data, ref, jref, cap, run


def test_rig_imagedata_reads_like_jax(cli_runs):
    """Lines that give only CAM_IDX take the camera defined for that index
    earlier, switching between the two: the same records and cameras as
    the JAX reader's."""
    _, data, _, _, _, _ = cli_runs
    rt = tio.read_image_data(str(data / "imagedata.txt"))
    rj = jio.read_image_data(str(data / "imagedata.txt"))
    assert [(r.name, r.camera_idx, r.camera_model, list(r.camera_params)) for r in rt] == \
        [(r.name, r.camera_idx, r.camera_model, list(r.camera_params)) for r in rj]
    assert [r.camera_idx for r in rt] == [1, 2] * (N // 2)
    for a, b in zip(tio.cameras_from_records(rt), jio.cameras_from_records(rj)):
        np.testing.assert_array_equal(a, b)
    models, params, image_cameras = tio.cameras_from_records(rt)
    assert list(models) == [tcam.PINHOLE, tcam.OPENCV]
    np.testing.assert_allclose(params[1, :8], RIG_OPENCV, rtol=1e-6)
    np.testing.assert_array_equal(image_cameras, np.arange(N) % 2)


def test_rig_reference_cache_reads_like_jax(rig, cli_runs):
    """The port's ReferenceCacheProvider on the reference layout gives every
    frame the features the JAX one gives on its layout, and the arrays the
    pipeline's providers hold."""
    _, (_, jf), _ = rig
    _, _, ref, jref, cap, _ = cli_runs
    names = [f"img{i}" for i in range(N)]
    pt = ReferenceCacheProvider(str(ref), names, capacity=cap)
    pj = JRefProvider(str(jref), names, capacity=cap)
    pa = ArrayFeatureProvider(jf, capacity=cap)
    for i in range(N):
        a, b, c = pt.get(i), pj.get(i), pa.get(i)
        for f in ("keypoints", "descriptors", "mask"):
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)))
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))


def _rows(path):
    return [[v.strip() for v in line.split(",")]
            for line in path.read_text().splitlines() if not line.startswith("#")]


def test_rig_cli_matches_jax(cli_runs):
    """Both CLIs register the same frames, all 8, with 2 cameras in the
    port's store; each imagedataout.txt names both camera models with their
    parameters, as the other package's does."""
    tmp, _, _, _, _, run = cli_runs
    rt, rj = _rows(tmp / "tout" / "imagedataout.txt"), _rows(tmp / "jout" / "imagedataout.txt")
    assert [r[0] for r in rt] == [r[0] for r in rj] == [f"img{i}" for i in range(N)]
    cams_t = {tuple(r[11:]) for r in rt}
    assert cams_t == {tuple(r[11:]) for r in rj}
    by_idx = {int(c[0]): (int(c[1]), [float(v) for v in c[2:]]) for c in cams_t}
    assert by_idx[1][0] == tcam.PINHOLE and len(by_idx[1][1]) == 4
    assert by_idx[2][0] == tcam.OPENCV
    np.testing.assert_allclose(by_idx[2][1], RIG_OPENCV, rtol=1e-6)
    m = run.result.main_mapper
    assert m.num_proc_images == N and m.store.num_cameras == 2
    assert sorted(os.listdir(tmp / "tout")) == sorted(os.listdir(tmp / "jout"))
