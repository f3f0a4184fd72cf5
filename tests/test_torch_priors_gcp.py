"""IMU rotation priors, ground-control points, the point-cloud filter and
the per-point errors of the port held against the JAX package on the very
same map.

One 6-image survey is built into a JAX mapper's store without any
registration step (ground-truth tracks, noisy poses and points) and carried
into a port mapper with interop.map_store_from_jax, so both packages start
every check from the same numbers. Tolerances: poses to 1e-4 and 3-D
points to 1e-3 m (the two LM loops add in different orders, and a point
seen in two views moves most), per-point errors to 1e-4 px (float32 at
pixel coordinates of some hundreds, where the residual cancels).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mavmap_tpu.ba import BAOptions as JBAOptions
from mavmap_tpu.ba import build_problem as j_build
from mavmap_tpu.ba.core import point_mean_errors as j_point_mean_errors
from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.sfm import SequentialMapper as JMapper
from mavmap_tpu.sfm import pipeline as jpipe
from mavmap_tpu.utils.io import ControlPoint as JControlPoint
from mavmap_tpu.utils.synthetic import imu_priors, make_uav_scene, render_features

from mavmap_tpu_torch.ba import BAOptions
from mavmap_tpu_torch.ba.core import point_mean_errors, with_plans
from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.interop import map_store_from_jax, problem_from_jax
from mavmap_tpu_torch.sfm import SequentialMapper
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.utils.io import ControlPoint

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 6


@pytest.fixture(scope="module")
def survey():
    scene = make_uav_scene(num_images=N, num_points=1500, relief=10.0, rows=1, seed=4)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=0, dropout=0.0, seed=4)
    return scene, feats, gt


def _mappers(survey):
    """(JAX mapper, port mapper) holding the same map: every image with a
    pose 5 mrad / 5 cm off the truth, every point seen twice or more with
    its track over all its images and 5 cm of noise."""
    scene, feats, gt = survey
    rng = np.random.default_rng(7)
    cap = max(len(k) for k, _ in feats)
    mj = JMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                 JProvider(feats, capacity=cap), store_backend="python")
    s = mj.store
    for i in range(N):
        iid = mj._add_image_to_store(i)
        s.set_pose(iid, scene.rvecs[i] + rng.normal(size=3) * 0.005,
                   scene.tvecs[i] + rng.normal(size=3) * 0.05)
    obs = {}
    for i in range(N):
        start = s.point2D_ids_of_image(mj.image_idx_to_id[i])[0]
        for row, pid in enumerate(gt[i]):
            obs.setdefault(int(pid), []).append(start + row)
    for pid, p2d in sorted(obs.items()):
        if pid < 0 or len(p2d) < 2:
            continue
        for a, b in zip(p2d[:-1], p2d[1:]):
            sp = s.add_correspondence(a, b)
        s.set_point3D(sp, scene.points3D[pid] + rng.normal(size=3) * 0.05)
    mj.pair_graph = {(i, i + 1) for i in range(N - 1)}
    mt = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                          ArrayFeatureProvider(feats, capacity=cap), device=CPU)
    mt.store = map_store_from_jax(mj.store)
    for k in ("image_idx_to_id", "image_id_to_idx", "pair_graph", "num_proc_images",
              "_store_cam_ids", "min_image_idx", "max_image_idx"):
        setattr(mt, k, copy.deepcopy(getattr(mj, k)))
    return mj, mt


def _same_map(mt, mj, atol=1e-4, points_atol=1e-3):
    for f, tol in (("image_rvecs", atol), ("image_tvecs", atol), ("point3D_xyz", points_atol)):
        np.testing.assert_allclose(getattr(mt.store, f), getattr(mj.store, f), atol=tol,
                                   err_msg=f)


def test_map_store_from_jax_copies_everything(survey):
    mj, mt = _mappers(survey)
    for f in mt.store.STATE_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(mt.store, f)),
                                      np.asarray(getattr(mj.store, f)), f)
    assert mt.store.tracks == mj.store.tracks and len(mt.store.tracks) > 150
    mt.store.point3D_xyz[0] += 1.0  # a copy, not a view
    assert not np.array_equal(mt.store.point3D_xyz[0], mj.store.point3D_xyz[0])


def test_align_model_to_rot_prior_matches_jax(survey):
    """The model rotated into the priors' frame from image 0's prior: the
    same poses and points, and image 0's rotation equal to its prior."""
    scene = survey[0]
    mj, mt = _mappers(survey)
    prior = (scene.rvecs[0] + np.array([0.01, -0.02, 0.03], np.float32)).astype(np.float32)
    mj._align_model_to_rot_prior(0, prior)
    mt._align_model_to_rot_prior(0, prior)
    _same_map(mt, mj, atol=1e-5, points_atol=1e-5)
    np.testing.assert_allclose(mt.store.image_rvecs[0], prior, atol=1e-5)


@pytest.mark.parametrize("selfcal", [False, True])
def test_adjust_bundle_with_rot_priors_matches_jax(survey, selfcal):
    """adjust_bundle with IMU priors on every image (weight 20) over the
    whole map, first image fixed, second's x pinned: the model is aligned to
    the priors, then both LM loops converge to the same poses and points."""
    scene = survey[0]
    mj, mt = _mappers(survey)
    priors = imu_priors(scene, noise=0.005, seed=4)
    kw = dict(rot_priors=priors, rot_prior_weight=20.0)
    oj = JBAOptions(max_num_iterations=10, refine_camera_params=selfcal)
    ot = BAOptions(max_num_iterations=10, refine_camera_params=selfcal)
    ij = mj.adjust_bundle(list(range(2, N)), [0], [1], ba_options=oj, **kw)
    it = mt.adjust_bundle(list(range(2, N)), [0], [1], ba_options=ot, **kw)
    assert it["final_cost"] < it["initial_cost"]
    np.testing.assert_allclose(it["final_cost"], float(ij["final_cost"]), rtol=1e-3)
    _same_map(mt, mj)
    np.testing.assert_allclose(mt.store.camera_params, mj.store.camera_params, rtol=1e-5)
    # adjust_global_bundle passes the priors through the same way.
    mj.adjust_global_bundle(oj, **kw)
    mt.adjust_global_bundle(ot, **kw)
    _same_map(mt, mj)


def _control_points(scene, rng, cls):
    out = []
    for k in range(5):
        X = np.array([rng.uniform(1, 12), rng.uniform(2, 10), rng.uniform(0, 3)])
        obs = []
        for i in range(N):
            R = _rot(scene.rvecs[i])
            Xc = R @ X + scene.tvecs[i]
            u, v = 700.0 * Xc[0] / Xc[2] + 400.0, 700.0 * Xc[1] / Xc[2] + 300.0
            if Xc[2] > 1 and 0 <= u < 800 and 0 <= v < 600:
                obs.append((i, float(u), float(v)))
        out.append(cls(f"cp{k}", X.copy(), obs, fixed=k < 4))
    return out


def _rot(rvec):
    th = np.linalg.norm(rvec)
    k = rvec / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def test_apply_control_points_matches_jax(survey, monkeypatch):
    """apply_control_points on the same map: the same model -> GCP-frame
    similarity (captured from solve_umeyama), the same map after the GCP
    bundle adjustment and the same control-point estimates, track lengths
    and residuals, each within 1e-4."""
    import mavmap_tpu.ops.similarity as jsim
    import mavmap_tpu_torch.ops.similarity as tsim

    scene = survey[0]
    mj, mt = _mappers(survey)
    cj = _control_points(scene, np.random.default_rng(3), JControlPoint)
    ct = _control_points(scene, np.random.default_rng(3), ControlPoint)
    sims = {}
    for name, mod in (("jax", jsim), ("torch", tsim)):
        orig = mod.solve_umeyama

        def capture(src, dst, _orig=orig, _name=name, **kw):
            T = _orig(src, dst, **kw)
            sims[_name] = np.asarray(T)
            return T

        monkeypatch.setattr(mod, "solve_umeyama", capture)
    kw = dict(verbose=False, min_track_len=2, ba_global_max_iters=20)
    rj = jpipe.apply_control_points(mj, cj, jpipe.PipelineOptions(**kw))
    rt = tpipe.apply_control_points(mt, ct, tpipe.PipelineOptions(**kw))
    np.testing.assert_allclose(sims["torch"], sims["jax"], atol=1e-4)
    _same_map(mt, mj)
    assert len(rt) == len(rj) == 5
    for (cp_t, xt, lt, et), (cp_j, xj, lj, ej) in zip(rt, rj):
        assert cp_t.name == cp_j.name and lt == lj >= 2
        np.testing.assert_allclose(xt, np.asarray(xj), atol=1e-4)
        np.testing.assert_allclose(et, ej, atol=1e-4)
        if not cp_t.fixed:
            assert np.linalg.norm(xt - cp_t.xyz) < 0.05  # geo-registered
    np.testing.assert_allclose(mt.store.point3D_error, mj.store.point3D_error, atol=1e-4)


def test_filter_point_cloud_deletes_the_same_points(survey):
    """The filter stage: a global bundle adjustment with point errors, then
    filter_point_cloud at a threshold inside a clear gap of the error
    distribution: the same points go, their tracks with them."""
    mj, mt = _mappers(survey)
    o = dict(verbose=False, min_track_len=2, ba_global_max_iters=10, refine_camera_params=False)
    jpipe._global_ba(mj, jpipe.PipelineOptions(**o), update_errors=True)
    tpipe._global_ba(mt, tpipe.PipelineOptions(**o), update_errors=True)
    np.testing.assert_allclose(mt.store.point3D_error, mj.store.point3D_error, atol=1e-4)
    err = np.sort(mj.store.point3D_error[mj.store.point3D_valid])
    k = int(np.argmax(np.diff(err[len(err) // 2: -1]))) + len(err) // 2
    thr = 0.5 * (err[k] + err[k + 1])
    assert err[k + 1] - err[k] > 1e-3
    nj, nt = jpipe.filter_point_cloud(mj, thr), tpipe.filter_point_cloud(mt, thr)
    assert nt == nj > 0
    np.testing.assert_array_equal(mt.store.point3D_valid, mj.store.point3D_valid)
    assert mt.store.tracks == mj.store.tracks


def test_point_mean_errors_by_plan_matches_jax(survey):
    """point_mean_errors sums by the K2 plan of obs_point (plan_pt) and
    gives the JAX package's errors, -1 for points without observations;
    without the plan it refuses."""
    mj, _ = _mappers(survey)
    image_ids, poses, _, points, oi, op, oc, xy = mj.ba_problem_arrays(min_track_len=2)
    pj = j_build(poses, points, mj.store.camera_params.astype(np.float32),
                 mj.store.camera_models, oi, op, oc, xy, bucket=True, host=True)
    ej = np.asarray(j_point_mean_errors(pj, jnp.asarray(pj.poses), jnp.asarray(pj.points)))
    pt = problem_from_jax(pj)
    assert pt.plan_pt is not None
    t = {k: v if k.startswith("plan") or v is None else torch.as_tensor(v)
         for k, v in pt._asdict().items()}
    pt_t = pt._replace(**{k: (v.to(CPU) if k.startswith("plan") and v is not None else v)
                          for k, v in t.items()})
    et = point_mean_errors(pt_t, pt_t.poses, pt_t.points).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-4)
    assert (et[len(points):] == -1).all() and (et[: len(points)] >= 0).all()
    with pytest.raises(ValueError, match="plan_pt"):
        point_mean_errors(pt_t._replace(plan_pt=None), pt_t.poses, pt_t.points)
    assert with_plans(pt, ("plan_pt",)).plan_pt is pt.plan_pt
