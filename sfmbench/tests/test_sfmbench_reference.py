"""The benchmark's frozen inputs and reference against the port's own
generator and ATE, at small sizes on the CPU (this test may import the
port; the reference never does)."""

import numpy as np
import pytest
import torch

from sfmbench import core
from sfmbench.reference import judge, roofline, scene as ref

# float32 storage of poses: rotations and translations agree to a few ulps
# of their magnitudes (|rvec| ~ pi, |t| ~ 30-60 m).
RVEC_TOL = 2e-6
TVEC_TOL = 2e-5
# Keypoints: the port projects in float32, the reference in float64 then
# rounds; at 800 x 600 px that is within a few float32 ulps of 800.
KP_TOL = 2e-4
# The smoke's two-camera rig (the port's make_multi_camera_scene): even
# frames on a PINHOLE camera of 700 px, odd frames on an OPENCV camera.
RIG_CAMERAS = [
    {"model": "PINHOLE", "params": [700.0, 700.0, 400.0, 300.0]},
    {"model": "OPENCV", "params": [620.0, 620.0, 406.0, 296.0, -0.15, 0.03, 0.0005, -0.0005]},
]
SMALL = dict(num_images=8, num_points=600, relief=10.0, rows=2, seed=11)
UAV30 = dict(num_images=30, num_points=4000, relief=10.0, rows=2, seed=11)


def _port_scene(kw, rig):
    from mavmap_tpu_torch.utils.synthetic import make_multi_camera_scene, make_uav_scene

    return (make_multi_camera_scene if rig else make_uav_scene)(**kw)


def _ref_scene(kw, rig):
    return ref.make_uav_scene(**kw, cameras=RIG_CAMERAS if rig else None)


@pytest.mark.parametrize("kw, rig", [
    (SMALL, False), (UAV30, False),
    (dict(num_images=60, num_points=7200, relief=10.0, rows=4, extent=None, seed=13), False),
    (dict(num_images=60, num_points=7200, relief=10.0, rows=1, extent=None, seed=13), False),
    (SMALL, True), (UAV30, True),
], ids=["small", "uav30", "survey60-lawnmower", "survey60-corridor", "rig8", "rig30"])
def test_scene_matches_port(kw, rig):
    got, want = _ref_scene(kw, rig), _port_scene(kw, rig)
    np.testing.assert_array_equal(got.points3D, want.points3D)
    np.testing.assert_array_equal(got.descriptors, want.descriptors)
    np.testing.assert_allclose(got.rvecs, want.rvecs, rtol=0, atol=RVEC_TOL)
    np.testing.assert_allclose(got.tvecs, want.tvecs, rtol=0, atol=TVEC_TOL)
    np.testing.assert_array_equal(got.cam_params, want.cam_params)
    np.testing.assert_array_equal(got.cam_models, want.cam_models)
    np.testing.assert_array_equal(got.image_cameras, want.image_cameras)
    assert (got.cam_params.dtype, got.cam_models.dtype, got.image_cameras.dtype) == (
        want.cam_params.dtype, want.cam_models.dtype, want.image_cameras.dtype)
    np.testing.assert_allclose(got.centers(), want.camera_centers(), rtol=0, atol=TVEC_TOL)


@pytest.mark.parametrize("cameras", [
    [{"model": "CATA", "params": [700.0] * 9}],
    [{"model": "OPENCV", "params": [700.0, 700.0, 400.0, 300.0]}],
], ids=["unknown-model", "too-few-params"])
def test_scene_refuses_cameras(cameras):
    with pytest.raises(ValueError):
        ref.make_uav_scene(num_images=2, num_points=10, cameras=cameras)


@pytest.mark.parametrize("kw, rig", [(SMALL, False), (SMALL, True), (UAV30, True)],
                         ids=["small", "rig8", "rig30"])
def test_features_match_port(kw, rig):
    from mavmap_tpu_torch.utils.synthetic import render_features

    got, gids = ref.render_features(_ref_scene(kw, rig), np.random.default_rng(4),
                                    pixel_noise=0.3, clutter=64, capacity=1024)
    want, wids = render_features(_port_scene(kw, rig), pixel_noise=0.3, clutter=64, seed=3)
    assert len(got) == len(want) == kw["num_images"]
    for (k, d), (wk, wd), g, w in zip(got, want, gids, wids):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(k, wk, rtol=0, atol=KP_TOL)
        np.testing.assert_allclose(d, wd, rtol=0, atol=1e-6)


def test_seed_orders_the_workloads_flights():
    from sfmbench.core import make_inputs

    wl = {"flight": dict(num_images=4, num_points=800, relief=10.0, rows=1, seed=11),
          "noise": dict(clutter=8, capacity=1024), "data_seed": 101, "maps": 3}
    a, b = make_inputs(wl, 5, 3), make_inputs(wl, 2 ** 31 + 9, 3)
    assert sorted(a.order) == sorted(b.order) == [0, 1, 2]
    for inputs in (a, b):
        for k, flight in enumerate(inputs.order):
            want, _ = ref.render_features(inputs.scene, ref.noise_rng(101, flight), clutter=8,
                                          capacity=1024)
            for (kg, dg), (kw, dw) in zip(inputs.feats[k], want):
                np.testing.assert_array_equal(kg, kw)
                np.testing.assert_array_equal(dg, dw)
    np.testing.assert_array_equal(a.feats[-1][0][0], b.feats[-1][0][0])
    assert make_inputs(wl, 5, 1).order == a.order[:1]


def test_noise_rng_takes_large_seeds():
    big = 2 ** 31 + 12345
    a = ref.noise_rng(big, 0).random(4)
    np.testing.assert_array_equal(a, ref.noise_rng(big, 0).random(4))
    assert not np.array_equal(a, ref.noise_rng(big + 1, 0).random(4))
    assert 0 <= ref.mapper_seed(big, 3) < 2 ** 31
    orders = {tuple(ref.map_order(big + i, 4)) for i in range(20)}
    assert len(orders) > 1 and all(sorted(o) == [0, 1, 2, 3] for o in orders)


@pytest.mark.parametrize("model", [ref.PINHOLE, ref.OPENCV], ids=["PINHOLE", "OPENCV"])
def test_projection_matches_port(model):
    """Points over the whole 800 x 600 frame and beyond its corners, at
    20-40 m, through the rig's cameras: the reference's float64 projection
    against the port's camera model run in float64."""
    from mavmap_tpu_torch.models import camera as cam

    c = model - 1
    params = np.zeros(9)
    params[:len(RIG_CAMERAS[c]["params"])] = RIG_CAMERAS[c]["params"]
    u, v = np.meshgrid(np.linspace(-0.75, 0.75, 31), np.linspace(-0.55, 0.55, 23))
    z = np.linspace(20.0, 40.0, u.size).reshape(u.shape)
    X = np.stack([u * z, v * z, z], -1).reshape(-1, 3)
    want = cam.world2image(torch.as_tensor(X), model, torch.as_tensor(params)).numpy()
    np.testing.assert_allclose(ref.project(X, params, model), want, rtol=0, atol=1e-9)
    # The same points through per-row parameters, as the judge passes them.
    np.testing.assert_allclose(ref.project(X, np.tile(params, (len(X), 1)), model), want,
                               rtol=0, atol=1e-9)
    if model == ref.OPENCV:
        # At the frame's corners the distortion moves a point by tens of pixels.
        assert np.abs(ref.project(X, params, ref.PINHOLE) - want).max() > 20.0


def test_projection_refuses_other_models():
    with pytest.raises(ValueError):
        ref.project(np.ones((2, 3)), np.ones(9), 3)


def test_rotations_round_trip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        r = rng.normal(size=3)
        r *= rng.uniform(0.01, 3.1) / np.linalg.norm(r)
        np.testing.assert_allclose(ref.rvec(ref.rotmat(r)), r, atol=1e-9)
    from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec

    rv = rng.normal(size=(5, 3))
    np.testing.assert_allclose(ref.rotmat(rv), rotmat_from_rvec(torch.as_tensor(rv)).numpy(),
                               atol=1e-12)


def test_ate_matches_port():
    from mavmap_tpu_torch.utils.synthetic import ate_rmse

    rng = np.random.default_rng(1)
    gt = rng.normal(size=(40, 3)) * 20
    R = ref.rotmat(np.array([0.3, -0.2, 1.0]))
    est = 0.7 * (gt + rng.normal(size=gt.shape) * 0.05) @ R.T + [1.0, 2.0, 3.0]
    got = float(np.sqrt(np.mean(judge.aligned_errors(est, gt) ** 2)))
    assert got == pytest.approx(ate_rmse(est, gt), rel=1e-5)
    assert np.sqrt(np.mean(judge.aligned_errors(0.5 * gt @ R.T + 4.0, gt) ** 2)) < 1e-9


def _true_state(scene, feats, gids, frames):
    """A MapState built from the truth: every observation of a real point,
    each frame with its own camera's model and parameters."""
    obs_f, obs_r, obs_p = [], [], []
    for f in frames:
        rows = np.flatnonzero(gids[f] >= 0)
        obs_f.append(np.full(len(rows), f))
        obs_r.append(rows)
        obs_p.append(gids[f][rows])
    pids, inv = np.unique(np.concatenate(obs_p), return_inverse=True)
    cams = scene.image_cameras[frames]
    return judge.MapState(
        frames=np.array(frames), rvecs=scene.rvecs[frames].astype(np.float64),
        tvecs=scene.tvecs[frames].astype(np.float64),
        cam_params=scene.cam_params[cams].astype(np.float64),
        obs_frame=np.concatenate(obs_f), obs_row=np.concatenate(obs_r), obs_point=inv,
        points=scene.points3D[pids], maps=1, closures=0, cam_models=scene.cam_models[cams])


@pytest.mark.parametrize("noise, rig", [
    pytest.param(0.0, False, id="0.0"), pytest.param(0.5, False, id="0.5"),
    pytest.param(0.0, True, id="rig-0.0"), pytest.param(0.3, True, id="rig-0.3"),
])
def test_judge_on_the_truth(noise, rig):
    s = _ref_scene(dict(num_images=6, num_points=800, relief=10.0, rows=2, seed=11), rig)
    feats, gids = ref.render_features(s, np.random.default_rng(0), pixel_noise=noise,
                                      clutter=8)
    kps = [k for k, _ in feats]
    j = judge.judge_map(_true_state(s, feats, gids, list(range(6))), s, kps, 6)
    assert j["missing"] == 0
    assert j["ate_m"] < 1e-5
    # Pixel noise of sigma per axis: RMSE of the 2-D error ~ sqrt(2) sigma.
    assert j["reproj_rmse_px"] == pytest.approx(np.sqrt(2) * noise, abs=0.05 + 0.1 * noise)
    assert j["reproj_rmse_px"] <= 1.5 * np.sqrt(2) * noise + 1e-3
    dropped = judge.judge_map(_true_state(s, feats, gids, [0, 1, 2, 4]), s, kps, 6)
    assert dropped["missing"] == 2


def test_state_defaults_to_pinhole():
    s = ref.make_uav_scene(**SMALL)
    feats, gids = ref.render_features(s, np.random.default_rng(0), clutter=8)
    state = _true_state(s, feats, gids, list(range(8)))
    from dataclasses import replace

    bare = replace(state, cam_models=None)
    assert bare.cam_models.tolist() == [ref.PINHOLE] * 8
    np.testing.assert_array_equal(judge.reprojection_errors(bare, [k for k, _ in feats]),
                                  judge.reprojection_errors(state, [k for k, _ in feats]))
    assert judge.bfloat16_state(state).cam_models is state.cam_models


def _rig_truth_record():
    """The smoke's rig flight (30 frames, clutter 64, seed 11) as a map
    record whose state is the truth, with the keypoints handed over."""
    s = _ref_scene(UAV30, True)
    feats, gids = ref.render_features(s, np.random.default_rng(12), pixel_noise=0.3,
                                      clutter=64, capacity=1024)
    rec = core.MapRecord(wall_s=1.0, offered=30, registered=30, counters={}, timings={},
                         stats={}, state=_true_state(s, feats, gids, list(range(30))))
    return s, [k for k, _ in feats], rec


def test_zeroed_distortion_is_not_correct():
    """A planted fault: the OPENCV camera's k1, k2, p1, p2 set to zero in
    the map handed to the judge. The rig's truth passes the limits of
    uav30-chained (the same flight from one camera); the fault fails them."""
    from dataclasses import replace

    s, kps, rec = _rig_truth_record()
    limits = core.load_json(core.ROOT / "workloads" / "uav30-chained.json")["limits"]
    ok, checks = core.check(core.judge_values([rec], s, [kps])[0], limits)
    assert ok, checks
    params = rec.state.cam_params.copy()
    params[rec.state.cam_models == ref.OPENCV, 4:8] = 0.0
    fault = replace(rec, state=replace(rec.state, cam_params=params))
    ok, checks = core.check(core.judge_values([fault], s, [kps])[0], limits)
    assert not ok and checks["reproj_worst_px"]["value"] > 3.0, checks


def test_kernel_costs_match_the_smoke():
    import chip_smoke

    assert roofline.k1_cost(1, 1024, 1024, 128, True, True, True) == chip_smoke._k1_cost(
        1024, 1024, 128, True)
    assert roofline.k3_cost(151552, 3, 49152)[1] == chip_smoke._seg_cost(151552, 3, 49152)[1]
    nb, fl = roofline.k2_cost(303104, 9, 201)
    # The same, plus the plan's S + 1 offsets that the smoke leaves out.
    assert (nb - 4 * 202, fl) == chip_smoke._seg_cost(303104, 9, 201)
    # The smoke's K1 bound at 1024 x 1024 x 128 with the prefilter (PERF.md: 4.07 us).
    assert roofline.bound_s(*roofline.k1_cost(1, 1024, 1024, 128, True, True, True)) \
        == pytest.approx(4.07e-6, rel=0.01)
    assert roofline.is_hand_kernel("void seg_rows_kernel<true, true>(float const*, ...)")
    assert roofline.is_hand_kernel("match_tile_kernel<false>")
    assert not roofline.is_hand_kernel("void at::native::vectorized_elementwise_kernel<4>")
