"""The benchmark's frozen inputs and reference against the port's own
generator and ATE, at small sizes on the CPU (this test may import the
port; the reference never does)."""

import numpy as np
import pytest
import torch

from sfmbench.reference import judge, roofline, scene as ref

# float32 storage of poses: rotations and translations agree to a few ulps
# of their magnitudes (|rvec| ~ pi, |t| ~ 30-60 m).
RVEC_TOL = 2e-6
TVEC_TOL = 2e-5
# Keypoints: the port projects in float32, the reference in float64 then
# rounds; at 800 x 600 px that is within a few float32 ulps of 800.
KP_TOL = 2e-4


@pytest.mark.parametrize("kw", [
    dict(num_images=8, num_points=600, relief=10.0, rows=2, seed=11),
    dict(num_images=30, num_points=4000, relief=10.0, rows=2, seed=11),
    dict(num_images=60, num_points=7200, relief=10.0, rows=4, extent=None, seed=13),
    dict(num_images=60, num_points=7200, relief=10.0, rows=1, extent=None, seed=13),
], ids=["small", "uav30", "survey60-lawnmower", "survey60-corridor"])
def test_scene_matches_port(kw):
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene

    got, want = ref.make_uav_scene(**kw), make_uav_scene(**kw)
    np.testing.assert_array_equal(got.points3D, want.points3D)
    np.testing.assert_array_equal(got.descriptors, want.descriptors)
    np.testing.assert_allclose(got.rvecs, want.rvecs, rtol=0, atol=RVEC_TOL)
    np.testing.assert_allclose(got.tvecs, want.tvecs, rtol=0, atol=TVEC_TOL)
    np.testing.assert_array_equal(got.cam_params, want.cam_params)
    np.testing.assert_allclose(got.centers(), want.camera_centers(), rtol=0, atol=TVEC_TOL)


def test_features_match_port():
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

    kw = dict(num_images=8, num_points=600, relief=10.0, rows=2, seed=11)
    got, gids = ref.render_features(ref.make_uav_scene(**kw), np.random.default_rng(4),
                                    pixel_noise=0.3, clutter=64, capacity=1024)
    want, wids = render_features(make_uav_scene(**kw), pixel_noise=0.3, clutter=64, seed=3)
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
    """A MapState built from the truth: every observation of a real point."""
    obs_f, obs_r, obs_p = [], [], []
    for f in frames:
        rows = np.flatnonzero(gids[f] >= 0)
        obs_f.append(np.full(len(rows), f))
        obs_r.append(rows)
        obs_p.append(gids[f][rows])
    pids, inv = np.unique(np.concatenate(obs_p), return_inverse=True)
    return judge.MapState(
        frames=np.array(frames), rvecs=scene.rvecs[frames].astype(np.float64),
        tvecs=scene.tvecs[frames].astype(np.float64),
        cam_params=np.repeat(scene.cam_params[:1].astype(np.float64), len(frames), 0),
        obs_frame=np.concatenate(obs_f), obs_row=np.concatenate(obs_r), obs_point=inv,
        points=scene.points3D[pids], maps=1, closures=0)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_judge_on_the_truth(noise):
    s = ref.make_uav_scene(num_images=6, num_points=800, relief=10.0, rows=2, seed=11)
    feats, gids = ref.render_features(s, np.random.default_rng(0), pixel_noise=noise,
                                      clutter=8)
    kps = [k for k, _ in feats]
    j = judge.judge_map(_true_state(s, feats, gids, list(range(6))), s, kps, 6)
    assert j["missing"] == 0
    assert j["ate_m"] < 1e-5
    # Pixel noise of sigma per axis: RMSE of the 2-D error ~ sqrt(2) sigma.
    assert j["reproj_rmse_px"] == pytest.approx(np.sqrt(2) * noise, abs=0.05 + 0.1 * noise)
    dropped = judge.judge_map(_true_state(s, feats, gids, [0, 1, 2, 4]), s, kps, 6)
    assert dropped["missing"] == 2


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
