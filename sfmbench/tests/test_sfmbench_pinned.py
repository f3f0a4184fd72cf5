"""The inputs of the benchmark's PINHOLE cells and the judge's numbers,
pinned bit for bit. A change to the reference scene, the inputs or the
judge must leave every byte handed to the program and every number judged
as the cells' limits and bounds were set from; the values below are those
of the harness's single-camera scene and judge, read with numpy 2.0."""

import hashlib

import numpy as np
import pytest

from sfmbench import core
from sfmbench.reference import judge, scene as ref

# sha256 of make_inputs(workload, PIN_SEED, maps) for each cell at the
# number of flights it was recorded with: the scene's points, descriptors,
# poses and camera parameters, then every map's (warm-up first) keypoints
# and descriptors, then the flights' order. A window of more flights adds
# flights whose noise comes from the same generators.
PIN_SEED = 2 ** 31 + 4321
PIN_MAPS = {"uav30-chained": 3, "survey60-lawnmower": 1}
INPUT_DIGESTS = {
    "uav30-chained": "006179a0e4ac389556997293083a5a3524492e66239ae0b1f83f38c60815c5e4",
    "survey60-lawnmower": "76dec6d004aee9df035f2c6e6212dd0569983d510853c1b78354f3d0be890577",
}
# judge_map over a fixed perturbed truth map, and over its bfloat16 control.
JUDGED = {
    "program": (0.006308232856560265, 0.5326094488762819, 176.1608243450563,
                0.0002387628106355189),
    "control": (0.09241426541735653, 1.1101898005029647, 765.3957851404446,
                0.05124237871577772),
}


def inputs_digest(inputs):
    h = hashlib.sha256()
    s = inputs.scene
    for a in (s.points3D, s.descriptors, s.rvecs, s.tvecs, s.cam_params):
        h.update(np.ascontiguousarray(a).tobytes())
    for k in sorted(inputs.feats):
        for kp, de in inputs.feats[k]:
            h.update(np.ascontiguousarray(kp).tobytes())
            h.update(np.ascontiguousarray(de).tobytes())
    h.update(np.asarray(inputs.order, np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(INPUT_DIGESTS))
def test_cell_inputs_are_pinned(name):
    cell = core.load_cell(name)
    wl = dict(cell.workload, maps=PIN_MAPS[name])
    assert inputs_digest(core.make_inputs(wl, PIN_SEED, wl["maps"], cell.config)) \
        == INPUT_DIGESTS[name]


@pytest.mark.parametrize("name", sorted(INPUT_DIGESTS))
def test_more_flights_keep_each_flights_inputs(name):
    """The cell's window of `maps` flights hands each flight (and the
    warm-up) the features that the pinned window of fewer flights does."""
    cell = core.load_cell(name)
    full = core.make_inputs(cell.workload, PIN_SEED, cell.workload["maps"], cell.config)
    few = core.make_inputs(dict(cell.workload, maps=PIN_MAPS[name]), PIN_SEED,
                           PIN_MAPS[name], cell.config)
    by_flight = dict(zip(full.order, (full.feats[k] for k in range(len(full.order)))))
    assert sorted(full.order) == list(range(cell.workload["maps"]))
    for k, flight in [(-1, -1)] + list(enumerate(few.order)):
        got = full.feats[-1] if flight == -1 else by_flight[flight]
        for (kp, de), (kp0, de0) in zip(got, few.feats[k], strict=True):
            assert np.array_equal(kp, kp0) and np.array_equal(de, de0)


def perturbed_state():
    """A map of a short two-strip flight: the truth with every pose, point
    and focal length moved by fixed small amounts."""
    s = ref.make_uav_scene(num_images=6, num_points=800, relief=10.0, rows=2, seed=11)
    feats, gids = ref.render_features(s, np.random.default_rng(0), pixel_noise=0.3, clutter=8)
    rng = np.random.default_rng(5)
    frames = np.arange(6)
    obs_f, obs_r, obs_p = [], [], []
    for f in frames:
        rows = np.flatnonzero(gids[f] >= 0)
        obs_f.append(np.full(len(rows), f))
        obs_r.append(rows)
        obs_p.append(gids[f][rows])
    pids, inv = np.unique(np.concatenate(obs_p), return_inverse=True)
    params = np.repeat(s.cam_params[:1].astype(np.float64), 6, 0)
    params[:, :2] += rng.normal(size=(6, 1)) * 0.5
    state = judge.MapState(
        frames=frames, rvecs=s.rvecs.astype(np.float64) + rng.normal(size=(6, 3)) * 1e-4,
        tvecs=s.tvecs.astype(np.float64) + rng.normal(size=(6, 3)) * 5e-3, cam_params=params,
        obs_frame=np.concatenate(obs_f), obs_row=np.concatenate(obs_r), obs_point=inv,
        points=s.points3D[pids] + rng.normal(size=(len(pids), 3)) * 5e-3, maps=1, closures=0)
    return s, [k for k, _ in feats], state


def judged_numbers():
    s, kps, state = perturbed_state()
    out = {}
    for mode, st in (("program", state), ("control", judge.bfloat16_state(state))):
        j = judge.judge_map(st, s, kps, 6)
        out[mode] = (j["ate_m"], j["reproj_rmse_px"], float(j["reproj_err2"].sum()),
                     float(j["center_err2"].sum()))
    return out


def test_judged_numbers_are_pinned():
    assert judged_numbers() == JUDGED
