"""The run_pipeline options this port carries since the CLI slice, each run
on the CPU and held against the JAX package's run_pipeline with the same
option: IMU rotation priors, ground control points, the point-cloud filter,
map checkpoints (period and path), the debug dumps and resume_from.

One 8-image survey (capacity 512, 128 RANSAC trials, no loop detection) goes
through both packages once with every one of these options on; each case
then checks its own option's outcome against the JAX run's. The packages
draw different RANSAC samples, so the checks are on outcomes: the same
registered frames, rotations against the priors (0.02, tests/test_pipeline.py's
bound) and against each other (0.005), control points against the truth
(0.05 m) and each other (0.01 m), filtered point counts within 10 %, the
same debug dump names, and checkpoints that load in the other package.
"""

import os

import numpy as np
import pytest
import torch

from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.sfm import SequentialMapper as JMapper
from mavmap_tpu.sfm import pipeline as jpipe
from mavmap_tpu.utils import checkpoint as jckpt
from mavmap_tpu.utils.io import ControlPoint as JControlPoint
from mavmap_tpu.utils.synthetic import imu_priors, make_uav_scene, render_features

from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec
from mavmap_tpu_torch.sfm import SequentialMapper
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.utils import checkpoint as tckpt
from mavmap_tpu_torch.utils.io import ControlPoint

torch.set_num_threads(2)
CPU = torch.device("cpu")
N, CAP, TRIALS = 8, 512, 128
SCENE = dict(num_images=N, num_points=1800, relief=10.0, rows=1, seed=10)
BASE = dict(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
            loop_detection=False, essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS,
            ba_local_max_iters=8, ba_global_max_iters=20)
OPTIONS = dict(constrain_rotation=True, constrain_rotation_weight=20.0,
               use_control_points=True, filter_max_error=1.0, checkpoint_period=3, debug=True)


def _rot(rvecs):
    return rotmat_from_rvec(torch.as_tensor(np.asarray(rvecs, np.float32))).numpy()


def _control_points(scene, cls):
    rng = np.random.default_rng(4)
    out = []
    for k in range(5):
        X = np.array([rng.uniform(1, 15), rng.uniform(2, 10), rng.uniform(0, 3)])
        obs = []
        for i in range(N):
            Xc = _rot(scene.rvecs[i]).astype(np.float64) @ X + scene.tvecs[i]
            u, v = 700.0 * Xc[0] / Xc[2] + 400.0, 700.0 * Xc[1] / Xc[2] + 300.0
            if Xc[2] > 1 and 0 <= u < 800 and 0 <= v < 600:
                obs.append((i, float(u), float(v)))
        out.append(cls(f"cp{k}", X.copy(), obs, fixed=k < 4))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages over the survey with every option on; returns
    {package: (result, checkpoint path, debug dir)} and the scene, priors
    and features."""
    tmp = tmp_path_factory.mktemp("options")
    scene = make_uav_scene(**SCENE)
    feats, _ = render_features(scene, pixel_noise=0.4, clutter=15, seed=10)
    feats = [(k[:CAP], d[:CAP]) for k, d in feats]
    priors = imu_priors(scene, noise=0.005, seed=10)
    out = {}
    for pkg, pipe, prov, cp_cls, kw in (
            ("torch", tpipe, ArrayFeatureProvider, ControlPoint, {"device": CPU}),
            ("jax", jpipe, JProvider, JControlPoint, {})):
        ckpt, dbg = str(tmp / f"{pkg}-map.npz"), str(tmp / f"{pkg}-debug")
        opts = pipe.PipelineOptions(**BASE, **OPTIONS, checkpoint_path=ckpt, debug_path=dbg)
        res = pipe.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                                prov(feats, capacity=CAP), opts, rot_priors=priors,
                                control_points=_control_points(scene, cp_cls), **kw)
        out[pkg] = (res, ckpt, dbg)
    return out, scene, priors, feats


def _registered(res):
    return sorted(res.main_mapper.image_idx_to_id)


def _rotations(m, idxs):
    return _rot(np.stack([m.store.image_rvecs[m.image_idx_to_id[i]] for i in idxs]))


def _case_constrain_rotation(runs):
    """Every frame registered in both; the rotations lie within 0.02 of the
    priors in the priors' frame (the model is aligned to them before each
    constrained bundle adjustment) and within 0.005 of the JAX package's."""
    out, scene, priors, _ = runs
    (rt, _, _), (rj, _, _) = out["torch"], out["jax"]
    assert _registered(rt) == _registered(rj) == list(range(N))
    Rp = _rot(np.stack([priors[i] for i in range(N)]))
    Rt, Rj = _rotations(rt.main_mapper, range(N)), _rotations(rj.main_mapper, range(N))
    assert np.abs(Rt - Rp).max() < 0.02 and np.abs(Rj - Rp).max() < 0.02
    assert np.abs(Rt - Rj).max() < 0.005


def _case_use_control_points(runs):
    """control_point_results in both, for the same points with the same
    track lengths; the free point within 0.05 m of the truth and 0.01 m of
    the JAX package's estimate; the camera centres in the same frame as the
    JAX package's, within 0.02 m with no similarity fit. (The filter stage
    after the control points runs two constrained bundle adjustments, which
    rotate the model about the origin into the priors' frame again: both
    packages end some 0.1-0.3 m off the control points' frame.)"""
    out, scene, _, _ = runs
    (rt, _, _), (rj, _, _) = out["torch"], out["jax"]
    assert rt.control_point_results is not None and rj.control_point_results is not None
    for (cp, xt, lt, _), (_, xj, lj, _) in zip(rt.control_point_results,
                                               rj.control_point_results):
        assert lt == lj >= 2
        assert np.linalg.norm(xt - np.asarray(xj)) < 0.01
        if not cp.fixed:
            assert np.linalg.norm(xt - cp.xyz) < 0.05
    centres = []
    for m in (rt.main_mapper, rj.main_mapper):
        t = np.stack([m.store.image_tvecs[m.image_idx_to_id[i]] for i in range(N)])
        centres.append(-np.einsum("nji,nj->ni", _rotations(m, range(N)), t))
    assert np.abs(centres[0] - centres[1]).max() < 0.02
    assert np.sqrt(np.mean(np.sum((centres[0] - scene.camera_centers()) ** 2, -1))) < 0.5


def _case_filter_max_error(runs):
    """The filter stage ran in both (its timing), and the maps keep point
    counts within 10 % of each other."""
    out = runs[0]
    (rt, _, _), (rj, _, _) = out["torch"], out["jax"]
    assert "filter" in rt.timings and "filter" in rj.timings
    nt, nj = rt.main_mapper.store.num_points3D, rj.main_mapper.store.num_points3D
    assert abs(nt - nj) <= 0.1 * nj and nt > 100


def _load_both(feats, path):
    scene = make_uav_scene(**SCENE)
    mt = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                          ArrayFeatureProvider(feats, capacity=CAP), device=CPU)
    mj = JMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                 JProvider(feats, capacity=CAP), store_backend="python")
    return tckpt.load_map(mt, path), jckpt.load_map(mj, path)


def _case_checkpoint_period(runs):
    """After every 3 or more newly committed frames (a chain commits up to
    4) the map went to the checkpoint in both packages: each package's last
    checkpoint holds the same frames, and loads in the other package too."""
    out, _, _, feats = runs
    held = []
    for pkg in ("torch", "jax"):
        mt, mj = _load_both(feats, out[pkg][1])
        assert sorted(mt.image_idx_to_id) == sorted(mj.image_idx_to_id)
        np.testing.assert_array_equal(mt.store.point3D_xyz, mj.store.point3D_xyz)
        held.append(sorted(mt.image_idx_to_id))
    assert held[0] == held[1] and 3 <= len(held[0]) <= N


def _case_checkpoint_path(runs):
    """The checkpoint lands at checkpoint_path, in the JAX package's npz
    format (every key the JAX writer writes)."""
    out = runs[0]
    kt = set(np.load(out["torch"][1]).files)
    kj = set(np.load(out["jax"][1]).files)
    assert kt == kj and {"point3D_xyz", "track_flat", "idx_to_id", "pair_graph"} <= kt


def _case_debug(runs):
    """The same debug dumps by name in both packages (match tables, track
    logs and scenes per step: the same steps ran), with the same headers."""
    out = runs[0]
    nt, nj = sorted(os.listdir(out["torch"][2])), sorted(os.listdir(out["jax"][2]))
    assert nt == nj and len(nt) >= 3 * N
    for name in nt:
        if name.endswith(".txt"):
            for d in (out["torch"][2], out["jax"][2]):
                assert open(os.path.join(d, name)).readline() == "# x_a y_a x_b y_b inlier\n"


def _case_resume_from(runs):
    """resume_from each package's mid-run checkpoint continues the
    sequential loop through the last frame in both, registering every
    frame; the port resumes from the JAX package's checkpoint as well."""
    out, scene, priors, feats = runs
    opts = dict(BASE, constrain_rotation=True, constrain_rotation_weight=20.0)
    reg = {}
    for name, path, pipe, prov, kw in (
            ("torch", out["torch"][1], tpipe, ArrayFeatureProvider, {"device": CPU}),
            ("jax", out["jax"][1], jpipe, JProvider, {}),
            ("torch-from-jax", out["jax"][1], tpipe, ArrayFeatureProvider, {"device": CPU})):
        res = pipe.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                                prov(feats, capacity=CAP), pipe.PipelineOptions(**opts),
                                rot_priors=priors, resume_from=path, **kw)
        reg[name] = _registered(res)
    assert reg["torch"] == reg["jax"] == reg["torch-from-jax"] == list(range(N))


@pytest.mark.parametrize("option", ["constrain_rotation", "use_control_points",
                                    "filter_max_error", "checkpoint_period",
                                    "checkpoint_path", "debug", "resume_from"])
def test_ported_option_matches_jax(runs, option):
    """Each option of the JAX pipeline ported with the CLI slice runs on the
    CPU and lands where the JAX package's run lands (see the module
    docstring for each case's checks)."""
    globals()[f"_case_{option}"](runs)
