"""Bundle adjustment of the PyTorch port held against the JAX package.

  - segment sums: the plain versions of CUDA kernels K2/K3 against the
    Pallas kernels in interpret mode, 1e-5 relative (f32 sums in another
    order), including a segment that straddles the Pallas tiles and more
    than 2048 segments;
  - problem construction and the JAX -> port conversion: exact;
  - the dense LM loops (with and without self-calibration) on the same
    converted problem, 6 iterations: poses, points and intrinsics at 1e-4
    relative to their scale (the loops take the same accept/reject path;
    f32 reassociation in the Schur solve moves results by ~1e-6);
  - pose refinement: 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ba import build_problem as j_build
from mavmap_tpu.ba.core import (
    _lm_loop as j_lm_loop, _lm_loop_selfcal as j_lm_loop_selfcal,
    _selfcal_cam_free as j_cam_free, pose_refinement as j_pose_refinement)
from mavmap_tpu.ops.pallas.ba_accum import seg_accum_full as j_full, seg_accum_sorted as j_sorted
from mavmap_tpu.ops.rotation import rotmat_from_rvec as j_rot

from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
from mavmap_tpu_torch.ba.core import (
    _lm_loop, _lm_loop_selfcal, _resolve_solver, _selfcal_cam_free, pose_refinement,
    problem_to_device)
from mavmap_tpu_torch.interop import problem_from_jax
from mavmap_tpu_torch.ops.cuda import ba_accum as ka

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _rel_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


# ----------------------------------------------------------- segment sums


@pytest.mark.parametrize("O,K,S", [(5000, 42, 37), (3000, 3, 2500), (100, 81, 9)])
def test_seg_accum_full_plain_matches_pallas(rng, O, K, S):
    c = rng.normal(size=(O, K)).astype(np.float32)
    ids = rng.integers(0, S, size=O).astype(np.int32)
    got = ka.seg_accum_full(torch.as_tensor(c), torch.as_tensor(ids), S).numpy()
    ref = np.asarray(j_full(jnp.asarray(c), jnp.asarray(ids), S, interpret=True))
    scale = np.zeros((S, K), np.float32)
    np.add.at(scale, ids, np.abs(c))
    assert np.all(np.abs(got - ref) <= 1e-5 * scale + 1e-6)
    assert np.all(got[np.bincount(ids, minlength=S) == 0] == 0.0)


@pytest.mark.parametrize("case", ["tracks", "straddle"])
def test_seg_accum_sorted_plain_matches_pallas(rng, case):
    if case == "tracks":  # > 2048 segments, segments cross the 1024-row tiles
        lens = rng.integers(1, 9, size=2300)
    else:  # one segment spanning several 1024-row tiles
        lens = np.array([5, 2500, 3, 7, 1])
    ids = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    S = len(lens) + 20
    K = 12
    c = rng.normal(size=(len(ids), K)).astype(np.float32)
    offsets = ka.offsets_from_sorted_ids(ids, S)
    got = ka.seg_accum_sorted(torch.as_tensor(c), torch.as_tensor(offsets), S).numpy()
    ref = np.asarray(j_sorted(jnp.asarray(c), jnp.asarray(ids), S, interpret=True))
    scale = np.zeros((S, K), np.float32)
    np.add.at(scale, ids, np.abs(c))
    assert np.all(np.abs(got - ref) <= 1e-5 * scale + 1e-6)
    assert np.all(got[len(lens):] == 0.0)


# ------------------------------------------------------------------ problems


def _scene(rng, I=8, P=240, per_image=140, noise=0.5, focal_err=0.0):
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = (rng.normal(size=(P, 3)) * [4, 4, 2] + [0, 0, 14]).astype(np.float32)
    poses = np.concatenate([rng.normal(size=(I, 3)) * 0.03,
                            np.stack([np.arange(I) * 0.7, np.zeros(I), np.zeros(I)], 1)],
                           axis=1).astype(np.float32)
    oi, op, uv = [], [], []
    for i in range(I):
        R = np.asarray(j_rot(jnp.asarray(poses[i, :3])))
        Xc = X @ R.T + poses[i, 3:]
        u = Xc[:, :2] / Xc[:, 2:] * 700.0 + [400.0, 300.0]
        sel = np.sort(rng.permutation(P)[:per_image])
        oi += [i] * len(sel)
        op += list(sel)
        uv += list(u[sel] + rng.normal(size=(len(sel), 2)) * noise)
    # Perturbed initial values.
    poses0 = poses + rng.normal(size=poses.shape).astype(np.float32) * [0.003] * 3 \
        + np.concatenate([np.zeros((I, 3)), rng.normal(size=(I, 3)) * 0.02], 1)
    poses0[:2] = poses[:2]
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    K0 = K.copy()
    K0[0, :2] *= 1.0 + focal_err
    states = [1, 2] + [0] * (I - 2)
    return (poses0.astype(np.float32), X0.astype(np.float32), K0, np.array([1], np.int32),
            np.array(oi, np.int32), np.array(op, np.int32), np.zeros(len(oi), np.int32),
            np.array(uv, np.float32), states)


def test_build_problem_and_conversion_match_jax(rng):
    poses, X, K, models, oi, op, oc, uv, states = _scene(rng)
    point_fixed = np.zeros(len(X), bool)
    point_fixed[:5] = True
    kw = dict(pose_states=states, point_fixed=point_fixed, bucket=True)
    pj = j_build(poses, X, K, models, oi, op, oc, uv, host=True, **kw)
    pt = build_problem(poses, X, K, models, oi, op, oc, uv, **kw)
    for f in pt._fields:
        if f != "pt_offsets":
            np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)), f)
    conv = problem_from_jax(pj)
    for f in pt._fields:
        np.testing.assert_array_equal(getattr(conv, f), getattr(pt, f), f)
    # CSR offsets bound each dense point's real observations.
    n = int(pt.obs_mask.sum())
    ids = np.repeat(np.arange(len(pt.point_rows)), np.diff(pt.pt_offsets))
    np.testing.assert_array_equal(ids, pt.obs_point_dense[:n])


def _jax_problem(rng, focal_err=0.0):
    poses, X, K, models, oi, op, oc, uv, states = _scene(rng, focal_err=focal_err)
    pj = j_build(poses, X, K, models, oi, op, oc, uv, pose_states=states, bucket=True,
                 host=True)
    return pj, problem_to_device(problem_from_jax(pj), CPU)


LM = dict(scale=1.0, lambda_init=1e-4, lambda_up=10.0, lambda_down=0.5,
          function_tolerance=0.0)


def test_lm_loop_matches_jax(rng):
    pj, pt = _jax_problem(rng)
    jp, jx, jc, jc0, jit = j_lm_loop(jax.tree.map(jnp.asarray, pj), *LM.values(),
                                     max_iters=6, solver="dense", backend="xla")
    tp, tx, tc, tc0, tit = _lm_loop(pt, *LM.values(), 6)
    assert int(jit) == tit == 6
    _rel_close(float(tc0), float(jc0), 1e-5)
    _rel_close(float(tc), float(jc), 1e-4)
    _rel_close(tp.numpy(), np.asarray(jp), 1e-4)
    _rel_close(tx.numpy(), np.asarray(jx), 1e-4)
    assert float(tc) < 0.1 * float(tc0)


def test_lm_loop_selfcal_matches_jax(rng):
    pj, pt = _jax_problem(rng, focal_err=0.01)
    jpj = jax.tree.map(jnp.asarray, pj)
    out_j = j_lm_loop_selfcal(jpj, j_cam_free(jpj), *LM.values(), max_iters=6,
                              solver="dense", backend="xla")
    out_t = _lm_loop_selfcal(pt, _selfcal_cam_free(pt), *LM.values(), 6)
    assert int(out_j[5]) == out_t[5] == 6
    for k in range(3):  # poses, points, intrinsics
        _rel_close(out_t[k].numpy(), np.asarray(out_j[k]), 1e-4)
    _rel_close(float(out_t[3]), float(out_j[3]), 1e-4)
    # Self-calibration removes most of the 7 px focal error in 6 iterations.
    assert abs(float(out_t[2][0, 0]) - 700.0) < 3.5


def test_bundle_adjust_entry(rng):
    poses, X, K, models, oi, op, oc, uv, states = _scene(rng, focal_err=0.01)
    prob = build_problem(poses, X, K, models, oi, op, oc, uv, pose_states=states,
                         bucket=True)
    opts = BAOptions(max_num_iterations=10, refine_camera_params=True,
                     update_point3D_errors=True)
    p, x, info = bundle_adjust(prob, opts, CPU, num_obs=len(oi))
    assert p.shape == prob.poses.shape and x.shape == prob.points.shape
    assert info["final_cost"] < info["initial_cost"]
    assert info["num_residuals"] == 2 * len(oi)
    assert info["cam_params"].shape == (1, 9)
    err = info["point_errors"][: len(X)]
    assert np.all(err[np.isin(np.arange(len(X)), op)] >= 0) and np.median(err) < 2.0


def test_unported_solvers_raise(rng):
    pj, pt = _jax_problem(rng)
    with pytest.raises(NotImplementedError):
        _resolve_solver(pt, BAOptions(solver="cg"))
    big = pt._replace(poses=torch.zeros((64, 6)))
    with pytest.raises(NotImplementedError):
        _resolve_solver(big, BAOptions())
    assert _resolve_solver(pt, BAOptions()) == "dense"


def test_pose_refinement_matches_jax(rng):
    X = (rng.normal(size=(150, 3)) * [3, 3, 1] + [0, 0, 10]).astype(np.float32)
    rv = np.array([0.02, -0.01, 0.03], np.float32)
    tv = np.array([0.3, -0.2, 0.1], np.float32)
    R = np.asarray(j_rot(jnp.asarray(rv)))
    Xc = X @ R.T + tv
    uv = (Xc[:, :2] / Xc[:, 2:] * 700.0 + [400.0, 300.0]
          + rng.normal(size=(150, 2)) * 0.5).astype(np.float32)
    uv[:10] += 40.0  # outliers (Cauchy loss)
    mask = np.ones(150, bool)
    mask[-5:] = False
    K = np.array([700.0, 700.0, 400.0, 300.0, 0, 0, 0, 0, 0], np.float32)
    r0, t0 = rv + 0.01, tv + 0.05
    jr, jt, jc = j_pose_refinement(r0, t0, X, uv, mask, K, 1)
    tr, tt, tc = pose_refinement(r0, t0, X, uv, mask, K, 1, CPU)
    _rel_close(tr.numpy(), np.asarray(jr), 1e-4)
    _rel_close(tt.numpy(), np.asarray(jt), 1e-4)
    _rel_close(float(tc), float(jc), 1e-4)
    assert np.abs(tt.numpy() - tv).max() < 0.01
