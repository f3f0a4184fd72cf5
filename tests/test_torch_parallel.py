"""The port's distributed path (mavmap_tpu_torch/parallel/) on CPU ranks,
held against the JAX package's mesh on virtual CPU devices and against the
port's own one-process path.

Ranks are spawned processes joined by a gloo group on localhost, one
thread each; two module fixtures keep one set of 2 and one of 4 ranks for
every case, and each case or launch has a join timeout (the group's
collective timeout is 120 s). The rank side of each case is a `_task_*`
function of this module; JAX is imported inside the parent's tests only,
so the ranks import PyTorch and the port alone.

  - partition_problem equals the JAX package's shards array for array;
  - dist_bundle_adjust (dense and CG, 2 and 4 ranks) against the JAX
    package's dist_bundle_adjust on as many virtual devices and the port's
    one-device bundle_adjust; the gauge; rotation priors; a loose cg_tol
    honoured (the repaired clip); a second solve repeats bit for bit;
  - dist_match_pairs / dist_match_counts equal to the JAX package's;
  - the sharded register_view_pairs / register_view_batch give every slot
    the unsharded step's bits, with injected samples and with draws from a
    generator, which ends where the unsharded step's does;
  - process_shard_bounds equals the JAX helper's for one device per
    process;
  - run_pipeline(mesh_devices=2) against mesh_devices=1, and the CLI's
    --mesh 2 against --mesh 1;
  - the digest check raises on ranks holding different maps, a dead rank
    fails its launch within seconds, and run_pipeline refuses mesh_devices
    without a group of that size;
  - a singular reduced camera system gives a rejected LM step, not an
    exception, as XLA's solve does in the JAX package.
"""

import os
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mavmap_tpu_torch import cli as tcli
from mavmap_tpu_torch.ba import BA_POSE_FIXED, BA_POSE_FIXED_X, BAOptions, build_problem
from mavmap_tpu_torch.ba import bundle_adjust
from mavmap_tpu_torch.ba.core import (_lm_loop, _lm_loop_selfcal, _lm_step, _lm_step_cg,
                                      _selfcal_cam_free, problem_to_device, solver_plans,
                                      with_plans)
from mavmap_tpu_torch.features import ArrayFeatureProvider, FeatureCache
from mavmap_tpu_torch.loop import train_voc_tree
from mavmap_tpu_torch.models import camera as cam
from mavmap_tpu_torch.ops.matching import match_features_batched
from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec
from mavmap_tpu_torch.parallel import (dist_bundle_adjust, dist_match_counts, dist_match_pairs,
                                       dist_register_view_batch, dist_register_view_pairs,
                                       global_mesh, host_local_to_global, launch,
                                       partition_problem, process_shard_bounds)
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.sfm.kernels import register_view_batch, register_view_pairs
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

CPU = torch.device("cpu")
JOIN_S = 300  # each case's and each launch's join timeout


# ------------------------------------------------------------ rank pools


def _serve(mesh, tasks, results):
    """A pool rank: run (fn, args) from its task queue as fn(mesh, *args)
    until None, reporting (rank, ok, result or traceback)."""
    import traceback

    while True:
        task = tasks[mesh.rank].get()
        if task is None:
            return None
        fn, args = task
        try:
            results.put((mesh.rank, True, fn(mesh, *args)))
        except Exception:
            results.put((mesh.rank, False, traceback.format_exc()))


class _Ranks:
    """n CPU ranks kept alive for a module: parallel.launch of `_serve` on
    a thread of this process."""

    def __init__(self, n):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = n
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.error = None

        def run():
            try:
                launch(_serve, n, "cpu", args=(self.tasks, self.results), threads=1,
                       timeout=1800)
            except Exception as e:  # reported by the next run()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def run(self, fn, *args, expect_error=False):
        """fn(mesh, *args) on every rank: the results in rank order (with
        expect_error, each rank's (ok, result or traceback))."""
        for q in self.tasks:
            q.put((fn, args))
        out = {}
        deadline = time.monotonic() + JOIN_S
        while len(out) < self.n:
            if self.error is not None:
                raise self.error
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not finish {fn.__name__} in {JOIN_S} s")
            try:
                rank, ok, val = self.results.get(timeout=0.5)
            except queue.Empty:
                continue
            out[rank] = (ok, val)
        if expect_error:
            return [out[r] for r in range(self.n)]
        bad = [val for ok, val in out.values() if not ok]
        assert not bad, bad[0]
        return [out[r][1] for r in range(self.n)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        self.thread.join(timeout=60)


@pytest.fixture(scope="module")
def ranks2():
    r = _Ranks(2)
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4():
    r = _Ranks(4)
    yield r
    r.close()


@pytest.fixture
def jax_parallel():
    """The JAX package's parallel module and its Mesh, imported here (the
    ranks import this file and must not import JAX)."""
    from jax.sharding import Mesh

    from mavmap_tpu import parallel

    return parallel, Mesh


# -------------------------------------------------------------- problems


def _ba_problem(rng, I=6, P=200, noise=0.3):
    """tests/test_parallel.py's problem, rendered with the port's camera."""
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = rng.normal(size=(P, 3)) * np.array([4, 4, 2]) + np.array([0, 0, 12])
    poses = np.stack([np.concatenate([rng.normal(size=3) * 0.05,
                                      [i * 0.8, 0, 0] + rng.normal(size=3) * 0.05])
                      for i in range(I)]).astype(np.float32)
    obs_img, obs_pt, obs_uv = [], [], []
    for i in range(I):
        R = rotmat_from_rvec(torch.as_tensor(poses[i, :3])).numpy()
        Xc = torch.as_tensor(X @ R.T + poses[i, 3:], dtype=torch.float32)
        uv = cam.world2image(Xc, cam.PINHOLE, torch.as_tensor(K[0])).numpy()
        obs_img += [i] * P
        obs_pt += list(range(P))
        obs_uv += list(uv)
    obs_uv = np.asarray(obs_uv) + rng.normal(size=(len(obs_img), 2)) * noise
    states = [BA_POSE_FIXED, BA_POSE_FIXED_X] + [0] * (I - 2)
    poses0 = poses.copy()
    poses0[2:] += rng.normal(size=poses0[2:].shape) * 0.01
    X0 = X + rng.normal(size=X.shape) * 0.05
    return dict(poses=poses0, points=X0.astype(np.float32), cam_params=K,
                cam_models=np.array([1], np.int32), obs_image=np.array(obs_img),
                obs_point=np.array(obs_pt), obs_cam=np.zeros(len(obs_img), np.int64),
                obs_uv=obs_uv.astype(np.float32), pose_states=states)


def _args(p):
    return (p["poses"], p["points"], p["cam_params"], p["cam_models"], p["obs_image"],
            p["obs_point"], p["obs_cam"], p["obs_uv"])


def _task_dist_ba(mesh, p, options, extra=None, repeat=False):
    """One rank: its shard, the distributed solve; (poses, points in the
    input order, info[, a second solve's poses and points])."""
    prob, new_index, per = partition_problem(*_args(p), mesh.size, pose_states=p["pose_states"],
                                             shard=mesh.rank, **(extra or {}))
    poses, points, info = dist_bundle_adjust(mesh, prob, options, per)
    out = (poses, points[new_index], info)
    if repeat:
        again = dist_bundle_adjust(mesh, prob, options, per)
        out += (again[0], again[1][new_index])
    return out


def _single_ba(p, options, extra=None):
    prob = build_problem(*_args(p), pose_states=p["pose_states"], **(extra or {}))
    return bundle_adjust(prob, options, device=CPU)


def _same_on_every_rank(res):
    for r in res[1:]:
        for a, b in zip(res[0][:2], r[:2]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- partition_problem


@pytest.mark.parametrize("shards,bucket", [(2, False), (4, False), (2, True), (4, True)])
def test_partition_problem_matches_jax(rng, jax_parallel, shards, bucket):
    """The same shards, array for array, as the JAX package's
    partition_problem (its stacked shard axis against the port's list)."""
    jpar, _ = jax_parallel
    p = _ba_problem(rng)
    fixed = np.zeros(len(p["points"]), bool)
    fixed[::7] = True
    kw = dict(pose_states=p["pose_states"], point_fixed=fixed, bucket=bucket,
              rot_prior=p["poses"][:, :3] + 0.01, rot_prior_weight=np.full(6, 3.0, np.float32))
    stacked, jidx, jper = jpar.partition_problem(*_args(p), num_shards=shards, **kw)
    mine, idx, per = partition_problem(*_args(p), shards, **kw)
    assert per == jper and len(mine) == shards
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    own = {"pt_offsets", "plan_img", "plan_blk", "plan_hess", "plan_ptimg", "plan_ptblk",
           "plan_pt"}
    for s, prob in enumerate(mine):
        for f in prob._fields:
            if f not in own:
                np.testing.assert_array_equal(getattr(prob, f),
                                              np.asarray(getattr(stacked, f))[s], f"{s} {f}")
    one, _, _ = partition_problem(*_args(p), shards, shard=shards - 1, **kw)
    np.testing.assert_array_equal(one.obs_uv, mine[-1].obs_uv)


# ------------------------------------------------------ dist_bundle_adjust


@pytest.fixture(scope="module")
def ba_case():
    return _ba_problem(np.random.default_rng(1234))


@pytest.mark.parametrize("n,solver", [(2, "dense"), (2, "cg"), (4, "dense"), (4, "cg")])
def test_dist_bundle_adjust_matches_jax(request, ba_case, cpu_devices, jax_parallel, n, solver):
    """The point-sharded solve on n ranks against the JAX package's on n
    virtual devices and the port's one-device solve, at
    tests/test_parallel.py's bounds (poses 1e-4, points 1e-3); every rank
    returns the same bits, and a second solve repeats them."""
    jpar, JMesh = jax_parallel
    ranks = request.getfixturevalue(f"ranks{n}")
    p = ba_case
    cg_tol = 1e-6
    res = ranks.run(_task_dist_ba, p, BAOptions(max_num_iterations=15, solver=solver,
                                                cg_tol=cg_tol), None, True)
    _same_on_every_rank(res)
    poses, points, info = res[0][:3]
    np.testing.assert_array_equal(poses, res[0][3])
    np.testing.assert_array_equal(points, res[0][4])
    assert info["solver"] == solver and info["distributed"] == n
    assert info["final_cost"] < info["initial_cost"] and info["collectives"] > 0

    stacked, jidx, jper = jpar.partition_problem(*_args(p), num_shards=n,
                                                  pose_states=p["pose_states"])
    jp, jx, jcost, _, _ = jpar.dist_bundle_adjust(
        JMesh(np.array(cpu_devices[:n]), ("obs",)), stacked, max_iters=15, solver=solver,
        cg_tol=cg_tol)
    assert np.abs(poses - np.asarray(jp)).max() < 1e-4
    assert np.abs(points - np.asarray(jx)[jidx]).max() < 1e-3
    assert abs(info["final_cost"] - float(jcost)) <= 1e-4 * float(jcost)

    p1, x1, _ = _single_ba(p, BAOptions(max_num_iterations=15, solver="dense"))
    assert np.abs(poses - p1).max() < 1e-4
    assert np.abs(points - x1).max() < 1e-3


def test_dist_bundle_adjust_respects_gauge(ranks4):
    """Pose 0 stays exactly where it was and pose 1 keeps its x exactly."""
    p = _ba_problem(np.random.default_rng(7), I=4, P=96)
    for solver in ("dense", "cg"):
        res = ranks4.run(_task_dist_ba, p, BAOptions(max_num_iterations=10, solver=solver))
        _same_on_every_rank(res)
        poses = res[0][0]
        assert np.abs(poses[0] - p["poses"][0]).max() == 0.0
        assert poses[1, 3] == p["poses"][1, 3]
        assert np.abs(poses[2:] - p["poses"][2:]).max() > 0.0


def test_dist_bundle_adjust_rotation_priors(ranks4):
    """IMU rotation priors are every rank's data, added once after the
    ranks' sum: the sharded CG solve matches the one-device dense one."""
    p = _ba_problem(np.random.default_rng(11), I=5, P=120)
    extra = dict(rot_prior=p["poses"][:, :3] + 0.01, rot_prior_weight=np.full(5, 10.0,
                                                                                np.float32))
    res = ranks4.run(_task_dist_ba, p, BAOptions(max_num_iterations=12, solver="cg",
                                                 cg_tol=1e-6), extra)
    _same_on_every_rank(res)
    p1, _, _ = _single_ba(p, BAOptions(max_num_iterations=12, solver="dense"), extra)
    assert np.abs(res[0][0] - p1).max() < 1e-4


def test_dist_cg_honours_loose_tolerance(ranks2, ba_case):
    """cg_tol = 0.05: the distributed CG takes the single-device loop's
    forcing term (bounds [0.05, 0.05]), not the JAX version's clip to
    [0.05, 0.03] (mavmap_tpu/parallel/dist_ba.py:170-174): the same CG
    iterations per LM iteration as the port's one-device CG, and fewer in
    total than at the tighter 0.03."""
    opts = BAOptions(max_num_iterations=8, solver="cg", cg_tol=0.05)
    res = ranks2.run(_task_dist_ba, ba_case, opts)
    _, _, single = _single_ba(ba_case, opts)
    assert res[0][2]["cg_iters"] == single["cg_iters"]
    tight = ranks2.run(_task_dist_ba, ba_case, BAOptions(max_num_iterations=8, solver="cg",
                                                         cg_tol=0.03))
    assert sum(res[0][2]["cg_iters"]) < sum(tight[0][2]["cg_iters"])


# ------------------------------------------------------ sharded matching


def _descriptor_pairs(B=8, F=64, D=32, seed=3):
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(B, F, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(F) for _ in range(B)])
    d2 = np.take_along_axis(d1, perm[:, :, None], axis=1)
    d2 = d2 + rng.normal(size=d2.shape).astype(np.float32) * 0.01
    m1 = rng.random((B, F)) < 0.9
    m2 = rng.random((B, F)) < 0.9
    return d1, d2, m1, m2


def _task_match(mesh, d1, d2, m1, m2):
    t = [torch.as_tensor(a) for a in (d1, d2, m1, m2)]
    matches, valid = dist_match_pairs(mesh, *t, ratio=0.9)
    counts = dist_match_counts(mesh, t[0][0], t[2][0], t[1], t[3], 0.9)
    return matches.numpy(), valid.numpy(), counts.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_dist_match_pairs_and_counts_match_jax(request, cpu_devices, jax_parallel, n):
    """The pairs split over n ranks give the JAX package's matches and the
    loop pre-gate's counts exactly, on every rank; so does a batch that
    does not split evenly, against the port's unsharded launch."""
    import jax.numpy as jnp

    from mavmap_tpu.parallel.dist_register import dist_match_counts as j_counts

    jpar, JMesh = jax_parallel
    ranks = request.getfixturevalue(f"ranks{n}")
    d1, d2, m1, m2 = _descriptor_pairs()
    res = ranks.run(_task_match, d1, d2, m1, m2)
    for r in res[1:]:
        for a, b in zip(res[0], r):
            np.testing.assert_array_equal(a, b)
    jmesh = JMesh(np.array(cpu_devices[:n]), ("obs",))
    jm, jv = jpar.dist_match_pairs(jmesh, *(jnp.asarray(a) for a in (d1, d2, m1, m2)))
    jc = j_counts(jmesh, jnp.asarray(d1[0]), jnp.asarray(m1[0]), jnp.asarray(d2),
                  jnp.asarray(m2), jnp.float32(0.9))
    matches, valid, counts = res[0]
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_array_equal(np.where(valid, matches, -1),
                                  np.where(np.asarray(jv), np.asarray(jm), -1))
    np.testing.assert_array_equal(counts, np.asarray(jc))

    odd = [a[:5] for a in (d1, d2, m1, m2)]
    res = ranks.run(_task_match, *odd)
    t = [torch.as_tensor(a) for a in odd]
    um, uv = match_features_batched(*t, ratio=0.9)
    np.testing.assert_array_equal(res[-1][0], um.numpy())
    np.testing.assert_array_equal(res[-1][1], uv.numpy())


# ------------------------------------------------- sharded registration

F_REG, TRIALS = 256, 64


def _image(scene, feats, i):
    kp, de = feats[i]
    n = len(kp)
    k = np.zeros((F_REG, 2), np.float32)
    d = np.zeros((F_REG, de.shape[1]), np.float32)
    m = np.zeros(F_REG, bool)
    k[:n], d[:n], m[:n] = kp, de, True
    return [k, d, m, cam.image2normalized_np(k, 1, scene.cam_params[0]).astype(np.float32)]


def _state(scene, gt, i, rng):
    ids = np.full(F_REG, -1)
    ids[: len(gt[i])] = gt[i]
    has_tri = (ids >= 0) & (rng.random(F_REG) < 0.8)
    stable = has_tri & (rng.random(F_REG) < 0.9)
    xyz = np.zeros((F_REG, 3), np.float32)
    xyz[has_tri] = scene.points3D[ids[has_tri]] + rng.normal(size=(has_tri.sum(), 3)) * 0.01
    return [xyz, has_tri, stable, scene.rvecs[i].astype(np.float32),
            scene.tvecs[i].astype(np.float32)]


@pytest.fixture(scope="module")
def register_inputs():
    """Five slots of each batched registration step (two images shared by
    two slots), and injected samples for each."""
    scene = make_uav_scene(num_images=4, num_points=700, relief=10.0, seed=1)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=20, seed=1,
                                max_features=F_REG)
    rng = np.random.default_rng(5)
    pairs = [(2, 1), (1, 0), (3, 2), (2, 0), (3, 1)]
    stack = lambda items: [np.stack(x) for x in zip(*items)]  # noqa: E731
    prevs = stack([_image(scene, feats, p) for _, p in pairs])
    states = stack([_state(scene, gt, p, rng) for _, p in pairs])
    K = np.repeat(scene.cam_params[:1].astype(np.float32), len(pairs), axis=0)
    K[1, 4:8] = [2e-3, -1e-3, 5e-4, -5e-4]
    nts = [4.0 / 700, 3.0 / 700, 5.0 / 700, 4.0 / 700, 2.0 / 700]
    pair_args = (prevs + stack([_image(scene, feats, c) for c, _ in pairs]) + states
                 + [K, [1, 2, 1, 1, 1], 0.9, 1e9, nts])
    batch_args = (prevs + _image(scene, feats, 3) + states
                  + [scene.cam_params[0].astype(np.float32), 1, 0.9, 1e9, nts[0]])
    samples = [rng.integers(0, 200, size=(len(pairs), t, 4)) for t in (128, TRIALS)]
    return {"pairs": pair_args, "batch": batch_args}, samples


def _tensors(args):
    return [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]


def _register(step, args, gen, samples, mesh=None):
    fn = {("pairs", False): register_view_pairs, ("batch", False): register_view_batch,
          ("pairs", True): dist_register_view_pairs,
          ("batch", True): dist_register_view_batch}[step, mesh is not None]
    pre = (mesh,) if mesh is not None else ()
    s = None if samples is None else [torch.as_tensor(x) for x in samples]
    rows, scalars = fn(*pre, gen, *_tensors(args), p3p_trials=TRIALS, samples=s)
    return rows.numpy(), scalars.numpy(), torch.rand(8, generator=gen).numpy()


def _task_register(mesh, step, args, samples):
    return _register(step, args, torch.Generator().manual_seed(7), samples, mesh)


@pytest.mark.parametrize("n,step", [(2, "pairs"), (2, "batch"), (4, "pairs"), (4, "batch")])
def test_sharded_registration_equals_unsharded(request, register_inputs, n, step):
    """Five slots split over n ranks (3 + 2; 2 + 2 + 1 + 0): every slot's
    rows and scalars equal the unsharded step's bit for bit, with injected
    samples and with draws from a seeded generator, which then stands where
    the unsharded step leaves it (its next draws are equal)."""
    ranks = request.getfixturevalue(f"ranks{n}")
    inputs, samples = register_inputs
    for injected in (samples, None):
        ref = _register(step, inputs[step], torch.Generator().manual_seed(7), injected)
        for got in ranks.run(_task_register, step, inputs[step], injected):
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        assert np.isfinite(ref[1]).all()


def test_process_shard_bounds_matches_jax():
    """Rank r of n owns the JAX helper's range for a process holding the
    r-th device of the mesh; one process owns everything."""
    from mavmap_tpu.parallel.multihost import process_shard_bounds as j_bounds

    for n in (2, 3, 4):
        for r in range(n):
            devs = np.array([SimpleNamespace(process_index=0 if k == r else 1)
                             for k in range(n)], dtype=object)
            mine = process_shard_bounds(8 * n, SimpleNamespace(rank=r, size=n))
            assert mine == j_bounds(8 * n, SimpleNamespace(devices=devs))
    one = global_mesh(device=CPU)
    assert (one.rank, one.size, one.group) == (0, 1, None)
    assert process_shard_bounds(24, one) == (0, 24)
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(host_local_to_global(one, a).numpy(), a)
    assert one.psum(torch.ones(2)) is not None and one.all_gather(torch.ones(1))[0].shape == (1,)


# ------------------------------------------------------- pipeline and CLI

N_PIPE, CAP, PIPE_TRIALS = 16, 512, 128
PIPE_SCENE = dict(num_images=N_PIPE, num_points=150 * N_PIPE, relief=10.0, rows=2, extent=None,
                  seed=13)
PIPE_OPTS = dict(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
                 loop_detection_period=4, loop_detection_nh_dist=3, loop_detection_num_images=6,
                 final_closure_sweeps=1, final_closure_step=2, chain_len=4,
                 ba_local_max_iters=8, essential_ransac_trials=PIPE_TRIALS,
                 p3p_ransac_trials=PIPE_TRIALS)


def _pipeline_run(mesh_devices, ckpt_dir=None):
    """tests/test_torch_pipeline.py's survey through run_pipeline (with a
    checkpoint every 4 frames into `ckpt_dir` where one is given); returns
    (registered image indices, closures, poses by image index, counters)."""
    scene = make_uav_scene(**PIPE_SCENE)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=13)
    feats = [(k[:CAP], d[:CAP]) for k, d in feats]
    desc = np.concatenate([d for _, d in feats[::4]])
    tree = train_voc_tree(desc[np.random.default_rng(0).permutation(len(desc))[:4000]],
                          branching=8, depth=2, iters=3, device=CPU)
    res = tpipe.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                             ArrayFeatureProvider(feats, capacity=CAP),
                             tpipe.PipelineOptions(mesh_devices=mesh_devices,
                                                   **{**PIPE_OPTS, **_ckpt_opts(ckpt_dir)}),
                             voc_tree=tree, device=CPU)
    m = res.main_mapper
    reg = sorted(m.image_idx_to_id)
    poses = np.stack([np.concatenate(m.get_pose(i)) for i in reg])
    rep = m.report()
    return reg, (rep.get("loop_closures", 0), rep.get("sweep_closures", 0)), poses, rep


def _ckpt_opts(ckpt_dir):
    """Checkpoints every 4 frames, with loop detection every 8 so that a
    checkpoint finds the last chain's window solve deferred (a detection
    lands it)."""
    if ckpt_dir is None:
        return {}
    return dict(checkpoint_period=4, checkpoint_path=os.path.join(ckpt_dir, "map.npz"),
                loop_detection_period=8)


def _task_pipeline(mesh, ckpt_dir):
    return _pipeline_run(mesh.size, ckpt_dir)


@pytest.mark.parametrize("checkpoints", [False, True])
def test_run_pipeline_mesh2_matches_mesh1(ranks2, tmp_path, checkpoints):
    """mesh_devices=2 (the global BA sharded by point, the fan-outs split)
    against one process: the same registered frames and closures, poses
    within 1e-4; both ranks return the same map. With checkpoints (each
    lands the deferred window solve) every rank keeps the schedule, or the
    ranks' anchors part, and rank 0 alone writes."""
    dirs = [None, None]
    if checkpoints:
        dirs = [str(tmp_path / "mesh2"), str(tmp_path / "mesh1")]
        for d in dirs:
            os.makedirs(d)
    res = ranks2.run(_task_pipeline, dirs[0])
    for a, b in zip(res[0][:3], res[1][:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    reg1, closures1, poses1, _ = _pipeline_run(1, dirs[1])
    if checkpoints:
        assert os.listdir(dirs[0]) == os.listdir(dirs[1]) == ["map.npz"]
    reg2, closures2, poses2, rep2 = res[0]
    assert reg2 == reg1 == list(range(N_PIPE))
    assert closures2 == closures1 and min(closures1) >= 1
    assert np.abs(poses2 - poses1).max() < 1e-4
    assert rep2["global_ba_runs"] == 2 and rep2["ba_collective_s"] >= 0.0


def test_run_pipeline_mesh_needs_its_group():
    """mesh_devices=2 in a process without a group of 2 ranks raises, and
    says how to launch; mesh_devices=0 on the CPU is one process."""
    with pytest.raises(RuntimeError, match="parallel.launch"):
        tpipe.run_pipeline(np.zeros(4, np.int32), np.ones(1, np.int32),
                           np.zeros((1, 9), np.float32), None,
                           tpipe.PipelineOptions(mesh_devices=2), device=CPU)
    assert tpipe._pipeline_mesh(tpipe.PipelineOptions(mesh_devices=0), CPU) is None


CLI_N = 6
CLI_FLAGS = ["--max-features", "1024", "--min-track-len", "2", "--tri-min-angle", "1.0",
             "--init-tri-min-angle", "4.0", "--quiet", "--device", "cpu"]


def test_cli_mesh2_writes_the_images_of_mesh1(tmp_path):
    """--mesh 2 maps on two spawned ranks and rank 0 writes the outputs:
    the registered images of --mesh 1, their poses within 1e-4."""
    scene = make_uav_scene(num_images=CLI_N, num_points=1500, relief=10.0, rows=1, seed=6)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=10, seed=6)
    data = tmp_path / "data"
    data.mkdir()
    lines = ["# imagedata"] + [
        f"img{i}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0"
        + (", 1, PINHOLE, 700.0, 700.0, 400.0, 300.0" if i == 0 else "") for i in range(CLI_N)]
    (data / "imagedata.txt").write_text("\n".join(lines) + "\n")
    args = tcli.build_parser().parse_args(["--input-path", "x", "--output-path", "y"]
                                          + CLI_FLAGS)
    fc = FeatureCache(str(tmp_path / "cache"), tcli.detector_params(args),
                      detector=lambda i: feats[i], capacity=1024)
    for i in range(CLI_N):
        fc.query(i, f"img{i}")
    base = ["--input-path", str(data), "--cache-path", str(tmp_path / "cache")] + CLI_FLAGS
    rows = {}
    for mesh in ("1", "2"):
        out = tmp_path / f"out{mesh}"
        assert tcli.main(base + ["--output-path", str(out), "--mesh", mesh]) == 0
        rows[mesh] = [[v.strip() for v in line.split(",")]
                      for line in (out / "imagedataout.txt").read_text().splitlines()
                      if not line.startswith("#")]
        assert (out / "points3D.txt").exists()
    assert [r[0] for r in rows["2"]] == [r[0] for r in rows["1"]] == \
        [f"img{i}" for i in range(CLI_N)]
    poses = {k: np.array([[float(x) for x in r[1:7]] for r in v]) for k, v in rows.items()}
    assert np.abs(poses["2"] - poses["1"]).max() < 1e-4


# --------------------------------------------------- failures surface


def _task_digest(mesh, drift):
    """Each rank maps the same two-view start; with `drift`, rank 1 moves a
    3-D point by 1e-3. Returns whether the digest check passed."""
    scene = make_uav_scene(num_images=3, num_points=600, relief=10.0, seed=1)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=1, max_features=F_REG)
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=F_REG), device=CPU, mesh=mesh)
    assert m.process_initial(0, 1, SequentialMapperOptions(
        tri_min_angle=1.0, min_track_len=2, essential_ransac_trials=TRIALS))
    if drift and mesh.rank == 1:
        pid = int(np.flatnonzero(m.store.point3D_valid)[0])
        m.store.point3D_xyz[pid] += 1e-3
    m._check_replicated("the test's map")
    return True


def test_digest_check_raises_on_ranks_holding_different_maps(ranks2):
    assert ranks2.run(_task_digest, False) == [True, True]
    for ok, err in ranks2.run(_task_digest, True, expect_error=True):
        assert not ok and "ranks drifted apart after the test's map" in err


def _task_die(mesh):
    if mesh.rank == 1:
        os._exit(3)
    mesh.all_gather(torch.ones(4))  # waits for the dead rank
    return True


def test_dead_rank_fails_the_launch_promptly():
    """A rank that dies fails parallel.launch, which kills the others, in
    seconds, well inside the group's 120 s timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="launch: rank"):
        launch(_task_die, 2, "cpu", threads=1, timeout=JOIN_S)
    assert time.monotonic() - t0 < 60


# ------------------------------------------------------ singular systems


@pytest.mark.parametrize("solver,selfcal", [("dense", False), ("cg", False), ("dense", True),
                                            ("cg", True)])
def test_singular_schur_system_rejects_the_step(ba_case, solver, selfcal):
    """A free pose with no observation and lambda 0: the reduced system
    (or its preconditioner block) is exactly singular. The step is NaN, not
    an exception (torch.linalg raises there, XLA returns NaN); the LM
    rejects it, lambda grows to its floor, and the next steps converge (to
    the JAX package's solution: checked for the pose-only solvers, whose
    JAX loops compile in a few seconds)."""
    import jax
    import jax.numpy as jnp

    from mavmap_tpu.ba import build_problem as j_build
    from mavmap_tpu.ba.core import _lm_loop as j_lm_loop

    p = dict(ba_case)
    poses = np.concatenate([p["poses"], p["poses"][-1:] + 0.1])  # image 6: no observation
    args = (poses,) + _args(p)[1:]
    states = p["pose_states"] + [0]
    prob = build_problem(*args, pose_states=states)
    tp = problem_to_device(with_plans(prob, solver_plans(selfcal, solver)), CPU)
    lam0 = torch.tensor(0.0)
    pts = tp.points[tp.point_rows.long()]
    if not selfcal:
        step = (_lm_step(tp, tp.poses, pts, lam0, 1.0) if solver == "dense" else
                _lm_step_cg(tp, tp.poses, pts, lam0, 1.0, 100, 1e-6))
        assert torch.isnan(step[0]).any()
    lm = (1.0, 0.0, 10.0, 0.5, 1e-4)

    def port(iters):
        if selfcal:
            out = _lm_loop_selfcal(tp, _selfcal_cam_free(tp), *lm, iters, solver=solver,
                                   cg_tol=1e-6)
        else:
            out = _lm_loop(tp, *lm, iters, solver=solver, cg_tol=1e-6)
        return out[0].numpy(), float(out[-3]), float(out[-2]), out[-1]

    first, cost1, init1, _ = port(1)
    np.testing.assert_array_equal(first, poses)  # the NaN step is rejected
    assert cost1 == init1
    final, cost, init, it = port(15)
    assert cost < 0.1 * init and it >= 2
    if not selfcal:
        jp = jax.tree.map(jnp.asarray, j_build(*args, pose_states=states, host=True))
        out = j_lm_loop(jp, *lm, max_iters=15, solver=solver, cg_tol=1e-6, backend="xla")
        assert np.abs(final - np.asarray(out[0])).max() < 1e-4
