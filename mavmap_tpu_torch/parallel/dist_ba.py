"""Bundle adjustment sharded by 3-D point over ranks.

Port of mavmap_tpu/parallel/dist_ba.py (the reference hands this solve to
Ceres SPARSE_SCHUR's threads, bundle_adjustment.cc:554-569). The 3-D
points and their observations are split over the ranks, the poses are
held by every rank, and the reduced camera system is summed over the
ranks in rank order (Mesh.psum). Every observation of a point, and so
every Schur co-observation term of it, lives on one shard: the point-block
solves and the back-substitution stay shard-local, and per LM iteration
the ranks exchange only

    the (I, 42) per-image blocks and gradient, the reduced gradient,
    the cost, and the (I, I, 6, 6) Schur off-diagonal (dense solver) or
    the (I, 6, 6) preconditioner blocks and one (I, 6) matvec sum per CG
    iteration (matrix-free CG).

The LM loop is ba/core.py's own, run with the psum hook: the summed cost
makes every rank take the same steps and decisions, so the ranks stay in
step without a controller. Each shard's problem carries its own K2 plans,
so kernels K2 and K3 run at about 1/N of the problem's rows per rank.
"""

import numpy as np
import torch

from ..ba.core import (_lm_loop, _resolve_solver, build_problem, problem_to_device,
                       solver_plans, with_plans)


def partition_problem(poses, points, cam_params, cam_models, obs_image, obs_point, obs_cam,
                      obs_uv, num_shards, pose_states=None, point_fixed=None, rot_prior=None,
                      rot_prior_weight=None, bucket=False, shard=None):
    """Host: split a BA problem into `num_shards` point-disjoint shards.

    Points are balanced over the shards by observation count (a snake
    assignment over the count-sorted order: 0..S-1, S-1..0, ...) and
    permuted so that shard s owns the rows [s * per_shard, (s + 1) *
    per_shard) of the permuted points, padded with fixed dummy points. Each
    shard is a build_problem of its observations (padded to one common
    capacity, rounded up to 4096 with `bucket`) over the whole permuted
    points array, whose obs_point are rows of that array; the poses and the
    cameras are every shard's.

    Returns (shards, new_index, per_shard): the list of the shards' host
    problems (only shard `shard`'s problem, not in a list, where `shard`
    is given), new_index (P,) the permuted row of every input point, and
    the block size."""
    obs_point = np.asarray(obs_point, np.int64)
    obs_image = np.asarray(obs_image, np.int32)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    P_n = len(points)

    pid_counts = np.bincount(obs_point, minlength=P_n)
    order = np.argsort(-pid_counts, kind="stable")
    cyc = np.arange(P_n) % (2 * num_shards)
    shard_of_rank = np.where(cyc < num_shards, cyc, 2 * num_shards - 1 - cyc)
    point_shard = np.empty(P_n, np.int32)
    point_shard[order] = shard_of_rank.astype(np.int32)

    counts = np.bincount(point_shard, minlength=num_shards)
    per_shard = int(counts.max()) if P_n else 1
    grouped = np.argsort(point_shard, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_shard = np.arange(P_n) - offsets[point_shard[grouped]]
    rows = point_shard[grouped].astype(np.int64) * per_shard + pos_in_shard
    new_index = np.full(P_n, -1, np.int64)
    new_index[grouped] = rows
    new_points = np.zeros((num_shards * per_shard, 3), np.float32)
    new_points[new_index] = points
    new_point_fixed = np.ones(num_shards * per_shard, bool)  # padding fixed
    new_point_fixed[new_index] = point_fixed if point_fixed is not None else False

    obs_shard = point_shard[obs_point]
    max_obs = int(np.max(np.bincount(obs_shard, minlength=num_shards)))
    if bucket:
        max_obs = max(((max_obs + 4095) // 4096) * 4096, 4096)

    def build_shard(s):
        sel = np.where(obs_shard == s)[0]
        return build_problem(
            poses, new_points, cam_params, cam_models, obs_image[sel],
            new_index[obs_point[sel]], obs_cam[sel], obs_uv[sel], pose_states=pose_states,
            point_fixed=new_point_fixed, rot_prior=rot_prior, rot_prior_weight=rot_prior_weight,
            obs_capacity=max_obs, bucket=bucket)

    if shard is not None:
        return build_shard(shard), new_index, per_shard
    return [build_shard(s) for s in range(num_shards)], new_index, per_shard


def dist_bundle_adjust(mesh, prob, options, per_shard):
    """The LM solve of one rank's shard `prob` (partition_problem's shard
    mesh.rank, a host problem) over `mesh`: ba/core.py's loop with the
    cost and the camera system summed over the ranks. options: a BAOptions
    with the intrinsics held fixed (the solve refines poses and points);
    its solver "auto" is dense below DENSE_SOLVER_MAX_CAMERAS cameras and
    CG from there up, and CG keeps the single-device loop's forcing term
    (ba/core.py _cg_tolerance; the JAX version's clip crosses its bounds
    for cg_tol > 3e-2).

    Returns (poses, points, info) as numpy on every rank, the same bits on
    each: poses (I, 6), points the whole permuted array (each rank's block
    of per_shard rows from that rank), info with the costs, iterations,
    solver, CG iterations and the collectives' host seconds and count."""
    if options.refine_camera_params:
        raise ValueError("dist_bundle_adjust holds the intrinsics fixed: refine them first "
                         "(the mapper's stage 1 on one device)")
    solver = _resolve_solver(prob, options)
    dprob = problem_to_device(with_plans(prob, solver_plans(False, solver)), mesh.device)
    stats = {}
    before = dict(mesh.stats)
    poses, points, cost, init_cost, iters = _lm_loop(
        dprob, float(options.loss_scale_factor), options.lambda_init, options.lambda_up,
        options.lambda_down, options.function_tolerance, options.max_num_iterations,
        solver=solver, cg_max_iters=options.cg_max_iters, cg_tol=options.cg_tol, stats=stats,
        psum=mesh.psum)
    # Each rank's block of the permuted points from that rank: the JAX
    # version's psum of owned rows over zeros, without the zeros.
    lo = mesh.rank * per_shard
    whole = mesh.size * per_shard
    points = points.clone()
    points[:whole] = torch.cat(mesh.all_gather(points[lo:lo + per_shard].contiguous()))
    info = {
        "initial_cost": float(init_cost),
        "final_cost": float(cost),
        "iterations": iters,
        "solver": solver,
        "cg_iters": stats.get("cg_iters", []),
        "distributed": mesh.size,
        "collective_s": mesh.stats["collective_s"] - before["collective_s"],
        "collectives": mesh.stats["collectives"] - before["collectives"],
    }
    return poses.cpu().numpy(), points.cpu().numpy(), info
