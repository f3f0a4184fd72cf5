#!/usr/bin/env python3
"""The point-sharded bundle adjustment on 2 ranks against one process, on
CUDA devices (run from the repo root):

    python3 benchmarks/torch_dist_ba.py

A synthetic problem of the survey's size (200 cameras in 4 rows, 48000
points each seen by 3 consecutive cameras of a row: 144000 observations,
0.5 px noise, perturbed start) is solved pose-only by matrix-free CG: once
in this process, then twice on 2 ranks started with parallel.launch, which
picks NCCL where it sees a CUDA device per rank and gloo on host copies
where the ranks share one (run it with CUDA_VISIBLE_DEVICES=0 for that).
Prints one JSON line per solve: ms per LM iteration, LM and CG iterations,
final cost, the collectives' count and host ms per LM iteration, the
largest pose difference to the one-process solve, and whether the two
2-rank solves gave the same bits; then the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

I, ROWS, P, TRACK = 200, 4, 48000, 3
OPTS = dict(max_num_iterations=20, solver="cg")


def problem(seed=0):
    """build_problem's positional arguments and the pose states."""
    rng = np.random.default_rng(seed)
    per_row = I // ROWS
    cam_x = np.tile(np.arange(per_row) * 2.0, ROWS)
    cam_y = np.repeat(np.arange(ROWS) * 20.0, per_row)
    poses = np.zeros((I, 6), np.float32)
    poses[:, :3] = rng.normal(size=(I, 3)) * 0.02
    poses[:, 3] = -cam_x
    poses[:, 4] = -cam_y
    first = rng.integers(0, per_row - TRACK + 1, P)
    row = rng.integers(0, ROWS, P)
    X = np.stack([first * 2.0 + 2.0 + rng.normal(size=P), row * 20.0 + rng.normal(size=P) * 6,
                  30.0 + rng.normal(size=P) * 3], 1).astype(np.float32)
    K = np.array([[700.0, 700.0, 400.0, 300.0, 0, 0, 0, 0, 0]], np.float32)
    from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec

    R = rotmat_from_rvec(torch.as_tensor(poses[:, :3])).numpy()
    cams = (row[:, None] * per_row + first[:, None] + np.arange(TRACK)[None, :]).ravel()
    pts = np.repeat(np.arange(P), TRACK)
    Xc = np.einsum("oij,oj->oi", R[cams], X[pts]) + poses[cams, 3:]
    uv = Xc[:, :2] / Xc[:, 2:] * 700.0 + [400.0, 300.0] + rng.normal(size=(len(pts), 2)) * 0.5
    poses0 = poses + np.concatenate([rng.normal(size=(I, 3)) * 1e-3,
                                     rng.normal(size=(I, 3)) * 1e-2], 1).astype(np.float32)
    poses0[:2] = poses[:2]
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    args = (poses0, X0, K, np.array([1], np.int32), cams, pts, np.zeros(len(pts), np.int32),
            uv.astype(np.float32))
    return args, [1, 2] + [0] * (I - 2)


def rank_solves(mesh, args, states):
    from mavmap_tpu_torch.ba import BAOptions
    from mavmap_tpu_torch.parallel import dist_bundle_adjust, partition_problem

    prob, new_index, per = partition_problem(*args, mesh.size, pose_states=states, bucket=True,
                                             shard=mesh.rank)
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, _, info = dist_bundle_adjust(mesh, prob, BAOptions(**OPTS), per)
        out.append(dict(poses=poses, info=info, wall=time.perf_counter() - t0))
    return out


def main():
    from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
    from mavmap_tpu_torch.parallel import launch

    if not torch.cuda.is_available():
        raise SystemExit("torch_dist_ba.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    args, states = problem()
    prob = build_problem(*args, pose_states=states, bucket=True)
    bundle_adjust(prob, BAOptions(max_num_iterations=1, solver="cg"), dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1, _, info1 = bundle_adjust(prob, BAOptions(**OPTS), dev)
    wall1 = time.perf_counter() - t0
    it = max(info1["iterations"], 1)
    print(json.dumps(dict(ranks=1, observations=len(args[4]), ms_per_lm_iter=1000 * wall1 / it,
                          lm_iters=info1["iterations"], cg_iters=info1["cg_iters"],
                          final_cost=info1["final_cost"])), flush=True)
    ranks = launch(rank_solves, 2, "cuda", args=(args, states), timeout=900)
    first = ranks[0][0]["poses"]
    same = all(np.array_equal(s["poses"], first) for r in ranks for s in r)
    for k in range(2):
        info = ranks[0][k]["info"]
        it = max(info["iterations"], 1)
        print(json.dumps(dict(
            ranks=2, solve=k + 1, devices=torch.cuda.device_count(),
            ms_per_lm_iter=[1000 * r[k]["wall"] / it for r in ranks],
            lm_iters=info["iterations"], cg_iters=info["cg_iters"],
            final_cost=info["final_cost"], collectives_per_lm_iter=info["collectives"] / it,
            collective_ms_per_lm_iter=[1000 * r[k]["info"]["collective_s"] / it for r in ranks],
            max_pose_diff=float(np.abs(ranks[0][k]["poses"] - p1).max()),
            same_bits_on_ranks_and_solves=same)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
