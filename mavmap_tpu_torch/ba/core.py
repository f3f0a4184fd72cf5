"""Robust Levenberg-Marquardt bundle adjustment with Schur complement.

Port of mavmap_tpu/ba/core.py (reference src/base3d/bundle_adjustment.{h,cc}):

  - residuals r_o = world2image(R_i X_p + t_i; cam) - uv_o in PIXELS with
    the Cauchy robust loss (`loss_scale_factor`, reference :148-149);
  - per-observation Jacobians in column arithmetic (ba/colmath.py);
  - normal equations in camera-block / point-block Schur form: 3x3 point
    blocks inverted in closed form, then the reduced camera system (6 per
    pose, + 9 per camera with refine_camera_params) solved either densely
    from per-(point, image) aggregates (exact; below
    DENSE_SOLVER_MAX_CAMERAS cameras) or matrix-free by block-Jacobi
    preconditioned CG with an inexact-Newton forcing term (from
    DENSE_SOLVER_MAX_CAMERAS cameras up);
  - gauge fixing by masking parameter rows (BA_POSE_FREE / FIXED /
    FIXED_X, bundle_adjustment.h:33-35), IMU rotation priors, GCP pinning.

The per-image, per-block and per-(point, block) reductions go through CUDA
kernel K2 (ops/cuda/ba_accum.py seg_accum_full, keyed by the plans that
bundle_adjust builds for the solver it runs, `with_plans`) and the
per-point reductions through K3 (seg_accum_sorted, over the CSR offsets
that build_problem makes) when the problem lives on a CUDA device, the CG
matvec's included; on the CPU the wrappers run their plain PyTorch
versions, K2's keyed by the same plans. Every sum of a solve adds in an
order fixed by its plan or its offsets, none by atomics, so a solve gives
the same bits on every run. The LM and CG loops are Python loops with an
early exit (one host sync per iteration). A singular reduced system gives
a NaN step, which the LM rejects, as XLA's solve does in the JAX package.

The point-sharded solve (parallel/dist_ba.py) runs these loops with a
`psum` hook: the rank-ordered sum over the ranks of the camera system's
pieces (the JAX package's jax.lax.psum over the mesh axis). Without the
hook every function computes exactly what the single-device solve does.

The registration step's robust pose refinement (`_pose_refine_loop`)
runs every LM iteration of every slot in one launch of CUDA kernel K4
(ops/cuda/pose_lm.py) on a CUDA device, and as its plain version
`_pose_refine_plain` on the CPU.

`bundle_adjust_async` keeps the JAX package's dispatch/finalize interface
but runs the solve when it is called: the loops sync the host every
iteration, so nothing is left in flight (see its docstring).
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from ..models import camera as cam
from ..ops.essential import inv_or_nan, solve_or_nan
from ..ops.projection import compose_proj_matrix, transform_points
from ..ops.reduce import sum_pairwise
from ..ops.cuda.ba_accum import (
    SegPlan, make_plan, offsets_from_sorted_ids, seg_accum_full, seg_accum_sorted)
from ..ops.cuda.pose_lm import pose_lm
from ..ops.rotation import rotmat_from_rvec
from ..utils.device import resolve_device
from ..utils.timer import span, sync
from . import colmath as cm

BA_POSE_FREE = 0
BA_POSE_FIXED = 1
BA_POSE_FIXED_X = 2

# Camera-count cutoff of the exact dense Schur solve: matrix-free CG from
# here up.
DENSE_SOLVER_MAX_CAMERAS = 64


@dataclass(frozen=True)
class BAOptions:
    max_num_iterations: int = 50
    function_tolerance: float = 1e-4
    loss_scale_factor: float = 1.0  # Cauchy scale, pixels
    # Accepted for the JAX package's callers and read nowhere, as there:
    # rotation priors reach the BA through the problem's rot_prior and
    # rot_prior_weight (build_problem's rot_prior arguments).
    constrain_rotation: bool = False
    constrain_rotation_weight: float = 0.0
    refine_camera_params: bool = False
    update_point3D_errors: bool = False
    min_track_len: int = 2
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    # Segment sums of the assembly and the CG matvec (_check_backend):
    # "auto" and "pallas" run kernels K2/K3 on CUDA tensors and their plain
    # versions on CPU tensors; "xla" and "pallas_interpret" mean the plain
    # versions, which are the CPU's path and raise on the card.
    backend: str = "auto"
    # Reduced-camera-system solver: "dense" (exact), "cg" (matrix-free
    # preconditioned CG) or "auto" (dense below DENSE_SOLVER_MAX_CAMERAS).
    solver: str = "auto"
    # Above this observation count, self-calibration runs as TWO stages
    # (intrinsics refined on an observation subsample, then the full
    # problem with intrinsics fixed; mapper.adjust_bundle implements it).
    selfcal_max_obs: int = 150_000
    # CG: iteration cap and relative residual target (the forcing term of
    # _cg_tolerance loosens the target while LM still makes large steps).
    cg_max_iters: int = 100
    cg_tol: float = 1e-3


class BAProblem(NamedTuple):
    """Static-shape arrays of one BA problem (numpy on the host, tensors on
    a device — see `problem_to_device`).

    Observations are sorted by (point, image). Point bookkeeping runs in a
    DENSE id space: `obs_point_dense` renames the points that carry
    observations to gapless sorted ids 0..Pd-1 (`point_rows` maps dense row
    -> row in `points`), and `pt_offsets` are the CSR offsets of those ids
    over the real (unpadded) observations: rows pt_offsets[s] ..
    pt_offsets[s+1] observe dense point s. Compared with the JAX BAProblem,
    the co-observation pair fields and the by-image sort (img_order,
    obs_image_sorted) are gone, `pt_offsets` replaces the banded kernel's
    `pt_gather_rows`, and six K2 plans take the sort's part: every K2 call
    of the solvers sums by one of them, and by nothing else. They are None
    until `with_plans` builds those that a solver needs.
    """

    poses: object            # (I, 6) rvec+tvec
    points: object           # (P, 3)
    cam_params: object       # (C, 9)
    cam_models: object       # (C,) int32 model codes
    obs_image: object        # (O,) int32
    obs_point: object        # (O,) int32 into points (full id space)
    obs_cam: object          # (O,) int32
    obs_uv: object           # (O, 2) pixel observations
    obs_mask: object         # (O,) bool
    pose_free: object        # (I, 6) f32 1=free 0=fixed (per component)
    point_free: object       # (P,) f32
    rot_prior: object        # (I, 3) prior rvec
    rot_prior_weight: object  # (I,) f32, 0 disables
    obs_point_dense: object  # (O,) int32 sorted gapless dense point ids
    point_rows: object       # (Pd,) int32 dense row -> full point row (pads: P)
    point_free_dense: object  # (Pd,) f32
    pt_offsets: object       # (Pd + 1,) int32 CSR offsets of obs_point_dense
    plan_img: SegPlan = None   # obs_image into the I images
    plan_blk: SegPlan = None   # both entries, cat(obs_image, I + obs_cam), into B = I + C
    plan_hess: SegPlan = None  # the 4 entry pairs blk[:, a] * B + blk[:, b] into B^2
    plan_ptimg: SegPlan = None  # obs_point_dense * I + obs_image into Pd I
    plan_ptblk: SegPlan = None  # both entries, obs_point_dense * B + blk[:, a], into Pd B
    plan_pt: SegPlan = None     # obs_point into the P points (point_mean_errors)


PLANS = ("plan_img", "plan_blk", "plan_hess", "plan_ptimg", "plan_ptblk", "plan_pt")


def solver_plans(selfcal, solver):
    """The K2 plans that a solver sums by: the image plan for the pose-only
    steps, the block plan for the self-calibrating ones; the dense steps add
    their per-(point, block) plan (_ptblk_agg), and the self-calibrating one
    the B^2 plan of its Hessian."""
    if not selfcal:
        return ("plan_img", "plan_ptimg") if solver == "dense" else ("plan_img",)
    return ("plan_blk", "plan_hess", "plan_ptblk") if solver == "dense" else ("plan_blk",)


def plan_ids(prob: BAProblem, name):
    """Host: (ids, S), the id array that the named K2 plan keys and its
    segment count; a call summing by the plan has its rows in this order.
    plan_img keys the image ids into the I images; plan_blk both block
    entries of every observation (the image's pose block, then I + its
    camera's intrinsics block) into the B = I + C blocks; plan_hess the four
    (a, b) entry pairs in the order (0, 0), (0, 1), (1, 0), (1, 1), each
    blk[:, a] * B + blk[:, b], into B^2; plan_ptimg each observation's
    (dense point, image) pair into Pd I; plan_ptblk both entries' (dense
    point, block) pairs, entry 0's rows then entry 1's, into Pd B; plan_pt
    each observation's point into the P points. Padding rows (bucketing's,
    ~obs_mask) get id -1, so every plan leaves them out: their values are
    zero, and on their ids (the last real point and image) they would
    crowd one segment with up to 4095 rows."""
    I, C, Pd = len(prob.poses), len(prob.cam_params), len(prob.point_rows)
    B = I + C
    real = np.asarray(prob.obs_mask, bool)
    obs_image = np.asarray(prob.obs_image, np.int64)
    pt = np.asarray(prob.obs_point_dense, np.int64)
    blk = (obs_image, I + np.asarray(prob.obs_cam, np.int64))

    def ids(*entries):
        return np.concatenate([np.where(real, e, -1) for e in entries])

    if name == "plan_img":
        return ids(obs_image), I
    if name == "plan_blk":
        return ids(*blk), B
    if name == "plan_hess":
        return ids(*(blk[a] * B + blk[b] for a in range(2) for b in range(2))), B * B
    if name == "plan_ptimg":
        return ids(pt * I + obs_image), Pd * I
    if name == "plan_ptblk":
        return ids(*(pt * B + b for b in blk)), Pd * B
    if name == "plan_pt":
        return ids(np.asarray(prob.obs_point, np.int64)), len(prob.points)
    raise ValueError(f"unknown K2 plan {name!r}")


def with_plans(prob: BAProblem, names=PLANS) -> BAProblem:
    """Host: `prob` with the named K2 plans built from its ids (plan_ids;
    those it has are kept)."""
    return prob._replace(**{n: make_plan(*plan_ids(prob, n)) for n in names
                            if getattr(prob, n) is None})


def build_problem(poses, points, cam_params, cam_models, obs_image, obs_point,
                  obs_cam, obs_uv, pose_states=None, point_fixed=None,
                  rot_prior=None, rot_prior_weight=None, obs_capacity=None,
                  bucket=False):
    """Host-side problem construction: numpy in, numpy BAProblem out.

    `bucket=True` rounds images up to multiples of 8, points and dense
    points to 1024 and observations to 4096, like the JAX builder, so both
    packages solve identically shaped problems (the padding rows are
    fixed/masked and contribute nothing).
    """
    obs_image = np.asarray(obs_image, np.int32)
    obs_point = np.asarray(obs_point, np.int32)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    O = len(obs_image)

    # Sort observations by (3-D point, image).
    if O:
        order0 = np.lexsort((obs_image, obs_point))
        obs_image = obs_image[order0]
        obs_point = obs_point[order0]
        obs_cam = obs_cam[order0]
        obs_uv = obs_uv[order0]

    # Dense point ids: rank the points that carry observations (gapless).
    if O:
        new_group = np.empty(O, bool)
        new_group[0] = True
        new_group[1:] = obs_point[1:] != obs_point[:-1]
        group_id = (np.cumsum(new_group) - 1).astype(np.int32)
        rows0 = obs_point[new_group].astype(np.int32)
    else:
        group_id = np.zeros(0, np.int32)
        rows0 = np.zeros(0, np.int32)
    Pd0 = len(rows0)

    def round_up(n, q):
        return max(((n + q - 1) // q) * q, q)

    if obs_capacity is None:
        obs_capacity = round_up(O, 4096) if bucket else O
    if obs_capacity < O:
        raise ValueError(f"obs_capacity {obs_capacity} < {O} observations")

    def pad(arr, n, fill=0):
        out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
        out[: len(arr)] = arr
        return out

    I0 = len(poses)
    P0 = len(points)
    I = round_up(I0, 8) if bucket else I0
    P = round_up(P0, 1024) if bucket else P0
    poses = pad(np.asarray(poses, np.float32), I)
    points = pad(np.asarray(points, np.float32), P)

    pose_free = np.ones((I, 6), np.float32)
    pose_free[I0:] = 0.0  # bucketing padding: fully fixed dummy poses
    if pose_states is not None:
        for i, s in enumerate(pose_states):
            if s == BA_POSE_FIXED:
                pose_free[i] = 0.0
            elif s == BA_POSE_FIXED_X:
                pose_free[i, 3] = 0.0  # x-translation pinned
    point_free = np.ones((P,), np.float32)
    point_free[P0:] = 0.0
    if point_fixed is not None:
        point_free[:P0][np.asarray(point_fixed, bool)] = 0.0

    # Dense padding rows point AT P (out of range): dropped on scatter-back.
    Pd = round_up(Pd0, 1024) if bucket else max(Pd0, 1)
    point_rows = np.full(Pd, P, np.int32)
    point_rows[:Pd0] = rows0
    point_free_dense = np.zeros(Pd, np.float32)
    point_free_dense[:Pd0] = point_free[rows0]

    if rot_prior is None:
        rot_prior = np.zeros((I, 3), np.float32)
    else:
        rot_prior = pad(np.asarray(rot_prior, np.float32), I)
    if rot_prior_weight is None:
        rot_prior_weight = np.zeros((I,), np.float32)
    else:
        rot_prior_weight = pad(np.asarray(rot_prior_weight, np.float32), I)

    obs_image = pad(obs_image, obs_capacity, fill=int(obs_image[-1]) if O else 0)
    return BAProblem(
        poses=poses,
        points=points,
        cam_params=np.asarray(cam_params, np.float32),
        cam_models=np.asarray(cam_models, np.int32),
        # Padding keeps the LAST image/point index so the sort order holds;
        # masked rows contribute zeros wherever they land.
        obs_image=obs_image,
        obs_point=pad(obs_point, obs_capacity, fill=int(obs_point[-1]) if O else 0),
        obs_cam=pad(obs_cam, obs_capacity),
        obs_uv=pad(obs_uv, obs_capacity),
        obs_mask=pad(np.ones(O, bool), obs_capacity, False),
        pose_free=pose_free,
        point_free=point_free,
        rot_prior=rot_prior,
        rot_prior_weight=rot_prior_weight,
        obs_point_dense=pad(group_id, obs_capacity, fill=int(group_id[-1]) if O else 0),
        point_rows=point_rows,
        point_free_dense=point_free_dense,
        pt_offsets=offsets_from_sorted_ids(group_id, Pd),
    )


def problem_to_device(prob: BAProblem, device) -> BAProblem:
    """Host (numpy) problem -> tensors on `device` (plans not built stay None)."""
    # A blocking copy of each array with elements (the plans count theirs).
    sync(sum(np.size(a) > 0 for a in prob if a is not None and not isinstance(a, SegPlan)))
    return BAProblem(*(a if a is None else a.to(device) if isinstance(a, SegPlan)
                       else torch.as_tensor(np.asarray(a), device=device) for a in prob))


# ---------------------------------------------------------------- residuals


def _gather_dense_points(prob: BAProblem, points):
    """(P, 3) full points -> (Pd, 3) dense rows (pads clamp to the last)."""
    return points[torch.clamp(prob.point_rows.long(), max=points.shape[0] - 1)]


def _scatter_dense_points(prob: BAProblem, points, points_d):
    """Write dense rows back into the full array (pad rows dropped)."""
    out = points.clone()
    keep = prob.point_rows < points.shape[0]
    out[prob.point_rows[keep].long()] = points_d[keep]
    sync(2)  # each boolean-mask index reads its count back
    return out


def _rot_residuals(prob: BAProblem, poses):
    """(I, 9) weighted Frobenius rotation-prior residuals
    (BARotationConstraintCostFunction, bundle_adjustment.cc:57-111)."""
    R = rotmat_from_rvec(poses[:, :3])
    R0 = rotmat_from_rvec(prob.rot_prior)
    return (prob.rot_prior_weight[:, None, None] * (R - R0)).reshape(-1, 9)


def _cauchy_weight(res_sq_norm, scale):
    """IRLS weight rho'(s) for the Cauchy loss rho(s) = c^2 log(1 + s/c^2)."""
    return 1.0 / (1.0 + res_sq_norm / (scale * scale))


def _robust_cost(prob: BAProblem, poses, r2, scale, psum=None):
    """0.5 sum rho over the observations (summed over the ranks by `psum`),
    plus the rotation priors, which every rank holds whole: added once."""
    s = r2[0] * r2[0] + r2[1] * r2[1]
    c2 = scale * scale
    rho = c2 * torch.log1p(s / c2)
    cost = 0.5 * torch.sum(torch.where(prob.obs_mask, rho, torch.zeros_like(rho)))
    if psum is not None:
        cost = psum(cost)
    rr = _rot_residuals(prob, poses)
    return cost + 0.5 * torch.sum(rr * rr)


def _total_cost_d(prob: BAProblem, poses, points_d, scale, psum=None):
    """Robust total cost over DENSE points."""
    r2 = cm.residual_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        prob.cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    return _robust_cost(prob, poses, r2, scale, psum)


def _total_cost_selfcal_d(prob: BAProblem, poses, points_d, cam_params, scale):
    r2 = cm.residual_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    return _robust_cost(prob, poses, r2, scale)


def total_cost(prob: BAProblem, poses, points, scale):
    """Robust total cost 0.5 sum rho(||r||^2) over the FULL points array."""
    return _total_cost_d(prob, poses, _gather_dense_points(prob, points), scale)


def total_cost_selfcal(prob: BAProblem, poses, points, cam_params, scale):
    """Robust total cost with explicit intrinsics over the FULL points array."""
    return _total_cost_selfcal_d(prob, poses, _gather_dense_points(prob, points), cam_params,
                                 scale)


# ------------------------------------------------------------ normal eqs


def _rot_prior_blocks(prob: BAProblem, poses):
    """Per-pose (6x6 JᵀJ, 6 Jᵀr) contributions of the IMU rotation priors."""

    def rot_one(pose, prior, wgt, free):
        def f(p):
            return (wgt * (rotmat_from_rvec(p[:3]) - rotmat_from_rvec(prior))).reshape(9)

        rr = f(pose)
        Jr = jacfwd(f)(pose) * free[None, :]
        return Jr.T @ Jr, Jr.T @ rr

    return vmap(rot_one)(poses, prob.rot_prior, prob.rot_prior_weight, prob.pose_free)


def _seg_plan(plan, vals):
    """Reduction of rows keyed by one of the problem's K2 plans into its
    segments (any trailing shape) — kernel K2. The rows are in the order of
    the plan's id array (with_plans)."""
    S = plan.num_segments
    flat = vals.reshape(vals.shape[0], -1).contiguous()
    return seg_accum_full(flat, None, S, plan).reshape((S,) + vals.shape[1:])


def _seg_pt(prob: BAProblem, vals):
    """Dense-point-keyed reduction (sorted gapless ids, CSR offsets) — K3."""
    Pd = prob.point_rows.shape[0]
    flat = vals.reshape(vals.shape[0], -1).contiguous()
    return seg_accum_sorted(flat, prob.pt_offsets, Pd).reshape((Pd,) + vals.shape[1:])


def _assemble_blocks(prob: BAProblem, poses, points_d, lam, scale, psum=None):
    """Normal-equation blocks of the pose-only system. points_d is DENSE.

    Returns (U, Vinv, bp, G, T, g_red):
      U (I,6,6) damped per-image blocks incl. rotation priors,
      Vinv (Pd,9) flat inverse damped point blocks, bp (Pd,3) point
      gradients, G (O,18) flat couplings Jc^T W Jp, T (O,18) flat G V^-1,
      g_red (I,6) reduced gradient bc - sum_o T_o bp[pt_o].

    With `psum` (observations sharded by point over ranks) the per-image
    sums U, bc and the reduced gradient's are summed over the ranks, U and
    bc before the replicated priors and the damping are added; V, bp, G and
    T stay shard-local, since every observation of a point is on one shard.
    """
    I = poses.shape[0]
    r2, Jc, Jp = cm.residual_jacobian_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        prob.cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    w = _cauchy_weight(r2[0] * r2[0] + r2[1] * r2[1], scale)
    w = torch.where(prob.obs_mask, w, torch.zeros_like(w))

    # Gauge masks on the Jacobian columns.
    pf_o = prob.pose_free[prob.obs_image]
    pfd_o = prob.point_free_dense[prob.obs_point_dense]
    for k in range(2):
        for i in range(6):
            Jc[k][i] = Jc[k][i] * pf_o[:, i]
        for i in range(3):
            Jp[k][i] = Jp[k][i] * pfd_o

    # Per-image 6x6 blocks + gradient: one (O, 42) reduction.
    UB = _seg_plan(prob.plan_img,
                   cm.stack_cols(cm.jtwj_cols(Jc, Jc, w) + cm.jtwr_cols(Jc, r2, w)))
    if psum is not None:
        UB = psum(UB)
    U = UB[:, :36].reshape(I, 6, 6)
    bc = UB[:, 36:]
    # Per-point 3x3 blocks + gradient: one (O, 12) reduction.
    Vbp = _seg_pt(prob, cm.stack_cols(cm.jtwj_cols(Jp, Jp, w) + cm.jtwr_cols(Jp, r2, w)))
    Vf = Vbp[:, :9]
    bp = Vbp[:, 9:]

    Ur, br = _rot_prior_blocks(prob, poses)
    U = U + Ur
    bc = bc + br

    # Marquardt damping lambda * diag(H) (+ small floor).
    d = torch.diagonal(U, dim1=-2, dim2=-1)
    U = U + torch.diag_embed(lam * (d + 1e-6))
    Vcols = cm.cols_of(Vf)
    pin = 1.0 - prob.point_free_dense
    for di in (0, 4, 8):
        Vcols[di] = Vcols[di] + lam * (Vcols[di] + 1e-6) + pin
    Vinv = cm.stack_cols(cm.inv3x3_cols(Vcols))

    Gcols = cm.jtwj_cols(Jc, Jp, w)
    Tcols = cm.matmul_cols(Gcols, cm.cols_of(Vinv[prob.obs_point_dense]), 6, 3, 3)
    G = cm.stack_cols(Gcols)
    T = cm.stack_cols(Tcols)

    bp_o = cm.cols_of(bp[prob.obs_point_dense])
    g_local = _seg_plan(prob.plan_img, cm.stack_cols(cm.matvec_cols(Tcols, bp_o, 6, 3)))
    if psum is not None:
        g_local = psum(g_local)
    return U, Vinv, bp, G, T, bc - g_local


def _backsub_points(prob: BAProblem, Vinv, bp, G, dc):
    """dp_p = -V^-1 (bp_p + sum_{o in p} G_o^T dc[img_o]) — DENSE (Pd, 3)."""
    dc_o = cm.cols_of(dc[prob.obs_image])
    Gt_dc = _seg_pt(prob, cm.stack_cols(cm.matTvec_cols(cm.cols_of(G), dc_o, 6, 3)))
    rhs = cm.cols_of(bp + Gt_dc)
    dp = cm.stack_cols(cm.matvec_cols(cm.cols_of(Vinv), rhs, 3, 3))
    return -dp * prob.point_free_dense[:, None]


def _ptblk_agg(prob: BAProblem, plan, T, G):
    """Per-(point, block) aggregation of the couplings: T and G list the
    (O, 3m) values of each block entry of the observations, in `plan`'s
    entry order (plan_ptimg: the image alone; plan_ptblk: the image's pose
    block, then the camera's intrinsics block) -> That, Ghat (Pd, nblk, m, 3).

    The Schur off-diagonal is sum_p That_p[i] Ghat_p[j]^T; aggregating the
    couplings per (point, block) first replaces the pair enumeration with
    one segment sum plus one batched matmul. The JAX package sums each
    entry with an XLA segment_sum; here one K2 call over [T | G] of every
    entry sums by the plan, in the same order on every run."""
    Pd = prob.point_rows.shape[0]
    nblk = plan.num_segments // Pd
    k = T[0].shape[1]
    agg = _seg_plan(plan, torch.cat([torch.cat([t, g], dim=1) for t, g in zip(T, G)]))
    agg = agg.reshape(Pd, nblk, 2 * k)
    return (agg[..., :k].reshape(Pd, nblk, k // 3, 3),
            agg[..., k:].reshape(Pd, nblk, k // 3, 3))


def _lm_step(prob: BAProblem, poses, points_d, lam, scale, psum=None):
    """One damped LM solve (exact dense Schur): (dposes, dpoints_d); NaN
    where the reduced system is singular. With `psum` the Schur
    off-diagonal is summed over the ranks too."""
    I = poses.shape[0]
    U, Vinv, bp, G, T, g_red = _assemble_blocks(prob, poses, points_d, lam, scale, psum)

    That, Ghat = _ptblk_agg(prob, prob.plan_ptimg, [T], [G])  # (Pd, I, 6, 3) each
    S_off = torch.einsum("pbij,pckj->bcik", That, Ghat)
    if psum is not None:
        S_off = psum(S_off)
    idx = torch.arange(I, device=poses.device)
    S = -S_off
    S[idx, idx] += U

    Sd = S.permute(0, 2, 1, 3).reshape(I * 6, I * 6)
    free = prob.pose_free.reshape(I * 6)
    Sd = Sd * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    gd = g_red.reshape(I * 6) * free
    dc = -solve_or_nan(Sd, gd).reshape(I, 6) * prob.pose_free
    return dc, _backsub_points(prob, Vinv, bp, G, dc)


def _pcg(matvec, Minv, b, free, cg_iters, cg_tol, stats=None):
    """Block-Jacobi preconditioned CG on S x = b from x = 0, stopping after
    `cg_iters` iterations or once ||r|| <= cg_tol ||b|| (one host sync per
    iteration). Minv (N, m, m) inverse diagonal blocks, b/free (N, m).
    Appends the iteration count to stats["cg_iters"] when given."""
    r0n = torch.sqrt(torch.sum(b * b))
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("iab,ib->ia", Minv, r) * free
    p = z
    rz = torch.sum(r * z)
    it = 0
    while it < cg_iters:
        sync()
        if not bool(torch.sqrt(torch.sum(r * r)) > cg_tol * r0n):
            break
        Sp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Sp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Sp
        z = torch.einsum("iab,ib->ia", Minv, r) * free
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
        it += 1
    if stats is not None:
        stats.setdefault("cg_iters", []).append(it)
    return x


def _lm_step_cg(prob: BAProblem, poses, points_d, lam, scale, cg_iters: int, cg_tol,
                stats=None, psum=None):
    """One damped LM solve by matrix-free preconditioned CG on the reduced
    camera system (Ceres ITERATIVE_SCHUR + SCHUR_JACOBI in spirit; the
    reference uses SPARSE_SCHUR, bundle_adjustment.cc:554-569).

    The Schur matvec S x = U x - G V^-1 (G^T x) is two segment sums over
    the observations per CG iteration (reduce by point — K3, scatter back
    by image — K2); no co-observation pairs are enumerated. The
    preconditioner is the exact 6x6 diagonal blocks of S,
    D_i = U_i - sum_{o: img_o = i} T_o G_o^T (one K2 reduction); a singular
    block gives NaN, and the LM rejects the step. With `psum` the
    preconditioner's and each matvec's per-image sums are summed over the
    ranks: one (I, 6) sum per CG iteration.
    Returns (dposes, dpoints_d)."""
    I = poses.shape[0]
    U, Vinv, bp, G, T, g_red = _assemble_blocks(prob, poses, points_d, lam, scale, psum)
    free = prob.pose_free
    D_local = _seg_plan(prob.plan_img, cm.stack_cols(
        cm.abt_cols(cm.cols_of(T), cm.cols_of(G), 6, 3, 6))).reshape(I, 6, 6)
    if psum is not None:
        D_local = psum(D_local)
    # Pin fixed components so the blocks stay invertible.
    D = (U - D_local) * free[:, :, None] * free[:, None, :] + torch.diag_embed(1.0 - free)
    Minv = inv_or_nan(D)

    G3 = G.reshape(-1, 6, 3)
    V3 = Vinv.reshape(-1, 3, 3)

    def matvec(x):  # x (I, 6), free-masked
        y = torch.einsum("iab,ib->ia", U, x)
        tp = _seg_pt(prob, cm.matTvec(G3, x[prob.obs_image]))
        s = cm.matvec(V3, tp)
        y2 = _seg_plan(prob.plan_img, cm.matvec(G3, s[prob.obs_point_dense]))
        if psum is not None:
            y2 = psum(y2)
        return (y - y2) * free

    x = _pcg(matvec, Minv, -g_red * free, free, cg_iters, cg_tol, stats)
    dc = x * free
    return dc, _backsub_points(prob, Vinv, bp, G, dc)


def _assemble_selfcal_blocks(prob: BAProblem, poses, points_d, cam_params, cam_free,
                             lam, scale):
    """Assembly with the shared per-camera intrinsics as extra unknowns.

    Returns (Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag, Ur9):
    per-observation entry Jacobians (entry 0 = pose block 9-padded, entry 1
    = intrinsics block), their block ids blk (O,2) over the B = I + C
    blocks, robust weights, damped point blocks, couplings G/T (27 columns
    per entry), gradient and reduced gradient (B, 9), the undamped direct
    diagonal blocks Ddiag (B, 9, 9) and the pose-row prior blocks Ur9.
    """
    I = poses.shape[0]
    C = cam_params.shape[0]
    B = I + C
    r2, Jc, Jp, Jk = cm.residual_jacobian_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv,
        with_intrinsics=True)
    w = _cauchy_weight(r2[0] * r2[0] + r2[1] * r2[1], scale)
    w = torch.where(prob.obs_mask, w, torch.zeros_like(w))

    pf_o = prob.pose_free[prob.obs_image]
    pfd_o = prob.point_free_dense[prob.obs_point_dense]
    cf_o = cam_free[prob.obs_cam]
    zero = torch.zeros_like(w)
    for k in range(2):
        for i in range(6):
            Jc[k][i] = Jc[k][i] * pf_o[:, i]
        for i in range(3):
            Jp[k][i] = Jp[k][i] * pfd_o
        for i in range(9):
            Jk[k][i] = Jk[k][i] * cf_o[:, i]
    Ecols = [[[Jc[k][i] if i < 6 else zero for i in range(9)] for k in range(2)], Jk]
    blk = torch.stack([prob.obs_image, I + prob.obs_cam], dim=1)  # (O, 2)

    # Both entries in one K2 call: entry 0's rows, then entry 1's (plan_blk).
    g = _seg_plan(prob.plan_blk, torch.cat([cm.stack_cols(cm.jtwr_cols(Ecols[a], r2, w))
                                            for a in range(2)]))
    Ddiag = _seg_plan(prob.plan_blk, torch.cat([
        cm.stack_cols(cm.jtwj_cols(Ecols[a], Ecols[a], w)) for a in range(2)])).reshape(B, 9, 9)

    Vbp = _seg_pt(prob, cm.stack_cols(cm.jtwj_cols(Jp, Jp, w) + cm.jtwr_cols(Jp, r2, w)))
    Vcols = cm.cols_of(Vbp[:, :9])
    bp = Vbp[:, 9:]
    pin = 1.0 - prob.point_free_dense
    for di in (0, 4, 8):
        Vcols[di] = Vcols[di] + lam * (Vcols[di] + 1e-6) + pin
    Vinv = cm.stack_cols(cm.inv3x3_cols(Vcols))

    Ur, br = _rot_prior_blocks(prob, poses)
    Ur9 = torch.zeros((I, 9, 9), device=w.device)
    Ur9[:, :6, :6] = Ur
    Ddiag[:I] += Ur9
    g[:I, :6] += br

    Vinv_o = cm.cols_of(Vinv[prob.obs_point_dense])
    Gcols = [cm.jtwj_cols(Ecols[a], Jp, w) for a in range(2)]
    Tcols = [cm.matmul_cols(Gcols[a], Vinv_o, 9, 3, 3) for a in range(2)]
    bp_o = cm.cols_of(bp[prob.obs_point_dense])
    g_red = g - _seg_plan(prob.plan_blk, torch.cat([
        cm.stack_cols(cm.matvec_cols(Tcols[a], bp_o, 9, 3)) for a in range(2)]))
    return Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag, Ur9


def _selfcal_backsub(prob: BAProblem, Vinv, bp, Gcols, blk, dx):
    """dp_p = -V^-1 (bp_p + sum_a sum_{o in p} G_{o,a}^T dx[blk_{o,a}]).

    One K3 call sums both entries side by side (6 columns), then the two
    per-point sums are added: the JAX package's association (two sums, then
    their sum) in one launch. Adding the entries per observation first
    moves the weakly pinned principal point of a self-calibrating solve by
    more f32 rounding than the solvers' agreement allows."""
    Gt = torch.cat([cm.matTvec(cm.stack_cols(Gcols[a]).reshape(-1, 9, 3), dx[blk[:, a]])
                    for a in range(2)], dim=1)
    Gt2 = _seg_pt(prob, Gt)
    Gt_dx = Gt2[:, :3] + Gt2[:, 3:]
    rhs = cm.cols_of(bp + Gt_dx)
    dp = cm.stack_cols(cm.matvec_cols(cm.cols_of(Vinv), rhs, 3, 3))
    return -dp * prob.point_free_dense[:, None]


def _lm_step_selfcal(prob: BAProblem, poses, points_d, cam_params, cam_free, lam,
                     scale):
    """One damped LM solve with SHARED per-camera intrinsics in the reduced
    system (reference refine_camera_params, bundle_adjustment.cc:370-376):
    I pose blocks (9-padded) then C intrinsics blocks, dimension 9(I + C).
    Returns (dposes, dpoints_d, dcams)."""
    I = poses.shape[0]
    C = cam_params.shape[0]
    B = I + C
    (Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag,
     Ur9) = _assemble_selfcal_blocks(prob, poses, points_d, cam_params, cam_free,
                                     lam, scale)

    # Full direct Hessian: the 4 entry combinations of each observation in
    # ONE segment sum over 4O rows into B^2 blocks (in plan_hess's order).
    H = _seg_plan(prob.plan_hess, torch.cat([
        cm.stack_cols(cm.jtwj_cols(Ecols[a], Ecols[b], w))
        for a in range(2) for b in range(2)])).reshape(B, B, 9, 9)
    idx_i = torch.arange(I, device=w.device)
    H[idx_i, idx_i] += Ur9

    # Schur off-diagonal via per-(point, block) aggregation over both entries.
    That, Ghat = _ptblk_agg(prob, prob.plan_ptblk, [cm.stack_cols(Tcols[a]) for a in range(2)],
                            [cm.stack_cols(Gcols[a]) for a in range(2)])  # (Pd, B, 9, 3) each
    S = H - torch.einsum("pbij,pckj->bcik", That, Ghat)
    # Marquardt damping on the diagonal blocks (diag of the UNDAMPED H).
    dH = torch.diagonal(Ddiag, dim1=-2, dim2=-1)
    idx_b = torch.arange(B, device=w.device)
    S[idx_b, idx_b] += torch.diag_embed(lam * (dH + 1e-6))

    pose_free9 = torch.cat([prob.pose_free, torch.zeros((I, 3), device=w.device)], dim=1)
    free = torch.cat([pose_free9, cam_free], dim=0).reshape(B * 9)
    Sd = S.permute(0, 2, 1, 3).reshape(B * 9, B * 9)
    Sd = Sd * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    gd = g_red.reshape(B * 9) * free  # the REDUCED gradient
    dx = -solve_or_nan(Sd, gd).reshape(B, 9)
    dc = dx[:I, :6] * prob.pose_free
    dk = dx[I:] * cam_free
    return dc, _selfcal_backsub(prob, Vinv, bp, Gcols, blk, dx), dk


def _lm_step_selfcal_cg(prob: BAProblem, poses, points_d, cam_params, cam_free, lam,
                        scale, cg_iters: int, cg_tol, stats=None):
    """Matrix-free preconditioned CG version of _lm_step_selfcal: the
    9(I + C) reduced system is never formed. Per CG iteration the matvec
    is one K3 reduction (G^T x by point) and one K2 reduction of both
    entries of every observation (pose block and camera block) into the
    B = I + C blocks. The block-Jacobi preconditioner uses each
    observation's self-pairs: exact for the pose blocks, missing the
    cross-observation terms for the shared-intrinsics blocks (still SPD).
    Returns (dposes, dpoints_d, dcams)."""
    I = poses.shape[0]
    C = cam_params.shape[0]
    B = I + C
    (Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag,
     Ur9) = _assemble_selfcal_blocks(prob, poses, points_d, cam_params, cam_free,
                                     lam, scale)
    # Marquardt damping from the undamped direct diagonal.
    damp = lam * (torch.diagonal(Ddiag, dim1=-2, dim2=-1) + 1e-6)
    pose_free9 = torch.cat([prob.pose_free, torch.zeros((I, 3), device=w.device)], dim=1)
    free = torch.cat([pose_free9, cam_free], dim=0)  # (B, 9)

    D_schur = _seg_plan(prob.plan_blk, torch.cat([
        cm.stack_cols(cm.abt_cols(Tcols[a], Gcols[a], 9, 3, 9)) for a in range(2)])).reshape(
        B, 9, 9)
    D = (Ddiag + torch.diag_embed(damp) - D_schur) * free[:, :, None] * free[:, None, :]
    Minv = inv_or_nan(D + torch.diag_embed(1.0 - free))

    E3 = [torch.stack([cm.stack_cols(Ecols[a][k]) for k in range(2)], dim=1)
          for a in range(2)]  # (O, 2, 9) per entry
    G3 = [cm.stack_cols(Gcols[a]).reshape(-1, 9, 3) for a in range(2)]
    V3 = Vinv.reshape(-1, 3, 3)

    def matvec(x):  # x (B, 9), free-masked
        xa = [x[blk[:, a]] for a in range(2)]
        u = w[:, None] * (cm.matvec(E3[0], xa[0]) + cm.matvec(E3[1], xa[1]))  # (O, 2)
        tp = _seg_pt(prob, cm.matTvec(G3[0], xa[0]) + cm.matTvec(G3[1], xa[1]))
        sv_o = cm.matvec(V3, tp)[prob.obs_point_dense]  # (O, 3)
        # Direct term E^T W E x minus the Schur term G V^-1 G^T x (G carries
        # the weights already), both entries reduced together.
        y = _seg_plan(prob.plan_blk, torch.cat([
            cm.matTvec(E3[a], u) - cm.matvec(G3[a], sv_o) for a in range(2)]))
        y[:I] += torch.einsum("iab,ib->ia", Ur9, x[:I])
        return (y + damp * x) * free

    dx = _pcg(matvec, Minv, -g_red * free, free, cg_iters, cg_tol, stats) * free
    dc = dx[:I, :6] * prob.pose_free
    dk = dx[I:] * cam_free
    return dc, _selfcal_backsub(prob, Vinv, bp, Gcols, blk, dx), dk


def _cg_tolerance(rel_prev, cg_tol):
    """Inexact-Newton forcing term of the CG solves: while LM still makes
    large relative cost reductions (rel_prev, the last accepted step's),
    a looser solve steers as well, so the target is sqrt(rel_prev) * 0.3
    kept within [cg_tol, max(cg_tol, 3e-2)]; a strict request
    (cg_tol < 1e-4) is honoured as given.

    Deliberate divergence: the JAX package clips to [cg_tol, 3e-2], whose
    bounds cross when cg_tol > 3e-2 and then give 3e-2, tighter than asked
    (mavmap_tpu/ba/core.py:1215, :1278). Here such a cg_tol is used as is."""
    if cg_tol < 1e-4:
        return cg_tol
    return torch.clamp(torch.sqrt(rel_prev) * 0.3, min=cg_tol, max=max(cg_tol, 3e-2))


def _lm_loop_selfcal(prob: BAProblem, cam_free, scale, lambda_init, lambda_up,
                     lambda_down, function_tolerance, max_iters: int,
                     solver: str = "dense", cg_max_iters: int = 100,
                     cg_tol: float = 1e-3, stats=None):
    """LM over poses, dense points and shared intrinsics. Returns (poses,
    points, cams, cost, init_cost, iterations)."""
    points_d = _gather_dense_points(prob, prob.points)
    poses, cams = prob.poses, prob.cam_params
    cost = _total_cost_selfcal_d(prob, poses, points_d, cams, scale)
    init_cost = cost
    lam = torch.tensor(lambda_init, dtype=torch.float32, device=poses.device)
    rel_prev = torch.tensor(1.0, dtype=torch.float32, device=poses.device)
    sync(2)  # the two copies from the host
    it = 0
    while it < max_iters:
        if solver == "cg":
            dc, dp, dk = _lm_step_selfcal_cg(prob, poses, points_d, cams, cam_free, lam,
                                             scale, cg_max_iters,
                                             _cg_tolerance(rel_prev, cg_tol), stats)
        else:
            dc, dp, dk = _lm_step_selfcal(prob, poses, points_d, cams, cam_free, lam,
                                          scale)
        new_poses, new_points, new_cams = poses + dc, points_d + dp, cams + dk
        new_cost = _total_cost_selfcal_d(prob, new_poses, new_points, new_cams, scale)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points_d = torch.where(accept, new_points, points_d)
        cams = torch.where(accept, new_cams, cams)
        lam = torch.clamp(torch.where(accept, lam * lambda_down, lam * lambda_up),
                          1e-10, 1e8)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        done = accept & (rel < function_tolerance)
        cost = torch.where(accept, new_cost, cost)
        # A rejected step keeps the forcing term; an accepted one tracks
        # the observed progress.
        rel_prev = torch.where(accept, torch.clamp(rel, min=1e-20), rel_prev)
        it += 1
        sync()
        if bool(done):
            break
    points = _scatter_dense_points(prob, prob.points, points_d)
    return poses, points, cams, cost, init_cost, it


def _lm_loop(prob: BAProblem, scale, lambda_init, lambda_up, lambda_down,
             function_tolerance, max_iters: int, solver: str = "dense",
             cg_max_iters: int = 100, cg_tol: float = 1e-3, stats=None, psum=None):
    """LM over poses and dense points. Returns (poses, points, cost,
    init_cost, iterations). With `psum` (parallel/dist_ba.py) the cost and
    the camera system are summed over the ranks, so every rank takes the
    same steps and decisions; each rank's points are its shard's."""
    points_d = _gather_dense_points(prob, prob.points)
    poses = prob.poses
    cost = _total_cost_d(prob, poses, points_d, scale, psum)
    init_cost = cost
    lam = torch.tensor(lambda_init, dtype=torch.float32, device=poses.device)
    rel_prev = torch.tensor(1.0, dtype=torch.float32, device=poses.device)
    sync(2)  # the two copies from the host
    it = 0
    while it < max_iters:
        if solver == "cg":
            dc, dp = _lm_step_cg(prob, poses, points_d, lam, scale, cg_max_iters,
                                 _cg_tolerance(rel_prev, cg_tol), stats, psum)
        else:
            dc, dp = _lm_step(prob, poses, points_d, lam, scale, psum)
        new_poses, new_points = poses + dc, points_d + dp
        new_cost = _total_cost_d(prob, new_poses, new_points, scale, psum)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points_d = torch.where(accept, new_points, points_d)
        lam = torch.clamp(torch.where(accept, lam * lambda_down, lam * lambda_up),
                          1e-10, 1e8)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        done = accept & (rel < function_tolerance)
        cost = torch.where(accept, new_cost, cost)
        rel_prev = torch.where(accept, torch.clamp(rel, min=1e-20), rel_prev)
        it += 1
        sync()
        if bool(done):
            break
    points = _scatter_dense_points(prob, prob.points, points_d)
    return poses, points, cost, init_cost, it


def point_mean_errors(prob: BAProblem, poses, points, cam_params=None):
    """Per-point mean UNROBUSTIFIED reprojection error in pixels (P,), -1
    for points without observations (reference bundle_adjustment.cc:575-598).
    The per-point sums of the errors and of the observation counts are one
    K2 call by the problem's plan_pt (with_plans), so a second call gives
    the same bits on the card."""
    if prob.plan_pt is None:
        raise ValueError("point_mean_errors: the problem has no plan_pt (with_plans)")
    cams = prob.cam_params if cam_params is None else cam_params
    r2 = cm.residual_cols(
        poses[prob.obs_image], _gather_dense_points(prob, points)[prob.obs_point_dense],
        cams[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    nrm = torch.sqrt(r2[0] * r2[0] + r2[1] * r2[1])
    nrm = torch.where(prob.obs_mask, nrm, torch.zeros_like(nrm))
    sums = _seg_plan(prob.plan_pt, torch.stack([nrm, prob.obs_mask.float()], dim=1))
    s, n = sums[:, 0], sums[:, 1]
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.full_like(s, -1.0))


def _resolve_solver(prob: BAProblem, options: BAOptions) -> str:
    """The reduced-camera-system solver: "auto" is the exact dense solve
    below DENSE_SOLVER_MAX_CAMERAS cameras (the (I, I, 6, 6) Schur tensor
    and its factorization stay cheap) and matrix-free CG from there up;
    "dense" and "cg" are taken as given."""
    if options.solver == "auto":
        I = int(prob.poses.shape[0])
        return "dense" if I < DENSE_SOLVER_MAX_CAMERAS else "cg"
    if options.solver not in ("dense", "cg"):
        raise ValueError(f"unknown BA solver {options.solver!r}")
    return options.solver


BACKENDS = ("auto", "pallas", "xla", "pallas_interpret")


def _check_backend(options: BAOptions, device):
    """Check options.backend for a solve on `device`. "auto" and "pallas"
    run K2/K3 on a CUDA device and their plain versions on the CPU (the
    JAX package's "auto" likewise picks its kernels on the accelerator
    alone). "xla" and "pallas_interpret" ask for the plain sums: those are
    the CPU's path, and on a CUDA device they raise, since the plain K2
    sums with index_add_, whose atomic adds break the port's fixed-order
    rule (every sum on the card adds in a fixed order, so a solve repeats
    bit for bit); neither runs the kernels or the CPU in their place."""
    b = options.backend
    if b not in BACKENDS:
        raise ValueError(f"unknown BA backend {b!r} (one of {', '.join(BACKENDS)})")
    if b in ("xla", "pallas_interpret") and torch.device(device).type == "cuda":
        raise ValueError(
            f"BA backend {b!r} asks for the plain segment sums, which add with "
            "index_add_'s atomics on a CUDA device and break the fixed-order rule (every "
            "sum on the card adds in a fixed order, so a solve repeats bit for bit): use "
            "'auto' or 'pallas' there, or a CPU device")


def _selfcal_cam_free(prob: BAProblem):
    """Per-camera free mask over the 9 padded intrinsics slots."""
    sync(1 + torch.is_tensor(prob.cam_models))  # the models' pull, the mask's copy
    models = np.asarray(prob.cam_models.cpu() if torch.is_tensor(prob.cam_models)
                        else prob.cam_models)
    cam_free = np.zeros((len(models), cam.MAX_CAM_PARAMS), np.float32)
    for c in range(len(models)):
        cam_free[c, : cam.CAMERA_MODEL_NUM_PARAMS[int(models[c])]] = 1.0
    return torch.as_tensor(cam_free, device=prob.poses.device)


def bundle_adjust_async(prob: BAProblem, options: BAOptions = BAOptions(), num_obs=None,
                        device="cuda"):
    """Solve on `device` (the CUDA card unless another is named; it raises
    where there is none) and return a finalize() callable that yields
    (poses, points, info) as numpy, with the solve's device tensors
    (poses, points[, cams], cost, init_cost, iterations) as `finalize.fut`.

    The JAX package enqueues the LM loop here and returns at once; its
    results reach the host when finalize() pulls them. This loop syncs the
    host once per LM iteration, so the solve runs here, when it is
    dispatched, and finalize() only converts. The mapper keeps the JAX
    package's schedule: it applies the results where the JAX package pulls
    them, so every later step sees the same map. The K2 plans of the
    solver that runs are built here, on the host, and no others (plan_pt
    too where the point errors are asked for)."""
    selfcal = options.refine_camera_params
    device = resolve_device(device, "bundle_adjust")
    _check_backend(options, device)
    solver = _resolve_solver(prob, options)
    names = solver_plans(selfcal, solver) + (
        ("plan_pt",) if options.update_point3D_errors else ())
    with span("ba.plans"):
        prob = problem_to_device(with_plans(prob, names), device)
    stats = {}
    args = (float(options.loss_scale_factor), options.lambda_init, options.lambda_up,
            options.lambda_down, options.function_tolerance, options.max_num_iterations)
    kw = dict(solver=solver, cg_max_iters=options.cg_max_iters, cg_tol=options.cg_tol,
              stats=stats)
    with span("ba.lm"):
        if selfcal:
            fut = _lm_loop_selfcal(prob, _selfcal_cam_free(prob), *args, **kw)
        else:
            fut = _lm_loop(prob, *args, **kw)

    def finalize():
        poses, points, cost, init_cost, iters = fut[:2] + fut[-3:]
        # Its host reads: the two costs, the observation count without
        # num_obs, the intrinsics, the point errors, the poses and points.
        sync(4 + (num_obs is None) + selfcal + bool(options.update_point3D_errors))
        info = {
            "initial_cost": float(init_cost),
            "final_cost": float(cost),
            "iterations": iters,
            "num_residuals": 2 * (num_obs if num_obs is not None
                                  else int(prob.obs_mask.sum())),
            "solver": solver,
            "cg_iters": stats.get("cg_iters", []),
        }
        fprob = prob
        if selfcal:
            fprob = prob._replace(cam_params=fut[2])
            info["cam_params"] = fut[2].cpu().numpy()
        if options.update_point3D_errors:
            info["point_errors"] = point_mean_errors(fprob, poses, points).cpu().numpy()
        return poses.cpu().numpy(), points.cpu().numpy(), info

    finalize.fut = fut
    return finalize


def bundle_adjust(prob: BAProblem, options: BAOptions = BAOptions(), num_obs=None,
                  device="cuda"):
    """Run LM to convergence on `device` (see bundle_adjust_async). `prob`
    is a host problem from build_problem. Returns (poses, points, info) as numpy; with
    options.refine_camera_params the shared intrinsics are refined too and
    returned in info["cam_params"]; info["solver"] names the solver and
    info["cg_iters"] lists the CG iterations of each LM iteration."""
    return bundle_adjust_async(prob, options, num_obs, device)()


# --------------------------------------------------------- pose refinement


def _slot_residuals(pose, points, uv, kparams, model_codes, code_ids):
    """(B, N, 2) pixel residuals of each slot's world points under its pose
    (B, 6) and camera (B, 9): once per camera model present, each slot
    keeping its own model's values, as the JAX package's vmapped
    lax.switch over per-slot codes does. model_codes: the slots' codes on
    the host; code_ids: the same on the device, needed only where the
    slots mix models."""
    xc = transform_points(compose_proj_matrix(pose[:, :3], pose[:, 3:]), points)
    out = None
    for code in sorted(set(model_codes)):
        r = cam.world2image(xc, code, kparams[:, None, :]) - uv
        out = r if out is None else torch.where((code_ids == code)[:, None, None], r, out)
    return out


def _slot_jacobian(f, pose):
    """(B, N, 2, 6): each slot's Jacobian of f (B, 6) -> (B, N, 2) with
    respect to its own pose, by forward mode as jacfwd does, one pose axis
    at a time for every slot at once (slot b's residuals depend on its own
    pose alone)."""
    B = pose.shape[0]
    axes = torch.eye(6, dtype=pose.dtype, device=pose.device)[:, None, :].expand(6, B, 6)
    return vmap(lambda t: jvp(f, (pose,), (t,))[1])(axes).permute(1, 2, 3, 0)


def _pose_refine_loop(pose, points, uv, mask, kparams, model_codes, scale, max_iters,
                      code_ids=None):
    """Robust pose LM (DENSE_QR + Cauchy in the reference) over a leading
    slot axis: pose (B, 6), points (B, N, 3), uv (B, N, 2), mask (B, N),
    kparams (B, 9); model_codes: B host ints (code_ids: the same as a
    device tensor where they mix models). On a CUDA device every iteration
    of every slot runs in one launch of kernel K4 (ops/cuda/pose_lm.py); on
    the CPU as _pose_refine_plain, its plain version. Returns (poses (B, 6),
    final costs (B,))."""
    if pose.is_cuda:
        if code_ids is not None:
            code_ids = code_ids.to(torch.int32)
        p, cost, _ = pose_lm(pose, points.contiguous(), uv.contiguous(), mask.contiguous(),
                             kparams.contiguous(), model_codes, scale, max_iters, code_ids)
        return p, cost
    return _pose_refine_plain(pose, points, uv, mask, kparams, model_codes, scale, max_iters,
                              code_ids)


def _pose_refine_plain(pose, points, uv, mask, kparams, model_codes, scale, max_iters,
                       code_ids=None):
    """The plain PyTorch version of K4, _pose_refine_loop's arguments and
    results. A slot stops when an accepted step gains under 1e-6 of its
    cost, and from then on its pose, damping and cost stay frozen while the
    others iterate: what the JAX package's lax.while_loop does under vmap.
    The loop ends once no slot is active, read on the host every iteration
    (a sync per iteration on a CUDA device, where only tests and timings
    call it)."""
    c2 = scale * scale

    def residual(p):
        return _slot_residuals(p, points, uv, kparams, model_codes, code_ids)

    def cost_of(r):
        s = torch.sum(r * r, dim=-1)
        return 0.5 * sum_pairwise(torch.where(mask, c2 * torch.log1p(s / c2),
                                              torch.zeros_like(s)))

    B = pose.shape[0]
    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    p = pose
    r = residual(p)
    cost = cost_of(r)
    lam = torch.full((B,), 1e-3, dtype=pose.dtype, device=pose.device)
    active = torch.ones(B, dtype=torch.bool, device=pose.device)
    for _ in range(max_iters):
        J = _slot_jacobian(residual, p)  # (B, N, 2, 6)
        w = _cauchy_weight(torch.sum(r * r, dim=-1), scale)
        w = torch.where(mask, w, torch.zeros_like(w))
        wJ = w[..., None, None] * J
        # The normal equations summed over each slot's residuals in a fixed
        # order (ops/reduce.py), so a slot's bits do not depend on B.
        H = sum_pairwise((wJ[..., :, None] * J[..., None, :]).flatten(1, 2), dim=1) \
            + lam[:, None, None] * eye
        g = sum_pairwise((wJ * r[..., None]).flatten(1, 2), dim=1)
        # NaN where H is singular, as XLA's solve gives: the step is then
        # rejected (torch.linalg.solve raises there on the card).
        new_p = p - solve_or_nan(H, g[..., None])[..., 0]
        new_r = residual(new_p)
        new_cost = cost_of(new_r)
        accept = active & (new_cost < cost)
        p = torch.where(accept[:, None], new_p, p)
        r = torch.where(accept[:, None, None], new_r, r)
        lam = torch.where(active, torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0),
                                              1e-10, 1e8), lam)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        cost = torch.where(accept, new_cost, cost)
        active = active & ~(accept & (rel < 1e-6))
        if not bool(active.any()):
            break
    return p, cost


def pose_refinement(rvec, tvec, points3D, points2D_px, mask, cam_params, cam_model,
                    loss_scale=1.0, max_iters=30, device="cuda"):
    """Single-pose robust refinement, 3-D points and intrinsics constant
    (reference bundle_adjustment.cc:139-225), on `device` (the CUDA card
    unless another is named). Returns (rvec, tvec, cost)."""
    f32 = torch.float32
    device = resolve_device(device, "pose_refinement")

    def t(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pose = torch.cat([t(rvec), t(tvec)])
    p, cost = _pose_refine_loop(pose[None], t(points3D)[None], t(points2D_px)[None],
                                t(mask, torch.bool)[None], t(cam_params)[None],
                                [int(cam_model)], float(loss_scale), max_iters)
    return p[0, :3], p[0, 3:], cost[0]
