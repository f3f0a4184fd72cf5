"""Robust Levenberg-Marquardt bundle adjustment with Schur complement.

Port of the dense path of mavmap_tpu/ba/core.py (reference
src/base3d/bundle_adjustment.{h,cc}):

  - residuals r_o = world2image(R_i X_p + t_i; cam) - uv_o in PIXELS with
    the Cauchy robust loss (`loss_scale_factor`, reference :148-149);
  - per-observation Jacobians in column arithmetic (ba/colmath.py);
  - normal equations in camera-block / point-block Schur form: 3x3 point
    blocks inverted in closed form, the reduced camera system (6 per pose,
    + 9 per camera with refine_camera_params) assembled from per-(point,
    image) aggregates and solved densely — exact;
  - gauge fixing by masking parameter rows (BA_POSE_FREE / FIXED /
    FIXED_X, bundle_adjustment.h:33-35), IMU rotation priors, GCP pinning.

The per-image and per-block reductions go through CUDA kernel K2
(ops/cuda/ba_accum.py seg_accum_full) and the per-point reductions through
K3 (seg_accum_sorted) when the problem lives on a CUDA device; on the CPU
the wrappers run their plain PyTorch versions. The LM loops are Python
loops with an early exit (one host sync per iteration).

Not in this package yet: the matrix-free CG solver (solver="cg" and
problems with >= DENSE_SOLVER_MAX_CAMERAS cameras raise
NotImplementedError) and the asynchronous dispatch.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..models import camera as cam
from ..ops.cuda.ba_accum import (
    offsets_from_sorted_ids, seg_accum_full, seg_accum_sorted)
from ..ops.rotation import rotmat_from_rvec
from . import colmath as cm

BA_POSE_FREE = 0
BA_POSE_FIXED = 1
BA_POSE_FIXED_X = 2

# Camera-count cutoff of the exact dense Schur solve (the JAX package
# switches to matrix-free CG above it).
DENSE_SOLVER_MAX_CAMERAS = 64


@dataclass(frozen=True)
class BAOptions:
    max_num_iterations: int = 50
    function_tolerance: float = 1e-4
    loss_scale_factor: float = 1.0  # Cauchy scale, pixels
    refine_camera_params: bool = False
    update_point3D_errors: bool = False
    min_track_len: int = 2
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    # Reduced-camera-system solver: "dense" or "auto" (dense below
    # DENSE_SOLVER_MAX_CAMERAS). "cg" is not ported yet and raises.
    solver: str = "auto"
    # Above this observation count, self-calibration runs as TWO stages
    # (intrinsics refined on an observation subsample, then the full
    # problem with intrinsics fixed; mapper.adjust_bundle implements it).
    selfcal_max_obs: int = 150_000


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
    obs_image_sorted) are gone — the by-image kernel takes unsorted ids —
    and `pt_offsets` replaces the banded kernel's `pt_gather_rows`.
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

    return BAProblem(
        poses=poses,
        points=points,
        cam_params=np.asarray(cam_params, np.float32),
        cam_models=np.asarray(cam_models, np.int32),
        # Padding keeps the LAST image/point index so the sort order holds;
        # masked rows contribute zeros wherever they land.
        obs_image=pad(obs_image, obs_capacity, fill=int(obs_image[-1]) if O else 0),
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
    """Host (numpy) problem -> tensors on `device`."""
    return BAProblem(*(torch.as_tensor(np.asarray(a), device=device) for a in prob))


# ---------------------------------------------------------------- residuals


def _gather_dense_points(prob: BAProblem, points):
    """(P, 3) full points -> (Pd, 3) dense rows (pads clamp to the last)."""
    return points[torch.clamp(prob.point_rows.long(), max=points.shape[0] - 1)]


def _scatter_dense_points(prob: BAProblem, points, points_d):
    """Write dense rows back into the full array (pad rows dropped)."""
    out = points.clone()
    keep = prob.point_rows < points.shape[0]
    out[prob.point_rows[keep].long()] = points_d[keep]
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


def _robust_cost(prob: BAProblem, poses, r2, scale):
    s = r2[0] * r2[0] + r2[1] * r2[1]
    c2 = scale * scale
    rho = c2 * torch.log1p(s / c2)
    cost = 0.5 * torch.sum(torch.where(prob.obs_mask, rho, torch.zeros_like(rho)))
    rr = _rot_residuals(prob, poses)
    return cost + 0.5 * torch.sum(rr * rr)


def _total_cost_d(prob: BAProblem, poses, points_d, scale):
    """Robust total cost over DENSE points."""
    r2 = cm.residual_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        prob.cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    return _robust_cost(prob, poses, r2, scale)


def _total_cost_selfcal_d(prob: BAProblem, poses, points_d, cam_params, scale):
    r2 = cm.residual_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    return _robust_cost(prob, poses, r2, scale)


def total_cost(prob: BAProblem, poses, points, scale):
    """Robust total cost 0.5 sum rho(||r||^2) over the FULL points array."""
    return _total_cost_d(prob, poses, _gather_dense_points(prob, points), scale)


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


def _seg_img(prob: BAProblem, vals, I):
    """Image-keyed reduction (any trailing shape) — kernel K2."""
    flat = vals.reshape(vals.shape[0], -1).contiguous()
    return seg_accum_full(flat, prob.obs_image, I).reshape((I,) + vals.shape[1:])


def _seg_ids(ids, vals, S):
    """Reduction keyed by arbitrary (unsorted) ids into S segments — K2."""
    flat = vals.reshape(vals.shape[0], -1).contiguous()
    return seg_accum_full(flat, ids.to(torch.int32).contiguous(), S).reshape(
        (S,) + vals.shape[1:])


def _seg_pt(prob: BAProblem, vals):
    """Dense-point-keyed reduction (sorted gapless ids, CSR offsets) — K3."""
    Pd = prob.point_rows.shape[0]
    flat = vals.reshape(vals.shape[0], -1).contiguous()
    return seg_accum_sorted(flat, prob.pt_offsets, Pd).reshape((Pd,) + vals.shape[1:])


def _assemble_blocks(prob: BAProblem, poses, points_d, lam, scale):
    """Normal-equation blocks of the pose-only system. points_d is DENSE.

    Returns (U, Vinv, bp, G, T, g_red):
      U (I,6,6) damped per-image blocks incl. rotation priors,
      Vinv (Pd,9) flat inverse damped point blocks, bp (Pd,3) point
      gradients, G (O,18) flat couplings Jc^T W Jp, T (O,18) flat G V^-1,
      g_red (I,6) reduced gradient bc - sum_o T_o bp[pt_o].
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
    UB = _seg_img(prob, cm.stack_cols(cm.jtwj_cols(Jc, Jc, w) + cm.jtwr_cols(Jc, r2, w)), I)
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
    g_local = _seg_img(prob, cm.stack_cols(cm.matvec_cols(Tcols, bp_o, 6, 3)), I)
    return U, Vinv, bp, G, T, bc - g_local


def _backsub_points(prob: BAProblem, Vinv, bp, G, dc):
    """dp_p = -V^-1 (bp_p + sum_{o in p} G_o^T dc[img_o]) — DENSE (Pd, 3)."""
    dc_o = cm.cols_of(dc[prob.obs_image])
    Gt_dc = _seg_pt(prob, cm.stack_cols(cm.matTvec_cols(cm.cols_of(G), dc_o, 6, 3)))
    rhs = cm.cols_of(bp + Gt_dc)
    dp = cm.stack_cols(cm.matvec_cols(cm.cols_of(Vinv), rhs, 3, 3))
    return -dp * prob.point_free_dense[:, None]


def _ptblk_agg(prob: BAProblem, vals, nblk, blk_ids):
    """Per-(point, block) aggregation: (O, K) values -> (Pd, nblk, K/3, 3).

    The Schur off-diagonal is sum_p That_p[i] Ghat_p[j]^T; aggregating the
    couplings per (point, block) first replaces the pair enumeration with
    one segment sum plus one batched matmul. (An XLA segment_sum in the
    JAX package, not a Pallas kernel: index_add_ here.)"""
    Pd = prob.point_rows.shape[0]
    ids = prob.obs_point_dense.long() * nblk + blk_ids.long()
    out = torch.zeros((Pd * nblk, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, ids, vals)
    return out.reshape(Pd, nblk, vals.shape[1] // 3, 3)


def _lm_step(prob: BAProblem, poses, points_d, lam, scale):
    """One damped LM solve (exact dense Schur): (dposes, dpoints_d)."""
    I = poses.shape[0]
    U, Vinv, bp, G, T, g_red = _assemble_blocks(prob, poses, points_d, lam, scale)

    That = _ptblk_agg(prob, T, I, prob.obs_image)  # (Pd, I, 6, 3)
    Ghat = _ptblk_agg(prob, G, I, prob.obs_image)
    S_off = torch.einsum("pbij,pckj->bcik", That, Ghat)
    idx = torch.arange(I, device=poses.device)
    S = -S_off
    S[idx, idx] += U

    Sd = S.permute(0, 2, 1, 3).reshape(I * 6, I * 6)
    free = prob.pose_free.reshape(I * 6)
    Sd = Sd * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    gd = g_red.reshape(I * 6) * free
    dc = -torch.linalg.solve(Sd, gd).reshape(I, 6) * prob.pose_free
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

    g = torch.zeros((B, 9), device=w.device)
    Ddiag = torch.zeros((B, 9, 9), device=w.device)
    for a in range(2):
        g = g + _seg_ids(blk[:, a], cm.stack_cols(cm.jtwr_cols(Ecols[a], r2, w)), B)
        Ddiag = Ddiag + _seg_ids(
            blk[:, a], cm.stack_cols(cm.jtwj_cols(Ecols[a], Ecols[a], w)), B
        ).reshape(B, 9, 9)

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
    g_red = g - sum(
        _seg_ids(blk[:, a], cm.stack_cols(cm.matvec_cols(Tcols[a], bp_o, 9, 3)), B)
        for a in range(2))
    return Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag, Ur9


def _selfcal_backsub(prob: BAProblem, Vinv, bp, Gcols, blk, dx):
    Gt_dx = sum(
        _seg_pt(prob, cm.stack_cols(
            cm.matTvec_cols(Gcols[a], cm.cols_of(dx[blk[:, a]]), 9, 3)))
        for a in range(2))
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
    # ONE segment sum over 4O rows into B^2 blocks.
    h_ids, h_vals = [], []
    for a in range(2):
        for b in range(2):
            h_vals.append(cm.stack_cols(cm.jtwj_cols(Ecols[a], Ecols[b], w)))
            h_ids.append(blk[:, a] * B + blk[:, b])
    H = _seg_ids(torch.cat(h_ids), torch.cat(h_vals), B * B).reshape(B, B, 9, 9)
    idx_i = torch.arange(I, device=w.device)
    H[idx_i, idx_i] += Ur9

    # Schur off-diagonal via per-(point, block) aggregation over both entries.
    G2 = [cm.stack_cols(Gcols[a]) for a in range(2)]  # (O, 27)
    T2 = [cm.stack_cols(Tcols[a]) for a in range(2)]
    That = _ptblk_agg(prob, T2[0], B, blk[:, 0]) + _ptblk_agg(prob, T2[1], B, blk[:, 1])
    Ghat = _ptblk_agg(prob, G2[0], B, blk[:, 0]) + _ptblk_agg(prob, G2[1], B, blk[:, 1])
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
    dx = -torch.linalg.solve(Sd, gd).reshape(B, 9)
    dc = dx[:I, :6] * prob.pose_free
    dk = dx[I:] * cam_free
    return dc, _selfcal_backsub(prob, Vinv, bp, Gcols, blk, dx), dk


def _lm_loop_selfcal(prob: BAProblem, cam_free, scale, lambda_init, lambda_up,
                     lambda_down, function_tolerance, max_iters: int):
    """LM over poses, dense points and shared intrinsics. Returns (poses,
    points, cams, cost, init_cost, iterations)."""
    points_d = _gather_dense_points(prob, prob.points)
    poses, cams = prob.poses, prob.cam_params
    cost = _total_cost_selfcal_d(prob, poses, points_d, cams, scale)
    init_cost = cost
    lam = torch.tensor(lambda_init, dtype=torch.float32, device=poses.device)
    it = 0
    while it < max_iters:
        dc, dp, dk = _lm_step_selfcal(prob, poses, points_d, cams, cam_free, lam, scale)
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
        it += 1
        if bool(done):
            break
    points = _scatter_dense_points(prob, prob.points, points_d)
    return poses, points, cams, cost, init_cost, it


def _lm_loop(prob: BAProblem, scale, lambda_init, lambda_up, lambda_down,
             function_tolerance, max_iters: int):
    """LM over poses and dense points. Returns (poses, points, cost,
    init_cost, iterations)."""
    points_d = _gather_dense_points(prob, prob.points)
    poses = prob.poses
    cost = _total_cost_d(prob, poses, points_d, scale)
    init_cost = cost
    lam = torch.tensor(lambda_init, dtype=torch.float32, device=poses.device)
    it = 0
    while it < max_iters:
        dc, dp = _lm_step(prob, poses, points_d, lam, scale)
        new_poses, new_points = poses + dc, points_d + dp
        new_cost = _total_cost_d(prob, new_poses, new_points, scale)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points_d = torch.where(accept, new_points, points_d)
        lam = torch.clamp(torch.where(accept, lam * lambda_down, lam * lambda_up),
                          1e-10, 1e8)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        done = accept & (rel < function_tolerance)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        if bool(done):
            break
    points = _scatter_dense_points(prob, prob.points, points_d)
    return poses, points, cost, init_cost, it


def point_mean_errors(prob: BAProblem, poses, points, cam_params=None):
    """Per-point mean UNROBUSTIFIED reprojection error in pixels (P,), -1
    for points without observations (reference bundle_adjustment.cc:575-598)."""
    cams = prob.cam_params if cam_params is None else cam_params
    r2 = cm.residual_cols(
        poses[prob.obs_image], _gather_dense_points(prob, points)[prob.obs_point_dense],
        cams[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv)
    nrm = torch.sqrt(r2[0] * r2[0] + r2[1] * r2[1])
    m = prob.obs_mask.float()
    P = points.shape[0]
    ids = prob.obs_point.long()
    s = torch.zeros(P, device=nrm.device).index_add_(0, ids, nrm * m)
    n = torch.zeros(P, device=nrm.device).index_add_(0, ids, m)
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.full_like(s, -1.0))


def _resolve_solver(prob: BAProblem, options: BAOptions) -> str:
    """The dense Schur solve; CG is not ported yet and raises."""
    I = int(prob.poses.shape[0])
    if options.solver == "cg" or (options.solver == "auto"
                                  and I >= DENSE_SOLVER_MAX_CAMERAS):
        raise NotImplementedError(
            f"BA solver {options.solver!r} with {I} cameras: only the dense "
            f"Schur solve (< {DENSE_SOLVER_MAX_CAMERAS} cameras) is ported")
    if options.solver not in ("auto", "dense"):
        raise ValueError(f"unknown BA solver {options.solver!r}")
    return "dense"


def _selfcal_cam_free(prob: BAProblem):
    """Per-camera free mask over the 9 padded intrinsics slots."""
    models = np.asarray(prob.cam_models.cpu() if torch.is_tensor(prob.cam_models)
                        else prob.cam_models)
    cam_free = np.zeros((len(models), cam.MAX_CAM_PARAMS), np.float32)
    for c in range(len(models)):
        cam_free[c, : cam.CAMERA_MODEL_NUM_PARAMS[int(models[c])]] = 1.0
    return torch.as_tensor(cam_free, device=prob.poses.device)


def bundle_adjust(prob: BAProblem, options: BAOptions, device, num_obs=None):
    """Run LM to convergence on `device`. `prob` is a host problem from
    build_problem. Returns (poses, points, info) as numpy; with
    options.refine_camera_params the shared intrinsics are refined too and
    returned in info["cam_params"]."""
    _resolve_solver(prob, options)
    prob = problem_to_device(prob, device)
    args = (float(options.loss_scale_factor), options.lambda_init, options.lambda_up,
            options.lambda_down, options.function_tolerance, options.max_num_iterations)
    if options.refine_camera_params:
        poses, points, cams, cost, init_cost, iters = _lm_loop_selfcal(
            prob, _selfcal_cam_free(prob), *args)
        prob = prob._replace(cam_params=cams)
    else:
        poses, points, cost, init_cost, iters = _lm_loop(prob, *args)
    info = {
        "initial_cost": float(init_cost),
        "final_cost": float(cost),
        "iterations": iters,
        "num_residuals": 2 * (num_obs if num_obs is not None
                              else int(prob.obs_mask.sum())),
    }
    if options.refine_camera_params:
        info["cam_params"] = prob.cam_params.cpu().numpy()
    if options.update_point3D_errors:
        info["point_errors"] = point_mean_errors(prob, poses, points).cpu().numpy()
    return poses.cpu().numpy(), points.cpu().numpy(), info


# --------------------------------------------------------- pose refinement


def _obs_residuals(pose, points, uv, kparams, model_code):
    """(N, 2) pixel residuals of world points under one pose."""
    xc = points @ rotmat_from_rvec(pose[:3]).T + pose[3:]
    return cam.world2image(xc, model_code, kparams) - uv


def _pose_refine_loop(pose, points, uv, mask, kparams, model_code, scale, max_iters):
    """Robust single-pose LM (DENSE_QR + Cauchy in the reference). Returns
    (pose, final cost)."""

    def residual(p):
        return _obs_residuals(p, points, uv, kparams, model_code)

    c2 = scale * scale

    def cost_of(r):
        s = torch.sum(r * r, dim=-1)
        return 0.5 * torch.sum(torch.where(mask, c2 * torch.log1p(s / c2),
                                           torch.zeros_like(s)))

    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    p = pose
    cost = cost_of(residual(p))
    lam = torch.tensor(1e-3, dtype=pose.dtype, device=pose.device)
    for _ in range(max_iters):
        r = residual(p)
        J = jacfwd(residual)(p)  # (N, 2, 6)
        w = _cauchy_weight(torch.sum(r * r, dim=-1), scale)
        w = torch.where(mask, w, torch.zeros_like(w))
        wJ = w[:, None, None] * J
        H = torch.einsum("oki,okj->ij", wJ, J) + lam * eye
        g = torch.einsum("oki,ok->i", wJ, r)
        new_p = p - torch.linalg.solve(H, g)
        new_cost = cost_of(residual(new_p))
        accept = new_cost < cost
        p = torch.where(accept, new_p, p)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0), 1e-10, 1e8)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        done = accept & (rel < 1e-6)
        cost = torch.where(accept, new_cost, cost)
        if bool(done):
            break
    return p, cost


def pose_refinement(rvec, tvec, points3D, points2D_px, mask, cam_params, cam_model,
                    device, loss_scale=1.0, max_iters=30):
    """Single-pose robust refinement, 3-D points and intrinsics constant
    (reference bundle_adjustment.cc:139-225). Returns (rvec, tvec, cost)."""
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pose = torch.cat([t(rvec), t(tvec)])
    p, cost = _pose_refine_loop(pose, t(points3D), t(points2D_px), t(mask, torch.bool),
                                t(cam_params), int(cam_model), float(loss_scale),
                                max_iters)
    return p[:3], p[3:], cost
