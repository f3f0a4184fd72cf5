"""Device steps of the sequential mapper.

Port of mavmap_tpu/sfm/kernels.py (`two_view_init`, `register_view` and
their host unpacking). Each step runs on the device of its input tensors
and returns two packed buffers, `rows` (F, 9|12) and `scalars` (21|13),
laid out exactly like the JAX version's, so the two packages can be held
against each other field by field. All gates return scalars; the host
applies the accept/reject logic.

RANSAC draws its samples from an explicit torch.Generator; `samples`
injects (T, S) sample indices instead (tests feed the JAX package's).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ba.core import _pose_refine_loop
from ..ops import essential, homography, matching, p3p, projection, triangulation
from ..ops.ransac import ransac
from ..ops.rotation import rvec_from_rotmat


class TwoViewResult(NamedTuple):
    matches: np.ndarray        # (F,) int32 into image2, -1 invalid
    match_valid: np.ndarray    # (F,)
    num_matches: int
    med_disparity: float
    num_hom_inliers: int
    E: np.ndarray              # (3, 3)
    e_inlier: np.ndarray       # (F,) bool, aligned with image-1 rows
    num_e_inliers: int
    rvec2: np.ndarray          # (3,) second pose (first = identity)
    tvec2: np.ndarray
    z_component: float         # |z| of inverted second pose (forward-motion gate)
    points3D: np.ndarray       # (F, 3) triangulated per match row
    tri_angle: np.ndarray      # (F,) radians
    mean_tri_angle: float      # degrees, folded at 90
    depth1: np.ndarray         # (F,)
    depth2: np.ndarray


def two_view_init(generator, kp1, desc1, mask1, n1, kp2, desc2, mask2, n2,
                  ratio, max_distance, norm_threshold, essential_trials=512,
                  hom_trials=128, max_depth=100.0, samples=None):
    """Match + disparity + homography + 5pt-RANSAC + pose + triangulate.

    Device side of reference process_initial (sequential_mapper.cc:46-386).
    kp/desc/mask are capacity-F padded; n1/n2 are normalized coords of the
    same rows. samples: optional (homography (T_h, 4), essential (T_e, 5))
    sample indices. Returns (rows (F, 9), scalars (21,)).
    """
    matches, valid = matching.match_features(
        desc1, desc2, mask1, mask2, kp1, kp2, ratio=ratio, max_distance=max_distance)
    num_matches = torch.sum(valid)
    med_disp = matching.median_feature_disparity(kp1, kp2, matches, valid)

    x1 = n1
    x2 = n2[torch.clamp(matches.long(), min=0)]

    s_h, s_e = samples if samples is not None else (None, None)
    hom = ransac(generator, x1, x2, homography.solve_homography,
                 homography.homography_residuals, sample_size=4,
                 num_trials=hom_trials, threshold=norm_threshold,
                 valid_mask=valid, samples=s_h)
    eres = ransac(generator, x1, x2, essential.solve_essential_5pt,
                  essential.abs_sampson_residuals, sample_size=5,
                  num_trials=essential_trials, threshold=norm_threshold,
                  valid_mask=valid, samples=s_e)
    # Non-minimal refit on all inliers (masked 8-point); keep whichever of
    # {RANSAC model, refit} has more inliers.
    E_refit = essential.solve_essential_8pt(
        x1, x2, weights=eres.inlier_mask.to(x1.dtype))[0][0]
    refit_inl = (essential.abs_sampson_residuals(x1, x2, E_refit)
                 <= norm_threshold) & valid
    use_refit = torch.sum(refit_inl) >= eres.num_inliers
    E_best = torch.where(use_refit, E_refit, eres.model)
    inlier_best = torch.where(use_refit, refit_inl, eres.inlier_mask)
    num_inl_best = torch.maximum(torch.sum(refit_inl), eres.num_inliers.long())

    R, t, _ = essential.pose_from_essential_matrix(E_best, x1, x2, inlier_best,
                                                   max_depth=max_depth)
    rvec2 = rvec_from_rotmat(R)
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    proj1 = torch.cat([eye, torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)], dim=1)
    proj2 = torch.cat([R, t[:, None]], dim=1)
    z_comp = torch.abs(projection.invert_proj_matrix(proj2)[2, 3])

    X = triangulation.triangulate_points(proj1, proj2, x1, x2)
    ang = triangulation.calc_tri_angles(proj1, proj2, X)
    ang_folded = torch.minimum(ang, math.pi - ang)
    mean_angle = torch.sum(torch.where(inlier_best, ang_folded, torch.zeros_like(ang))) \
        / torch.clamp(num_inl_best, min=1)
    d1 = projection.calc_depth(proj1, X)
    d2 = projection.calc_depth(proj2, X)

    f32 = torch.float32
    rows = torch.stack([matches.to(f32), valid.to(f32), inlier_best.to(f32),
                        ang, d1, d2], dim=-1)
    rows = torch.cat([rows, X], dim=-1)  # (F, 9)
    head = torch.stack([num_matches.to(f32), med_disp, hom.num_inliers.to(f32),
                        num_inl_best.to(f32), z_comp, mean_angle * (180.0 / math.pi)])
    scalars = torch.cat([head, rvec2, t, E_best.reshape(9)])  # (21,)
    return rows, scalars


def unpack_two_view(rows, scalars) -> TwoViewResult:
    """Host-side unpacking of two_view_init's packed outputs (numpy in)."""
    return TwoViewResult(
        matches=rows[:, 0].astype(np.int32),
        match_valid=rows[:, 1] > 0.5,
        num_matches=int(scalars[0]),
        med_disparity=float(scalars[1]),
        num_hom_inliers=int(scalars[2]),
        E=scalars[12:21].reshape(3, 3),
        e_inlier=rows[:, 2] > 0.5,
        num_e_inliers=int(scalars[3]),
        rvec2=scalars[6:9],
        tvec2=scalars[9:12],
        z_component=float(scalars[4]),
        points3D=rows[:, 6:9],
        tri_angle=rows[:, 3],
        mean_tri_angle=float(scalars[5]),
        depth1=rows[:, 4],
        depth2=rows[:, 5],
    )


class RegisterResult(NamedTuple):
    matches: np.ndarray         # (F,) prev-row -> curr-row
    match_valid: np.ndarray
    num_matches: int
    med_disparity: float
    num_hom_inliers: int
    num_stable: int
    p3p_inlier: np.ndarray      # (F,) over prev rows (stable subset)
    num_p3p_inliers: int
    p3p_success: bool
    rvec: np.ndarray            # refined pose of current image
    tvec: np.ndarray
    final_cost: float           # RMS px over stable inliers
    track_reproj: np.ndarray    # (F,) error of existing 3D pts in new view
    new_points3D: np.ndarray    # (F, 3) triangulations for new matches
    new_reproj_prev: np.ndarray  # (F,) normalized reproj error in prev view
    new_reproj_curr: np.ndarray
    new_tri_angle: np.ndarray   # (F,) radians
    new_depth_prev: np.ndarray
    new_depth_curr: np.ndarray


def register_view(generator, kp_prev, desc_prev, mask_prev, n_prev,
                  kp_curr, desc_curr, mask_curr, n_curr,
                  prev_p3d_xyz, prev_has_tri, prev_stable, prev_rvec, prev_tvec,
                  cam_params, cam_model, ratio, max_distance, norm_threshold,
                  p3p_trials=512, hom_trials=128, refine_iters=30, samples=None):
    """Match + gates + P3P RANSAC + LM pose refinement + track continuation
    checks + new-point triangulation (device side of reference `process`,
    sequential_mapper.cc:389-934).

    prev_p3d_xyz (F, 3): 3-D point of each prev row's track (garbage where
    none); prev_has_tri/prev_stable (F,) bool; cam_model: int. samples:
    optional (homography (T_h, 4), p3p (T_p, 4)) sample indices.
    Returns (rows (F, 12), scalars (13,)).
    """
    matches, valid = matching.match_features(
        desc_prev, desc_curr, mask_prev, mask_curr, kp_prev, kp_curr,
        ratio=ratio, max_distance=max_distance)
    num_matches = torch.sum(valid)
    med_disp = matching.median_feature_disparity(kp_prev, kp_curr, matches, valid)

    j = torch.clamp(matches.long(), min=0)
    x_prev = n_prev
    x_curr = n_curr[j]
    kp_curr_m = kp_curr[j]

    s_h, s_p = samples if samples is not None else (None, None)
    hom = ransac(generator, x_prev, x_curr, homography.solve_homography,
                 homography.homography_residuals, sample_size=4,
                 num_trials=hom_trials, threshold=norm_threshold,
                 valid_mask=valid, samples=s_h)

    stable = valid & prev_stable & prev_has_tri
    num_stable = torch.sum(stable)
    pres = ransac(generator, x_curr, prev_p3d_xyz, p3p.solve_p3p_best,
                  p3p.p3p_residuals, sample_size=4, num_trials=p3p_trials,
                  threshold=norm_threshold, valid_mask=stable, samples=s_p)
    rvec0 = rvec_from_rotmat(pres.model[:3, :3])
    tvec0 = pres.model[:3, 3]

    pose, cost = _pose_refine_loop(torch.cat([rvec0, tvec0]), prev_p3d_xyz,
                                   kp_curr_m, pres.inlier_mask, cam_params,
                                   int(cam_model), 1.0, refine_iters)
    # RMS px over refined residuals, like the reference
    # sqrt(summary.final_cost / num_residuals) (bundle_adjustment.cc:222).
    final_cost = torch.sqrt(cost / torch.clamp(pres.num_inliers * 2, min=1))

    rvec, tvec = pose[:3], pose[3:]
    proj_curr = projection.compose_proj_matrix(rvec, tvec)
    proj_prev = projection.compose_proj_matrix(prev_rvec, prev_tvec)
    track_err = projection.calc_reproj_errors(x_curr, prev_p3d_xyz, proj_curr)

    Xnew = triangulation.triangulate_points(proj_prev, proj_curr, x_prev, x_curr)
    err_prev = projection.calc_reproj_errors(x_prev, Xnew, proj_prev)
    err_curr = projection.calc_reproj_errors(x_curr, Xnew, proj_curr)
    ang = triangulation.calc_tri_angles(proj_prev, proj_curr, Xnew)
    dp = projection.calc_depth(proj_prev, Xnew)
    dc = projection.calc_depth(proj_curr, Xnew)

    f32 = torch.float32
    rows = torch.stack([matches.to(f32), valid.to(f32), pres.inlier_mask.to(f32),
                        track_err, err_prev, err_curr, ang, dp, dc], dim=-1)
    rows = torch.cat([rows, Xnew], dim=-1)  # (F, 12)
    head = torch.stack([num_matches.to(f32), med_disp, hom.num_inliers.to(f32),
                        num_stable.to(f32), pres.num_inliers.to(f32),
                        pres.success.to(f32), final_cost])
    scalars = torch.cat([head, rvec, tvec])  # (13,)
    return rows, scalars


def unpack_register(rows, scalars) -> RegisterResult:
    """Host-side unpacking of register_view's packed outputs (numpy in)."""
    return RegisterResult(
        matches=rows[:, 0].astype(np.int32),
        match_valid=rows[:, 1] > 0.5,
        num_matches=int(scalars[0]),
        med_disparity=float(scalars[1]),
        num_hom_inliers=int(scalars[2]),
        num_stable=int(scalars[3]),
        p3p_inlier=rows[:, 2] > 0.5,
        num_p3p_inliers=int(scalars[4]),
        p3p_success=bool(scalars[5] > 0.5),
        rvec=scalars[7:10],
        tvec=scalars[10:13],
        final_cost=float(scalars[6]),
        track_reproj=rows[:, 3],
        new_points3D=rows[:, 9:12],
        new_reproj_prev=rows[:, 4],
        new_reproj_curr=rows[:, 5],
        new_tri_angle=rows[:, 6],
        new_depth_prev=rows[:, 7],
        new_depth_curr=rows[:, 8],
    )
