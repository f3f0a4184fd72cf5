"""Device steps of the sequential mapper.

Port of mavmap_tpu/sfm/kernels.py (`two_view_init`, `register_view`, the
chained `register_chain` / `register_chain_fresh` with their device copy
of the commit's track rules `_derive_chain_state`, the batched
`two_view_init_batch` / `register_view_batch` / `register_view_pairs`, and
the host unpacking). Each step runs on the device of its input tensors and
returns packed buffers, `rows` (F, 9|12) and `scalars` (21|13) per frame
(with a leading slot axis from the batched steps), laid out exactly like
the JAX version's, so the two packages can be held against each other
field by field. All gates return scalars; the host applies the
accept/reject logic.

The batched steps run as one batched computation from the match to the
packed outputs, as the JAX package's jax.vmap of the whole step does: one
batched K1 launch matches every slot, and the geometry after it (RANSAC
with its minimal solvers, the 8-point refit, pose recovery, the pose LM,
the track checks and triangulation) carries the slot axis, with no host
sync per slot. `two_view_init` and `register_view` are its one-slot case.
RANSAC draws its samples from an explicit torch.Generator, slot by slot
in slot order before the batched body (`ops.ransac.draw_samples`), so a
slot draws what the single step draws from a generator seeded alike;
`samples` injects (T, S) sample indices instead (tests feed the JAX
package's), with a leading slot axis for the batched steps. `draw_block`
runs a block of a larger step's slots (parallel/dist_register.py): the
generator draws for every slot of that step and the block keeps its own.

On a CUDA device a chain's frame steps run as CUDA graphs after their
match and draw (`_graphed_frame`): the shapes of a frame step are fixed
by the provider's capacity and the trial counts, so each camera model's
graphs are captured once per process and replayed by every later frame,
with the pose LM's kernel K4 cut out between them and called eagerly.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ba.core import _kernel, _pose_refine_loop, _Stretches
from ..ops import essential, homography, matching, p3p, projection, triangulation
from ..ops.ransac import draw_samples, ransac
from ..ops.reduce import sum_pairwise
from ..ops.rotation import rvec_from_rotmat
from ..utils.timer import count, span, sync


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
                  hom_trials=128, max_depth=100.0, matcher="pallas", samples=None):
    """Match + disparity + homography + 5pt-RANSAC + pose + triangulate.

    Device side of reference process_initial (sequential_mapper.cc:46-386).
    kp/desc/mask are capacity-F padded; n1/n2 are normalized coords of the
    same rows. samples: optional (homography (T_h, 4), essential (T_e, 5))
    sample indices; matcher: the matcher backend (ops/matching.py
    MATCHER_BACKENDS). Returns (rows (F, 9), scalars (21,)).
    """
    matches, valid = matching.match_features(
        desc1, desc2, mask1, mask2, kp1, kp2, ratio=ratio, max_distance=max_distance,
        backend=matcher)
    rows, scalars = _two_view_geometry(
        generator, matches[None], valid[None], kp1[None], n1[None], kp2[None], n2[None],
        _slot_thresholds(norm_threshold, 1, kp1.device), essential_trials, hom_trials,
        max_depth, _one_slot(samples))
    return rows[0], scalars[0]


def two_view_init_batch(generator, kp1, desc1, mask1, n1, kp2s, desc2s, mask2s, n2s,
                        ratio, max_distance, norm_thresholds, essential_trials=512,
                        max_depth=100.0, matcher="pallas", hom_trials=128, samples=None):
    """two_view_init of one first image against B candidate second images
    (the JAX package's jax.vmap over the candidates, mapper.cc:1027-1036):
    the first image is shared, the candidates' inputs carry a leading B,
    norm_thresholds is one float per slot. One batched K1 launch matches
    every slot and the geometry runs batched over the slots. samples:
    optional (homography (B, T_h, 4), essential (B, T_e, 5)). Returns
    (rows (B, F, 9), scalars (B, 21))."""
    matches, valid = matching.match_features_batched(
        desc1, desc2s, mask1, mask2s, kp1, kp2s, ratio=ratio, max_distance=max_distance,
        backend=matcher)
    B = matches.shape[0]
    return _two_view_geometry(generator, matches, valid, kp1.expand(B, -1, -1),
                              n1.expand(B, -1, -1), kp2s, n2s,
                              _slot_thresholds(norm_thresholds, B, kp1.device),
                              essential_trials, hom_trials, max_depth, samples)


def _one_slot(samples):
    """Injected samples of one step with a slot axis of 1 (None: draw)."""
    if samples is None:
        return None
    return tuple((s if torch.is_tensor(s) else torch.from_numpy(np.array(s)))[None]
                 for s in samples)


def _slot_thresholds(thresholds, B, device):
    """The slots' norm thresholds as a (B,) float32 tensor on `device`,
    from one host float (no copy) or one per slot."""
    if np.ndim(thresholds) == 0:
        return torch.full((B,), float(np.float32(thresholds)), device=device)
    sync()  # a blocking copy
    return torch.as_tensor(np.asarray(thresholds, np.float32), device=device)


def _rows(a, matches):
    """Per slot, the rows of a (B, F, d) at the matched indices (B, F)."""
    j = torch.clamp(matches.long(), min=0)
    return torch.gather(a, 1, j[..., None].expand(j.shape + (a.shape[-1],)))


def _two_view_geometry(generator, matches, valid, kp1, n1, kp2, n2, norm_thresholds,
                       essential_trials, hom_trials, max_depth, samples):
    """two_view_init after the match, over a leading slot axis (matches,
    valid (B, F); kp, n (B, F, 2); norm_thresholds (B,)): disparity,
    homography and 5-point RANSAC, the 8-point refit, pose and
    triangulation."""
    num_matches = torch.sum(valid, dim=-1)
    med_disp = matching.median_feature_disparity(kp1, kp2, matches, valid)

    x1 = n1
    x2 = _rows(n2, matches)

    if samples is None:
        samples = draw_samples(generator, [(hom_trials, 4, valid),
                                           (essential_trials, 5, valid)])
    s_h, s_e = samples
    nt = norm_thresholds
    hom = ransac(None, x1, x2, homography.solve_homography,
                 homography.homography_residuals, sample_size=4,
                 num_trials=hom_trials, threshold=nt, valid_mask=valid, samples=s_h)
    eres = ransac(None, x1, x2, essential.solve_essential_5pt,
                  essential.abs_sampson_residuals, sample_size=5,
                  num_trials=essential_trials, threshold=nt, valid_mask=valid,
                  samples=s_e)
    # Non-minimal refit on all inliers (masked 8-point); keep whichever of
    # {RANSAC model, refit} has more inliers.
    E_refit = essential.solve_essential_8pt(
        x1, x2, weights=eres.inlier_mask.to(x1.dtype))[0][:, 0]
    refit_inl = (essential.abs_sampson_residuals(x1, x2, E_refit)
                 <= nt[:, None]) & valid
    num_refit = torch.sum(refit_inl, dim=-1)
    use_refit = num_refit >= eres.num_inliers
    E_best = torch.where(use_refit[:, None, None], E_refit, eres.model)
    inlier_best = torch.where(use_refit[:, None], refit_inl, eres.inlier_mask)
    num_inl_best = torch.maximum(num_refit, eres.num_inliers.long())

    R, t, _ = essential.pose_from_essential_matrix(E_best, x1, x2, inlier_best,
                                                   max_depth=max_depth)
    rvec2 = rvec_from_rotmat(R)
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)
    proj1 = torch.cat([eye, torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)], dim=1)
    proj2 = torch.cat([R, t[..., None]], dim=-1)
    z_comp = torch.abs(projection.invert_proj_matrix(proj2)[:, 2, 3])

    X = triangulation.triangulate_points(proj1, proj2, x1, x2)
    ang = triangulation.calc_tri_angles(proj1, proj2, X)
    ang_folded = torch.minimum(ang, math.pi - ang)
    mean_angle = sum_pairwise(torch.where(inlier_best, ang_folded, torch.zeros_like(ang))) \
        / torch.clamp(num_inl_best, min=1)
    d1 = projection.calc_depth(proj1, X)
    d2 = projection.calc_depth(proj2, X)

    f32 = torch.float32
    rows = torch.stack([matches.to(f32), valid.to(f32), inlier_best.to(f32),
                        ang, d1, d2], dim=-1)
    rows = torch.cat([rows, X], dim=-1)  # (B, F, 9)
    head = torch.stack([num_matches.to(f32), med_disp, hom.num_inliers.to(f32),
                        num_inl_best.to(f32), z_comp, mean_angle * (180.0 / math.pi)],
                       dim=-1)
    return rows, torch.cat([head, rvec2, t, E_best.flatten(-2)], dim=-1)  # (B, 21)


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
                  p3p_trials=512, hom_trials=128, refine_iters=30, matcher="pallas",
                  samples=None):
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
        ratio=ratio, max_distance=max_distance, backend=matcher)
    one = [a[None] for a in (matches, valid, kp_prev, n_prev, kp_curr, n_curr, prev_p3d_xyz,
                             prev_has_tri, prev_stable, prev_rvec, prev_tvec, cam_params)]
    rows, scalars = _register_geometry(
        generator, *one, [int(cam_model)], None,
        _slot_thresholds(norm_threshold, 1, kp_prev.device), p3p_trials, hom_trials,
        refine_iters, _one_slot(samples))
    return rows[0], scalars[0]


def _register_geometry(generator, matches, valid, kp_prev, n_prev, kp_curr, n_curr,
                       prev_p3d_xyz, prev_has_tri, prev_stable, prev_rvec, prev_tvec,
                       cam_params, model_codes, code_ids, norm_thresholds, p3p_trials,
                       hom_trials, refine_iters, samples, draw_block=None):
    """register_view after the match, over a leading slot axis (every
    input with a leading B; model_codes the B host codes, code_ids the same
    on the device where they mix models): disparity, homography and P3P
    RANSAC, the pose refinement, track checks and new triangulations.
    draw_block: (lo, n), see draw_samples."""
    num_matches = torch.sum(valid, dim=-1)
    med_disp = matching.median_feature_disparity(kp_prev, kp_curr, matches, valid)

    x_prev = n_prev
    x_curr = _rows(n_curr, matches)
    kp_curr_m = _rows(kp_curr, matches)
    stable = valid & prev_stable & prev_has_tri

    if samples is None:
        samples = draw_samples(generator, [(hom_trials, 4, valid), (p3p_trials, 4, stable)],
                               draw_block)
    s_h, s_p = samples
    nt = norm_thresholds
    hom = ransac(None, x_prev, x_curr, homography.solve_homography,
                 homography.homography_residuals, sample_size=4,
                 num_trials=hom_trials, threshold=nt, valid_mask=valid, samples=s_h)

    num_stable = torch.sum(stable, dim=-1)
    pres = ransac(None, x_curr, prev_p3d_xyz, p3p.solve_p3p_best,
                  p3p.p3p_residuals, sample_size=4, num_trials=p3p_trials,
                  threshold=nt, valid_mask=stable, samples=s_p)
    rvec0 = rvec_from_rotmat(pres.model[:, :3, :3])
    tvec0 = pres.model[:, :3, 3]

    pose, cost = _kernel(_pose_lm, torch.cat([rvec0, tvec0], dim=-1), prev_p3d_xyz,
                         kp_curr_m, pres.inlier_mask, cam_params, model_codes, refine_iters,
                         code_ids)
    # RMS px over refined residuals, like the reference
    # sqrt(summary.final_cost / num_residuals) (bundle_adjustment.cc:222).
    final_cost = torch.sqrt(cost / torch.clamp(pres.num_inliers * 2, min=1))

    rvec, tvec = pose[:, :3], pose[:, 3:]
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
    rows = torch.cat([rows, Xnew], dim=-1)  # (B, F, 12)
    head = torch.stack([num_matches.to(f32), med_disp, hom.num_inliers.to(f32),
                        num_stable.to(f32), pres.num_inliers.to(f32),
                        pres.success.to(f32), final_cost], dim=-1)
    return rows, torch.cat([head, rvec, tvec], dim=-1)  # (B, 13)


def _pose_lm(pose, points, uv, mask, kparams, model_codes, refine_iters, code_ids):
    """The registration step's pose refinement (K4 on the card) in its
    register.pose_lm span: a hand-kernel call that the registration graphs
    cut out (_kernel), so the span times every launch, on replays too."""
    with span("register.pose_lm", "reg_pose_lm_s"):
        return _pose_refine_loop(pose, points, uv, mask, kparams, model_codes, 1.0,
                                 refine_iters, code_ids)


def _derive_chain_state(rows, scalars, prev_xyz, prev_has_tri, prev_len, tri_nt,
                        min_tri_angle, min_track_len):
    """Device copy of the commit's track rules (mapper._register_commit):
    the NEXT frame's anchor state from a register_view result. A track
    continues if its 3-D point reprojects well in the new frame; otherwise
    a new triangulation must pass both reprojection gates, the folded
    angle and positive depths. The three thresholds are numbers or 0-dim
    device tensors (the chain's slices of its packed scalars): the same
    float32 values give the same bits.

    Returns (xyz, has_tri, stable, lens, rvec, tvec) in the new frame's
    row space."""
    F = prev_xyz.shape[0]
    matches = rows[:, 0].long()
    valid = rows[:, 1] > 0.5
    track_err, ep, ec, ang = rows[:, 3], rows[:, 4], rows[:, 5], rows[:, 6]
    dpv, dcv = rows[:, 7], rows[:, 8]
    Xnew = rows[:, 9:12]

    angf = torch.minimum(ang, math.pi - ang)
    cont = valid & prev_has_tri & (track_err < tri_nt)
    new = (valid & ~prev_has_tri & (ep < tri_nt) & (ec < tri_nt)
           & (angf >= min_tri_angle) & (dpv > 0) & (dcv > 0))
    got = cont | new
    src_xyz = torch.where(cont[:, None], prev_xyz,
                          torch.where(got[:, None], Xnew, torch.zeros_like(Xnew)))
    src_len = torch.where(cont, prev_len + 1, torch.full_like(prev_len, 2))
    src_len = torch.where(got, src_len, torch.zeros_like(src_len))

    # Scatter prev-row state into the new frame's rows. Matches are
    # injective on valid rows (mutual cross-check); invalid rows and
    # out-of-range targets go to a spare row F that is dropped, as
    # mode="drop" does in JAX, with no host sync (a boolean index would
    # read its count back).
    keep = valid & (matches >= 0) & (matches < F)
    tgt = (torch.where(keep, matches, F),)

    def scatter(src):
        return src.new_zeros((F + 1,) + src.shape[1:]).index_put_(tgt, src)[:F]

    xyz, has_tri, lens = scatter(src_xyz), scatter(got), scatter(src_len)
    stable = has_tri & (lens >= min_track_len)
    return xyz, has_tri, stable, lens, scalars[7:10], scalars[10:13]


def _chain_frame(matches, valid, kp_prev, n_prev, kp_curr, n_curr, xyz, has_tri, stable, lens,
                 pose, per, rules, s_h, s_p, code, p3p_trials, hom_trials, refine_iters):
    """One chain frame after its match and its draw: register_view's
    geometry against the anchor state (xyz, has_tri, stable, lens, pose
    [rvec | tvec]) and the next frame's anchor state from its result
    (_derive_chain_state). per: the frame's 12 packed scalars [nt | tri_nt
    | cam_model | cam_params(9)], rules [min_tri_angle | min_track_len],
    both device tensors; (s_h, s_p): the frame's (1, T, 4) samples.
    Returns (rows (F, 12), scalars (13,), the next anchor state)."""
    one = [a[None] for a in (matches, valid, kp_prev, n_prev, kp_curr, n_curr, xyz, has_tri,
                             stable, pose[:3], pose[3:], per[3:12])]
    rows, scalars = _register_geometry(None, *one, [code], None, per[0:1], p3p_trials,
                                       hom_trials, refine_iters, (s_h, s_p))
    rows, scalars = rows[0], scalars[0]
    xyz, has_tri, stable, lens, _, _ = _derive_chain_state(rows, scalars, xyz, has_tri, lens,
                                                           per[1], rules[0], rules[1])
    return rows, scalars, (xyz, has_tri, stable, lens, scalars[7:13])


def _graph_chain(device, samples, eager=False):
    """Whether a chain's frame steps run as the registration graphs: on a
    CUDA device, drawing their own samples, unless `eager` (tests). Only
    the chain asks, whose steps are one slot at the provider's capacity:
    the same shapes on every frame of every map. register_view, the batched
    steps (whose shapes change with their slot count) and the mesh's steps
    stay eager."""
    return not eager and torch.device(device).type == "cuda" and samples is None


# The registration graphs: one runner per device, for the process
# (_Stretches "reg"), and each key's static inputs, which every frame step
# copies its inputs into before the runner replays the key's graphs.
_FRAME_RUNNERS = {}
_FRAME_INPUTS = {}


def _graphed_frame(step, code, p3p_trials, hom_trials, refine_iters):
    """_chain_frame(*step, ...) through the registration graphs: graph A
    (the disparity, the gathers, homography and P3P RANSAC, the pose's
    rotation vector) and graph B (the final cost, projections,
    triangulation, the packed rows and scalars, _derive_chain_state),
    with K4 cut out between them (_pose_lm). A key is what fixes the
    graphs' shapes and branches: F, the camera model (K4's code), the trial
    counts, the LM's iterations and the dtype; it is captured on its first
    step in the process and replayed after. The step's inputs (the match,
    the samples, the keypoints, the anchor state, the frame's scalars) are
    copied into the key's static inputs first. A replay overwrites the
    outputs of the capture, which the caller copies before the next step."""
    dev = step[0].device
    key = (step[0].shape[0], code, p3p_trials, hom_trials, refine_iters, step[2].dtype)
    run = _FRAME_RUNNERS.get(dev)
    if run is None:
        run = _FRAME_RUNNERS[dev] = _Stretches(True, dev, "reg")
    inputs = _FRAME_INPUTS.get((dev, key))
    if inputs is None:
        inputs = _FRAME_INPUTS[(dev, key)] = tuple(torch.empty_like(t) for t in step)
    for dst, src in zip(inputs, step):
        dst.copy_(src)
    return run(key, lambda: _chain_frame(*inputs, code, p3p_trials, hom_trials, refine_iters))


def _register_chain_impl(generator, kp_p, d_p, m_p, n_p, feats_k, track_state, scal,
                         ba_poses, ba_points, p3p_trials, hom_trials, refine_iters,
                         samples, matcher, eager=False):
    """K consecutive frame registrations: frame k anchors on track state
    derived on the device from frame k-1's results (`_derive_chain_state`),
    so the host pulls once per K frames instead of once per frame.

    The derived state only steers each frame's registration (which 2D-3D
    pairs feed P3P and the refinement); the committed map still comes from
    the host's own bookkeeping, and the host gates still veto each frame.

    Packed calling convention, as in the JAX package:
      feats_k: K (kp, desc, mask, normalized) tuples of device tensors;
      track_state (F, 7) f32: [xyz(3) | has_tri | stable | track_len |
        ba_row], ba_row mapping a row to the window-BA solve's point rows
        (-1: keep the staged xyz);
      scal (12 + 12K,) f32 on the host: [prev_rvec(3) | prev_tvec(3) |
        ratio | max_dist | min_tri_angle | min_track_len | key_counter |
        anchor_row] + per frame [nt | tri_nt | cam_model | cam_params(9)].
        The key counter is unused (the generator carries the RNG state);
      ba_poses/ba_points (fresh variant): the window-BA solve's output
        tensors; the anchor's pose and 3-D points are read from them.
    The K frame steps run as a Python loop with no host pull between
    frames (the JAX package scans them in one program). Each matches (K1)
    and draws its RANSAC samples, then runs the rest (_chain_frame) with
    its thresholds and camera read from the device copy of `scal`: on a
    CUDA device as the registration graphs (_graphed_frame, _graph_chain),
    eagerly with injected `samples` (an optional list of K per-frame sample
    tuples, see register_view) or `eager` (tests). The owning mapper counts
    reg_eager_steps, one per frame step that ran eagerly on a CUDA device.
    Returns (rows (K, F, 12), scalars (K, 13), has_tri_in (K, F),
    end_state (F, 6), end_pose (6,)): has_tri_in[k] is the anchor has_tri
    state frame k registered against; end_state is the last frame's
    derived [xyz(3) | has_tri | stable | track_len] and end_pose its
    [rvec | tvec], as the JAX package returns them.
    """
    dev = kp_p.device
    K, F = len(feats_k), kp_p.shape[0]
    scal_h = np.asarray(scal, np.float32)
    sync(2)  # the blocking copies of scal and track_state
    scal_d = torch.as_tensor(scal_h, device=dev)
    ratio, max_distance = float(scal_h[6]), float(scal_h[7])
    per = scal_h[12:].reshape(K, 12)
    per_d = scal_d[12:].reshape(K, 12)
    rules = scal_d[8:10]  # min_tri_angle | min_track_len

    state, pose = torch.as_tensor(track_state, device=dev), scal_d[0:6]
    xyz = state[:, :3]
    has_tri = state[:, 3] > 0.5
    stable = state[:, 4] > 0.5
    lens = state[:, 5].long()
    if ba_poses is not None:
        anchor_row = int(scal_h[11])
        if anchor_row >= 0:
            pose = ba_poses[anchor_row]
        xyz_rows = state[:, 6].long()
        xyz = torch.where((xyz_rows >= 0)[:, None],
                          ba_points[torch.clamp(xyz_rows, min=0)], xyz)

    graphed = _graph_chain(dev, samples, eager)
    f32 = torch.float32
    rows_all = torch.empty((K, F, 12), dtype=f32, device=dev)
    scalars_all = torch.empty((K, 13), dtype=f32, device=dev)
    has_tri_in = torch.empty((K, F), dtype=torch.bool, device=dev)
    kp_prev, d_prev, m_prev, n_prev = kp_p, d_p, m_p, n_p
    for k in range(K):
        kp_c, d_c, m_c, n_c = feats_k[k]
        matches, valid = matching.match_features(d_prev, d_c, m_prev, m_c, kp_prev, kp_c,
                                                 ratio=ratio, max_distance=max_distance,
                                                 backend=matcher)
        if samples is None:
            s_k = draw_samples(generator, [(hom_trials, 4, valid[None]),
                                           (p3p_trials, 4, (valid & stable & has_tri)[None])])
        else:
            s_k = _one_slot(samples[k])
        has_tri_in[k] = has_tri
        step = (matches, valid, kp_prev, n_prev, kp_c, n_c, xyz, has_tri, stable, lens, pose,
                per_d[k], rules, *s_k)
        consts = (int(per[k, 2]), p3p_trials, hom_trials, refine_iters)
        if graphed:
            rows, scalars, nxt = _graphed_frame(step, *consts)
        else:
            if dev.type == "cuda":
                count("reg_eager_steps")
            rows, scalars, nxt = _chain_frame(*step, *consts)
        # A replay overwrites the graphs' outputs: the chain keeps copies,
        # and the next frame's step copies the anchor state it reads.
        rows_all[k] = rows
        scalars_all[k] = scalars
        xyz, has_tri, stable, lens, pose = nxt
        kp_prev, d_prev, m_prev, n_prev = kp_c, d_c, m_c, n_c
    end_state = torch.cat([xyz] + [v[:, None].to(xyz.dtype) for v in (has_tri, stable, lens)],
                          dim=1)
    return rows_all, scalars_all, has_tri_in, end_state, pose.clone()


def register_chain(generator, kp_p, d_p, m_p, n_p, feats_k, track_state, scal,
                   p3p_trials=512, hom_trials=128, refine_iters=30, matcher="pallas",
                   samples=None):
    """Chain registration from host-staged anchor state (no window BA to
    read from; see _register_chain_impl's packed calling convention)."""
    return _register_chain_impl(generator, kp_p, d_p, m_p, n_p, feats_k, track_state,
                                scal, None, None, p3p_trials, hom_trials, refine_iters,
                                samples, matcher)


def register_chain_fresh(generator, kp_p, d_p, m_p, n_p, feats_k, track_state, scal,
                         ba_poses, ba_points, p3p_trials=512, hom_trials=128,
                         refine_iters=30, matcher="pallas", samples=None):
    """Chain registration anchored on the latest window-BA solve's output
    (see _register_chain_impl's packed calling convention)."""
    return _register_chain_impl(generator, kp_p, d_p, m_p, n_p, feats_k, track_state,
                                scal, ba_poses, ba_points, p3p_trials, hom_trials,
                                refine_iters, samples, matcher)


def register_view_batch(generator, kpp, desc_p, mask_p, np_, kp_curr, desc_c, mask_c, nc_,
                        xyz, has_tri, stable, prev_rvec, prev_tvec, kparams, model_code,
                        ratio, max_distance, norm_threshold, p3p_trials=500, matcher="pallas",
                        hom_trials=128, refine_iters=30, samples=None, draw_block=None):
    """register_view of one current image against B processed candidates
    (the JAX package's jax.vmap over loop-closure candidates,
    sequential_mapper.cc:1182-1211): the candidates' features, track state
    and poses carry a leading B; the current image's features and camera
    are shared. One batched K1 launch matches every slot and the geometry
    runs batched over the slots. samples: optional (homography
    (B, T_h, 4), p3p (B, T_p, 4)); draw_block: (lo, n), the slots' place
    in a step sharded over ranks (see draw_samples). Returns (rows
    (B, F, 12), scalars (B, 13))."""
    matches, valid = matching.match_features_batched(
        desc_p, desc_c, mask_p, mask_c, kpp, kp_curr, ratio=ratio, max_distance=max_distance,
        backend=matcher)
    B = matches.shape[0]
    return _register_geometry(generator, matches, valid, kpp, np_, kp_curr.expand(B, -1, -1),
                              nc_.expand(B, -1, -1), xyz, has_tri, stable, prev_rvec,
                              prev_tvec, kparams.expand(B, -1), [int(model_code)] * B, None,
                              _slot_thresholds(norm_threshold, B, kpp.device), p3p_trials,
                              hom_trials, refine_iters, samples, draw_block)


def register_view_pairs(generator, kpp, desc_p, mask_p, np_, kpc, desc_c, mask_c, nc_,
                        xyz, has_tri, stable, prev_rvec, prev_tvec, kparams, model_code,
                        ratio, max_distance, norm_threshold, p3p_trials=500, matcher="pallas",
                        hom_trials=128, refine_iters=30, samples=None, draw_block=None):
    """register_view over B full (current, previous) pairs: both sides carry
    a leading B, as do kparams (B, 9); model_code and norm_threshold are
    one value per slot (the back-fill and closure-sweep pairs,
    mapper.cc:221-299). One batched K1 launch matches every slot and the
    geometry runs batched over the slots; slots of different camera models
    refine their poses under their own model; draw_block as in
    register_view_batch. Returns (rows (B, F, 12), scalars (B, 13))."""
    matches, valid = matching.match_features_batched(
        desc_p, desc_c, mask_p, mask_c, kpp, kpc, ratio=ratio, max_distance=max_distance,
        backend=matcher)
    B = matches.shape[0]
    codes = [int(c) for c in model_code]
    # One host->device copy carries the thresholds and, where the slots mix
    # camera models, their codes (small integers, exact in float32).
    sync()  # a blocking copy
    per_slot = torch.as_tensor(np.asarray([norm_threshold, codes], np.float32),
                               device=kpp.device)
    code_ids = per_slot[1] if len(set(codes)) > 1 else None
    return _register_geometry(generator, matches, valid, kpp, np_, kpc, nc_, xyz, has_tri,
                              stable, prev_rvec, prev_tvec, kparams, codes, code_ids,
                              per_slot[0], p3p_trials, hom_trials, refine_iters, samples,
                              draw_block)


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
