"""End-to-end mapping pipeline — counterpart of reference src/mapper.cc.

Port of mavmap_tpu/sfm/pipeline.py (mapper.cc:563-1257): the sequential
loop (the batched initial-pair search, chained registration with one
deferred window bundle adjustment per chain and periodic loop detection,
the per-frame fallback with the loop-detection rescue and sub-map restart)
or segment-parallel mapping (parallel_segments > 1: overlapping segments,
one mapper each, their chains dispatched in turn), then the back-fill of
skipped frames, the global bundle adjustment, the merge of the sub-maps
into one (merge_mappers, SequentialMapper.merge; mapper.cc:302-379), the
final closure sweeps, ground-control-point geo-registration and the
point-cloud filter; IMU rotation priors in every bundle adjustment, map
checkpoints with resume, and the debug dumps. Every mapping step runs on
the device given to run_pipeline.
With mesh_devices > 1 the run spans that many torch.distributed ranks
(parallel/), each mapping alike: the batched fan-outs split their slots
over the ranks, the global bundle adjustment is sharded by 3-D point, and
rank 0 alone writes checkpoints and debug dumps.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ba import BA_POSE_FIXED, BA_POSE_FIXED_X, BAOptions, build_problem, bundle_adjust
from ..utils.device import resolve_device
from ..utils.timer import span
from .mapper import SequentialMapper
from .options import SequentialMapperOptions


@dataclass
class PipelineOptions:
    """CLI-level options, the JAX package's fields and defaults (names
    mirror mapper.cc flags, SURVEY §5.6)."""

    start_image_idx: int = 0
    end_image_idx: int = -1
    first_image_idx: int = -1   # initial pair: first image (default start)
    second_image_idx: int = -1  # initial pair: second image (default auto)
    max_subsequent_trials: int = 30
    failure_skip_images: int = 1      # restart offset for a new sub-map
    failure_max_image_dist: int = 10  # accepted for parity; unused in the
                                      # reference too (declared, never read)
    local_ba_window_size: int = 8
    loop_detection: bool = True
    loop_detection_period: int = 20
    loop_detection_num_images: int = 30
    loop_detection_num_nh_images: int = 15
    loop_detection_nh_dist: int = 30
    merge: bool = True
    merge_num_skip_images: int = 5
    min_track_len: int = 3
    final_cost_threshold: float = 2.0
    init_max_homography_inliers: float = 0.7
    max_homography_inliers: float = 0.8
    init_min_disparity: float = 0.0
    min_disparity: float = 0.0
    match_max_ratio: float = 0.9
    match_max_distance: float = -1.0
    ransac_min_inlier_threshold: float = 30
    ransac_min_inlier_stop: float = 0.6  # parity; fixed-trial RANSAC ignores
    ransac_max_reproj_error: float = 4.0
    tri_max_reproj_error: float = 4.0
    init_tri_min_angle: float = 10.0
    tri_min_angle: float = 1.0
    loss_scale_factor: float = 1.0
    essential_ransac_trials: int = 512
    p3p_ransac_trials: int = 512
    constrain_rotation: bool = False
    constrain_rotation_weight: float = 0.0
    use_control_points: bool = False
    filter_max_error: float = 0.0
    process_prev_prev: bool = False
    ba_local_max_iters: int = 15
    ba_global_max_iters: int = 50
    # LM relative-cost-decrease stop of the global solves (Ceres
    # function_tolerance analog; window solves keep the BAOptions default).
    ba_function_tolerance: float = 1e-4
    verbose: bool = True
    # The reference refines intrinsics in every bundle adjustment by default
    # (mapper.cc:878-885); the initial two-view bundle keeps them fixed
    # (mapper.cc:1059).
    refine_camera_params: bool = True
    local_ba_refine_camera_params: bool = True
    matcher_backend: str = "auto"  # auto | xla | pallas (SequentialMapper._matcher_backend)
    # Register `chain_len` consecutive frames per device step, frame k
    # anchored on the state derived on the device from frame k-1: one pull
    # per chain; the host gates still veto each frame and failures fall back
    # to the per-frame path. One window solve per chain.
    chain_frames: bool = True
    chain_len: int = 4
    # Segment-parallel mapping: split [start, end] into this many segments
    # that overlap by segment_overlap frames (at least 3, what the merge
    # needs), map each with its own mapper, their chains dispatched in turn,
    # and merge the sub-maps in the post-pass.
    parallel_segments: int = 1
    segment_overlap: int = 4
    # Post-pass closure sweeps (beyond the reference): after the first
    # global BA, query every `final_closure_step`-th registered image for
    # non-neighborhood loop closures (batched registration) and re-run the
    # global BA; up to `final_closure_sweeps` rounds or until one adds none.
    final_closure_sweeps: int = 1
    final_closure_step: int = 2
    # Ranks (beyond the reference, which is one process): 1 = this process
    # alone, N > 1 = the N ranks of an initialised torch.distributed group
    # (parallel.launch, the CLI's --mesh, or torchrun) whose global BA is
    # sharded by point and whose batched fan-outs split their slots; 0 = one
    # rank per visible CUDA device (1 on the CPU).
    mesh_devices: int = 1
    # Map checkpoints (beyond the reference): every `checkpoint_period`
    # committed frames the main mapper's state (map and loop-retrieval
    # database) is written to `checkpoint_path`; run_pipeline(resume_from=)
    # continues the sequential loop from the last checkpointed frame.
    checkpoint_period: int = 0
    checkpoint_path: str = ""
    debug: bool = False             # per-frame gate diagnostics (and dumps, with a path)
    debug_path: str = ""


def _pipeline_mesh(opts: PipelineOptions, device):
    """The run's parallel.Mesh, or None for one process: mesh_devices ranks
    (0: one per visible CUDA device, 1 on the CPU), which must be the ranks
    of the initialised torch.distributed group."""
    from ..parallel.multihost import global_mesh

    n = opts.mesh_devices
    if n == 0:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 0:
        raise ValueError(f"run_pipeline: mesh_devices={opts.mesh_devices}")
    if n == 1:
        return None
    mesh = global_mesh(device=device)
    if mesh.size != n:
        raise RuntimeError(
            f"run_pipeline: mesh_devices={n} needs a torch.distributed group of {n} ranks, "
            f"this process has {mesh.size}: run it in every rank of "
            f"mavmap_tpu_torch.parallel.launch(fn, {n}, device), under "
            f"`torchrun --nproc-per-node {n}` after parallel.init_multihost(), or use the "
            f"CLI's --mesh {n}")
    return mesh


def _mapper_options(opts: PipelineOptions, initial=False, num_proc=1000000):
    # Bootstrap ramp: the reference drops min_track_len to 2 until more than
    # 2 * min_track_len images are processed (mapper.cc:195,236,765-770),
    # or the 3rd image could never find stable tracks.
    mtl = 2 if (initial or num_proc <= 2 * opts.min_track_len) else opts.min_track_len
    return SequentialMapperOptions(
        final_cost_threshold=opts.final_cost_threshold,
        tri_min_angle=opts.init_tri_min_angle if initial else opts.tri_min_angle,
        max_homography_inliers=(opts.init_max_homography_inliers if initial
                                else opts.max_homography_inliers),
        min_disparity=opts.init_min_disparity if initial else opts.min_disparity,
        match_max_ratio=opts.match_max_ratio,
        match_max_distance=opts.match_max_distance,
        ransac_min_inlier_threshold=opts.ransac_min_inlier_threshold,
        ransac_min_inlier_stop=opts.ransac_min_inlier_stop,
        ransac_max_reproj_error=opts.ransac_max_reproj_error,
        tri_max_reproj_error=opts.tri_max_reproj_error,
        essential_ransac_trials=opts.essential_ransac_trials,
        p3p_ransac_trials=opts.p3p_ransac_trials,
        loop_detection_num_images=opts.loop_detection_num_images,
        matcher_backend=opts.matcher_backend,
        min_track_len=mtl,
    )


@dataclass
class PipelineResult:
    mappers: list
    records: list = None
    control_point_results: list = None
    timings: dict = None  # per-stage wall seconds

    @property
    def main_mapper(self):
        return max(self.mappers, key=lambda m: m.num_proc_images)

    def num_registered(self):
        return sum(m.num_proc_images for m in self.mappers)


def _local_ba(mapper, opts: PipelineOptions, rot_priors=None, drop_last=0):
    """The window bundle adjustment after a commit: the last
    local_ba_window_size registered images, the first two fixed, deferred
    onto the next register step (the solve lands one step later); with the
    IMU priors under constrain_rotation."""
    reg = sorted(mapper.image_idx_to_id.keys(), key=lambda i: mapper.image_idx_to_id[i])
    if drop_last:
        reg = reg[:-drop_last]
    window = reg[-opts.local_ba_window_size:]
    if len(window) <= 2:
        return
    mapper.adjust_bundle(
        window[2:], window[:2],
        ba_options=BAOptions(max_num_iterations=opts.ba_local_max_iters,
                             min_track_len=opts.min_track_len,
                             loss_scale_factor=opts.loss_scale_factor,
                             refine_camera_params=opts.local_ba_refine_camera_params),
        rot_priors=rot_priors if opts.constrain_rotation else None,
        rot_prior_weight=opts.constrain_rotation_weight, async_=True, defer=True)


def _final_closure_sweeps(mapper, opts: PipelineOptions, rot_priors=None):
    """Post-global-BA closure densification (see PipelineOptions). Returns
    the number of closures added over all rounds."""
    if mapper.loop_detector is None or mapper.num_proc_images < 3:
        return 0
    total = 0
    for _ in range(opts.final_closure_sweeps):
        seq = _mapper_options(opts, num_proc=mapper.num_proc_images)
        reg = sorted(mapper.image_idx_to_id.keys())
        # Batched over every query of the sweep: retrieval and the pair
        # pre-gate pick the candidate pairs, one chunked batch_register_pairs
        # pass commits the closures.
        added = mapper.batch_detect_closures(
            reg[:: max(opts.final_closure_step, 1)], num_images=opts.loop_detection_num_images,
            nh_distance=opts.loop_detection_nh_dist, options=seq, verbose=False)
        if added == 0:
            break
        if opts.verbose:
            print(f"Closure sweep added {added} closures; re-running global BA")
        # Re-BA with the intrinsics held at the pre-sweep solution: the global
        # BA before this sweep already converged self-calibration, and the
        # closure commits only add correspondences and merge tracks.
        _global_ba(mapper, opts, rot_priors, refine_cams=False)
        total += added
    return total


def _global_ba(mapper, opts: PipelineOptions, rot_priors=None, update_errors=False,
               max_iters=None, refine_cams=None):
    info = mapper.adjust_global_bundle(
        BAOptions(max_num_iterations=max_iters if max_iters is not None
                  else opts.ba_global_max_iters,
                  function_tolerance=opts.ba_function_tolerance,
                  min_track_len=opts.min_track_len,
                  loss_scale_factor=opts.loss_scale_factor,
                  refine_camera_params=(opts.refine_camera_params if refine_cams is None
                                        else refine_cams),
                  update_point3D_errors=update_errors),
        rot_priors=rot_priors if opts.constrain_rotation else None,
        rot_prior_weight=opts.constrain_rotation_weight)
    mapper._count("global_ba_runs")
    if info:
        mapper._count("global_ba_iters", int(info.get("iterations", 0)))
    return info


def process_remaining_images(mapper, start_idx, end_idx, opts: PipelineOptions):
    """Back-fill skipped frames against their nearest processed neighbors
    (reference mapper.cc:221-299). Every (skipped frame, neighbor) pair of a
    sweep registers in one batched call; sweeps repeat while frames keep
    landing (a filled frame is a neighbor in the next sweep, like the
    reference's incremental 'processed' update). Returns the frames filled."""
    seq_opts = _mapper_options(opts)
    num = 0
    for _ in range(max(end_idx - start_idx + 1, 1)):  # one frame per sweep at worst
        processed = sorted(mapper.image_idx_to_id.keys())
        if not processed:
            return num
        pairs = []
        for idx in range(start_idx, end_idx + 1):
            if mapper.is_image_processed(idx):
                continue
            below = [p for p in processed if p < idx]
            above = [p for p in processed if p > idx]
            if below:
                pairs.append((idx, below[-1]))
            if above:
                pairs.append((idx, above[0]))
        if not pairs:
            break
        got = mapper.batch_register_pairs(pairs, seq_opts)
        for (idx, cand), ok in zip(pairs, got):
            if ok and opts.verbose:
                print(f"Processed remaining image #{idx} against #{cand}")
        # A frame may appear in two pairs (below and above): count it once.
        filled = {idx for (idx, _), ok in zip(pairs, got) if ok}
        num += len(filled)
        if not filled:
            break
    return num


def merge_mappers(mappers, opts: PipelineOptions):
    """Greedy pairwise merge, always the smaller map into the larger
    (reference mapper.cc:302-379). Returns the mappers left."""
    seq_opts = _mapper_options(opts)
    mappers = list(mappers)
    merged = True
    while merged and len(mappers) > 1:
        merged = False
        mappers.sort(key=lambda m: -m.num_proc_images)
        for i in range(len(mappers)):
            for j in range(len(mappers) - 1, i, -1):
                if mappers[i].merge(mappers[j], num_similar_images=opts.loop_detection_num_images,
                                    num_skip_images=opts.merge_num_skip_images,
                                    options=seq_opts, verbose=opts.verbose):
                    del mappers[j]
                    merged = True
            if merged:
                break
    return mappers


def filter_point_cloud(mapper, max_error):
    """Delete the 3-D points whose mean reprojection error exceeds
    max_error (reference mapper.cc:382-402). Needs the point errors of a
    bundle adjustment run with update_point3D_errors. Returns the number
    deleted."""
    doomed = [pid for pid in list(mapper.store.tracks.keys())
              if mapper.store.point3D_valid[pid] and mapper.store.point3D_error[pid] > max_error]
    for pid in doomed:
        mapper.store.delete_point3D(pid)
    return len(doomed)


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def apply_control_points(mapper, control_points, opts: PipelineOptions):
    """Geo-registration with ground control points (reference
    mapper.cc:405-560):

    1. triangulate each control point from its observations in processed
       images (multiview DLT with the current poses);
    2. fit the model -> GCP-frame similarity (Umeyama) to the fixed control
       points, when there are at least 3, and move every pose and point;
    3. a global bundle adjustment with every triangulated control point
       appended, the fixed ones pinned at their coordinates (with at least 3
       fixed ones they give the gauge; else the first pose and the second's
       x-translation are fixed as usual).

    The small host steps (DLT, similarity) run in float32 on the CPU, as
    the JAX version runs them; the bundle adjustment on the mapper's
    device. Returns [(cp, est_xyz or None, track_len, mean_residual)]."""
    from ..models import camera as cam
    from ..ops.projection import compose_proj_matrix
    from ..ops.similarity import solve_umeyama, transform_points, transform_pose
    from ..ops.triangulation import triangulate_points_multiview

    estimates = []
    for cp in control_points:
        projs, obs_n, obs_px, imgs = [], [], [], []
        for (image_idx, x, y) in cp.points2D:
            if not mapper.is_image_processed(image_idx):
                continue
            rv, tv = mapper.store.get_pose(mapper.image_idx_to_id[image_idx])
            projs.append(compose_proj_matrix(_f32(rv), _f32(tv)).numpy())
            ci = mapper.image_cameras[image_idx]
            obs_n.append(np.asarray(cam.image2normalized_np(
                np.asarray([x, y], np.float32), int(mapper.cam_models[ci]),
                mapper.cam_params[ci])))
            obs_px.append((x, y))
            imgs.append(image_idx)
        if len(projs) < 2:
            estimates.append(None)
            continue
        X = triangulate_points_multiview(_f32(np.stack(projs)), _f32(np.stack(obs_n)),
                                         torch.ones(len(projs), dtype=torch.bool))
        estimates.append((X.numpy(), imgs, obs_px, obs_n))

    fixed_src = [est[0] for cp, est in zip(control_points, estimates)
                 if cp.fixed and est is not None]
    fixed_dst = [cp.xyz for cp, est in zip(control_points, estimates)
                 if cp.fixed and est is not None]
    if len(fixed_src) >= 3:
        T = solve_umeyama(_f32(np.stack(fixed_src)), _f32(np.stack(fixed_dst)))
        for iid in range(mapper.store.num_images):
            if mapper.store.image_registered[iid]:
                rv, tv = mapper.store.get_pose(iid)
                nrv, ntv = transform_pose(T, _f32(rv), _f32(tv))
                mapper.store.image_rvecs[iid] = nrv.numpy()
                mapper.store.image_tvecs[iid] = ntv.numpy()
        valid = mapper.store.point3D_valid
        mapper.store.point3D_xyz[valid] = transform_points(
            T, _f32(mapper.store.point3D_xyz[valid])).numpy()
        for k, est in enumerate(estimates):
            if est is not None:
                X, imgs, obs_px, obs_n = est
                estimates[k] = (transform_points(T, _f32(X)).numpy(), imgs, obs_px, obs_n)

    # The global problem with the control points' observations appended.
    (image_ids, poses, point_ids, points, obs_image, obs_point, obs_cam,
     obs_xy) = mapper.ba_problem_arrays(min_track_len=opts.min_track_len)
    id_to_row = {iid: k for k, iid in enumerate(image_ids)}
    n_pts = len(points)
    extra_pts, extra_fixed = [], []
    extra_img, extra_pt, extra_cam, extra_xy = [], [], [], []
    gcp_rows = []
    for cp, est in zip(control_points, estimates):
        if est is None:
            gcp_rows.append(None)
            continue
        X, imgs, obs_px, _ = est
        row = n_pts + len(extra_pts)
        gcp_rows.append(row)
        extra_pts.append(cp.xyz if cp.fixed else X)
        extra_fixed.append(cp.fixed)
        for image_idx, (x, y) in zip(imgs, obs_px):
            extra_img.append(id_to_row[mapper.image_idx_to_id[image_idx]])
            extra_pt.append(row)
            extra_cam.append(mapper._store_cam_ids[int(mapper.image_cameras[image_idx])])
            extra_xy.append((x, y))
    if extra_pts:
        points = np.concatenate([points, np.asarray(extra_pts, np.float32)])
        obs_image = np.concatenate([obs_image, np.asarray(extra_img, np.int32)])
        obs_point = np.concatenate([obs_point, np.asarray(extra_pt, np.int32)])
        obs_cam = np.concatenate([obs_cam, np.asarray(extra_cam, np.int32)])
        obs_xy = np.concatenate([obs_xy, np.asarray(extra_xy, np.float32)])
    point_fixed = np.zeros(len(points), bool)
    point_fixed[n_pts:] = extra_fixed
    if sum(extra_fixed) >= 3:
        states = [0] * len(image_ids)
    else:
        states = [BA_POSE_FIXED if k < 1 else 0 for k in range(len(image_ids))]
        if len(states) > 1:
            states[1] = BA_POSE_FIXED_X
    prob = build_problem(poses, points, mapper.store.camera_params.astype(np.float32),
                         mapper.store.camera_models, obs_image, obs_point, obs_cam, obs_xy,
                         pose_states=states, point_fixed=point_fixed, bucket=True)
    new_poses, new_points, info = bundle_adjust(
        prob, BAOptions(max_num_iterations=opts.ba_global_max_iters,
                        update_point3D_errors=True, min_track_len=2), device=mapper.device)
    errors = info["point_errors"]
    mapper.apply_ba_result(image_ids, new_poses, point_ids, new_points[:n_pts], errors[:n_pts])
    return [(cp, None, 0, -1.0) if row is None else
            (cp, new_points[row], int((obs_point == row).sum()), float(errors[row]))
            for cp, row in zip(control_points, gcp_rows)]


class _Segment:
    """Cursor state of one segment in segment-parallel mapping."""

    def __init__(self, mapper, lo, hi):
        self.mapper = mapper
        self.lo = lo
        self.hi = hi
        self.first = lo
        self.idx = lo
        self.prev = None
        self.init_j = lo + 1
        self.init_chunk = 2
        self.num_skipped = 0
        self.count_since_loop = 0
        self.phase = "init"  # init | seq | done
        self.token = None


def _run_segments_parallel(new_mapper, start, end, opts: PipelineOptions, rot_priors):
    """Segment-parallel mapping (PipelineOptions.parallel_segments).

    Splits [start, end] into S overlapping segments, one mapper each, and
    goes round the segments: complete the chain a segment dispatched on the
    last round (chain_complete: pull, gates, commits), then dispatch its
    next one (chain_dispatch). Failures go as in the sequential loop: gates,
    skip, rescue by loop detection, sub-map restart inside the segment.
    The order is the JAX version's, which overlaps one segment's pull with
    the others' device work on a remote TPU; here every step runs in order
    on one stream, and no thread is added.

    Returns (mappers, ranges): one or more mappers per segment, and each
    mapper's segment range (lo, hi), to which the pre-merge back-fill is
    clamped."""
    S = opts.parallel_segments
    step = int(np.ceil((end - start + 1) / S))
    # The merge aligns sub-maps on common images and needs at least 3 of
    # them (mapper.merge, reference sequential_mapper.cc:1311-1315); a
    # smaller overlap would give sub-maps that cannot merge.
    overlap = max(opts.segment_overlap, 3)
    if opts.segment_overlap < 3 and opts.verbose:
        print(f"segment-overlap {opts.segment_overlap} raised to 3 "
              f"(merge needs >= 3 common images)")
    mappers, ranges, segs = [], {}, []
    for s in range(S):
        lo = start + s * step
        if lo > end:
            break
        hi = min(start + (s + 1) * step - 1, end)
        lo_eff = max(start, lo - overlap) if s > 0 else lo
        if hi - lo_eff < 1:
            continue
        m = new_mapper(s)
        ranges[m] = (lo_eff, hi)
        mappers.append(m)
        segs.append(_Segment(m, lo_eff, hi))

    init_opts = _mapper_options(opts, initial=True)

    def restart_submap(seg):
        # In-segment sub-map restart (mapper.cc:1150-1173).
        if opts.verbose:
            print(f"Starting new sub-map at image #{seg.idx}")
        m = new_mapper(len(mappers))
        ranges[m] = (seg.lo, seg.hi)
        mappers.append(m)
        seg.mapper = m
        seg.idx += max(opts.failure_skip_images - 1, 0)
        seg.first = seg.idx
        seg.init_j = seg.first + 1
        seg.init_chunk = 2
        seg.num_skipped = 0
        seg.prev = None
        seg.phase = "init" if seg.first < seg.hi else "done"

    def advance_init(seg):
        # One batched initial-pair attempt per visit (mapper.cc:1027-1062).
        if seg.init_j > seg.hi:
            seg.first += 1
            if seg.first >= seg.hi:
                seg.phase = "done"
                return
            seg.init_j = seg.first + 1
            seg.init_chunk = 2
            return
        cands = list(range(seg.init_j, min(seg.init_j + seg.init_chunk, seg.hi + 1)))
        sec = seg.mapper.process_initial_batch(seg.first, cands, init_opts)
        if sec >= 0:
            if opts.verbose:
                print(f"Initialized with pair (#{seg.first}, #{sec})")
            seg.mapper.adjust_bundle([], [seg.first], [sec], ba_options=BAOptions(
                max_num_iterations=opts.ba_local_max_iters, min_track_len=2))
            seg.prev = sec
            seg.idx = sec + 1
            seg.phase = "seq" if seg.idx <= seg.hi else "done"
        else:
            seg.init_j += len(cands)
            seg.init_chunk = 8

    def after_commit(seg, committed_last, n_committed, seq_opts):
        seg.count_since_loop += n_committed
        seg.prev = committed_last
        seg.num_skipped = 0
        seg.idx = committed_last + 1
        _local_ba(seg.mapper, opts, rot_priors)
        if opts.loop_detection and seg.count_since_loop >= opts.loop_detection_period:
            seg.mapper.detect_loop(seg.prev, num_images=opts.loop_detection_num_images,
                                   num_nh_images=opts.loop_detection_num_nh_images,
                                   nh_distance=opts.loop_detection_nh_dist, options=seq_opts,
                                   verbose=opts.verbose)
            seg.count_since_loop = 0
        if seg.idx > seg.hi:
            seg.phase = "done"

    def sync_step(seg, seq_opts):
        # The per-frame fallback for one frame: process, rescue, skip, sub-map
        # restart (mapper.cc:1088-1173).
        m = seg.mapper
        success = m.process(seg.idx, seg.prev, seq_opts)
        if not success and opts.loop_detection:
            success = m.detect_loop(seg.idx, num_images=opts.loop_detection_num_images,
                                    num_nh_images=1, nh_distance=1 << 30, options=seq_opts) > 0
        if success:
            if opts.verbose:
                print(f"Processed image #{seg.idx} (points3D={m.store.num_points3D})")
            after_commit(seg, seg.idx, 1, seq_opts)
        else:
            seg.num_skipped += 1
            if seg.num_skipped >= opts.max_subsequent_trials:
                restart_submap(seg)
            else:
                seg.idx += 1
                if seg.idx > seg.hi:
                    seg.phase = "done"

    def try_dispatch(seg):
        m = seg.mapper
        seq_opts = _mapper_options(opts, num_proc=m.num_proc_images)
        if (opts.chain_frames and not opts.process_prev_prev and opts.chain_len >= 2
                and m.num_proc_images >= 2 and seg.prev is not None
                and m.is_image_processed(seg.prev)):
            chain = []
            for j in range(seg.idx, min(seg.idx + opts.chain_len, seg.hi + 1)):
                if m.is_image_processed(j):
                    break
                chain.append(j)
            if len(chain) >= 2:
                seg.token = (m.chain_dispatch(chain, seg.prev, seq_opts, pad_to=opts.chain_len),
                             chain, seq_opts)
                return
        # Not chainable: one per-frame step now.
        sync_step(seg, seq_opts)

    live = list(segs)
    while live:
        for seg in list(live):
            if seg.token is not None:
                token, chain, seq_opts = seg.token
                seg.token = None
                oks = seg.mapper.chain_complete(token)
                committed = sum(oks)
                if committed:
                    if opts.verbose:
                        for j in chain[:committed]:
                            print(f"Processed image #{j} "
                                  f"(points3D={seg.mapper.store.num_points3D})")
                    after_commit(seg, chain[committed - 1], committed, seq_opts)
                else:
                    sync_step(seg, seq_opts)
            if seg.phase == "init":
                advance_init(seg)
            if seg.phase == "seq":
                try_dispatch(seg)
            if seg.phase == "done" and seg.token is None:
                seg.mapper.flush_ba()
                live.remove(seg)
    return mappers, ranges


def run_pipeline(image_cameras, cam_models, cam_params, provider, opts: PipelineOptions = None,
                 voc_tree=None, rot_priors=None, control_points=None, resume_from=None,
                 device="cuda"):
    """The full mapping run (reference mapper.cc main loop, :1014-1245) on
    `device` (default the CUDA card: it raises where there is none; tests
    pass "cpu"). voc_tree: a loop.VocTree, enabling loop detection and the
    closure sweeps. Sub-map k's mapper draws its RANSAC samples from a
    generator seeded k, as the JAX package seeds its keys (segment s starts
    with mapper s; a restart takes the next free number). rot_priors:
    {image_idx: prior rvec}, used under constrain_rotation; control_points:
    utils.io.ControlPoint list, used under use_control_points. With
    `merge` (the default) the post-pass merges the sub-maps into one.

    resume_from: a map checkpoint (utils/checkpoint.save_map), restored
    with its loop-retrieval database into the first mapper; the sequential
    loop continues from the frame after the last processed one (also with
    parallel_segments > 1), then the usual post-pass. Returns a
    PipelineResult with per-stage wall seconds in `timings`.

    mesh_devices > 1: call this in every rank of a torch.distributed group
    of that many ranks (see PipelineOptions.mesh_devices), each with its
    rank's device (the mesh's); every rank returns the same map."""
    from ..loop import LoopDetector

    opts = opts or PipelineOptions()
    device = resolve_device(device, "run_pipeline")
    mesh = _pipeline_mesh(opts, device)
    if mesh is not None:
        device = mesh.device
        if mesh.rank != 0:  # rank 0 alone prints and dumps
            opts = replace(opts, verbose=False, debug=False)
    num_images = len(image_cameras)
    start = opts.start_image_idx
    end = opts.end_image_idx if opts.end_image_idx >= 0 else num_images - 1
    init_opts = _mapper_options(opts, initial=True)
    debug = opts.debug

    dumper = None
    if opts.debug and opts.debug_path:
        from .debug import DebugDumper

        dumper = DebugDumper(opts.debug_path, image_reader=getattr(provider, "image", None))

    def new_mapper(k):
        det = LoopDetector(voc_tree) if (voc_tree is not None and opts.loop_detection) else None
        m = SequentialMapper(image_cameras, cam_models, cam_params, provider, device=device,
                             seed=k, loop_detector=det, mesh=mesh)
        m.debug_dumper = dumper
        return m

    mappers = [new_mapper(0)]
    mapper = mappers[0]
    idx = first_idx = opts.first_image_idx if opts.first_image_idx >= 0 else start
    prev_idx = None
    num_skipped = 0
    count_since_loop = 0

    if resume_from:
        from ..utils.checkpoint import load_map

        load_map(mapper, resume_from)
        processed = sorted(mapper.image_idx_to_id.keys())
        if processed:
            first_idx, prev_idx = processed[0], processed[-1]
            idx = prev_idx + 1
            if opts.verbose:
                print(f"Resumed {len(processed)} registered images from {resume_from}; "
                      f"continuing at #{idx}")

    # Periodic checkpoints: after every `checkpoint_period` frames newly
    # committed to the current mapper. A checkpoint lands the deferred
    # window solves, so every rank keeps the schedule and rank 0 alone writes.
    ckpt_last = [mapper.num_proc_images]

    def maybe_checkpoint(m):
        if opts.checkpoint_period <= 0 or not opts.checkpoint_path:
            return
        if m.num_proc_images - ckpt_last[0] >= opts.checkpoint_period:
            from ..utils.checkpoint import save_map

            if mesh is None or mesh.rank == 0:
                save_map(m, opts.checkpoint_path)
            else:
                m.flush_ba()
            ckpt_last[0] = m.num_proc_images

    # Per-stage wall clocks (the reference prints per-frame and total
    # timings, mapper.cc:1181,1252-1257).
    timings = {}

    def stage(name):
        return span("pipeline." + name, name, totals=timings)

    def detect(at, **kw):
        with span("loop.detect", "seq_detect_s", mapper):
            return mapper.detect_loop(at, num_images=opts.loop_detection_num_images,
                                      options=seq_opts, **kw)

    def periodic_detect(at):
        nonlocal count_since_loop
        if opts.loop_detection and count_since_loop >= opts.loop_detection_period:
            detect(at, num_nh_images=opts.loop_detection_num_nh_images,
                   nh_distance=opts.loop_detection_nh_dist, verbose=opts.verbose)
            count_since_loop = 0

    with stage("sequential_loop"):
        segment_range = {}  # mapper -> its segment (lo, hi) in segment-parallel mode
        if resume_from and opts.parallel_segments > 1 and opts.verbose:
            print("Resume continues sequentially (segment-parallel mapping restarts segments "
                  "from scratch)")
        if opts.parallel_segments > 1 and not resume_from:
            # Segment-parallel mapping replaces the sequential loop; the post-pass
            # below (back-fill, global BA, merge, closure sweeps) joins the
            # segments' sub-maps into one map.
            mappers, segment_range = _run_segments_parallel(new_mapper, start, end, opts,
                                                            rot_priors)
            idx = end + 1
        while idx <= end:
            if mapper.num_proc_images == 0:
                # Initial-pair search (mapper.cc:1027-1062).
                second = opts.second_image_idx if (
                    opts.second_image_idx >= 0 and len(mappers) == 1) else -1
                success = False
                if second >= 0:
                    success = mapper.process_initial(first_idx, second, init_opts, debug=debug)
                    idx = max(first_idx, second)
                else:
                    # Batched sweeps of candidate seconds (the reference tries one
                    # sequential process_initial per candidate, mapper.cc:1027-1036).
                    j = first_idx + 1
                    chunk = 2  # almost always succeeds at once; then widen
                    while j <= end:
                        cands = list(range(j, min(j + chunk, end + 1)))
                        sec = mapper.process_initial_batch(first_idx, cands, init_opts, debug=debug)
                        if sec >= 0:
                            success = True
                            idx = sec
                            break
                        j += len(cands)
                        chunk = 8
                if not success:
                    if opts.verbose:
                        print(f"Failed to find initial pair from #{first_idx}")
                    # The restart frame itself may be bad: advance it and retry
                    # (beyond reference mapper.cc, which pins a sub-map's first
                    # image).
                    first_idx += 1
                    idx = first_idx + 1
                    if first_idx >= end:
                        break
                    continue
                if opts.verbose:
                    print(f"Initialized with pair (#{first_idx}, #{idx})")
                # Initial bundle (mapper.cc:1050-1062).
                mapper.adjust_bundle([], [first_idx], [idx], ba_options=BAOptions(
                    max_num_iterations=opts.ba_local_max_iters, min_track_len=2))
                prev_idx = idx
                idx += 1
                continue

            # Sequential step (mapper.cc:1088-1148).
            seq_opts = _mapper_options(opts, num_proc=mapper.num_proc_images)
            chain = []
            # Chain gate num_proc_images >= 2 (not the min_track_len ramp, which
            # _mapper_options already applies; the host gates veto immature
            # chains frame by frame).
            if (opts.chain_frames and not opts.process_prev_prev and opts.chain_len >= 2
                    and mapper.num_proc_images >= 2 and prev_idx is not None
                    and mapper.is_image_processed(prev_idx)):
                for j in range(idx, min(idx + opts.chain_len, end + 1)):
                    if mapper.is_image_processed(j):
                        break
                    chain.append(j)
            if len(chain) >= 2:
                # seq_chain_s: the chain step, without the bookkeeping of
                # the frames it commits.
                with span("loop.chain", "seq_chain_s", mapper):
                    oks = mapper.process_chain_k(chain, prev_idx, seq_opts,
                                                 pad_to=opts.chain_len, debug=debug)
                committed = sum(oks)
                if committed:
                    for j in chain[:committed]:
                        if opts.verbose:
                            print(f"Processed image #{j} "
                                  f"(points3D={mapper.store.num_points3D})")
                    count_since_loop += committed
                    prev_idx = chain[committed - 1]
                    num_skipped = 0
                    idx = prev_idx + 1
                    # One window solve per chain, deferred onto the next
                    # register step: the window covers every frame the chain
                    # added.
                    with span("loop.local_ba", "seq_localba_s", mapper):
                        _local_ba(mapper, opts, rot_priors)
                    periodic_detect(prev_idx)
                    maybe_checkpoint(mapper)
                    continue
                # The chain's first frame failed its gates: the per-frame path
                # below takes it (rescue, skip, sub-map restart).
            success = mapper.process(idx, prev_idx, seq_opts, debug=debug)
            if not success and opts.loop_detection:
                # Rescue by loop detection: every candidate counts as
                # neighborhood and one closure is enough (mapper.cc:1107-1108:
                # detect_loop(idx, 30, 1, SIZE_MAX)).
                success = detect(idx, num_nh_images=1, nh_distance=1 << 30) > 0
            if success:
                if opts.verbose:
                    print(f"Processed image #{idx} (points3D={mapper.store.num_points3D})")
                if opts.process_prev_prev and prev_idx is not None:
                    prev_reg = sorted(mapper.image_idx_to_id.keys())
                    if len(prev_reg) >= 3:
                        # The reference disables the homography gate for the
                        # prev-prev pair (mapper.cc:1114-1117).
                        mapper.process(idx, prev_reg[-3],
                                       replace(seq_opts, max_homography_inliers=1.0))
                _local_ba(mapper, opts, rot_priors)
                count_since_loop += 1
                periodic_detect(idx)
                maybe_checkpoint(mapper)
                prev_idx = idx
                num_skipped = 0
                idx += 1
            else:
                num_skipped += 1
                if num_skipped >= opts.max_subsequent_trials:
                    # Start a new sub-map (mapper.cc:1150-1173).
                    if opts.verbose:
                        print(f"Starting new sub-map at image #{idx}")
                    mapper = new_mapper(len(mappers))
                    mappers.append(mapper)
                    ckpt_last[0] = 0
                    idx += max(opts.failure_skip_images - 1, 0)  # mapper.cc:1157
                    first_idx = idx
                    num_skipped = 0
                else:
                    idx += 1

    # Post-pass (mapper.cc:1188-1209). In segment-parallel mode the
    # back-fill before the merge stays inside each mapper's segment; the one
    # after the merge covers the full range.
    with stage("backfill"):
        for m in mappers:
            if m.num_proc_images:
                process_remaining_images(m, *segment_range.get(m, (start, end)), opts)
    with stage("global_ba"):
        for m in mappers:
            if m.num_proc_images:
                _global_ba(m, opts, rot_priors)
    mappers = [m for m in mappers if m.num_proc_images > 0]
    merged = False
    if len(mappers) > 1 and opts.merge:
        with stage("merge"):
            mappers = merge_mappers(mappers, opts)
            merged = True
    # Full-range back-fill and global BA (reference mapper.cc:1201-1209):
    # after a merge, and also without one where a mapper's back-fill was
    # clamped to its segment (one mapper left, or merge=False), since the
    # sequential loop would have tried those frames.
    clamped = any(segment_range.get(m, (start, end)) != (start, end) for m in mappers)
    if merged or clamped:
        with stage("merge" if merged else "backfill"):
            for m in mappers:
                process_remaining_images(m, start, end, opts)
                _global_ba(m, opts, rot_priors)
    if opts.loop_detection and opts.final_closure_sweeps > 0:
        with stage("closure_sweeps"):
            for m in mappers:
                _final_closure_sweeps(m, opts, rot_priors)

    cp_results = None
    main = max(mappers, key=lambda m: m.num_proc_images) if mappers else None
    if opts.use_control_points and control_points and main is not None:
        with stage("control_points"):
            cp_results = apply_control_points(main, control_points, opts)
    if opts.filter_max_error > 0 and main is not None:
        with stage("filter"):
            _global_ba(main, opts, rot_priors, update_errors=True)
            n = filter_point_cloud(main, opts.filter_max_error)
            if opts.verbose:
                print(f"Filtered {n} points with error > {opts.filter_max_error}")
            _global_ba(main, opts, rot_priors)
    if opts.verbose:
        print("Pipeline stages: " + " | ".join(f"{k} {v:.1f}s" for k, v in timings.items()))
    return PipelineResult(mappers=mappers, control_point_results=cp_results, timings=timings)
