"""End-to-end mapping pipeline, sequential mode — counterpart of reference
src/mapper.cc.

Port of mavmap_tpu/sfm/pipeline.py's sequential loop (mapper.cc:563-1257):
the batched initial-pair search, chained registration with one deferred
window bundle adjustment per chain and periodic loop detection, the
per-frame fallback with the loop-detection rescue and sub-map restart,
then the back-fill of skipped frames, the global bundle adjustment and the
final closure sweeps. Every step runs on the device given to run_pipeline.

Options of the JAX pipeline that this package does not carry yet raise
NotImplementedError at entry (see _refuse_unported), naming the ROADMAP
queue item that ports them; none falls back silently.
"""

import time as _time
from dataclasses import dataclass, replace

import torch

from ..ba import BAOptions
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
    matcher_backend: str = "auto"  # the port has one matcher, K1: "auto" only
    # Register `chain_len` consecutive frames per device step, frame k
    # anchored on the state derived on the device from frame k-1: one pull
    # per chain; the host gates still veto each frame and failures fall back
    # to the per-frame path. One window solve per chain.
    chain_frames: bool = True
    chain_len: int = 4
    pipeline_chains: bool = False   # on the ROADMAP's do-not-port list
    parallel_segments: int = 1      # segment-parallel mapping: not ported
    segment_overlap: int = 4
    # Post-pass closure sweeps (beyond the reference): after the first
    # global BA, query every `final_closure_step`-th registered image for
    # non-neighborhood loop closures (batched registration) and re-run the
    # global BA; up to `final_closure_sweeps` rounds or until one adds none.
    final_closure_sweeps: int = 1
    final_closure_step: int = 2
    mesh_devices: int = 1           # multi-device global BA: not ported
    checkpoint_period: int = 0      # map checkpoints: not ported
    checkpoint_path: str = ""
    debug: bool = False             # debug dumps: not ported
    debug_path: str = ""


def _refuse_unported(opts, resume_from):
    """Raise NotImplementedError for every option of the JAX pipeline whose
    code this package does not carry, naming its ROADMAP queue item."""
    refused = [
        (opts.constrain_rotation, "constrain_rotation (IMU rotation priors): ROADMAP queue "
                                  "item 3"),
        (opts.use_control_points, "use_control_points (GCP geo-registration): ROADMAP "
                                  "queue item 6"),
        (opts.filter_max_error > 0, "filter_max_error > 0 (point-cloud filter): ROADMAP "
                                    "queue item 6"),
        (opts.parallel_segments > 1, "parallel_segments > 1 (segment-parallel mapping and "
                                     "its merge): ROADMAP queue item 7"),
        (resume_from is not None or opts.checkpoint_period > 0 or bool(opts.checkpoint_path),
         "resume_from / checkpoint_period / checkpoint_path (map checkpoints): ROADMAP "
         "queue item 6"),
        (opts.mesh_devices != 1, "mesh_devices != 1 (multi-device global BA): ROADMAP queue "
                                 "item 8"),
        (opts.debug, "debug (debug dumps): ROADMAP queue item 6"),
        (opts.pipeline_chains, "pipeline_chains (speculative chain pipelining): on the "
                               "ROADMAP's do-not-port list"),
        (opts.matcher_backend != "auto", f"matcher_backend={opts.matcher_backend!r}: the port "
                                         f"has one matcher, kernel K1 ('auto')"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"run_pipeline: {what} is not ported")


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


def _local_ba(mapper, opts: PipelineOptions, drop_last=0):
    """The window bundle adjustment after a commit: the last
    local_ba_window_size registered images, the first two fixed, deferred
    onto the next register step (the solve lands one step later)."""
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
        async_=True, defer=True)


def _final_closure_sweeps(mapper, opts: PipelineOptions):
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
        _global_ba(mapper, opts, refine_cams=False)
        total += added
    return total


def _global_ba(mapper, opts: PipelineOptions, max_iters=None, refine_cams=None):
    info = mapper.adjust_global_bundle(BAOptions(
        max_num_iterations=max_iters if max_iters is not None else opts.ba_global_max_iters,
        function_tolerance=opts.ba_function_tolerance,
        min_track_len=opts.min_track_len,
        loss_scale_factor=opts.loss_scale_factor,
        refine_camera_params=(opts.refine_camera_params if refine_cams is None
                              else refine_cams)))
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


def run_pipeline(image_cameras, cam_models, cam_params, provider, opts: PipelineOptions = None,
                 voc_tree=None, rot_priors=None, control_points=None, resume_from=None,
                 device="cuda"):
    """The full mapping run in sequential mode (reference mapper.cc main
    loop, :1014-1245) on `device` (default the CUDA card: it raises where
    there is none; tests pass "cpu"). voc_tree: a loop.VocTree, enabling
    loop detection and the closure sweeps. Sub-map k's mapper draws its
    RANSAC samples from a generator seeded k, as the JAX package seeds its
    keys. rot_priors and control_points are read only by options that are
    not ported (see _refuse_unported). Returns a PipelineResult with
    per-stage wall seconds in `timings`."""
    from ..loop import LoopDetector

    opts = opts or PipelineOptions()
    _refuse_unported(opts, resume_from)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pipeline: no CUDA device (pass device='cpu' to run on the CPU)")
    num_images = len(image_cameras)
    start = opts.start_image_idx
    end = opts.end_image_idx if opts.end_image_idx >= 0 else num_images - 1
    init_opts = _mapper_options(opts, initial=True)

    def new_mapper(k):
        det = LoopDetector(voc_tree) if (voc_tree is not None and opts.loop_detection) else None
        return SequentialMapper(image_cameras, cam_models, cam_params, provider, device,
                                seed=k, loop_detector=det)

    mappers = [new_mapper(0)]
    mapper = mappers[0]
    idx = first_idx = opts.first_image_idx if opts.first_image_idx >= 0 else start
    prev_idx = None
    num_skipped = 0
    count_since_loop = 0

    # Per-stage wall clocks (the reference prints per-frame and total
    # timings, mapper.cc:1181,1252-1257).
    timings = {}

    class _stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = _time.perf_counter()

        def __exit__(self, *exc):
            timings[self.name] = timings.get(self.name, 0.0) + _time.perf_counter() - self.t0

    def detect(at, **kw):
        t0 = _time.perf_counter()
        n = mapper.detect_loop(at, num_images=opts.loop_detection_num_images, options=seq_opts,
                               **kw)
        mapper._count_time("seq_detect_s", _time.perf_counter() - t0)
        return n

    def periodic_detect(at):
        nonlocal count_since_loop
        if opts.loop_detection and count_since_loop >= opts.loop_detection_period:
            detect(at, num_nh_images=opts.loop_detection_num_nh_images,
                   nh_distance=opts.loop_detection_nh_dist, verbose=opts.verbose)
            count_since_loop = 0

    t_seq0 = _time.perf_counter()
    while idx <= end:
        if mapper.num_proc_images == 0:
            # Initial-pair search (mapper.cc:1027-1062).
            second = opts.second_image_idx if (
                opts.second_image_idx >= 0 and len(mappers) == 1) else -1
            success = False
            if second >= 0:
                success = mapper.process_initial(first_idx, second, init_opts)
                idx = max(first_idx, second)
            else:
                # Batched sweeps of candidate seconds (the reference tries one
                # sequential process_initial per candidate, mapper.cc:1027-1036).
                j = first_idx + 1
                chunk = 2  # almost always succeeds at once; then widen
                while j <= end:
                    cands = list(range(j, min(j + chunk, end + 1)))
                    sec = mapper.process_initial_batch(first_idx, cands, init_opts)
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
            t0 = _time.perf_counter()
            oks = mapper.process_chain_k(chain, prev_idx, seq_opts, pad_to=opts.chain_len)
            mapper._count_time("seq_chain_s", _time.perf_counter() - t0)
            committed = sum(oks)
            if committed:
                for j in chain[:committed]:
                    if opts.verbose:
                        print(f"Processed image #{j} (points3D={mapper.store.num_points3D})")
                count_since_loop += committed
                prev_idx = chain[committed - 1]
                num_skipped = 0
                idx = prev_idx + 1
                # One window solve per chain, deferred onto the next register
                # step: the window covers every frame the chain added.
                t0 = _time.perf_counter()
                _local_ba(mapper, opts)
                mapper._count_time("seq_localba_s", _time.perf_counter() - t0)
                periodic_detect(prev_idx)
                continue
            # The chain's first frame failed its gates: the per-frame path
            # below takes it (rescue, skip, sub-map restart).
        success = mapper.process(idx, prev_idx, seq_opts)
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
            _local_ba(mapper, opts)
            count_since_loop += 1
            periodic_detect(idx)
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
                idx += max(opts.failure_skip_images - 1, 0)  # mapper.cc:1157
                first_idx = idx
                num_skipped = 0
            else:
                idx += 1
    timings["sequential_loop"] = _time.perf_counter() - t_seq0

    # Post-pass (mapper.cc:1188-1209).
    with _stage("backfill"):
        for m in mappers:
            if m.num_proc_images:
                process_remaining_images(m, start, end, opts)
    with _stage("global_ba"):
        for m in mappers:
            if m.num_proc_images:
                _global_ba(m, opts)
    mappers = [m for m in mappers if m.num_proc_images > 0]
    if len(mappers) > 1 and opts.merge:
        raise NotImplementedError(
            f"run_pipeline: merging {len(mappers)} sub-maps (merge=True) is not ported: "
            f"ROADMAP queue item 7")
    if opts.loop_detection and opts.final_closure_sweeps > 0:
        with _stage("closure_sweeps"):
            for m in mappers:
                _final_closure_sweeps(m, opts)
    if opts.verbose:
        print("Pipeline stages: " + " | ".join(f"{k} {v:.1f}s" for k, v in timings.items()))
    return PipelineResult(mappers=mappers, timings=timings)
