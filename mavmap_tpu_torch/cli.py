"""mavmap_tpu_torch command-line mapper — counterpart of reference
src/mapper.cc.

Port of mavmap_tpu/cli.py with the same flags, output files and return
codes, plus --device (default: the CUDA card; --device cpu runs on the
CPU). Input: a path holding `imagedata.txt` plus images (8-bit PNG or
binary PGM, read without Pillow by utils/imageio.py) for the detector, or
cached feature .npz files; output: estimated poses, point clouds and
VRML/PLY models; sub-maps are merged into one unless --no-merge, and
--parallel-segments N maps N overlapping segments before that merge.
--mesh N runs the mapping on N torch.distributed ranks (started here
through parallel.launch, or the ranks of a torchrun environment): the
global bundle adjustment is sharded by 3-D point and the batched fan-outs
split their slots over the ranks; rank 0 writes the outputs, and the exit
code is rank 0's once every rank has finished (a rank that fails makes it
non-zero). Options the port does not carry (--pipeline-chains,
--matcher-backend other than auto) are refused by run_pipeline's
NotImplementedError, and the CLI exits with 1.

Usage:
    python -m mavmap_tpu_torch.cli --input-path DATA/ --output-path OUT/ \
        [--cache-path CACHE/] [--voc-tree-path TREE.npz] [--device cpu] [flags...]
"""

import argparse
import os
import sys
import time
from dataclasses import dataclass


def build_parser():
    p = argparse.ArgumentParser(
        prog="mavmap_tpu_torch",
        description="sequential structure-from-motion in PyTorch, with CUDA kernels",
    )
    # Paths (mapper.cc:624-660).
    p.add_argument("--input-path", required=True)
    p.add_argument("--output-path", required=True)
    p.add_argument("--cache-path", default=None)
    p.add_argument("--reference-cache-path", default=None,
                   help="read features from a reference-mavmap FeatureCache "
                        "directory (<name>-keypoints.bin / -descriptors.bin "
                        "raw dumps, feature_cache.cc:125-163) instead of "
                        "detecting — cross-validation with real "
                        "OpenCV-SURF features")
    p.add_argument("--voc-tree-path", default=None,
                   help="vocabulary tree: .npz (train one with "
                        "mavmap_tpu_torch.loop.train_voc_tree) or the reference's "
                        "binary format (drop-in --voc-tree-path compat); "
                        "omit to disable loop detection")
    p.add_argument("--image-prefix", default="")
    p.add_argument("--image-suffix", default="")
    p.add_argument("--image-ext", default=".png")
    p.add_argument("--calib-matrix-path", default=None,
                   help="3x3 calibration matrix file overriding imagedata "
                        "intrinsics (PINHOLE, reference io.cc:146)")

    # Range (mapper.cc:664-686).
    p.add_argument("--start-image-idx", type=int, default=0)
    p.add_argument("--end-image-idx", type=int, default=-1)
    p.add_argument("--first-image-idx", type=int, default=-1)
    p.add_argument("--second-image-idx", type=int, default=-1)

    # Detection (SURF options in the reference; DoH detector here).
    p.add_argument("--surf-hessian-threshold", type=float, default=1000.0)
    p.add_argument("--surf-num-octaves", type=int, default=4)
    p.add_argument("--surf-num-octave-layers", type=int, default=3)
    p.add_argument("--surf-upright", action="store_true",
                   help="skip orientation assignment (U-SURF; the "
                        "reference's OpenCV SURF computes orientation)")
    p.add_argument("--surf-adaptive-cell-rows", type=int, default=3,
                   help="spatial-uniformity grid rows (reference "
                        "surf-adaptive-cell-rows)")
    p.add_argument("--surf-adaptive-cell-cols", type=int, default=3,
                   help="spatial-uniformity grid cols")
    p.add_argument("--surf-adaptive-max-per-cell", type=int, default=0,
                   help="features per grid cell; overrides --max-features "
                        "when > 0 (reference surf-adaptive-max-per-cell)")
    p.add_argument("--surf-adaptive-min-per-cell", type=int, default=0,
                   help="minimum features per grid cell: activates "
                        "cross-frame adaptive per-cell thresholds "
                        "(AdaptiveDetector — per-cell Hessian thresholds "
                        "lower/raise by 1.5x and persist across frames, "
                        "reference AdaptiveSURF feature.cc:198-309 + "
                        "mapper.cc:707-712); maxima below the quality "
                        "floor hessian/1.5^10 are never admitted")
    p.add_argument("--max-features", type=int, default=2048)

    # Matching / gates (mapper.cc:755-806).
    p.add_argument("--match-max-ratio", type=float, default=0.9)
    p.add_argument("--match-max-distance", type=float, default=-1)
    p.add_argument("--min-disparity", type=float, default=0)
    p.add_argument("--init-min-disparity", type=float, default=0)
    p.add_argument("--max-homography-inliers", type=float, default=0.8)
    p.add_argument("--init-max-homography-inliers", type=float, default=0.7)
    p.add_argument("--final-cost-threshold", type=float, default=2.0)
    p.add_argument("--loss-scale-factor", type=float, default=1.0,
                   help="Cauchy robust-loss scale for pose refinement and BA")
    p.add_argument("--ransac-min-inlier-threshold", type=float, default=30)
    p.add_argument("--ransac-min-inlier-stop", type=float, default=0.6,
                   help="accepted for reference compatibility; the batched "
                        "RANSAC runs a fixed trial count instead of "
                        "stopping early. Equivalence: the reference stops "
                        "at this inlier ratio or after dynamic_max_trials "
                        "(0.99 confidence, estimation.cc:15-21,129-132). "
                        "Our fixed 512 trials meets the 0.99-confidence "
                        "bound for inlier ratios >= 0.39 (5-pt) / 0.31 "
                        "(P3P); below that the reference runs its own "
                        "1000/500-trial caps anyway, so coverage is "
                        "equivalent; extra trials only ever improve the best "
                        "model")
    p.add_argument("--ransac-max-reproj-error", type=float, default=4.0)
    p.add_argument("--tri-max-reproj-error", type=float, default=4.0)
    p.add_argument("--init-tri-min-angle", type=float, default=10.0)
    p.add_argument("--tri-min-angle", type=float, default=1.0)
    p.add_argument("--min-track-len", type=int, default=3)

    # Orchestration (mapper.cc:810-868).
    p.add_argument("--max-subsequent-trials", type=int, default=30)
    p.add_argument("--failure-skip-images", type=int, default=1,
                   help="restart offset of a new sub-map after unrecoverable "
                        "failure")
    p.add_argument("--failure-max-image-dist", type=int, default=10,
                   help="accepted for reference compatibility (declared but "
                        "unused by the reference as well)")
    p.add_argument("--local-ba-window-size", type=int, default=8)
    p.add_argument("--ba-function-tolerance", type=float, default=1e-4,
                   help="global-BA LM stop: relative cost decrease below "
                        "this ends the solve (Ceres function_tolerance)")
    p.add_argument("--local-ba-refine-camera-params",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="refine shared intrinsics in the local BA "
                        "(reference default true, mapper.cc:882-885; "
                        "--no-local-ba-refine-camera-params disables)")
    p.add_argument("--loop-detection-period", type=int, default=20)
    p.add_argument("--loop-detection-num-images", type=int, default=30)
    p.add_argument("--loop-detection-num-nh-images", type=int, default=15)
    p.add_argument("--loop-detection-nh-dist", type=int, default=30)
    p.add_argument("--merge-num-skip-images", type=int, default=5)
    p.add_argument("--no-merge", action="store_true",
                   help="do not merge separate sub-maps")
    p.add_argument("--no-loop-detection", action="store_true")
    p.add_argument("--no-chain-frames", action="store_true",
                   help="disable two-frame chained registration (one device "
                        "round-trip per frame instead of per pair)")
    p.add_argument("--chain-len", type=int, default=4,
                   help="frames registered per chained device program")
    p.add_argument("--pipeline-chains", action="store_true",
                   help="speculative chain pipelining: dispatch the next "
                        "chain on the in-flight chain's device state "
                        "(headline-bench win; off by default in the full "
                        "pipeline, see PipelineOptions.pipeline_chains)")
    p.add_argument("--parallel-segments", type=int, default=1,
                   help="map N overlapping sequence segments, one mapper "
                        "each, their chains dispatched in turn, then merge "
                        "the sub-maps; 1 = strictly sequential like the "
                        "reference")
    p.add_argument("--segment-overlap", type=int, default=4,
                   help="frames shared between adjacent parallel segments "
                        "(anchors the merge alignment)")
    p.add_argument("--final-closure-sweeps", type=int, default=1,
                   help="post-global-BA rounds of non-neighborhood closure "
                        "sweeping + re-BA (0 disables; beyond reference — "
                        "attacks long-survey drift)")
    p.add_argument("--final-closure-step", type=int, default=2,
                   help="query every Nth registered image in a closure sweep")
    p.add_argument("--save-map", default="",
                   help="write a map checkpoint (npz: poses, points, "
                        "tracks, cameras) after mapping (beyond the "
                        "reference; utils/checkpoint.py)")
    p.add_argument("--load-map", default="",
                   help="resume from a map checkpoint: restore the map + "
                        "loop-retrieval DB and CONTINUE sequential mapping "
                        "from the last processed frame, then the normal "
                        "post-pass (back-fill, global BA, closure sweeps) "
                        "and outputs")
    p.add_argument("--checkpoint-period", type=int, default=0,
                   help="write the --save-map checkpoint every N committed "
                        "frames during mapping (0 = only at the end), so a "
                        "preempted run resumes with --load-map")
    p.add_argument("--mesh", type=int, default=1,
                   help="ranks for the distributed global BA and the sharded "
                        "batched fan-outs (beyond the reference): 1 = this "
                        "process, 0 = one per visible CUDA device")
    p.add_argument("--process-prev-prev", action="store_true")

    # Constraints (mapper.cc:871-899).
    p.add_argument("--constrain-rotation", action="store_true",
                   help="use roll/pitch/yaw from imagedata.txt as IMU priors")
    p.add_argument("--constrain-rotation-weight", type=float, default=50.0)
    p.add_argument("--use-control-points", action="store_true")
    p.add_argument("--refine-camera-params",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="refine shared camera intrinsics in global bundle "
                        "adjustments (self-calibration; reference default "
                        "true, mapper.cc:878-881)")
    p.add_argument("--control-point-data-path", default=None)
    p.add_argument("--filter-max-error", type=float, default=0.0)

    p.add_argument("--matcher-backend", default="auto",
                   choices=("auto", "xla", "pallas"),
                   help="descriptor-matcher kernel; the port has one, the "
                        "CUDA matcher (auto); the others are refused")
    p.add_argument("--device", default="cuda",
                   help="torch device every step runs on: the CUDA card by "
                        "default; pass cpu to run on the CPU")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="print per-frame gate diagnostics")
    p.add_argument("--debug-path", default="",
                   help="directory for per-pair match dumps, track-length "
                        "logs and per-step VRML scenes (reference "
                        "--debug-path)")
    return p


def detector_params(args):
    """Every detection parameter of the run, the feature cache's
    fingerprint (the JAX CLI leaves min_per_cell out when it is 0, so a
    cache written before the flag existed stays valid there; this package
    has no such caches and fingerprints all of them)."""
    return {
        "hessian_threshold": args.surf_hessian_threshold,
        "num_octaves": args.surf_num_octaves,
        "num_octave_layers": args.surf_num_octave_layers,
        "upright": args.surf_upright,
        "grid_size": (args.surf_adaptive_cell_rows, args.surf_adaptive_cell_cols),
        "max_features": args.max_features,
        "min_per_cell": args.surf_adaptive_min_per_cell,
    }


def pipeline_options(args, loop_detection):
    from .sfm.pipeline import PipelineOptions

    return PipelineOptions(
        start_image_idx=args.start_image_idx,
        end_image_idx=args.end_image_idx,
        first_image_idx=args.first_image_idx,
        second_image_idx=args.second_image_idx,
        max_subsequent_trials=args.max_subsequent_trials,
        failure_skip_images=args.failure_skip_images,
        failure_max_image_dist=args.failure_max_image_dist,
        local_ba_window_size=args.local_ba_window_size,
        local_ba_refine_camera_params=args.local_ba_refine_camera_params,
        ba_function_tolerance=args.ba_function_tolerance,
        loop_detection=loop_detection,
        loop_detection_period=args.loop_detection_period,
        loop_detection_num_images=args.loop_detection_num_images,
        loop_detection_num_nh_images=args.loop_detection_num_nh_images,
        loop_detection_nh_dist=args.loop_detection_nh_dist,
        merge=not args.no_merge,
        chain_frames=not args.no_chain_frames,
        chain_len=args.chain_len,
        pipeline_chains=args.pipeline_chains,
        parallel_segments=args.parallel_segments,
        segment_overlap=args.segment_overlap,
        final_closure_sweeps=args.final_closure_sweeps,
        final_closure_step=args.final_closure_step,
        mesh_devices=args.mesh,
        merge_num_skip_images=args.merge_num_skip_images,
        min_track_len=args.min_track_len,
        final_cost_threshold=args.final_cost_threshold,
        init_max_homography_inliers=args.init_max_homography_inliers,
        max_homography_inliers=args.max_homography_inliers,
        init_min_disparity=args.init_min_disparity,
        min_disparity=args.min_disparity,
        match_max_ratio=args.match_max_ratio,
        match_max_distance=args.match_max_distance,
        ransac_min_inlier_threshold=args.ransac_min_inlier_threshold,
        ransac_min_inlier_stop=args.ransac_min_inlier_stop,
        ransac_max_reproj_error=args.ransac_max_reproj_error,
        tri_max_reproj_error=args.tri_max_reproj_error,
        loss_scale_factor=args.loss_scale_factor,
        init_tri_min_angle=args.init_tri_min_angle,
        tri_min_angle=args.tri_min_angle,
        constrain_rotation=args.constrain_rotation,
        constrain_rotation_weight=args.constrain_rotation_weight,
        use_control_points=args.use_control_points,
        filter_max_error=args.filter_max_error,
        process_prev_prev=args.process_prev_prev,
        verbose=not args.quiet,
        refine_camera_params=args.refine_camera_params,
        matcher_backend=args.matcher_backend,
        checkpoint_period=args.checkpoint_period,
        checkpoint_path=args.save_map,
        debug=args.debug,
        debug_path=args.debug_path,
    )


@dataclass
class CliRun:
    """What one CLI run gives back: the return code, the PipelineResult
    (None where mapping did not run) and the wall seconds of the feature
    extraction before mapping."""

    rc: int
    result: object = None
    detection_s: float = 0.0


def run(argv=None):
    """The CLI's work; main() returns its return code."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from .features import FeatureCache
    from .loop import VocTree
    from .sfm import outputs
    from .sfm.pipeline import _pipeline_mesh, _refuse_unported, run_pipeline
    from .utils.imageio import read_image
    from .utils.io import (cameras_from_records, read_control_point_data, read_image_data,
                           write_control_point_data)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("mavmap_tpu_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return CliRun(1)

    t0 = time.time()
    records = read_image_data(os.path.join(args.input_path, "imagedata.txt"))
    if args.calib_matrix_path:
        from .utils.io import read_calib_matrix

        K = read_calib_matrix(args.calib_matrix_path)
        for rec in records:
            rec.camera_idx = 0
            rec.camera_model = 1  # PINHOLE
            rec.camera_params = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
    cam_models, cam_params, image_cameras = cameras_from_records(records)
    mesh = _pipeline_mesh(pipeline_options(args, False), device)
    rank = 0 if mesh is None else mesh.rank
    if rank == 0:
        print(f"Loaded {len(records)} images, {len(cam_models)} cameras")

    cache_path = args.cache_path or os.path.join(args.output_path, "cache")
    os.makedirs(args.output_path, exist_ok=True)

    if args.surf_adaptive_max_per_cell > 0:
        args.max_features = (args.surf_adaptive_max_per_cell * args.surf_adaptive_cell_rows
                             * args.surf_adaptive_cell_cols)
    params = detector_params(args)

    voc_tree = None
    if args.voc_tree_path and not args.no_loop_detection:
        if args.voc_tree_path.endswith(".npz"):
            voc_tree = VocTree.load(args.voc_tree_path, device=device)
        else:
            voc_tree = VocTree.load_reference_binary(args.voc_tree_path, device=device)
    opts = pipeline_options(args, loop_detection=voc_tree is not None)
    try:
        _refuse_unported(opts)  # before any detection work
    except NotImplementedError as e:
        print(f"mavmap_tpu_torch: {e}", file=sys.stderr)
        return CliRun(1)

    def image_path(image_idx):
        name = args.image_prefix + records[image_idx].name + args.image_suffix
        return os.path.join(args.input_path, name + args.image_ext)

    adaptive_det = None
    if args.surf_adaptive_min_per_cell > 0:
        from .features.detector import AdaptiveDetector

        adaptive_det = AdaptiveDetector(**params, device=device)

    def detect(image_idx):
        from .features.detector import detect_image_file

        if adaptive_det is not None:
            return detect_image_file(image_path(image_idx), detector=adaptive_det)
        return detect_image_file(image_path(image_idx), device=device,
                                 **{k: v for k, v in params.items() if k != "min_per_cell"})

    cache = FeatureCache(cache_path, params, detector=detect, capacity=args.max_features)

    class CachedProvider:
        capacity = args.max_features
        descriptor_dim = 128

        def get(self, image_idx):
            return cache.query(image_idx, records[image_idx].name)

        def dimensions(self, image_idx):
            """(rows, cols, diagonal) without decoding the image (reference
            FeatureCache::query_dimensions)."""
            return cache.query_dimensions(image_idx, records[image_idx].name)

        def image(self, image_idx):
            """The image's pixels (debug drawings and point colors), None
            where the file does not exist; a file that does not decode
            raises."""
            path = image_path(image_idx)
            return read_image(path) if os.path.exists(path) else None

    provider = CachedProvider()
    t_det = time.perf_counter()
    if adaptive_det is None and not args.reference_cache_path:
        # Feature extraction ahead of mapping: PNG decode and the npz writes
        # run on worker threads while the device detects other frames.
        # Skipped under the adaptive detector, whose cross-frame per-cell
        # thresholds depend on the frame order.
        lo = max(args.start_image_idx, 0)
        hi = args.end_image_idx if args.end_image_idx >= 0 else len(records) - 1
        todo = [i for i in range(lo, min(hi + 1, len(records))) if os.path.exists(image_path(i))]
        if mesh is not None:  # each rank extracts its share; all then read every file
            todo = todo[mesh.rank::mesh.size]
        if todo:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(3) as ex:
                list(ex.map(lambda i: cache.query(i, records[i].name), todo))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        mesh.barrier()
    detection_s = time.perf_counter() - t_det
    if args.reference_cache_path:
        from .features import ReferenceCacheProvider

        ref = ReferenceCacheProvider(args.reference_cache_path, [rec.name for rec in records],
                                     capacity=args.max_features)
        # No `dimensions`: the npz cache would detect on a miss, and a
        # reference-cache run may have no images at all.
        ref.image = provider.image
        provider = ref

    rot_priors = None
    if args.constrain_rotation:
        rot_priors = {i: rec.prior_rvec() for i, rec in enumerate(records)}

    control_points = None
    if args.use_control_points:
        if not args.control_point_data_path:
            print("--use-control-points requires --control-point-data-path", file=sys.stderr)
            return CliRun(1, detection_s=detection_s)
        control_points = read_control_point_data(args.control_point_data_path)

    result = run_pipeline(image_cameras, cam_models, cam_params, provider, opts,
                          voc_tree=voc_tree, rot_priors=rot_priors,
                          control_points=control_points, resume_from=args.load_map or None,
                          device=device)
    if rank != 0:  # every rank holds the same map; rank 0 writes it
        return CliRun(0 if result.mappers else 1, result, detection_s)

    if args.save_map and result.mappers:
        from .utils.checkpoint import save_map

        save_map(result.main_mapper, args.save_map)
        if not args.quiet:
            print(f"Map checkpoint written to {args.save_map}")

    if not result.mappers:
        print("Mapping failed: no images registered", file=sys.stderr)
        return CliRun(1, result, detection_s)

    out = args.output_path
    for k, m in enumerate(sorted(result.mappers, key=lambda m: -m.num_proc_images)):
        suffix = "" if k == 0 else f"-{k}"
        outputs.write_image_data(m, records, os.path.join(out, f"imagedataout{suffix}.txt"))
        outputs.write_point_cloud_data(m, os.path.join(out, f"points3D{suffix}.txt"),
                                       image_reader=provider.image)
        outputs.write_point_cloud_ply(m, os.path.join(out, f"points3D{suffix}.ply"))
        outputs.write_camera_models_vrml(m, os.path.join(out, f"cameras{suffix}.wrl"))
        # Point-cloud VRML variants of the reference's write_mapper
        # (mapper.cc:97-108): strict (tri_max/5) clouds at track length 2,
        # 3 and min(3 * min_track_len, nproc/2), and an "all" cloud at the
        # full reprojection threshold.
        strict = args.tri_max_reproj_error / 5.0
        outputs.write_point_cloud_vrml(
            m, os.path.join(out, f"points3D-min-track-len-2{suffix}.wrl"),
            min_track_len=2, max_error=strict)
        outputs.write_point_cloud_vrml(
            m, os.path.join(out, f"points3D-min-track-len-3{suffix}.wrl"),
            min_track_len=3, max_error=strict)
        mtl_main = min(3 * args.min_track_len, max(m.num_proc_images // 2, 2))
        outputs.write_point_cloud_vrml(m, os.path.join(out, f"points3D{suffix}.wrl"),
                                       min_track_len=mtl_main, max_error=strict)
        outputs.write_point_cloud_vrml(m, os.path.join(out, f"points3D-all{suffix}.wrl"),
                                       min_track_len=0, max_error=args.tri_max_reproj_error)
        outputs.write_camera_connections_vrml(m, os.path.join(out, f"connections{suffix}.wrl"))

    if result.control_point_results:
        rows = [(cp, est if est is not None else np.zeros(3), tl, res_)
                for cp, est, tl, res_ in result.control_point_results]
        write_control_point_data(os.path.join(out, "control_points_out.txt"),
                                 [r[0] for r in rows], [r[1] for r in rows],
                                 [r[2] for r in rows], [r[3] for r in rows])

    n_reg = result.main_mapper.num_proc_images
    print(f"Registered {n_reg}/{len(records)} images in {time.time() - t0:.1f} s "
          f"({len(result.mappers)} sub-map(s), {result.main_mapper.store.num_points3D} points)")
    return CliRun(0, result, detection_s)


def _rank_rc(mesh, argv):
    """One rank of `--mesh N`: the CLI's run, its return code."""
    return run(argv).rc


def main(argv=None):
    """The CLI's return code. --mesh N (N > 1, or 0 with more than one CUDA
    device) runs `run` on N ranks: the ranks of a torchrun environment
    (WORLD_SIZE set), or N processes started here with parallel.launch."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.mesh == 1:
        return run(argv).rc

    import torch

    from .parallel.multihost import init_multihost, launch

    device = torch.device(args.device)
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        init_multihost(device=device)
        return run(argv).rc
    n = args.mesh if args.mesh > 0 else (
        torch.cuda.device_count() if device.type == "cuda" else 1)
    if n <= 1:
        return run(argv).rc
    try:
        rcs = launch(_rank_rc, n, device.type, args=(argv,))
    except RuntimeError as e:
        print(f"mavmap_tpu_torch: {e}", file=sys.stderr)
        return 1
    if any(rc != rcs[0] for rc in rcs):
        print(f"mavmap_tpu_torch: the ranks returned {rcs}", file=sys.stderr)
        return 1
    return rcs[0]


if __name__ == "__main__":
    sys.exit(main())
