"""SequentialMapper — incremental SfM engine.

Port of the sequential path of mavmap_tpu/sfm/mapper.py (reference
src/sfm/sequential_mapper.{h,cc}). The class owns the MapStore, the
idx<->id maps, the processed-pair graph and the per-image feature caches;
each `process*` call runs ONE device step (sfm/kernels.py) on the mapper's
device and applies the reference's failure gates host-side on the pulled
scalars:

  process_initial: disparity -> homography -> 5pt inliers -> forward-motion
  -> mean tri angle (sequential_mapper.cc:46-386);
  process: disparity -> homography -> #stable 2D-3D -> P3P inliers ->
  refinement final cost, then track continuation + new triangulations
  (sequential_mapper.cc:389-934);
  process_chain_k (chain_dispatch + chain_complete): K frames registered
  in one step, each anchored on the state derived on the device from the
  frame before, pulled once, then gated and committed frame by frame;
  process_initial_batch, detect_loop (_batch_register_candidates),
  batch_register_pairs and batch_detect_closures: many pairs registered in
  one batched step (one batched K1 launch), committed in order with the
  same gates; the loop-closure pre-gates count matches of many pairs in
  batched K1 launches;
  merge: another mapper's map joined into this one through cross-loop
  closures (batched, as in detect_loop) and a similarity alignment
  (sequential_mapper.cc:1218-1481).

Bundle adjustment runs on the same device, synchronously or on the JAX
package's deferred/asynchronous schedule (adjust_bundle(async_=,
defer=), flush_ba): a deferred window solve enters at the next register
step and its results land in the store at the pull after that one. Here
the solve itself runs when it is dispatched (ba/core.py
bundle_adjust_async), so the map every step sees is the JAX package's,
without its overlap of solve and registration. Thresholds in pixels
convert to normalized units with threshold / mean(fx, fy), like the
reference (camera_models.cc:47-52). IMU rotation priors enter adjust_bundle
and adjust_global_bundle (rot_priors, with the model first rotated into the
priors' frame); with `debug` and a DebugDumper in `debug_dumper`, the steps
write the reference's debug dumps (sfm/debug.py).

With a parallel.Mesh of more than one rank (mesh=), every rank runs this
mapper on the same host state; the batched fan-outs (the loop-closure
pre-gate's match counts, the candidates' and the pairs' registrations)
split their slots over the ranks (parallel/dist_register.py) and the
global bundle adjustment is sharded by 3-D point (parallel/dist_ba.py).
After each, the ranks compare a digest of the map they hold, and a
difference raises.
"""

from collections import OrderedDict
from dataclasses import replace as _dc_replace
from typing import NamedTuple

import numpy as np
import torch

from ..ba import (BA_POSE_FIXED, BA_POSE_FIXED_X, BAOptions, build_problem, bundle_adjust,
                  bundle_adjust_async)
from ..fm.native_map_store import create_map_store
from ..interop import features_to_device
from ..models import camera as cam
from ..ops.matching import MATCHER_BACKENDS, match_features_batched
from ..ops.rotation import rotmat_from_rvec, rvec_from_rotmat
from ..utils.device import resolve_device
from ..utils.mathx import rel2abs_threshold
from ..utils.timer import span, sync
from .kernels import (register_chain, register_chain_fresh, register_view,
                      register_view_batch, register_view_pairs, two_view_init,
                      two_view_init_batch, unpack_register, unpack_two_view)
from .options import SequentialMapperOptions


class _LRUCache(OrderedDict):
    """Bounded per-image cache: evicts least-recently-used beyond capacity."""

    def __init__(self, capacity):
        super().__init__()
        self.capacity = capacity

    def get_or(self, key, make):
        if key in self:
            self.move_to_end(key)
            return self[key]
        val = make()
        self[key] = val
        if len(self) > self.capacity:
            self.popitem(last=False)
        return val


class _ChainToken(NamedTuple):
    """A dispatched chain, for chain_complete: its device outputs (rows,
    scalars, has_tri_in, end_state, end_pose), the host copies of the
    first three issued at dispatch with the CUDA event recorded behind
    them (None on the CPU), its frames (padded to K) and the real count,
    its anchor image, and the anchor's point2D ids and has_tri."""

    out: tuple
    host: tuple
    ready: object
    idxs: list
    n_real: int
    anchor_idx: int
    anchor_p2d: object
    has_tri: object
    tri_nts: list
    options: SequentialMapperOptions


class SequentialMapper:
    def __init__(self, image_cameras, cam_models, cam_params, feature_provider,
                 loop_detector=None, seed=0, store_backend="auto", cache_capacity=128,
                 mesh=None, device="cuda"):
        """image_cameras: (num_images,) camera index per dataset image;
        cam_models/cam_params: per-camera model codes and padded params;
        feature_provider: FeatureProvider with fixed capacity;
        loop_detector: a loop.LoopDetector every committed image is added
        to (None: no loop closure); seed: RANSAC generator seed;
        store_backend: 'native' or 'auto' (the C++ track store,
        fm/native_map_store.py; its build raises where it fails) or
        'python' (fm/map_store.py); cache_capacity: max images kept in the
        feature caches; mesh: a parallel.Mesh whose ranks share the fan-outs
        and the global bundle adjustment (one rank, or None: this process
        alone); device: the torch device every step runs on (the CUDA card
        unless another is named; it raises where there is none)."""
        self.device = resolve_device(device, "SequentialMapper")
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.loop_detector = loop_detector
        self.image_cameras = np.asarray(image_cameras, np.int32)
        self.cam_models = np.asarray(cam_models, np.int32)
        # Own copy: self-calibration adopts refined intrinsics in place.
        self.cam_params = np.array(cam_params, np.float32)
        self.provider = feature_provider
        self.store = create_map_store(store_backend)
        self._store_cam_ids = {}
        self.image_idx_to_id = {}
        self.image_id_to_idx = {}
        self.pair_graph = set()
        self.num_proc_images = 0
        self.min_image_idx = None
        self.max_image_idx = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Descriptors (intrinsics-independent) and normalized coordinates
        # (intrinsics-DEPENDENT) are cached separately so self-calibration
        # only invalidates the latter.
        self._feat_cache = _LRUCache(cache_capacity)
        self._norm_cache = _LRUCache(cache_capacity)
        self._dev_feat_cache = _LRUCache(cache_capacity)
        self._dev_norm_cache = _LRUCache(cache_capacity)
        # Event counters and accumulated seconds (utils/timer.span); free-form
        # keys.
        self.counters = {}
        # Bundle adjustments on the deferred/asynchronous schedule: problems
        # stashed by adjust_bundle(defer=True) and solves whose results have
        # not reached the store yet, as (sel_ids, pids, finalize).
        self._deferred_ba = []
        self._pending_ba = []
        # Optional sfm.debug.DebugDumper: with it, steps called with
        # debug=True write the reference's debug dumps.
        self.debug_dumper = None
        # The matcher backend the last step ran ('pallas' or 'xla'; see
        # _matcher_backend), None before any match.
        self.matcher_backend_resolved = None

    def _count(self, name, n=1):
        if n:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def _count_time(self, name, seconds):
        # Accumulates unrounded (the JAX version rounds on every add, which
        # drops sub-5 ms solves entirely); rounding happens in report().
        self.counters[name] = self.counters.get(name, 0.0) + float(seconds)

    def report(self):
        """The counters, with accumulated seconds rounded to 10 ms, and the
        map store's backend ('native' or 'python')."""
        rep = {k: round(v, 2) if isinstance(v, float) else v for k, v in self.counters.items()}
        rep["store_backend"] = self.store.backend
        return rep

    # ------------------------------------------------------------- helpers

    def _matcher_backend(self, options):
        """Resolve options.matcher_backend, the JAX package's names:
        'auto' and 'pallas' = kernel K1 (CUDA kernel on the card, its plain
        version on the CPU), 'xla' = the plain PyTorch matcher
        (ops/matching.py match_brute_force) on the mapper's device, on the
        card too. The resolved name is recorded in
        `matcher_backend_resolved`, so a run can show which matcher it
        took; an unknown name raises, and nothing falls back."""
        b = getattr(options, "matcher_backend", "auto")
        if b not in MATCHER_BACKENDS:
            raise ValueError(f"matcher_backend {b!r}: expected one of {MATCHER_BACKENDS}")
        b = "pallas" if b == "auto" else b
        self.matcher_backend_resolved = b
        return b

    def _features(self, image_idx):
        return self._feat_cache.get_or(image_idx, lambda: self.provider.get(image_idx))

    def _device_features(self, image_idx):
        """Per-image (kp, desc, mask, normalized) tensors on the device."""

        kp, desc, mask = self._dev_feat_cache.get_or(
            image_idx, lambda: features_to_device(self._features(image_idx), self.device))
        n = self._dev_norm_cache.get_or(
            image_idx, lambda: self._tensor(self._normalized(image_idx)))
        return kp, desc, mask, n

    def _normalized(self, image_idx):
        """Normalized coords of an image's (padded) keypoints (host numpy)."""

        def make():
            f = self._features(image_idx)
            ci = self.image_cameras[image_idx]
            return cam.image2normalized_np(
                f.keypoints, int(self.cam_models[ci]), self.cam_params[ci]
            ).astype(np.float32)

        return self._norm_cache.get_or(image_idx, make)

    def _norm_threshold(self, px, image_idx):
        p = self.cam_params[self.image_cameras[image_idx]]
        return float(px) / float((p[0] + p[1]) / 2.0)

    def _abs_disparity(self, min_disparity, image_idx):
        """Relative (<1) min-disparity thresholds scale by the frame
        diagonal (reference sequential_mapper.cc:425-436); without
        dimension metadata, 2 * principal point stands in for it."""
        if min_disparity >= 1 or min_disparity <= 0:
            return min_disparity
        diag = 0.0
        if hasattr(self.provider, "dimensions"):
            dims = self.provider.dimensions(image_idx)
            if dims is not None:
                diag = float(dims[2])
        if diag <= 0:
            ci = self.image_cameras[image_idx]
            cx, cy = self.cam_params[ci][2], self.cam_params[ci][3]
            diag = 2.0 * float(np.hypot(cx, cy))
        return min_disparity * diag

    def _store_camera(self, cam_idx):
        if cam_idx not in self._store_cam_ids:
            self._store_cam_ids[cam_idx] = self.store.add_camera(
                int(self.cam_models[cam_idx]), self.cam_params[cam_idx])
        return self._store_cam_ids[cam_idx]

    def _add_image_to_store(self, image_idx):
        f = self._features(image_idx)
        n = self._normalized(image_idx)
        cid = self._store_camera(int(self.image_cameras[image_idx]))
        image_id, _ = self.store.add_image(cid, f.keypoints, n)
        self.image_idx_to_id[image_idx] = image_id
        self.image_id_to_idx[image_id] = image_idx
        if self.loop_detector is not None:
            dev = self._dev_feat_cache.get(image_idx)
            self.loop_detector.add_image(image_idx, f,
                                         device_descriptors=dev[1] if dev else None,
                                         device_mask=dev[2] if dev else None)
        self._track_minmax(image_idx)
        self.num_proc_images += 1
        return image_id

    def _track_minmax(self, image_idx):
        if self.min_image_idx is None or image_idx < self.min_image_idx:
            self.min_image_idx = image_idx
        if self.max_image_idx is None or image_idx > self.max_image_idx:
            self.max_image_idx = image_idx

    def is_image_processed(self, image_idx):
        return image_idx in self.image_idx_to_id

    def is_pair_processed(self, idx1, idx2):
        return (min(idx1, idx2), max(idx1, idx2)) in self.pair_graph

    def get_pose(self, image_idx):
        return self.store.get_pose(self.image_idx_to_id[image_idx])

    def _prev_track_state(self, prev_image_idx, options):
        """Per prev-row track info for registration, capacity-padded:
        (prev_p2d ids, has_tri (F,), stable (F,), xyz (F,3), rvec, tvec,
        track_len (F,))."""
        prev_id = self.image_idx_to_id[prev_image_idx]
        prev_p2d = self.store.point2D_ids_of_image(prev_id)
        F = self.provider.capacity
        p3d = self.store.point2D_point3D[prev_p2d]
        pids = np.maximum(p3d, 0)
        linked = (p3d >= 0) & self.store.point3D_valid[pids]
        has_tri_rows = linked & self.store.point3D_tri[pids]
        lens_rows = np.where(has_tri_rows, self.store.point3D_track_len[pids],
                             0).astype(np.int32)
        stable_rows = has_tri_rows & (lens_rows >= options.min_track_len)
        n = len(prev_p2d)
        has_tri = np.zeros(F, bool)
        stable = np.zeros(F, bool)
        lens = np.zeros(F, np.int32)
        xyz = np.zeros((F, 3), np.float32)
        has_tri[:n] = has_tri_rows
        stable[:n] = stable_rows
        lens[:n] = lens_rows
        xyz[:n][has_tri_rows] = self.store.point3D_xyz[pids[has_tri_rows]]
        prev_rvec, prev_tvec = self.store.get_pose(prev_id)
        return prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, lens

    @staticmethod
    def _max_distance(options):
        return options.match_max_distance if options.match_max_distance > 0 else 1e9

    def _tensor(self, a, dtype=None):
        a = np.asarray(a)
        sync(int(a.size > 0))  # a blocking copy
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _stacked_features(self, image_idxs):
        """(kp, desc, mask, normalized) of several images, each stacked to
        a leading slot axis on the device."""
        feats = [self._device_features(i) for i in image_idxs]
        return tuple(torch.stack(x) for x in zip(*feats))

    def _stacked_states(self, prev_idxs, options):
        """Track states of several previous images: (states, xyz, has_tri,
        stable, rvec, tvec), the last five stacked to a leading slot axis
        on the device."""
        states = [self._prev_track_state(i, options) for i in prev_idxs]
        f32 = torch.float32
        return (states, self._tensor(np.stack([s[3] for s in states])),
                self._tensor(np.stack([s[1] for s in states])),
                self._tensor(np.stack([s[2] for s in states])),
                self._tensor(np.stack([s[4] for s in states]), f32),
                self._tensor(np.stack([s[5] for s in states]), f32))

    # ------------------------------------------------------ process_initial

    def process_initial(self, first_idx, second_idx,
                        options: SequentialMapperOptions = None, debug=False, samples=None):
        """Two-view initialization (reference sequential_mapper.cc:46-386).
        samples: optional injected RANSAC samples (see two_view_init)."""
        options = options or SequentialMapperOptions()
        if self.num_proc_images > 0:
            raise ValueError("initial processing can only be called once")
        if first_idx == second_idx:
            raise ValueError("initial pair must be distinct images")

        with span("register.prepare", "reg_prepare_s", self):
            kp1, d1, m1, n1 = self._device_features(first_idx)
            kp2, d2, m2, n2 = self._device_features(second_idx)
        with span("register.dispatch", "reg_dispatch_s", self):
            rows, scalars = two_view_init(
                self._gen, kp1, d1, m1, n1, kp2, d2, m2, n2,
                options.match_max_ratio, self._max_distance(options),
                self._norm_threshold(options.ransac_max_reproj_error, first_idx),
                essential_trials=options.essential_ransac_trials,
                max_depth=options.max_depth, samples=samples,
                matcher=self._matcher_backend(options))
        with span("register.wait", "reg_wait_s", self):
            sync(2)
            rows, scalars = rows.cpu().numpy(), scalars.cpu().numpy()
        with span("register.commit", "reg_commit_s", self):
            return self._two_view_gates_and_commit(first_idx, second_idx,
                                                   unpack_two_view(rows, scalars), options,
                                                   debug=debug)

    def process_initial_batch(self, first_idx, candidate_idxs,
                              options: SequentialMapperOptions = None, debug=False):
        """Two-view initialization of `first_idx` against several candidate
        second images in one batched step (two_view_init_batch); commits
        the first candidate, in the given order, that passes every gate.
        Returns the committed second index or -1. (The reference pays one
        sequential process_initial per candidate, mapper.cc:1027-1036.)"""
        options = options or SequentialMapperOptions()
        if self.num_proc_images > 0:
            raise ValueError("initial processing can only be called once")
        if not len(candidate_idxs):
            return -1
        with span("register.prepare", "reg_prepare_s", self):
            kp1, d1, m1, n1 = self._device_features(first_idx)
            kp2s, d2s, m2s, n2s = self._stacked_features(candidate_idxs)
        with span("batch.step", "batch_register_s", self):
            with span("register.dispatch", "reg_dispatch_s", self):
                rows, scalars = two_view_init_batch(
                    self._gen, kp1, d1, m1, n1, kp2s, d2s, m2s, n2s, options.match_max_ratio,
                    self._max_distance(options),
                    [self._norm_threshold(options.ransac_max_reproj_error, j)
                     for j in candidate_idxs],
                    essential_trials=options.essential_ransac_trials,
                    max_depth=options.max_depth, matcher=self._matcher_backend(options))
            rows, scalars = self._pull_batch(rows, scalars, len(candidate_idxs))
        with span("register.commit", "reg_commit_s", self):
            for k, j in enumerate(candidate_idxs):
                if self._two_view_gates_and_commit(first_idx, j,
                                                   unpack_two_view(rows[k], scalars[k]),
                                                   options, debug=debug):
                    return j
        return -1

    def _pull_batch(self, rows, scalars, n):
        """A batched registration step's outputs as numpy; counts its n
        slots."""
        with span("register.wait", "reg_wait_s", self):
            sync(2)
            rows, scalars = rows.cpu().numpy(), scalars.cpu().numpy()
        self._count("batch_register_slots", n)
        return rows, scalars

    def _step(self, step):
        """A batched registration step, or with a mesh the step with its
        slots split over the ranks (parallel/dist_register.py)."""
        if self.mesh is None:
            return step
        from functools import partial

        from ..parallel.dist_register import dist_step

        return partial(dist_step, self.mesh, step)

    def _check_replicated(self, what, *results):
        """With a mesh: raise unless every rank holds the same map (the
        counts, the registered poses, the 3-D points and the RANSAC
        generator's state) and the same `results`, bit for bit."""
        if self.mesh is None:
            return
        from ..parallel.multihost import digest

        st = self.store
        reg = np.flatnonzero(st.image_registered[: st.num_images])
        valid = np.flatnonzero(st.point3D_valid)
        self.mesh.check_same(what, [len(reg), len(valid)] + digest(
            st.image_rvecs[reg], st.image_tvecs[reg], st.point3D_xyz[valid],
            self._gen.get_state().numpy(), *results))

    def _dump_matches(self, idx_a, idx_b, r, inlier):
        """The step's matches before and after RANSAC (reference
        sequential_mapper.cc:82-97, 234-254, 406-455)."""
        kp_a = self._features(idx_a).keypoints
        kp_b = self._features(idx_b).keypoints
        for tag, inl in (("matches-all", None), ("matches-inlier", inlier)):
            self.debug_dumper.dump_matches(self.num_proc_images, idx_a, idx_b, kp_a, kp_b,
                                           r.matches, r.match_valid, inlier=inl, tag=tag)

    def _two_view_gates_and_commit(self, first_idx, second_idx, r, options, debug=False):
        """Host-side gates + commit of a two-view result (reference
        sequential_mapper.cc:100-386)."""
        num_matches = int(r.num_matches)
        if debug and self.debug_dumper is not None:
            self._dump_matches(first_idx, second_idx, r, r.e_inlier)
        if num_matches < 5:
            return False
        if options.min_disparity > 0 and float(r.med_disparity) < \
                self._abs_disparity(options.min_disparity, second_idx):
            return False
        if int(r.num_hom_inliers) > rel2abs_threshold(options.max_homography_inliers,
                                                      num_matches):
            return False
        if int(r.num_e_inliers) < rel2abs_threshold(options.ransac_min_inlier_threshold,
                                                    num_matches):
            return False
        if float(r.z_component) > 0.99:  # forward motion
            return False
        if float(r.mean_tri_angle) < options.tri_min_angle:
            return False

        # Commit: first pose = identity (reference :269-271).
        first_id = self._add_image_to_store(first_idx)
        second_id = self._add_image_to_store(second_idx)
        self.store.set_pose(first_id, np.zeros(3), np.zeros(3))
        self.store.set_pose(second_id, np.asarray(r.rvec2), np.asarray(r.tvec2))

        p2d_first = self.store.point2D_ids_of_image(first_id)
        p2d_second = self.store.point2D_ids_of_image(second_id)
        sel = np.where(r.e_inlier & (r.depth1 > 0))[0]
        pids = self.store.add_correspondences_bulk(
            p2d_first[sel], p2d_second[r.matches[sel]])
        for k, pid in enumerate(pids):
            self.store.set_point3D(pid, r.points3D[sel[k]])
        self.pair_graph.add((min(first_idx, second_idx), max(first_idx, second_idx)))
        return True

    # --------------------------------------------------------------- process

    def process(self, image_idx, prev_image_idx,
                options: SequentialMapperOptions = None, debug=False, samples=None):
        """Register `image_idx` against processed `prev_image_idx`
        (reference sequential_mapper.cc:389-934). samples: optional
        injected RANSAC samples (see register_view)."""
        options = options or SequentialMapperOptions()
        if image_idx == prev_image_idx:
            return False
        if not self.is_image_processed(prev_image_idx):
            if not self.is_image_processed(image_idx):
                raise ValueError("neither image of the pair is processed")
            image_idx, prev_image_idx = prev_image_idx, image_idx
        if self.is_pair_processed(image_idx, prev_image_idx):
            return True

        with span("register.prepare", "reg_prepare_s", self):
            kpp, dp_, mp_, npn = self._device_features(prev_image_idx)
            kpc, dc_, mc_, ncn = self._device_features(image_idx)
            prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, _ = \
                self._prev_track_state(prev_image_idx, options)
            ci = self.image_cameras[image_idx]
            f32 = torch.float32
            state = (self._tensor(xyz), self._tensor(has_tri), self._tensor(stable),
                     self._tensor(prev_rvec, f32), self._tensor(prev_tvec, f32),
                     self._tensor(self.cam_params[ci]))
        with span("register.dispatch", "reg_dispatch_s", self):
            out = register_view(
                self._gen, kpp, dp_, mp_, npn, kpc, dc_, mc_, ncn, *state,
                int(self.cam_models[ci]), options.match_max_ratio, self._max_distance(options),
                self._norm_threshold(options.ransac_max_reproj_error, image_idx),
                p3p_trials=options.p3p_ransac_trials, samples=samples,
                matcher=self._matcher_backend(options))
        # The JAX package's schedule: register first, then dispatch the
        # previous frame's deferred window solve, pull the outputs with
        # the results of the solve dispatched a step earlier.
        pulled = self._pull_with_pending(out)
        with span("register.commit", "reg_commit_s", self):
            r = unpack_register(*pulled)
            if not self._register_gates(image_idx, r, options, prev_image_idx, debug=debug):
                return False
            tri_nt = self._norm_threshold(options.tri_max_reproj_error, image_idx)
            return self._register_commit(image_idx, prev_image_idx, r, options,
                                         prev_p2d, has_tri, tri_nt, debug=debug)

    def _register_gates(self, image_idx, r, options, prev_image_idx=None, debug=False):
        """Host-side failure gates on the pulled register_view scalars
        (reference sequential_mapper.cc:389-732); with `debug`, the gate
        values are printed and the matches dumped."""
        num_matches = int(r.num_matches)
        num_stable = int(r.num_stable)
        min_inl = rel2abs_threshold(options.ransac_min_inlier_threshold, num_stable)
        max_hom = rel2abs_threshold(options.max_homography_inliers, num_matches)
        if debug:
            print(f"DEBUG process({image_idx},{prev_image_idx}): "
                  f"matches={num_matches} disp={float(r.med_disparity):.1f} "
                  f"hom={int(r.num_hom_inliers)}/{max_hom} stable={num_stable} "
                  f"p3p={int(r.num_p3p_inliers)}/{min_inl} "
                  f"cost={float(r.final_cost):.2f}/{options.final_cost_threshold}")
            if self.debug_dumper is not None:
                self._dump_matches(prev_image_idx, image_idx, r, r.p3p_inlier)
        if num_matches == 0:
            return False
        if options.min_disparity > 0 and float(r.med_disparity) < \
                self._abs_disparity(options.min_disparity, image_idx):
            return False
        if int(r.num_hom_inliers) > max_hom:
            return False
        if num_stable < max(min_inl, 4):
            return False
        if not bool(r.p3p_success):
            return False
        if int(r.num_p3p_inliers) < min_inl:
            return False
        return float(r.final_cost) <= options.final_cost_threshold

    def _register_commit(self, image_idx, prev_image_idx, r, options,
                         prev_p2d, has_tri, tri_nt, debug=False):
        """Commit a registration: pose, track continuations, new
        triangulations, pair graph (reference :743-934)."""
        n_prev_feats = len(prev_p2d)
        if self.is_image_processed(image_idx):
            curr_id = self.image_idx_to_id[image_idx]
        else:
            curr_id = self._add_image_to_store(image_idx)
            self.store.set_pose(curr_id, np.asarray(r.rvec), np.asarray(r.tvec))

        curr_p2d = self.store.point2D_ids_of_image(curr_id)
        ang = r.new_tri_angle
        min_ang = options.tri_min_angle * np.pi / 180.0

        rows = np.where(r.match_valid[:n_prev_feats])[0]
        jrows = r.matches[rows]
        # Continue a track if the existing point reprojects well (:764-777).
        cont = has_tri[rows] & (r.track_reproj[rows] < tri_nt)
        # New triangulation gates (:784-810).
        angf = np.minimum(ang[rows], np.pi - ang[rows])
        new = (~has_tri[rows]
               & (r.new_reproj_prev[rows] < tri_nt)
               & (r.new_reproj_curr[rows] < tri_nt)
               & (angf >= min_ang)
               & (r.new_depth_prev[rows] > 0)
               & (r.new_depth_curr[rows] > 0))
        if cont.any():
            self.store.add_correspondences_bulk(prev_p2d[rows[cont]],
                                                curr_p2d[jrows[cont]])
        if new.any():
            new_rows = rows[new]
            pids = self.store.add_correspondences_bulk(prev_p2d[new_rows],
                                                       curr_p2d[jrows[new]])
            fresh = self.store.point3D_valid[pids] & ~self.store.point3D_tri[pids]
            for k in np.where(fresh)[0]:
                self.store.set_point3D(pids[k], r.new_points3D[new_rows[k]])

        self.pair_graph.add((min(image_idx, prev_image_idx),
                             max(image_idx, prev_image_idx)))
        if debug and self.debug_dumper is not None:
            # Per-step track-length log and VRML scene of the current image's
            # points (reference sequential_mapper.cc:817-911).
            self.debug_dumper.dump_track_lengths(self.num_proc_images, image_idx,
                                                 prev_image_idx, self.store, curr_id)
            self.debug_dumper.dump_scene_vrml(self.num_proc_images, image_idx, prev_image_idx,
                                              self.store, curr_id,
                                              min_track_len=options.min_track_len)
        return True

    # ---------------------------------------------------------------- chains

    def process_chain(self, idxA, idxB, prev_image_idx,
                      options: SequentialMapperOptions = None, debug=False):
        """Register two consecutive frames in one device step. Returns
        (okA, okB); okB is None when frame A failed its gates (B was
        registered against a rejected anchor and must go through the
        normal path). `debug` prints each frame's gate decisions, as in
        process_chain_k."""
        oks = self.process_chain_k([idxA, idxB], prev_image_idx, options, debug=debug)
        if not oks[0]:
            return False, None
        return True, len(oks) > 1 and oks[1]

    def process_chain_k(self, idxs, prev_image_idx,
                        options: SequentialMapperOptions = None, debug=False, pad_to=None):
        """Register K consecutive frames in one device step
        (kernels.register_chain): frame k anchors on the track state derived
        on the device from frame k-1's results, and the results are pulled
        once for all K frames.

        Returns the per-frame commit results, truncated at the first
        failure: [True]*n means the first n frames committed; a trailing
        False means that frame failed its gates and the frames after it
        were not attempted (they registered against a rejected pose; the
        caller re-processes them through the normal path).

        pad_to: pad the chain to this length by repeating the last frame
        (its results are discarded), as the JAX package does to reuse one
        compiled program; here it only keeps the amount of work per chain
        the same."""
        return self.chain_complete(self.chain_dispatch(idxs, prev_image_idx, options,
                                                       pad_to=pad_to), debug=debug)

    def _chain_scal(self, idxs, options):
        """The packed scalars of a chain over `idxs` (see
        kernels._register_chain_impl) without the anchor pose, and each
        frame's triangulation threshold."""
        K = len(idxs)
        cis = [self.image_cameras[i] for i in idxs]
        tri_nts = [self._norm_threshold(options.tri_max_reproj_error, i) for i in idxs]
        scal = np.zeros(12 + 12 * K, np.float32)
        scal[6] = options.match_max_ratio
        scal[7] = self._max_distance(options)
        scal[8] = options.tri_min_angle * np.pi / 180.0
        scal[9] = options.min_track_len
        scal[10] = 0.0  # the JAX package's PRNG key counter; the generator holds the state
        scal[11] = -1.0  # anchor_row
        per = scal[12:].reshape(K, 12)
        per[:, 0] = [self._norm_threshold(options.ransac_max_reproj_error, i) for i in idxs]
        per[:, 1] = tri_nts
        per[:, 2] = self.cam_models[cis]
        per[:, 3:12] = self.cam_params[cis]
        return tri_nts, scal

    @staticmethod
    def _copy_early(out):
        """Issue the host copies of a chain's rows, scalars and has_tri_in
        right behind the chain, into pinned host tensors, and record a
        CUDA event behind them (the JAX package's _copy_async): the chain's
        pull then waits for that one event, one host sync instead of a
        blocking copy per output. Returns (host tensors, event); on the
        CPU the outputs are host tensors already and the event is None."""
        if out[0].device.type != "cuda":
            return tuple(out[:3]), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out[:3])
        for h, t in zip(host, out[:3]):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(out[0].device))
        return host, ready

    def chain_dispatch(self, idxs, prev_image_idx,
                       options: SequentialMapperOptions = None, pad_to=None):
        """First half of process_chain_k: dispatch the deferred window
        solves, then register the chain and issue the host copies of its
        outputs, without waiting for them. Returns a token for
        chain_complete."""
        options = options or SequentialMapperOptions()
        if not self.is_image_processed(prev_image_idx):
            raise ValueError("chain needs a processed previous image")
        for i in idxs:
            if self.is_image_processed(i):
                raise ValueError("chain frames must be unprocessed")

        n_real = len(idxs)
        K = max(pad_to or n_real, n_real)
        idxs = list(idxs) + [idxs[-1]] * (K - n_real)
        with span("register.prepare", "reg_prepare_s", self):
            kpp, dp_, mp_, npn = self._device_features(prev_image_idx)
            feats = tuple(self._device_features(i) for i in idxs)
            prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, lens = \
                self._prev_track_state(prev_image_idx, options)

        # Unlike process(), the previous chain's deferred window solves go
        # BEFORE this chain and land WITH it: one chain of anchor staleness
        # instead of two.
        handles = self._dispatch_deferred_ba()
        self._pending_ba += handles

        with span("register.prepare", "reg_prepare_s", self):
            F = self.provider.capacity
            track_state = np.zeros((F, 7), np.float32)
            track_state[:, :3] = xyz
            track_state[:, 3] = has_tri
            track_state[:, 4] = stable
            track_state[:, 5] = lens
            track_state[:, 6] = -1.0
            tri_nts, scal = self._chain_scal(idxs, options)
            scal[0:3] = prev_rvec
            scal[3:6] = prev_tvec

            # Anchor freshness: the solve just dispatched refines the
            # anchor's pose and most of its 3-D points, but its results
            # reach the store only after this chain's pull. The fresh
            # variant reads the anchor pose from the solve's output tensors
            # and gathers each row's 3-D point through track_state[:, 6].
            ba_args = None
            if handles:
                sel_ids_h, pids_h, h = handles[-1]
                prev_id = self.image_idx_to_id[prev_image_idx]
                anchor_row = sel_ids_h.index(prev_id) if prev_id in sel_ids_h else -1
                if anchor_row >= 0 and len(pids_h):
                    p3d = self.store.point2D_point3D[prev_p2d]
                    loc = np.minimum(np.searchsorted(pids_h, np.maximum(p3d, 0)),
                                     len(pids_h) - 1)
                    ok = has_tri[: len(prev_p2d)] & (p3d >= 0) & (pids_h[loc] == p3d)
                    track_state[: len(prev_p2d), 6][ok] = loc[ok]
                    scal[11] = anchor_row
                    ba_args = (h.fut[0], h.fut[1])

        common = dict(p3p_trials=options.p3p_ransac_trials,
                      matcher=self._matcher_backend(options))
        with span("register.dispatch", "reg_dispatch_s", self):
            if ba_args is not None:
                out = register_chain_fresh(self._gen, kpp, dp_, mp_, npn, feats, track_state,
                                           scal, *ba_args, **common)
            else:
                out = register_chain(self._gen, kpp, dp_, mp_, npn, feats, track_state, scal,
                                     **common)
            host, ready = self._copy_early(out)
        self._count("chains")
        return _ChainToken(out, host, ready, idxs, n_real, prev_image_idx, prev_p2d, has_tri,
                           tri_nts, options)

    def chain_complete(self, token, debug=False):
        """Second half of process_chain_k: wait for the chain's host copies,
        land the pending window solves (in dispatch order), run the host
        gates and commit frame by frame. Returns the per-frame oks (see
        process_chain_k)."""
        rows_all, scalars_all, has_tri_in = self._pull_with_pending(token.host, token.ready)
        with span("register.commit", "reg_commit_s", self):
            anchor_idx, anchor_p2d = token.anchor_idx, token.anchor_p2d
            anchor_has_tri = token.has_tri
            oks = []
            for k, idx in enumerate(token.idxs[:token.n_real]):
                r = unpack_register(rows_all[k], scalars_all[k])
                ok = self._register_gates(idx, r, token.options, anchor_idx, debug=debug)
                if ok:
                    # The commit classifies rows with the same derived has_tri
                    # the device registered against.
                    ok = self._register_commit(idx, anchor_idx, r, token.options, anchor_p2d,
                                               anchor_has_tri, token.tri_nts[k], debug=debug)
                oks.append(bool(ok))
                if not ok:
                    break
                if k + 1 < token.n_real:
                    anchor_idx = idx
                    anchor_p2d = self.store.point2D_ids_of_image(self.image_idx_to_id[idx])
                    anchor_has_tri = has_tri_in[k + 1]
            return oks

    # --------------------------------------------------------- loop closure

    def find_similar_images(self, image_idx, num_images=30):
        """Most similar processed images via the loop detector (reference
        sequential_mapper.cc:2086-2103): (image_idxs, scores)."""
        if self.loop_detector is None:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        return self.loop_detector.query(self._features(image_idx), num_images=num_images,
                                        image_idx=image_idx)

    def _batch_match_counts(self, image_idx, cand_idxs, options):
        """Match counts of image_idx against many candidates in one batched
        K1 launch, the query shared by every slot (the loop-closure
        pre-gate: most candidates die at the match gate, and a full
        registration per candidate costs far more)."""
        if not len(cand_idxs):
            return np.zeros(0, np.int64)
        _, dq, mq, _ = self._device_features(image_idx)
        _, dstack, mstack, _ = self._stacked_features(cand_idxs)
        if self.mesh is not None:
            from ..parallel.dist_register import dist_match_counts

            sync()
            counts = dist_match_counts(self.mesh, dq, mq, dstack, mstack,
                                       options.match_max_ratio,
                                       self._matcher_backend(options)).cpu().numpy()
            self._check_replicated("the match-count pre-gate", counts)
            return counts
        _, ok = match_features_batched(dq, dstack, mq, mstack, ratio=options.match_max_ratio,
                                       backend=self._matcher_backend(options))
        sync()
        return torch.sum(ok, dim=-1).cpu().numpy()

    @staticmethod
    def _min_matches(options):
        """Matches a candidate needs before registration is worth trying:
        an absolute min-inlier threshold bounds them from below; a relative
        one cannot apply before matching, so a minimal P3P sample then."""
        t = options.ransac_min_inlier_threshold
        return max(4, int(t)) if t >= 1 else 4

    def detect_loop(self, image_idx, num_images=30, num_nh_images=15, nh_distance=30,
                    options=None, verbose=False):
        """Try to close loops against the most similar processed images
        (reference sequential_mapper.cc:1161-1215): candidates within
        `nh_distance` frames count against the `num_nh_images` neighborhood
        quota. A batched match-count pre-gate drops candidates that cannot
        pass the inlier threshold, the rest register in one batched step and
        commit in order. Returns the number of closures committed."""
        if self.loop_detector is None:
            return 0
        options = options or SequentialMapperOptions()
        with span("loop.query", "detect_query_s", self):
            idxs, _ = self.find_similar_images(image_idx, num_images)
        with span("loop.pregate", "detect_pregate_s", self):
            cand = [int(i) for i in idxs]
            match_counts = self._batch_match_counts(image_idx, cand, options)
        min_needed = self._min_matches(options)
        # The batched step registers the current image against processed
        # previous images; the current one may itself be unregistered (the
        # rescue path): its first commit sets its pose, as process() would.
        runnable = [i for i, c in zip(cand, match_counts)
                    if c >= min_needed and i != image_idx
                    and not self.is_pair_processed(image_idx, i)
                    and self.is_image_processed(i)]
        num_successes = 0
        num_nh = 0
        if runnable:
            results = self._batch_register_candidates(image_idx, runnable, options)
            self._count("detect_runnable", len(runnable))
            with span("register.commit", "reg_commit_s", self):
                for other, (r, prev_p2d, has_tri, tri_nt) in zip(runnable, results):
                    distance = abs(other - image_idx)
                    if not (num_nh < num_nh_images or distance > nh_distance):
                        continue
                    if not self._register_gates(image_idx, r, options):
                        continue
                    if self._register_commit(image_idx, other, r, options, prev_p2d, has_tri,
                                             tri_nt):
                        if verbose:
                            print(f"Closed loop to image #{other}")
                        num_successes += 1
                        if distance <= nh_distance:
                            num_nh += 1
        self._count("loop_closures", num_successes)
        return num_successes

    # Slots per batched registration step: more candidates or pairs run in
    # chunks of this many.
    BATCH_CHUNK = 32

    def _batch_register_candidates(self, image_idx, cand_idxs, options):
        """Register `image_idx` against many processed candidates in one
        batched step (register_view_batch). Returns [(RegisterResult,
        prev_p2d, has_tri, tri_nt)] aligned with cand_idxs. The track states
        are read once, before any commit (commits between candidates only
        touch shared tracks, which each commit's track merge handles)."""
        self.flush_ba()  # registration anchors on post-BA poses and points
        n = len(cand_idxs)
        if n > self.BATCH_CHUNK:
            out = []
            for k in range(0, n, self.BATCH_CHUNK):
                out.extend(self._batch_register_candidates(
                    image_idx, cand_idxs[k:k + self.BATCH_CHUNK], options))
            return out
        with span("register.prepare", "reg_prepare_s", self):
            states, xyz, has_tri, stable, rvecs, tvecs = self._stacked_states(cand_idxs,
                                                                               options)
            kpp, dp_, mp_, npn = self._stacked_features(cand_idxs)
            kpc, dc_, mc_, ncn = self._device_features(image_idx)
            ci = self.image_cameras[image_idx]
            tri_nt = self._norm_threshold(options.tri_max_reproj_error, image_idx)
            kparams = self._tensor(self.cam_params[ci])
        with span("batch.step", "batch_register_s", self):
            with span("register.dispatch", "reg_dispatch_s", self):
                rows, scalars = self._step(register_view_batch)(
                    self._gen, kpp, dp_, mp_, npn, kpc, dc_, mc_, ncn, xyz, has_tri, stable,
                    rvecs, tvecs, kparams, int(self.cam_models[ci]), options.match_max_ratio,
                    self._max_distance(options),
                    self._norm_threshold(options.ransac_max_reproj_error, image_idx),
                    p3p_trials=options.p3p_ransac_trials, matcher=self._matcher_backend(options))
            rows, scalars = self._pull_batch(rows, scalars, n)
        self._check_replicated("a batched candidate registration", scalars)
        return [(unpack_register(rows[k], scalars[k]), states[k][0], states[k][1], tri_nt)
                for k in range(n)]

    def batch_register_pairs(self, pairs, options, closure=False):
        """Register many (curr_idx, prev_idx) pairs in batched steps
        (register_view_pairs) and commit them in order with the usual gates;
        every prev must be processed. Returns the per-pair success list.
        More than BATCH_CHUNK pairs run in chunks, each committed before the
        next reads the track state.

        The back-fill pass (the reference pays a sequential process() per
        pair, mapper.cc:221-299). closure=True: the currents are already
        registered and each commit adds loop-closure correspondences (the
        final closure sweep)."""
        if not pairs:
            return []
        # Pending window solves land first: registration anchors on the
        # store's poses and points.
        self.flush_ba()
        n = len(pairs)
        if n > self.BATCH_CHUNK:
            out = []
            for k in range(0, n, self.BATCH_CHUNK):
                out.extend(self.batch_register_pairs(pairs[k:k + self.BATCH_CHUNK], options,
                                                     closure=closure))
            return out
        with span("register.prepare", "reg_prepare_s", self):
            states, xyz, has_tri, stable, rvecs, tvecs = self._stacked_states(
                [p for _, p in pairs], options)
            kpp, dp_, mp_, npn = self._stacked_features([p for _, p in pairs])
            kpc, dc_, mc_, ncn = self._stacked_features([c for c, _ in pairs])
            cis = [self.image_cameras[c] for c, _ in pairs]
            tri_nts = [self._norm_threshold(options.tri_max_reproj_error, c) for c, _ in pairs]
            kparams = self._tensor(self.cam_params[cis])
        with span("batch.step", "batch_register_s", self):
            with span("register.dispatch", "reg_dispatch_s", self):
                rows, scalars = self._step(register_view_pairs)(
                    self._gen, kpp, dp_, mp_, npn, kpc, dc_, mc_, ncn, xyz, has_tri, stable,
                    rvecs, tvecs, kparams, [int(self.cam_models[c]) for c in cis],
                    options.match_max_ratio, self._max_distance(options),
                    [self._norm_threshold(options.ransac_max_reproj_error, c) for c, _ in pairs],
                    p3p_trials=options.p3p_ransac_trials, matcher=self._matcher_backend(options))
            rows, scalars = self._pull_batch(rows, scalars, n)
        out = []
        with span("register.commit", "reg_commit_s", self):
            for k, (curr, prev) in enumerate(pairs):
                # Back-fill: every pair was built while `curr` was
                # unregistered; once an earlier pair registered it,
                # committing this one would add points triangulated with a
                # pose that never committed (the reference breaks on the
                # first success). Closure mode registers processed currents
                # by design.
                if not closure and self.is_image_processed(curr):
                    out.append(True)
                    continue
                if self.is_pair_processed(curr, prev):
                    out.append(not closure)
                    continue
                r = unpack_register(rows[k], scalars[k])
                ok = self._register_gates(curr, r, options)
                if ok:
                    ok = self._register_commit(curr, prev, r, options, states[k][0],
                                               states[k][1], tri_nts[k])
                out.append(bool(ok))
        self._check_replicated("a batched pair registration", scalars)
        return out

    # Pairs per batched K1 launch of the pair pre-gate.
    PREGATE_CHUNK = 64

    def _batch_match_counts_pairs(self, pairs, options):
        """Match counts of many (a, b) image pairs: every image's features
        go to the device once as one (U, F, D) stack, and each chunk of
        PREGATE_CHUNK pairs gathers its rows from it into one batched K1
        launch."""
        if not pairs:
            return np.zeros(0, np.int64)
        imgs = sorted({i for p in pairs for i in p})
        row = {i: k for k, i in enumerate(imgs)}
        feats = [self._features(i) for i in imgs]
        dstack = self._tensor(np.stack([f.descriptors for f in feats]))
        mstack = self._tensor(np.stack([f.mask for f in feats]))
        counts = []
        for k in range(0, len(pairs), self.PREGATE_CHUNK):
            chunk = pairs[k:k + self.PREGATE_CHUNK]
            ai = self._tensor([row[a] for a, _ in chunk], torch.int64)
            bi = self._tensor([row[b] for _, b in chunk], torch.int64)
            _, ok = match_features_batched(dstack[ai], dstack[bi], mstack[ai], mstack[bi],
                                           ratio=options.match_max_ratio,
                                           backend=self._matcher_backend(options))
            counts.append(torch.sum(ok, dim=-1))
        sync()
        return torch.cat(counts).cpu().numpy()

    def batch_detect_closures(self, query_idxs, num_images=30, nh_distance=30, options=None,
                              verbose=False):
        """Cross-survey loop closures for many query images (the final
        closure sweep): per query, retrieval picks the processed candidates
        beyond `nh_distance` frames; one pair pre-gate over every candidate
        pair keeps those that can pass the inlier threshold; they all
        register through batch_register_pairs with closure commits.
        Returns the number of closures committed."""
        if self.loop_detector is None:
            return 0
        options = options or SequentialMapperOptions()
        min_needed = self._min_matches(options)
        cand_pairs = []
        with span("loop.sweep_retrieval", "sweep_retrieval_s", self):
            for q in query_idxs:
                if not self.is_image_processed(q):
                    continue
                idxs, _ = self.find_similar_images(q, num_images)
                cand_pairs += [(q, int(c)) for c in idxs
                               if int(c) != q and abs(int(c) - q) > nh_distance
                               and self.is_image_processed(int(c))
                               and not self.is_pair_processed(q, int(c))]
        if not cand_pairs:
            return 0
        with span("loop.sweep_pregate", "sweep_pregate_s", self):
            counts = self._batch_match_counts_pairs(cand_pairs, options)
            jobs = [p for p, n in zip(cand_pairs, counts) if n >= min_needed]
        if not jobs:
            return 0
        got = self.batch_register_pairs(jobs, options, closure=True)
        self._count("sweep_jobs", len(jobs))
        self._count("sweep_cands", len(cand_pairs))
        n = 0
        for (q, c), ok in zip(jobs, got):
            if ok:
                n += 1
                if verbose:
                    print(f"Closed loop #{q} -> #{c}")
        self._count("sweep_closures", n)
        return n

    # ----------------------------------------------------------------- merge

    def merge(self, other, num_similar_images=15, num_skip_images=5, options=None,
              verbose=False):
        """Merge `other` into this mapper through cross-sequence loop
        closures and a similarity alignment (reference
        sequential_mapper.cc:1218-1481). Both mappers share the feature
        provider. Returns True on success; on failure this mapper keeps the
        closures it committed but nothing of `other`.

        Counters: merge_common_before / merge_common_after (images
        registered in both maps before the closures, and when the alignment
        is solved), merge_closures, merges."""
        from ..ops.similarity import solve_umeyama, transform_points, transform_pose

        options = options or SequentialMapperOptions()
        self.flush_ba()
        other.flush_ba()
        before_common = [idx for idx in other.image_idx_to_id if self.is_image_processed(idx)]

        # Close cross-loops on every num_skip_images-th image of `other`: all
        # candidates of one query in one batched registration step (the
        # reference runs a full process() per candidate).
        other_idxs = sorted(other.image_idx_to_id.keys())
        closures = 0
        for k, idx in enumerate(other_idxs):
            if num_skip_images and k % num_skip_images != 0:
                continue
            sim_idxs, _ = self.find_similar_images(idx, num_similar_images)
            cands = [int(c) for c in sim_idxs
                     if int(c) != idx and not self.is_pair_processed(idx, int(c))
                     and self.is_image_processed(int(c))]
            if not cands:
                continue
            results = self._batch_register_candidates(idx, cands, options)
            with span("register.commit", "reg_commit_s", self):
                for cand, (r, prev_p2d, has_tri, tri_nt) in zip(cands, results):
                    if self._register_gates(idx, r, options, cand):
                        closures += bool(self._register_commit(idx, cand, r, options,
                                                               prev_p2d, has_tri, tri_nt))

        # Images processed in both mappers anchor the alignment.
        common = [idx for idx in other.image_idx_to_id if self.is_image_processed(idx)]
        if len(common) < 3:
            # Fallback (beyond reference sequential_mapper.cc:1311-1315, which
            # fails here): register frames that `other` processed next to
            # this map's frames directly into this map, as the back-fill
            # does, so that they become common anchors. It covers runs
            # without loop detection and segments whose overlap a sub-map
            # restart ate.
            mine = sorted(self.image_idx_to_id.keys())
            cand_pairs = []
            for idx in other_idxs:
                if self.is_image_processed(idx):
                    continue
                below = [p for p in mine if p < idx]
                above = [p for p in mine if p > idx]
                if below:
                    cand_pairs.append((abs(idx - below[-1]), idx, below[-1]))
                if above:
                    cand_pairs.append((abs(idx - above[0]), idx, above[0]))
            cand_pairs.sort()
            pairs = [(c, p) for _, c, p in cand_pairs[:16]]
            if pairs:
                self.batch_register_pairs(pairs, options)
                common = [idx for idx in other.image_idx_to_id if self.is_image_processed(idx)]
                if verbose and len(common) >= 3:
                    print(f"Merge overlap widened to {len(common)} common images via "
                          f"adjacency registration")
        self._count("merge_closures", closures)
        if len(common) < 3:
            return False

        # The similarity other -> this from the common camera centres, in
        # float32 on the host as the JAX version solves it.
        def centers(mapper, idxs):
            ids = [mapper.image_idx_to_id[i] for i in idxs]
            R = rotmat_from_rvec(torch.as_tensor(mapper.store.image_rvecs[ids],
                                                 dtype=torch.float32)).numpy()
            return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), mapper.store.image_tvecs[ids])

        T = solve_umeyama(torch.as_tensor(centers(other, common), dtype=torch.float32),
                          torch.as_tensor(centers(self, common), dtype=torch.float32))

        # Clone other's images with transformed poses.
        for idx in other_idxs:
            if self.is_image_processed(idx):
                continue
            rv, tv = other.store.get_pose(other.image_idx_to_id[idx])
            nrv, ntv = transform_pose(T, torch.as_tensor(rv, dtype=torch.float32),
                                      torch.as_tensor(tv, dtype=torch.float32))
            self.store.set_pose(self._add_image_to_store(idx), nrv.numpy(), ntv.numpy())

        # Clone other's tracks, with transformed points, in one bulk call: a
        # point2D id translation table (other's store rows -> this store's;
        # the shared provider makes row r of an image the same keypoint in
        # both), then every track's chain of consecutive pairs. Tracks go in
        # other.store.tracks order (pid order on both backends).
        xyz_all = transform_points(T, torch.as_tensor(other.store.point3D_xyz,
                                                      dtype=torch.float32)).numpy()
        trans = np.full(other.store.num_points2D, -1, np.int64)
        for idx in other_idxs:
            trans[other.store.point2D_ids_of_image(other.image_idx_to_id[idx])] = \
                self.store.point2D_ids_of_image(self.image_idx_to_id[idx])
        pairs_a, pairs_b, track_pids = [], [], []
        for pid, track in other.store.tracks.items():
            if not other.store.point3D_valid[pid] or len(track) < 2:
                continue
            arr = trans[np.asarray(track, np.int64)]
            pairs_a.append(arr[:-1])
            pairs_b.append(arr[1:])
            track_pids.append(pid)
        if pairs_a:
            new_pids = self.store.add_correspondences_bulk(np.concatenate(pairs_a),
                                                           np.concatenate(pairs_b))
            # The surviving pid of each cloned track is its last pair's.
            last = np.cumsum([len(x) for x in pairs_a]) - 1
            for pid, k in zip(track_pids, last):
                if not other.store.point3D_tri[pid]:
                    continue
                new_pid = int(new_pids[k])
                valid, tri = self.store.point3D_status(new_pid)
                if valid and not tri:
                    self.store.set_point3D(new_pid, xyz_all[pid])

        self.pair_graph |= other.pair_graph
        self._count("merges")
        self._count("merge_common_before", len(before_common))
        self._count("merge_common_after", len(common))
        if verbose:
            print(f"Merged mappers with {len(common)} common images "
                  f"({len(before_common)} before closure)")
        return True

    # ------------------------------------------------------ bundle adjustment

    def _apply_ba(self, pending):
        """Land one solve's results (sel_ids, pids, finalize) in the store."""
        sel_ids, pids, finalize = pending
        with span("ba.apply", "ba_apply_s", self):
            new_poses, new_points, info = finalize()
            self.apply_ba_result(sel_ids, new_poses, pids, new_points,
                                 point_errors=info.get("point_errors"))
            if "cam_params" in info:
                self._adopt_cam_params(info["cam_params"])
        self._count("ba_iters", int(info["iterations"]))
        self._count("ba_applied")
        return info

    def _dispatch_deferred_ba(self):
        """Dispatch every deferred window problem, in order (each solve runs
        here, see bundle_adjust_async); returns their handles."""
        deferred, self._deferred_ba = self._deferred_ba, []
        handles = []
        for sel_ids, pids, prob, ba_options, n_obs in deferred:
            with span("ba.solve", "ba_solve_s", self):
                handles.append((sel_ids, pids, bundle_adjust_async(
                    prob, ba_options, device=self.device, num_obs=n_obs)))
        return handles

    def _pull_with_pending(self, out, ready=None):
        """Dispatch the deferred solves, bring the step's output tensors to
        the host, then apply the solves pending from earlier dispatches in
        dispatch order; the ones just dispatched become pending. `out` may
        be host copies issued earlier (_copy_early), with the CUDA event
        `ready` behind them: then only that event is waited for (one host
        sync, which CUDA's sync debug mode does not see). Returns the
        outputs as numpy arrays."""
        newly = self._dispatch_deferred_ba()
        with span("register.wait", "reg_wait_s", self):
            sync(len(out) if ready is None else 1)
            if ready is not None:
                ready.synchronize()
            vals = tuple(t.cpu().numpy() for t in out)
        self._count("pulls")
        pending, self._pending_ba = self._pending_ba, []
        for p in pending:
            self._apply_ba(p)
        self._pending_ba += newly
        return vals

    def flush_ba(self):
        """Land every pending and deferred solve in the store; returns the
        info of the last one (None if there was none)."""
        info = None
        pending, self._pending_ba = self._pending_ba, []
        for p in pending:
            info = self._apply_ba(p)
        for h in self._dispatch_deferred_ba():
            info = self._apply_ba(h)
        return info

    def _adopt_cam_params(self, new_k):
        """Self-calibration: adopt refined intrinsics (store + mapper) and
        drop cached normalized coordinates computed with the old ones."""
        new_k = new_k[: self.store.num_cameras]
        if np.array_equal(new_k, self.store.camera_params):
            return
        self.store.camera_params[:] = new_k
        for cam_idx, store_id in self._store_cam_ids.items():
            self.cam_params[cam_idx] = new_k[store_id]
        self._norm_cache.clear()
        self._dev_norm_cache.clear()

    def _align_model_to_rot_prior(self, fixed_image_idx, prior_rvec):
        """Rotate all poses and points into the rotation priors' frame
        (the reference's model re-alignment before adding rotation
        constraints, bundle_adjustment.cc:390-446). From the fixed image's
        estimated rotation R_est and prior R_pri (both world->cam; priors in
        the IMU world frame), the frame rotation is A = R_pri^T R_est
        (x_imu = A x_model): points map as X' = A X, poses as R' = R A^T with
        t unchanged, so the fixed image's rotation equals its prior and the
        free images' w (R - R0) residuals compare in the priors' frame."""
        def rot(rv):
            return rotmat_from_rvec(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

        R_est = rot(self.store.image_rvecs[self.image_idx_to_id[fixed_image_idx]])
        A = rot(prior_rvec).T @ R_est
        if np.abs(A - np.eye(3, dtype=A.dtype)).max() < 1e-7:
            return
        reg = np.where(self.store.image_registered[: self.store.num_images])[0]
        R = rot(self.store.image_rvecs[reg])
        self.store.image_rvecs[reg] = rvec_from_rotmat(torch.as_tensor(R @ A.T)).numpy()
        valid = self.store.point3D_valid
        self.store.point3D_xyz[valid] = self.store.point3D_xyz[valid] @ A.T.astype(np.float32)

    def adjust_bundle(self, free_image_idxs, fixed_image_idxs, fixed_x_image_idxs=(),
                      ba_options=None, rot_priors=None, rot_prior_weight=0.0, gcp_point_ids=(),
                      async_=False, defer=False):
        """Bundle-adjust a subset of images (reference adjust_bundle,
        sequential_mapper.cc:1030-1158). Returns the BA info dict, or None
        on the asynchronous schedule:

        async_: the solve is dispatched now and its results land at the
        next pull (process / chain_complete) or flush_ba;
        defer (with async_): the problem is built from the store now but
        dispatched only at the next register step, so the solve does not
        hold up that step's pull (the JAX package's schedule; the solve
        starts from state one window solve staler, and the windowed LM
        re-converges). At most 8 problems wait; a ninth lands them first.

        rot_priors: optional {image_idx: prior rvec} (IMU rotation priors),
        weighted by rot_prior_weight; with a positive weight the whole model
        is first rotated into the priors' frame, from the first fixed image
        that has a prior (earlier solves land before that). gcp_point_ids:
        store point ids held fixed.
        """
        align = bool(rot_priors) and rot_prior_weight > 0
        if async_ and defer and not align:
            if len(self._deferred_ba) >= 8:
                self.flush_ba()
        else:
            self.flush_ba()  # earlier solves land before this one reads the store
        if align:
            for fi in list(fixed_image_idxs) + list(fixed_x_image_idxs):
                if fi in rot_priors and fi in self.image_idx_to_id:
                    self._align_model_to_rot_prior(fi, rot_priors[fi])
                    break
        ba_options = ba_options or BAOptions()
        sel_idxs = list(free_image_idxs) + list(fixed_image_idxs) + list(fixed_x_image_idxs)
        sel_ids = [self.image_idx_to_id[i] for i in sel_idxs]
        states = ([0] * len(free_image_idxs) + [BA_POSE_FIXED] * len(fixed_image_idxs)
                  + [BA_POSE_FIXED_X] * len(fixed_x_image_idxs))
        poses = np.concatenate([self.store.image_rvecs[sel_ids],
                                self.store.image_tvecs[sel_ids]], axis=1).astype(np.float32)

        obs_img_raw, obs_pt_raw, obs_xy, _ = self.store.observation_table(
            min_track_len=ba_options.min_track_len, image_ids=sel_ids)
        row_of_id = np.full(self.store.num_images, -1, np.int32)
        for k, iid in enumerate(sel_ids):
            row_of_id[iid] = k
        obs_rows = row_of_id[obs_img_raw]
        keep = obs_rows >= 0
        if keep.sum() < 1:
            return None
        obs_img_raw = obs_img_raw[keep]
        obs_pt_raw = obs_pt_raw[keep]
        obs_xy = obs_xy[keep]
        obs_image = obs_rows[keep]
        # Points need >= 2 observations inside the problem to be solvable;
        # single-observation points are held fixed.
        pids, obs_point, counts = np.unique(obs_pt_raw, return_inverse=True,
                                            return_counts=True)
        obs_point = obs_point.astype(np.int32)
        points = self.store.point3D_xyz[pids].astype(np.float32)
        point_fixed = counts < 2
        gcp = np.asarray(list(gcp_point_ids))
        if len(gcp):
            point_fixed |= np.isin(pids, gcp)
        obs_cam = self.store.image_cameras[obs_img_raw].astype(np.int32)

        rp = np.zeros((len(sel_ids), 3), np.float32)
        rw = np.zeros((len(sel_ids),), np.float32)
        if rot_priors:
            for k, idx in enumerate(sel_idxs):
                if idx in rot_priors:
                    rp[k] = rot_priors[idx]
                    rw[k] = rot_prior_weight

        if (ba_options.refine_camera_params and not async_
                and len(obs_xy) > ba_options.selfcal_max_obs):
            # Two-stage self-calibration: stage 1 refines the shared
            # intrinsics on an observation subsample, stage 2 runs the FULL
            # problem with them held fixed.
            stride = int(np.ceil(len(obs_xy) / ba_options.selfcal_max_obs))
            sub = np.arange(0, len(obs_xy), stride)
            pids_s, obs_point_s, counts_s = np.unique(
                obs_pt_raw[sub], return_inverse=True, return_counts=True)
            point_fixed_s = counts_s < 2
            if len(gcp):
                point_fixed_s |= np.isin(pids_s, gcp)
            prob_s = build_problem(
                poses, self.store.point3D_xyz[pids_s].astype(np.float32),
                self.store.camera_params.astype(np.float32), self.store.camera_models,
                obs_image[sub], obs_point_s.astype(np.int32), obs_cam[sub], obs_xy[sub],
                pose_states=states, point_fixed=point_fixed_s, rot_prior=rp,
                rot_prior_weight=rw, bucket=True)
            with span("ba.selfcal", "ba_selfcal_s", self):
                _, _, info_s = bundle_adjust(
                    prob_s, _dc_replace(ba_options, update_point3D_errors=False),
                    device=self.device, num_obs=len(sub))
            self._count("ba_selfcal_iters", int(info_s["iterations"]))
            self._adopt_cam_params(info_s["cam_params"])
            ba_options = _dc_replace(ba_options, refine_camera_params=False)

        prob = build_problem(
            poses, points, self.store.camera_params.astype(np.float32),
            self.store.camera_models, obs_image, obs_point, obs_cam, obs_xy,
            pose_states=states, point_fixed=point_fixed, rot_prior=rp, rot_prior_weight=rw,
            bucket=True)
        n_obs = len(obs_xy)
        if async_ and defer:
            self._deferred_ba.append((sel_ids, pids, prob, ba_options, n_obs))
            return None
        if async_:
            with span("ba.solve", "ba_solve_s", self):
                self._pending_ba.append((sel_ids, pids, bundle_adjust_async(
                    prob, ba_options, device=self.device, num_obs=n_obs)))
            return None
        with span("ba.solve", "ba_solve_s", self):
            new_poses, new_points, info = bundle_adjust(prob, ba_options, device=self.device,
                                                        num_obs=n_obs)
        self._count("ba_iters", int(info["iterations"]))
        self.apply_ba_result(sel_ids, new_poses, pids, new_points,
                             point_errors=info.get("point_errors"))
        if "cam_params" in info:
            self._adopt_cam_params(info["cam_params"])
        return info

    def adjust_global_bundle(self, ba_options=None, rot_priors=None, rot_prior_weight=0.0,
                             gcp_point_ids=()):
        """Global BA: first processed pose fixed, second's x-translation
        fixed (reference sequential_mapper.cc:1092-1158); rot_priors and
        gcp_point_ids as in adjust_bundle. With a mesh the solve is sharded
        by 3-D point over the ranks (_adjust_global_bundle_dist)."""
        reg = [iid for iid in range(self.store.num_images)
               if self.store.image_registered[iid]]
        if len(reg) < 2:
            return None
        idxs = [self.image_id_to_idx[iid] for iid in reg]
        if self.mesh is not None:
            return self._adjust_global_bundle_dist(idxs, ba_options, rot_priors,
                                                   rot_prior_weight, gcp_point_ids)
        return self.adjust_bundle(idxs[2:], [idxs[0]], [idxs[1]], ba_options=ba_options,
                                  rot_priors=rot_priors, rot_prior_weight=rot_prior_weight,
                                  gcp_point_ids=gcp_point_ids)

    def _adjust_global_bundle_dist(self, idxs, ba_options=None, rot_priors=None,
                                   rot_prior_weight=0.0, gcp_point_ids=()):
        """The global BA sharded by 3-D point over the mesh's ranks
        (parallel/dist_ba.py): points and their observations split over
        the ranks, poses on every rank, the reduced camera system summed
        over the ranks per LM iteration. Self-calibration runs as the JAX
        package's two stages: stage 1 refines the shared intrinsics on one
        device (every rank alike) on an observation subsample (all of them
        up to selfcal_max_obs), stage 2 is the sharded solve with them held
        fixed, from the map's poses and points. The per-point errors are
        computed on every rank. Ground-control points stay fixed in both
        stages (the JAX version frees them in stage 1)."""
        from ..ba.core import point_mean_errors, problem_to_device, with_plans
        from ..parallel.dist_ba import dist_bundle_adjust, partition_problem

        ba_options = ba_options or BAOptions()
        if bool(rot_priors) and rot_prior_weight > 0:
            for fi in idxs[:2]:
                if fi in rot_priors:
                    self._align_model_to_rot_prior(fi, rot_priors[fi])
                    break
        (image_ids, poses, pids, points, obs_image, obs_point, obs_cam,
         obs_xy) = self.ba_problem_arrays(min_track_len=ba_options.min_track_len)
        if len(obs_xy) == 0:
            return None
        states = [0] * len(image_ids)
        states[0] = BA_POSE_FIXED
        states[1] = BA_POSE_FIXED_X
        gcp = np.asarray(list(gcp_point_ids))
        point_fixed = np.bincount(obs_point, minlength=len(points)) < 2
        if len(gcp):
            point_fixed |= np.isin(pids, gcp)
        rp = np.zeros((len(image_ids), 3), np.float32)
        rw = np.zeros((len(image_ids),), np.float32)
        if rot_priors:
            for k, iid in enumerate(image_ids):
                idx = self.image_id_to_idx[iid]
                if idx in rot_priors:
                    rp[k] = rot_priors[idx]
                    rw[k] = rot_prior_weight

        if ba_options.refine_camera_params:
            stride = max(int(np.ceil(len(obs_xy) / ba_options.selfcal_max_obs)), 1)
            sub = np.arange(0, len(obs_xy), stride)
            rows_s, obs_point_s, counts_s = np.unique(obs_point[sub], return_inverse=True,
                                                      return_counts=True)
            point_fixed_s = counts_s < 2
            if len(gcp):
                point_fixed_s |= np.isin(pids[rows_s], gcp)
            prob_s = build_problem(
                poses, points[rows_s], self.store.camera_params.astype(np.float32),
                self.store.camera_models, obs_image[sub], obs_point_s.astype(np.int32),
                obs_cam[sub], obs_xy[sub], pose_states=states, point_fixed=point_fixed_s,
                rot_prior=rp, rot_prior_weight=rw, bucket=True)
            with span("ba.selfcal", "ba_selfcal_s", self):
                _, _, info_s = bundle_adjust(
                    prob_s, _dc_replace(ba_options, update_point3D_errors=False),
                    device=self.device, num_obs=len(sub))
            self._count("ba_selfcal_iters", int(info_s["iterations"]))
            self._adopt_cam_params(info_s["cam_params"])

        cams = self.store.camera_params.astype(np.float32)
        mesh = self.mesh
        prob, new_index, per_shard = partition_problem(
            poses, points, cams, self.store.camera_models, obs_image, obs_point, obs_cam,
            obs_xy, mesh.size, pose_states=states, point_fixed=point_fixed, rot_prior=rp,
            rot_prior_weight=rw, bucket=True, shard=mesh.rank)
        with span("ba.solve", "ba_solve_s", self):
            new_poses, new_points, info = dist_bundle_adjust(
                mesh, prob, _dc_replace(ba_options, refine_camera_params=False,
                                        update_point3D_errors=False), per_shard)
        self._count_time("ba_collective_s", info["collective_s"])
        self._count("ba_iters", int(info["iterations"]))
        new_poses = new_poses[: len(image_ids)]
        new_points = new_points[new_index]

        point_errors = None
        if ba_options.update_point3D_errors:
            prob_e = build_problem(new_poses, new_points, cams, self.store.camera_models,
                                   obs_image, obs_point, obs_cam, obs_xy, bucket=True)
            prob_e = problem_to_device(with_plans(prob_e, ("plan_pt",)), self.device)
            sync()
            point_errors = point_mean_errors(prob_e, prob_e.poses,
                                             prob_e.points).cpu().numpy()[: len(points)]
        self.apply_ba_result(image_ids, new_poses, pids, new_points, point_errors=point_errors)
        self._check_replicated("the distributed global bundle adjustment", new_poses)
        return info

    def ba_problem_arrays(self, min_track_len=2):
        """Arrays for bundle adjustment over the current map: (image_ids,
        poses, point_ids, points, obs_image, obs_point, obs_cam, obs_xy)
        with image/point rows indexed densely in the returned order. Pending
        solves land first."""
        self.flush_ba()
        image_ids = [iid for iid in range(self.store.num_images)
                     if self.store.image_registered[iid]]
        poses = np.concatenate([self.store.image_rvecs[image_ids],
                                self.store.image_tvecs[image_ids]], axis=1).astype(np.float32)
        obs_img_raw, obs_pt_raw, obs_xy, _ = self.store.observation_table(
            min_track_len=min_track_len)
        pids = np.unique(obs_pt_raw)
        points = self.store.point3D_xyz[pids].astype(np.float32)
        obs_image = np.searchsorted(np.asarray(image_ids, np.int64),
                                    obs_img_raw).astype(np.int32)
        obs_point = np.searchsorted(pids, obs_pt_raw).astype(np.int32)
        obs_cam = self.store.image_cameras[obs_img_raw].astype(np.int32)
        return (image_ids, poses, pids, points, obs_image, obs_point, obs_cam,
                obs_xy.astype(np.float32))

    def apply_ba_result(self, image_ids, poses, point_ids, points, point_errors=None):
        ids = np.asarray(image_ids, np.int64)
        self.store.image_rvecs[ids] = poses[: len(ids), :3]
        self.store.image_tvecs[ids] = poses[: len(ids), 3:]
        pids = np.asarray(point_ids, np.int64)
        self.store.point3D_xyz[pids] = points[: len(pids)]
        if point_errors is not None:
            self.store.point3D_error[pids] = point_errors[: len(pids)]
