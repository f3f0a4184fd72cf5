"""SequentialMapper — incremental SfM engine.

Port of the per-frame path of mavmap_tpu/sfm/mapper.py (reference
src/sfm/sequential_mapper.{h,cc}). The class owns the MapStore, the
idx<->id maps, the processed-pair graph and the per-image feature caches;
each `process*` call runs ONE device step (sfm/kernels.py) on the mapper's
device and applies the reference's failure gates host-side on the pulled
scalars:

  process_initial: disparity -> homography -> 5pt inliers -> forward-motion
  -> mean tri angle (sequential_mapper.cc:46-386);
  process: disparity -> homography -> #stable 2D-3D -> P3P inliers ->
  refinement final cost, then track continuation + new triangulations
  (sequential_mapper.cc:389-934).

Bundle adjustment runs synchronously on the same device. Thresholds in
pixels convert to normalized units with threshold / mean(fx, fy), like
the reference (camera_models.cc:47-52). Not in this package yet: chained
and batched registration, deferred/asynchronous BA, loop closure, merge,
IMU rotation priors and the multi-device global BA.
"""

import time as _time
from collections import OrderedDict
from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ..ba import BA_POSE_FIXED, BA_POSE_FIXED_X, BAOptions, build_problem, bundle_adjust
from ..fm import MapStore
from ..interop import features_to_device
from ..models import camera as cam
from ..utils.mathx import rel2abs_threshold
from .kernels import register_view, two_view_init, unpack_register, unpack_two_view
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


class SequentialMapper:
    def __init__(self, image_cameras, cam_models, cam_params, feature_provider,
                 device, seed=0, cache_capacity=128):
        """image_cameras: (num_images,) camera index per dataset image;
        cam_models/cam_params: per-camera model codes and padded params;
        feature_provider: FeatureProvider with fixed capacity; device: the
        torch device every step runs on; seed: RANSAC generator seed;
        cache_capacity: max images kept in the feature caches."""
        self.device = torch.device(device)
        self.image_cameras = np.asarray(image_cameras, np.int32)
        self.cam_models = np.asarray(cam_models, np.int32)
        # Own copy: self-calibration adopts refined intrinsics in place.
        self.cam_params = np.array(cam_params, np.float32)
        self.provider = feature_provider
        self.store = MapStore()
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
        # Event counters and accumulated seconds; free-form keys.
        self.counters = {}

    def _count(self, name, n=1):
        if n:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def _count_time(self, name, seconds):
        # Accumulates unrounded (the JAX version rounds on every add, which
        # drops sub-5 ms solves entirely); rounding happens in report().
        self.counters[name] = self.counters.get(name, 0.0) + float(seconds)

    def report(self):
        """The counters, with accumulated seconds rounded to 10 ms."""
        return {k: round(v, 2) if isinstance(v, float) else v
                for k, v in self.counters.items()}

    # ------------------------------------------------------------- helpers

    def _features(self, image_idx):
        return self._feat_cache.get_or(image_idx, lambda: self.provider.get(image_idx))

    def _device_features(self, image_idx):
        """Per-image (kp, desc, mask, normalized) tensors on the device."""

        kp, desc, mask = self._dev_feat_cache.get_or(
            image_idx, lambda: features_to_device(self._features(image_idx), self.device))
        n = self._dev_norm_cache.get_or(
            image_idx,
            lambda: torch.as_tensor(self._normalized(image_idx), device=self.device))
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
        self.store.sync()
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

    # ------------------------------------------------------ process_initial

    def process_initial(self, first_idx, second_idx,
                        options: SequentialMapperOptions = None, samples=None):
        """Two-view initialization (reference sequential_mapper.cc:46-386).
        samples: optional injected RANSAC samples (see two_view_init)."""
        options = options or SequentialMapperOptions()
        if self.num_proc_images > 0:
            raise ValueError("initial processing can only be called once")
        if first_idx == second_idx:
            raise ValueError("initial pair must be distinct images")

        kp1, d1, m1, n1 = self._device_features(first_idx)
        kp2, d2, m2, n2 = self._device_features(second_idx)
        rows, scalars = two_view_init(
            self._gen, kp1, d1, m1, n1, kp2, d2, m2, n2,
            options.match_max_ratio, self._max_distance(options),
            self._norm_threshold(options.ransac_max_reproj_error, first_idx),
            essential_trials=options.essential_ransac_trials,
            max_depth=options.max_depth, samples=samples)
        r = unpack_two_view(rows.cpu().numpy(), scalars.cpu().numpy())
        return self._two_view_gates_and_commit(first_idx, second_idx, r, options)

    def _two_view_gates_and_commit(self, first_idx, second_idx, r, options):
        """Host-side gates + commit of a two-view result (reference
        sequential_mapper.cc:100-386)."""
        num_matches = int(r.num_matches)
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
                options: SequentialMapperOptions = None, samples=None):
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

        kpp, dp_, mp_, npn = self._device_features(prev_image_idx)
        kpc, dc_, mc_, ncn = self._device_features(image_idx)
        prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, _ = \
            self._prev_track_state(prev_image_idx, options)
        ci = self.image_cameras[image_idx]

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        rows, scalars = register_view(
            self._gen, kpp, dp_, mp_, npn, kpc, dc_, mc_, ncn,
            t(xyz), t(has_tri), t(stable),
            t(prev_rvec, torch.float32), t(prev_tvec, torch.float32),
            t(self.cam_params[ci]), int(self.cam_models[ci]),
            options.match_max_ratio, self._max_distance(options),
            self._norm_threshold(options.ransac_max_reproj_error, image_idx),
            p3p_trials=options.p3p_ransac_trials, samples=samples)
        r = unpack_register(rows.cpu().numpy(), scalars.cpu().numpy())
        if not self._register_gates(image_idx, r, options):
            return False
        tri_nt = self._norm_threshold(options.tri_max_reproj_error, image_idx)
        return self._register_commit(image_idx, prev_image_idx, r, options,
                                     prev_p2d, has_tri, tri_nt)

    def _register_gates(self, image_idx, r, options):
        """Host-side failure gates on the pulled register_view scalars
        (reference sequential_mapper.cc:389-732)."""
        num_matches = int(r.num_matches)
        num_stable = int(r.num_stable)
        min_inl = rel2abs_threshold(options.ransac_min_inlier_threshold, num_stable)
        max_hom = rel2abs_threshold(options.max_homography_inliers, num_matches)
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
                         prev_p2d, has_tri, tri_nt):
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
            self.store.sync()
            fresh = self.store.point3D_valid[pids] & ~self.store.point3D_tri[pids]
            for k in np.where(fresh)[0]:
                self.store.set_point3D(pids[k], r.new_points3D[new_rows[k]])

        self.pair_graph.add((min(image_idx, prev_image_idx),
                             max(image_idx, prev_image_idx)))
        return True

    # ------------------------------------------------------ bundle adjustment

    def flush_ba(self):
        """Bundle adjustment here is synchronous: nothing is ever in flight."""
        return None

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

    def adjust_bundle(self, free_image_idxs, fixed_image_idxs, fixed_x_image_idxs=(),
                      ba_options=None, gcp_point_ids=()):
        """Bundle-adjust a subset of images (reference adjust_bundle,
        sequential_mapper.cc:1030-1158). Returns the BA info dict."""
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

        if ba_options.refine_camera_params and len(obs_xy) > ba_options.selfcal_max_obs:
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
                pose_states=states, point_fixed=point_fixed_s, bucket=True)
            t0 = _time.perf_counter()
            _, _, info_s = bundle_adjust(
                prob_s, _dc_replace(ba_options, update_point3D_errors=False),
                self.device, num_obs=len(sub))
            self._count_time("ba_selfcal_s", _time.perf_counter() - t0)
            self._count("ba_selfcal_iters", int(info_s["iterations"]))
            self._adopt_cam_params(info_s["cam_params"])
            ba_options = _dc_replace(ba_options, refine_camera_params=False)

        prob = build_problem(
            poses, points, self.store.camera_params.astype(np.float32),
            self.store.camera_models, obs_image, obs_point, obs_cam, obs_xy,
            pose_states=states, point_fixed=point_fixed, bucket=True)
        t0 = _time.perf_counter()
        new_poses, new_points, info = bundle_adjust(prob, ba_options, self.device,
                                                    num_obs=len(obs_xy))
        self._count_time("ba_solve_s", _time.perf_counter() - t0)
        self._count("ba_iters", int(info["iterations"]))
        self.apply_ba_result(sel_ids, new_poses, pids, new_points,
                             point_errors=info.get("point_errors"))
        if "cam_params" in info:
            self._adopt_cam_params(info["cam_params"])
        return info

    def adjust_global_bundle(self, ba_options=None, gcp_point_ids=()):
        """Global BA: first processed pose fixed, second's x-translation
        fixed (reference sequential_mapper.cc:1092-1158)."""
        reg = [iid for iid in range(self.store.num_images)
               if self.store.image_registered[iid]]
        if len(reg) < 2:
            return None
        idxs = [self.image_id_to_idx[iid] for iid in reg]
        return self.adjust_bundle(idxs[2:], [idxs[0]], [idxs[1]],
                                  ba_options=ba_options, gcp_point_ids=gcp_point_ids)

    def ba_problem_arrays(self, min_track_len=2):
        """Arrays for bundle adjustment over the current map: (image_ids,
        poses, point_ids, points, obs_image, obs_point, obs_cam, obs_xy)
        with image/point rows indexed densely in the returned order."""
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
