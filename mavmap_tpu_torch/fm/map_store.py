"""MapStore — struct-of-arrays reconstruction state.

Counterpart of reference src/fm/feature_management.{h,cc}
(FeatureManager). The reference keeps 10 pointer-heavy unordered_maps
(feature_management.h:189-230); this rebuild is struct-of-arrays over dense
integer ids (row indices), with host-side numpy for the branchy track
bookkeeping; the numeric path (BA, triangulation) reads its arrays.

Semantics matched to the reference (validated by tests mirroring
fm/feature_management_test.cc:19-303):
  - add_correspondence creates a new 3-D point, extends an existing track,
    or merges two tracks keeping the LONGER one
    (feature_management.cc:107-226);
  - a track never holds more than one observation per image — duplicates
    are suppressed (feature_management.h:96-110);
  - find_tri_points returns which of an image's 2-D points have a
    *triangulated* 3-D point (feature_management.cc:258-288);
  - 3-D points carry a `tri` flag set by set_point3D and a mean reprojection
    error maintained by bundle adjustment.

Ids are monotonically allocated ints, never reused (delete just clears the
valid flag) — matching the reference's monotonic id allocation
(feature_management.cc:40-104).
"""

import numpy as np


def _grow(arr, new_rows):
    extra = np.zeros((new_rows,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, extra], axis=0)


class MapStore:
    def __init__(self, max_cam_params=9):
        self.max_cam_params = max_cam_params

        # Cameras.
        self.camera_params = np.zeros((0, max_cam_params), np.float64)
        self.camera_models = np.zeros((0,), np.int32)

        # Images: pose = (rvec[3], tvec[3]) world->cam; camera index.
        self.image_rvecs = np.zeros((0, 3), np.float64)
        self.image_tvecs = np.zeros((0, 3), np.float64)
        self.image_cameras = np.zeros((0,), np.int32)
        self.image_registered = np.zeros((0,), bool)

        # 2-D points (flat table across all images). Backed by capacity-
        # doubling buffers; the public point2D_* attributes are VIEWS of
        # length num_points2D (per-image np.concatenate would re-copy the
        # whole table on every add_image — quadratic on long sequences).
        self._p2d_cap = 0
        self._p2d_len = 0
        self._b_xy = np.zeros((0, 2), np.float64)
        self._b_xy_norm = np.zeros((0, 2), np.float64)
        self._b_image = np.zeros((0,), np.int32)
        self._b_p3d = np.zeros((0,), np.int64)
        self._refresh_p2d_views()
        self.image_point2D_start = []                         # per image: (start, n)

        # 3-D points — same capacity-doubling buffer/view scheme.
        self._p3_cap = 0
        self._p3_len = 0
        self._b3_xyz = np.zeros((0, 3), np.float64)
        self._b3_valid = np.zeros((0,), bool)
        self._b3_tri = np.zeros((0,), bool)
        self._b3_error = np.full((0,), -1.0, np.float64)
        self._b3_fixed = np.zeros((0,), bool)                # GCP pinning
        self._b3_track_len = np.zeros((0,), np.int32)
        self._refresh_p3d_views()
        # track: point3D id -> list of point2D ids.
        self.tracks = {}

    def _refresh_p2d_views(self):
        n = self._p2d_len
        self.point2D_xy = self._b_xy[:n]
        self.point2D_xy_norm = self._b_xy_norm[:n]
        self.point2D_image = self._b_image[:n]
        self.point2D_point3D = self._b_p3d[:n]

    def _refresh_p3d_views(self):
        n = self._p3_len
        self.point3D_xyz = self._b3_xyz[:n]
        self.point3D_valid = self._b3_valid[:n]
        self.point3D_tri = self._b3_tri[:n]
        self.point3D_error = self._b3_error[:n]
        self.point3D_fixed = self._b3_fixed[:n]
        self.point3D_track_len = self._b3_track_len[:n]

    def reserve_points3D(self, new_len):
        """Extend the 3-D point tables to `new_len` rows (amortized O(1);
        new rows invalid/zeroed, error -1)."""
        if new_len <= self._p3_len:
            return
        if new_len > self._p3_cap:
            new_cap = max(new_len, 2 * self._p3_cap, 4096)

            def grow(buf, dtype, fill=0):
                nb = np.full((new_cap,) + buf.shape[1:], fill, dtype)
                nb[: self._p3_len] = buf[: self._p3_len]
                return nb

            self._b3_xyz = grow(self._b3_xyz, np.float64)
            self._b3_valid = grow(self._b3_valid, bool, False)
            self._b3_tri = grow(self._b3_tri, bool, False)
            self._b3_error = grow(self._b3_error, np.float64, -1.0)
            self._b3_fixed = grow(self._b3_fixed, bool, False)
            self._b3_track_len = grow(self._b3_track_len, np.int32)
            self._p3_cap = new_cap
        self._p3_len = new_len
        self._refresh_p3d_views()

    def _reserve_p2d(self, n):
        need = self._p2d_len + n
        if need > self._p2d_cap:
            new_cap = max(need, 2 * self._p2d_cap, 4096)

            def grow(buf, dtype, fill=0):
                nb = np.full((new_cap,) + buf.shape[1:], fill, dtype)
                nb[: self._p2d_len] = buf[: self._p2d_len]
                return nb

            self._b_xy = grow(self._b_xy, np.float64)
            self._b_xy_norm = grow(self._b_xy_norm, np.float64)
            self._b_image = grow(self._b_image, np.int32)
            self._b_p3d = grow(self._b_p3d, np.int64, fill=-1)
            self._p2d_cap = new_cap

    def sync(self):
        """No-op on the Python backend (native backend refreshes mirrors)."""

    # ------------------------------------------------------------------ ids

    @property
    def num_cameras(self):
        return len(self.camera_models)

    @property
    def num_images(self):
        return len(self.image_cameras)

    @property
    def num_points2D(self):
        return len(self.point2D_image)

    @property
    def num_points3D(self):
        return int(self.point3D_valid.sum())

    # -------------------------------------------------------------- cameras

    def add_camera(self, model_code, params):
        params = np.asarray(params, np.float64)
        row = np.zeros((1, self.max_cam_params), np.float64)
        row[0, : len(params)] = params
        self.camera_params = np.concatenate([self.camera_params, row], axis=0)
        self.camera_models = np.append(self.camera_models, np.int32(model_code))
        return self.num_cameras - 1

    # --------------------------------------------------------------- images

    def add_image(self, camera_id, points2D, points2D_norm=None):
        """Register an image's 2-D feature points. Returns (image_id, point2D_ids)."""
        points2D = np.asarray(points2D, np.float64).reshape(-1, 2)
        n = len(points2D)
        image_id = self.num_images
        self.image_rvecs = _grow(self.image_rvecs, 1)
        self.image_tvecs = _grow(self.image_tvecs, 1)
        self.image_cameras = np.append(self.image_cameras, np.int32(camera_id))
        self.image_registered = np.append(self.image_registered, False)

        start = self.num_points2D
        self._reserve_p2d(n)
        end = start + n
        self._b_xy[start:end] = points2D
        if points2D_norm is None:
            points2D_norm = np.zeros_like(points2D)
        self._b_xy_norm[start:end] = np.asarray(
            points2D_norm, np.float64).reshape(-1, 2)
        self._b_image[start:end] = image_id
        self._b_p3d[start:end] = -1
        self._p2d_len = end
        self._refresh_p2d_views()
        self.image_point2D_start.append((start, n))
        return image_id, np.arange(start, start + n)

    def point2D_ids_of_image(self, image_id):
        start, n = self.image_point2D_start[image_id]
        return np.arange(start, start + n)

    def set_pose(self, image_id, rvec, tvec):
        self.image_rvecs[image_id] = np.asarray(rvec, np.float64)
        self.image_tvecs[image_id] = np.asarray(tvec, np.float64)
        self.image_registered[image_id] = True

    def get_pose(self, image_id):
        return self.image_rvecs[image_id].copy(), self.image_tvecs[image_id].copy()

    # ------------------------------------------------------------- points3D

    def _new_point3D(self, xyz=None):
        pid = self._p3_len
        self.reserve_points3D(pid + 1)
        if xyz is not None:
            self.point3D_xyz[pid] = np.asarray(xyz, np.float64)
        self.point3D_valid[pid] = True
        self.point3D_tri[pid] = xyz is not None
        self.tracks[pid] = []
        return pid

    def set_point3D(self, point3D_id, xyz, error=None):
        self.point3D_xyz[point3D_id] = np.asarray(xyz, np.float64)
        self.point3D_tri[point3D_id] = True
        if error is not None:
            self.point3D_error[point3D_id] = error

    def delete_point3D(self, point3D_id):
        """Clear a 3-D point and detach its observations
        (reference feature_management.cc:247-255)."""
        for p2d in self.tracks.pop(point3D_id, []):
            self.point2D_point3D[p2d] = -1
        self.point3D_valid[point3D_id] = False
        self.point3D_tri[point3D_id] = False
        self.point3D_track_len[point3D_id] = 0

    def track_len(self, point3D_id):
        return len(self.tracks.get(point3D_id, ()))

    def point3D_status(self, point3D_id):
        """(valid, tri) for one point — safe immediately after writes on
        every backend (native queries the C++ core directly)."""
        return (
            bool(self.point3D_valid[point3D_id]),
            bool(self.point3D_tri[point3D_id]),
        )

    # ------------------------------------------------------ correspondences

    def _track_images(self, point3D_id):
        return set(self.point2D_image[p] for p in self.tracks[point3D_id])

    def _attach(self, point3D_id, p2d_id):
        """Attach an observation unless its image already observes the track."""
        img = self.point2D_image[p2d_id]
        if img in self._track_images(point3D_id):
            return False
        self.tracks[point3D_id].append(int(p2d_id))
        self.point2D_point3D[p2d_id] = point3D_id
        self.point3D_track_len[point3D_id] += 1
        return True

    def add_correspondences_bulk(self, pairs_a, pairs_b):
        """Batch add_correspondence; returns the surviving point3D ids
        (NativeMapStore overrides this with one C++ call)."""
        import numpy as _np

        return _np.asarray(
            [self.add_correspondence(a, b) for a, b in zip(pairs_a, pairs_b)],
            _np.int64,
        )

    def add_correspondence(self, p2d_a, p2d_b):
        """Register that two 2-D points observe the same 3-D point.

        Creates a new (untriangulated) 3-D point, extends a track, or merges
        two tracks keeping the longer one. Returns the surviving point3D id.
        Reference feature_management.cc:107-226.
        """
        ta = int(self.point2D_point3D[p2d_a])
        tb = int(self.point2D_point3D[p2d_b])

        if ta < 0 and tb < 0:
            pid = self._new_point3D()
            self.tracks[pid] = [int(p2d_a)]
            self.point2D_point3D[p2d_a] = pid
            self.point3D_track_len[pid] = 1
            self._attach(pid, p2d_b)
            return pid
        if ta >= 0 and tb < 0:
            self._attach(ta, p2d_b)
            return ta
        if tb >= 0 and ta < 0:
            self._attach(tb, p2d_a)
            return tb
        if ta == tb:
            return ta

        # Merge: keep the longer track (reference keeps the longer one and
        # de-duplicates per-image observations).
        keep, drop = (ta, tb) if self.track_len(ta) >= self.track_len(tb) else (tb, ta)
        for p2d in self.tracks[drop]:
            self._attach(keep, p2d)
            if self.point2D_point3D[p2d] == drop:
                # Duplicate image — detach from everything.
                self.point2D_point3D[p2d] = -1
        del self.tracks[drop]
        self.point3D_valid[drop] = False
        self.point3D_tri[drop] = False
        self.point3D_track_len[drop] = 0
        return keep

    def find_tri_points(self, image_id):
        """(point2D_ids, mask, point3D_ids) — which of an image's 2-D points
        have triangulated 3-D points (reference feature_management.cc:258-288)."""
        p2d = self.point2D_ids_of_image(image_id)
        p3d = self.point2D_point3D[p2d]
        mask = (p3d >= 0) & np.where(p3d >= 0, self.point3D_tri[np.maximum(p3d, 0)], False)
        return p2d, mask, p3d

    # -------------------------------------------------------- device export

    def observation_table(self, min_track_len=2, tri_only=True,
                          image_ids=None):
        """Flat (obs -> image, point3D, uv, uv_norm) arrays for BA.

        Only observations of valid (and optionally triangulated) 3-D points
        whose track length >= min_track_len. Fully vectorized over the
        point2D->point3D table — no per-track Python loop (this runs once
        per local BA, i.e. every frame).

        image_ids: restrict to observations of those images. Each image's
        point2D ids form one contiguous block, so the restriction is a
        range-concatenation instead of a full-table scan — keeps per-frame
        local-BA cost O(window) instead of O(total observations) on long
        sequences.
        """
        if image_ids is not None:
            cand = np.concatenate(
                [self.point2D_ids_of_image(i) for i in image_ids]
            ) if len(image_ids) else np.zeros(0, np.int64)
            p3d = self.point2D_point3D[cand]
        else:
            cand = None
            p3d = self.point2D_point3D
        sel = p3d >= 0
        pids = np.maximum(p3d, 0)
        ok = (
            sel
            & self.point3D_valid[pids]
            & (self.point3D_track_len[pids] >= min_track_len)
        )
        if tri_only:
            ok = ok & self.point3D_tri[pids]
        rows = np.where(ok)[0]
        if cand is not None:
            rows = cand[rows]
        return (
            self.point2D_image[rows].astype(np.int32),
            self.point2D_point3D[rows],
            self.point2D_xy[rows],
            self.point2D_xy_norm[rows],
        )
