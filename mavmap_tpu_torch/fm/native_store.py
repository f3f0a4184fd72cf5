"""NativeTrackIndex — the C++ track graph behind the MapStore API.

Port of mavmap_tpu/fm/native_store.py: wraps the native map-store core
(native/mapstore.cc) for the bookkeeping ops (add_correspondence's
create / extend / merge / dedup). Geometry payloads (poses, xyz, uv) stay
in numpy on the Python side; the core owns the correspondence graph. Held
to the Python MapStore by tests/test_torch_native_store.py. Beyond the JAX
version, `load_tracks` restores a checkpoint's tracks under their own ids.
"""

import ctypes

import numpy as np

from ..native import load_mapstore_lib

_I64P = ctypes.POINTER(ctypes.c_int64)


def _ptr(a, ctype=_I64P):
    return a.ctypes.data_as(ctype)


class NativeTrackIndex:
    """Correspondence/track graph with native storage."""

    def __init__(self):
        self._lib = load_mapstore_lib()
        self._h = self._lib.ms_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ms_destroy(self._h)
            self._h = None

    def add_image(self, image_id, num_points2D):
        return int(self._lib.ms_add_image(self._h, int(image_id), int(num_points2D)))

    def add_correspondence(self, a, b):
        return int(self._lib.ms_add_correspondence(self._h, int(a), int(b)))

    def add_correspondences(self, a_arr, b_arr):
        a = np.ascontiguousarray(a_arr, np.int64)
        b = np.ascontiguousarray(b_arr, np.int64)
        if a.shape != b.shape or a.ndim != 1:
            raise ValueError(f"add_correspondences: shapes {a.shape} and {b.shape}")
        out = np.empty(len(a), np.int64)
        self._lib.ms_add_correspondences(self._h, _ptr(a), _ptr(b), len(a), _ptr(out))
        return out

    def load_tracks(self, num_points3D, tracks, tri):
        """Restore `tracks` ({point3D id: point2D ids}) under their own ids
        into a core that holds its images and no tracks: num_points3D slots
        with the triangulated flags `tri`, the listed ones valid."""
        pids = np.asarray(list(tracks.keys()), np.int64)
        lens = np.asarray([len(t) for t in tracks.values()], np.int64)
        flat = (np.concatenate([np.asarray(t, np.int64) for t in tracks.values()])
                if len(pids) else np.zeros(0, np.int64))
        tri = np.ascontiguousarray(tri, np.uint8)
        if len(tri) != num_points3D:
            raise ValueError(f"load_tracks: {len(tri)} tri flags for {num_points3D} points")
        n = self._lib.ms_load_tracks(self._h, int(num_points3D), len(pids), _ptr(pids),
                                     _ptr(lens), _ptr(flat),
                                     _ptr(tri, ctypes.POINTER(ctypes.c_uint8)))
        if n != len(pids):
            raise ValueError("load_tracks: a point3D or point2D id out of range, a point3D "
                             "id given twice, or a core that already holds tracks")

    def point3D_of(self, p2d):
        return int(self._lib.ms_point3D_of(self._h, int(p2d)))

    def track_len(self, pid):
        return int(self._lib.ms_track_len(self._h, int(pid)))

    def track(self, pid):
        out = np.empty(self.track_len(pid), np.int64)
        self._lib.ms_get_track(self._h, int(pid), _ptr(out))
        return out

    def set_tri(self, pid, tri=True):
        self._lib.ms_set_tri(self._h, int(pid), int(bool(tri)))

    def is_tri(self, pid):
        return bool(self._lib.ms_get_tri(self._h, int(pid)))

    def is_valid(self, pid):
        return bool(self._lib.ms_get_valid(self._h, int(pid)))

    def delete_point3D(self, pid):
        self._lib.ms_delete_point3D(self._h, int(pid))

    @property
    def num_points2D(self):
        return int(self._lib.ms_num_points2D(self._h))

    @property
    def num_points3D(self):
        return int(self._lib.ms_num_points3D(self._h))

    @property
    def capacity_points3D(self):
        return int(self._lib.ms_capacity_points3D(self._h))

    def export_point2D_point3D(self):
        out = np.empty(self.num_points2D, np.int64)
        self._lib.ms_export_p2d_point3D(self._h, _ptr(out))
        return out

    def export_point3D_flags(self):
        n = self.capacity_points3D
        valid = np.empty(n, np.uint8)
        tri = np.empty(n, np.uint8)
        tl = np.empty(n, np.int32)
        self._lib.ms_export_p3d_flags(self._h, _ptr(valid, ctypes.POINTER(ctypes.c_uint8)),
                                      _ptr(tri, ctypes.POINTER(ctypes.c_uint8)),
                                      _ptr(tl, ctypes.POINTER(ctypes.c_int32)))
        return valid.astype(bool), tri.astype(bool), tl
