"""NativeMapStore — MapStore with the track graph owned by the C++ core.

Port of mavmap_tpu/fm/native_map_store.py. A subclass of this package's
Python MapStore: geometry payloads (poses, xyz, errors, uv tables) stay
numpy; the correspondence/track bookkeeping (add_correspondence's create /
extend / merge / dedup) runs in native code (native/mapstore.cc). Readers
see the Python store's arrays: point2D_point3D, point3D_valid, point3D_tri
and point3D_track_len are mirrors of the core, exported again (one bulk
copy) on the first read after a write. The JAX version leaves that refresh
to its callers (sync()); here every read gets it, and sync() is a no-op
kept for those callers.

Select with create_map_store("native" | "auto" | "python").
"""

import numpy as np

from .map_store import MapStore
from .native_store import NativeTrackIndex


def _mirror(name):
    key = "_mirror_" + name

    def get(self):
        if self._dirty:
            self._sync()
        return self.__dict__[key]

    def put(self, value):
        self.__dict__[key] = value

    return property(get, put, doc=f"{name}, refreshed from the native core on read")


class NativeMapStore(MapStore):
    backend = "native"
    _dirty = False  # the base __init__ reads the mirrors before ours runs
    _tracks_cache = None

    point2D_point3D = _mirror("point2D_point3D")
    point3D_valid = _mirror("point3D_valid")
    point3D_tri = _mirror("point3D_tri")
    point3D_track_len = _mirror("point3D_track_len")

    def __init__(self, max_cam_params=9):
        self._idx = NativeTrackIndex()
        super().__init__(max_cam_params)

    # -- write path ---------------------------------------------------------

    def add_image(self, camera_id, points2D, points2D_norm=None):
        image_id, p2d = super().add_image(camera_id, points2D, points2D_norm)
        self._idx.add_image(image_id, len(p2d))
        return image_id, p2d

    def add_correspondence(self, p2d_a, p2d_b):
        pid = self._idx.add_correspondence(int(p2d_a), int(p2d_b))
        self._dirty = True
        self._grow_payload(pid)
        return pid

    def add_correspondences_bulk(self, pairs_a, pairs_b):
        pids = self._idx.add_correspondences(pairs_a, pairs_b)
        self._dirty = True
        if len(pids):
            self._grow_payload(int(pids.max()))
        return pids

    def set_point3D(self, point3D_id, xyz, error=None):
        self._grow_payload(point3D_id)
        self.point3D_xyz[point3D_id] = np.asarray(xyz, np.float64)
        self._idx.set_tri(int(point3D_id), True)
        self.point3D_tri[point3D_id] = True
        if error is not None:
            self.point3D_error[point3D_id] = error

    def delete_point3D(self, point3D_id):
        self._idx.delete_point3D(int(point3D_id))
        self._dirty = True

    def _grow_payload(self, pid):
        self.reserve_points3D(pid + 1)

    def load_state(self, arrays, tracks):
        """MapStore.load_state into a fresh core: the tracks keep their
        point3D ids (the JAX version replays them as correspondences, which
        numbers them anew)."""
        self._idx = NativeTrackIndex()
        self._dirty = False
        super().load_state(arrays, tracks)

    def _load_tracks(self, tracks):
        for image_id, (_, n) in enumerate(self.image_point2D_start):
            self._idx.add_image(image_id, n)
        self._idx.load_tracks(self._p3_len, tracks, self.point3D_tri)
        self._dirty = True

    # -- read path ----------------------------------------------------------

    def _sync(self):
        if not self._dirty:
            return
        self._dirty = False  # first: the writes below read the mirrors
        # In-place copy into the view: keeps the capacity-doubling buffer
        # as the single backing store (appends and syncs stay consistent).
        self.point2D_point3D[:] = self._idx.export_point2D_point3D()
        cap = self._idx.capacity_points3D
        self._grow_payload(cap - 1)
        valid, tri, tl = self._idx.export_point3D_flags()
        self.point3D_valid[:cap] = valid
        self.point3D_tri[:cap] = tri
        self.point3D_track_len[:cap] = tl
        self._tracks_cache = None

    @property
    def tracks(self):
        """Materialized {pid: [p2d...]} view in pid order (built on demand;
        for the merge, output and checkpoint paths, not the per-frame
        path)."""
        self._sync()
        if self._tracks_cache is None:
            self._tracks_cache = {int(pid): self._idx.track(pid).tolist()
                                  for pid in np.where(self.point3D_valid)[0]}
        return self._tracks_cache

    @tracks.setter
    def tracks(self, value):
        # The base __init__ assigns {}; the core owns the graph.
        if value:
            raise AttributeError("NativeMapStore tracks are native-owned")

    def track_len(self, point3D_id):
        return self._idx.track_len(int(point3D_id))

    def point3D_status(self, point3D_id):
        return self._idx.is_valid(int(point3D_id)), self._idx.is_tri(int(point3D_id))


def create_map_store(backend="auto", max_cam_params=9):
    """'python': the Python MapStore; 'native' or 'auto': NativeMapStore,
    whose build raises with g++'s output where it fails (the JAX version's
    'auto' falls back to Python quietly)."""
    if backend == "python":
        return MapStore(max_cam_params)
    if backend in ("native", "auto"):
        return NativeMapStore(max_cam_params)
    raise ValueError(f"unknown map store backend: {backend!r}")
