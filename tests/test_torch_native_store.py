"""The port's native (C++) track store held against its Python MapStore and
against the JAX package's native core.

  - the five cases of tests/test_native_store.py on the port's
    NativeTrackIndex, the randomized one against the port's Python
    MapStore (the executable specification);
  - the JAX package's NativeTrackIndex and the port's given one random
    workload: the same surviving pid for every correspondence, the same
    point2D -> point3D table and the same tracks, compared sorted as
    tests/test_native_store.py compares them;
  - NativeMapStore as a MapStore: the same state as the Python store after
    the same writes, and exact load_state / load_map round trips (a
    checkpoint's tracks keep their ids in the C++ core);
  - a mapper's store backend shows in report().
All comparisons are exact: the stores hold integers and copied floats.
"""

import numpy as np
import pytest
import torch

from mavmap_tpu.fm.native_store import NativeTrackIndex as JNativeTrackIndex

from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.fm import MapStore
from mavmap_tpu_torch.fm.native_map_store import NativeMapStore, create_map_store
from mavmap_tpu_torch.fm.native_store import NativeTrackIndex
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.utils import checkpoint
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

torch.set_num_threads(2)


@pytest.fixture
def index():
    return NativeTrackIndex()


def test_native_basic(index):
    s0 = index.add_image(0, 5)
    s1 = index.add_image(1, 5)
    assert (s0, s1) == (0, 5)
    pid = index.add_correspondence(0, 5)
    assert index.track_len(pid) == 2
    assert index.point3D_of(0) == pid and index.point3D_of(5) == pid
    assert not index.is_tri(pid)
    index.set_tri(pid)
    assert index.is_tri(pid)
    assert index.num_points3D == 1
    index.delete_point3D(pid)
    assert index.num_points3D == 0
    assert index.point3D_of(0) == -1


def test_native_merge_keeps_longer(index):
    for i in range(6):
        index.add_image(i, 4)
    a = index.add_correspondence(0 * 4, 1 * 4)
    index.add_correspondence(1 * 4, 2 * 4)              # len(a) = 3
    b = index.add_correspondence(3 * 4 + 1, 4 * 4 + 1)  # len(b) = 2
    surv = index.add_correspondence(2 * 4, 4 * 4 + 1)
    assert surv == a
    assert not index.is_valid(b)
    assert index.track_len(a) == 5


def test_native_duplicate_image_suppressed(index):
    index.add_image(0, 4)
    index.add_image(1, 4)
    pid = index.add_correspondence(0, 4)
    index.add_correspondence(4, 1)  # image 0 already observes pid
    assert index.track_len(pid) == 2
    assert index.point3D_of(1) == -1


def _random_pairs(rng, n_img, n_pts, n):
    pairs = []
    for _ in range(n):
        i1, i2 = rng.choice(n_img, 2, replace=False)
        pairs.append((i1 * n_pts + rng.integers(n_pts), i2 * n_pts + rng.integers(n_pts)))
    return pairs


def test_native_differential_random(rng):
    """Randomized differential test: the port's native core against its
    Python MapStore, op for op."""
    py = MapStore()
    nt = NativeTrackIndex()
    cam = py.add_camera(1, [100, 100, 50, 50])
    n_img, n_pts = 12, 30
    for i in range(n_img):
        py.add_image(cam, np.zeros((n_pts, 2)))
        nt.add_image(i, n_pts)
    for a, b in _random_pairs(rng, n_img, n_pts, 800):
        pa = py.add_correspondence(a, b)
        na = nt.add_correspondence(a, b)
        assert pa == na and py.track_len(pa) == nt.track_len(na)
    assert py.num_points3D == nt.num_points3D
    np.testing.assert_array_equal(py.point2D_point3D, nt.export_point2D_point3D())
    valid, tri, tl = nt.export_point3D_flags()
    np.testing.assert_array_equal(py.point3D_valid, valid)
    np.testing.assert_array_equal(py.point3D_track_len, tl)
    for pid in py.tracks:
        assert sorted(py.tracks[pid]) == sorted(nt.track(pid).tolist())


def test_native_bulk_ingestion(index, rng):
    for i in range(4):
        index.add_image(i, 50)
    a = rng.integers(0, 50, 100)
    b = rng.integers(50, 100, 100)
    pids = index.add_correspondences(a, b)
    assert len(pids) == 100
    assert (pids >= 0).all()


def test_native_index_matches_jax(rng):
    """One random workload (bulk and single correspondences, deletions)
    through the JAX package's native core and the port's: the same pids,
    the same tables and the same tracks."""
    n_img, n_pts = 10, 40
    cores = (JNativeTrackIndex(), NativeTrackIndex())
    for core in cores:
        for i in range(n_img):
            core.add_image(i, n_pts)
    pairs = np.asarray(_random_pairs(rng, n_img, n_pts, 600), np.int64)
    bulk = [core.add_correspondences(pairs[:400, 0], pairs[:400, 1]) for core in cores]
    np.testing.assert_array_equal(*bulk)
    doomed = rng.choice(np.unique(bulk[0]), 20, replace=False)
    for core in cores:
        for pid in doomed:
            core.delete_point3D(int(pid))
        for pid in np.unique(bulk[0])[::3]:
            core.set_tri(int(pid))
    single = [[core.add_correspondence(a, b) for a, b in pairs[400:]] for core in cores]
    assert single[0] == single[1]
    j, t = cores
    np.testing.assert_array_equal(j.export_point2D_point3D(), t.export_point2D_point3D())
    for a, b in zip(j.export_point3D_flags(), t.export_point3D_flags()):
        np.testing.assert_array_equal(a, b)
    assert j.num_points3D == t.num_points3D > 0
    for pid in range(j.capacity_points3D):
        assert sorted(j.track(pid).tolist()) == sorted(t.track(pid).tolist())


def _fill(store, rng, n_img=8, n_pts=25):
    cam = store.add_camera(1, [100, 100, 50, 50])
    for i in range(n_img):
        iid, _ = store.add_image(cam, rng.normal(size=(n_pts, 2)), rng.normal(size=(n_pts, 2)))
        store.set_pose(iid, rng.normal(size=3), rng.normal(size=3))
    pairs = np.asarray(_random_pairs(rng, n_img, n_pts, 300), np.int64)
    pids = store.add_correspondences_bulk(pairs[:, 0], pairs[:, 1])
    live = np.unique(pids)
    for pid in live[::2]:
        store.set_point3D(int(pid), rng.normal(size=3), error=float(rng.random()))
    for pid in live[1::7]:
        store.delete_point3D(int(pid))
    return store


def _state(store):
    return ({k: np.array(getattr(store, k)) for k in MapStore.STATE_ARRAYS},
            {int(k): list(v) for k, v in store.tracks.items()})


def _same_state(a, b):
    (arr_a, tr_a), (arr_b, tr_b) = _state(a), _state(b)
    for k in MapStore.STATE_ARRAYS:
        np.testing.assert_array_equal(arr_a[k], arr_b[k], k)
    assert tr_a == tr_b


def test_native_map_store_matches_python_store(rng):
    """The same writes (images, bulk correspondences, points set and
    deleted) leave NativeMapStore in the Python MapStore's state; the
    mirrors need no explicit sync."""
    seed = int(rng.integers(1 << 30))
    py = _fill(MapStore(), np.random.default_rng(seed))
    nt = _fill(NativeMapStore(), np.random.default_rng(seed))
    _same_state(nt, py)
    assert nt.num_points3D == py.num_points3D > 0
    pid = int(np.where(py.point3D_valid)[0][0])
    assert nt.point3D_status(pid) == py.point3D_status(pid)
    assert nt.track_len(pid) == py.track_len(pid)
    for a, b in zip(nt.observation_table(), py.observation_table()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_store_sync_is_a_no_op_for_jax_callers(rng, backend):
    """A caller written for the JAX package calls sync() before it reads
    the mirrors: both stores take it, and it changes no array (every read
    already refreshes them)."""
    seed = int(rng.integers(1 << 30))
    store = _fill(create_map_store(backend), np.random.default_rng(seed))
    ref = _fill(MapStore(), np.random.default_rng(seed))
    assert store.sync() is None
    _same_state(store, ref)


@pytest.mark.parametrize("target", ["native", "python"])
def test_native_load_state_round_trip(rng, target):
    """A native store's state loaded into a fresh store of either backend
    is the same state, tracks under their own ids; later writes give both
    the same pids."""
    src = _fill(NativeMapStore(), rng)
    arrays, tracks = _state(src)
    dst = create_map_store(target)
    dst.load_state(arrays, tracks)
    _same_state(dst, src)
    a, b = np.asarray(_random_pairs(rng, 8, 25, 50), np.int64).T
    np.testing.assert_array_equal(dst.add_correspondences_bulk(a, b),
                                  src.add_correspondences_bulk(a, b))
    _same_state(dst, src)


def test_native_load_state_refuses_bad_tracks(rng):
    src = _fill(MapStore(), rng)
    arrays, tracks = _state(src)
    bad = dict(tracks)
    bad[int(max(tracks)) + 10 ** 6] = [0, 30]
    with pytest.raises(ValueError, match="out of range"):
        NativeMapStore().load_state(arrays, bad)


def test_native_load_map_round_trip(tmp_path):
    """save_map / load_map of a mapper on the native store: the restored
    store (native and Python) holds the saved state exactly, and the mapper
    reports its backend."""
    scene = make_uav_scene(num_images=4, num_points=600, relief=10.0, rows=1, seed=5)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=10, seed=5)
    prov = ArrayFeatureProvider([(k[:256], d[:256]) for k, d in feats], capacity=256)
    kw = dict(tri_min_angle=1.0, min_track_len=2, essential_ransac_trials=64,
              p3p_ransac_trials=64)

    def mapper(backend):
        return SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params, prov,
                                device=torch.device("cpu"), store_backend=backend)

    m = mapper("auto")
    assert m.process_initial(0, 1, SequentialMapperOptions(**dict(kw, tri_min_angle=4.0)))
    assert m.process(2, 1, SequentialMapperOptions(**kw))
    assert m.report()["store_backend"] == "native"
    path = str(tmp_path / "map.npz")
    checkpoint.save_map(m, path)
    for backend in ("native", "python"):
        r = checkpoint.load_map(mapper(backend), path)
        _same_state(r.store, m.store)
        assert r.report()["store_backend"] == backend
        assert (r.image_idx_to_id, r.pair_graph) == (m.image_idx_to_id, m.pair_graph)


def test_unknown_store_backend_raises():
    with pytest.raises(ValueError, match="unknown map store backend"):
        create_map_store("rust")
