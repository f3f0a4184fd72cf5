"""The port's detector, feature caches and rendered images held against the
JAX package on the same numpy inputs (the JAX detector runs its jitted
function on the CPU; it reaches no Pallas kernel).

Tolerances: the DoH response to 1e-4 of its largest magnitude (the JAX
version multiplies banded matrices, the port convolves: the same sums in
another order); keypoints in the same order within 0.05 px and descriptor
cosine above 0.999 on at least 98 % of them; per-cell counts and adapted
thresholds exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mavmap_tpu.features import FeatureCache as JFeatureCache
from mavmap_tpu.features import detector as jdet
from mavmap_tpu.utils import synthetic as jsyn

from mavmap_tpu_torch.features import (FeatureCache, ReferenceCacheProvider,
                                       read_reference_features)
from mavmap_tpu_torch.features import detector as tdet
from mavmap_tpu_torch.utils import synthetic as tsyn
from mavmap_tpu_torch.utils.imageio import write_png

torch.set_num_threads(2)
CPU = torch.device("cpu")
# A 200 x 150 view of the rendered survey (focal scaled with the size).
SCENE = dict(num_images=3, num_points=800, relief=10.0, rows=1, seed=21, image_size=(200, 150),
             focal=175.0)


@pytest.fixture(scope="module")
def images():
    scene = jsyn.make_uav_scene(**SCENE)
    return [im.astype(np.float32) for im in jsyn.render_images(scene, texture_contrast=0.25,
                                                               seed=21)]


def test_hessian_response_matches_jax(images):
    """_hessian_response at 96x128 for two scales: replicate padding plus a
    1-D convolution per axis against the JAX version's banded matrices."""
    img = images[0][:96, :128] / 255.0
    for sigma in (1.6, 2.5198421):
        rj = np.asarray(jdet._hessian_response(jnp.asarray(img), sigma))
        rt = tdet._hessian_response(torch.as_tensor(img), sigma).numpy()
        np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=1e-4 * np.abs(rj).max())
    # A constant image gives no response (the DC correction and the padding).
    flat = tdet._hessian_response(torch.full((40, 50), 0.5), 1.6)
    assert float(flat.abs().max()) < 1e-9


def _same_detections(out_t, out_j):
    kt, st, dt, mt, ct = (x.numpy() for x in out_t)
    kj, sj, dj, mj, cj = (np.asarray(x) for x in out_j)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st[mt], sj[mj])
    assert mt.sum() > 50
    assert np.abs(kt - kj)[mt].max() < 0.05
    cos = np.sum(dt * dj, axis=1)[mt]
    assert (cos > 0.999).mean() >= 0.98, np.sort(cos)[:5]


@pytest.mark.parametrize("variant", ["oriented", "upright", "adaptive"])
def test_detect_and_describe_matches_jax(images, variant):
    """The full detector on a 200x150 rendered frame: the same kept
    keypoints in the same order (the per-cell sort keeps top_k's ties),
    the same scales and per-cell counts, descriptors alike; the adaptive
    variant with per-cell thresholds and rank admission."""
    kw = dict(hessian_threshold=1000.0, max_features=512)
    if variant == "upright":
        kw["upright"] = True
    if variant == "adaptive":
        kw.update(min_per_cell=20, cell_thresholds=np.linspace(300, 3000, 9).astype(np.float32))
    img = images[1]
    out_t = tdet.detect_and_describe(torch.as_tensor(img), **kw)
    out_j = jdet.detect_and_describe(jnp.asarray(img), **{
        k: (jnp.asarray(v) if k == "cell_thresholds" else v) for k, v in kw.items()})
    _same_detections(out_t, out_j)


def test_cell_top_k_orders_ties_like_jax(rng):
    """The per-cell selection gives jax.lax.top_k's values and indices,
    equal values (many of them, and the suppressed -inf pixels) lowest
    index first."""
    import jax

    x = rng.integers(0, 6, (9, 400)).astype(np.float32)
    x[x == 0] = -np.inf
    vt, it = tdet._top_k(torch.as_tensor(x), 57)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 57)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_adaptive_detector_follows_jax(images):
    """AdaptiveDetector's per-cell thresholds and detections follow the JAX
    package's over 3 frames (a low-contrast frame so the thresholds move)."""
    kw = dict(hessian_threshold=3000.0, min_per_cell=15, max_features=256, grid_size=(2, 2))
    dt = tdet.AdaptiveDetector(**kw, device=CPU)
    dj = jdet.AdaptiveDetector(**kw)
    moved = False
    for img in images:
        low = 128.0 + (img - 128.0) * 0.5
        (kt, de_t), (kj, de_j) = dt.detect(low), dj.detect(low)
        np.testing.assert_array_equal(dt.cell_thr, dj.cell_thr)
        assert kt.shape == kj.shape and np.abs(kt - kj).max() < 0.05
        moved |= bool((dt.cell_thr != 3000.0).any())
    assert moved


def test_detect_image_file_reads_like_pillow(images, tmp_path):
    """detect_image_file reads a PNG through utils/imageio.py; the JAX
    version through Pillow's convert("L"): the same detections, and the
    image dims ride along."""
    pytest.importorskip("PIL")
    path = str(tmp_path / "f.png")
    write_png(path, images[2].astype(np.uint8))
    kw = dict(hessian_threshold=1000.0, max_features=256)
    kt, dt, shape_t = tdet.detect_image_file(path, device=CPU, **kw)
    kj, dj, shape_j = jdet.detect_image_file(path, **kw)
    assert shape_t == shape_j == (150, 200)
    assert kt.shape == kj.shape and np.abs(kt - kj).max() < 0.05
    assert (np.sum(dt * dj, axis=1) > 0.999).mean() >= 0.98


def test_render_images_matches_jax():
    """render_images (numpy with float32 rotations) gives the JAX package's
    images: float32 rotation bits may differ in the last place, which moves
    a pixel across a rounding edge at most by one level on at most 0.1 % of
    the pixels."""
    ts, js = tsyn.make_uav_scene(**SCENE), jsyn.make_uav_scene(**SCENE)
    for a, b in zip(tsyn.render_images(ts, texture_contrast=0.25, seed=21),
                    jsyn.render_images(js, texture_contrast=0.25, seed=21)):
        assert a.dtype == np.uint8 and a.shape == (150, 200)
        d = np.abs(a.astype(int) - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    pt, pj = tsyn.imu_priors(ts, noise=0.005, seed=3), jsyn.imu_priors(js, noise=0.005, seed=3)
    for i in pj:
        np.testing.assert_allclose(pt[i], pj[i], atol=1e-6)
    mt = tsyn.make_multi_camera_scene(num_images=4, seed=2)
    mj = jsyn.make_multi_camera_scene(num_images=4, seed=2)
    for f in ("cam_params", "cam_models", "image_cameras"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))


def test_feature_cache_invalidates_on_fingerprint_change(images, tmp_path):
    """A changed parameter dict re-extracts; an unchanged one hits. The npz
    files are the JAX package's format: each package reads the other's."""
    calls = []

    def detector(idx):
        calls.append(idx)
        kp, de = tdet.detect_image(images[0], max_features=128, device=CPU)
        return kp, de, images[0].shape

    params = {"hessian_threshold": 1000.0, "min_per_cell": 0}
    cache = FeatureCache(str(tmp_path), params, detector, capacity=256)
    f1 = cache.query(0, "img0")
    f2 = cache.query(0, "img0")
    assert calls == [0]
    np.testing.assert_array_equal(f1.keypoints, f2.keypoints)
    assert cache.query_dimensions(0, "img0")[:2] == (150, 200)
    fj = JFeatureCache(str(tmp_path), params, None, capacity=256).query(0, "img0")
    np.testing.assert_array_equal(fj.descriptors, f1.descriptors)
    FeatureCache(str(tmp_path), dict(params, min_per_cell=5), detector, capacity=256).query(
        0, "img0")
    assert calls == [0, 0]


def _write_dump(path, name, kp, desc, resp):
    """The reference's dumps (feature_cache.cc:125-142): 28-byte
    cv::KeyPoint structs behind a size_t byte count; the descriptor matrix
    behind its size_t byte count and cv::Mat's rows, cols and type as
    4-byte ints."""
    raw = np.zeros(len(kp), dtype=[("x", "<f4"), ("y", "<f4"), ("size", "<f4"),
                                   ("angle", "<f4"), ("response", "<f4"), ("octave", "<i4"),
                                   ("class_id", "<i4")])
    raw["x"], raw["y"], raw["response"] = kp[:, 0], kp[:, 1], resp
    (path / f"{name}-keypoints.bin").write_bytes(np.uint64(raw.nbytes).tobytes()
                                                 + raw.tobytes())
    d32 = desc.astype("<f4")
    (path / f"{name}-descriptors.bin").write_bytes(
        np.uint64(d32.nbytes).tobytes() + np.array([*d32.shape, 5], "<i4").tobytes()
        + d32.tobytes())


def test_reference_dump_with_4_byte_header_parses(rng, tmp_path):
    """Divergence from the JAX package, on purpose: rows/cols of a
    reference descriptor dump are cv::Mat's 4-byte ints. The port parses
    such a dump; the JAX version reads them as 8-byte and fails on it."""
    from mavmap_tpu.features import read_reference_features as j_read

    kp = rng.uniform(0, 800, (40, 2)).astype(np.float32)
    desc = rng.normal(size=(40, 64)).astype(np.float32)
    resp = rng.uniform(0, 1, 40).astype(np.float32)
    _write_dump(tmp_path, "img7", kp, desc, resp)
    k, d, r = read_reference_features(str(tmp_path / "img7-keypoints.bin"),
                                      str(tmp_path / "img7-descriptors.bin"))
    np.testing.assert_array_equal(k, kp)
    np.testing.assert_array_equal(d, desc)
    np.testing.assert_array_equal(r, resp)
    with pytest.raises(Exception):
        j_read(str(tmp_path / "img7-keypoints.bin"), str(tmp_path / "img7-descriptors.bin"))
    # Over capacity, the strongest responses survive in their file order.
    f16 = ReferenceCacheProvider(str(tmp_path), ["img7"], capacity=16).get(0)
    keep = np.sort(np.argsort(-resp)[:16])
    np.testing.assert_array_equal(f16.keypoints[:16], kp[keep])


def test_reference_cache_provider_is_bounded(rng, tmp_path):
    """Divergence from the JAX package, on purpose: the provider keeps at
    most cache_capacity parsed images (least recently used out first); the
    JAX version keeps every image it has read."""
    names = [f"img{i}" for i in range(5)]
    for n in names:
        _write_dump(tmp_path, n, rng.uniform(0, 100, (8, 2)).astype(np.float32),
                    rng.normal(size=(8, 16)).astype(np.float32), np.ones(8, np.float32))
    prov = ReferenceCacheProvider(str(tmp_path), names, capacity=8, cache_capacity=2)
    for i in (0, 1, 0, 2, 3):
        prov.get(i)
    assert list(prov._cache) == [2, 3]
    assert prov.descriptor_dim == 16
