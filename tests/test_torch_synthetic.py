"""The port's real-photograph survey renderer held against the JAX package's.

  - `sample_photo_paths` returns the JAX function's list;
  - the committed photographs (mavmap_tpu_torch/data/photos/*.png) are
    Pillow's convert("L") of the JPEGs that `sample_photo_paths` finds, bit
    for bit, and rendering from them (`load_sample_photos`) gives the
    images that rendering from the JPEGs gives;
  - `render_photo_survey` against the JAX renderer on
    tests/test_pipeline.py's real-photo scene: at most 1 gray level on at
    most 0.25 % of each frame's pixels (measured on the CPU: 0.14-0.18 %
    here, up to 0.24 % on chip_smoke.py's 40-image survey). The scenes'
    float32 rotations differ in the last bits between the packages, which
    moves the footprint by ~1e-5 m, and truncation to uint8 turns that into
    single gray levels. Given the JAX package's rotations, the renderer
    alone differs on at most 0.01 % of the pixels (measured 0.0017-0.0023
    %: sin/cos and rays @ R round differently in numpy and PyTorch);
  - a frame tilted so far that its rays leave the textured footprint:
    the clipped texture coordinates gather in bounds, within the same
    tolerance of the JAX renderer;
  - the CLI from the rendered PNGs (tests/test_pipeline.py
    test_cli_from_real_photo_textures through mavmap_tpu_torch.cli with
    --device cpu, on the committed photographs, so it never skips): at
    least 5/6 frames registered at ATE < 1.0 m.

The tests that read the JPEGs skip where `sample_photo_paths` finds none or
Pillow is missing, as tests/test_pipeline.py does.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ops.rotation import rotmat_from_rvec as j_rot
from mavmap_tpu.utils import synthetic as jsyn

from mavmap_tpu_torch import cli as tcli
from mavmap_tpu_torch.utils import synthetic as tsyn
from mavmap_tpu_torch.utils.imageio import read_gray, write_png

torch.set_num_threads(2)
CPU = torch.device("cpu")
SCENE = dict(num_images=6, num_points=10, relief=10.0, rows=1, seed=23)
# Per frame: the largest gray-level difference and the share of pixels
# that differ (see the module docstring for what was measured).
MAX_LEVELS = 1
MAX_SHARE = 2.5e-3
MAX_SHARE_SAME_ROTATIONS = 1e-4


def _need_jpegs():
    if not jsyn.sample_photo_paths():
        pytest.skip("no bundled sample photographs in this environment")
    pytest.importorskip("PIL")


def _check_close(got, ref, max_share, what):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (600, 800)
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= MAX_LEVELS, (what, i, int(d.max()))
        assert (d > 0).mean() <= max_share, (what, i, float((d > 0).mean()))


@pytest.fixture(scope="module")
def jax_frames():
    _need_jpegs()
    return jsyn.render_photo_survey(jsyn.make_uav_scene(**SCENE), relief_amp=4.0, seed=23)


def test_sample_photo_paths_matches_jax():
    paths = tsyn.sample_photo_paths()
    assert paths == jsyn.sample_photo_paths()
    if paths:
        names = tuple(os.path.splitext(os.path.basename(p))[0] for p in paths)
        assert names == tsyn.SAMPLE_PHOTOS


def test_committed_photos_equal_pillow():
    _need_jpegs()
    from PIL import Image

    for path, name in zip(jsyn.sample_photo_paths(), tsyn.SAMPLE_PHOTOS):
        ref = np.asarray(Image.open(path).convert("L"))
        got = read_gray(os.path.join(tsyn.PHOTO_DIR, f"{name}.png"))
        np.testing.assert_array_equal(got, ref, name)


def test_render_photo_survey_matches_jax(jax_frames):
    got = tsyn.render_photo_survey(tsyn.make_uav_scene(**SCENE), 4.0, 23,
                                   photos=tsyn.load_sample_photos(CPU), device="cpu")
    _check_close(got, jax_frames, MAX_SHARE, "port scene")


def test_renderer_alone_matches_jax_given_its_rotations(jax_frames, monkeypatch):
    monkeypatch.setattr(tsyn, "_rotmats",
                        lambda r: np.array(j_rot(jnp.asarray(r, np.float32))))
    got = tsyn.render_photo_survey(tsyn.make_uav_scene(**SCENE), 4.0, 23,
                                   photos=tsyn.load_sample_photos(CPU), device="cpu")
    _check_close(got, jax_frames, MAX_SHARE_SAME_ROTATIONS, "JAX rotations")


def test_committed_photos_render_like_the_jpegs():
    """photos=load_sample_photos(), their numpy arrays, and photos=None
    (Pillow on the JPEGs) render the same bits."""
    _need_jpegs()
    scene = tsyn.make_uav_scene(**SCENE)
    ref = tsyn.render_photo_survey(scene, 4.0, 23, device="cpu")
    photos = tsyn.load_sample_photos(CPU)
    for given in (photos, [p.numpy().astype(np.uint8) for p in photos]):
        got = tsyn.render_photo_survey(scene, 4.0, 23, photos=given, device="cpu")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_render_clips_at_the_texture_edges_like_jax():
    """Frame 1 pitched by 0.9 rad about its centre: its far rays meet the
    ground beyond the footprint's margin, so the texture coordinates clip
    at shape - 2 (the last bilinear cell). Both renderers stay in bounds
    and agree within the tolerance."""
    _need_jpegs()
    scene = tsyn.make_uav_scene(num_images=2, num_points=10, relief=10.0, rows=1, seed=23)
    C = scene.camera_centers()
    rvecs = scene.rvecs.copy()
    rvecs[1, 0] += 0.9
    R1 = tsyn._rotmats(rvecs[1])
    tvecs = scene.tvecs.copy()
    tvecs[1] = (-R1 @ C[1]).astype(np.float32)
    scene = dataclasses.replace(scene, rvecs=rvecs, tvecs=tvecs)
    jscene = jsyn.SyntheticScene(**{f.name: getattr(scene, f.name)
                                    for f in dataclasses.fields(scene)})
    # The flat-ground hits of frame 1's image corners: some lie outside the
    # textured footprint (x0, x1) x (y0, y1), or behind the camera.
    Cn = scene.camera_centers()
    half = 1.2 * Cn[:, 2].max() * 400 / 700.0
    corners = np.array([[-400, -300, 700], [400, -300, 700], [-400, 300, 700],
                        [400, 300, 700]], np.float64) / 700.0
    d = corners @ R1
    t = -Cn[1, 2] / d[:, 2]
    g = Cn[1, :2] + t[:, None] * d[:, :2]
    lo, hi = Cn[:, :2].min(0) - half, Cn[:, :2].max(0) + half
    assert np.any((t < 0) | np.any((g < lo) | (g > hi), axis=1))
    ref = jsyn.render_photo_survey(jscene, relief_amp=4.0, seed=23)
    got = tsyn.render_photo_survey(scene, 4.0, 23, photos=tsyn.load_sample_photos(CPU),
                                   device="cpu")
    _check_close(got, ref, MAX_SHARE, "tilted")


def test_render_photo_survey_without_photos_raises(monkeypatch):
    scene = tsyn.make_uav_scene(**SCENE)
    monkeypatch.setattr(tsyn, "sample_photo_paths", lambda: [])
    with pytest.raises(RuntimeError, match="no bundled sample photographs"):
        tsyn.render_photo_survey(scene, device="cpu")
    with pytest.raises(RuntimeError):
        tsyn.render_photo_survey(scene, photos=[], device="cpu")


def test_cli_from_real_photo_textures(tmp_path):
    """tests/test_pipeline.py test_cli_from_real_photo_textures through the
    port's CLI on the CPU: the same scene, render and flags, with the
    images rendered from the committed photographs and written as PNGs."""
    scene = tsyn.make_uav_scene(**SCENE)
    imgs = tsyn.render_photo_survey(scene, relief_amp=4.0, seed=23,
                                    photos=tsyn.load_sample_photos(CPU), device="cpu")
    data, out = tmp_path / "data", tmp_path / "out"
    data.mkdir()
    lines = ["# imagedata"]
    for i, im in enumerate(imgs):
        write_png(str(data / f"img{i}.png"), im)
        cam_def = ", 1, PINHOLE, 700.0, 700.0, 400.0, 300.0" if i == 0 else ""
        lines.append(f"img{i}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0{cam_def}")
    (data / "imagedata.txt").write_text("\n".join(lines) + "\n")
    rc = tcli.main([
        "--input-path", str(data), "--output-path", str(out),
        "--max-features", "1024", "--min-track-len", "2",
        "--tri-min-angle", "1.0", "--init-tri-min-angle", "2.0",
        "--ransac-min-inlier-threshold", "15",
        "--surf-hessian-threshold", "600", "--quiet", "--device", "cpu",
    ])
    assert rc == 0
    content = (out / "imagedataout.txt").read_text().splitlines()
    rows = [ln.split(",") for ln in content if not ln.startswith("#")]
    assert len(rows) >= 5  # at least 5/6 frames registered from pixels
    est = np.array([[float(r[8]), float(r[9]), float(r[10])] for r in rows])
    idxs = [int(r[0].strip()[3:]) for r in rows]
    assert tsyn.ate_rmse(est, scene.camera_centers()[idxs]) < 1.0  # m at 30 m altitude
