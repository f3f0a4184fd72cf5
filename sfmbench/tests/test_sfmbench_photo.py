"""The photograph cell on the CPU (this test may import the port; the
reference never does):

- the reference renderer (`reference/photo.py`) against the port's
  `render_photo_survey` on the cell's 40 frames, given the same poses: at
  most 1 gray level on at most 0.1 % of each frame's pixels (measured
  0.00-0.04 %: the rotations are the port's bits but where the port's
  float32 cos is off by an ulp, and sin / cos and rays @ R round
  differently in numpy);
- the reference's PNG reader gives the port's pixels of the committed
  photographs, undoes every row filter, and reads back its writer's
  bytes, which the port reads alike; the cell's PNG bytes are pinned;
- the port's detector against the reference detector on rendered frames,
  oriented and upright: within the driver's tolerances; a bfloat16
  response map, three octaves in place of four and upright descriptors
  are not;
- the configuration's `detector` block is what the CLI makes of its
  flags; the new reference modules import neither torch nor the port;
- the driver maps a 10-frame cut through `cli.run` from PNG files and the
  judge reads it correct; planted faults read not correct: the judged
  points moved 5 cm, loop detection off; the driver's map check passes
  the sound map, fails it with its points moved 5 cm, and passes it with
  a few observations hundreds of pixels off, as loop closures leave them;
- the readers of the extraction's spans on made-up runs, and nothing
  where the program has no such span.
"""

import dataclasses
import hashlib
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from sfmbench import core
from sfmbench.drivers import photo_cli
from sfmbench.reference import detector as ref_detector, photo
from sfmbench.reference.scene import noise_rng

CELL = "photo40-cli"
READERS = {r.name: r for r in core.load_readers()}
# sha256 over the PNG bytes of every frame of the warm-up flight, then of
# flight 0, as the driver writes them (zlib level 1 of this machine's zlib).
PNG_DIGEST = "23fc3f8df53eb41d9a1d4ecee2a35c311441d6b4a6d0239e1121e0cd04746402"
MAX_SHARE = 1e-3


@pytest.fixture(scope="module")
def cell():
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    return core.load_cell(CELL)


@pytest.fixture(scope="module")
def clean(cell):
    scene = core.make_inputs(cell.workload, 1, 0, cell.config).scene
    return scene, photo_cli.render(cell, scene)


def test_reference_render_matches_the_port(clean):
    from mavmap_tpu_torch.utils import synthetic as tsyn

    scene, frames = clean
    port_scene = tsyn.SyntheticScene(**{f.name: getattr(scene, f.name)
                                        for f in dataclasses.fields(tsyn.SyntheticScene)})
    got = tsyn.render_photo_survey(port_scene, 4.0, 23, photos=tsyn.load_sample_photos(),
                                   device="cpu")
    assert len(got) == len(frames) == 40
    for i, (a, b) in enumerate(zip(got, frames)):
        assert a.shape == b.shape == (600, 800) and b.dtype == np.uint8
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE, (i, int(d.max()), (d > 0).mean())


def test_reference_reads_the_committed_photographs_like_the_port():
    from mavmap_tpu_torch.utils.imageio import read_gray

    for name in photo.SAMPLE_PHOTOS:
        path = os.path.join(photo_cli.PHOTO_DIR, f"{name}.png")
        np.testing.assert_array_equal(photo.read_png(path), read_gray(path))


def _filtered_png(px, kind):
    """An 8-bit gray PNG of `px` with every row under filter `kind`."""
    h, w = px.shape
    img = px.astype(np.int64)
    rows = []
    for y in range(h):
        a = np.concatenate([[0], img[y, :-1]])
        b = img[y - 1] if y else np.zeros(w, np.int64)
        c = np.concatenate([[0], b[:-1]])
        pred = [np.zeros(w, np.int64), a, b, (a + b) // 2,
                np.array([photo._paeth(*t) for t in zip(a, b, c)])][kind]
        rows.append(bytes([kind]) + ((img[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(k, body):
        return struct.pack(">I", len(body)) + k + body + struct.pack(
            ">I", zlib.crc32(k + body) & 0xFFFFFFFF)

    return (photo.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_reader_undoes_every_row_filter(tmp_path, kind):
    from mavmap_tpu_torch.utils.imageio import read_gray

    px = np.random.default_rng(kind).integers(0, 256, (23, 31), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(px, kind))
    np.testing.assert_array_equal(photo.read_png(path), px)
    np.testing.assert_array_equal(read_gray(str(path)), px)
    photo.write_png(tmp_path / "w.png", px)
    np.testing.assert_array_equal(photo.read_png(tmp_path / "w.png"), px)
    np.testing.assert_array_equal(read_gray(str(tmp_path / "w.png")), px)


def test_cell_png_bytes_are_pinned(cell, clean):
    _, frames = clean
    h = hashlib.sha256()
    for flight in (-1, 0):
        for f in photo_cli.noisy(frames, noise_rng(cell.workload["data_seed"], flight),
                                 cell.workload["images"]["sensor_noise"]):
            h.update(photo.png_bytes(f))
    assert h.hexdigest() == PNG_DIGEST


def _small_frames(cell, n=2):
    """The cell's first frames rendered at 320x240 with a focal of 280 (the
    same footprint), with flight 0's sensor noise."""
    from sfmbench.reference.scene import make_uav_scene

    scene = make_uav_scene(**dict(cell.workload["flight"], num_images=n), image_size=(320, 240),
                           focal=280.0)
    return photo_cli.noisy(photo_cli.render(cell, scene), noise_rng(1, 0), 1.0)


@pytest.mark.parametrize("upright", [False, True], ids=["oriented", "upright"])
def test_port_detector_holds_to_the_reference(cell, upright):
    from mavmap_tpu_torch.features.detector import detect_image

    params = dict(cell.config["detector"], upright=upright)
    for gray in _small_frames(cell):
        kp, desc = detect_image(gray.astype(np.float32), device="cpu", **params)
        got = photo_cli.compare_detection(kp, desc, ref_detector.detect(gray, **params))
        assert got["ok"] and got["matched"] == 1.0, got


def _bf16_response(monkeypatch):
    from mavmap_tpu_torch.features import detector

    orig = detector._hessian_response
    monkeypatch.setattr(detector, "_hessian_response",
                        lambda img, s: orig(img, s).bfloat16().float())
    return {}


def _three_octaves(monkeypatch):
    return {"num_octaves": 3}


def _upright(monkeypatch):
    return {"upright": True}


@pytest.mark.parametrize("plant", [_bf16_response, _three_octaves, _upright],
                         ids=["bfloat16-response", "dropped-octave", "upright-descriptors"])
def test_detector_fault_fails_the_drivers_check(cell, clean, monkeypatch, plant):
    from mavmap_tpu_torch.features.detector import detect_image

    params = cell.config["detector"]
    gray = photo_cli.noisy(clean[1][7:8], noise_rng(1, 1), 1.0)[0]
    ref = ref_detector.detect(gray, **params)
    kp, desc = detect_image(gray.astype(np.float32), device="cpu", **params)
    assert photo_cli.compare_detection(kp, desc, ref)["ok"]
    kp, desc = detect_image(gray.astype(np.float32), device="cpu",
                            **dict(params, **plant(monkeypatch)))
    got = photo_cli.compare_detection(kp, desc, ref)
    assert not got["ok"], got


def test_detector_block_is_what_the_cli_parses(cell):
    from mavmap_tpu_torch import cli

    args = cli.build_parser().parse_args(["--input-path", "x", "--output-path", "y",
                                          *cell.config["cli"]])
    parsed = cli.detector_params(args)
    assert parsed.pop("min_per_cell") == 0
    assert parsed.pop("grid_size") == (3, 3) and cell.config["detector"]["grid_size"] == 3
    assert parsed == {k: v for k, v in cell.config["detector"].items() if k != "grid_size"}


def test_new_reference_modules_import_nothing_of_the_port():
    code = ("import json, sys\n"
            "import sfmbench.reference.photo, sfmbench.reference.detector\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT.parent,
                         capture_output=True, text=True, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & {"mavmap_tpu_torch", "mavmap_tpu", "jax", "torch"}


@pytest.fixture(scope="module")
def cut(tmp_path_factory, cell):
    """A 10-frame cut of the cell at its own frame size, one flight a
    window, a 3-frame warm-up, loop detection every 6 frames over
    neighbours 4 apart, so that loops close in 10 frames (argparse takes
    the last of a repeated flag). Its limits: measured on a CPU,
    the sound map 10/10 at ATE 0.031 m, 12 closures, reprojection RMSE
    1.43 px (median 0.16 px; 24 of 3550 observations beyond 4 px, the
    farthest 55 px, which the RMSE follows). The cell itself leaves the
    reprojection RMSE out of its limits: on its 40-frame flights such
    observations reach hundreds of pixels and now and then one lies
    behind its camera, in the JAX package's maps of the same frames too
    (PERF.md, section 2); its driver holds each map's median instead
    (`check_map`). At 10 frames the RMSE is finite and the moved points
    show in it."""
    import shutil

    root = tmp_path_factory.mktemp("photo")
    for d in ("configs", "metrics"):
        shutil.copytree(core.ROOT / d, root / d)
    cfg = dict(cell.config, cli=cell.config["cli"] + ["--loop-detection-period", "6",
                                                        "--loop-detection-nh-dist", "4"])
    (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "workloads").mkdir()
    wl = dict(cell.workload, name="photo10", maps=1, warmup_frames=3,
              flight=dict(cell.workload["flight"], num_images=10),
              limits={"missing_frames": 0, "maps_max": 1, "ate_worst_m": 0.06,
                      "reproj_worst_px": 1.8, "closures_min": 6})
    (root / "workloads" / "photo10.json").write_text(json.dumps(wl))
    c = core.load_cell("photo10", root)
    inputs = core.make_inputs(c.workload, 2 ** 31 + 25, 1, c.config)
    ctx = c.driver.prepare(c, inputs, 2 ** 31 + 25, torch.device("cpu"))
    c.driver.warmup(ctx, core.Spans())
    return c, ctx, inputs, c.driver.map_once(ctx, 0, core.Spans())


def _checks(c, inputs, rec):
    values, _ = core.judge_values([rec], inputs.scene, [[kp for kp, _ in inputs.feats[0]]])
    return core.check(values, c.workload["limits"])


def test_photo_cut_is_correct_on_the_cpu(cut):
    c, ctx, inputs, rec = cut
    assert rec.registered == rec.offered == 10 and rec.stats["maps"] == 1
    ok, checks = _checks(c, inputs, rec)
    assert ok, checks
    # The judge holds the map to the program's own keypoints, read back
    # from the CLI's cache: every frame's, as many rows as it detected.
    assert len(inputs.feats[0]) == 10
    assert all(len(kp) == len(de) > 500 for kp, de in inputs.feats[0])
    assert rec.stats["detector_check"]["ok"] and rec.stats["detector_check"]["frame"] == \
        (7 * inputs.order[0]) % 10
    assert rec.stats["map_check"]["reproj_median_px"] <= c.workload["map_check"][
        "reproj_median_px"] / 2
    t = rec.timings
    assert t["image_decodes"] == t["detect_frames"] == 10 and t["cli.features"] > 0


def test_photo_cut_with_points_moved_is_not_correct(cut):
    c, _, inputs, rec = cut
    state = dataclasses.replace(rec.state, points=rec.state.points + np.array([0.05, 0.0, 0.0]))
    ok, checks = _checks(c, inputs, dataclasses.replace(rec, state=state))
    assert not ok and checks["reproj_worst_px"]["value"] > c.workload["limits"][
        "reproj_worst_px"], checks


def _far_off(state):
    """One point in 200 moved 30 m sideways: its observations hundreds of
    pixels off, as a wrong track merge at a loop closure leaves them."""
    pts = state.points.copy()
    pts[::200] += np.array([30.0, 0.0, 0.0])
    return dataclasses.replace(state, points=pts)


@pytest.mark.parametrize("plant, fails", [
    (lambda s: dataclasses.replace(s, points=s.points + np.array([0.05, 0.0, 0.0])), True),
    (_far_off, False),
], ids=["points-moved-5cm", "few-far-off"])
def test_map_check_holds_the_points(cut, plant, fails):
    c, ctx, inputs, rec = cut
    state = plant(rec.state)
    if fails:
        with pytest.raises(RuntimeError, match="median reprojection error"):
            c.driver.check_map(ctx, 0, state, inputs.feats[0], core.Spans())
    else:
        out = c.driver.check_map(ctx, 0, state, inputs.feats[0], core.Spans())
        assert out["beyond_4px"] > 0 and out["reproj_median_px"] <= out["limit"], out
        ok, checks = _checks(c, inputs, dataclasses.replace(rec, state=state))
        assert not ok and checks["reproj_worst_px"]["value"] > 100, checks


def test_photo_cut_without_loop_detection_is_not_correct(cut):
    c, ctx, inputs, _ = cut
    r, wall, feats = c.driver.run(ctx, 0, core.Spans(), ["--no-loop-detection"], frames=10)
    rec = c.driver.record(ctx, r, wall)
    values, _ = core.judge_values([rec], inputs.scene, [[kp for kp, _ in feats]])
    ok, checks = core.check(values, c.workload["limits"])
    assert not ok and checks["closures_min"]["value"] == 0, checks


def _run(timings, counters=None, maps=2, offered=40):
    return core.Run(maps=[core.MapRecord(wall_s=8.0, offered=offered, registered=offered,
                                         counters=dict(counters or {}), timings=dict(timings),
                                         stats={}) for _ in range(maps)], spans=core.Spans())


@pytest.mark.parametrize("name, timings, counters, value", [
    ("features.extract_ms_per_frame", {"cli.features": 2.4, "cli.outputs": 0.2}, {},
     1000.0 * 2.4 / 40),
    ("features.detect_ms_per_frame", {"detect_s": 5.1, "detect_frames": 40}, {},
     1000.0 * 5.1 / 40),
    ("features.detect_ms_per_frame", {"detect_s": 5.0, "detect_frames": 39},
     {"detect_s": 0.1, "detect_frames": 1}, 1000.0 * 5.1 / 40),
    ("features.decode_ms_per_frame", {"image_decode_s": 0.8, "image_decodes": 40}, {},
     1000.0 * 0.8 / 40),
], ids=["extract", "detect", "detect-also-in-a-mapper", "decode"])
def test_extraction_reader_reads_its_span(name, timings, counters, value):
    r = READERS[name]
    assert r.read(_run(timings, counters)) == pytest.approx(value)
    assert r.drivers == ("photo_cli",) and r.moves == "frames_per_s"
    assert r.source == "program_span" and r.layer == "feature extraction"
    # A program without the extraction's spans (the parent of this cell)
    # gives no reading, and no error; nor does a window without maps.
    assert r.read(_run({"cli.inputs": 0.01, "sequential_loop": 4.0})) is None
    assert r.read(_run({}, maps=0)) is None
