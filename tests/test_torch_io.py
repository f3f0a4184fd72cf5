"""The port's file readers and writers held against the JAX package's and
Pillow's: imagedata.txt and control-point files field for field, the IMU
prior's rvec to 1e-6, and utils/imageio.py (PNG and PGM without Pillow)
bit for bit against Pillow's reading and gray conversion."""

import os
import struct
import zlib
from dataclasses import asdict

import numpy as np
import pytest

from mavmap_tpu.utils import io as jio

from mavmap_tpu_torch.utils import imageio
from mavmap_tpu_torch.utils import io as tio

IMAGEDATA = """# BASENAME, ROLL, PITCH, YAW, LAT, LON, ALT, LOCAL_HEIGHT, TX, TY, TZ, ...
img0, 0.1, -0.2, 1.3, 47.1, 8.5, 500.0, 30.0, 1.0, 2.0, 3.0, 1, PINHOLE, 700, 701, 400, 300
img1, 3.05, 0.01, -0.4, 47.2, 8.6, 501.5, 31.0, 1.5, 2.5, 3.5

img2, -3.1, 0.02, 0.7, 0, 0, 0, 0, 0, 0, 0, 2, OPENCV, 620, 620, 406, 296, -0.15, 0.03, 5e-4, -5e-4
img3, 0.0, 0.0, 0.0, 0, 0, 0, 0, 0, 0, 0, 1
img4, 0.2, 0.1, -2.9, 0, 0, 0, 0, 0, 0, 0, 2
img5, 0.2, 0.1, -2.9, 0, 0, 0, 0, 0, 0, 0, 3, 1, 650, 650, 400, 300
"""

CONTROL_POINTS = """## base, 10.5, -3.25, 1.0
0, 410.5, 300.25
3, 402.0, 288.0
# tower, 12.0, 4.0, 8.5
1, 100.0, 200.0
2, 150.5, 220.75
4, 160.0, 230.0
## well, -1.0, 2.0, 0.5
5, 33.0, 44.0
"""


def test_image_data_reader_matches_jax(tmp_path):
    """read_image_data (camera inheritance by position and by index, named
    and numeric model codes) and cameras_from_records give the JAX
    package's records and camera tables field for field, and prior_rvec
    agrees to 1e-6."""
    path = tmp_path / "imagedata.txt"
    path.write_text(IMAGEDATA)
    rt, rj = tio.read_image_data(str(path)), jio.read_image_data(str(path))
    assert [asdict(r) for r in rt] == [asdict(r) for r in rj]
    for a, b in zip(tio.cameras_from_records(rt), jio.cameras_from_records(rj)):
        np.testing.assert_array_equal(a, b)
    for r_t, r_j in zip(rt, rj):
        np.testing.assert_allclose(r_t.prior_rvec(), np.asarray(r_j.prior_rvec()), atol=1e-6)
        assert r_t.prior_rvec().dtype == np.float32


@pytest.mark.parametrize("bad", ["img0, 1, 2, 3", "img0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0",
                                 "img0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, PINHOLE, 700, 700"])
def test_image_data_reader_refuses_like_jax(tmp_path, bad):
    """A short line, a first image without a camera and a camera with the
    wrong number of parameters raise in both packages."""
    path = tmp_path / "imagedata.txt"
    path.write_text(bad + "\n")
    for read in (tio.read_image_data, jio.read_image_data):
        with pytest.raises(ValueError):
            read(str(path))


def test_control_point_reader_and_writer_match_jax(tmp_path):
    """Fixed (##) and variable (#) control points parse to the JAX
    package's records, and the estimate writer writes the same bytes; the
    calibration-matrix reader agrees too."""
    path = tmp_path / "gcp.txt"
    path.write_text(CONTROL_POINTS)
    ct, cj = tio.read_control_point_data(str(path)), jio.read_control_point_data(str(path))
    assert len(ct) == len(cj) == 3
    for a, b in zip(ct, cj):
        assert (a.name, a.points2D, a.fixed) == (b.name, b.points2D, b.fixed)
        np.testing.assert_array_equal(a.xyz, b.xyz)
    est = [np.array([1.0, 2.0, 3.0]), np.array([-0.1234567, 5.5, 1e3]), np.zeros(3)]
    args = ([1, 3, 0], [0.5, 0.25, -1.0])
    tio.write_control_point_data(str(tmp_path / "t.txt"), ct, est, *args)
    jio.write_control_point_data(str(tmp_path / "j.txt"), cj, est, *args)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    calib = tmp_path / "K.txt"
    calib.write_text("# K\n700, 0, 400\n0 701 300\n0, 0, 1\n")
    np.testing.assert_array_equal(tio.read_calib_matrix(str(calib)),
                                  jio.read_calib_matrix(str(calib)))


def _pixels(rng, mode):
    shape = {"L": (37, 53), "LA": (37, 53, 2), "RGB": (37, 53, 3), "RGBA": (37, 53, 4)}[mode]
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_read_matches_pillow(rng, tmp_path, mode):
    """PNGs that Pillow writes (its own row filters) read as
    np.asarray(Image.open(p)) gives them, and read_gray equals Pillow's
    convert("L") bit for bit."""
    Image = pytest.importorskip("PIL.Image")
    px = _pixels(rng, mode)
    path = tmp_path / f"{mode}.png"
    Image.fromarray(px, mode=mode).save(path)
    np.testing.assert_array_equal(imageio.read_image(str(path)), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(imageio.read_gray(str(path)),
                                  np.asarray(Image.open(path).convert("L")))


def _png_with_filters(path, px, filters):
    """An 8-bit PNG of px (H, W[, C]) whose row y uses row filter
    filters[y] (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth), encoded here."""
    h, w = px.shape[:2]
    ch = 1 if px.ndim == 2 else px.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = px.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        f = filters[y]
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (a + up) // 2
        else:
            p = a + up - c
            pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGBA"])
def test_png_every_row_filter(rng, tmp_path, mode):
    """Rows under each of the five PNG filters decode to the pixels, and
    Pillow reads the same file to the same array."""
    Image = pytest.importorskip("PIL.Image")
    px = _pixels(rng, mode)
    path = tmp_path / "filters.png"
    _png_with_filters(path, px, [y % 5 for y in range(px.shape[0])])
    np.testing.assert_array_equal(imageio.read_image(str(path)), px)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), px)


def test_png_and_pgm_round_trip(rng, tmp_path):
    """write_png / write_pgm then read_image give the gray pixels back, and
    Pillow reads both files to the same array."""
    px = rng.integers(0, 256, (41, 67), dtype=np.uint8)
    for name, write in (("a.png", imageio.write_png), ("a.pgm", imageio.write_pgm)):
        write(str(tmp_path / name), px)
        np.testing.assert_array_equal(imageio.read_image(str(tmp_path / name)), px)
        np.testing.assert_array_equal(imageio.read_gray(str(tmp_path / name)), px)
    Image = pytest.importorskip("PIL.Image")
    for name in ("a.png", "a.pgm"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)), px)


def test_pgm_header_comments(tmp_path):
    """A P5 header with comments and odd whitespace reads."""
    px = np.arange(12, dtype=np.uint8).reshape(3, 4)
    (tmp_path / "c.pgm").write_bytes(b"P5 # made by hand\n4\t3\n# maxval next\n255\n"
                                     + px.tobytes())
    np.testing.assert_array_equal(imageio.read_image(str(tmp_path / "c.pgm")), px)


def _patched_ihdr(tmp_path, **fields):
    """A valid gray PNG with IHDR fields replaced (depth, ctype, interlace)."""
    imageio.write_png(str(tmp_path / "ok.png"), np.zeros((4, 4), np.uint8))
    data = bytearray((tmp_path / "ok.png").read_bytes())
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", w, h, fields.get("depth", depth), fields.get("ctype", ctype),
                       comp, filt, fields.get("interlace", inter))
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    return path


@pytest.mark.parametrize("fields,why", [({"interlace": 1}, "interlaced"),
                                         ({"depth": 16}, "16-bit"),
                                         ({"ctype": 3}, "color type 3")])
def test_unsupported_png_is_refused(tmp_path, fields, why):
    """An interlaced, a 16-bit and a palette PNG raise ImageFormatError
    naming the file and the reason; nothing falls back."""
    path = _patched_ihdr(tmp_path, **fields)
    with pytest.raises(imageio.ImageFormatError, match=why) as e:
        imageio.read_image(str(path))
    assert str(path) in str(e.value)


def test_other_formats_are_refused(rng, tmp_path):
    """A JPEG, a damaged PNG and a PGM with maxval 65535 raise, naming the
    file."""
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(rng.integers(0, 256, (16, 16), dtype=np.uint8)).save(tmp_path / "a.jpg")
    imageio.write_png(str(tmp_path / "d.png"), np.zeros((4, 4), np.uint8))
    data = bytearray((tmp_path / "d.png").read_bytes())
    data[45] ^= 0xFF  # inside the IDAT data: its CRC no longer holds
    (tmp_path / "d.png").write_bytes(bytes(data))
    (tmp_path / "w.pgm").write_bytes(b"P5\n2 2\n65535\n" + bytes(8))
    for name, why in (("a.jpg", "not an 8-bit PNG"), ("d.png", "damaged"),
                      ("w.pgm", "maxval 65535")):
        with pytest.raises(imageio.ImageFormatError, match=why) as e:
            imageio.read_image(str(tmp_path / name))
        assert name in str(e.value)


def test_timers_match_jax(monkeypatch):
    """Timer and StageTimers keep the JAX package's API and report format
    (on a fake clock, so the strings are exact)."""
    import time

    from mavmap_tpu.utils import timer as jtimer
    from mavmap_tpu_torch.utils import timer as ttimer

    reports = []
    for mod in (ttimer, jtimer):
        clock = iter(float(t) for t in range(100))
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = mod.Timer()
        t.start()
        t.pause()
        t.start()
        assert t.elapsed_time() == 2.0
        st = mod.StageTimers()
        for name in ("detect", "map", "detect"):
            with st.stage(name):
                pass
        reports.append(st.report())
    assert reports[0] == reports[1] == ("detect: 2.000s total, 2 calls, 1000.0 ms/call\n"
                                        "map: 1.000s total, 1 calls, 1000.0 ms/call")


def test_device_trace_writes_a_trace(tmp_path):
    """device_trace records the block with torch.profiler and writes the
    trace for TensorBoard into the directory."""
    import torch

    from mavmap_tpu_torch.utils.timer import device_trace

    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(tmp_path))
