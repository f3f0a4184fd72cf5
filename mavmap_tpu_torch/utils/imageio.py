"""Image files without Pillow: 8-bit PNG and binary PGM, read and written
with zlib and numpy.

The JAX package opens images with Pillow (`Image.open(p).convert("L")` for
the detector, `np.asarray(Image.open(p))` for point colors and drawings).
This module is the port's way to open the same files; it adds no format:

  - PNG: 8-bit gray, gray+alpha, RGB and RGBA, not interlaced, every row
    filter (none, Sub, Up, Average, Paeth), CRCs checked;
  - PGM: binary (P5) with maxval 255.

Anything else (16-bit samples, palettes, interlacing, JPEG, ...) raises
ImageFormatError naming the file; nothing falls back quietly. `read_gray`
converts to gray with Pillow's own integer formula for convert("L"),
L = (19595 R + 38470 G + 7471 B + 0x8000) >> 16, with alpha dropped, so a
gray image is bit for bit what the JAX package reads.
"""

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class ImageFormatError(ValueError):
    """An image file this module does not read (or a damaged one)."""


def _fail(path, why):
    raise ImageFormatError(f"{path}: {why}")


def _png_chunks(path, data):
    if data[:8] != _PNG_SIGNATURE:
        _fail(path, "not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            _fail(path, f"damaged PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    _fail(path, "PNG ends before its IEND chunk")


def _unfilter(path, raw, height, stride, bpp):
    """Undo the PNG row filters: (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        _fail(path, f"PNG image data holds {len(raw)} bytes, not {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            _fail(path, f"unknown PNG row filter {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def _read_png(path, data):
    header, idat = None, []
    for kind, body in _png_chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        _fail(path, "PNG without an IHDR chunk")
    width, height, depth, ctype, compression, filt, interlace = header
    if depth != 8:
        _fail(path, f"{depth}-bit PNG samples are not read (8-bit only)")
    if ctype not in _PNG_CHANNELS:
        _fail(path, f"PNG color type {ctype} is not read (gray, gray+alpha, RGB, RGBA only)")
    if interlace != 0:
        _fail(path, "interlaced PNG is not read")
    if compression != 0 or filt != 0:
        _fail(path, f"PNG compression {compression} / filter method {filt} is not read")
    ch = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        _fail(path, f"PNG image data does not inflate ({e})")
    px = _unfilter(path, raw, height, width * ch, ch)
    return px.reshape(height, width) if ch == 1 else px.reshape(height, width, ch)


def _pgm_tokens(path, data, count):
    """The first `count` header tokens of a PNM file (comments skipped) and
    the offset just past the single whitespace byte after the last."""
    tokens, pos = [], 0
    while len(tokens) < count:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            _fail(path, "PGM header ends early")
        tokens.append(data[start:pos])
    return tokens, pos + 1


def _read_pgm(path, data):
    (magic, w, h, maxval), pos = _pgm_tokens(path, data, 4)
    if magic != b"P5":
        _fail(path, f"PNM type {magic!r} is not read (binary PGM, P5, only)")
    width, height, maxval = int(w), int(h), int(maxval)
    if maxval != 255:
        _fail(path, f"PGM maxval {maxval} is not read (255 only)")
    px = np.frombuffer(data, np.uint8, count=width * height, offset=pos) \
        if len(data) >= pos + width * height else None
    if px is None:
        _fail(path, "PGM pixel data ends early")
    return px.reshape(height, width).copy()


def read_image(path):
    """The file's pixels as uint8, shaped as np.asarray(Image.open(path))
    gives them: (H, W) gray, (H, W, 2) gray+alpha, (H, W, 3) RGB, (H, W, 4)
    RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        return _read_png(path, data)
    if data[:2] == b"P5":
        return _read_pgm(path, data)
    _fail(path, "not an 8-bit PNG or a binary PGM (no other image format is read)")


def to_gray(pixels):
    """uint8 (H, W[, C]) -> (H, W) gray as Pillow's convert("L"): gray is
    kept, gray+alpha keeps its gray, RGB(A) takes the integer luma."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        raise ValueError(f"to_gray takes uint8 pixels, not {px.dtype}")
    if px.ndim == 2:
        return px
    if px.ndim == 3 and px.shape[2] == 2:
        return px[..., 0].copy()
    if px.ndim == 3 and px.shape[2] in (3, 4):
        rgb = px[..., :3].astype(np.uint32)
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    raise ValueError(f"to_gray: pixels of shape {px.shape}")


def read_gray(path):
    """(H, W) uint8 gray of an image file (Pillow's convert("L"))."""
    return to_gray(read_image(path))


def _gray_u8(path, pixels):
    px = np.asarray(pixels)
    if px.dtype != np.uint8 or px.ndim != 2:
        raise ValueError(f"{path}: a gray image is (H, W) uint8, not {px.dtype} {px.shape}")
    return px


def write_png(path, pixels):
    """Write an (H, W) uint8 gray image as an 8-bit PNG (row filter none)."""
    px = _gray_u8(path, pixels)
    h, w = px.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), px], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_pgm(path, pixels):
    """Write an (H, W) uint8 gray image as a binary PGM (P5, maxval 255)."""
    px = _gray_u8(path, pixels)
    with open(path, "wb") as f:
        f.write(f"P5\n{px.shape[1]} {px.shape[0]}\n255\n".encode() + px.tobytes())
