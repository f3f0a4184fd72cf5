"""The photograph survey's images, in numpy alone: a PNG reader and writer
for 8-bit gray images, and the survey renderer.

- `read_png`: an 8-bit gray PNG (colour type 0, not interlaced, every
  row filter: none, Sub, Up, Average, Paeth; CRCs checked), the format of
  the committed photographs under mavmap_tpu_torch/data/photos/.
- `write_png`: an 8-bit gray PNG, row filter none, zlib level 1 (the
  survey's frames carry sensor noise, which a higher level hardly
  shrinks).
- `render_photo_survey`: the port's `render_photo_survey`, written from
  its documented arithmetic. The ground is a collage of the photographs,
  each cut to the lowest one's height, beside their mirror images,
  mirror-tiled into 6 rows, draped over the height field
  relief_amp (sin 0.37x cos 0.41y + 0.6 sin(0.73x + 1.3) sin(0.53y + 0.7)).
  Each pixel's ray leaves the camera centre, meets the flat ground, then
  takes 4 fixed-point steps onto the height field; the texture is read
  bilinearly and modulated by 0.82 + 0.18 sin(0.11x + 0.07y). Geometry in
  float32, the bilinear weights and the texture value in float64, the
  clamp to [0, 255] truncated to uint8. The rotations are Rodrigues' in
  float32 in the port's order of operations (`rotmat32`), so the frames
  agree with the port's to single gray levels on a few pixels, where sin /
  cos and the rays' product with the rotation round differently.

Nothing here imports the program.
"""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# The committed photographs, in the order the port's collage takes them.
SAMPLE_PHOTOS = ("grace_hopper", "china", "flower")


def _chunks(data):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"damaged PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw, height, width):
    """Undo the row filters of one byte per pixel: (height, width) uint8."""
    if len(raw) != height * (width + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not {height * (width + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, width + 1)
    out = np.zeros((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum modulo 256
            cur = (np.cumsum(line, dtype=np.uint64) & 0xFF).astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before it
            cur, up = [0] * width, prior.tolist()
            for x in range(width):
                a = cur[x - 1] if x else 0
                c = up[x - 1] if x else 0
                pred = (a + up[x]) >> 1 if kind == 3 else _paeth(a, up[x], c)
                cur[x] = (int(line[x]) + pred) & 0xFF
            cur = np.array(cur, np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path):
    """(H, W) uint8 pixels of an 8-bit gray PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, compression, filt, interlace = header
    if (depth, ctype, compression, filt, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit gray PNG without interlacing")
    return _unfilter(zlib.decompress(b"".join(idat)), height, width)


def png_bytes(pixels):
    """The bytes of an 8-bit gray PNG of (H, W) uint8 pixels."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8 or px.ndim != 2:
        raise ValueError(f"a gray image is (H, W) uint8, not {px.dtype} {px.shape}")
    h, w = px.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), px], axis=1)
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_png(path, pixels):
    with open(path, "wb") as f:
        f.write(png_bytes(pixels))


def rotmat32(rvec, fused=True):
    """Rodrigues' rotation of one angle-axis vector in float32, in the
    port's order of operations: theta^2 as ((x^2 + y^2) + z^2), sin / cos
    rounded once to float32, I + a K + b K K. Each entry of K K is, with
    `fused`, a chain of three fused multiply-adds (each product exact, one
    rounding per step), as the port's float32 product of one 3x3 pair
    computes it on the CPU; else a sum of products each rounded, as its
    batched product does (the footprint's bounds come from that one)."""
    r = np.asarray(rvec, np.float32)
    f = np.float32
    theta2 = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]
    theta = np.sqrt(theta2)
    if theta2 < f(1e-12):
        a, b = f(1.0) - theta2 / f(6.0), f(0.5) - theta2 / f(24.0)
    else:
        a = f(np.sin(np.float64(theta))) / theta
        b = (f(1.0) - f(np.cos(np.float64(theta)))) / theta2
    x, y, z = r
    zero = f(0.0)
    K = np.array([[zero, -z, y], [z, zero, -x], [-y, x, zero]], np.float32)
    KK = np.zeros((3, 3), np.float32)
    for k in range(3):
        if fused:
            KK = (np.outer(K[:, k].astype(np.float64), K[k, :]) + KK).astype(np.float32)
        else:
            KK = KK + np.outer(K[:, k], K[k, :])
    return np.eye(3, dtype=np.float32) + a * K + b * KK


def load_photos(paths):
    """The photographs' gray pixels as float32 arrays."""
    return [read_png(p).astype(np.float32) for p in paths]


def _height(gx, gy, amp):
    f = np.float32
    return amp * (np.sin(f(0.37) * gx) * np.cos(f(0.41) * gy)
                  + f(0.6) * np.sin(f(0.73) * gx + f(1.3)) * np.sin(f(0.53) * gy + f(0.7)))


def render_photo_survey(scene, photos, relief_amp=4.0):
    """Every frame of `scene` (reference/scene.py's Scene, its first
    camera PINHOLE) over the photographs (a list of (H, W) gray arrays):
    a list of (H, W) uint8 images, the poses the scene's truth."""
    f = np.float32
    photos = [np.asarray(p, np.float32) for p in photos]
    if not photos:
        raise ValueError("render_photo_survey: no photographs given")
    hmin = min(p.shape[0] for p in photos)
    strip = np.concatenate([p[:hmin] for p in photos] + [p[:hmin, ::-1] for p in photos], 1)
    tex = np.concatenate([strip if k % 2 == 0 else strip[::-1] for k in range(6)], 0)
    th, tw = tex.shape
    flat = np.ascontiguousarray(tex).reshape(-1)

    w, h = scene.image_size
    Rb = np.stack([rotmat32(r, fused=False) for r in scene.rvecs])
    C = -np.einsum("nij,nj->ni", Rb.transpose(0, 2, 1), scene.tvecs)
    fx, fy, cx, cy = (float(v) for v in scene.cam_params[0][:4])
    half = 1.2 * np.max(C[:, 2]) * max(w, h) / 2.0 / fx
    x0, x1 = C[:, 0].min() - half, C[:, 0].max() + half
    y0, y1 = C[:, 1].min() - half, C[:, 1].max() + half
    X0, Y0, XS, YS = f(x0), f(y0), f(x1 - x0), f(y1 - y0)
    amp = f(relief_amp)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1).astype(np.float32)
    tiny = f(1e-6)

    images = []
    for r_i, t_i in zip(scene.rvecs, scene.tvecs):
        R = rotmat32(r_i)
        Ci = -R.T @ t_i
        d = rays @ R
        dz = np.where(np.abs(d[..., 2]) < tiny, tiny, d[..., 2])
        cx_, cy_, cz = f(Ci[0]), f(Ci[1]), f(Ci[2])
        t = -cz / dz
        for _ in range(4):
            gx = cx_ + t * d[..., 0]
            gy = cy_ + t * d[..., 1]
            t = (_height(gx, gy, amp) - cz) / dz
        gx = cx_ + t * d[..., 0]
        gy = cy_ + t * d[..., 1]
        u = np.clip((gx - X0) / XS * f(tw - 2), f(0), f(tw - 2))
        v = np.clip((gy - Y0) / YS * f(th - 2), f(0), f(th - 2))
        ui, vi = u.astype(np.int64), v.astype(np.int64)
        fu, fv = u.astype(np.float64) - ui, v.astype(np.float64) - vi
        at = vi * tw + ui
        val = (flat[at] * (1 - fu) * (1 - fv) + flat[at + 1] * fu * (1 - fv)
               + flat[at + tw] * (1 - fu) * fv + flat[at + tw + 1] * fu * fv)
        val = val * (f(0.82) + f(0.18) * np.sin(f(0.11) * gx + f(0.07) * gy))
        images.append(np.clip(val, 0, 255).astype(np.uint8))
    return images
