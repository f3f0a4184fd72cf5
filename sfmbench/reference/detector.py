"""A plain determinant-of-Hessian detector with SURF-128 descriptors, in
numpy float64: the reference the photograph cell holds the port's
on-card detector to.

The semantics are the port's (mavmap_tpu_torch/features/detector.py, as
its docstrings state them), written out directly:

- the image as gray / 255;
- octaves o = 0..3 at 2^-o of the frame (each halving the mean of 2x2
  blocks, an odd row or column dropped), 3 layers each at
  sigma = 1.6 * 2^(l / 3); per layer the Gaussian and its first and second
  derivatives (radius max(int(3 sigma + 0.5), 1), normalised, the second's
  DC residual removed by subtracting its sum times the Gaussian), applied
  separably by correlation over an edge-replicated border: Lxx (rows g, columns
  g''), Lxy (g', g'), Lyy (g'', g); det = Lxx Lyy - (0.9 Lxy)^2, times
  sigma^4;
- a maximum is >= all 26 neighbours of the octave's (layer, row, column)
  stack with every axis wrapping (layer 0 meets the last layer), at least
  max(8 / 2^o, 2) octave pixels from the border; it lands on the frame's
  grid at stride 2^o, the best layer of a pixel winning (the first on
  ties), and scores above hessian_threshold * 1e-6 count;
- the frame cut into a 3x3 grid of equal cells (the remainder strip
  unscanned); each cell keeps its max_features // 9 best scores, ties to
  the lower index (row-major within the cell);
- the position moved to the octave pixel's centre ((2^o - 1) / 2) and
  refined by a 1-D parabola per axis through the octave's responses one
  octave pixel either side (held by the nearest octave pixel on the
  frame's grid, zero beyond the last whole octave pixel), the offset
  clamped to +-0.5 octave pixels;
- the dominant orientation: gradients (central differences that wrap at
  the border) sampled bilinearly on a sigma-spaced 13x13 grid within 6
  sigma, weighted by a 2.5 sigma Gaussian, binned into 42 angle bins; a
  window of 7 bins (pi / 3) sums the vectors, the longest sum (the first
  on ties) gives the angle;
- SURF-128 on a 20x20 sample grid of spacing sigma rotated into that
  angle, Gaussian-weighted (sigma 5 samples), 4x4 cells of 5x5 samples:
  sums of dx and |dx| split by the sign of dy, and of dy and |dy| split by
  the sign of dx; the 128 values normalised to unit length.

Departures from the reference mavmap's OpenCV SURF (`base2d/feature.cc`),
which the port makes and this file follows: Gaussian derivative filters
in place of box filters on an integral image; a 2x2 mean pyramid in place
of growing filter sizes; scale-space wrap in the non-max suppression (the
port rolls its layer axis), so the first and last layers of an octave
each see the other as a neighbour; a quadratic fit per axis in place of
the 3-D Taylor refinement; no Laplacian sign; orientation by 42 angle
bins of the sampled gradients in place of Haar responses over a sliding
pi / 3 window; descriptor samples of bilinear gradients in place of Haar
wavelets, with SURF's 128-value extended layout (the sign split of
`extended=true`); a fixed per-cell budget in place of AdaptiveSURF's
adaptation (the cell's CLI sets no minimum per cell).

Nothing here imports the program.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Detection:
    """A frame's kept features: keypoints (N, 2) as (x, y), descriptors
    (N, 128) and each keypoint's octave, in the order the port writes them
    (cell by cell, strongest first)."""

    keypoints: np.ndarray
    descriptors: np.ndarray
    octaves: np.ndarray


def derivative_kernels(sigma):
    """(radius, g, g', g''), float64."""
    radius = max(int(3.0 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    g1 = -(x / sigma ** 2) * g
    g2 = ((x ** 2 - sigma ** 2) / sigma ** 4) * g
    return radius, g, g1, g2 - g2.sum() * g


def correlate(a, kernel, axis):
    """`a` correlated with `kernel` along `axis`, edge-replicated."""
    r = (len(kernel) - 1) // 2
    n = a.shape[axis]
    padded = np.take(a, np.clip(np.arange(-r, n + r), 0, n - 1), axis=axis)
    out = np.zeros(a.shape, np.float64)
    for k, w in enumerate(kernel):
        out += w * np.take(padded, np.arange(k, k + n), axis=axis)
    return out


def hessian_response(img, sigma):
    """Scale-normalised determinant of the Hessian of `img` at `sigma`."""
    _, g, g1, g2 = derivative_kernels(sigma)
    ys = [correlate(img, k, 0) for k in (g, g1, g2)]
    lxx, lxy, lyy = correlate(ys[0], g2, 1), correlate(ys[1], g1, 1), correlate(ys[2], g, 1)
    return (lxx * lyy - (0.9 * lxy) ** 2) * sigma ** 4


def local_maxima(stack):
    """Where a (L, H, W) stack is >= its 26 neighbours, every axis wrapping."""
    keep = np.ones(stack.shape, bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds or dy or dx:
                    keep &= stack >= np.roll(stack, (ds, dy, dx), axis=(0, 1, 2))
    return keep


def _sampler(gx, gy):
    """Bilinear samples of the two gradient images at float coordinates
    (corner indices clamped to the last whole cell)."""
    H, W = gx.shape
    f1, f2 = gx.reshape(-1), gy.reshape(-1)

    def sample(ys, xs):
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 2)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 2)
        fy, fx = np.clip(ys - y0, 0.0, 1.0), np.clip(xs - x0, 0.0, 1.0)
        i = y0 * W + x0
        w = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
        corners = (i, i + 1, i + W, i + W + 1)
        return (sum(f1[c] * wc for c, wc in zip(corners, w)),
                sum(f2[c] * wc for c, wc in zip(corners, w)))

    return sample


def orientations(sample, keypoints, sigmas, num_bins=42):
    """The dominant gradient angle of each keypoint, radians."""
    r = np.arange(-6, 7, dtype=np.float64)
    yo, xo = np.meshgrid(r, r, indexing="ij")
    weight = np.exp(-(yo ** 2 + xo ** 2) / (2.0 * 2.5 ** 2)) * (yo ** 2 + xo ** 2 <= 36.0 + 1e-6)
    ys = keypoints[:, 1, None, None] + yo * sigmas[:, None, None]
    xs = keypoints[:, 0, None, None] + xo * sigmas[:, None, None]
    sgx, sgy = sample(ys, xs)
    dx = (sgx * weight).reshape(len(keypoints), -1)
    dy = (sgy * weight).reshape(len(keypoints), -1)
    bins = np.clip(np.floor((np.arctan2(dy, dx) + np.pi) / (2.0 * np.pi) * num_bins),
                   0, num_bins - 1).astype(np.int64)
    hx, hy = np.zeros((len(keypoints), num_bins)), np.zeros((len(keypoints), num_bins))
    for b in range(num_bins):
        hx[:, b] = np.where(bins == b, dx, 0.0).sum(1)
        hy[:, b] = np.where(bins == b, dy, 0.0).sum(1)
    win = max(int(round(num_bins / 6.0)), 1)
    sx = sum(np.roll(hx, -k, axis=1) for k in range(win))
    sy = sum(np.roll(hy, -k, axis=1) for k in range(win))
    best = np.argmax(sx * sx + sy * sy, axis=1)
    rows = np.arange(len(keypoints))
    return np.arctan2(sy[rows, best], sx[rows, best])


def describe(img, keypoints, sigmas, upright=False):
    """SURF-128 descriptors (N, 128), unit length."""
    gx = (np.roll(img, -1, axis=1) - np.roll(img, 1, axis=1)) * 0.5
    gy = (np.roll(img, -1, axis=0) - np.roll(img, 1, axis=0)) * 0.5
    sample = _sampler(gx, gy)
    K = len(keypoints)
    angles = np.zeros(K) if upright else orientations(sample, keypoints, sigmas)
    offs = np.arange(20, dtype=np.float64) - 9.5
    wy = np.exp(-0.5 * (offs / 5.0) ** 2)
    weight = wy[:, None] * wy[None, :]
    ca, sa = np.cos(angles)[:, None, None], np.sin(angles)[:, None, None]
    U = offs[None, None, :] * sigmas[:, None, None]
    V = offs[None, :, None] * sigmas[:, None, None]
    X = keypoints[:, 0, None, None] + ca * U - sa * V
    Y = keypoints[:, 1, None, None] + sa * U + ca * V
    dxi, dyi = sample(Y, X)
    dx = ((ca * dxi + sa * dyi) * weight).reshape(K, 4, 5, 4, 5)
    dy = ((-sa * dxi + ca * dyi) * weight).reshape(K, 4, 5, 4, 5)
    parts = []
    for v, split in ((dx, dy), (dy, dx)):
        for m in (split >= 0, split < 0):
            parts.append(np.where(m, v, 0.0).sum(axis=(2, 4)))
            parts.append(np.where(m, np.abs(v), 0.0).sum(axis=(2, 4)))
    d = np.stack(parts, axis=-1).reshape(K, 128)
    return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-8)


def detect(gray, hessian_threshold=100.0, num_octaves=4, num_octave_layers=3,
           max_features=2048, grid_size=3, upright=False):
    """The kept features of an (H, W) gray image (uint8 or float, 0-255)."""
    img = np.asarray(gray, np.float64) / 255.0
    H, W = img.shape
    base = [1.6 * 2.0 ** (l / num_octave_layers) for l in range(num_octave_layers)]
    n_scales = num_octaves * num_octave_layers
    score = np.full((n_scales, H, W), -np.inf)
    dense = np.zeros((n_scales, H, W))
    sigma_of, octave_of = [], []
    img_o = img
    for o in range(num_octaves):
        f = 2 ** o
        Ho, Wo = img_o.shape
        stack = np.stack([hessian_response(img_o, s) for s in base])
        b = max(8 // f, 2)
        inside = np.zeros((Ho, Wo), bool)
        inside[b:Ho - b, b:Wo - b] = True
        kept = np.where(local_maxima(stack) & inside, stack, -np.inf)
        for l in range(num_octave_layers):
            s = o * num_octave_layers + l
            score[s, :Ho * f:f, :Wo * f:f] = kept[l]
            up = np.repeat(np.repeat(stack[l], f, axis=0), f, axis=1)[:H, :W]
            dense[s, :up.shape[0], :up.shape[1]] = up
            sigma_of.append(base[l] * f)
            octave_of.append(o)
        he, we = (Ho // 2) * 2, (Wo // 2) * 2
        a = img_o[:he, :we]
        img_o = 0.25 * (a[::2, ::2] + a[1::2, ::2] + a[::2, 1::2] + a[1::2, 1::2])
    thr = hessian_threshold * 1e-6
    score = np.where(score > thr, score, -np.inf)
    best_scale = np.argmax(score, axis=0)
    best = np.take_along_axis(score, best_scale[None], 0)[0]

    rows, cols = (grid_size, grid_size) if isinstance(grid_size, int) else grid_size
    per_cell = max_features // (rows * cols)
    ch, cw = H // rows, W // cols
    kp, scale = [], []
    for cy in range(rows):
        for cx in range(cols):
            cell = best[cy * ch:(cy + 1) * ch, cx * cw:(cx + 1) * cw].reshape(-1)
            order = np.argsort(-cell, kind="stable")[:per_cell]
            order = order[np.isfinite(cell[order]) & (cell[order] > thr)]
            py, px = order // cw + cy * ch, order % cw + cx * cw
            kp.append(np.stack([px, py], -1))
            scale.append(best_scale[py, px])
    kp = np.concatenate(kp).astype(np.float64)
    scale = np.concatenate(scale)
    fac = np.array([2 ** o for o in octave_of], np.int64)[scale]
    sig = np.array(sigma_of)[scale]
    kp = kp + ((fac - 1) * 0.5)[:, None]

    ky = np.clip(kp[:, 1].astype(np.int64), 1, H - 2)
    kx = np.clip(kp[:, 0].astype(np.int64), 1, W - 2)
    ky0, kx0 = (ky // fac) * fac, (kx // fac) * fac

    def at(y, x):
        return dense[scale, np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)]

    r0 = at(ky0, kx0)
    offsets = []
    for m, p in ((at(ky0, kx0 - fac), at(ky0, kx0 + fac)), (at(ky0 - fac, kx0),
                                                            at(ky0 + fac, kx0))):
        curv = m - 2.0 * r0 + p
        ok = np.abs(curv) > 1e-12
        off = np.where(ok, 0.5 * (m - p) / np.where(ok, curv, 1.0), 0.0)
        offsets.append(np.clip(off, -0.5, 0.5) * fac)
    kp = kp + np.stack(offsets, -1)
    desc = describe(img, kp, sig, upright=upright)
    return Detection(keypoints=kp, descriptors=desc, octaves=np.array(octave_of)[scale])
