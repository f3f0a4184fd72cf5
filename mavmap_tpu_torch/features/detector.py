"""SURF-style feature detection + description in plain PyTorch.

Port of mavmap_tpu/features/detector.py (reference src/base2d/feature.{h,cc},
AdaptiveSURF), run on an explicit device:

  - scale space by separable Gaussian(-derivative) filters: edge-replicate
    padding, then one 1-D convolution per axis (conv2d). The JAX version
    folds the padding into dense banded matrices and multiplies, which
    suits the TPU's matrix unit; on a GPU a 4000x3000 frame would spend
    about a TFLOP per scale on those zero bands;
  - determinant-of-Hessian response det = Lxx Lyy - (0.9 Lxy)^2 per scale,
    scale-normalized by sigma^4;
  - 3x3x3 non-max suppression by torch.roll, which wraps around like
    jnp.roll (the scale axis included: layer 0 meets the last layer);
  - per-cell top-k over a fixed grid, by a stable descending sort so that
    ties keep the lower index first, as jax.lax.top_k keeps them (the order
    feeds the matcher's ties and RANSAC's indices);
  - SURF-128 descriptors on a 20 sigma window with bilinear gradient
    samples, rotated into the dominant orientation unless `upright`, as
    batched tensor code over (keypoints, samples).

Shapes are static: `max_features` rows with a validity mask, as the feature
providers expect. Nothing here is a hand kernel: the JAX detector reaches no
Pallas kernel.

`detect_image_file` opens two spans per image: `features.decode` (reading
and converting the file; counters `image_decode_s`, `image_decodes`) and
`features.detect` (one detection, from the upload to the host arrays;
`detect_s`, `detect_frames`). They add to the counters of the mapper whose
span is open, else to the `totals` dict given (the CLI's timings, shared
by its extraction threads).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.imageio import read_gray
from ..utils.timer import add_total, owner_counters, span


def _gaussian_kernel1d_np(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float64)


def _derivative_kernels(sigma):
    """(radius, g, g1, g2): the Gaussian and its first and second
    derivatives, float64, with the second's DC residual removed."""
    radius = max(int(3.0 * sigma + 0.5), 1)
    g = _gaussian_kernel1d_np(sigma, radius)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g1 = -(x / (sigma**2)) * g
    g2 = ((x**2 - sigma**2) / (sigma**4)) * g
    # DC correction: the continuous operator has integral 0, but sampling and
    # tail truncation leave sum(g2) ~ 1e-3, which turns constant regions into
    # responses above the adaptive floor (hessian / 1.5^10). Subtracting the
    # residual times the smoothing kernel keeps the shape and zeroes flat
    # responses.
    g2 = g2 - g2.sum() * g
    return radius, g, g1, g2


def _replicate(x, radius, dim):
    """x padded by `radius` edge copies on both sides of `dim` (any radius,
    also one beyond the axis: indices clamp onto the edge)."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-radius, n + radius, device=x.device), 0, n - 1)
    return x.index_select(dim, idx)


def _hessian_response(img, sigma):
    """Determinant-of-Hessian response of an (H, W) image at scale sigma,
    scale-normalized. The y pass filters the image with g, g1 and g2 (three
    output channels of one conv2d); the x pass filters those channels with
    g2, g1 and g (one grouped conv2d), giving Lxx (y: g, x: g2), Lxy (y: g1,
    x: g1) and Lyy (y: g2, x: g). Edge-replicate padding: a constant image
    gives zero derivatives (zero padding would fabricate step edges)."""
    radius, g, g1, g2 = _derivative_kernels(sigma)
    K = 2 * radius + 1

    def w(*kerns):
        return torch.as_tensor(np.stack(kerns), dtype=torch.float32, device=img.device)

    x = _replicate(img[None, None], radius, 2)
    ys = F.conv2d(x, w(g, g1, g2).reshape(3, 1, K, 1))            # (1, 3, H, W)
    out = F.conv2d(_replicate(ys, radius, 3), w(g2, g1, g).reshape(3, 1, 1, K), groups=3)
    Lxx, Lxy, Lyy = out[0, 0], out[0, 1], out[0, 2]
    det = Lxx * Lyy - (0.9 * Lxy) ** 2
    return det * sigma**4  # scale normalization


def detect_and_describe(img, hessian_threshold=100.0, num_octaves=4, num_octave_layers=3,
                        max_features=2048, grid_size=3, upright=False, cell_thresholds=None,
                        min_per_cell=0, adapt_levels=10):
    """(H, W) grayscale [0, 255] tensor -> (keypoints (K, 2), scales (K,),
    descriptors (K, 128), mask (K,), cell_counts (rows*cols,)), all on
    img's device.

    K = max_features. The response map is divided into a rows x cols grid
    (grid_size: int for square, or (rows, cols)) and each cell receives an
    equal share of the keypoint budget (the reference's adaptive per-cell
    thresholds, feature.h:24-31).

    Adaptive per-cell thresholds (reference AdaptiveSURF, feature.cc:198-309):
    `cell_thresholds` is an optional (rows*cols,) array of per-cell Hessian
    thresholds (same units as hessian_threshold), kept across frames by
    AdaptiveDetector. With `min_per_cell` > 0 the strongest min_per_cell
    maxima of a cell are admitted even below the cell threshold, but never
    below the quality floor hessian_threshold / 1.5^adapt_levels.
    cell_counts reports per-cell above-threshold counts for the host-side
    adaptation rule.
    """
    H, W = img.shape
    dev = img.device
    img = img.to(torch.float32) / 255.0
    grid_rows, grid_cols = (grid_size, grid_size) if isinstance(grid_size, int) else grid_size

    # Octave-downsampled pyramid: octave o runs at H/2^o x W/2^o with the small
    # base sigmas, and det * sigma_rel^4 at octave resolution is the
    # scale-normalized full-resolution response.
    base_sigmas = [1.6 * (2.0 ** (l / num_octave_layers)) for l in range(num_octave_layers)]
    sigmas, scale_factor, resp_full, dense_full = [], [], [], []
    img_o = img
    for o in range(num_octaves):
        f = 2**o
        Ho, Wo = img_o.shape
        st = torch.stack([_hessian_response(img_o, s) for s in base_sigmas])  # (L, Ho, Wo)
        # 3x3x3 non-max suppression within the octave; torch.roll wraps like
        # jnp.roll, on the scale axis too.
        is_max = torch.ones_like(st, dtype=torch.bool)
        for ds in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if ds == 0 and dy == 0 and dx == 0:
                        continue
                    is_max = is_max & (st >= torch.roll(st, (ds, dy, dx), dims=(0, 1, 2)))
        # Border suppression at octave resolution (8 full-res px minimum).
        b = max(8 // f, 2)
        yy = torch.arange(Ho, device=dev)
        xx = torch.arange(Wo, device=dev)
        bm = ((yy[:, None] >= b) & (yy[:, None] < Ho - b)
              & (xx[None, :] >= b) & (xx[None, :] < Wo - b))
        dense = st
        st = torch.where(is_max & bm[None], st, torch.full_like(st, -math.inf))
        # The surviving maxima land on the full-res grid at stride f (each on
        # exactly one pixel); the dense maps ride along nearest-upsampled for
        # the sub-pixel fit.
        for l in range(num_octave_layers):
            up = torch.full((H, W), -math.inf, dtype=torch.float32, device=dev)
            up[: Ho * f: f, : Wo * f: f] = st[l]
            resp_full.append(up)
            d = dense[l].repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)[:H, :W]
            dense_full.append(F.pad(d, (0, W - d.shape[1], 0, H - d.shape[0])))
            sigmas.append(base_sigmas[l] * f)
            scale_factor.append(f)
        if o + 1 < num_octaves:
            he, we = (Ho // 2) * 2, (Wo // 2) * 2
            a = img_o[:he, :we]
            img_o = 0.25 * (a[::2, ::2] + a[1::2, ::2] + a[::2, 1::2] + a[1::2, 1::2])

    responses = torch.stack(resp_full)  # (S, H, W) sparse suppressed scores
    responses_dense = torch.stack(dense_full)
    thr = hessian_threshold * 1e-6
    # Quality floor: the deepest threshold the reference's /1.5 adaptation
    # could reach.
    floor = thr * float(1.5 ** (-adapt_levels)) if min_per_cell > 0 else thr
    responses = torch.where(responses > floor, responses, torch.full_like(responses, -math.inf))
    score_flat, best_scale = torch.max(responses, dim=0)  # best scale per pixel (first on ties)

    n_cells = grid_rows * grid_cols
    if cell_thresholds is None:
        cell_thr = torch.full((n_cells,), thr, dtype=torch.float32, device=dev)
    else:
        cell_thr = torch.as_tensor(np.asarray(cell_thresholds), dtype=torch.float32,
                                   device=dev) * 1e-6

    # Per-cell top-k over fixed-size cells (the H % rows / W % cols remainder
    # strip is not scanned; it lies inside the suppressed border): a stable
    # descending sort of each cell, so equal scores keep the lower index
    # first, as jax.lax.top_k does.
    per_cell = max_features // n_cells
    cell_h, cell_w = H // grid_rows, W // grid_cols

    def cells(a):
        a = a[: grid_rows * cell_h, : grid_cols * cell_w]
        return a.reshape(grid_rows, cell_h, grid_cols, cell_w).permute(0, 2, 1, 3).reshape(
            n_cells, cell_h * cell_w)

    vals, idx = _top_k(cells(score_flat), per_cell)
    cy = torch.arange(grid_rows, device=dev).repeat_interleave(grid_cols)
    cx = torch.arange(grid_cols, device=dev).repeat(grid_rows)
    py = idx // cell_w + (cy * cell_h)[:, None]
    px = idx % cell_w + (cx * cell_w)[:, None]
    scale_idx = torch.gather(cells(best_scale), 1, idx).reshape(-1)
    above = torch.isfinite(vals) & (vals > cell_thr[:, None])
    cell_counts = above.sum(dim=1, dtype=torch.int32)
    keep = above
    if min_per_cell > 0:
        rank = torch.arange(per_cell, device=dev)
        keep = keep | (torch.isfinite(vals) & (rank[None, :] < min_per_cell))
    mask = keep.reshape(-1)
    keypoints = torch.stack([px, py], dim=-1).reshape(-1, 2).to(torch.float32)  # (x, y)

    kp_sigma = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)[scale_idx]
    kp_fac = torch.as_tensor(scale_factor, dtype=torch.float32, device=dev)[scale_idx]
    # Coarse-octave centering: octave pixel (x_o, y_o) sits at full-res
    # (x_o + 0.5) * f - 0.5 = grid position + (f - 1) / 2.
    keypoints = keypoints + ((kp_fac - 1.0) * 0.5)[:, None]

    # Sub-pixel localization: 1-D quadratic fits on the dense response at the
    # octave stride; the fit engages only where both neighbours are finite,
    # offsets clamp to +-0.5 octave px.
    fi = kp_fac.to(torch.int32)
    fs = torch.clamp(fi, min=1)
    ky = torch.clamp(keypoints[:, 1].to(torch.int32), 1, H - 2)
    kx = torch.clamp(keypoints[:, 0].to(torch.int32), 1, W - 2)
    ky0 = (ky // fs) * fs
    kx0 = (kx // fs) * fs

    def r_at(y, x):
        return responses_dense[scale_idx.long(), y.long(), x.long()]

    r0 = r_at(ky0, kx0)
    rxm = r_at(ky0, torch.clamp(kx0 - fi, 0, W - 1))
    rxp = r_at(ky0, torch.clamp(kx0 + fi, 0, W - 1))
    rym = r_at(torch.clamp(ky0 - fi, 0, H - 1), kx0)
    ryp = r_at(torch.clamp(ky0 + fi, 0, H - 1), kx0)
    dxx = rxm - 2.0 * r0 + rxp
    dyy = rym - 2.0 * r0 + ryp
    okx = torch.isfinite(rxm) & torch.isfinite(rxp) & (torch.abs(dxx) > 1e-12)
    oky = torch.isfinite(rym) & torch.isfinite(ryp) & (torch.abs(dyy) > 1e-12)
    zero = torch.zeros_like(dxx)
    offx = torch.where(okx, 0.5 * (rxm - rxp) / dxx, zero)
    offy = torch.where(oky, 0.5 * (rym - ryp) / dyy, zero)
    offx = torch.clamp(offx, -0.5, 0.5) * kp_fac
    offy = torch.clamp(offy, -0.5, 0.5) * kp_fac
    keypoints = keypoints + torch.stack([offx, offy], dim=-1)

    desc = _describe(img, keypoints, kp_sigma, upright=upright)
    K = keypoints.shape[0]
    if K < max_features:
        pad = max_features - K
        keypoints = torch.cat([keypoints, torch.zeros((pad, 2), device=dev)])
        kp_sigma = torch.cat([kp_sigma, torch.ones((pad,), device=dev)])
        desc = torch.cat([desc, torch.zeros((pad, 128), device=dev)])
        mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return keypoints, kp_sigma, desc, mask, cell_counts


def _top_k(x, k):
    """Row-wise top k of (R, N) as jax.lax.top_k gives it: (values, indices)
    in descending order, equal values lowest index first (a stable sort;
    torch.topk guarantees no order among ties)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _grad_sampler(gx, gy):
    """Bilinear sampler of both gradient images at shared float coords: the
    four corners of each sample are gathered from the flat images (the JAX
    version packs them into one (H W, 8) table for the TPU's gather)."""
    H, W = gx.shape
    f1, f2 = gx.reshape(-1), gy.reshape(-1)

    def sample(ys, xs):
        """(gx, gy) sampled at float coords; keeps the input shape. Corner
        indices clamp to y <= H-2, x <= W-2."""
        y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, H - 2)
        x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, W - 2)
        fy = torch.clamp(ys - y0, 0.0, 1.0)
        fx = torch.clamp(xs - x0, 0.0, 1.0)
        i = (y0 * W + x0).long()
        w00 = (1 - fy) * (1 - fx)
        w01 = (1 - fy) * fx
        w10 = fy * (1 - fx)
        w11 = fy * fx
        gxs = f1[i] * w00 + f1[i + 1] * w01 + f1[i + W] * w10 + f1[i + W + 1] * w11
        gys = f2[i] * w00 + f2[i + 1] * w01 + f2[i + W] * w10 + f2[i + W + 1] * w11
        return gxs, gys

    return sample


def _orientations(gx, gy, keypoints, sigmas, num_bins=42):
    """Dominant orientation per keypoint (K,) radians, SURF-style: gradient
    samples on a sigma-spaced 13x13 grid within radius 6 sigma, weighted by
    a 2.5 sigma Gaussian, binned by angle; a circular pi/3 window sums the
    response vectors and the window of largest magnitude gives the angle
    (Bay et al.; OpenCV SURF with upright=false, the reference's default).
    The binning is a one-hot product and the window a circulant product, as
    in the JAX version: fixed-order sums, no scatter."""
    dev = gx.device
    sample = _grad_sampler(gx, gy)
    r = torch.arange(-6, 7, dtype=torch.float32, device=dev)  # 13 offsets, units of sigma
    YO, XO = torch.meshgrid(r, r, indexing="ij")
    disk = (YO**2 + XO**2) <= 36.0 + 1e-6
    wgt = torch.exp(-(YO**2 + XO**2) / (2.0 * 2.5**2)) * disk  # (13, 13)

    win = max(int(round(num_bins / 6.0)), 1)  # pi/3 window in bins
    ii = torch.arange(num_bins, device=dev)
    circ = (((ii[None, :] - ii[:, None]) % num_bins) < win).to(torch.float32)

    ys = keypoints[:, 1, None, None] + YO * sigmas[:, None, None]
    xs = keypoints[:, 0, None, None] + XO * sigmas[:, None, None]
    sgx, sgy = sample(ys, xs)                       # (K, 13, 13)
    dx = (sgx * wgt).reshape(len(keypoints), -1)    # (K, 169)
    dy = (sgy * wgt).reshape(len(keypoints), -1)
    theta = torch.atan2(dy, dx)  # [-pi, pi]
    b = torch.floor((theta + math.pi) / (2.0 * math.pi) * num_bins)
    b = torch.clamp(b, 0, num_bins - 1)
    onehot = (b[..., None] == ii).to(torch.float32)  # (K, 169, B)
    hx = torch.bmm(dx[:, None, :], onehot)[:, 0]     # (K, B)
    hy = torch.bmm(dy[:, None, :], onehot)[:, 0]
    sx = hx @ circ.T
    sy = hy @ circ.T
    best = torch.argmax(sx * sx + sy * sy, dim=1, keepdim=True)
    return torch.atan2(torch.gather(sy, 1, best), torch.gather(sx, 1, best))[:, 0]


def _describe(img, keypoints, sigmas, cells=4, samples_per_cell=5, upright=False):
    """SURF-128 descriptors via bilinear gradient sampling; with orientation
    assignment unless `upright`."""
    dev = img.device
    # Central differences that wrap at the border, as jnp.roll does.
    gx = (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) * 0.5
    gy = (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0)) * 0.5

    n = cells * samples_per_cell  # 20 samples across the window
    offs = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0  # -9.5..9.5
    sample = _grad_sampler(gx, gy)
    K = keypoints.shape[0]
    if upright:
        angles = torch.zeros((K,), dtype=torch.float32, device=dev)
    else:
        angles = _orientations(gx, gy, keypoints, sigmas)

    wy = torch.exp(-0.5 * (offs / (n / 4.0)) ** 2)
    weight = wy[:, None] * wy[None, :]

    step = sigmas[:, None, None]  # sample spacing = sigma
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    # The sampling grid rotated into each keypoint's local frame.
    U = offs[None, None, :].expand(K, n, n) * step  # local x
    V = offs[None, :, None].expand(K, n, n) * step  # local y
    X = keypoints[:, 0, None, None] + ca * U - sa * V
    Y = keypoints[:, 1, None, None] + sa * U + ca * V
    dxi, dyi = sample(Y, X)
    # Gradients rotated into the local frame.
    dx = (ca * dxi + sa * dyi) * weight
    dy = (-sa * dxi + ca * dyi) * weight
    dx_c = dx.reshape(K, cells, samples_per_cell, cells, samples_per_cell)
    dy_c = dy.reshape(K, cells, samples_per_cell, cells, samples_per_cell)
    feats = []
    # SURF-128: statistics of dx split by the sign of dy, and vice versa.
    for m in (dy_c >= 0, dy_c < 0):
        m = m.to(torch.float32)
        feats.append(torch.sum(dx_c * m, dim=(2, 4)))
        feats.append(torch.sum(torch.abs(dx_c) * m, dim=(2, 4)))
    for m in (dx_c >= 0, dx_c < 0):
        m = m.to(torch.float32)
        feats.append(torch.sum(dy_c * m, dim=(2, 4)))
        feats.append(torch.sum(torch.abs(dy_c) * m, dim=(2, 4)))
    d = torch.stack(feats, dim=-1).reshape(K, -1)  # (K, 4*4*8 = 128)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)


def _gray_tensor(img_array, device):
    img = np.asarray(img_array)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return torch.as_tensor(np.asarray(img, np.float32), device=device)


def detect_image(img_array, hessian_threshold=100.0, num_octaves=4, num_octave_layers=3,
                 max_features=2048, upright=False, grid_size=3, cell_thresholds=None,
                 min_per_cell=0, device="cuda"):
    """Numpy grayscale/RGB image -> (keypoints (N, 2), descriptors (N, 128))
    as numpy, detected on `device`."""
    kp, _, desc, mask, _ = detect_and_describe(
        _gray_tensor(img_array, device), hessian_threshold=hessian_threshold,
        num_octaves=num_octaves, num_octave_layers=num_octave_layers,
        max_features=max_features, upright=upright,
        grid_size=grid_size if isinstance(grid_size, int) else tuple(grid_size),
        cell_thresholds=cell_thresholds, min_per_cell=min_per_cell)
    m = mask.cpu().numpy()
    return kp.cpu().numpy()[m], desc.cpu().numpy()[m]


class AdaptiveDetector:
    """Cross-frame adaptive per-cell thresholds, the stateful counterpart of
    the reference's AdaptiveSURF (feature.cc:198-309): each grid cell keeps
    its own Hessian threshold across frames, lowering it (/1.5) when the cell
    yields fewer than `min_per_cell` above-threshold maxima and raising it
    (*1.5) when the cell saturates its budget, clamped to
    [hessian/1.5^adapt_levels, hessian*1.5^adapt_levels]. Within a frame the
    rank-based admission of detect_and_describe already guarantees
    min_per_cell wherever the quality floor allows.

    CLI: --surf-adaptive-min-per-cell > 0 activates this wrapper (reference
    mapper.cc:707-712)."""

    def __init__(self, hessian_threshold=100.0, min_per_cell=100, num_octaves=4,
                 num_octave_layers=3, max_features=2048, grid_size=3, upright=False,
                 adapt_levels=10, device="cuda"):
        rows, cols = (grid_size, grid_size) if isinstance(grid_size, int) else grid_size
        self.grid = (rows, cols)
        self.device = torch.device(device)
        self.hessian_threshold = float(hessian_threshold)
        self.min_per_cell = int(min_per_cell)
        self.max_per_cell = max_features // (rows * cols)
        self.adapt_levels = int(adapt_levels)
        self.kw = dict(num_octaves=num_octaves, num_octave_layers=num_octave_layers,
                       max_features=max_features, grid_size=(rows, cols), upright=upright)
        self.cell_thr = np.full((rows * cols,), self.hessian_threshold, np.float32)

    def detect(self, img_array):
        """(keypoints (N, 2), descriptors (N, 128)) + threshold update."""
        kp, _, desc, mask, counts = detect_and_describe(
            _gray_tensor(img_array, self.device), hessian_threshold=self.hessian_threshold,
            cell_thresholds=self.cell_thr, min_per_cell=self.min_per_cell,
            adapt_levels=self.adapt_levels, **self.kw)
        counts = counts.cpu().numpy()
        lo = self.hessian_threshold * 1.5 ** (-self.adapt_levels)
        hi = self.hessian_threshold * 1.5 ** (self.adapt_levels)
        thr = self.cell_thr
        thr = np.where(counts < self.min_per_cell, thr / 1.5,
                       np.where(counts >= self.max_per_cell, thr * 1.5, thr))
        self.cell_thr = np.clip(thr, lo, hi).astype(np.float32)
        m = mask.cpu().numpy()
        return kp.cpu().numpy()[m], desc.cpu().numpy()[m]


def detect_image_file(path, detector=None, device="cuda", totals=None, **kwargs):
    """(keypoints, descriptors, (rows, cols)) of an image file, read with
    utils/imageio.py (Pillow's convert("L") gray); the dims ride along so
    the feature cache can answer query_dimensions without decoding again.
    `detector`: an optional stateful AdaptiveDetector (its own device).
    `totals`: the dict that takes the decode and detection spans' counters
    outside every mapper's span (none kept where it is None)."""
    sink = owner_counters(totals)
    with span("features.decode", "image_decode_s", totals=sink):
        img = read_gray(path).astype(np.float32)
    add_total(sink, "image_decodes")
    with span("features.detect", "detect_s", totals=sink):
        if detector is not None:
            kp, desc = detector.detect(img)
        else:
            kp, desc = detect_image(img, device=device, **kwargs)
    add_total(sink, "detect_frames")
    return kp, desc, img.shape
