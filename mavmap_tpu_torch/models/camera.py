"""Batched camera models: PINHOLE (code 1), OPENCV (2), CATA (3).

Port of mavmap_tpu/models/camera.py. Each model is a function over an
(..., 2)/(..., 3) batch of points; the model code is a Python int chosen on
the host (the JAX version also accepts a traced code under `lax.switch`,
which eager PyTorch does not need).

Parameter vectors are fixed-width (MAX_CAM_PARAMS = 9), zero-padded, with
ordering matching the reference exactly:

- PINHOLE: fx, fy, cx, cy                      (camera_models.h:104-147)
- OPENCV:  fx, fy, cx, cy, k1, k2, p1, p2      (camera_models.h:163-244)
- CATA:    fx, fy, cx, cy, k1, k2, p1, p2, xi  (camera_models.h:270-359)

`image2world` returns points on the normalized plane (z=1) for PINHOLE and
OPENCV and on the unit-sphere lift for CATA. The iterative undistortion is
a fixed 10-iteration loop, like the reference's fixed-point scheme; all
functions are differentiable with torch.func.
"""

import numpy as np
import torch

from ..utils.device import resolve_device

PINHOLE = 1
OPENCV = 2
CATA = 3

MAX_CAM_PARAMS = 9

CAMERA_MODEL_CODES = {"PINHOLE": PINHOLE, "OPENCV": OPENCV, "CATA": CATA}
CAMERA_MODEL_NAMES = {v: k for k, v in CAMERA_MODEL_CODES.items()}
CAMERA_MODEL_NUM_PARAMS = {PINHOLE: 4, OPENCV: 8, CATA: 9}


def camera_model_code(name: str) -> int:
    """Model name (or numeric code string) -> integer code (reference
    camera_models.cc:12-21). Numeric codes are accepted so imagedataout.txt,
    which stores codes like the reference's writer, reads back."""
    name = name.strip()
    if name.lstrip("+-").isdigit():
        code = int(name)
        if code not in CAMERA_MODEL_NAMES:
            raise KeyError(f"unknown camera model code {code}")
        return code
    return CAMERA_MODEL_CODES[name.upper()]


def camera_model_name(code: int) -> str:
    return CAMERA_MODEL_NAMES[int(code)]


def pad_params(params, dtype=torch.float32, device="cuda"):
    """Pad a parameter list/array to MAX_CAM_PARAMS with zeros, as a tensor
    on `device` (the CUDA card unless another is named)."""
    device = resolve_device(device, "pad_params")
    params = torch.as_tensor(np.asarray(params), dtype=dtype, device=device)
    p = torch.zeros((MAX_CAM_PARAMS,), dtype=dtype, device=device)
    p[: params.shape[0]] = params
    return p


def _distortion(uv, params):
    """Radial (k1,k2) + tangential (p1,p2) distortion delta for normalized uv.

    Shared by OPENCV and CATA (reference camera_models.h:222-243, 341-358).
    uv: (..., 2) -> (..., 2).
    """
    k1, k2, p1, p2 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    u, v = uv[..., 0], uv[..., 1]
    u2 = u * u
    v2 = v * v
    uvp = u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return torch.stack([du, dv], dim=-1)


def _undistort(uv, params, num_iterations=10):
    """Fixed-point inverse of `_distortion` (reference camera_models.h:205-218)."""
    xx = uv
    for _ in range(num_iterations):
        xx = uv - _distortion(xx, params)
    return xx


def _to_pixels(uv, params):
    return uv * params[..., :2] + params[..., 2:4]


def _from_pixels(uv_px, params):
    return (uv_px - params[..., 2:4]) / params[..., :2]


def _safe(d, eps):
    return torch.where(d.abs() < eps, torch.full_like(d, eps), d)


# --- per-model world2image: points (..., 3) camera-frame -> (..., 2) pixels ---


def _pinhole_world2image(points, params, eps):
    uv = points[..., :2] / _safe(points[..., 2:3], eps)
    return _to_pixels(uv, params)


def _opencv_world2image(points, params, eps):
    uv = points[..., :2] / _safe(points[..., 2:3], eps)
    uv = uv + _distortion(uv, params)
    return _to_pixels(uv, params)


def _cata_world2image(points, params, eps):
    xi = params[..., 8:9]
    norm = torch.linalg.norm(points, dim=-1, keepdim=True)
    zz = points[..., 2:3] + xi * norm
    uv = points[..., :2] / _safe(zz, eps)
    uv = uv + _distortion(uv, params)
    return _to_pixels(uv, params)


# --- per-model image2world: pixels (..., 2) -> (..., 3) ray points ---


def _pinhole_image2world(uv_px, params):
    uv = _from_pixels(uv_px, params)
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _opencv_image2world(uv_px, params):
    uv = _undistort(_from_pixels(uv_px, params), params)
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _cata_image2world(uv_px, params):
    xi = params[..., 8:9]
    uv = _undistort(_from_pixels(uv_px, params), params)
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    # Sphere lift (reference camera_models.h:330-338), branch-free with the
    # xi == 1 limit guarded like the JAX version.
    denom = xi + torch.sqrt(torch.clamp(1.0 + (1.0 - xi * xi) * r2, min=0.0))
    tiny = denom.abs() < 1e-12
    z = torch.where(
        tiny,
        (1.0 - r2) / 2.0,
        1.0 - xi * (r2 + 1.0) / torch.where(tiny, torch.ones_like(denom), denom),
    )
    return torch.cat([uv, z], dim=-1)


_WORLD2IMAGE = {
    PINHOLE: _pinhole_world2image,
    OPENCV: _opencv_world2image,
    CATA: _cata_world2image,
}
_IMAGE2WORLD = {
    PINHOLE: _pinhole_image2world,
    OPENCV: _opencv_image2world,
    CATA: _cata_image2world,
}


def world2image(points, model_code, params, eps=1e-12):
    """Camera-frame points -> pixel coords under the given model.

    points: (..., N, 3); model_code: int; params: (MAX_CAM_PARAMS,), or
    with leading dims that broadcast against the points' ((B, 1, 9) for
    (B, N, 3): one camera per slot). Returns (..., N, 2).
    """
    return _WORLD2IMAGE[int(model_code)](points, params, eps)


def image2world(uv_px, model_code, params):
    """Pixel coords -> ray points in the camera frame (z=1 plane or sphere
    lift). uv_px: (..., 2); params: (MAX_CAM_PARAMS,). Returns (..., 3)."""
    return _IMAGE2WORLD[int(model_code)](uv_px, params)


def image2normalized(uv_px, model_code, params, eps=1e-12):
    """Pixel coords -> normalized plane coords (x/z, y/z)."""
    xyz = image2world(uv_px, model_code, params)
    return xyz[..., :2] / _safe(xyz[..., 2:3], eps)


def image2normalized_np(uv_px, model_code, params, eps=1e-12):
    """Host (numpy) mirror of `image2normalized` for per-frame bookkeeping.

    A zero focal length (an unused, zero-padded camera row) is guarded to 1
    instead of dividing by zero; the JAX version returns inf/nan there.
    """
    uv_px = np.asarray(uv_px, np.float32)
    params = np.asarray(params, np.float32)
    f, c = params[:2], params[2:4]
    f = np.where(f == 0, np.float32(1.0), f)
    uv = (uv_px - c) / f
    model_code = int(model_code)
    if model_code == PINHOLE:
        return uv

    def distortion(xx):
        k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
        u, v = xx[..., 0], xx[..., 1]
        r2 = u * u + v * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        dv = v * radial + 2.0 * p2 * u * v + p1 * (r2 + 2.0 * v * v)
        return np.stack([du, dv], axis=-1)

    xx = uv.copy()
    for _ in range(10):
        xx = uv - distortion(xx)
    uv = xx
    if model_code == OPENCV:
        return uv
    # CATA: sphere lift then projective division.
    xi = params[8]
    r2 = np.sum(uv * uv, axis=-1, keepdims=True)
    denom = xi + np.sqrt(np.maximum(1.0 + (1.0 - xi * xi) * r2, 0.0))
    z = np.where(
        np.abs(denom) < 1e-12,
        (1.0 - r2) / 2.0,
        1.0 - xi * (r2 + 1.0) / np.where(np.abs(denom) < 1e-12, 1.0, denom),
    )
    safe_z = np.where(np.abs(z) < eps, eps, z)
    return uv / safe_z


def normalize_threshold(threshold, params):
    """Pixel threshold -> normalized-coordinate threshold: t / mean(fx, fy).

    Reference: camera_models.cc:47-52.
    """
    return threshold / ((params[0] + params[1]) / 2.0)
