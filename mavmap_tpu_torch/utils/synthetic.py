"""Synthetic UAV-style scenes for tests and benchmarks.

Port of mavmap_tpu/utils/synthetic.py (`make_uav_scene`,
`make_multi_camera_scene`, `imu_priors`, `render_features`, `render_images`,
`sample_photo_paths`, `render_photo_survey`, `mapper_ate`,
`mapper_ate_profile`, `ate_rmse`): a terrain point cloud with per-point
descriptors, a serpentine aerial camera trajectory, projected per-image
features with pixel noise, descriptor noise, clutter and dropout, and
rendered grayscale images of the ground for the detector: a blob texture
with painted splats (`render_images`), or a collage of real photographs
draped on a height field (`render_photo_survey`, on a chosen device).
Scenes are host data (numpy, made from a seed); the few rotation and
projection calls run in float32 PyTorch on the CPU, as the JAX version
runs them in float32 JAX, so both packages build the same scene.

The photographs' gray pixels are committed under mavmap_tpu_torch/data/
photos/ (`load_sample_photos`; licences in NOTICE.txt there), so a machine
without Pillow or the packages that ship them renders the same survey.
"""

import glob
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..models import camera as cam
from ..ops.rotation import rotmat_from_rvec, rvec_from_rotmat
from ..ops.similarity import solve_umeyama, transform_points
from .imageio import read_gray

_CPU = torch.device("cpu")
PHOTO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "data", "photos")
# The committed photographs in sample_photo_paths()'s order where both
# packages that ship them are installed (matplotlib's path sorts before
# scikit-learn's); the collage, and so every rendered pixel, depends on it.
SAMPLE_PHOTOS = ("grace_hopper", "china", "flower")


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32), device=_CPU)


def _rotmats(rvecs):
    return rotmat_from_rvec(_f32(rvecs)).numpy()


@dataclass
class SyntheticScene:
    points3D: np.ndarray          # (M, 3) terrain points
    descriptors: np.ndarray       # (M, D) unit-norm per-point descriptors
    rvecs: np.ndarray             # (I, 3) world->cam ground truth
    tvecs: np.ndarray             # (I, 3)
    cam_params: np.ndarray        # (C, 9)
    cam_models: np.ndarray        # (C,)
    image_cameras: np.ndarray     # (I,)
    image_size: tuple             # (width, height)

    def camera_centers(self):
        R = _rotmats(self.rvecs)
        return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), self.tvecs)


def make_uav_scene(num_images=20, num_points=2000, descriptor_dim=128,
                   image_size=(800, 600), focal=700.0, altitude=30.0, extent=60.0,
                   overlap_step=2.5, rows=2, relief=8.0, cam_model=cam.PINHOLE,
                   distortion=None, seed=0):
    """Serpentine aerial survey over a terrain patch (extent=None sizes the
    point field to the flight plan plus one frustum margin)."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    per_row = int(np.ceil(num_images / rows))
    row_step = 0.8 * altitude * (image_size[1] / 2.0) / focal
    half_w = altitude * (w / 2.0) / focal
    half_h = altitude * (h / 2.0) / focal
    if extent is None:
        x_lo, x_hi = -half_w, (per_row - 1) * overlap_step + half_w
        y_lo, y_hi = -half_h, (rows - 1) * row_step + half_h
    else:
        x_lo, x_hi = -extent * 0.2, extent * 1.2
        y_lo, y_hi = -extent * 0.2, extent * 0.7

    pts = np.stack([rng.uniform(x_lo, x_hi, num_points),
                    rng.uniform(y_lo, y_hi, num_points),
                    rng.uniform(0.0, relief, num_points)], axis=-1)
    desc = rng.normal(size=(num_points, descriptor_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    rvecs, tvecs = [], []
    for i in range(num_images):
        r, k = divmod(i, per_row)
        x = k * overlap_step if r % 2 == 0 else (per_row - 1 - k) * overlap_step
        C = np.array([x, r * row_step, altitude]) + rng.normal(size=3) * 0.3
        # Nadir-looking camera with small attitude perturbations.
        R = _rot_z(rng.normal() * 0.05) @ _rot_x(np.pi + rng.normal() * 0.05)
        rvecs.append(rvec_from_rotmat(_f32(R)).numpy())
        tvecs.append(-R @ C)

    params = np.zeros((1, 9), np.float32)
    params[0, :4] = [focal, focal, w / 2, h / 2]
    if distortion is not None:
        params[0, 4: 4 + len(distortion)] = distortion
        cam_model = cam.OPENCV
    return SyntheticScene(
        points3D=pts, descriptors=desc,
        rvecs=np.array(rvecs, np.float32), tvecs=np.array(tvecs, np.float32),
        cam_params=params, cam_models=np.array([cam_model], np.int32),
        image_cameras=np.zeros(num_images, np.int32), image_size=image_size)


def make_multi_camera_scene(num_images=12, seed=0, **kwargs):
    """Mixed CAM_IDX sequence (the multi-camera rig with an OPENCV model):
    odd frames use a second, distorted camera with other intrinsics."""
    scene = make_uav_scene(num_images=num_images, seed=seed, **kwargs)
    w, h = scene.image_size
    cam2 = np.zeros((1, 9), np.float32)
    cam2[0, :8] = [620.0, 620.0, w / 2 + 6, h / 2 - 4, -0.15, 0.03, 0.0005, -0.0005]
    scene.cam_params = np.concatenate([scene.cam_params, cam2], axis=0)
    scene.cam_models = np.append(scene.cam_models, np.int32(cam.OPENCV))
    scene.image_cameras = (np.arange(num_images) % 2).astype(np.int32)
    return scene


def imu_priors(scene: SyntheticScene, noise=0.01, seed=0):
    """Per-image IMU rotation priors: ground-truth rvecs plus noise (the
    roll/pitch/yaw of imagedata.txt)."""
    rng = np.random.default_rng(seed + 7)
    return {i: scene.rvecs[i] + rng.normal(size=3).astype(np.float32) * noise
            for i in range(len(scene.rvecs))}


def render_features(scene: SyntheticScene, pixel_noise=0.3, descriptor_noise=0.05,
                    clutter=50, dropout=0.05, max_features=None, seed=0):
    """Project the scene into every image -> (feats_list, gt_point_ids_list):
    per image (keypoints, descriptors) of the visible points with noise,
    `clutter` random non-matchable features and random dropout; gt ids map
    each row to its source 3-D point (-1 for clutter)."""
    rng = np.random.default_rng(seed + 1)
    w, h = scene.image_size
    feats, gt_ids = [], []
    for i in range(len(scene.rvecs)):
        R = _rotmats(scene.rvecs[i])
        Xc = scene.points3D @ R.T + scene.tvecs[i]
        ci = scene.image_cameras[i]
        uv = cam.world2image(_f32(Xc), int(scene.cam_models[ci]),
                             _f32(scene.cam_params[ci])).numpy()
        vis = ((Xc[:, 2] > 1.0) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
               & (uv[:, 1] >= 0) & (uv[:, 1] < h))
        idx = np.where(vis)[0]
        if dropout:
            idx = idx[rng.random(len(idx)) > dropout]
        kp = uv[idx] + rng.normal(size=(len(idx), 2)) * pixel_noise
        de = scene.descriptors[idx] + rng.normal(
            size=(len(idx), scene.descriptors.shape[1])).astype(np.float32) * descriptor_noise
        de /= np.maximum(np.linalg.norm(de, axis=-1, keepdims=True), 1e-12)
        ids = idx.astype(np.int64)
        if clutter:
            ckp = np.stack([rng.uniform(0, w, clutter), rng.uniform(0, h, clutter)], axis=-1)
            cde = rng.normal(size=(clutter, scene.descriptors.shape[1])).astype(np.float32)
            cde /= np.linalg.norm(cde, axis=-1, keepdims=True)
            kp = np.concatenate([kp, ckp], axis=0)
            de = np.concatenate([de, cde], axis=0)
            ids = np.concatenate([ids, np.full(clutter, -1, np.int64)])
        perm = rng.permutation(len(kp))
        kp, de, ids = kp[perm], de[perm], ids[perm]
        if max_features is not None and len(kp) > max_features:
            kp, de, ids = kp[:max_features], de[:max_features], ids[:max_features]
        feats.append((kp.astype(np.float32), de))
        gt_ids.append(ids)
    return feats, gt_ids


def mapper_ate(mapper, scene):
    """ATE RMSE of a mapper's registered camera centers vs the scene's
    ground truth, after similarity alignment."""
    reg_ids = [iid for iid in range(mapper.store.num_images)
               if mapper.store.image_registered[iid]]
    if len(reg_ids) < 3:
        return np.inf
    idxs = [mapper.image_id_to_idx[iid] for iid in reg_ids]
    R = _rotmats(mapper.store.image_rvecs[reg_ids])
    est = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1),
                     mapper.store.image_tvecs[reg_ids])
    return ate_rmse(est, scene.camera_centers()[idxs])


def mapper_ate_profile(mapper, scene, block=100):
    """Per-block ATE profile: one similarity alignment over every registered
    frame, then the RMSE of each contiguous `block` of image indices under
    it — where along the survey the error accumulates (uniform: noise;
    ramping: drift the loop closures did not remove). Returns
    [(start_idx, n_frames, rmse_m)]."""
    reg_ids = [iid for iid in range(mapper.store.num_images)
               if mapper.store.image_registered[iid]]
    if len(reg_ids) < 3:
        return []
    idxs = np.array([mapper.image_id_to_idx[iid] for iid in reg_ids])
    R = _rotmats(mapper.store.image_rvecs[reg_ids])
    est = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), mapper.store.image_tvecs[reg_ids])
    gt = scene.camera_centers()[idxs]
    T = solve_umeyama(_f32(est), _f32(gt))
    aligned = transform_points(T, _f32(est)).numpy()
    err2 = np.sum((aligned - gt) ** 2, axis=-1)
    out = []
    for s in range(0, int(idxs.max()) + 1, block):
        sel = (idxs >= s) & (idxs < s + block)
        if sel.sum():
            out.append((s, int(sel.sum()), float(np.sqrt(err2[sel].mean()))))
    return out


def ate_rmse(est_centers, gt_centers, mask=None):
    """Absolute trajectory error after similarity alignment (Umeyama)."""
    if mask is not None:
        est_centers = est_centers[mask]
        gt_centers = gt_centers[mask]
    if len(est_centers) < 3:
        return np.inf
    T = solve_umeyama(_f32(est_centers), _f32(gt_centers))
    aligned = transform_points(T, _f32(est_centers)).numpy()
    return float(np.sqrt(np.mean(np.sum((aligned - gt_centers) ** 2, axis=-1))))


def render_images(scene: SyntheticScene, texture_size=2048, texture_contrast=1.0, seed=0):
    """Grayscale images of a textured flat ground plane (z = 0) for every
    camera: the detector's test source, numpy apart from the float32
    rotations. The texture is smoothed random noise; each pixel is
    inverse-warped to the plane and bilinearly sampled; the scene's 3-D
    points are painted on top as Gaussian splats of consistent appearance
    at their true projections, so the imaged structure is not planar (a
    planar scene trips the homography gate, as in the reference). Returns a
    list of (H, W) uint8 arrays."""
    rng = np.random.default_rng(seed + 3)
    w, h = scene.image_size

    # Smooth random texture: separable box smoothing, nearest upsample, a
    # second smoothing.
    base = rng.normal(size=(texture_size // 8, texture_size // 8))
    k = np.ones(5) / 5.0
    for axis in (0, 1):
        base = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, base)
    tex = np.kron(base, np.ones((8, 8)))
    for axis in (0, 1):
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, np.ones(9) / 9.0, mode="same"), axis, tex)
    tex -= tex.min()
    tex = (tex / max(tex.max(), 1e-9) * 255.0).astype(np.float32)
    # Low contrast keeps the planar ground texture below the detector's
    # threshold relative to the off-plane point splats.
    tex = 127.5 + (tex - 127.5) * texture_contrast

    # The texture covers the flight plan's ground footprint with a margin.
    C = scene.camera_centers()
    half = 1.2 * np.max(C[:, 2]) * max(w, h) / 2.0 / float(scene.cam_params[0][0])
    x0, x1 = C[:, 0].min() - half, C[:, 0].max() + half
    y0, y1 = C[:, 1].min() - half, C[:, 1].max() + half

    def sample(gx, gy):
        u = (gx - x0) / (x1 - x0) * (tex.shape[1] - 2)
        v = (gy - y0) / (y1 - y0) * (tex.shape[0] - 2)
        u = np.clip(u, 0, tex.shape[1] - 2)
        v = np.clip(v, 0, tex.shape[0] - 2)
        ui, vi = u.astype(int), v.astype(int)
        fu, fv = u - ui, v - vi
        return (tex[vi, ui] * (1 - fu) * (1 - fv) + tex[vi, ui + 1] * fu * (1 - fv)
                + tex[vi + 1, ui] * (1 - fu) * fv + tex[vi + 1, ui + 1] * fu * fv)

    fx, fy, cx, cy = (float(v) for v in scene.cam_params[0][:4])
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)

    # Per-point splat appearance (the same in every view): 3 offset lobes
    # per point make each splat locally distinctive for the ratio test.
    n_pts = len(scene.points3D)
    n_lobes = 3
    splat_amp = rng.uniform(50, 110, (n_pts, n_lobes)) * rng.choice([-1, 1], (n_pts, n_lobes))
    splat_sig = rng.uniform(1.2, 2.6, (n_pts, n_lobes))
    splat_off = rng.uniform(-4.0, 4.0, (n_pts, n_lobes, 2))
    splat_off[:, 0] = 0.0  # first lobe centered (the keypoint stays on the point)

    images = []
    yy, xx = np.mgrid[-7:8, -7:8]
    for i in range(len(scene.rvecs)):
        R = _rotmats(scene.rvecs[i])
        Ci = -R.T @ scene.tvecs[i]
        d = rays @ R  # world-frame ray directions (R^T applied row by row)
        tplane = -Ci[2] / d[..., 2]
        img = sample(Ci[0] + tplane * d[..., 0], Ci[1] + tplane * d[..., 1])

        # Off-plane 3-D points as Gaussian splats.
        Xc = scene.points3D @ R.T + scene.tvecs[i]
        vis = Xc[:, 2] > 1.0
        u = fx * Xc[:, 0] / np.maximum(Xc[:, 2], 1e-6) + cx
        v = fy * Xc[:, 1] / np.maximum(Xc[:, 2], 1e-6) + cy
        vis &= (u >= 8) & (u < w - 8) & (v >= 8) & (v < h - 8)
        for pid in np.where(vis)[0]:
            ui, vi = int(round(u[pid])), int(round(v[pid]))
            for l in range(n_lobes):
                du = u[pid] + splat_off[pid, l, 0]
                dv = v[pid] + splat_off[pid, l, 1]
                g = splat_amp[pid, l] * np.exp(
                    -((xx + ui - du) ** 2 + (yy + vi - dv) ** 2) / (2 * splat_sig[pid, l] ** 2))
                img[vi - 7: vi + 8, ui - 7: ui + 8] += g
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def sample_photo_paths():
    """Real photographs bundled with installed packages (no download):
    scikit-learn's china/flower and matplotlib's grace_hopper, sorted by
    path; [] where neither package is installed."""
    cands = []
    try:
        import sklearn

        root = os.path.dirname(sklearn.__file__)
        cands += glob.glob(os.path.join(root, "datasets", "images", "*.jpg"))
    except Exception:
        pass
    try:
        import matplotlib

        root = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data")
        cands += glob.glob(os.path.join(root, "grace_hopper.jpg"))
    except Exception:
        pass
    return sorted(p for p in cands if os.path.getsize(p) > 30_000)


def load_sample_photos(device=_CPU):
    """The committed gray pixels of sample_photo_paths()'s photographs
    (data/photos/<name>.png: Pillow's convert("L") of each JPEG), read
    without Pillow, in SAMPLE_PHOTOS order: a list of (H, W) float32
    tensors on `device`."""
    return [torch.as_tensor(read_gray(os.path.join(PHOTO_DIR, f"{n}.png")),
                            device=device).float() for n in SAMPLE_PHOTOS]


def render_photo_survey(scene: SyntheticScene, relief_amp=4.0, seed=0, *, photos=None,
                        device="cuda"):
    """Render the survey over real photographic terrain texture, on `device`.

    The ground is a mirror-tiled collage of real photographs draped over a
    smooth height field: every feature the detector finds is real image
    content, and the relief's parallax keeps the scene off the homography
    gate. Each pixel's ray meets the terrain after 4 fixed-point steps from
    the flat ground (relief << altitude). `photos`: a list of (H, W) gray
    arrays or tensors (load_sample_photos()), or None to read
    sample_photo_paths() with Pillow, as the JAX version does; RuntimeError
    where that finds none. `seed` is unused, as there. Returns a list of
    (H, W) uint8 numpy images; the poses are the scene's ground truth.

    The arithmetic is the JAX version's numpy arithmetic: the geometry in
    float32 and the bilinear weights, and so the texture value, in float64
    (numpy promotes u - int(u) to float64). Scalars enter as 0-d tensors on
    the device, so no division by one turns into a product with its
    reciprocal. Where sin/cos or the rays @ R product round differently
    (numpy against PyTorch, CPU against GPU), the truncation to uint8 turns
    the ulps into single gray levels on a few pixels."""
    dev = torch.device(device)
    if photos is None:
        paths = sample_photo_paths()
        if not paths:
            raise RuntimeError("no bundled sample photographs found")
        from PIL import Image

        photos = [np.asarray(Image.open(p).convert("L"), np.float32) for p in paths]
    if not len(photos):
        raise RuntimeError("render_photo_survey: no photographs given")
    photos = [torch.as_tensor(p).to(dev, torch.float32) for p in photos]
    # Equal-height collage strip, then mirror-tile it into 6 rows.
    hmin = min(p.shape[0] for p in photos)
    strip = torch.cat([p[:hmin] for p in photos] + [p[:hmin].flip(1) for p in photos], 1)
    tex = torch.cat([strip if k % 2 == 0 else strip.flip(0) for k in range(6)], 0)
    th, tw = tex.shape
    flat = tex.reshape(-1)

    w, h = scene.image_size
    C = scene.camera_centers()
    half = 1.2 * np.max(C[:, 2]) * max(w, h) / 2.0 / float(scene.cam_params[0][0])
    x0, x1 = C[:, 0].min() - half, C[:, 0].max() + half
    y0, y1 = C[:, 1].min() - half, C[:, 1].max() + half

    def s32(v):
        return torch.tensor(np.float32(v), device=dev)

    X0, Y0, XS, YS = s32(x0), s32(y0), s32(x1 - x0), s32(y1 - y0)

    def height(gx, gy):
        return relief_amp * (torch.sin(0.37 * gx) * torch.cos(0.41 * gy)
                             + 0.6 * torch.sin(0.73 * gx + 1.3) * torch.sin(0.53 * gy + 0.7))

    def sample(gx, gy):
        u = torch.clamp((gx - X0) / XS * (tw - 2), 0, tw - 2)
        v = torch.clamp((gy - Y0) / YS * (th - 2), 0, th - 2)
        ui, vi = u.long(), v.long()
        fu, fv = u.double() - ui, v.double() - vi
        at = vi * tw + ui
        val = (flat[at] * (1 - fu) * (1 - fv) + flat[at + 1] * fu * (1 - fv)
               + flat[at + tw] * (1 - fu) * fv + flat[at + tw + 1] * fu * fv)
        # Slow world-anchored brightness modulation breaks the tiling
        # periodicity (mirror-tiled repeats would die in the ratio test).
        return val * (0.82 + 0.18 * torch.sin(0.11 * gx + 0.07 * gy))

    fx, fy, cx, cy = (float(v) for v in scene.cam_params[0][:4])
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays = torch.as_tensor(np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1),
                           device=dev)
    tiny = s32(1e-6)

    images = []
    for i in range(len(scene.rvecs)):
        R = _rotmats(scene.rvecs[i])
        Ci = -R.T @ scene.tvecs[i]
        d = rays @ torch.as_tensor(R, device=dev)
        dz = torch.where(d[..., 2].abs() < tiny, tiny, d[..., 2])
        cx_, cy_, cz = s32(Ci[0]), s32(Ci[1]), s32(Ci[2])
        t = -cz / dz  # flat-ground start
        for _ in range(4):  # fixed point on the height field
            gx = cx_ + t * d[..., 0]
            gy = cy_ + t * d[..., 1]
            t = (height(gx, gy) - cz) / dz
        gx = cx_ + t * d[..., 0]
        gy = cy_ + t * d[..., 1]
        images.append(torch.clamp(sample(gx, gy), 0, 255).to(torch.uint8).cpu().numpy())
    return images
