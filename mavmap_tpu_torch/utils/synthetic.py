"""Synthetic UAV-style scenes for tests and benchmarks.

Port of mavmap_tpu/utils/synthetic.py (`make_uav_scene`, `render_features`,
`mapper_ate`, `ate_rmse`): a terrain point cloud with per-point
descriptors, a serpentine aerial camera trajectory, and projected
per-image features with pixel noise, descriptor noise, clutter and
dropout. Scenes are host data (numpy, made from a seed); the few rotation
and projection calls run in float32 PyTorch on the CPU, as the JAX version
runs them in float32 JAX, so both packages build the same scene.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..models import camera as cam
from ..ops.rotation import rotmat_from_rvec, rvec_from_rotmat
from ..ops.similarity import solve_umeyama, transform_points

_CPU = torch.device("cpu")


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
