"""The benchmark's own scenes and features, in numpy alone.

A frozen copy of the synthetic UAV survey that the port's tests use
(`make_uav_scene`, `render_features`): a terrain point cloud with unit
descriptors, a serpentine nadir flight over it, and per-image features
(projected points with pixel noise, descriptor noise, dropout and random
clutter). The draws are the same, in the same order, so a scene seed gives
the scene that the port's generator gives; rotations and projections run
here in float64 and are stored in float32 where the port stores float32.

A scene carries its cameras: each camera's model (PINHOLE or OPENCV, the
codes of the port's camera models) and parameters, and which camera took
each frame. A flight with no `cameras` has the one PINHOLE camera of its
focal length; a rig's frame i is on camera i % C, as the port's
`make_multi_camera_scene` puts it.

Nothing here imports the program: the benchmark makes its inputs and its
truth itself and hands the same features to the program and to the judge.
"""

from dataclasses import dataclass

import numpy as np

PINHOLE = 1
OPENCV = 2
MODEL_CODES = {"PINHOLE": PINHOLE, "OPENCV": OPENCV}
# fx, fy, cx, cy; OPENCV adds k1, k2, p1, p2.
MODEL_NUM_PARAMS = {PINHOLE: 4, OPENCV: 8}


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rotmat(rvecs):
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), Rodrigues in
    float64."""
    r = np.asarray(rvecs, np.float64)
    theta = np.linalg.norm(r, axis=-1)[..., None, None]
    small = theta < 1e-9
    t = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - theta ** 2 / 6.0, np.sin(t) / t)
    b = np.where(small, 0.5 - theta ** 2 / 24.0, (1.0 - np.cos(t)) / t ** 2)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([np.stack([zero, -z, y], -1), np.stack([z, zero, -x], -1),
                  np.stack([-y, x, zero], -1)], -2)
    return np.eye(3) + a * K + b * (K @ K)


def rvec(R):
    """Rotation matrix (3, 3) -> angle-axis (3,), through the quaternion
    (stable near pi, where the survey's nadir cameras sit)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    piv = np.array([1.0 + tr, 1.0 + R[0, 0] - R[1, 1] - R[2, 2],
                    1.0 - R[0, 0] + R[1, 1] - R[2, 2], 1.0 - R[0, 0] - R[1, 1] + R[2, 2]])
    k = int(np.argmax(piv))
    s = np.sqrt(max(piv[k], 0.0))
    cands = [
        [s * s, R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
        [R[2, 1] - R[1, 2], s * s, R[0, 1] + R[1, 0], R[0, 2] + R[2, 0]],
        [R[0, 2] - R[2, 0], R[0, 1] + R[1, 0], s * s, R[1, 2] + R[2, 1]],
        [R[1, 0] - R[0, 1], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], s * s],
    ]
    q = np.array(cands[k])
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    sin_half = np.linalg.norm(q[1:])
    if sin_half < 1e-12:
        return 2.0 * q[1:]
    return q[1:] * (2.0 * np.arctan2(sin_half, q[0]) / sin_half)


def camera_centers(rvecs, tvecs):
    """World-frame centres of world->camera poses: C = -R^T t."""
    R = rotmat(rvecs)
    return -np.einsum("nji,nj->ni", R, np.asarray(tvecs, np.float64))


@dataclass
class Scene:
    points3D: np.ndarray      # (M, 3) float64 terrain points
    descriptors: np.ndarray   # (M, D) float32 unit descriptors
    rvecs: np.ndarray         # (I, 3) float32 world->camera truth
    tvecs: np.ndarray         # (I, 3) float32
    cam_params: np.ndarray    # (C, 9) float32 each camera's parameters, zero-padded
    cam_models: np.ndarray    # (C,) int32 each camera's model code
    image_cameras: np.ndarray  # (I,) int32 the camera of each frame
    image_size: tuple         # (width, height)

    @property
    def num_images(self):
        return len(self.rvecs)

    def centers(self):
        return camera_centers(self.rvecs, self.tvecs)


def make_uav_scene(num_images, num_points, descriptor_dim=128, image_size=(800, 600),
                   focal=700.0, altitude=30.0, extent=60.0, overlap_step=2.5, rows=2,
                   relief=8.0, seed=0, cameras=None):
    """A serpentine nadir survey of `rows` strips over a terrain patch
    (extent=None sizes the patch to the flight plus one frustum margin).
    `cameras`: a rig's cameras, [{"model": "PINHOLE" | "OPENCV", "params":
    [...]}, ...], frame i on camera i % C; by default one PINHOLE camera
    of `focal`. The cameras draw nothing: the flight is the same either way."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    per_row = int(np.ceil(num_images / rows))
    row_step = 0.8 * altitude * (h / 2.0) / focal
    half_w = altitude * (w / 2.0) / focal
    half_h = altitude * (h / 2.0) / focal
    if extent is None:
        x_lo, x_hi = -half_w, (per_row - 1) * overlap_step + half_w
        y_lo, y_hi = -half_h, (rows - 1) * row_step + half_h
    else:
        x_lo, x_hi = -extent * 0.2, extent * 1.2
        y_lo, y_hi = -extent * 0.2, extent * 0.7
    pts = np.stack([rng.uniform(x_lo, x_hi, num_points), rng.uniform(y_lo, y_hi, num_points),
                    rng.uniform(0.0, relief, num_points)], axis=-1)
    desc = rng.normal(size=(num_points, descriptor_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    rvecs, tvecs = [], []
    for i in range(num_images):
        r, k = divmod(i, per_row)
        x = k * overlap_step if r % 2 == 0 else (per_row - 1 - k) * overlap_step
        C = np.array([x, r * row_step, altitude]) + rng.normal(size=3) * 0.3
        R = rot_z(rng.normal() * 0.05) @ rot_x(np.pi + rng.normal() * 0.05)
        rvecs.append(rvec(R))
        tvecs.append(-R @ C)
    if cameras is None:
        cameras = [{"model": "PINHOLE", "params": [focal, focal, w / 2, h / 2]}]
    params = np.zeros((len(cameras), 9), np.float32)
    models = np.zeros(len(cameras), np.int32)
    for c, camera in enumerate(cameras):
        if camera["model"] not in MODEL_CODES:
            raise ValueError(f"camera {c}: unknown model {camera['model']!r}")
        models[c] = MODEL_CODES[camera["model"]]
        if len(camera["params"]) != MODEL_NUM_PARAMS[models[c]]:
            raise ValueError(f"camera {c}: {camera['model']} takes "
                             f"{MODEL_NUM_PARAMS[models[c]]} parameters")
        params[c, :len(camera["params"])] = camera["params"]
    return Scene(points3D=pts, descriptors=desc, rvecs=np.array(rvecs, np.float32),
                 tvecs=np.array(tvecs, np.float32), cam_params=params, cam_models=models,
                 image_cameras=(np.arange(num_images) % len(cameras)).astype(np.int32),
                 image_size=image_size)


def project(points_cam, params, model=PINHOLE):
    """Projection of camera-frame points (..., 3) through a camera of code
    `model` with params (..., 9) (fx, fy, cx, cy, then OPENCV's k1, k2, p1,
    p2): pixel coordinates (..., 2), float64. OPENCV distorts the
    normalised point radially and tangentially, as the port's camera model
    does; any other code raises ValueError."""
    p = np.asarray(params, np.float64)
    X = np.asarray(points_cam, np.float64)
    z = X[..., 2]
    if model == PINHOLE:
        return np.stack([p[..., 0] * X[..., 0] / z + p[..., 2],
                         p[..., 1] * X[..., 1] / z + p[..., 3]], axis=-1)
    if model != OPENCV:
        raise ValueError(f"no projection for camera model {model!r}")
    u, v = X[..., 0] / z, X[..., 1] / z
    k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
    return np.stack([(u + du) * p[..., 0] + p[..., 2], (v + dv) * p[..., 1] + p[..., 3]],
                    axis=-1)


def render_features(scene: Scene, rng, pixel_noise=0.3, descriptor_noise=0.05, clutter=50,
                    dropout=0.05, capacity=None):
    """Every image's features -> (feats, gt_ids): per image (keypoints
    (n, 2) float32, projected through the frame's own camera; descriptors
    (n, D) float32) of the visible points with noise, `clutter`
    unmatchable rows and random dropout, shuffled, the first `capacity`
    kept; gt_ids maps each row to its 3-D point (-1: clutter). `rng` draws
    every noise term (the port's generator seeds it with
    default_rng(seed + 1))."""
    w, h = scene.image_size
    feats, gt_ids = [], []
    R_all = rotmat(scene.rvecs)
    D = scene.descriptors.shape[1]
    for i in range(scene.num_images):
        Xc = scene.points3D @ R_all[i].T + scene.tvecs[i].astype(np.float64)
        c = scene.image_cameras[i]
        uv = project(Xc, scene.cam_params[c], scene.cam_models[c]).astype(np.float32)
        vis = ((Xc[:, 2] > 1.0) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
               & (uv[:, 1] >= 0) & (uv[:, 1] < h))
        idx = np.where(vis)[0]
        if dropout:
            idx = idx[rng.random(len(idx)) > dropout]
        kp = uv[idx] + rng.normal(size=(len(idx), 2)) * pixel_noise
        de = scene.descriptors[idx] + rng.normal(
            size=(len(idx), D)).astype(np.float32) * descriptor_noise
        de /= np.maximum(np.linalg.norm(de, axis=-1, keepdims=True), 1e-12)
        ids = idx.astype(np.int64)
        if clutter:
            ckp = np.stack([rng.uniform(0, w, clutter), rng.uniform(0, h, clutter)], axis=-1)
            cde = rng.normal(size=(clutter, D)).astype(np.float32)
            cde /= np.linalg.norm(cde, axis=-1, keepdims=True)
            kp = np.concatenate([kp, ckp], axis=0)
            de = np.concatenate([de, cde], axis=0)
            ids = np.concatenate([ids, np.full(clutter, -1, np.int64)])
        perm = rng.permutation(len(kp))
        kp, de, ids = kp[perm], de[perm], ids[perm]
        if capacity is not None:
            kp, de, ids = kp[:capacity], de[:capacity], ids[:capacity]
        feats.append((kp.astype(np.float32), de.astype(np.float32)))
        gt_ids.append(ids)
    return feats, gt_ids


def noise_rng(seed, map_index):
    """The generator of one map's sensor noise: map `map_index` (-1: the
    warm-up) of the flights drawn from `seed`."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(map_index) + 1]))


def map_order(seed, maps):
    """The order in which a run with `--seed seed` maps a workload's
    `maps` flights: a permutation drawn from the seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), 0])).permutation(maps)


def mapper_seed(seed, map_index):
    """A RANSAC seed in [0, 2^31) drawn from (seed, map_index)."""
    return int(np.random.SeedSequence([int(seed), int(map_index) + 1, 7]).generate_state(1)[0]
               >> 1)
