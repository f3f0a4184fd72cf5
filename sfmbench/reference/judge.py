"""The plain reference that decides `correct`: float64 numpy over the
benchmark's own truth and observations.

The program's outputs are read only to be judged: per map, the registered
frames, their world->camera poses, the 3-D points, each frame's camera
model and refined intrinsics, and which feature row of which frame each
point was built from (a `MapState`, host arrays copied out of the program
after the window).
The truth (the scene's poses) and the observations (the keypoints the
benchmark generated and handed to the program) are the benchmark's own.

Numbers per map:
- missing frames: frames offered that are not in the map's main model;
- ATE: RMSE of the registered camera centres against the truth after one
  similarity (Umeyama) fit, the centres' translation, rotation and scale
  solved in float64;
- reprojection RMSE: every observation of a triangulated point in the map,
  projected with the map's pose, point and refined intrinsics through the
  frame's camera model and compared with the benchmark's own keypoint of
  that feature row.
"""

from dataclasses import dataclass

import numpy as np

from .scene import PINHOLE, camera_centers, project, rotmat


@dataclass
class MapState:
    """One map as the program left it (host copies)."""

    frames: np.ndarray        # (R,) image indices registered in the main model
    rvecs: np.ndarray         # (R, 3) their world->camera rotations
    tvecs: np.ndarray         # (R, 3) and translations
    cam_params: np.ndarray    # (R, 9) each frame's refined camera parameters
    obs_frame: np.ndarray     # (O,) image index of each observation
    obs_row: np.ndarray       # (O,) its feature row in that image
    obs_point: np.ndarray     # (O,) its point's row in `points`
    points: np.ndarray        # (P, 3) the triangulated 3-D points
    maps: int                 # models the run ended with (sub-maps not merged)
    closures: int             # loop and sweep closures committed
    cam_models: np.ndarray = None  # (R,) each frame's camera model code; all PINHOLE if None

    def __post_init__(self):
        if self.cam_models is None:
            self.cam_models = np.full(len(self.frames), PINHOLE, np.int32)


def umeyama(src, dst):
    """s, R, t minimising |dst - (s R src + t)|^2 (Umeyama 1991), float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cs, cd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(cd.T @ cs / len(src))
    sgn = np.ones(3)
    sgn[2] = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    R = (U * sgn) @ Vt
    s = float((D * sgn).sum() / max(np.mean((cs * cs).sum(1)), 1e-300))
    return s, R, mu_d - s * R @ mu_s


def aligned_errors(est_centers, true_centers):
    """Per-frame centre errors (m) after one similarity fit."""
    s, R, t = umeyama(est_centers, true_centers)
    aligned = s * np.asarray(est_centers, np.float64) @ R.T + t
    return np.linalg.norm(aligned - true_centers, axis=1)


def reprojection_errors(state: MapState, keypoints):
    """Pixel error of every observation of the map: the map's point through
    its frame's pose, camera model and refined intrinsics, against the
    keypoint the benchmark generated for that feature row. keypoints: per
    image (n, 2) arrays, as handed to the program."""
    if len(state.obs_frame) == 0:
        return np.zeros(0)
    slot = np.full(max(int(state.frames.max()) + 1, 1), -1, np.int64)
    slot[state.frames] = np.arange(len(state.frames))
    s = slot[state.obs_frame]
    if (s < 0).any():
        raise ValueError("an observation lies in a frame that is not registered")
    R = rotmat(state.rvecs)[s]
    Xc = np.einsum("oij,oj->oi", R, state.points[state.obs_point]) + state.tvecs[s]
    p = np.asarray(state.cam_params, np.float64)[s]
    z = Xc[:, 2]
    model = np.asarray(state.cam_models)[s]
    uv = np.empty((len(s), 2))
    for code in np.unique(model):
        rows = model == code
        uv[rows] = project(Xc[rows], p[rows], code)
    sizes = np.array([len(k) for k in keypoints])
    if (state.obs_row >= sizes[state.obs_frame]).any():
        raise ValueError("an observation lies on a feature row the frame does not have")
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    kp = np.concatenate(keypoints).astype(np.float64)[start[state.obs_frame] + state.obs_row]
    err = np.linalg.norm(uv - kp, axis=1)
    return np.where(z > 0, err, np.inf)


def judge_map(state: MapState, scene, keypoints, offered):
    """The numbers of one map: missing frames, squared centre errors and
    squared reprojection errors (for pooling), and the map's own ATE and
    reprojection RMSE."""
    missing = len(set(range(offered)) - set(int(f) for f in state.frames))
    if len(state.frames) >= 3:
        est = camera_centers(state.rvecs, state.tvecs)
        err = aligned_errors(est, scene.centers()[state.frames])
    else:
        err = np.full(max(len(state.frames), 1), np.inf)
    rep = reprojection_errors(state, keypoints)
    return dict(missing=missing, center_err2=err ** 2, reproj_err2=rep ** 2,
                ate_m=float(np.sqrt(np.mean(err ** 2))),
                reproj_rmse_px=float(np.sqrt(np.mean(rep ** 2))) if len(rep) else float("inf"),
                maps=state.maps, closures=state.closures)


def to_bfloat16(a):
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float64: the 8 significant bits a bfloat16 keeps."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def bfloat16_state(state: MapState):
    """The control: the map as the program hands it over, its poses,
    points and intrinsics held in bfloat16, the precision below the
    configurations' float32 (the camera models as they are)."""
    from dataclasses import replace

    return replace(state, rvecs=to_bfloat16(state.rvecs), tvecs=to_bfloat16(state.tvecs),
                   cam_params=to_bfloat16(state.cam_params), points=to_bfloat16(state.points))


def pooled_ate(judged):
    """RMSE of the centre errors of every registered frame of every map."""
    e2 = np.concatenate([j["center_err2"] for j in judged])
    return float(np.sqrt(np.mean(e2)))
