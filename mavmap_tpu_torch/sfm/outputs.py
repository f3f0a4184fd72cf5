"""Output writers: imagedataout.txt, point cloud text, PLY, VRML.

Port of mavmap_tpu/sfm/outputs.py (reference sequential_mapper.cc:1485-1955:
write_image_data, write_point_cloud_data, write_*_vrml, write_tracks), with
the same formats and names. Host code: the poses' rotations run in float32
on the CPU, as the JAX version runs them; point colors read the imagery
through `image_reader`, which the CLI backs with utils/imageio.py.
`write_tracks` draws with Pillow and raises where Pillow is missing.
"""

import os

import numpy as np
import torch

from ..models import camera as cam
from ..ops.rotation import euler_from_rotmat, rotmat_from_rvec


def _rotmat(rvec):
    return rotmat_from_rvec(torch.as_tensor(np.asarray(rvec, np.float32))).numpy()


def _world_poses(mapper, image_idxs=None):
    """(idx, image id, euler rx/ry/rz, camera center) per registered image."""
    out = []
    ids = sorted((mapper.image_id_to_idx[iid], iid) for iid in range(mapper.store.num_images)
                 if mapper.store.image_registered[iid])
    for idx, iid in ids:
        if image_idxs is not None and idx not in image_idxs:
            continue
        R = _rotmat(mapper.store.image_rvecs[iid])
        C = -R.T @ mapper.store.image_tvecs[iid]
        rx, ry, rz = (float(v) for v in euler_from_rotmat(torch.as_tensor(R.T.copy())))
        out.append((idx, iid, (rx, ry, rz), C))
    return out


def write_image_data(mapper, records, path):
    """imagedataout.txt with estimated world poses (reference
    sequential_mapper.cc:1485-1540)."""
    with open(path, "w") as f:
        f.write("# BASENAME, ROLL, PITCH, YAW, LAT, LON, ALT, LOCAL_HEIGHT, "
                "TX, TY, TZ, CAM_IDX, CAM_MODEL, CAM_PARAMS[]\n")
        for idx, iid, (rx, ry, rz), C in _world_poses(mapper):
            rec = records[idx]
            n_params = cam.CAMERA_MODEL_NUM_PARAMS[rec.camera_model]
            params = ", ".join(f"{p:.12g}" for p in rec.camera_params[:n_params])
            f.write(f"{rec.name}, {rx:.12g}, {ry:.12g}, {rz:.12g}, "
                    f"{rec.lat:.12g}, {rec.lon:.12g}, {rec.alt:.12g}, "
                    f"{rec.local_height:.12g}, "
                    f"{C[0]:.12g}, {C[1]:.12g}, {C[2]:.12g}, "
                    f"{rec.camera_idx}, {rec.camera_model}, {params}\n")


def _collect_points(mapper, min_track_len=2, max_error=None, with_point_ids=False):
    pts, errs, lens, pids = [], [], [], []
    for pid, track in mapper.store.tracks.items():
        if not mapper.store.point3D_valid[pid] or not mapper.store.point3D_tri[pid]:
            continue
        if len(track) < min_track_len:
            continue
        err = mapper.store.point3D_error[pid]
        if max_error is not None and err >= 0 and err > max_error:
            continue
        pts.append(mapper.store.point3D_xyz[pid])
        errs.append(err)
        lens.append(len(track))
        pids.append(pid)
    if not pts:
        out = (np.zeros((0, 3)), np.zeros(0), np.zeros(0, int))
    else:
        out = (np.asarray(pts), np.asarray(errs), np.asarray(lens, int))
    return out + (pids,) if with_point_ids else out


def _rgb(im):
    """An (H, W[, C]) image as (H, W, 3+) channels (gray repeated)."""
    im = np.asarray(im)
    if im.ndim == 3 and im.shape[2] == 2:  # gray + alpha
        im = im[..., 0]
    return np.stack([im] * 3, -1) if im.ndim == 2 else im


def _point_colors(mapper, pids, image_reader):
    """Mean 3x3-window color per 3-D point over all observing images
    (reference sequential_mapper.cc:1559-1597). Returns (N, 3) uint8, or
    None where no image could be read. Image-major, so one decoded frame is
    in memory at a time."""
    store = mapper.store
    row_of_pid = {pid: k for k, pid in enumerate(pids)}
    by_image = {}
    for pid in pids:
        for p2d in store.tracks[pid]:
            by_image.setdefault(int(store.point2D_image[p2d]), []).append((pid, p2d))
    acc = np.zeros((len(pids), 3), np.float64)
    cnt = np.zeros(len(pids), np.int64)
    any_image = False
    for iid, obs in sorted(by_image.items()):
        im = image_reader(mapper.image_id_to_idx[iid])
        if im is None:
            continue
        im = _rgb(im)
        any_image = True
        H, W = im.shape[:2]
        for pid, p2d in obs:
            x, y = store.point2D_xy[p2d]
            xi, yi = int(round(x)), int(round(y))
            y0, y1 = max(yi - 1, 0), min(yi + 2, H)
            x0, x1 = max(xi - 1, 0), min(xi + 2, W)
            if y0 >= y1 or x0 >= x1:
                continue
            k = row_of_pid[pid]
            acc[k] += im[y0:y1, x0:x1, :3].reshape(-1, 3).mean(axis=0)
            cnt[k] += 1
    if not any_image:
        return None
    colors = np.zeros((len(pids), 3), np.uint8)
    nz = cnt > 0
    colors[nz] = np.clip(acc[nz] / cnt[nz, None], 0, 255)
    return colors


def write_point_cloud_data(mapper, path, min_track_len=2, max_error=None, image_reader=None):
    """Text point cloud: X, Y, Z, [R, G, B,] TRACK_LEN, MEAN_RESIDUAL
    (reference sequential_mapper.cc:1543-1643). Colors (the mean of the 3x3
    windows around each observation) are written where
    `image_reader(image_idx) -> HxW[xC] array` reads the imagery."""
    pts, errs, lens, pids = _collect_points(mapper, min_track_len, max_error,
                                            with_point_ids=True)
    colors = _point_colors(mapper, pids, image_reader) if image_reader is not None else None
    with open(path, "w") as f:
        if colors is None:
            f.write("# X, Y, Z, TRACK_LEN, MEAN_RESIDUAL\n")
            for p, e, l in zip(pts, errs, lens):
                f.write(f"{p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f}, {l}, {e:.6f}\n")
        else:
            f.write("# X, Y, Z, R, G, B, TRACK_LEN, MEAN_RESIDUAL\n")
            for p, c, e, l in zip(pts, colors, errs, lens):
                f.write(f"{p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f}, "
                        f"{c[0]}, {c[1]}, {c[2]}, {l}, {e:.6f}\n")


def write_point_cloud_ply(mapper, path, min_track_len=2, max_error=None):
    """ASCII PLY point cloud."""
    pts, errs, lens = _collect_points(mapper, min_track_len, max_error)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property float error\nproperty int track_len\n"
                "end_header\n")
        for p, e, l in zip(pts, errs, lens):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {e:.6f} {l}\n")


def write_camera_models_vrml(mapper, path, scale=1.0):
    """VRML camera frusta (reference sequential_mapper.cc:1646-1787)."""
    with open(path, "w") as f:
        f.write("#VRML V2.0 utf8\n")
        for idx, iid, _, C in _world_poses(mapper):
            R = _rotmat(mapper.store.image_rvecs[iid])
            s = scale
            corners = np.array([[-s, -s, 2 * s], [s, -s, 2 * s], [s, s, 2 * s], [-s, s, 2 * s]])
            world = corners @ R + C  # R^T @ c per corner
            f.write("Shape { appearance Appearance { material Material "
                    "{ diffuseColor 1 0 0 } } geometry IndexedLineSet {\n")
            f.write("coord Coordinate { point [\n")
            f.write(f"{C[0]:.4f} {C[1]:.4f} {C[2]:.4f},\n")
            for w in world:
                f.write(f"{w[0]:.4f} {w[1]:.4f} {w[2]:.4f},\n")
            f.write("] }\ncoordIndex [\n")
            f.write("0,1,-1, 0,2,-1, 0,3,-1, 0,4,-1, 1,2,3,4,1,-1\n] } }\n")


def write_point_cloud_vrml(mapper, path, min_track_len=2, max_error=None):
    """VRML point cloud (reference sequential_mapper.cc:1790-1848)."""
    pts, errs, lens = _collect_points(mapper, min_track_len, max_error)
    with open(path, "w") as f:
        f.write("#VRML V2.0 utf8\n")
        f.write("Shape { geometry PointSet {\ncoord Coordinate { point [\n")
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f},\n")
        f.write("] } } }\n")


def write_camera_connections_vrml(mapper, path):
    """VRML co-visibility connections between processed pairs (reference
    sequential_mapper.cc:1851-1955)."""
    centers = {idx: C for idx, iid, _, C in _world_poses(mapper)}
    with open(path, "w") as f:
        f.write("#VRML V2.0 utf8\n")
        f.write("Shape { geometry IndexedLineSet {\ncoord Coordinate { point [\n")
        idx_to_row = {}
        for i, (idx, C) in enumerate(sorted(centers.items())):
            idx_to_row[idx] = i
            f.write(f"{C[0]:.4f} {C[1]:.4f} {C[2]:.4f},\n")
        f.write("] }\ncoordIndex [\n")
        for a, b in sorted(mapper.pair_graph):
            if a in idx_to_row and b in idx_to_row:
                f.write(f"{idx_to_row[a]},{idx_to_row[b]},-1,\n")
        f.write("] } }\n")


def write_tracks(mapper, path, image_idx, image_reader, max_num_points=50, radius=6):
    """Per-track debug images (reference write_tracks,
    sequential_mapper.cc:1958-2033): for up to `max_num_points` triangulated
    points observed in `image_idx`, one image per observation with the
    observed keypoint circled, named LEN<track_len>-P3D#<id>-IMG#<id>.jpg.
    Needs the imagery (`image_reader(image_idx) -> array`) and Pillow.
    Returns the number of images written."""
    from .debug import _pillow

    Image, ImageDraw = _pillow("write_tracks")
    os.makedirs(path, exist_ok=True)
    store = mapper.store
    p2d_ids = store.point2D_ids_of_image(mapper.image_idx_to_id[image_idx])
    # (pid, track_len, obs) grouped by source image, so each frame is
    # decoded once.
    num_points = 0
    by_image = {}
    for p2d in p2d_ids:
        if num_points >= max_num_points:
            break
        pid = store.point2D_point3D[p2d]
        if pid < 0 or not store.point3D_valid[pid]:
            continue
        num_points += 1
        track = store.tracks[pid]
        for obs_p2d in track:
            obs_iid = int(store.point2D_image[obs_p2d])
            by_image.setdefault(obs_iid, []).append((pid, len(track), obs_p2d))
    num_written = 0
    for obs_iid, entries in sorted(by_image.items()):
        im = image_reader(mapper.image_id_to_idx[obs_iid])
        if im is None:
            continue
        im = _rgb(np.asarray(im).astype(np.uint8))
        for pid, tl, obs_p2d in entries:
            img = Image.fromarray(im[..., :3])
            draw = ImageDraw.Draw(img)
            x, y = store.point2D_xy[obs_p2d]
            draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                         outline=(255, 0, 0), width=2)
            img.save(os.path.join(path, f"LEN{tl}-P3D#{pid}-IMG#{obs_iid}.jpg"))
            num_written += 1
    return num_written
