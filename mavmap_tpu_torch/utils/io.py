"""Input parsers / output writers for the mavmap file formats.

Port of mavmap_tpu/utils/io.py (reference src/util/io.{h,cc}):
  - `imagedata.txt`: per-image BASENAME, ROLL, PITCH, YAW, LAT, LON, ALT,
    LOCAL_HEIGHT, TX, TY, TZ [, CAM_IDX, CAM_MODEL, CAM_PARAMS...] with
    "inherit previous camera" semantics (io.cc:12-143; format
    README.md:106-148);
  - calibration-matrix file (io.cc:146);
  - control-point file with fixed (##) vs variable (#) points
    (io.cc:190-296; format README.md:157-184);
  - estimated control-point output (io.cc:299-324).
Host code (numpy); only `ImageRecord.prior_rvec` runs one float32 rotation
on the CPU, as the JAX version does.
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models import camera as cam
from ..ops.rotation import rvec_from_euler


@dataclass
class ImageRecord:
    """One line of imagedata.txt (counterpart of base2d/image.h:36-52)."""

    name: str
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    lat: float = 0.0
    lon: float = 0.0
    alt: float = 0.0
    local_height: float = 0.0
    tx: float = 0.0
    ty: float = 0.0
    tz: float = 0.0
    camera_idx: int = -1
    camera_model: int = -1
    camera_params: list = field(default_factory=list)

    def prior_rvec(self):
        """IMU prior as angle-axis (reference base2d/image.cc:33-37), float32."""
        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        return rvec_from_euler(f32(self.roll), f32(self.pitch), f32(self.yaw)).numpy()


@dataclass
class ControlPoint:
    """Reference util/io.h:38-45."""

    name: str
    xyz: np.ndarray
    points2D: list  # [(image_idx, x, y), ...]
    fixed: bool


def read_image_data(path, root_path="", image_ext=""):
    """Parse imagedata.txt -> list[ImageRecord].

    Camera definitions inherit from the previous image until a new
    CAM_IDX/CAM_MODEL/CAM_PARAMS appears (reference io.cc:57-138).
    """
    records: List[ImageRecord] = []
    prev_cam_idx = -1
    prev_model = -1
    prev_params: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 11:
                raise ValueError(f"invalid imagedata line: {line!r}")
            rec = ImageRecord(name=parts[0], roll=float(parts[1]), pitch=float(parts[2]),
                              yaw=float(parts[3]), lat=float(parts[4]), lon=float(parts[5]),
                              alt=float(parts[6]), local_height=float(parts[7]),
                              tx=float(parts[8]), ty=float(parts[9]), tz=float(parts[10]))
            if len(parts) >= 13:
                rec.camera_idx = int(parts[11])
                rec.camera_model = cam.camera_model_code(parts[12])
                rec.camera_params = [float(p) for p in parts[13:]]
                n_expected = cam.CAMERA_MODEL_NUM_PARAMS[rec.camera_model]
                if len(rec.camera_params) != n_expected:
                    raise ValueError(f"camera model {parts[12]} expects {n_expected} params, "
                                     f"got {len(rec.camera_params)}: {line!r}")
                prev_cam_idx = rec.camera_idx
                prev_model = rec.camera_model
                prev_params = rec.camera_params
            elif len(parts) == 12:
                # Camera index only: the camera must have been defined before.
                rec.camera_idx = int(parts[11])
                if rec.camera_idx == prev_cam_idx:
                    rec.camera_model = prev_model
                    rec.camera_params = prev_params
                else:
                    for r in reversed(records):
                        if r.camera_idx == rec.camera_idx:
                            rec.camera_model = r.camera_model
                            rec.camera_params = r.camera_params
                            break
                    else:
                        raise ValueError(f"camera idx {rec.camera_idx} used before definition")
            else:
                if prev_cam_idx < 0:
                    raise ValueError("first image must define a camera")
                rec.camera_idx = prev_cam_idx
                rec.camera_model = prev_model
                rec.camera_params = prev_params
            records.append(rec)
    return records


def cameras_from_records(records):
    """Unique cameras -> (cam_models (C,), cam_params (C, 9), image_cameras)."""
    cam_map = {}
    models, params = [], []
    image_cameras = []
    for rec in records:
        key = rec.camera_idx
        if key not in cam_map:
            cam_map[key] = len(models)
            models.append(rec.camera_model)
            p = np.zeros(cam.MAX_CAM_PARAMS, np.float32)
            p[: len(rec.camera_params)] = rec.camera_params
            params.append(p)
        image_cameras.append(cam_map[key])
    return (np.asarray(models, np.int32),
            np.stack(params) if params else np.zeros((0, 9), np.float32),
            np.asarray(image_cameras, np.int32))


def read_calib_matrix(path):
    """3x3 calibration matrix file (reference io.cc:146-187)."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals.extend(float(v) for v in line.replace(",", " ").split())
    if len(vals) != 9:
        raise ValueError("calibration file must contain 9 values")
    return np.asarray(vals, np.float64).reshape(3, 3)


def read_control_point_data(path):
    """Parse control-point file -> list[ControlPoint] (io.cc:190-296)."""
    points: List[ControlPoint] = []
    current: Optional[ControlPoint] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                fixed = line.startswith("##")
                parts = [p.strip() for p in line.lstrip("#").strip().split(",")]
                if len(parts) != 4:
                    raise ValueError(f"invalid control point header: {line!r}")
                current = ControlPoint(name=parts[0],
                                       xyz=np.asarray([float(v) for v in parts[1:]], np.float64),
                                       points2D=[], fixed=fixed)
                points.append(current)
            else:
                if current is None:
                    raise ValueError("observation before control point header")
                parts = [p.strip() for p in line.split(",")]
                current.points2D.append((int(parts[0]), float(parts[1]), float(parts[2])))
    return points


def write_control_point_data(path, control_points, estimated_xyz, track_lens, mean_residuals):
    """Estimated control-point coordinates output (reference io.cc:299-324)."""
    with open(path, "w") as f:
        f.write("# NAME, X, Y, Z, TRACK_LEN, MEAN_RESIDUAL\n")
        for cp, xyz, tl, res in zip(control_points, estimated_xyz, track_lens, mean_residuals):
            f.write(f"{cp.name}, {xyz[0]:.6f}, {xyz[1]:.6f}, {xyz[2]:.6f}, {tl}, {res:.6f}\n")
