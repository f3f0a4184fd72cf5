"""The files a mavmap user hands the command-line mapper, in numpy alone.

- `imagedata.txt` (mavmap README.md:106-148, util/io.cc:12-143): one line
  per frame, BASENAME, ROLL, PITCH, YAW, LAT, LON, ALT, LOCAL_HEIGHT, TX,
  TY, TZ, CAM_IDX, and on a camera's first frame its CAM_MODEL and
  CAM_PARAMS; later frames of that camera give only its CAM_IDX. The
  scene's camera c is CAM_IDX c + 1. No IMU or GPS prior: those fields are
  0.
- The feature cache's dumps (base2d/feature_cache.cc:125-142), per frame
  `<name>-keypoints.bin`: the byte count (size_t), then 28-byte
  cv::KeyPoint structs (x, y, size, angle, response as float32; octave,
  class_id as int32); and `<name>-descriptors.bin`: the byte count
  (size_t), cv::Mat's rows, cols and type (CV_32F, 5) as 4-byte ints, then
  the float32 rows. Every feature is written, with responses falling in
  file order, so a reader that keeps the strongest `capacity` rows keeps
  the first ones: the rows the benchmark's judge holds.

Nothing here imports the program.
"""

import os

import numpy as np

from .scene import MODEL_CODES, MODEL_NUM_PARAMS

MODEL_NAMES = {code: name for name, code in MODEL_CODES.items()}
CV_KEYPOINT = np.dtype([("x", "<f4"), ("y", "<f4"), ("size", "<f4"), ("angle", "<f4"),
                        ("response", "<f4"), ("octave", "<i4"), ("class_id", "<i4")])
CV_32F = 5


def frame_name(i):
    return f"img{i}"


def write_feature_dump(root, name, keypoints, descriptors, responses):
    """One frame's `<name>-keypoints.bin` and `<name>-descriptors.bin`
    under `root`."""
    raw = np.zeros(len(keypoints), CV_KEYPOINT)
    raw["x"], raw["y"] = keypoints[:, 0], keypoints[:, 1]
    raw["response"] = responses
    with open(os.path.join(root, f"{name}-keypoints.bin"), "wb") as f:
        f.write(np.uint64(raw.nbytes).tobytes() + raw.tobytes())
    d = np.ascontiguousarray(descriptors, "<f4")
    header = np.array([*d.shape, CV_32F], "<i4")
    with open(os.path.join(root, f"{name}-descriptors.bin"), "wb") as f:
        f.write(np.uint64(d.nbytes).tobytes() + header.tobytes() + d.tobytes())


def imagedata_lines(scene):
    """imagedata.txt's lines for the scene's frames, each camera defined on
    its first frame (parameters as the float32 values' shortest repr)."""
    lines, defined = ["# BASENAME, ROLL, PITCH, YAW, LAT, LON, ALT, LOCAL_HEIGHT, TX, TY, TZ, "
                      "CAM_IDX, CAM_MODEL, CAM_PARAMS"], set()
    for i in range(scene.num_images):
        c = int(scene.image_cameras[i])
        line = f"{frame_name(i)}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, {c + 1}"
        if c not in defined:
            defined.add(c)
            model = int(scene.cam_models[c])
            params = scene.cam_params[c, :MODEL_NUM_PARAMS[model]]
            line += f", {MODEL_NAMES[model]}, " + ", ".join(repr(float(p)) for p in params)
        lines.append(line)
    return lines


def write_flight(root, scene, feats):
    """One flight's inputs under `root`: data/imagedata.txt and every
    frame's dumps under ref/. feats: per frame (keypoints (n, 2),
    descriptors (n, D)), as handed to the judge. Returns (data, ref)."""
    data, ref = os.path.join(root, "data"), os.path.join(root, "ref")
    os.makedirs(data, exist_ok=True)
    os.makedirs(ref, exist_ok=True)
    with open(os.path.join(data, "imagedata.txt"), "w") as f:
        f.write("\n".join(imagedata_lines(scene)) + "\n")
    for i, (kp, de) in enumerate(feats):
        write_feature_dump(ref, frame_name(i), kp, de,
                           np.linspace(1.0, 0.5, len(kp)).astype(np.float32))
    return data, ref
