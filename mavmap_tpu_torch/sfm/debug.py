"""Debug-mode artifact dumps for the sequential mapper.

Port of mavmap_tpu/sfm/debug.py (the reference's `--debug` / `--debug-path`,
sequential_mapper.cc:61-97, 234-254, 406-455, 817-911): per-pair match
tables, per-step track-length logs and per-step VRML scenes of the current
image's 3-D points colored by track length, named as the reference names
them: `<num_proc_images>-<idx_a>-<idx_b>-<tag>.<ext>`.

The text dumps need nothing beyond numpy. The match drawings (JPEGs of the
two images with their matches, made where an image reader returns imagery)
need Pillow, which this package does not require: where a drawing is asked
for and Pillow is missing, DebugDumper raises instead of skipping it.
"""

import os

import numpy as np


def _pillow(what):
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise RuntimeError(f"{what} needs Pillow, which is not installed (the text dumps do "
                           f"not; run without an image reader to skip the drawings)") from e
    return Image, ImageDraw


class DebugDumper:
    def __init__(self, debug_path, image_reader=None):
        """image_reader(image_idx) -> HxW[xC] uint8 array or None: the
        imagery the match drawings are made on (None: no drawings)."""
        self.path = debug_path
        self.image_reader = image_reader
        os.makedirs(debug_path, exist_ok=True)

    def _file(self, nproc, a, b, tag):
        return os.path.join(self.path, f"{nproc}-{a}-{b}-{tag}")

    # ------------------------------------------------------------- matches

    def dump_matches(self, nproc, idx_a, idx_b, kp_a, kp_b, matches, valid, inlier=None,
                     tag="matches-all"):
        """Write matched keypoint pairs (and draw them where imagery is
        available). `matches[i]` = row in image b matched to row i of image
        a; `valid` masks real matches; `inlier` optionally flags RANSAC
        inliers (reference `-matches-all.jpg` / `-matches-inlier.jpg`)."""
        kp_a = np.asarray(kp_a)
        kp_b = np.asarray(kp_b)
        matches = np.asarray(matches)
        valid = np.asarray(valid).astype(bool)
        rows = np.where(valid[: len(kp_a)])[0]
        with open(self._file(nproc, idx_a, idx_b, tag + ".txt"), "w") as f:
            f.write("# x_a y_a x_b y_b inlier\n")
            for i in rows:
                j = matches[i]
                flag = 1 if (inlier is None or bool(inlier[i])) else 0
                f.write(f"{kp_a[i, 0]:.2f} {kp_a[i, 1]:.2f} "
                        f"{kp_b[j, 0]:.2f} {kp_b[j, 1]:.2f} {flag}\n")
        if self.image_reader is not None:
            self._render_matches(nproc, idx_a, idx_b, kp_a, kp_b, matches, rows, inlier, tag)

    def _render_matches(self, nproc, idx_a, idx_b, kp_a, kp_b, matches, rows, inlier, tag):
        im_a = self.image_reader(idx_a)
        im_b = self.image_reader(idx_b)
        if im_a is None or im_b is None:
            return
        Image, ImageDraw = _pillow("drawing the debug match images")

        def to_rgb(im):
            im = np.asarray(im).astype(np.uint8)
            if im.ndim == 3 and im.shape[2] == 2:  # gray + alpha
                im = im[..., 0]
            return np.stack([im] * 3, -1) if im.ndim == 2 else im[..., :3]

        im_a, im_b = to_rgb(im_a), to_rgb(im_b)
        H = max(im_a.shape[0], im_b.shape[0])
        W = im_a.shape[1] + im_b.shape[1]
        canvas = np.zeros((H, W, 3), np.uint8)
        canvas[: im_a.shape[0], : im_a.shape[1]] = im_a
        canvas[: im_b.shape[0], im_a.shape[1]:] = im_b
        img = Image.fromarray(canvas)
        draw = ImageDraw.Draw(img)
        xoff = im_a.shape[1]
        for i in rows:
            j = matches[i]
            ok = inlier is None or bool(inlier[i])
            draw.line([(kp_a[i, 0], kp_a[i, 1]), (kp_b[j, 0] + xoff, kp_b[j, 1])],
                      fill=(0, 220, 0) if ok else (220, 0, 0), width=1)
        img.save(self._file(nproc, idx_a, idx_b, tag + ".jpg"), quality=85)

    # -------------------------------------------------------------- tracks

    def dump_track_lengths(self, nproc, image_idx, prev_image_idx, store, image_id):
        """`-track-length.log`: one line per observed 3-D point of the
        current image (reference sequential_mapper.cc:817-844)."""
        p3d = store.point2D_point3D[store.point2D_ids_of_image(image_id)]
        with open(self._file(nproc, image_idx, prev_image_idx, "track-length.log"), "w") as f:
            for pid in p3d:
                if pid < 0 or not store.point3D_valid[pid]:
                    continue
                tl = int(store.point3D_track_len[pid])
                z = float(store.point3D_xyz[pid][2])
                f.write(f"Point 3D-ID: {pid}\t\t, Track-length: {tl}\t\t, Z-coord: {z}\n")

    def dump_scene_vrml(self, nproc, image_idx, prev_image_idx, store, image_id,
                        min_track_len=3):
        """`-scene.wrl`: the current image's triangulated points, red for
        track length 2 (new), green above min_track_len (used for pose),
        blue otherwise (reference sequential_mapper.cc:846-911)."""
        p3d = store.point2D_point3D[store.point2D_ids_of_image(image_id)]
        pts, cols = [], []
        for pid in p3d:
            if pid < 0 or not store.point3D_valid[pid] or not store.point3D_tri[pid]:
                continue
            tl = int(store.point3D_track_len[pid])
            if tl == 2:
                col = (1, 0, 0)
            elif tl > min_track_len:
                col = (0, 1, 0)
            else:
                col = (0, 0, 1)
            pts.append(store.point3D_xyz[pid])
            cols.append(col)
        with open(self._file(nproc, image_idx, prev_image_idx, "scene.wrl"), "w") as f:
            f.write("#VRML V2.0 utf8\n")
            f.write("Background { skyColor [1.0 1.0 1.0] } \n")
            f.write("Shape{ appearance Appearance {\n")
            f.write(" material Material {emissiveColor 1 1 1} }\n")
            f.write(" geometry PointSet {\n")
            f.write(" coord Coordinate {\n")
            f.write("  point [\n")
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            f.write(" ] }\n")
            f.write(" color Color { color [\n")
            for c in cols:
                f.write(f"{c[0]} {c[1]} {c[2]}\n")
            f.write(" ] } } }\n")
