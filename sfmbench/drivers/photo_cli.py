"""The command-line mapper from photographs: `mavmap_tpu_torch.cli.run` over
a flight written as its user's files, one PNG per frame and
imagedata.txt (one PINHOLE camera, no IMU angles), with the
configuration's `cli` flags and a vocabulary tree; every other option is
the CLI's default. The CLI decodes every frame, detects and describes its
features on the card, caches them, then maps.

Set-up renders the survey once over the committed photographs
(`reference/photo.py`, the workload's `images` block), then writes the
warm-up flight's frames and those of each flight of the window under one
temporary directory: the same render with each flight's own sensor noise
(Gaussian, `images.sensor_noise` gray levels, rounded and clipped to
uint8, drawn from `noise_rng(data_seed, flight)`; the warm-up is flight
-1), each frame a PNG of the reference's writer. The tree is trained on
the card from the port's own detections (`detect_image`, the
configuration's `detector` block) of every `tree.every`-th warm-up frame:
`tree.rows` of those descriptors, saved as tree.npz for --voc-tree-path.

A map is one `cli.run` into a fresh output directory, with no
--reference-cache-path, so every frame is decoded and detected; timed
from the call to after a synchronize on its return. A non-zero return
code raises. After the timed call, before the output directory goes:

- the program's keypoints are read back from the CLI's own cache files
  (`<out>/cache/img<i>.npz`) into `inputs.feats[k]`: with detection there
  is no benchmark keypoint per feature row, so the judge holds each map's
  reprojection to the program's own measurements, as mavmap's
  reprojection error does; ATE stays against the benchmark's truth;
- one frame per map, `(7 * flight) mod frames`, is detected again by the
  plain reference (`reference/detector.py`) from the same PNG, and the
  program's cached keypoints and descriptors are held to it
  (`compare_detection`); a frame outside the tolerances raises;
- the map's 3-D points are held to those keypoints (`check_map`): the
  median reprojection error of every track observation, as the judge
  computes each one, above the workload's `map_check.reproj_median_px`
  raises. The judge's RMSE cannot hold these maps: loop closures on
  these mirror-tiled photographs merge tracks of different ground
  points, leaving a few observations hundreds of pixels off and now and
  then one behind its camera, as the JAX package's CLI does on the same
  frames; the median does not follow them, and moved points move it.

Spans: `cli` around the call, and inside it the post-pass stages
(`stage_spans` of the pipeline driver), as the cli driver has them;
`detector_check` around the reference's detection and the comparison,
and `map_check` around the map's check.
"""

import contextlib
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from ..reference import detector as ref_detector, judge, photo
from ..reference.mavmap_files import frame_name, imagedata_lines
from ..reference.scene import noise_rng
from .cli import _sync, flight_dir, record
from .pipeline import stage_spans

PHOTO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "mavmap_tpu_torch", "data", "photos")

# The detector check's tolerances. Measured on a CPU, the port's
# float32 detector against this float64 reference on the survey's frames:
# the same 1017 keypoints in the same order, every one within 5e-5 px,
# 99.7-99.8 % of the descriptors within 0.05 (the rest: orientation bins
# that flip between near-equal window sums). The planted faults read: a
# bfloat16 response map 11.5-13.3 % of the keypoints within 1e-3 px
# (its sub-pixel fits and suppression ties move); three octaves in place
# of four none of the reference's 48-52 fourth-octave keypoints; upright
# descriptors 0.2-0.5 % within 0.05.
POSITION_TOL_PX = 1e-3      # a reference keypoint is matched within this
MATCHED_MIN = 0.98          # share of the reference's keypoints matched
OCTAVE_MATCHED_MIN = 0.9    # in every octave holding OCTAVE_MIN_KEYPOINTS
OCTAVE_MIN_KEYPOINTS = 10
COUNT_TOL = 0.02            # |program - reference| / reference keypoints
DESCRIPTOR_TOL = 0.05       # L2 distance of a matched pair's descriptors
DESCRIPTOR_SHARE_MIN = 0.97  # share of matched pairs within it


@dataclass
class Context:
    cell: object
    inputs: object
    device: object
    tmp: object
    tree_path: str


def render(cell, scene):
    """The survey's frames before sensor noise."""
    im = cell.workload["images"]
    photos = photo.load_photos([os.path.join(PHOTO_DIR, f"{n}.png") for n in im["photos"]])
    return photo.render_photo_survey(scene, photos, im["relief_amp"])


def noisy(frames, rng, sigma):
    """Each frame plus Gaussian sensor noise, rounded and clipped to uint8."""
    return [np.clip(np.rint(f + rng.normal(0.0, sigma, f.shape)), 0, 255).astype(np.uint8)
            for f in frames]


def write_flight(root, scene, frames):
    """data/imagedata.txt and data/img<i>.png under `root`."""
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    with open(os.path.join(data, "imagedata.txt"), "w") as f:
        f.write("\n".join(imagedata_lines(scene)) + "\n")
    for i, frame in enumerate(frames):
        photo.write_png(os.path.join(data, f"{frame_name(i)}.png"), frame)


def flight_of(ctx, k):
    return -1 if k == -1 else ctx.inputs.order[k]


def prepare(cell, inputs, seed, device):
    from mavmap_tpu_torch.features.detector import detect_image
    from mavmap_tpu_torch.loop import train_voc_tree

    wl = cell.workload
    tmp = tempfile.TemporaryDirectory(prefix="sfmbench_photo_")
    ctx = Context(cell=cell, inputs=inputs, device=device, tmp=tmp,
                  tree_path=os.path.join(tmp.name, "tree.npz"))
    clean = render(cell, inputs.scene)
    warm = None
    for k in inputs.feats:
        frames = noisy(clean, noise_rng(wl["data_seed"], flight_of(ctx, k)),
                       wl["images"]["sensor_noise"])
        write_flight(flight_dir(ctx, k), inputs.scene, frames)
        if k == -1:
            warm = frames
    t, det = cell.config["tree"], cell.config["detector"]
    desc = np.concatenate([detect_image(f.astype(np.float32), device=device, **det)[1]
                           for f in warm[:: t["every"]]])
    rows = desc[np.random.default_rng(t["seed"]).permutation(len(desc))[: t["rows"]]]
    train_voc_tree(rows, branching=t["branching"], depth=t["depth"], iters=t["iters"],
                   device=device).save(ctx.tree_path)
    return ctx


def read_cache(out, n):
    """The program's (keypoints, descriptors) of frames 0..n-1 from the
    CLI's feature cache under `out`."""
    feats = []
    for i in range(n):
        with np.load(os.path.join(out, "cache", f"{frame_name(i)}.npz")) as z:
            feats.append((np.array(z["keypoints"], np.float32),
                          np.array(z["descriptors"], np.float32)))
    return feats


def run(ctx, k, spans, extra=(), frames=0):
    """One cli.run over flight k's PNGs (-1: the warm-up's) with the
    configuration's flags and `extra`; returns (CliRun, wall seconds, the
    program's cached features of the first `frames` frames)."""
    from mavmap_tpu_torch import cli

    out = tempfile.mkdtemp(prefix="out", dir=ctx.tmp.name)
    argv = ["--input-path", os.path.join(flight_dir(ctx, k), "data"), "--output-path", out,
            "--voc-tree-path", ctx.tree_path, "--device", str(ctx.device),
            *ctx.cell.config["cli"], *extra]
    try:
        _sync(ctx.device)
        t0 = time.perf_counter()
        with spans("cli"), stage_spans(spans), contextlib.redirect_stdout(sys.stderr):
            r = cli.run(argv)
            _sync(ctx.device)
        wall = time.perf_counter() - t0
        if r.rc != 0:
            raise RuntimeError(f"mavmap_tpu_torch.cli returned {r.rc} on flight {k}")
        feats = read_cache(out, frames)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return r, wall, feats


def warmup(ctx, spans):
    """The warm-up flight's first `warmup_frames` frames through the CLI:
    decode, detection and the cache writes on the worker threads, chains,
    window solves, a loop query, the global BA, a closure sweep and the
    writers each run once."""
    run(ctx, -1, spans, ["--end-image-idx", str(ctx.cell.workload["warmup_frames"] - 1)])


def compare_detection(keypoints, descriptors, ref):
    """The program's kept features of one frame against the reference's
    (`reference.detector.Detection`): the numbers and whether every one
    lies within its tolerance."""
    n_ref = len(ref.keypoints)
    kp = np.asarray(keypoints, np.float64)
    d2 = ((ref.keypoints[:, None, :] - kp[None, :, :]) ** 2).sum(-1)
    near = d2.argmin(1)
    dist = np.sqrt(d2[np.arange(n_ref), near])
    matched = dist <= POSITION_TOL_PX
    octaves = {}
    for o in np.unique(ref.octaves):
        here = ref.octaves == o
        if here.sum() >= OCTAVE_MIN_KEYPOINTS:
            octaves[int(o)] = float(matched[here].mean())
    dd = np.linalg.norm(np.asarray(descriptors, np.float64)[near[matched]]
                        - ref.descriptors[matched], axis=1)
    out = {"program": len(kp), "reference": n_ref, "matched": float(matched.mean()),
           "matched_by_octave": octaves,
           "descriptors_within": float((dd <= DESCRIPTOR_TOL).mean()) if len(dd) else 0.0}
    out["ok"] = bool(abs(len(kp) - n_ref) <= COUNT_TOL * n_ref
                     and out["matched"] >= MATCHED_MIN
                     and all(v >= OCTAVE_MATCHED_MIN for v in octaves.values())
                     and out["descriptors_within"] >= DESCRIPTOR_SHARE_MIN)
    return out


def check_frame(ctx, k, feats, spans):
    """Hold the program's features of map k's check frame to the
    reference's detection on the same PNG; raises outside the tolerances.
    Returns the numbers, with the check's seconds."""
    t0 = time.perf_counter()
    flight = flight_of(ctx, k)
    j = (7 * flight) % len(feats)
    with spans("detector_check"):
        gray = photo.read_png(os.path.join(flight_dir(ctx, k), "data", f"{frame_name(j)}.png"))
        ref = ref_detector.detect(gray, **ctx.cell.config["detector"])
        out = dict(compare_detection(*feats[j], ref), flight=flight, frame=j)
    out["seconds"] = time.perf_counter() - t0
    print(f"photo_cli: detector check {out}", file=sys.stderr, flush=True)
    if not out["ok"]:
        raise RuntimeError(f"the program's features of frame {j} of flight {flight} "
                           f"differ from the reference detector's: {out}")
    return out


def check_map(ctx, k, state, feats, spans):
    """Hold map k's points to the program's keypoints: the median
    reprojection error of every track observation (`judge`'s errors, a
    point behind its camera counting as infinite) against the workload's
    limit; raises above it. Returns the numbers."""
    limit = ctx.cell.workload["map_check"]["reproj_median_px"]
    with spans("map_check"):
        err = judge.reprojection_errors(state, [kp for kp, _ in feats])
    median = float(np.median(err)) if len(err) else float("inf")
    out = {"flight": flight_of(ctx, k), "observations": len(err),
           "reproj_median_px": median, "limit": limit,
           "beyond_4px": int((err > 4.0).sum()), "behind": int(np.isinf(err).sum())}
    print(f"photo_cli: map check {out}", file=sys.stderr, flush=True)
    if not median <= limit:
        raise RuntimeError(f"the median reprojection error of flight {out['flight']}'s map "
                           f"exceeds its limit: {out}")
    return out


def map_once(ctx, k, spans):
    n = ctx.inputs.scene.num_images
    r, wall, feats = run(ctx, k, spans, frames=n)
    ctx.inputs.feats[k] = feats
    rec = record(ctx, r, wall)
    rec.stats["detector_check"] = check_frame(ctx, k, feats, spans)
    rec.stats["map_check"] = check_map(ctx, k, rec.state, feats, spans)
    return rec
