"""The port's detector on the card against the benchmark's plain reference
detector (sfmbench/reference/detector.py, numpy float64). Every test is
marked `gpu` and skips without a CUDA device; the file imports neither jax
nor mavmap_tpu:

    python -m pytest --noconftest tests/test_torch_detector_gpu.py -q

- every frame of one flight of the photo40-cli cell (the survey rendered
  by sfmbench/reference/photo.py with flight 0's sensor noise) detected
  on the card lies within the photo_cli driver's tolerances of the
  reference (`compare_detection`: the same keypoints within 1e-3 px in
  every octave, 97 % of the descriptors within 0.05);
- two detections of one frame on the card are equal bit for bit, and
  frames detected on three threads at once, as the CLI extracts them,
  give the bits of frames detected one after another.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mavmap_tpu_torch.features.detector import detect_and_describe, detect_image
from sfmbench import core
from sfmbench.drivers import photo_cli
from sfmbench.reference import detector as ref_detector
from sfmbench.reference.scene import noise_rng

pytestmark = pytest.mark.gpu
CELL = "photo40-cli"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def flight():
    cell = core.load_cell(CELL)
    scene = core.make_inputs(cell.workload, 1, 0, cell.config).scene
    frames = photo_cli.noisy(photo_cli.render(cell, scene),
                             noise_rng(cell.workload["data_seed"], 0),
                             cell.workload["images"]["sensor_noise"])
    return cell.config["detector"], frames


def test_detector_holds_to_the_reference_on_every_frame_of_a_flight(dev, flight):
    params, frames = flight
    worst = None
    for i, gray in enumerate(frames):
        kp, desc = detect_image(gray.astype(np.float32), device=dev, **params)
        got = photo_cli.compare_detection(kp, desc, ref_detector.detect(gray, **params))
        assert got["ok"], (i, got)
        if worst is None or got["matched"] < worst["matched"]:
            worst = dict(got, frame=i)
    print(f"worst frame of {len(frames)}: {worst}")


def _detect(gray, dev, params):
    img = torch.as_tensor(gray.astype(np.float32), device=dev)
    return [t.cpu() for t in detect_and_describe(img, **params)]


def test_detection_repeats_bit_for_bit(dev, flight):
    params, frames = flight
    one = [_detect(g, dev, params) for g in frames[:6]]
    again = _detect(frames[0], dev, params)
    for a, b in zip(one[0], again):
        assert torch.equal(a, b)
    with ThreadPoolExecutor(3) as ex:
        threaded = list(ex.map(lambda g: _detect(g, dev, params), frames[:6]))
    for i, (x, y) in enumerate(zip(one, threaded)):
        for a, b in zip(x, y):
            assert torch.equal(a, b), i
