"""The CLI's cell on the CPU (this test may import the port; the reference
never does):

- the benchmark's own writer of the user's files (imagedata.txt and
  mavmap's feature dumps), read back through the port's parsers and its
  reference-cache provider, gives the scene's camera table and the rows
  the judge holds, bit for bit;
- the cli driver maps a 10-frame cut of the rig through `cli.run` and the
  judge reads it correct, every frame's dumps read once and counted, the
  CLI's inputs and outputs timed;
- planted faults read not correct: the OPENCV camera's k1-p2 zeroed in the
  judged map, every frame put on camera 0 by the program's camera table,
  and loop detection off (no closure, under the cell's floor);
- the readers of the CLI's spans on made-up runs, and nothing where the
  program has no such span.
"""

import json

import numpy as np
import pytest
import torch

from sfmbench import core
from sfmbench.reference import mavmap_files, scene as ref

READERS = {r.name: r for r in core.load_readers()}
RIG = core.load_json(core.ROOT / "configs" / "rig2_opencv_cli.json")
CUT = {"num_images": 10, "num_points": 1600, "relief": 10.0, "rows": 2, "seed": 11}


def _written(tmp_path, capacity=1024):
    s = ref.make_uav_scene(**CUT, cameras=RIG["cameras"])
    feats, _ = ref.render_features(s, ref.noise_rng(101, 0), clutter=64, capacity=capacity)
    data, dumps = mavmap_files.write_flight(str(tmp_path), s, feats)
    return s, feats, data, dumps


def test_written_cameras_read_back_bit_for_bit(tmp_path):
    from mavmap_tpu_torch.utils.io import cameras_from_records, read_image_data

    s, _, data, _ = _written(tmp_path)
    records = read_image_data(f"{data}/imagedata.txt")
    assert [r.name for r in records] == [f"img{i}" for i in range(10)]
    assert [r.camera_idx for r in records] == [1, 2] * 5
    models, params, image_cameras = cameras_from_records(records)
    np.testing.assert_array_equal(models, s.cam_models)
    assert params.dtype == s.cam_params.dtype == np.float32
    np.testing.assert_array_equal(params.view(np.uint32), s.cam_params.view(np.uint32))
    np.testing.assert_array_equal(image_cameras, s.image_cameras)


@pytest.mark.parametrize("capacity", [1024, 128], ids=["every-row", "cut"])
def test_written_dumps_read_back_as_the_judges_rows(tmp_path, capacity):
    """The provider's strongest-first cut keeps the file's first rows: the
    rows a provider of `capacity` holds and the judge compares with."""
    from mavmap_tpu_torch.features import ReferenceCacheProvider

    _, feats, _, dumps = _written(tmp_path)
    prov = ReferenceCacheProvider(dumps, [f"img{i}" for i in range(10)], capacity=capacity)
    for i, (kp, de) in enumerate(feats):
        f = prov.get(i)
        n = min(len(kp), capacity)
        np.testing.assert_array_equal(f.keypoints[:n], kp[:n])
        np.testing.assert_array_equal(f.descriptors[:n], de[:n])
        assert f.mask[:n].all() and not f.mask[n:].any()
    assert prov.totals["feature_reads"] == 10


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    import shutil

    root = tmp_path_factory.mktemp("cli")
    for d in ("configs", "metrics"):
        shutil.copytree(core.ROOT / d, root / d)
    # The cut closes no loop at the cell's detection period of 10 frames; at
    # 5, with a neighbourhood of 4, it closes 17 on the CPU, over the cell's
    # floor of 10 (argparse takes the last of a repeated flag).
    cfg = core.load_json(root / "configs" / "rig2_opencv_cli.json")
    cfg["cli"] += ["--loop-detection-period", "5", "--loop-detection-nh-dist", "4"]
    (root / "configs" / "rig2_opencv_cli.json").write_text(json.dumps(cfg))
    (root / "workloads").mkdir()
    wl = core.load_json(core.ROOT / "workloads" / "rig30-cli.json")
    wl.update(name="rig10", maps=1, warmup_frames=5, flight=CUT)
    (root / "workloads" / "rig10.json").write_text(json.dumps(wl))
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    return core.load_cell("rig10", root)


@pytest.fixture(scope="module")
def mapped(cell):
    inputs = core.make_inputs(cell.workload, 7, 1, cell.config)
    ctx = cell.driver.prepare(cell, inputs, 7, torch.device("cpu"))
    return ctx, inputs, cell.driver.map_once(ctx, 0, core.Spans())


def _checks(cell, inputs, rec):
    values, _ = core.judge_values([rec], inputs.scene, [[kp for kp, _ in inputs.feats[0]]])
    return core.check(values, cell.workload["limits"])


def test_cli_cell_is_correct_on_the_cpu(cell):
    result, lines, found = core.execute(cell, 7, 0.1, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert (result["attempted"], result["failed"], found) == (10, 0, [])
    assert len(lines) == len(cell.workload["limits"])


def test_cli_map_counts_its_reads_and_times_its_files(cell, mapped):
    ctx, inputs, rec = mapped
    assert rec.registered == rec.offered == 10 and rec.stats["maps"] == 1
    reads = rec.counters.get("feature_reads", 0) + rec.timings.get("feature_reads", 0)
    assert reads == rec.offered  # a new provider per run, its LRU larger than the flight
    assert rec.timings["cli.inputs"] > 0 and rec.timings["cli.outputs"] > 0
    assert {"sequential_loop", "global_ba"} <= set(rec.timings)
    assert set(rec.state.cam_models.tolist()) == {ref.PINHOLE, ref.OPENCV}
    ok, checks = _checks(cell, inputs, rec)
    assert ok, checks


def test_cli_map_with_zeroed_distortion_is_not_correct(cell, mapped):
    from dataclasses import replace

    _, inputs, rec = mapped
    params = rec.state.cam_params.copy()
    params[rec.state.cam_models == ref.OPENCV, 4:8] = 0.0
    ok, checks = _checks(cell, inputs, replace(rec, state=replace(rec.state, cam_params=params)))
    assert not ok and checks["reproj_worst_px"]["value"] > 3.0, checks


def _one_camera(monkeypatch):
    from mavmap_tpu_torch.utils import io

    table = io.cameras_from_records

    def one_camera(records):
        models, params, image_cameras = table(records)
        return models, params, np.zeros_like(image_cameras)

    monkeypatch.setattr(io, "cameras_from_records", one_camera)
    return []


def _no_loop_detection(monkeypatch):
    return ["--no-loop-detection"]


@pytest.mark.parametrize("plant", [_one_camera, _no_loop_detection],
                         ids=["every-frame-on-camera-0", "loop-detection-off"])
def test_cli_fault_is_not_correct(cell, mapped, monkeypatch, plant):
    ctx, inputs, _ = mapped
    rec = cell.driver.record(ctx, *cell.driver.run(ctx, 0, core.Spans(), plant(monkeypatch)))
    ok, checks = _checks(cell, inputs, rec)
    assert not ok, checks


def _run(counters, timings, maps=2, offered=30):
    return core.Run(maps=[core.MapRecord(wall_s=6.0, offered=offered, registered=offered,
                                         counters=dict(counters), timings=dict(timings),
                                         stats={}) for _ in range(maps)], spans=core.Spans())


@pytest.mark.parametrize("counters, timings, name, value", [
    ({"feature_reads": 30, "feature_read_s": 0.012}, {"cli.outputs": 0.15},
     "features.read_ms_per_frame", 1000.0 * 0.012 / 30),
    ({"feature_reads": 28, "feature_read_s": 0.010},
     {"feature_reads": 2, "feature_read_s": 0.002},
     "features.read_ms_per_frame", 1000.0 * 0.012 / 30),
    ({}, {"cli.inputs": 0.01, "cli.outputs": 0.15, "sequential_loop": 4.0},
     "cli.outputs_ms_per_frame", 1000.0 * 0.15 / 30),
], ids=["reads-in-the-mappers", "reads-also-outside", "outputs"])
def test_cli_reader_reads_its_span(counters, timings, name, value):
    r = READERS[name]
    assert r.read(_run(counters, timings)) == pytest.approx(value)
    assert r.drivers == ("cli",) and r.moves == "frames_per_s" and r.source == "program_span"
    # A program without the CLI's spans (the parent of this cell) gives no
    # reading, and no error; nor does a window without maps.
    assert r.read(_run({"ba_iters": 40}, {"sequential_loop": 4.0, "global_ba": 1.0})) is None
    assert r.read(_run({}, {}, maps=0)) is None


def test_the_cli_cell_loads_no_jax_and_its_writer_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import importlib, json, sys\n"
            "import sfmbench.reference.mavmap_files\n"
            "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
            "for m in ('sfmbench.drivers.cli', 'mavmap_tpu_torch.cli'):\n"
            "    importlib.import_module(m)\n"
            "from sfmbench import core\n"
            "print(json.dumps([tops, core.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT.parent, capture_output=True,
                         text=True, check=True).stdout
    tops, forbidden = json.loads(out.strip().splitlines()[-1])
    assert not set(tops) & {"mavmap_tpu_torch", "mavmap_tpu", "jax", "torch"}
    assert forbidden == []
