"""A run with the timed path broken underneath has to come out not
correct. Each test drives the whole of a run on the CPU (everything but
the harness's look for a card) on a short two-strip flight, with one fault
planted in the port, and reads `correct`:

- a step that returns its state unchanged: no bundle adjustment's result
  ever lands in the map;
- half of the batch left out: each chained registration step commits the
  first half of its frames and the rest never register;
- an answer altered where it is produced: every point a bundle adjustment
  returns is moved by 5 cm;
- on the survey's `run_pipeline` path, closures dropped: loop detection
  and the closure sweep find their candidates and commit none; and the
  closure sweep skipped.

The survey's flight is cut to four strips of six frames; loop detection
runs every six frames with a neighbourhood of four, so that so short a
flight closes loops at all.

The exchange between chips is a fault these one-chip cells cannot have.
"""

import json

import numpy as np
import pytest
import torch

from sfmbench import core


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    import shutil

    root = tmp_path_factory.mktemp("cell")
    for d in ("configs", "metrics"):
        shutil.copytree(core.ROOT / d, root / d)
    (root / "workloads").mkdir()
    wl = core.load_json(core.ROOT / "workloads" / "uav30-chained.json")
    wl.update(name="faults", maps=1, warmup_frames=6,
              flight={"num_images": 12, "num_points": 1600, "relief": 10.0, "rows": 2,
                      "seed": 11})
    (root / "workloads" / "faults.json").write_text(json.dumps(wl))
    return core.load_cell("faults", root)


@pytest.fixture(scope="module")
def survey_cell(tmp_path_factory):
    import shutil

    root = tmp_path_factory.mktemp("survey")
    shutil.copytree(core.ROOT / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    cfg = core.load_json(core.ROOT / "configs" / "survey_pinhole_loops.json")
    cfg["pipeline"].update(loop_detection_period=6, loop_detection_nh_dist=4)
    (root / "configs" / "survey_pinhole_loops.json").write_text(json.dumps(cfg))
    wl = core.load_json(core.ROOT / "workloads" / "survey60-lawnmower.json")
    wl.update(name="survey-faults", maps=1, warmup_frames=12,
              flight={"num_images": 24, "num_points": 2880, "relief": 10.0, "rows": 4,
                      "extent": None, "seed": 13})
    # The cell's floor of closures is set for its 60 frames; this flight
    # closes 126 on the CPU, 36 of them without the sweep.
    wl["limits"]["closures_min"] = 80
    (root / "workloads" / "survey-faults.json").write_text(json.dumps(wl))
    return core.load_cell("survey-faults", root)


def _run(cell):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    result, _, _ = core.execute(cell, 7, 0.1, False, torch.device("cpu"))
    return result


def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]


def _unchanged(monkeypatch):
    from mavmap_tpu_torch.sfm import SequentialMapper

    monkeypatch.setattr(SequentialMapper, "apply_ba_result", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from mavmap_tpu_torch.sfm import SequentialMapper

    left_out = set()
    chain, process = SequentialMapper.process_chain_k, SequentialMapper.process

    def half_chain(self, idxs, prev, options, **kw):
        if idxs[0] in left_out:
            return [False] * len(idxs)
        keep = max(len(idxs) // 2, 1)
        left_out.update(idxs[keep:])
        oks = list(chain(self, idxs[:keep], prev, options, **kw)) if keep >= 2 else [
            process(self, idxs[0], prev, options)]
        return oks + [False] * (len(idxs) - keep)

    def refuse(self, idx, prev, options, **kw):
        return False if idx in left_out else process(self, idx, prev, options, **kw)

    monkeypatch.setattr(SequentialMapper, "process_chain_k", half_chain)
    monkeypatch.setattr(SequentialMapper, "process", refuse)


def _altered(monkeypatch):
    from mavmap_tpu_torch.sfm import SequentialMapper

    apply = SequentialMapper.apply_ba_result

    def moved(self, image_ids, poses, point_ids, points, point_errors=None):
        return apply(self, image_ids, poses, point_ids, np.asarray(points) + np.float32(0.05),
                     point_errors)

    monkeypatch.setattr(SequentialMapper, "apply_ba_result", moved)


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _altered],
                         ids=["state-unchanged", "half-the-batch", "answer-altered"])
def test_fault_is_not_correct(cell, monkeypatch, plant):
    plant(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]


def test_sound_survey_run_is_correct(survey_cell):
    r = _run(survey_cell)
    assert r["correct"], r["checks"]


def _closures_dropped(monkeypatch):
    from mavmap_tpu_torch.sfm import SequentialMapper

    detect, sweep = SequentialMapper.detect_loop, SequentialMapper.batch_detect_closures

    def no_commit(fn):
        def found_none(self, *a, **kw):
            commit = self._register_commit
            self._register_commit = lambda *a, **kw: False
            try:
                return fn(self, *a, **kw)
            finally:
                del self._register_commit
        return found_none

    monkeypatch.setattr(SequentialMapper, "detect_loop", no_commit(detect))
    monkeypatch.setattr(SequentialMapper, "batch_detect_closures", no_commit(sweep))


def _sweep_skipped(monkeypatch):
    from mavmap_tpu_torch.sfm import pipeline

    monkeypatch.setattr(pipeline, "_final_closure_sweeps", lambda *a, **kw: 0)


@pytest.mark.parametrize("plant", [_closures_dropped, _sweep_skipped],
                         ids=["closures-dropped", "sweep-skipped"])
def test_survey_fault_is_not_correct(survey_cell, monkeypatch, plant):
    plant(monkeypatch)
    r = _run(survey_cell)
    assert not r["correct"], r["checks"]
