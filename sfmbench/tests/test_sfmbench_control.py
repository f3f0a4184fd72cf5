"""The control of the checks at a size a test run holds: on a short
two-strip flight the program's map passes every limit of the cell it is
cut from, and the same map with its poses, points and intrinsics held in
bfloat16 (the precision below the configurations' float32) fails one.
The cells' own readings, at their own sizes on the card, come from
`python3 -m sfmbench.readings` (PERF.md gives them)."""

import json

import pytest
import torch

from sfmbench import core, readings


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    import shutil

    root = tmp_path_factory.mktemp("cell")
    for d in ("configs", "metrics"):
        shutil.copytree(core.ROOT / d, root / d)
    (root / "workloads").mkdir()
    wl = core.load_json(core.ROOT / "workloads" / "uav30-chained.json")
    wl.update(name="control", maps=1, warmup_frames=6,
              flight={"num_images": 12, "num_points": 1600, "relief": 10.0, "rows": 2,
                      "seed": 11})
    (root / "workloads" / "control.json").write_text(json.dumps(wl))
    return core.load_cell("control", root)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_is_not_correct(cell, seed):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    program, control = readings.read_seed(cell, seed, torch.device("cpu"), core.Spans())
    assert (program["mode"], control["mode"]) == ("program", "control_bf16")
    limits = cell.workload["limits"]
    ok, checks = core.check(program, limits)
    assert ok, checks
    ok, checks = core.check(control, limits)
    assert not ok, checks
