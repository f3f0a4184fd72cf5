"""The harness on the CPU: its arguments, its result line, BENCHMARK.json
against the contract's characters and the files it names, the whole-map
window, and the guard against JAX."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from sfmbench import core, run

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_parser_takes_the_drivers_arguments():
    a = run.parse_args(["--workload", "uav30-chained", "--seed", str(2 ** 31 + 77),
                        "--seconds", "40", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("uav30-chained", 2 ** 31 + 77, 40.0, 1)


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--seconds", "40", "--trace", "0"],
    ["--workload", "x", "--seconds", "40", "--trace", "0"],
    ["--workload", "x", "--seed", "1", "--seconds", "40", "--trace", "2"],
    ["--workload", "x", "--seed", "1", "--seconds", "0", "--trace", "0"],
    ["--workload", "x", "--seed", "one", "--seconds", "40", "--trace", "0"],
], ids=["no-workload", "no-seed", "trace-2", "no-seconds", "seed-not-whole"])
def test_parser_refuses(argv):
    with pytest.raises(SystemExit):
        run.parse_args(argv)


def test_benchmark_json_keys_and_characters():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sfmbench"] and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                                   for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        assert c["file"].startswith("sfmbench/") and PATH.match(c["file"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert list(e2e) == list(core.END_TO_END)
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert core.UNITS[m["name"]] == m["unit"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_full_check_fits_the_day():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s per cell and 1200
    s spare fit 43200 s with the 24 cells later PRs may reach."""
    cells, r = 24, BENCH["run_seconds"]
    assert (2 + 14 * cells) * (r + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves(cell):
    c = core.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["name"] == cell == entry["traffic"]
    assert c.workload["config"] == entry["config"] == c.config["name"]
    conf = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert (REPO / conf["file"]).resolve() == core.ROOT / "configs" / f"{conf['name']}.json"
    assert conf["reduced"] == c.config["reduced"] and conf["source"] == c.config["source"]
    for fn in ("prepare", "warmup", "map_once"):
        assert callable(getattr(c.driver, fn))
    assert set(c.workload["limits"]) <= {"missing_frames", "maps_max", "ate_worst_m",
                                         "reproj_worst_px", "closures_min"}
    # Each per-layer metric listed for this cell has a reader that runs here.
    listed = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert listed == {r.name for r in c.readers}


def test_per_layer_entries_follow_their_readers():
    drivers = {w["name"]: core.load_cell(w["name"]).config["driver"] for w in BENCH["workloads"]}
    readers = {r.name: r for r in core.load_readers()}
    assert {m["name"] for m in BENCH["per_layer"]} == set(readers)
    layers = {}
    for m in BENCH["per_layer"]:
        r = readers[m["name"]]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            r.unit, r.better, r.source, r.layer, r.moves)
        assert m["moves"] in core.END_TO_END and m["moves"] != "setup_s"
        assert m["workloads"] == [c for c, d in drivers.items() if d in r.drivers]
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_window_takes_whole_maps():
    now = [0.0]

    def clock():
        return now[0]

    def mapper(dur):
        def map_once(k):
            now[0] += dur
            return core.MapRecord(wall_s=dur, offered=1, registered=1, counters={},
                                  timings={}, stats={})
        return map_once

    assert len(core.run_window(mapper(11.0), 40.0, 9, clock)) == 3   # 33 + 11 > 40
    now[0] = 0.0
    assert len(core.run_window(mapper(30.0), 40.0, 9, clock)) == 1   # always one
    now[0] = 0.0
    assert len(core.run_window(mapper(100.0), 40.0, 9, clock)) == 1
    now[0] = 0.0
    assert len(core.run_window(mapper(1.0), 40.0, 5, clock)) == 5    # inputs made for 5


@pytest.mark.parametrize("names,found", [
    (["mavmap_tpu_torch", "mavmap_tpu_torch.sfm.mapper", "numpy", "torch"], []),
    (["mavmap_tpu", "mavmap_tpu_torch"], ["mavmap_tpu"]),
    (["mavmap_tpu.sfm.mapper"], ["mavmap_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "mavmap_tpu_tools"], []),
], ids=["port", "jax-package", "jax-package-submodule", "jax", "prefixes"])
def test_forbidden_names_are_whole_top_level_names(names, found):
    assert core.forbidden_modules(names) == found


def test_nothing_the_harness_imports_loads_jax():
    """Import every module of the benchmark and the port's entries a run
    uses in a fresh process, and look at what it holds."""
    mods = ["sfmbench.run", "sfmbench.core", "sfmbench.readings", "sfmbench.drivers.chained",
            "sfmbench.drivers.pipeline", "mavmap_tpu_torch.sfm.pipeline",
            "mavmap_tpu_torch.ops.cuda.match", "mavmap_tpu_torch.ops.cuda.ba_accum"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from sfmbench import core\n"
            "core.load_readers()\n"
            "print(json.dumps(core.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_port():
    code = ("import json, sys\n"
            "import sfmbench.reference.scene, sfmbench.reference.judge, "
            "sfmbench.reference.roofline\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & {"mavmap_tpu_torch", "mavmap_tpu", "jax", "torch"}


def test_nothing_reads_the_old_benchmarks():
    pattern = re.compile(r"^\s*(from|import)\s+benchmarks\b|['\"]benchmarks/", re.M)
    for p in core.ROOT.rglob("*.py"):
        if p.parent.name != "tests":
            assert not pattern.search(p.read_text()), p


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "uav30-chained", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_run_refuses_an_unknown_cell():
    with pytest.raises(FileNotFoundError):
        run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1",
                  "--trace", "0"])


class _Event:
    def __init__(self, name, t0, dur, device="DeviceType.CUDA"):
        self._n, self._t0, self._d, self._dev = name, t0, dur, device

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._d


def test_reduce_trace_busy_gaps_and_hand_kernels():
    spans = core.Spans()
    spans.done += [("register", 1000, 5000, 0), ("global_ba", 6000, 9000, 0),
                   ("window_ba", 7000, 8000, 1)]
    ev = [_Event("match_tile_kernel<true>", 1100, 100), _Event("aten::add", 1150, 100),
          _Event("void seg_rows_kernel<false, false>(...)", 4900, 200),
          _Event("cudaLaunchKernel", 2000, 3000, device="DeviceType.CPU"),
          _Event("gemm", 9500, 1000)]
    r = core.reduce_trace(ev, 1000, 10000, spans, [(3.35e3, 0)])
    assert r["busy_s"] == pytest.approx((150 + 200 + 500) / 1e9)
    assert r["window_s"] == pytest.approx(9000 / 1e9)
    assert r["hand_kernel_s"] == pytest.approx(300 / 1e9)
    assert r["hand_bound_s"] == pytest.approx(1e-9)
    # Gaps 1000-1100 and 1250-4900 lie in `register`, 5100-9500 in
    # `window_ba` (the innermost span at its middle).
    idle = {n: round(g * 1e9) for n, g in r["idle_gaps"]}
    assert idle == {"register": 100 + 3650, "window_ba": 4400}
    assert list(idle) == ["window_ba", "register"]
    assert r["longest_gap_s"] == pytest.approx(4400 / 1e9)
    assert r["device_ops"][0][0] == "gemm"
    assert [n for n, _ in r["device_ops"]][1:3] == ["seg_rows_kernel<false, false>",
                                                   "match_tile_kernel<true>"]


def _result_keys(result, trace):
    keys = list(result)
    assert keys[:5] == list(core.RESULT_KEYS) and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}


@pytest.fixture
def tiny_cell(tmp_path):
    import shutil

    for d in ("configs", "metrics"):
        shutil.copytree(core.ROOT / d, tmp_path / d)
    (tmp_path / "workloads").mkdir()
    wl = core.load_json(core.ROOT / "workloads" / "uav30-chained.json")
    wl.update(name="tiny", maps=1, warmup_frames=5,
              flight={"num_images": 8, "num_points": 1200, "relief": 10.0, "rows": 1,
                      "seed": 11})
    (tmp_path / "workloads" / "tiny.json").write_text(json.dumps(wl))
    return core.load_cell("tiny", tmp_path)


def test_result_line_schema_on_the_cpu(tiny_cell):
    import torch

    result, lines, found = core.execute(tiny_cell, 3, 0.1, False, torch.device("cpu"))
    _result_keys(result, trace=False)
    assert set(result["metrics"]) == set(core.END_TO_END)
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] == 8 and found == []
    assert len(lines) == len(result["checks"])
    json.dumps(result)


def test_run_refuses_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    prints no result and exits non-zero."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(core.ROOT, tmp_path / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "sfmbench.run", "--workload", "uav30-chained",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == "" and "missing" in p.stderr
