"""The harness: one run of one cell, driven by the files that name it.

A cell `<name>` is `workloads/<name>.json` (the flight, its noise, the
window's map limit and the limits of the numbers compared); the file names
its configuration, `configs/<config>.json` (the deployment: the driver of
the port's entry point, the mapper and BA options, its source and cuts);
the driver is `drivers/<driver>.py`; each per-layer metric is
`metrics/<metric>.py`, run where its DRIVERS include the cell's driver.
New cells, configurations and metrics are new files: nothing here names
one.

A run: set-up (the card, the kernels' build or load, the inputs, the
driver's own set-up and its warm-up map), the window (whole maps, another
only while the mean map still fits before --seconds), then, with the
program's state copied out and freed, the reference's judgement, the
metrics and the result line.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .reference import judge, scene as ref_scene

ROOT = Path(__file__).resolve().parent
# Top-level module names that no run may hold: JAX, its libraries and the
# JAX package the port was made from. Compared whole: the port's own name
# begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "mavmap_tpu")
# The system under test: the PyTorch and CUDA port.
PROGRAM = "mavmap_tpu_torch"
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
END_TO_END = ("frames_per_s", "ate_m", "setup_s")
UNITS = {"frames_per_s": "frames/s", "ate_m": "m", "setup_s": "s"}


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (default: the modules
    this process holds)."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Reader:
    """A per-layer metric's reader, from metrics/<name>.py."""

    name: str
    unit: str
    layer: str
    moves: str
    better: str
    source: str
    drivers: tuple
    read: object


def load_reader(path):
    spec = importlib.util.spec_from_file_location(f"sfmbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return Reader(name=path.stem, unit=mod.UNIT, layer=mod.LAYER, moves=mod.MOVES,
                  better=mod.BETTER, source=mod.SOURCE, drivers=tuple(mod.DRIVERS),
                  read=mod.read)


def load_readers(root=ROOT):
    return [load_reader(p) for p in sorted((root / "metrics").glob("*.py"))]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    driver: object
    readers: list


def load_cell(name, root=ROOT):
    """The cell named `name`, from its workload file; raises
    FileNotFoundError or KeyError where a file or key is missing."""
    workload = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{workload['config']}.json")
    driver = importlib.import_module(f"sfmbench.drivers.{config['driver']}")
    readers = [r for r in load_readers(root) if config["driver"] in r.drivers]
    return Cell(name=name, workload=workload, config=config, driver=driver, readers=readers)


class Spans:
    """The harness's spans around its calls into the port: (name, start,
    end) on the wall clock in ns (the profiler's clock), nested, kept in
    memory."""

    def __init__(self):
        self.stack = []
        self.done = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time_ns()
        self.stack.append(name)
        try:
            yield
        finally:
            self.stack.pop()
            self.done.append((name, t0, time.time_ns(), len(self.stack)))


@dataclass
class MapRecord:
    """One map of the window: its wall seconds (entry call to the last
    global BA, synchronised), frames offered, the program's counters and
    stage timings, driver statistics and the map as the program left it."""

    wall_s: float
    offered: int
    registered: int
    counters: dict
    timings: dict
    stats: dict
    state: object = None


@dataclass
class Run:
    """What the metric readers see."""

    maps: list
    spans: Spans
    trace: dict = field(default_factory=dict)

    @property
    def offered(self):
        return sum(m.offered for m in self.maps)

    def counter(self, name):
        return sum(m.counters.get(name, 0) for m in self.maps)


def run_window(map_once, seconds, max_maps, clock=time.perf_counter):
    """Whole maps: always one; another only while the mean map so far still
    fits before `seconds`, and at most `max_maps` (the workload's flights).
    Returns the records."""
    records = []
    t0 = clock()
    while True:
        records.append(map_once(len(records)))
        mean = statistics.fmean(r.wall_s for r in records)
        if len(records) >= max_maps or clock() - t0 + mean > seconds:
            return records


def judge_values(records, scene, keypoints):
    """The reference's numbers over the window's maps (keypoints: per map,
    per image, as handed to the program); returns (values, pooled ATE)."""
    judged = [judge.judge_map(r.state, scene, keypoints[k], r.offered)
              for k, r in enumerate(records)]
    values = {
        "missing_frames": sum(j["missing"] for j in judged),
        "maps_max": max(j["maps"] for j in judged),
        "ate_worst_m": max(j["ate_m"] for j in judged),
        "reproj_worst_px": max(j["reproj_rmse_px"] for j in judged),
        "closures_min": min(j["closures"] for j in judged),
    }
    return values, judge.pooled_ate(judged)


def check(values, limits):
    """Each number a workload limits beside its limit (a `_min` name is a
    floor, any other a ceiling); returns (correct, checks)."""
    checks, correct = {}, True
    for name, lim in limits.items():
        value = values[name]
        ok = value >= lim if name.endswith("_min") else value <= lim
        checks[name] = {"value": value, "limit": lim}
        correct &= bool(ok) and bool(np.isfinite(value))
    return correct, checks


def _kernel_wrappers(log):
    """Wrap the port's three CUDA entry points (K1, K2, K3) so each launch
    appends its (bytes, flops) to `log`; returns an undo function."""
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka
    from mavmap_tpu_torch.ops.cuda import match as km

    from .reference import roofline

    orig = (km._match_raw_cuda, ka._seg_accum_full_cuda, ka._seg_accum_sorted_cuda)

    def k1(d1, rowpen, d2, pen2, kp1=None, kp2=None, maxd2=None):
        b1, b2 = d1.dim() == 3, d2.dim() == 3
        B = d1.shape[0] if b1 else (d2.shape[0] if b2 else 1)
        N1, D = d1.shape[-2:]
        log.append(roofline.k1_cost(B, N1, d2.shape[-2], D, not b1, not b2, kp1 is not None))
        return orig[0](d1, rowpen, d2, pen2, kp1, kp2, maxd2)

    def k2(contrib, plan):
        rows, K = int(plan.order.shape[0]), int(contrib.shape[1])
        if plan.sparse:
            n = int(plan.filled.shape[0])
            nbytes, flops = roofline.k2_cost(rows, K, n, n)
            log.append((nbytes + 4 * n, flops))
        else:
            log.append(roofline.k2_cost(rows, K, plan.num_segments))
        return orig[1](contrib, plan)

    def k3(contrib, offsets, num_segments):
        log.append(roofline.k3_cost(int(contrib.shape[0]), int(contrib.shape[1]),
                                    int(num_segments)))
        return orig[2](contrib, offsets, num_segments)

    km._match_raw_cuda, ka._seg_accum_full_cuda, ka._seg_accum_sorted_cuda = k1, k2, k3

    def undo():
        km._match_raw_cuda, ka._seg_accum_full_cuda, ka._seg_accum_sorted_cuda = orig

    return undo


def _event_times(e):
    """(start_ns, duration_ns) of a raw profiler event, across versions."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return 1000 * e.start_us(), 1000 * e.duration_us()


def short_name(name, width=120):
    """A device operation's name without its return type, namespaces and
    arguments, cut to `width` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::"):
        name = name.replace(noise, "")
    cut = name.find("(", 1)
    return (name[:cut] if cut > 0 else name)[:width]


def reduce_trace(events, t_open, t_close, spans, kernel_log, top=10):
    """The traced window's device numbers from the profiler's raw events:
    busy seconds (the union of device activity), the hand kernels' device
    seconds and bound seconds, the device operations that took most time,
    and the idle seconds by what the host was doing: each gap between
    device activity goes to the innermost harness span open at its middle
    ('none' outside every span), and the labels with the most idle time
    come first."""
    from .reference import roofline

    intervals, by_name, hand_ns = [], {}, 0
    for e in events:
        if str(e.device_type()).rsplit(".", 1)[-1] != "CUDA":
            continue
        s, d = _event_times(e)
        if d <= 0 or s + d < t_open or s > t_close:
            continue
        s, t = max(s, t_open), min(s + d, t_close)
        intervals.append((s, t))
        name = e.name()
        by_name[name] = by_name.get(name, 0) + (t - s)
        if roofline.is_hand_kernel(name):
            hand_ns += t - s
    intervals.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, t_open
    for s, t in intervals:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, t_close))

    def label(mid):
        best = None
        for name, t0, t1, depth in spans.done:
            if t0 <= mid <= t1 and (best is None or depth > best[1]):
                best = (name, depth)
        return best[0] if best else "none"

    idle, longest = {}, 0
    for a, b in gaps:
        if b > a:
            lab = label((a + b) // 2)
            idle[lab] = idle.get(lab, 0) + (b - a)
            longest = max(longest, b - a)
    return {
        "busy_s": busy / 1e9,
        "window_s": (t_close - t_open) / 1e9,
        "device_events": len(intervals),
        "longest_gap_s": longest / 1e9,
        "hand_kernel_s": hand_ns / 1e9,
        "hand_bound_s": sum(roofline.bound_s(b, f) for b, f in kernel_log),
        "hand_launches": len(kernel_log),
        "device_ops": [[short_name(n), v / 1e9] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v / 1e9] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


@contextlib.contextmanager
def _traced(torch, state):
    """torch.profiler over the window, device activity alone (the host
    side is the harness's spans); fills `state` with the raw events."""
    from torch.profiler import ProfilerActivity, profile

    log = []
    undo = _kernel_wrappers(log)
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
        torch.cuda.synchronize()
        state["open"] = time.time_ns()
        yield
        torch.cuda.synchronize()
        state["close"] = time.time_ns()
        t0 = time.perf_counter()
        prof.stop()
        state["events"] = prof.profiler.kineto_results.events()
        state["kernel_log"] = log
        state["stop_s"] = time.perf_counter() - t0
    finally:
        undo()


def map_state(mapper, maps, closures):
    """The judged copy of a SequentialMapper's map: registered frames,
    poses, each frame's camera model and parameters, and every observation
    (frame, feature row) of a valid triangulated point of track length >= 2."""
    st = mapper.store
    reg = [iid for iid in range(st.num_images) if st.image_registered[iid]]
    frames = np.array([mapper.image_id_to_idx[i] for i in reg], np.int64)
    p2d3d = np.asarray(st.point2D_point3D)
    valid = (np.asarray(st.point3D_valid) & np.asarray(st.point3D_tri)
             & (np.asarray(st.point3D_track_len) >= 2))
    obs_f, obs_r, obs_p = [], [], []
    for iid, f in zip(reg, frames):
        p = p2d3d[st.point2D_ids_of_image(iid)]
        ok = np.flatnonzero((p >= 0) & valid[np.maximum(p, 0)])
        obs_f.append(np.full(len(ok), f))
        obs_r.append(ok)
        obs_p.append(p[ok])
    obs_p = np.concatenate(obs_p) if obs_p else np.zeros(0, np.int64)
    pids, obs_point = np.unique(obs_p, return_inverse=True)
    return judge.MapState(
        frames=frames, rvecs=np.array(st.image_rvecs[reg], np.float64),
        tvecs=np.array(st.image_tvecs[reg], np.float64),
        cam_params=np.array(st.camera_params[st.image_cameras[reg]], np.float64),
        cam_models=np.array(st.camera_models[st.image_cameras[reg]], np.int32),
        obs_frame=np.concatenate(obs_f) if obs_f else np.zeros(0, np.int64),
        obs_row=np.concatenate(obs_r) if obs_r else np.zeros(0, np.int64),
        obs_point=obs_point.reshape(-1),
        points=np.array(st.point3D_xyz[pids], np.float64), maps=int(maps),
        closures=int(closures))


@dataclass
class Inputs:
    """The run's inputs: the scene and, per map of the run (the warm-up's
    under key -1), the features handed to the program and (`order`) which
    of the workload's flights each map is."""

    scene: object
    feats: dict
    order: list = field(default_factory=list)


def make_inputs(workload, seed, num_maps, config=None):
    """The cell's scene and flights, fixed by the workload and the
    configuration's `cameras` (one PINHOLE camera where it has none): the
    warm-up's features (key -1) and those of its `maps` flights (sensor
    noise, clutter and row order drawn from `data_seed`); map k of a run
    with `--seed seed` is flight map_order(seed)[k]. Makes the first
    `num_maps`."""
    scene = ref_scene.make_uav_scene(**workload["flight"],
                                     cameras=(config or {}).get("cameras"))
    order = ref_scene.map_order(seed, workload["maps"])
    feats = {}
    for k, flight in [(-1, -1)] + list(enumerate(order[:num_maps])):
        feats[k], _ = ref_scene.render_features(
            scene, ref_scene.noise_rng(workload["data_seed"], int(flight)), **workload["noise"])
    return Inputs(scene=scene, feats=feats, order=[int(f) for f in order[:num_maps]])


def execute(cell, seed, seconds, trace, device, t_process=None):
    """One run of `cell` on `device` (set-up timed from `t_process`, by
    default from this call); returns (result, check lines, forbidden
    modules found). On a CUDA device the kernels are built or loaded
    first."""
    import torch

    t_setup0 = time.perf_counter() if t_process is None else t_process
    parts, t_part = {}, [t_setup0]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        part("start_and_cuda")
        from mavmap_tpu_torch import native
        from mavmap_tpu_torch.ops.cuda import build

        build.library()
        native.load_mapstore_lib()
        part("kernels_build_or_load")
    wl = cell.workload
    inputs = make_inputs(wl, seed, wl["maps"], cell.config)
    part("inputs")
    ctx = cell.driver.prepare(cell, inputs, seed, device)
    part("prepare")
    spans = Spans()
    cell.driver.warmup(ctx, spans)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    part("warmup")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_setup0
    spans.done.clear()

    def map_once(k):
        return cell.driver.map_once(ctx, k, spans)

    tstate = {}
    with (_traced(torch, tstate) if trace else contextlib.nullcontext()):
        records = run_window(map_once, seconds, wl["maps"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    del ctx
    if cuda:
        torch.cuda.empty_cache()

    values, ate = judge_values(records, inputs.scene,
                               [[kp for kp, _ in inputs.feats[k]] for k in range(len(records))])
    correct, checks = check(values, wl["limits"])
    total_wall = sum(r.wall_s for r in records)
    registered = sum(r.registered for r in records)
    attempted = sum(r.offered for r in records)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": attempted - registered}
    if trace:
        red = reduce_trace(tstate["events"], tstate["open"], tstate["close"], spans,
                           tstate["kernel_log"])
        red["profiler_stop_s"] = tstate["stop_s"]
        run = Run(maps=records, spans=spans, trace=red)
        metrics = {}
        for r in cell.readers:
            v = r.read(run)
            if v is not None:
                metrics[r.name] = {"value": v, "unit": r.unit}
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result.update(metrics=metrics, device=device_info,
                      breakdown={"device_ops": red["device_ops"],
                                 "idle_gaps": red["idle_gaps"]})
    else:
        result.update(metrics={
            "frames_per_s": {"value": registered / total_wall, "unit": UNITS["frames_per_s"]},
            "ate_m": {"value": ate, "unit": UNITS["ate_m"]},
            "setup_s": {"value": setup_s, "unit": UNITS["setup_s"]}}, device=device_info)
    found = forbidden_modules()
    if found:
        result["correct"] = False
    result["maps"] = [{"flight": f, "wall_s": r.wall_s, "registered": r.registered,
                       "offered": r.offered} for f, r in zip(inputs.order, records)]
    result["setup_parts_s"] = parts
    if trace:
        result["trace"] = {k: red[k] for k in ("device_events", "longest_gap_s",
                                                "hand_kernel_s", "hand_bound_s",
                                                "hand_launches", "profiler_stop_s")}
    result["checks"] = checks
    lines = [f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in checks.items()]
    return result, lines, found
