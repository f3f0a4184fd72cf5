"""The port's spans and host-sync counter (mavmap_tpu_torch/utils/timer.py)
on the CPU:

  - spans nest, each record naming its parent and depth, on time.time_ns()
    inside a bracket taken around them;
  - with recording off nothing is recorded and counters still take each
    span's inclusive seconds; a span outside every mapper's span does
    nothing; syncs go to the innermost span, and inside "ba.*" spans also
    to ba_host_syncs;
  - a small map through process_initial / process_chain_k / process with
    deferred window solves, and through run_pipeline with loop detection
    and a closure sweep, fills the registration and BA counters
    (reg_prepare_s, reg_dispatch_s, reg_pose_lm_s, reg_wait_s,
    reg_commit_s, ba_apply_s, host_syncs, ba_host_syncs) with the
    registration spans summing to no more than the steps' wall time, keeps
    every counter and stage timing that the benchmark and the smoke read,
    and records, with recording on, registration spans that are disjoint
    within a step, enclose no solve, and lie inside their parents;
  - a read of a frame's reference feature dumps (`features.read`) counts
    into the mapper whose span is open, else into the provider's totals,
    and a cached frame counts nothing; the CLI over a two-camera rig from
    such dumps reads each frame once, counting every read, and times its
    inputs and outputs (`cli.inputs`, `cli.outputs`) in `CliRun.timings`,
    and opens no span of the feature extraction (`cli.features`,
    `features.decode`, `features.detect`, `features.cache_write`);
  - a `totals` dict that three threads add to holds exactly the sum of
    their spans and counts, and each thread's spans are recorded in a copy
    of the caller's context; the CLI from PNG files decodes, detects and
    caches every frame once on its worker threads, inside `cli.features`,
    before any mapper's span opens, and counts each in `CliRun.timings`.

Imports neither jax nor mavmap_tpu.
"""

import time

import numpy as np
import pytest
import torch

from mavmap_tpu_torch.ba import BAOptions
from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.loop import train_voc_tree
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.utils import timer
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAP, TRIALS = 256, 128
NEW = ("reg_prepare_s", "reg_dispatch_s", "reg_pose_lm_s", "reg_wait_s", "reg_commit_s",
       "ba_apply_s", "host_syncs", "ba_host_syncs")
REGISTER = ("register.prepare", "register.dispatch", "register.wait", "register.commit")
REMOVED = ("detect_register_s", "sweep_register_s", "pull_wait_s")
EXTRACTION = ("cli.features", "features.decode", "features.detect", "features.cache_write")
EXTRACTION_COUNTERS = ("cli.features", "image_decode_s", "image_decodes", "detect_s",
                       "detect_frames", "feature_cache_write_s")


class _Owner:
    def __init__(self):
        self.counters = {}


def test_spans_nest_with_parent_and_depth():
    o = _Owner()
    with timer.recording() as recs:
        with timer.span("a", "a_s", o):
            with timer.span("b"):
                with timer.span("c", "c_s"):
                    pass
            with timer.span("d"):
                pass
    assert [(r[0], r[3], r[4]) for r in recs] == [
        ("c", 2, "b"), ("b", 1, "a"), ("d", 1, "a"), ("a", 0, None)]
    assert set(o.counters) == {"a_s", "c_s"}
    assert o.counters["a_s"] >= o.counters["c_s"] > 0


def test_recorded_times_fall_inside_a_time_ns_bracket():
    o = _Owner()
    with timer.recording() as recs:
        t0 = time.time_ns()
        with timer.span("outer", owner=o):
            with timer.span("inner"):
                time.sleep(0.002)
        t1 = time.time_ns()
    (inner, i0, i1, *_), (outer, o0, o1, *_) = recs
    assert (inner, outer) == ("inner", "outer")
    assert t0 <= o0 <= i0 <= i1 <= o1 <= t1
    assert i1 - i0 >= 2_000_000


def test_recording_off_records_nothing_and_counts_inclusive_seconds():
    o, timings = _Owner(), {}
    with timer.recording() as recs:
        pass
    with timer.span("outer", "outer_s", o):
        with timer.span("inner", "inner_s"):
            time.sleep(0.002)
        with timer.span("stage", "stage", totals=timings):
            time.sleep(0.001)
        timer.sync(2)
    assert recs == []
    assert o.counters["inner_s"] >= 0.002
    assert o.counters["outer_s"] >= o.counters["inner_s"] + timings["stage"]
    assert timings["stage"] >= 0.001 and "stage" not in o.counters
    assert o.counters["host_syncs"] == 2 and "ba_host_syncs" not in o.counters
    with pytest.raises(RuntimeError):
        with timer.recording(), timer.recording():
            pass


def test_spans_outside_a_mapper_do_nothing():
    with timer.recording() as recs:
        with timer.span("register.pose_lm", "reg_pose_lm_s"):
            timer.sync()
    assert recs == []


def test_syncs_go_to_the_innermost_span():
    o = _Owner()
    with timer.recording() as recs:
        with timer.span("register.wait", "reg_wait_s", o):
            timer.sync()
            with timer.span("ba.solve", "ba_solve_s", o):
                with timer.span("ba.lm"):
                    timer.sync(3)
                timer.sync()
    syncs = {r[0]: r[5] for r in recs}
    assert syncs == {"ba.lm": 3, "ba.solve": 1, "register.wait": 1}
    assert o.counters["host_syncs"] == 5 and o.counters["ba_host_syncs"] == 4


@pytest.fixture(scope="module")
def strip():
    scene = make_uav_scene(num_images=10, num_points=1600, relief=10.0, seed=2)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=2, max_features=CAP)
    return scene, feats


def _check_records(recs):
    """Registration spans of one step are disjoint and hold no BA solve;
    every record lies inside a record of its parent's name."""
    by_name = {}
    for r in recs:
        by_name.setdefault(r[0], []).append(r)
    for name, t0, t1, depth, parent, _ in recs:
        if parent is not None:
            assert any(p0 <= t0 and t1 <= p1 for _, p0, p1, *_ in by_name[parent]), name
        if name in REGISTER:
            assert parent not in REGISTER, (name, parent)
    for name in ("ba.solve", "ba.selfcal", "ba.apply"):
        for r in by_name.get(name, []):
            assert r[4] not in REGISTER + ("register.pose_lm",), r


def test_chained_map_fills_the_registration_counters(strip):
    scene, feats = strip
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=CAP), device=CPU, seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, essential_ransac_trials=TRIALS,
                                   p3p_ransac_trials=TRIALS)
    window = BAOptions(max_num_iterations=4, refine_camera_params=True)
    wall = 0.0
    with timer.recording() as recs:
        t0 = time.perf_counter()
        assert m.process_initial(0, 1, SequentialMapperOptions(
            tri_min_angle=4.0, essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS))
        assert m.process_chain_k([2, 3, 4, 5], 1, opts, pad_to=4) == [True] * 4
        wall += time.perf_counter() - t0
        m.adjust_bundle([2, 3, 4, 5], [0, 1], ba_options=window, async_=True, defer=True)
        t0 = time.perf_counter()
        assert m.process_chain_k([6, 7, 8], 5, opts, pad_to=4) == [True] * 3
        wall += time.perf_counter() - t0
        m.adjust_bundle([4, 5, 6, 7, 8], [2, 3], ba_options=window, async_=True, defer=True)
        t0 = time.perf_counter()
        assert m.process(9, 8, opts)
        wall += time.perf_counter() - t0
        m.flush_ba()
        m.adjust_global_bundle(BAOptions(max_num_iterations=3, refine_camera_params=True,
                                         selfcal_max_obs=500))
    c = m.counters
    assert all(c[k] > 0 for k in NEW), {k: c.get(k) for k in NEW}
    for k in ("ba_solve_s", "ba_selfcal_s", "ba_iters", "ba_selfcal_iters", "pulls", "chains"):
        assert c[k] > 0, k
    assert not set(REMOVED) & set(c)
    reg = sum(c[k] for k in ("reg_prepare_s", "reg_dispatch_s", "reg_wait_s", "reg_commit_s"))
    assert reg <= wall
    assert c["reg_pose_lm_s"] <= c["reg_dispatch_s"]
    assert c["ba_host_syncs"] < c["host_syncs"]
    _check_records(recs)
    names = {r[0] for r in recs}
    assert set(REGISTER) | {"register.pose_lm", "ba.solve", "ba.selfcal", "ba.apply",
                            "ba.plans", "ba.lm"} <= names
    assert sum(r[5] for r in recs) == c["host_syncs"]


def test_pipeline_map_fills_the_registration_counters():
    # tests/test_torch_pipeline.py's survey.
    scene = make_uav_scene(num_images=16, num_points=2400, relief=10.0, rows=2, extent=None,
                           seed=13)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=20, seed=13, max_features=512)
    desc = np.concatenate([d for _, d in feats[::3]])
    tree = train_voc_tree(desc[np.random.default_rng(0).permutation(len(desc))[:2000]],
                          branching=4, depth=2, iters=3, device=CPU)
    opts = tpipe.PipelineOptions(
        verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
        loop_detection_period=4, loop_detection_nh_dist=3, loop_detection_num_images=6,
        final_closure_sweeps=1, final_closure_step=2, chain_len=4, ba_local_max_iters=4,
        essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)
    with timer.recording() as recs:
        t0 = time.perf_counter()
        res = tpipe.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                                 ArrayFeatureProvider(feats, capacity=512), opts,
                                 voc_tree=tree, device=CPU)
        wall = time.perf_counter() - t0
    assert len(res.mappers) == 1 and res.main_mapper.num_proc_images == 16
    c = res.main_mapper.counters
    assert all(c[k] > 0 for k in NEW), {k: c.get(k) for k in NEW}
    for k in ("ba_solve_s", "ba_iters", "batch_register_s", "batch_register_slots",
              "detect_query_s", "detect_pregate_s", "sweep_retrieval_s", "sweep_pregate_s",
              "seq_chain_s", "seq_localba_s", "seq_detect_s"):
        assert c[k] > 0, k
    assert c.get("loop_closures", 0) + c.get("sweep_closures", 0) > 0
    assert not set(REMOVED) & set(c)
    assert {"sequential_loop", "backfill", "global_ba", "closure_sweeps"} <= set(res.timings)
    reg = sum(c[k] for k in ("reg_prepare_s", "reg_dispatch_s", "reg_wait_s", "reg_commit_s"))
    assert reg <= res.timings["sequential_loop"] + res.timings["backfill"] \
        + res.timings["closure_sweeps"] <= wall
    _check_records(recs)
    assert {"pipeline.sequential_loop", "pipeline.closure_sweeps", "loop.detect",
            "loop.query", "loop.chain", "loop.local_ba", "batch.step"} <= {r[0] for r in recs}


def test_owner_counters_are_the_innermost_owners():
    o, totals = _Owner(), {}
    assert timer.owner_counters() is None and timer.owner_counters(totals) is totals
    with timer.span("register.prepare", "reg_prepare_s", o):
        with timer.span("ba.lm"):
            assert timer.owner_counters(totals) is o.counters
    assert timer.owner_counters(totals) is totals


def _dumps(tmp_path, n, rows=40):
    import chip_smoke

    rng = np.random.default_rng(5)
    for i in range(n):
        chip_smoke.write_feature_dump(str(tmp_path), f"img{i}", rng.uniform(0, 800, (rows, 2)),
                                      rng.normal(size=(rows, 128)),
                                      np.linspace(1.0, 0.5, rows).astype(np.float32))
    return [f"img{i}" for i in range(n)]


def test_feature_reads_count_into_the_owner_or_the_totals(tmp_path):
    from mavmap_tpu_torch.features import ReferenceCacheProvider

    totals, o = {}, _Owner()
    prov = ReferenceCacheProvider(str(tmp_path), _dumps(tmp_path, 3), capacity=64,
                                  totals=totals)
    with timer.recording() as recs:
        prov.get(0)
        with timer.span("register.prepare", "reg_prepare_s", o):
            prov.get(1)
            prov.get(2)
            prov.get(0)  # cached: no read
        prov.get(2)
    assert totals["feature_reads"] == 1 and totals["feature_read_s"] > 0
    assert o.counters["feature_reads"] == 2
    assert 0 < o.counters["feature_read_s"] <= o.counters["reg_prepare_s"]
    assert [(r[0], r[4]) for r in recs if r[0] == "features.read"] == [
        ("features.read", None), ("features.read", "register.prepare"),
        ("features.read", "register.prepare")]
    # Without totals of its caller's, the provider keeps its own.
    alone = ReferenceCacheProvider(str(tmp_path), ["img0"], capacity=64)
    alone.get(0)
    assert alone.totals["feature_reads"] == 1


def test_cli_counts_every_feature_read_and_times_its_files(tmp_path):
    import chip_smoke
    from mavmap_tpu_torch import cli
    from mavmap_tpu_torch.utils.synthetic import make_multi_camera_scene

    n = 8
    scene = make_multi_camera_scene(num_images=n, num_points=2000, relief=10.0, rows=1, seed=9)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=10, seed=9, max_features=CAP)
    chip_smoke.write_rig_files(str(tmp_path), scene, feats)
    with timer.recording() as recs:
        run = cli.run(["--input-path", str(tmp_path / "data"),
                       "--output-path", str(tmp_path / "out"),
                       "--reference-cache-path", str(tmp_path / "ref"), "--max-features",
                       str(CAP), "--min-track-len", "2", "--tri-min-angle", "1.0",
                       "--init-tri-min-angle", "4.0", "--device", "cpu", "--quiet"])
    assert run.rc == 0 and run.result.main_mapper.num_proc_images == n
    reads = run.timings.get("feature_reads", 0) + sum(
        m.counters.get("feature_reads", 0) for m in run.result.mappers)
    assert reads == n
    assert run.timings["cli.inputs"] > 0 and run.timings["cli.outputs"] > 0
    assert not {"cli.inputs", "cli.outputs"} & set(run.result.timings)
    # From dumps there is no extraction stage: none of its spans or counters.
    assert not set(EXTRACTION) & {r[0] for r in recs}
    assert not set(EXTRACTION_COUNTERS) & set(run.timings)
    for m in run.result.mappers:
        assert not set(EXTRACTION_COUNTERS) & set(m.counters)


class _Clock:
    """time.perf_counter / time.time_ns that step by exactly 0.5 s on each
    call of the thread that calls them."""

    def __init__(self):
        import threading

        self.local = threading.local()

    def _tick(self):
        self.local.t = getattr(self.local, "t", 0.0) + 0.5
        return self.local.t

    def perf_counter(self):
        return self._tick()

    def time_ns(self):
        return int(self._tick() * 1e9)


def test_totals_shared_by_threads_add_up_exactly(monkeypatch):
    import contextvars
    import sys
    import threading

    monkeypatch.setattr(timer, "time", _Clock())
    totals, n = {}, 4000

    def work():
        for _ in range(n):
            with timer.span("features.decode", "image_decode_s", totals=totals):
                pass
            timer.add_total(totals, "image_decodes")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.recording() as recs, timer.span("cli.features", "cli.features",
                                                   totals=totals):
            threads = [threading.Thread(target=contextvars.copy_context().run, args=(work,))
                       for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert totals["image_decodes"] == 3 * n
    # Each span spans one clock step of its own thread: 0.5 s exactly.
    assert totals["image_decode_s"] == 0.5 * 3 * n
    decodes = [r for r in recs if r[0] == "features.decode"]
    assert len(decodes) == 3 * n
    assert {(r[3], r[4]) for r in decodes} == {(1, "cli.features")}


def test_cli_extracts_every_frame_once_before_mapping(tmp_path):
    from mavmap_tpu_torch import cli
    from mavmap_tpu_torch.utils.imageio import write_png
    from mavmap_tpu_torch.utils.synthetic import render_images

    n = 5
    scene = make_uav_scene(num_images=n, num_points=1500, relief=10.0, rows=1, seed=21,
                           image_size=(400, 300), focal=350.0)
    data = tmp_path / "data"
    data.mkdir()
    lines = ["# imagedata"]
    for i, im in enumerate(render_images(scene, texture_contrast=0.25, seed=21)):
        write_png(str(data / f"img{i}.png"), im)
        cam_def = ", 1, PINHOLE, 350.0, 350.0, 200.0, 150.0" if i == 0 else ""
        lines.append(f"img{i}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0{cam_def}")
    (data / "imagedata.txt").write_text("\n".join(lines) + "\n")
    with timer.recording() as recs:
        run = cli.run(["--input-path", str(data), "--output-path", str(tmp_path / "out"),
                       "--max-features", "512", "--min-track-len", "2",
                       "--init-tri-min-angle", "2.0", "--ransac-min-inlier-threshold", "15",
                       "--device", "cpu", "--quiet"])
    assert run.rc == 0
    t = run.timings
    assert t["image_decodes"] == t["detect_frames"] == n
    assert 0 < t["image_decode_s"] and 0 < t["detect_s"] and 0 < t["feature_cache_write_s"]
    assert t["cli.features"] <= run.detection_s
    for m in run.result.mappers:
        assert not set(EXTRACTION_COUNTERS) & set(m.counters)
    names = [r[0] for r in recs]
    assert names.count("features.decode") == names.count("features.detect") == n
    assert names.count("features.cache_write") == n and names.count("cli.features") == 1
    # Every extraction span lies in cli.features, which closes before the
    # first span of the mapping opens.
    (stage,) = [r for r in recs if r[0] == "cli.features"]
    inner = [r for r in recs if r[0] in EXTRACTION[1:]]
    assert all(r[4] == "cli.features" and stage[1] <= r[1] <= r[2] <= stage[2] for r in inner)
    mapping = [r for r in recs if r[0] not in EXTRACTION and not r[0].startswith("cli.")]
    assert mapping and stage[2] <= min(r[1] for r in mapping)
    assert sum(r[2] - r[1] for r in inner if r[0] == "features.detect") == pytest.approx(
        t["detect_s"] * 1e9, rel=0.01)

