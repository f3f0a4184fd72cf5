#!/usr/bin/env python3
"""Smoke test of mavmap_tpu_torch on one CUDA GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

 1. device: a CUDA device is required (no CPU fallback); prints the card's
    name and power limit as nvidia-smi reports them;
 2. build: compiles the CUDA kernels of mavmap_tpu_torch/csrc with nvcc;
 3. kernels: holds each kernel against its plain PyTorch version on the
    card at the mapper's shapes, and times both (CUDA events, median after
    warm-up);
 4. main path: the sequential mapper over bench.py's 30-image scene —
    process_initial, process for every later frame with a 10-image
    self-calibrating window bundle adjustment after each success, then one
    global bundle adjustment — checking 30/30 registrations, the ATE
    against ground truth, and that every kernel was launched;
 5. chained: bench.py's own loop (run() without its pipelining option) on
    the same scene — chains of 6 frames through process_chain_k, one
    deferred asynchronous window bundle adjustment per chain, flush_ba and
    the global bundle adjustment — checking 30/30, the ATE and launches;
 6. survey: the same loop over benchmarks/pipeline_scale.py's scene at 200
    images, whose global bundle adjustment (>= 64 cameras) runs the
    matrix-free CG solver — checking the registered count and the ATE
    against the JAX package's on the CPU, and finite output;
 7. kernels at the survey's shapes: K2/K3 at the global problem's
    observation, block and point counts (the CG matvec's 3/6/9 columns and
    the preconditioner's 81), held against their plain versions and timed;
 8. CG against dense: one ~40-camera problem solved by both solvers, with
    and without self-calibration, on the card;
 9. prints the kernels' JSON line, the card line, and last the result line.

The launch counters are zeroed just before each mapping phase (4, 5, 6, 8)
and read just after it. Imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# ATE of the JAX package on the CPU over the same 30-frame per-frame loop
# (recorded in PERF.md): the port must stay within 2x of it.
JAX_CPU_ATE_M = 0.0101
ATE_LIMIT_M = min(0.05, 2.0 * JAX_CPU_ATE_M)
NUM_IMAGES = 30
# The JAX package on the CPU over bench.py's chained loop (mapper seed 0),
# on bench.py's scene and on the 200-image survey (recorded in PERF.md).
# The chained loop must stay under min(0.05, 2x JAX's ATE). The survey is
# held to 2x JAX's ATE alone: without loop closure the JAX package itself
# ends at 0.0518-0.0527 m there (mapper seeds 0-2), above a 0.05 m cap.
JAX_CPU_CHAINED_ATE_M = 0.009436
JAX_CPU_SURVEY_ATE_M = 0.052406
JAX_CPU_SURVEY_REGISTERED = 200
CHAIN = 6
SURVEY_IMAGES = 200


def _phase(name):
    print(f"== {name}", flush=True)


def _time_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_phase():
    import torch

    _phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}; "
          f"nvidia-smi: {smi}", flush=True)
    return torch.device("cuda", 0), name, smi


def build_phase():
    from mavmap_tpu_torch.ops.cuda import build

    _phase("build")
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds}) -> {os.path.relpath(path)}", flush=True)


def _match_inputs(torch, rng, dev, N1, N2, D=128, prefilter=300.0):
    import numpy as np

    d1 = rng.normal(size=(N1, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    perm = rng.permutation(N1)[:N2] if N2 <= N1 else rng.integers(0, N1, N2)
    d2 = d1[perm] + rng.normal(size=(N2, D)).astype(np.float32) * 0.05
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    m1 = rng.random(N1) > 0.05
    m2 = rng.random(N2) > 0.05
    kp1 = (rng.random((N1, 2)) * [800, 600]).astype(np.float32)
    kp2 = kp1[perm] + rng.normal(size=(N2, 2)).astype(np.float32) * 40.0 \
        if N2 <= N1 else (rng.random((N2, 2)) * [800, 600]).astype(np.float32)
    t = [torch.as_tensor(a, device=dev) for a in (d1, d2, m1, m2, kp1, kp2)]
    return t, prefilter


def check_match(torch, dev):
    """K1 at 1024x1024x128 with the prefilter, and ragged 1000x937."""
    import numpy as np
    from mavmap_tpu_torch.ops.cuda import match as km

    rng = np.random.default_rng(0)
    out = {"max_abs_err": 0.0}
    for N1, N2 in ((1024, 1024), (1000, 937)):
        (d1, d2, m1, m2, kp1, kp2), maxd = _match_inputs(torch, rng, dev, N1, N2)
        args = km.padded_operands(d1, d2, m1, m2, kp1, kp2, maxd)
        got = km._match_raw_cuda(*args)
        ref = km.match_raw_plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for arg_i, best_i, second_i in ((0, 1, 2), (3, 4, 5)):
            ga, ra = got[arg_i].long(), ref[arg_i].long()
            gb, rb, rs = got[best_i], ref[best_i], ref[second_i]
            real = rb < 1e29
            d_err = (gb - rb).abs()
            err = max(err, float(d_err[real].max()))
            if not torch.equal(gb[~real], rb[~real]):
                raise AssertionError(f"K1 {N1}x{N2}: masked distances differ")
            if float(d_err[real].max()) > 1e-5:
                raise AssertionError(f"K1 {N1}x{N2}: distance error {float(d_err.max())}")
            s_err = (got[second_i] - rs).abs()[rs < 1e29]
            if s_err.numel() and float(s_err.max()) > 1e-5:
                raise AssertionError(f"K1 {N1}x{N2}: second-distance error {float(s_err.max())}")
            bad = ga != ra
            near_tie = (rs - rb) <= 1e-5
            if bool((bad & ~near_tie).any()):
                raise AssertionError(
                    f"K1 {N1}x{N2}: {int((bad & ~near_tie).sum())} indices differ off near-ties")
        # The whole matcher (ratio test + cross-check) on the card vs the CPU.
        mk, ok_k = km.match_brute_force_cuda(d1, d2, m1, m2, kp1, kp2, max_distance=maxd)
        mc, ok_c = km.match_brute_force_cuda(d1.cpu(), d2.cpu(), m1.cpu(), m2.cpu(),
                                             kp1.cpu(), kp2.cpu(), max_distance=maxd)
        n_diff = int((mk.cpu() != mc).sum())
        if n_diff > max(2, N1 // 200):
            raise AssertionError(f"K1 {N1}x{N2}: {n_diff} final matches differ from the CPU")
        ms = _time_ms(lambda: km._match_raw_cuda(*args))
        plain_ms = _time_ms(lambda: km.match_raw_plain(*args))
        print(f"K1 match {N1}x{N2}x128 prefilter {maxd:.0f}px: max_abs_err {err:.3g}, "
              f"{int(ok_k.sum())} matches ({n_diff} differ from CPU), "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if (N1, N2) == (1024, 1024):
            out["ms"], out["plain_ms"] = ms, plain_ms
    return out


def _seg_err(got, ref, scale):
    rel = (got - ref).abs() / (scale + 1e-30)
    return float((got - ref).abs().max()), float(rel.max())


def check_seg_full(torch, dev):
    """K2 at the selfcal window/global shapes (unsorted ids)."""
    import numpy as np
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka

    rng = np.random.default_rng(1)
    out = {"max_abs_err": 0.0}
    for O, K, S in ((8192, 9, 17), (8192, 81, 17), (32768, 81, 289), (32768, 81, 1089)):
        c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
        ids = torch.as_tensor(rng.integers(0, S, O).astype(np.int32), device=dev)
        got = ka._seg_accum_full_cuda(c, ids, S)
        ref = ka.seg_accum_full_plain(c, ids, S)
        scale = ka.seg_accum_full_plain(c.abs(), ids, S)
        abs_err, rel = _seg_err(got, ref, scale)
        # Atomics reorder the f32 sums: 1e-5 of the per-segment sum of |c|.
        if rel > 1e-5:
            raise AssertionError(f"K2 ({O},{K})->{S}: relative error {rel}")
        ms = _time_ms(lambda: ka._seg_accum_full_cuda(c, ids, S))
        plain_ms = _time_ms(lambda: ka.seg_accum_full_plain(c, ids, S))
        print(f"K2 seg_accum_full ({O},{K})->{S}: max_abs_err {abs_err:.3g} "
              f"(rel {rel:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], abs_err)
        if (O, K, S) == (32768, 81, 289):
            out["ms"], out["plain_ms"] = ms, plain_ms
    return out


def check_seg_sorted(torch, dev):
    """K3 at the per-point shapes, track lengths like the mapper's."""
    import numpy as np
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka

    rng = np.random.default_rng(2)
    out = {"max_abs_err": 0.0}
    for O, K in ((8192, 12), (20480, 3)):
        # Track lengths 2..12, mostly short (geometric), padded to O rows.
        lens = []
        while sum(lens) < int(O * 0.8):
            lens.append(int(min(2 + rng.geometric(0.35) - 1, 12)))
        Pd = -(-len(lens) // 1024) * 1024
        offsets = np.zeros(Pd + 1, np.int32)
        offsets[1: len(lens) + 1] = np.cumsum(lens)
        offsets[len(lens) + 1:] = offsets[len(lens)]
        c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
        off = torch.as_tensor(offsets, device=dev)
        got = ka._seg_accum_sorted_cuda(c, off, Pd)
        ref = ka.seg_accum_sorted_plain(c, off, Pd)
        scale = ka.seg_accum_sorted_plain(c.abs(), off, Pd)
        abs_err, rel = _seg_err(got, ref, scale)
        if rel > 1e-5:
            raise AssertionError(f"K3 ({O},{K}): relative error {rel}")
        ms = _time_ms(lambda: ka._seg_accum_sorted_cuda(c, off, Pd))
        plain_ms = _time_ms(lambda: ka.seg_accum_sorted_plain(c, off, Pd))
        print(f"K3 seg_accum_sorted ({O},{K}) {len(lens)} tracks -> {Pd} segments: "
              f"max_abs_err {abs_err:.3g} (rel {rel:.3g}), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], abs_err)
        if (O, K) == (8192, 12):
            out["ms"], out["plain_ms"] = ms, plain_ms
    return out


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mapper_options():
    from mavmap_tpu_torch.sfm import SequentialMapperOptions

    opts = SequentialMapperOptions(tri_min_angle=1.0, final_cost_threshold=2.0,
                                   essential_ransac_trials=512, p3p_ransac_trials=512)
    init_opts = SequentialMapperOptions(tri_min_angle=4.0, final_cost_threshold=2.0,
                                        essential_ransac_trials=512, p3p_ransac_trials=512)
    return opts, init_opts


def _provider(feats, cap=1024):
    from mavmap_tpu_torch.features import ArrayFeatureProvider

    return ArrayFeatureProvider([(k[:cap], d[:cap]) for k, d in feats], capacity=cap)


def _bench_scene():
    """bench.py's 30-image scene and its feature provider."""
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

    scene = make_uav_scene(num_images=NUM_IMAGES, num_points=4000, relief=10.0, rows=2,
                           seed=11)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
    return scene, _provider(feats)


def _check_map(m, n_images, min_registered, ate, ate_limit, what):
    import numpy as np

    nreg = int(m.store.image_registered.sum())
    reg = [iid for iid in range(m.store.num_images) if m.store.image_registered[iid]]
    poses = np.concatenate([m.store.image_rvecs[reg], m.store.image_tvecs[reg]], axis=1)
    if not np.isfinite(poses).all():
        raise AssertionError(f"{what}: non-finite poses")
    if not np.isfinite(m.store.point3D_xyz[m.store.point3D_valid]).all():
        raise AssertionError(f"{what}: non-finite 3-D points")
    if nreg < min_registered:
        raise AssertionError(f"{what}: registered {nreg}/{n_images} < {min_registered}")
    if not ate < ate_limit:
        raise AssertionError(f"{what}: ATE {ate} m >= {ate_limit} m")
    return nreg


def _check_launches(what, launches, min_match, min_seg, per):
    """Every kernel of the path ran: K1 at least min_match times, K2 and K3
    at least min_seg times (once per `per`)."""
    if launches["match"] < min_match:
        raise AssertionError(f"{what}: match kernel launched {launches['match']} < "
                             f"{min_match} times")
    for k in ("seg_accum_full", "seg_accum_sorted"):
        if launches[k] < min_seg:
            raise AssertionError(f"{what}: {k} launched {launches[k]} times for {per}")


def main_path_phase(torch, dev):
    """bench.py's scene through the port's per-frame mapping loop."""
    from mavmap_tpu_torch.ba import BAOptions
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.sfm import SequentialMapper
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    _phase("main path")
    scene, prov = _bench_scene()
    opts, init_opts = _mapper_options()
    window_ba = BAOptions(max_num_iterations=6, refine_camera_params=True)
    global_ba = BAOptions(max_num_iterations=30, refine_camera_params=True)

    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         prov, dev, seed=0)
    stages = {"init_s": 0.0, "register_s": 0.0, "window_ba_s": 0.0, "global_ba_s": 0.0}
    window_iters = 0
    build.reset_launches()
    _sync(torch, dev)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    if not m.process_initial(0, 1, init_opts):
        raise AssertionError("two-view initialization of images 0, 1 failed")
    stages["init_s"] += time.perf_counter() - t0
    last = 1
    for i in range(2, NUM_IMAGES):
        t0 = time.perf_counter()
        ok = m.process(i, last, opts)
        stages["register_s"] += time.perf_counter() - t0
        if ok:
            last = i
            window = sorted(m.image_idx_to_id)[-10:]
            if len(window) > 2:
                t0 = time.perf_counter()
                info = m.adjust_bundle(window[2:], window[:2], ba_options=window_ba)
                stages["window_ba_s"] += time.perf_counter() - t0
                window_iters += int(info["iterations"])
    t0 = time.perf_counter()
    ginfo = m.adjust_global_bundle(global_ba)
    _sync(torch, dev)
    stages["global_ba_s"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_start
    launches = dict(build.launches)

    nreg = int(m.store.image_registered.sum())
    ate = float(mapper_ate(m, scene))
    lm_iters = window_iters + int(ginfo["iterations"])
    ms_per_iter = 1000.0 * (stages["window_ba_s"] + stages["global_ba_s"]) / max(lm_iters, 1)
    print(f"registered {nreg}/{NUM_IMAGES} in {wall:.3f} s = {NUM_IMAGES / wall:.3f} "
          f"frames/s; ATE {ate:.6f} m (limit {ATE_LIMIT_M} m); "
          f"{m.store.num_points3D} 3-D points", flush=True)
    print("stages_s " + json.dumps({k: round(v, 4) for k, v in stages.items()}), flush=True)
    print(f"BA: {lm_iters} LM iterations ({window_iters} window, {ginfo['iterations']} "
          f"global), {ms_per_iter:.3f} ms/iteration; launches {json.dumps(launches)}",
          flush=True)

    _check_map(m, NUM_IMAGES, NUM_IMAGES, ate, ATE_LIMIT_M, "main path")
    # One match per registration attempt: the initial pair and each of the
    # NUM_IMAGES - 2 later frames, so NUM_IMAGES - 1 in all.
    _check_launches("main path", launches, NUM_IMAGES - 1, lm_iters,
                    f"{lm_iters} LM iterations")
    return launches


def bench_loop(torch, dev, scene, prov, n_images, seed=0):
    """bench.py's run() without its pipelining option, through the port:
    chains of CHAIN frames (process_chain_k, pad_to=CHAIN) with one
    deferred asynchronous 10-image self-calibrating window bundle
    adjustment per chain, process() where a chain cannot run, flush_ba and
    the 30-iteration global bundle adjustment. Returns (mapper, stats)."""
    from mavmap_tpu_torch.ba import BAOptions
    from mavmap_tpu_torch.sfm import SequentialMapper

    opts, init_opts = _mapper_options()
    window_ba = BAOptions(max_num_iterations=6, refine_camera_params=True)
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         prov, dev, seed=seed)
    st = {"init_s": 0.0, "register_s": 0.0, "window_ba_s": 0.0, "flush_s": 0.0,
          "global_ba_s": 0.0}

    def solve_s():
        return m.counters.get("ba_solve_s", 0.0)

    def register(fn, *a, **kw):
        # Deferred window solves run inside the register step that
        # dispatches them: their time goes to the window BA stage.
        s0, t0 = solve_s(), time.perf_counter()
        out = fn(*a, **kw)
        _sync(torch, dev)
        ds = solve_s() - s0
        st["register_s"] += time.perf_counter() - t0 - ds
        st["window_ba_s"] += ds
        return out

    def local_ba():
        window = sorted(m.image_idx_to_id)[-10:]
        if len(window) > 2:
            t0 = time.perf_counter()
            m.adjust_bundle(window[2:], window[:2], ba_options=window_ba, async_=True,
                            defer=True)
            st["window_ba_s"] += time.perf_counter() - t0

    _sync(torch, dev)
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    if not m.process_initial(0, 1, init_opts):
        raise AssertionError("two-view initialization of images 0, 1 failed")
    st["init_s"] = time.perf_counter() - t0
    last, i = 1, 2
    while i < n_images:
        chain = [j for j in range(i, min(i + CHAIN, n_images))
                 if not m.is_image_processed(j)]
        if len(chain) >= 2 and chain == list(range(chain[0], chain[-1] + 1)):
            committed = sum(register(m.process_chain_k, chain, last, opts, pad_to=CHAIN))
            if committed:
                last = chain[committed - 1]
                local_ba()
                i = last + 1
                continue
        if register(m.process, i, last, opts):
            last = i
            local_ba()
        i += 1
    t0 = time.perf_counter()
    m.flush_ba()
    _sync(torch, dev)
    st["flush_s"] = time.perf_counter() - t0
    window_iters = m.counters.get("ba_iters", 0)
    t0 = time.perf_counter()
    ginfo = m.adjust_global_bundle(BAOptions(max_num_iterations=30,
                                             refine_camera_params=True))
    _sync(torch, dev)
    st["global_ba_s"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_start
    c = m.counters
    return m, {"wall_s": wall, "stages_s": st, "window_iters": window_iters,
               "global": ginfo, "chains": c.get("chains", 0), "pulls": c.get("pulls", 0),
               "ba_applied": c.get("ba_applied", 0),
               "two_stage_selfcal": "ba_selfcal_iters" in c}


def _report_loop(name, m, n_images, ate, ate_limit, s, launches):
    nreg = int(m.store.image_registered.sum())
    g = s["global"]
    print(f"{name}: registered {nreg}/{n_images} in {s['wall_s']:.3f} s = "
          f"{n_images / s['wall_s']:.3f} frames/s; ATE {ate:.6f} m (limit {ate_limit:.6f} m); "
          f"{m.store.num_points3D} 3-D points", flush=True)
    print(f"{name} stages_s " + json.dumps({k: round(v, 4) for k, v in s["stages_s"].items()}),
          flush=True)
    print(f"{name}: {s['chains']} chains, {s['pulls']} pulls "
          f"({s['pulls'] / max(s['chains'], 1):.3f} per chain), {s['ba_applied']} window "
          f"solves landed ({s['ba_applied'] / max(s['pulls'], 1):.3f} per pull); "
          f"{s['window_iters']} window LM iterations; global BA {g['solver']} "
          f"{g['iterations']} iterations, "
          f"{1000.0 * s['stages_s']['global_ba_s'] / max(g['iterations'], 1):.3f} ms/iteration; "
          f"launches {json.dumps(launches)}", flush=True)


def chained_phase(torch, dev):
    """bench.py's chained loop over bench.py's 30-image scene."""
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    _phase("chained")
    scene, prov = _bench_scene()
    build.reset_launches()
    m, s = bench_loop(torch, dev, scene, prov, NUM_IMAGES)
    launches = dict(build.launches)
    ate = float(mapper_ate(m, scene))
    limit = min(0.05, 2.0 * JAX_CPU_CHAINED_ATE_M)
    _report_loop("chained", m, NUM_IMAGES, ate, limit, s, launches)
    _check_map(m, NUM_IMAGES, NUM_IMAGES, ate, limit, "chained")
    lm_iters = s["window_iters"] + s["global"]["iterations"]
    _check_launches("chained", launches, NUM_IMAGES - 1, lm_iters, f"{lm_iters} LM iterations")
    return launches


def survey_phase(torch, dev):
    """bench.py's chained loop over benchmarks/pipeline_scale.py's scene at
    SURVEY_IMAGES images; the global BA resolves to CG. Returns (launches,
    the global problem as built for the kernel checks)."""
    import numpy as np
    from mavmap_tpu_torch.ba import build_problem
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene, mapper_ate, render_features

    _phase("survey")
    t0 = time.perf_counter()
    scene = make_uav_scene(num_images=SURVEY_IMAGES, num_points=120 * SURVEY_IMAGES,
                           relief=10.0, rows=4, extent=None, seed=13)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=32, seed=13)
    prov = _provider(feats)
    print(f"survey scene: {SURVEY_IMAGES} images, {len(scene.points3D)} points, "
          f"{np.mean([len(k) for k, _ in feats]):.1f} features per image, rendered in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    m, s = bench_loop(torch, dev, scene, prov, SURVEY_IMAGES)
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ate = float(mapper_ate(m, scene))
    limit = 2.0 * JAX_CPU_SURVEY_ATE_M
    _report_loop("survey", m, SURVEY_IMAGES, ate, limit, s, launches)

    # The global problem as adjust_global_bundle builds it (all registered
    # images, bucketed): its shapes for the kernel checks.
    _, poses, _, points, oi, op, oc, xy = m.ba_problem_arrays()
    prob = build_problem(poses, points, m.store.camera_params, m.store.camera_models,
                         oi, op, oc, xy, bucket=True)
    g = s["global"]
    cg = g["cg_iters"]
    print(f"survey global BA: {g['num_residuals'] // 2} observations "
          f"(capacity {prob.obs_image.shape[0]}), {len(points)} points "
          f"({prob.point_rows.shape[0]} dense rows), {prob.poses.shape[0]} pose blocks + "
          f"{prob.cam_params.shape[0]} camera blocks; two-stage selfcal "
          f"{'ran' if s['two_stage_selfcal'] else 'did not run'} (selfcal_max_obs 150000); "
          f"{g['iterations']} LM iterations, CG iterations per LM iteration {cg}; "
          f"peak device memory {peak / 2**20:.1f} MiB", flush=True)
    if g["solver"] != "cg":
        raise AssertionError(f"survey: global BA ran {g['solver']}, not CG")
    _check_map(m, SURVEY_IMAGES, JAX_CPU_SURVEY_REGISTERED, ate, limit, "survey")
    lm_iters = s["window_iters"] + g["iterations"]
    _check_launches("survey", launches, SURVEY_IMAGES - 1, lm_iters + sum(cg),
                    f"{lm_iters} LM and {sum(cg)} CG iterations")
    return launches, prob


def check_survey_shapes(torch, dev, prob):
    """K2/K3 at the survey's global CG shapes, random values on the real ids:
    K2 (2O, 9) and (2O, 81) into the B = I + C blocks (the selfcal matvec
    and preconditioner reduce both entries of every observation at once),
    K2 (O, 6) into I (the pose-only matvec); K3 (O, 3) into the dense
    points (both matvecs)."""
    import numpy as np
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka

    rng = np.random.default_rng(3)
    I = prob.poses.shape[0]
    B = I + prob.cam_params.shape[0]
    O = prob.obs_image.shape[0]
    Pd = prob.point_rows.shape[0]
    ids2 = np.concatenate([prob.obs_image, I + prob.obs_cam]).astype(np.int32)
    out = {"max_abs_err": 0.0, "full": [], "sorted": []}
    for rows, ids, K, S in ((2 * O, ids2, 9, B), (2 * O, ids2, 81, B),
                            (O, prob.obs_image, 6, I)):
        c = torch.as_tensor(rng.normal(size=(rows, K)).astype(np.float32), device=dev)
        seg = torch.as_tensor(np.ascontiguousarray(ids, np.int32), device=dev)
        got = ka._seg_accum_full_cuda(c, seg, S)
        ref = ka.seg_accum_full_plain(c, seg, S)
        abs_err, rel = _seg_err(got, ref, ka.seg_accum_full_plain(c.abs(), seg, S))
        if rel > 1e-5:
            raise AssertionError(f"K2 ({rows},{K})->{S}: relative error {rel}")
        ms = _time_ms(lambda: ka._seg_accum_full_cuda(c, seg, S))
        plain_ms = _time_ms(lambda: ka.seg_accum_full_plain(c, seg, S))
        print(f"K2 seg_accum_full survey ({rows},{K})->{S}: max_abs_err {abs_err:.3g} "
              f"(rel {rel:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], abs_err)
        out["full"].append({"shape": [rows, K, S], "ms": ms, "plain_ms": plain_ms})
    c = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32), device=dev)
    off = torch.as_tensor(prob.pt_offsets, device=dev)
    got = ka._seg_accum_sorted_cuda(c, off, Pd)
    ref = ka.seg_accum_sorted_plain(c, off, Pd)
    abs_err, rel = _seg_err(got, ref, ka.seg_accum_sorted_plain(c.abs(), off, Pd))
    if rel > 1e-5:
        raise AssertionError(f"K3 ({O},3)->{Pd}: relative error {rel}")
    ms = _time_ms(lambda: ka._seg_accum_sorted_cuda(c, off, Pd))
    plain_ms = _time_ms(lambda: ka.seg_accum_sorted_plain(c, off, Pd))
    print(f"K3 seg_accum_sorted survey ({O},3)->{Pd}: max_abs_err {abs_err:.3g} "
          f"(rel {rel:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    out["sorted_err"] = abs_err
    out["sorted"].append({"shape": [O, 3, Pd], "ms": ms, "plain_ms": plain_ms})
    return out


def cg_vs_dense_phase(torch, dev):
    """One ~40-camera problem solved by the dense and the CG solver
    (cg_tol 1e-6), with and without self-calibration, on the card: poses
    agree to 1e-4 (1e-3 with self-calibration), final costs to 1e-3
    relative, as tests/test_ba.py holds the JAX package's solvers."""
    import numpy as np
    from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec

    _phase("cg vs dense")
    rng = np.random.default_rng(5)
    I, P, per_image = 40, 1500, 400
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = (rng.normal(size=(P, 3)) * [8, 4, 2] + [6, 0, 14]).astype(np.float32)
    poses = np.concatenate([rng.normal(size=(I, 3)) * 0.03,
                            np.stack([-np.arange(I) * 0.3, np.zeros(I), np.zeros(I)], 1)],
                           axis=1).astype(np.float32)
    R = rotmat_from_rvec(torch.as_tensor(poses[:, :3])).numpy()
    oi, op, uv = [], [], []
    for i in range(I):
        Xc = X @ R[i].T + poses[i, 3:]
        u = Xc[:, :2] / Xc[:, 2:] * 700.0 + [400.0, 300.0]
        sel = np.sort(rng.permutation(P)[:per_image])
        oi += [i] * len(sel)
        op += list(sel)
        uv += list(u[sel] + rng.normal(size=(len(sel), 2)) * 0.3)
    poses0 = poses.copy()
    poses0[2:] += rng.normal(size=poses0[2:].shape).astype(np.float32) * 0.01
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    build.reset_launches()
    for selfcal in (False, True):
        K0 = K.copy()
        if selfcal:
            K0[0, :2] *= [1.02, 0.985]
        prob = build_problem(poses0, X0, K0, [1], oi, op, np.zeros(len(oi), np.int32),
                             np.array(uv, np.float32), pose_states=[1, 2] + [0] * (I - 2))
        o = dict(max_num_iterations=25, refine_camera_params=selfcal)
        t0 = time.perf_counter()
        pd, xd, infod = bundle_adjust(prob, BAOptions(**o, solver="dense"), dev)
        t1 = time.perf_counter()
        pc, xc, infoc = bundle_adjust(prob, BAOptions(**o, solver="cg", cg_tol=1e-6), dev)
        t2 = time.perf_counter()
        dpose = float(np.abs(pc - pd).max())
        dcost = abs(infoc["final_cost"] - infod["final_cost"]) / max(1.0, infod["final_cost"])
        print(f"cg vs dense, selfcal {selfcal}: max pose difference {dpose:.3g}, final cost "
              f"{infod['final_cost']:.6g} dense vs {infoc['final_cost']:.6g} cg (rel "
              f"{dcost:.3g}); iterations {infod['iterations']} / {infoc['iterations']}, CG "
              f"iterations {infoc['cg_iters']}; {t1 - t0:.3f} s dense, {t2 - t1:.3f} s cg",
              flush=True)
        if infoc["solver"] != "cg" or infod["solver"] != "dense":
            raise AssertionError("cg vs dense: wrong solver ran")
        if dpose > (1e-3 if selfcal else 1e-4) or dcost > 1e-3:
            raise AssertionError(f"cg vs dense (selfcal {selfcal}): poses differ by {dpose}, "
                                 f"costs by {dcost}")
    return dict(build.launches)


def main():
    import torch

    dev, name, smi = device_phase()
    import mavmap_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_phase()
    _phase("kernels")
    k1 = check_match(torch, dev)
    k2 = check_seg_full(torch, dev)
    k3 = check_seg_sorted(torch, dev)
    phases = {"main": main_path_phase(torch, dev), "chained": chained_phase(torch, dev)}
    phases["survey"], survey_prob = survey_phase(torch, dev)
    _phase("kernels at the survey's shapes")
    ks = check_survey_shapes(torch, dev, survey_prob)
    phases["cg_vs_dense"] = cg_vs_dense_phase(torch, dev)
    k2["max_abs_err"] = max(k2["max_abs_err"], ks["max_abs_err"])
    k3["max_abs_err"] = max(k3["max_abs_err"], ks["sorted_err"])

    def by_phase(k):
        return {p: launches[k] for p, launches in phases.items()}

    kernels = [
        dict(name="match", route="cuda", source="mavmap_tpu_torch/csrc/match.cu",
             replaces="mavmap_tpu/ops/pallas/match.py:106",
             launches=phases["main"]["match"], launches_by_phase=by_phase("match"), **k1),
        dict(name="seg_accum_full", route="cuda", source="mavmap_tpu_torch/csrc/ba_accum.cu",
             replaces="mavmap_tpu/ops/pallas/ba_accum.py:79",
             launches=phases["main"]["seg_accum_full"],
             launches_by_phase=by_phase("seg_accum_full"), survey_shapes=ks["full"], **k2),
        dict(name="seg_accum_sorted", route="cuda", source="mavmap_tpu_torch/csrc/ba_accum.cu",
             replaces="mavmap_tpu/ops/pallas/ba_accum.py:179",
             launches=phases["main"]["seg_accum_sorted"],
             launches_by_phase=by_phase("seg_accum_sorted"), survey_shapes=ks["sorted"], **k3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
