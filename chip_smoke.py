#!/usr/bin/env python3
"""Smoke test of mavmap_tpu_torch on one CUDA GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

 1. device: a CUDA device is required (no CPU fallback); prints the card's
    name and power limit as nvidia-smi reports them;
 2. build: compiles the CUDA kernels of mavmap_tpu_torch/csrc with nvcc
    and, beside them, the native track store (mavmap_tpu_torch/native) with
    g++;
 3. timer check: the device timer against a sleep kernel of known length,
    and the launch floor: a near-empty kernel (torch.cuda._sleep(1)) under
    the same timer;
 4. kernels: holds each kernel against its plain PyTorch version on the
    card at the mapper's shapes (K3 also bit for bit against the plain
    version on a CPU copy, K2 and K3 against a second call), and reports
    per shape its device time (calls replayed back to back from a CUDA
    graph, median of 5), host time per call, the plain version's and the
    library call's device times, its bound and the share of it reached,
    and the profiler's kernel time;
 5. main path: the sequential mapper over bench.py's 30-image scene —
    process_initial, process for every later frame with a 10-image
    self-calibrating window bundle adjustment after each success, then one
    global bundle adjustment — checking 30/30 registrations, the ATE
    against ground truth, and that every kernel was launched;
 6. chained: bench.py's own loop (run() without its pipelining option) on
    the same scene — chains of 6 frames through process_chain_k, one
    deferred asynchronous window bundle adjustment per chain, flush_ba and
    the global bundle adjustment — checking 30/30, the ATE and launches;
    run twice, the two maps must be equal bit for bit (poses, points, ATE);
    then K2 at the per-(point, block) plan's shapes of its last window
    problem and of its global problem, beside index_add_;
 7. survey: the same loop over benchmarks/pipeline_scale.py's scene at 200
    images, whose global bundle adjustment (>= 64 cameras) runs the
    matrix-free CG solver — checking the registered count and the ATE
    against the JAX package's on the CPU, and finite output;
 8. kernels at the survey's shapes: K2/K3 at the global problem's
    observation, block and point counts (the CG matvec's 3/6/9 columns, the
    preconditioner's 81, and 81 with every row on the camera block), held
    against their plain versions and timed as in phase 4;
 9. CG against dense: one ~40-camera problem solved by both solvers, with
    and without self-calibration, on the card;
10. batched geometry: one register_view_pairs step (the back-fill's and
    the closure sweeps' batched step) on consecutive pairs of the survey
    at B = 1, 8 and 32, with vmap's per-sample fallback disabled: host ms
    per slot, the device's busy share over the step, peak device memory,
    host syncs per step (CUDA's sync debug mode; they must not grow with B)
    and K1 launches per step; then the 32-slot step slot by slot against
    register_view with the same RANSAC draws (counts and masks equal, how
    many slots give the same bits, the largest float differences);
11. pipeline: run_pipeline in sequential mode over the survey's scene and
    features with a vocabulary tree, as benchmarks/pipeline_scale.py runs
    it: the batched initial-pair search, chains of 4 with a deferred window
    bundle adjustment each, loop detection every 20 frames and as the
    rescue, the back-fill, the global bundle adjustment and one closure
    sweep — checking the registered count and the ATE against the JAX
    package's on the CPU, that loops were closed and that batched K1 ran;
12. mesh: the distributed path on 2 ranks that share the card
    (parallel.launch; gloo, host-staged collectives in rank order), each
    rank a spawned process that must succeed: (a) the survey's global
    problem solved sharded by 3-D point (CG), twice, against bundle_adjust
    on one process (final cost within 1 %, the second solve the first's
    bits on both ranks; ms per LM iteration at 1 and 2 ranks, host ms in
    the collectives); (b) run_pipeline with mesh_devices=2 over the
    survey as in 11, held to the same limits and compared with 11's run;
    (c) the batched geometry phase's 32-slot register_view_pairs step split
    over the ranks, every slot equal to the unsharded step bit for bit.
    K1, K2 and K3 must launch on every rank. Then K2 and K3 at rank 0's
    shard of the survey's problem and K1 at a rank's 16-slot block, held
    and timed as in phase 4;
13. submaps: run_pipeline over two runs that end in sub-maps and merge
    them into one map on the native track store: "restart", bench.py's
    scene with frames 13-14 given unrelated descriptors, so that one failed
    frame starts a new sub-map (no loop detection); "segments", a 60-image
    survey in 2 rows mapped as two overlapping segments with a vocabulary
    tree, whose merge closes cross-loops through batched K1. Held to the
    JAX package on the same inputs (benchmarks/jax_submaps_yardstick.py):
    one map, at least its registered count and under 2x its ATE; K1-K3
    launched, batched K1 inside the segments run's merge, and more common
    images after its cross-loop closures than before;
14. cli: the command-line mapper (mavmap_tpu_torch.cli, in process) from
    pixels: a 40-image survey written as PNG files with imagedata.txt (IMU
    roll/pitch/yaw), a control-point file and a vocabulary tree trained on
    the port's own detections; run 1 detects on the card and maps with
    loop detection, IMU priors, ground control points, the point-cloud
    filter and a map checkpoint; run 2 resumes from the checkpoint. Held to
    the JAX package's CLI on the same files (benchmarks/jax_cli_yardstick.py)
    and to absolute limits; then the detector's device and host time per
    frame at 800x600 and at one 4000x3000 frame;
15. prints the kernels' JSON line, the card line, and last the result line.

Phase 4 also holds K1 with a slot axis (the batched steps' and the
pre-gates' launches) slot by slot against its plain version and bit for
bit against the single-pair launch on each slot's pair. The launch
counters are zeroed just before each mapping run (5-7, 9, 11-13) and read
just after it (12: each rank's counts of its pipeline run, summed over the
ranks; 13: the sum of its two runs; 14: the counts span both CLI runs). The smoke's total seconds are printed last but two, against its
1200 s limit. Imports
nothing of JAX or of the JAX package.
"""

import json
import math
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
# The JAX package's run_pipeline on the CPU over the pipeline phase's scene,
# tree and options (benchmarks/jax_pipeline_yardstick.py, mapper seeds 0-2:
# 200/200, ATE 0.008439 / 0.008514 / 0.008387 m, 94 loop closures and 425
# sweep closures in each; recorded in PERF.md). The port must register as
# many and stay under 2x the seed-0 ATE.
JAX_CPU_PIPELINE_ATE_M = 0.008439
JAX_CPU_PIPELINE_REGISTERED = 200
PIPELINE_OPTS = dict(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
                     loop_detection_period=20, final_closure_sweeps=1, final_closure_step=2,
                     chain_len=4, ba_local_max_iters=15)
# The cli phase: its survey and the JAX package's own CLI on the CPU over
# the same files (benchmarks/jax_cli_yardstick.py, recorded in PERF.md):
# 21/40 registered (the first row and one rescued frame: no frame of the
# second row registers against the first in either package), the absolute
# camera-centre RMSE and each free control point's error.
CLI_IMAGES = 40
CLI_FILTER_MAX_ERROR = 2.0
JAX_CPU_CLI_REGISTERED = 21
JAX_CPU_CLI_ABS_RMSE_M = 0.20769685080775652
JAX_CPU_CLI_GCP_ERR_M = {"cp4": 0.00948342847402626, "cp5": 0.0025753420202657084}
# The submaps phase: two run_pipeline runs that end in sub-maps and merge
# them (the scenes, options and the JAX package's numbers on the CPU:
# benchmarks/jax_submaps_yardstick.py, recorded in PERF.md). Each run must
# end in one map, register at least as many frames as the JAX package and
# stay under 2x its ATE. Both take the pipeline phase's options.
# restart: bench.py's scene, frames 13 and 14 given unrelated descriptors;
# one failed frame starts a new sub-map.
RESTART_FRAMES = (13, 14)
RESTART_OPTS = dict(PIPELINE_OPTS, max_subsequent_trials=1, loop_detection=False,
                    final_closure_sweeps=0)
# segments: a 60-image survey in 2 rows mapped as two segments.
SEGMENT_IMAGES = 60
SEGMENT_OPTS = dict(PIPELINE_OPTS, parallel_segments=2, segment_overlap=4)
JAX_CPU_SUBMAPS = {"restart": {"registered": 28, "ate_m": 0.008275382220745087},
                   "segments": {"registered": 60, "ate_m": 0.004537736531347036}}


def _phase(name):
    print(f"== {name}", flush=True)


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bytes/s, and f32 FLOP/s outside the tensor cores (K1 stays IEEE
# f32). A kernel's bound is the larger of the bytes it must move (each
# input read once, each output written once) over the first and its
# operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _graph_timer(torch, fn, n):
    """fn captured n times back to back in one CUDA graph; returns a
    function that replays the graph once and gives device ms per call."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()

    def per_call_ms():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    per_call_ms()  # the first replay uploads the graph
    return per_call_ms


def _time_ms(fn, runs=5, min_calls=50, min_ms=1.0):
    """(device ms per call, host µs per call) of fn, after a warm-up call.

    Device time: n calls (n >= min_calls, and n calls last >= min_ms) are
    captured in one CUDA graph and each of `runs` replays is timed between
    two CUDA events; the median over n. A replay reaches the device with no
    host work between the calls. Timing one call between two events would
    time the wrapper's host work (argument checks, allocation, ctypes)
    wherever that is slower than the kernel.
    Host time (call_us): the host clock around min_calls calls started
    after a synchronise, so the wrapper's overhead stays visible."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(min_calls):
        fn()
    call_us = (time.perf_counter() - t0) / min_calls * 1e6
    torch.cuda.synchronize()
    n = min_calls
    timer = _graph_timer(torch, fn, n)
    first = timer()
    if first * n < min_ms:
        n = int(math.ceil(1.2 * min_ms / first))
        timer = _graph_timer(torch, fn, n)
    return statistics.median(timer() for _ in range(runs)), call_us


def _profiled_us(torch, fn, names, calls=20):
    """Device µs per call of the CUDA kernels whose names contain one of
    `names`, as torch.profiler (CUPTI) reports them, or None where the trace
    holds no device time: a cross-check of the graph timer."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            total += (getattr(e, "device_time_total", 0.0)
                      or getattr(e, "cuda_time_total", 0.0))
    return total / calls if total > 0 else None


def timer_check(torch):
    """Hold the device timer to a kernel of known length. torch.cuda._sleep
    spins for a number of SM clock cycles: one long sleep timed alone (its
    host overhead is nothing against ~20 ms) gives the cycles per ms; a
    5 µs sleep behind 50 µs of host work per call must then time at 5 µs,
    not at the host's pace."""
    _phase("timer check")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(40_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 40e6 / a.elapsed_time(b)
    expect_ms = 0.005

    def slow_host_call():
        t = time.perf_counter()
        while time.perf_counter() - t < 50e-6:
            pass
        torch.cuda._sleep(int(cycles_per_ms * expect_ms))

    ms, call_us = _time_ms(slow_host_call)
    print(f"timer check: {cycles_per_ms / 1e6:.4f} GHz SM clock under sleep; a "
          f"{1000 * expect_ms:.1f} µs sleep behind {call_us:.1f} µs of host work per call "
          f"times at {1000 * ms:.3f} µs", flush=True)
    if not 0.9 * expect_ms <= ms <= 1.1 * expect_ms + 0.0015:
        raise AssertionError(f"device timer: {ms} ms for a {expect_ms} ms kernel")
    # The launch floor: a kernel that does next to nothing, under the same
    # timer, is the least any kernel launch costs in a replayed graph.
    floor_ms, _ = _time_ms(lambda: torch.cuda._sleep(1))
    print(f"launch floor: {1000 * floor_ms:.3f} µs per launch (torch.cuda._sleep(1) "
          f"under the graph timer)", flush=True)
    return floor_ms


def _bound(nbytes, flops):
    """(bound_ms, bound_by, resource): the larger of bytes over the HBM rate
    and operations over the f32 rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOP_PER_S
    return (t_bytes, "bytes", "hbm") if t_bytes >= t_ops else (t_ops, "operations", "flops_f32")


def _timed(torch, shape, kernel, plain, library, nbytes, flops, names):
    """One timed shape of a kernel: device and host times of the kernel, its
    plain version and the library call (None where there is none), the
    bound and the share of it reached, and the profiler's cross-check."""
    ms, call_us = _time_ms(kernel)
    plain_ms, _ = _time_ms(plain)
    library_ms = _time_ms(library)[0] if library is not None else None
    bound_ms, by, resource = _bound(nbytes, flops)
    return dict(shape=shape, ms=ms, call_us=call_us, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
                bound_resource=resource, share=bound_ms / ms,
                profiler_us=_profiled_us(torch, kernel, names))


def _fmt(r):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    prof = "n/a" if r["profiler_us"] is None else f"{r['profiler_us']:.2f} µs"
    return (f"kernel {r['ms']:.4f} ms (profiler {prof}; host {r['call_us']:.1f} µs/call), "
            f"plain {r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_resource']}), share {r['share']:.3f}")


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

    from concurrent.futures import ThreadPoolExecutor

    from mavmap_tpu_torch import native

    _phase("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ run side by side
        cuda, store = pool.submit(build.build), pool.submit(native.build)
        path, store_path = cuda.result(), store.result()
    build.library()
    native.load_mapstore_lib()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds}) -> {os.path.relpath(path)}; native track store "
          f"(g++ {native.build_seconds}) -> {os.path.relpath(store_path)}", flush=True)


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


K1_KERNELS = ("match_tile_kernel", "match_merge_kernel")
K2_KERNELS = ("seg_pieces_kernel", "seg_merge_kernel")
K3_KERNELS = ("seg_rows_kernel",)


def _k1_cost(N1, N2, D, use_kp):
    """(bytes, flops) of K1: d1, d2, the penalties and keypoints read once,
    the per-row and per-column (arg, best, second) written once; 2 N1 N2 D
    for the distances and 4 N1 N2 for the prefilter's keypoint products."""
    n_in = (N1 + N2) * D + (N1 + N2) + (2 * (N1 + N2) if use_kp else 0)
    return 4 * n_in + 12 * (N1 + N2), 2 * N1 * N2 * D + (4 * N1 * N2 if use_kp else 0)


def _seg_cost(rows, K, S):
    """(bytes, flops) of a segment sum: the (rows, K) contributions and one
    int32 id (or offset) per row read once, the (S, K) sums written once;
    one add per contribution."""
    return 4 * (rows * K + rows + S * K), rows * K


def _check_match_slots(torch, got, ref, what):
    """K1 against its plain version (one pair, or every slot of a batched
    call): indices equal off near-ties (best and second within 1e-5),
    distances to 1e-5, masked distances exact. Returns the largest distance
    error."""
    err = 0.0
    for arg_i, best_i, second_i in ((0, 1, 2), (3, 4, 5)):
        gb, rb, rs = got[best_i], ref[best_i], ref[second_i]
        real = rb < 1e29
        d_err = float((gb - rb).abs()[real].max())
        if d_err > 1e-5 or not torch.equal(gb[~real], rb[~real]):
            raise AssertionError(f"K1 {what}: distance error {d_err} or masked distances differ")
        s_err = (got[second_i] - rs).abs()[rs < 1e29]
        if s_err.numel() and float(s_err.max()) > 1e-5:
            raise AssertionError(f"K1 {what}: second-distance error {float(s_err.max())}")
        bad = (got[arg_i] != ref[arg_i]) & ((rs - rb) > 1e-5)
        if bool(bad.any()):
            raise AssertionError(f"K1 {what}: {int(bad.sum())} indices differ off near-ties")
        err = max(err, d_err)
    return err


def check_match(torch, dev):
    """K1 at 1024x1024x128 with the prefilter, and ragged 1000x937."""
    import numpy as np
    from mavmap_tpu_torch.ops.cuda import match as km

    rng = np.random.default_rng(0)
    out = {"max_abs_err": 0.0, "shapes": []}
    for N1, N2 in ((1024, 1024), (1000, 937)):
        (d1, d2, m1, m2, kp1, kp2), maxd = _match_inputs(torch, rng, dev, N1, N2)
        args = km.padded_operands(d1, d2, m1, m2, kp1, kp2, maxd)
        got = km._match_raw_cuda(*args)
        ref = km.match_raw_plain(*args)
        torch.cuda.synchronize()
        err = _check_match_slots(torch, got, ref, f"{N1}x{N2}")
        # The whole matcher (ratio test + cross-check) on the card vs the CPU.
        mk, ok_k = km.match_brute_force_cuda(d1, d2, m1, m2, kp1, kp2, max_distance=maxd)
        mc, ok_c = km.match_brute_force_cuda(d1.cpu(), d2.cpu(), m1.cpu(), m2.cpu(),
                                             kp1.cpu(), kp2.cpu(), max_distance=maxd)
        n_diff = int((mk.cpu() != mc).sum())
        if n_diff > max(2, N1 // 200):
            raise AssertionError(f"K1 {N1}x{N2}: {n_diff} final matches differ from the CPU")
        P1, D = args[0].shape
        nbytes, flops = _k1_cost(P1, args[2].shape[0], D, True)
        # No single PyTorch call gives both directions' top-2: no library time.
        r = _timed(torch, [P1, args[2].shape[0], D], lambda: km._match_raw_cuda(*args),
                   lambda: km.match_raw_plain(*args), None, nbytes, flops, K1_KERNELS)
        r.update(max_abs_err=err, matches=int(ok_k.sum()), differ_from_cpu=n_diff)
        print(f"K1 match {N1}x{N2}x{D} (padded {P1}x{args[2].shape[0]}) prefilter {maxd:.0f}px: "
              f"max_abs_err {err:.3g}, {int(ok_k.sum())} matches ({n_diff} differ from CPU); "
              + _fmt(r), flush=True)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["shapes"].append(r)
    return out


# K1's batched layouts (slots, shared side: 0 none / 1 first / 2 second,
# prefilter) timed in the kernels phase.
K1_LAYOUTS = ((32, 1, True), (32, 2, True), (32, 0, True), (30, 1, False), (64, 0, False))


def check_match_batched(torch, dev, layouts=K1_LAYOUTS):
    """K1 with a slot axis at the mapper's batched shapes, each 1024x1024x128:
    32 slots with the first side shared and the prefilter on (the batched
    two-view search), 32 slots with the second side shared and the prefilter
    on (register_view_batch: loop-closure registration), 32 pairs with the
    prefilter on (register_view_pairs: the back-fill and the closure sweep),
    30 slots with the first side shared and no prefilter (the loop detector's
    match-count pre-gate over its 30 candidates) and 64 pairs without it (the
    closure sweep's pair pre-gate). Each is held slot by slot against its
    plain version, and bit for bit against the single-pair launch on every
    slot's pair."""
    from mavmap_tpu_torch.ops.cuda import match as km

    rng = __import__("numpy").random.default_rng(6)
    out = []
    for B, shared, prefilter in layouts:
        pairs, maxd = zip(*[_match_inputs(torch, rng, dev, 1024, 1024) for _ in range(B)])
        # Per-slot stacks of (d1, d2, m1, m2, kp1, kp2); the shared side is slot 0's.
        t = [pairs[0][i] if shared and i % 2 == shared - 1 else torch.stack([p[i] for p in pairs])
             for i in range(6)]
        args = km.padded_operands(*t, maxd[0] if prefilter else None)
        got = km._match_raw_cuda(*args)
        ref = km.match_raw_batched_plain(*args)
        torch.cuda.synchronize()
        what = f"batched {B} " + ("pairs", "shared first side", "shared second side")[shared]
        err = _check_match_slots(torch, got, ref, what)
        for b in range(B):
            single = km._match_raw_cuda(*[None if a is None else (a[b] if a.dim() == x else a)
                                          for a, x in zip(args[:6], (3, 2, 3, 2, 3, 3))],
                                        args[6])
            if not all(torch.equal(g[b], s) for g, s in zip(got, single)):
                raise AssertionError(f"K1 {what}: slot {b} differs from its single-pair launch")
        P1, D = args[0].shape[-2:]
        n1, n2 = (1 if shared == 1 else B), (1 if shared == 2 else B)
        nbytes = 4 * (n1 * P1 * D + n2 * P1 * D + n1 * P1 + n2 * P1
                      + (2 * (n1 + n2) * P1 if prefilter else 0)) + 12 * 2 * B * P1
        flops = B * (2 * P1 * P1 * D + (4 * P1 * P1 if prefilter else 0))
        r = _timed(torch, [B, P1, P1, D], lambda: km._match_raw_cuda(*args),
                   lambda: km.match_raw_batched_plain(*args), None, nbytes, flops, K1_KERNELS)
        r.update(max_abs_err=err, slots=B, shared_side=shared or None, prefilter=prefilter,
                 bitwise_single=True)
        print(f"K1 match {what} {B}x{P1}x{P1}x{D} prefilter {prefilter}: max_abs_err {err:.3g} "
              f"against the plain version, every slot equal bit for bit to its single-pair "
              f"launch; " + _fmt(r), flush=True)
        out.append(r)
    return out


def _seg_err(got, ref, scale):
    rel = (got - ref).abs() / (scale + 1e-30)
    return float((got - ref).abs().max()), float(rel.max())


def _check_seg_full_shape(torch, c, ids, S, what):
    """K2 on one (contributions, ids) pair with the ids' host plan: held to
    its plain version at 1e-5 of the per-segment sum of |contrib|, called
    twice to show it repeats bit for bit, and timed beside index_add_."""
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka

    rows, K = c.shape
    plan = ka.make_plan(ids.cpu().numpy(), S).to(c.device)
    got = ka.seg_accum_full(c, ids, S, plan)
    again = ka.seg_accum_full(c, ids, S, plan)
    ref = ka.seg_accum_full_plain(c, ids, S)
    abs_err, rel = _seg_err(got, ref, ka.seg_accum_full_plain(c.abs(), ids, S))
    if rel > 1e-5:
        raise AssertionError(f"K2 {what} ({rows},{K})->{S}: relative error {rel}")
    bitwise = bool(torch.equal(got, again))
    if not bitwise:
        raise AssertionError(f"K2 {what} ({rows},{K})->{S}: two calls differ")
    r = _timed(torch, [rows, K, S], lambda: ka.seg_accum_full(c, ids, S, plan),
               lambda: ka.seg_accum_full_plain(c, ids, S),
               lambda: torch.zeros((S, K), device=c.device).index_add_(0, ids, c),
               *_seg_cost(rows, K, S), K2_KERNELS)
    r.update(max_abs_err=abs_err, rel_err=rel, bitwise_repeat=bitwise)
    print(f"K2 seg_accum_full {what} ({rows},{K})->{S}: max_abs_err {abs_err:.3g} "
          f"(rel {rel:.3g}), repeats bit for bit: {bitwise}; " + _fmt(r), flush=True)
    return r


def check_seg_full(torch, dev):
    """K2 at the selfcal window/global shapes (unsorted ids)."""
    import numpy as np

    rng = np.random.default_rng(1)
    out = {"max_abs_err": 0.0, "shapes": []}
    for O, K, S in ((8192, 9, 17), (8192, 81, 17), (32768, 81, 289), (32768, 81, 1089)):
        c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
        ids = torch.as_tensor(rng.integers(0, S, O).astype(np.int32), device=dev)
        r = _check_seg_full_shape(torch, c, ids, S, "window")
        out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
        out["shapes"].append(r)
    return out


def _check_seg_sorted_shape(torch, c, off, S, what):
    """K3 on one (contributions, CSR offsets) pair: equal bit for bit to its
    plain version run on a CPU copy and to a second call, held to the plain
    version on the card (index_add_ with atomics) at 1e-5 of the
    per-segment sum of |contrib|, and timed beside torch.segment_reduce
    over the same offsets."""
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka

    rows, K = c.shape
    got = ka.seg_accum_sorted(c, off, S)
    again = ka.seg_accum_sorted(c, off, S)
    ref_cpu = ka.seg_accum_sorted_plain(c.cpu(), off.cpu(), S)
    bitwise_cpu = bool(torch.equal(got.cpu(), ref_cpu))
    bitwise = bool(torch.equal(got, again))
    if not (bitwise_cpu and bitwise):
        raise AssertionError(f"K3 {what} ({rows},{K})->{S}: equals the CPU's plain version "
                             f"bit for bit: {bitwise_cpu}; repeats: {bitwise}")
    ref = ka.seg_accum_sorted_plain(c, off, S)
    scale = ka.seg_accum_sorted_plain(c.abs(), off, S)
    abs_err, rel = _seg_err(got, ref, scale)
    if rel > 1e-5:
        raise AssertionError(f"K3 {what} ({rows},{K})->{S}: relative error {rel}")
    # The library call takes offsets from 0 over exactly the rows it sums
    # (unsafe=True skips its host-side checks, which would sync).
    n_rows, off_long = int(off[-1]), off.long()
    data = c[:n_rows]

    def library():
        return torch.segment_reduce(data, "sum", offsets=off_long, axis=0, unsafe=True)

    lib_err = _seg_err(library(), ref, scale)[1]
    if int(off[0]) != 0 or lib_err > 1e-5:
        raise AssertionError(f"K3 {what}: torch.segment_reduce disagrees ({lib_err})")
    r = _timed(torch, [rows, K, S], lambda: ka._seg_accum_sorted_cuda(c, off, S),
               lambda: ka.seg_accum_sorted_plain(c, off, S), library,
               4 * (n_rows * K + (S + 1) + S * K), n_rows * K, K3_KERNELS)
    r.update(max_abs_err=abs_err, rel_err=rel, bitwise_cpu=bitwise_cpu,
             bitwise_repeat=bitwise, rows_summed=n_rows)
    print(f"K3 seg_accum_sorted {what} ({rows},{K})->{S}, {n_rows} rows in segments: "
          f"max_abs_err {abs_err:.3g} (rel {rel:.3g}) against the card's plain version, equal "
          f"bit for bit to the CPU's and to a second call; " + _fmt(r), flush=True)
    return r


def check_seg_sorted(torch, dev):
    """K3 at the per-point shapes, track lengths like the mapper's."""
    import numpy as np

    rng = np.random.default_rng(2)
    out = {"max_abs_err": 0.0, "shapes": []}
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
        r = _check_seg_sorted_shape(torch, c, torch.as_tensor(offsets, device=dev), Pd,
                                    f"{len(lens)} tracks")
        out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
        out["shapes"].append(r)
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


def bench_loop(torch, dev, scene, prov, n_images, seed=0, keep_global=False):
    """bench.py's run() without its pipelining option, through the port:
    chains of CHAIN frames (process_chain_k, pad_to=CHAIN) with one
    deferred asynchronous 10-image self-calibrating window bundle
    adjustment per chain, process() where a chain cannot run, flush_ba and
    the 30-iteration global bundle adjustment. Returns (mapper, stats);
    with keep_global, stats["global_arrays"] holds the global problem's
    host arrays as they stand before its solve (outside the timings)."""
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

    window_prob = []

    def local_ba():
        window = sorted(m.image_idx_to_id)[-10:]
        if len(window) > 2:
            t0 = time.perf_counter()
            m.adjust_bundle(window[2:], window[:2], ba_options=window_ba, async_=True,
                            defer=True)
            st["window_ba_s"] += time.perf_counter() - t0
            window_prob[:] = [m._deferred_ba[-1][2]]  # the problem as built, not yet solved

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
    global_arrays = None
    if keep_global:
        t0 = time.perf_counter()
        _, poses, _, points, oi, op, oc, xy = m.ba_problem_arrays()
        global_arrays = dict(
            poses=poses, points=points, cam_params=m.store.camera_params.astype("float32"),
            cam_models=m.store.camera_models.copy(), obs_image=oi, obs_point=op, obs_cam=oc,
            obs_uv=xy)
        t_start += time.perf_counter() - t0
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
               "two_stage_selfcal": "ba_selfcal_iters" in c,
               "window_prob": window_prob[0] if window_prob else None,
               "global_arrays": global_arrays}


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


def _map_state(m, ate):
    """What a run mapped: registered poses, valid 3-D points and the ATE."""
    import numpy as np

    reg = [iid for iid in range(m.store.num_images) if m.store.image_registered[iid]]
    return {"poses": np.concatenate([m.store.image_rvecs[reg], m.store.image_tvecs[reg]], 1),
            "points": m.store.point3D_xyz[m.store.point3D_valid].copy(), "ate": ate}


def chained_phase(torch, dev, name="chained"):
    """bench.py's chained loop over bench.py's 30-image scene. Returns
    (launches, the map's state, the mapper, its last window problem)."""
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    _phase(name)
    scene, prov = _bench_scene()
    build.reset_launches()
    m, s = bench_loop(torch, dev, scene, prov, NUM_IMAGES)
    launches = dict(build.launches)
    ate = float(mapper_ate(m, scene))
    limit = min(0.05, 2.0 * JAX_CPU_CHAINED_ATE_M)
    _report_loop(name, m, NUM_IMAGES, ate, limit, s, launches)
    _check_map(m, NUM_IMAGES, NUM_IMAGES, ate, limit, name)
    lm_iters = s["window_iters"] + s["global"]["iterations"]
    _check_launches(name, launches, NUM_IMAGES - 1, lm_iters, f"{lm_iters} LM iterations")
    return launches, _map_state(m, ate), m, s["window_prob"]


def check_repeat(first, second):
    """The chained loop run twice maps the same bits: every sum of the path
    adds in an order fixed by a plan, and RANSAC draws from a seeded
    generator."""
    import numpy as np

    same = {k: bool(np.array_equal(first[k], second[k])) for k in ("poses", "points", "ate")}
    print(f"chained run twice: bitwise equal {json.dumps(same)}; ATE {first['ate']!r} / "
          f"{second['ate']!r} m, {len(first['points'])} / {len(second['points'])} points",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"chained loop: two runs differ ({same})")
    return same


def check_ptblk_shapes(torch, dev, m, window_prob):
    """K2 at the shapes of the dense self-calibrating step's per-(point,
    block) aggregation (plan_ptblk: [That | Ghat] of both block entries,
    54 columns, into Pd B segments), random values on the ids of the chained
    loop's last window problem and of its global problem, beside
    index_add_."""
    import numpy as np
    from mavmap_tpu_torch.ba import build_problem
    from mavmap_tpu_torch.ba.core import plan_ids

    _phase("kernels at the per-(point, block) shapes")
    _, poses, _, points, oi, op, oc, xy = m.ba_problem_arrays()
    global_prob = build_problem(poses, points, m.store.camera_params, m.store.camera_models,
                                oi, op, oc, xy, bucket=True)
    rng = np.random.default_rng(4)
    out = []
    for what, prob in (("window ptblk", window_prob), ("global ptblk", global_prob)):
        ids, S = plan_ids(prob, "plan_ptblk")
        c = torch.as_tensor(rng.normal(size=(len(ids), 54)).astype(np.float32), device=dev)
        out.append(_check_seg_full_shape(torch, c, torch.as_tensor(ids.astype(np.int32),
                                                                   device=dev), S, what))
    return out


def _survey_scene():
    """benchmarks/pipeline_scale.py's scene cut to SURVEY_IMAGES images in 4
    rows, with its rendered features (capacity 1024) and each feature's
    true point id (-1: clutter)."""
    import numpy as np
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_features

    t0 = time.perf_counter()
    scene = make_uav_scene(num_images=SURVEY_IMAGES, num_points=120 * SURVEY_IMAGES,
                           relief=10.0, rows=4, extent=None, seed=13)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=32, seed=13)
    feats = [(k[:1024], d[:1024]) for k, d in feats]
    gt = [g[:1024] for g in gt]
    print(f"survey scene: {SURVEY_IMAGES} images, {len(scene.points3D)} points, "
          f"{np.mean([len(k) for k, _ in feats]):.1f} features per image, rendered in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return scene, feats, gt


def survey_phase(torch, dev, scene, feats):
    """bench.py's chained loop over benchmarks/pipeline_scale.py's scene at
    SURVEY_IMAGES images; the global BA resolves to CG. Returns (launches,
    the global problem as built for the kernel checks, its host arrays
    before the global solve for the mesh phase's distributed solve)."""
    from mavmap_tpu_torch.ba import build_problem
    from mavmap_tpu_torch.ba.core import solver_plans, with_plans
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    _phase("survey")
    prov = _provider(feats)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    m, s = bench_loop(torch, dev, scene, prov, SURVEY_IMAGES, keep_global=True)
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
    # Host time of the K2 plans of this problem: those of the solver that
    # ran (what bundle_adjust builds) and all five (the per-(point, block)
    # plans key Pd B segments: the dense solver's alone).
    names = solver_plans(True, g["solver"])
    t0 = time.perf_counter()
    with_plans(prob, names)
    t1 = time.perf_counter()
    with_plans(prob)
    t2 = time.perf_counter()
    print(f"survey global problem's K2 plans: {1000 * (t1 - t0):.1f} ms of host time for "
          f"the {g['solver']} solver's {list(names)}, {1000 * (t2 - t1):.1f} ms for all five",
          flush=True)
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
    return launches, prob, s["global_arrays"]


def check_survey_shapes(torch, dev, prob):
    """K2/K3 at the survey's global CG shapes, random values on the real ids:
    K2 (2O, 9) and (2O, 81) into the B = I + C blocks (the selfcal matvec
    and preconditioner reduce both entries of every observation at once),
    K2 (O, 81) with every row on the camera block's id, K2 (O, 6) into I
    (the pose-only matvec); K3 (O, 3) into the dense points (both
    matvecs)."""
    import numpy as np

    rng = np.random.default_rng(3)
    I, C = prob.poses.shape[0], prob.cam_params.shape[0]
    B = I + C
    obs_image = prob.obs_image.astype(np.int32)
    O = len(obs_image)
    ids2 = np.concatenate([obs_image, I + prob.obs_cam]).astype(np.int32)
    out = {"max_abs_err": 0.0, "full": [], "sorted": []}
    for what, seg, K, S in (("survey", ids2, 9, B), ("survey", ids2, 81, B),
                            ("survey one id", np.full(O, I, np.int32), 81, B),
                            ("survey", obs_image, 6, I)):
        c = torch.as_tensor(rng.normal(size=(len(seg), K)).astype(np.float32), device=dev)
        r = _check_seg_full_shape(torch, c, torch.as_tensor(seg, device=dev), S, what)
        out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
        out["full"].append(r)
    offsets = prob.pt_offsets.astype(np.int32)
    Pd = len(offsets) - 1
    c = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32), device=dev)
    r = _check_seg_sorted_shape(torch, c, torch.as_tensor(offsets, device=dev), Pd, "survey")
    out["sorted_err"] = r["max_abs_err"]
    out["sorted"].append(r)
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


# ------------------------------------------------------- batched geometry

GEOMETRY_SLOTS = (1, 8, 32)


def geometry_inputs(torch, dev, scene, feats, gt, B, first=0):
    """register_view_pairs' inputs for B consecutive pairs (i + 1, i) of the
    survey from image `first` on, at the mapper's options: features at
    capacity 1024, each previous image's track state from the ground truth
    (80 % of its true points triangulated, 90 % of those stable, 1 cm of
    noise)."""
    import numpy as np
    from mavmap_tpu_torch.models import camera as cam

    F = 1024
    K = np.asarray(scene.cam_params[0], np.float32)
    rng = np.random.default_rng(first)

    def image(i):
        kp, de = feats[i]
        k, d, m = np.zeros((F, 2), np.float32), np.zeros((F, 128), np.float32), np.zeros(F, bool)
        k[:len(kp)], d[:len(kp)], m[:len(kp)] = kp, de, True
        return k, d, m, cam.image2normalized_np(k, 1, K).astype(np.float32)

    def state(i):
        ids = np.full(F, -1)
        ids[:len(gt[i])] = gt[i]
        has_tri = (ids >= 0) & (rng.random(F) < 0.8)
        xyz = np.zeros((F, 3), np.float32)
        xyz[has_tri] = scene.points3D[ids[has_tri]] + rng.normal(size=(has_tri.sum(), 3)) * 0.01
        return (xyz, has_tri, has_tri & (rng.random(F) < 0.9),
                np.asarray(scene.rvecs[i], np.float32), np.asarray(scene.tvecs[i], np.float32))

    idx = [first + b for b in range(B)]
    prevs = [image(i) for i in idx]
    currs = [image(i + 1) for i in idx]
    states = [state(i) for i in idx]

    def stack(items, k):
        return torch.as_tensor(np.stack([it[k] for it in items]), device=dev)

    nt = 4.0 / float((K[0] + K[1]) / 2.0)
    return ([stack(prevs, k) for k in range(4)] + [stack(currs, k) for k in range(4)]
            + [stack(states, k) for k in range(5)]
            + [torch.as_tensor(np.stack([K] * B), device=dev), [1] * B, 0.9, 1e9, [nt] * B])


def device_busy(torch, fn):
    """(device ms, window ms) of one call of fn under torch.profiler: the
    CUDA activity summed over the window, and the window's host wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) or
                 getattr(e, "self_cuda_time_total", 0.0) for e in prof.key_averages())
    return dev_us / 1000.0, 1000.0 * wall


def batched_geometry_phase(torch, dev, scene, feats, gt):
    """One register_view_pairs step (the back-fill's and the closure
    sweeps' batched step) on the survey's features at B = 1, 8 and 32: host
    ms per slot from the call to its outputs on the host (as the mapper's
    batch_register_s counts it; median of 3 after a warm-up), the device's
    busy share (torch.profiler's CUDA time over one call's window), peak
    device memory, host syncs per step (CUDA's sync debug mode) and K1
    launches per step, all with vmap's per-sample fallback disabled (an op
    without a batching rule raises). Then slot by slot, the 32-slot step
    against register_view on the same pairs with generators seeded alike:
    how many slots give the same bits, and the largest float differences.
    Fails unless every slot registers (P3P success, > 20 inliers) at every
    B and the counts and masks agree slot by slot."""
    import numpy as np
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.sfm.kernels import register_view, register_view_pairs
    from mavmap_tpu_torch.utils.timer import count_syncs

    _phase("batched geometry")
    torch._C._functorch._set_vmap_fallback_enabled(False)
    records = []
    try:
        for B in GEOMETRY_SLOTS:
            args = geometry_inputs(torch, dev, scene, feats, gt, B)
            gen = torch.Generator(device=dev)
            gen.manual_seed(B)

            def step():
                rows, scalars = register_view_pairs(gen, *args, p3p_trials=512)
                return rows.cpu().numpy(), scalars.cpu().numpy()

            step()  # warm-up
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows, scalars = step()
                walls.append(time.perf_counter() - t0)
            torch.cuda.reset_peak_memory_stats(dev)
            build.reset_launches()
            syncs, _ = count_syncs(lambda: register_view_pairs(gen, *args, p3p_trials=512))
            k1 = build.launches["match"]
            peak = torch.cuda.max_memory_allocated(dev)
            dev_ms, window_ms = device_busy(torch, step)
            wall = statistics.median(walls)
            rec = dict(B=B, host_ms_per_step=1000 * wall, host_ms_per_slot=1000 * wall / B,
                       device_ms=dev_ms, window_ms=window_ms, busy=dev_ms / window_ms,
                       peak_mib=peak / 2**20, syncs=syncs, k1_launches=k1,
                       p3p_success=int(scalars[:, 5].sum()), min_inliers=int(scalars[:, 4].min()))
            records.append(rec)
            print("batched geometry " + json.dumps(rec), flush=True)
            if rec["p3p_success"] != B or rec["min_inliers"] <= 20:
                raise AssertionError(f"batched geometry: B={B} registered "
                                     f"{rec['p3p_success']}/{B} slots, min inliers "
                                     f"{rec['min_inliers']}")
            if k1 != 1:
                raise AssertionError(f"batched geometry: {k1} K1 launches in one step")

        B = GEOMETRY_SLOTS[-1]
        args = geometry_inputs(torch, dev, scene, feats, gt, B)
        g1, g2 = torch.Generator(device=dev), torch.Generator(device=dev)
        g1.manual_seed(7)
        g2.manual_seed(7)
        rows, scalars = register_view_pairs(g1, *args, p3p_trials=512)
        same, pose_d, cost_r = 0, 0.0, 0.0
        for b in range(B):
            one = [a[b] for a in args[:14]] + [args[14][b], args[15], args[16], args[17][b]]
            r, s = register_view(g2, *one, p3p_trials=512)
            same += int(torch.equal(rows[b], r) and torch.equal(scalars[b], s))
            if not (torch.equal(rows[b, :, :3], r[:, :3])
                    and torch.equal(scalars[b, [0, 2, 3, 4, 5]], s[[0, 2, 3, 4, 5]])):
                raise AssertionError(f"batched geometry: slot {b} of {B} counts or masks "
                                     "differ from register_view's")
            pose_d = max(pose_d, float((scalars[b, 7:13] - s[7:13]).abs().max()))
            cost_r = max(cost_r, float((scalars[b, 6] - s[6]).abs() / s[6].abs()))
        print(f"batched geometry: {same}/{B} slots of the {B}-slot step equal register_view "
              f"bit for bit; counts and masks equal in all; largest pose difference "
              f"{pose_d!r}, largest relative cost difference {cost_r!r}", flush=True)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    if records[-1]["syncs"] > records[0]["syncs"]:
        raise AssertionError(f"batched geometry: {records[-1]['syncs']} host syncs per step "
                             f"at B={records[-1]['B']} against {records[0]['syncs']} at B=1")
    return records


def pipeline_tree(feats, dev):
    """benchmarks/pipeline_scale.py's vocabulary tree of the survey: 8000
    rows of every 10th image's descriptors (default_rng(0) permutation),
    branching 8, depth 2, 3 iterations, trained on `dev`."""
    import numpy as np
    from mavmap_tpu_torch.loop import train_voc_tree

    t0 = time.perf_counter()
    desc = np.concatenate([d for _, d in feats[::10]])
    tree = train_voc_tree(desc[np.random.default_rng(0).permutation(len(desc))[:8000]],
                          branching=8, depth=2, iters=3, device=dev)
    print(f"pipeline: vocabulary tree of {tree.num_words} words trained in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return tree


def pipeline_phase(torch, dev, scene, feats):
    """run_pipeline in sequential mode over the survey's scene and features,
    with benchmarks/pipeline_scale.py's vocabulary tree and options; held
    to the JAX package's registered count and 2x its ATE on the CPU, and
    required to close loops and to launch batched K1."""
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.sfm.pipeline import PipelineOptions, run_pipeline
    from mavmap_tpu_torch.utils.synthetic import mapper_ate, mapper_ate_profile

    _phase("pipeline")
    tree = pipeline_tree(feats, dev)
    opts = PipelineOptions(**PIPELINE_OPTS)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    res = run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                       _provider(feats), opts, voc_tree=tree, device=dev)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches, slots = dict(build.launches), dict(build.slots)
    peak = torch.cuda.max_memory_allocated(dev)
    m = res.main_mapper
    nreg = m.num_proc_images
    ate = float(mapper_ate(m, scene))
    limit = 2.0 * JAX_CPU_PIPELINE_ATE_M
    rep = m.report()
    print(f"pipeline: registered {nreg}/{SURVEY_IMAGES} in {len(res.mappers)} map(s) in "
          f"{wall:.3f} s = {SURVEY_IMAGES / wall:.3f} frames/s; ATE {ate!r} m (limit "
          f"{limit:.6f} m, the JAX package's {JAX_CPU_PIPELINE_ATE_M} m); "
          f"{m.store.num_points3D} 3-D points", flush=True)
    print("pipeline timings_s " + json.dumps({k: round(v, 4) for k, v in res.timings.items()}),
          flush=True)
    print("pipeline counters " + json.dumps(rep), flush=True)
    print("pipeline ATE profile per 50 frames " + " ".join(
        f"[{s}:+{n}]={e:.6f}" for s, n, e in mapper_ate_profile(m, scene, block=50)), flush=True)
    single = launches["match"] - launches["match_batched"]
    per_launch = slots["match_batched"] / max(launches["match_batched"], 1)
    slot_ms = 1000 * rep.get("batch_register_s", 0.0) / max(rep.get("batch_register_slots", 0), 1)
    print(f"pipeline K1 launches: {single} single, {launches['match_batched']} batched with "
          f"{slots['match_batched']} slots ({per_launch:.2f} per batched launch); batched "
          f"registration {slot_ms:.2f} ms of host time per slot over "
          f"{rep.get('batch_register_slots', 0)} slots; K2 {launches['seg_accum_full']}, "
          f"K3 {launches['seg_accum_sorted']} launches; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    _check_map(m, SURVEY_IMAGES, JAX_CPU_PIPELINE_REGISTERED, ate, limit, "pipeline")
    closures = rep.get("loop_closures", 0) + rep.get("sweep_closures", 0)
    if closures <= 0:
        raise AssertionError("pipeline: no loop closure committed")
    if launches["match_batched"] <= 0:
        raise AssertionError("pipeline: batched K1 never launched")
    lm_iters = rep.get("ba_iters", 0) + rep.get("global_ba_iters", 0)
    _check_launches("pipeline", launches, SURVEY_IMAGES - 1, lm_iters, f"{lm_iters} LM iterations")
    return dict(launches, match_batched_slots=slots["match_batched"]), _map_summary(res, scene,
                                                                                   wall)


def _map_summary(res, scene, wall):
    """What the mesh phase compares between one and two ranks: registered
    images, their poses, the ATE, the closures, the host ms per batched
    slot and the wall seconds."""
    import numpy as np
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    m = res.main_mapper
    reg = sorted(m.image_idx_to_id)
    rep = m.report()
    return dict(registered=reg, poses=np.stack([np.concatenate(m.get_pose(i)) for i in reg]),
                ate=float(mapper_ate(m, scene)), maps=len(res.mappers),
                closures=rep.get("loop_closures", 0) + rep.get("sweep_closures", 0),
                slot_ms=1000 * rep.get("batch_register_s", 0.0)
                / max(rep.get("batch_register_slots", 0), 1),
                slots=rep.get("batch_register_slots", 0), wall=wall,
                global_ba_s=res.timings.get("global_ba", 0.0),
                collective_s=rep.get("ba_collective_s", 0.0))


# --------------------------------------------------------------------- mesh

MESH_RANKS = 2
# The global solves of the mesh phase: the pipeline's global BA options
# with the intrinsics held fixed (the distributed solve's stage 2).
MESH_BA = dict(max_num_iterations=50, function_tolerance=1e-4, min_track_len=2)
# Bounds on the largest pose difference to one process, set from the first
# card runs (NVIDIA H100 80GB HBM3: 2.73e-5 for the global BA, 2.20e-4 for
# the pipeline's map): a dropped or doubled sum in the distributed solve
# still descends, and may still end near the one-process cost.
MESH_BA_POSE_TOL = 5e-4
MESH_PIPELINE_POSE_TOL = 2e-3


def _global_states(n):
    return [1, 2] + [0] * (n - 2)  # BA_POSE_FIXED, BA_POSE_FIXED_X, free


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def mesh_rank(mesh, raw, geometry_first):
    """One rank of the mesh phase (a spawned process; returns its results
    to the launcher): (c) its block of the 32-slot register_view_pairs
    step, (a) the distributed global BA of the survey's problem, twice, and
    (b) run_pipeline with mesh_devices=MESH_RANKS over the survey. The
    launch counters are zeroed before each and read after it."""
    import torch
    import torch.distributed as dist
    from mavmap_tpu_torch.ba import BAOptions
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.parallel import (dist_bundle_adjust, dist_register_view_pairs,
                                           partition_problem)
    from mavmap_tpu_torch.sfm.pipeline import PipelineOptions, run_pipeline

    dev = mesh.device
    if dev.type == "cuda":
        build.library()  # the launcher built it: a failed load raises here
    scene, feats, gt = _survey_scene()
    out = dict(rank=mesh.rank, backend=dist.get_backend(), device=str(dev),
               name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")

    # (c) the 32-slot step, this rank's block.
    args = geometry_inputs(torch, dev, scene, feats, gt, GEOMETRY_SLOTS[-1], geometry_first)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    build.reset_launches()
    rows, scalars = dist_register_view_pairs(mesh, gen, *args, p3p_trials=512)
    out["step"] = dict(rows=rows.cpu().numpy(), scalars=scalars.cpu().numpy(),
                       block=mesh.block(GEOMETRY_SLOTS[-1]), launches=dict(build.launches))

    # (a) the distributed global BA, twice.
    prob, new_index, per = partition_problem(
        raw["poses"], raw["points"], raw["cam_params"], raw["cam_models"], raw["obs_image"],
        raw["obs_point"], raw["obs_cam"], raw["obs_uv"], mesh.size,
        pose_states=_global_states(len(raw["poses"])), bucket=True, shard=mesh.rank)
    solves = []
    for _ in range(2):
        build.reset_launches()
        _sync(torch, dev)
        t0 = time.perf_counter()
        poses, points, info = dist_bundle_adjust(mesh, prob, BAOptions(**MESH_BA), per)
        wall = time.perf_counter() - t0
        solves.append(dict(poses=poses, points=points[new_index], info=info, wall=wall,
                           launches=dict(build.launches), obs=int(prob.obs_mask.sum()),
                           shard_rows=int(prob.obs_mask.shape[0]),
                           dense_points=int(prob.point_rows.shape[0])))
    out["ba"] = solves

    # (b) the pipeline on every rank.
    tree = pipeline_tree(feats, dev)
    build.reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    res = run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                       _provider(feats), PipelineOptions(**PIPELINE_OPTS,
                                                         mesh_devices=mesh.size),
                       voc_tree=tree, device=dev)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    out["pipeline"] = dict(_map_summary(res, scene, wall), launches=dict(build.launches),
                           counters=res.main_mapper.report(), timings=res.timings)
    return out


def mesh_phase(torch, dev, scene, feats, gt, raw, pipe_ref):
    """The distributed path on MESH_RANKS ranks that share the card (gloo,
    host-staged collectives), started with parallel.launch (a rank that
    fails fails the launch, and the smoke). Against one process: (a) the
    distributed global BA of the survey's problem against bundle_adjust
    (final cost within 1 %, poses within MESH_BA_POSE_TOL, the second solve
    the first's bits), (b) run_pipeline with mesh_devices=MESH_RANKS
    against the pipeline phase's run (PERF.md section 2's limits: every
    image, ATE, closures; the same registered images and closures, poses
    within MESH_PIPELINE_POSE_TOL), (c) the 32-slot register_view_pairs
    step split over the ranks against the unsharded step, slot by slot, bit
    for bit. K1-K3 must launch on every rank. Returns (the ranks' summed
    launches of (b), the kernels timed at a rank's shapes)."""
    import numpy as np
    from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
    from mavmap_tpu_torch.parallel import launch
    from mavmap_tpu_torch.sfm.kernels import register_view_pairs

    _phase("mesh")
    B = GEOMETRY_SLOTS[-1]
    first = 0  # the batched geometry phase's pairs 0->1 .. 31->32
    args = geometry_inputs(torch, dev, scene, feats, gt, B, first)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows, scalars = register_view_pairs(gen, *args, p3p_trials=512)
    rows, scalars = rows.cpu().numpy(), scalars.cpu().numpy()

    prob = build_problem(raw["poses"], raw["points"], raw["cam_params"], raw["cam_models"],
                         raw["obs_image"], raw["obs_point"], raw["obs_cam"], raw["obs_uv"],
                         pose_states=_global_states(len(raw["poses"])), bucket=True)
    _sync(torch, dev)
    t0 = time.perf_counter()
    p1, x1, info1 = bundle_adjust(prob, BAOptions(**MESH_BA), dev)
    wall1 = time.perf_counter() - t0

    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, dev.type, args=(raw, first))
    launch_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"mesh: {MESH_RANKS} ranks, backend {r0['backend']}, devices "
          f"{[r['device'] for r in ranks]} ({r0['name']}); the launch took {launch_s:.1f} s",
          flush=True)

    # (c)
    for r in ranks:
        diff = [b for b in range(B) if not (_same_bits(r["step"]["rows"][b], rows[b])
                                            and _same_bits(r["step"]["scalars"][b], scalars[b]))]
        if diff:
            raise AssertionError(f"mesh (c): rank {r['rank']}'s gathered {B}-slot step differs "
                                 f"from the unsharded step in slots {diff}")
    print(f"mesh (c): the {B}-slot register_view_pairs step split over the ranks "
          f"(blocks {[r['step']['block'] for r in ranks]}, K1 launches per rank "
          f"{[r['step']['launches']['match'] for r in ranks]}): {B}/{B} slots equal the "
          f"unsharded step bit for bit on every rank", flush=True)

    # (a)
    it1 = max(info1["iterations"], 1)
    first_solve, second_solve = r0["ba"]
    for r in ranks:
        for k in range(2):
            for key in ("poses", "points"):
                if not _same_bits(r["ba"][k][key], first_solve[key]):
                    raise AssertionError(f"mesh (a): rank {r['rank']} solve {k + 1} {key} "
                                         "differ from rank 0's first solve")
    info = first_solve["info"]
    it2 = max(info["iterations"], 1)
    n = len(raw["poses"])
    pose_d = float(np.abs(first_solve["poses"][:n] - p1[:n]).max())
    rel = abs(info["final_cost"] - info1["final_cost"]) / info1["final_cost"]
    rec = dict(observations=int(len(raw["obs_uv"])), points=int(len(raw["points"])),
               cameras=int(len(raw["poses"])), solver=info["solver"],
               shard_observations=[r["ba"][0]["obs"] for r in ranks],
               shard_dense_points=[r["ba"][0]["dense_points"] for r in ranks],
               initial_cost=info["initial_cost"], final_cost=info["final_cost"],
               single_final_cost=info1["final_cost"], rel_cost_diff=rel,
               lm_iters=info["iterations"], single_lm_iters=info1["iterations"],
               cg_iters=info["cg_iters"], single_cg_iters=info1["cg_iters"],
               max_pose_diff=pose_d, ms_per_lm_iter_1rank=1000 * wall1 / it1,
               ms_per_lm_iter_2ranks=[1000 * r["ba"][0]["wall"] / it2 for r in ranks],
               ms_per_lm_iter_2ranks_repeat=[1000 * r["ba"][1]["wall"] / it2 for r in ranks],
               collective_ms_per_lm_iter=[1000 * r["ba"][0]["info"]["collective_s"] / it2
                                          for r in ranks],
               collectives_per_lm_iter=r0["ba"][0]["info"]["collectives"] / it2,
               launches=[r["ba"][0]["launches"] for r in ranks])
    print("mesh (a) global BA " + json.dumps(rec), flush=True)
    if info["solver"] != "cg":
        raise AssertionError(f"mesh (a): the distributed solve ran {info['solver']}, not CG")
    if not rel < 0.01:
        raise AssertionError(f"mesh (a): final cost {info['final_cost']} against "
                             f"{info1['final_cost']} on one device")
    if not pose_d <= MESH_BA_POSE_TOL:
        raise AssertionError(f"mesh (a): poses {pose_d} from the one-device solve's "
                             f"(bound {MESH_BA_POSE_TOL})")
    print(f"mesh (a): the second {MESH_RANKS}-rank solve repeats the first bit for bit on "
          f"every rank", flush=True)

    # (b)
    p0 = r0["pipeline"]
    for r in ranks[1:]:
        if not (r["pipeline"]["registered"] == p0["registered"]
                and _same_bits(r["pipeline"]["poses"], p0["poses"])):
            raise AssertionError(f"mesh (b): rank {r['rank']}'s map differs from rank 0's")
    common = sorted(set(p0["registered"]) & set(pipe_ref["registered"]))
    ia = [p0["registered"].index(i) for i in common]
    ib = [pipe_ref["registered"].index(i) for i in common]
    pose_d = float(np.abs(p0["poses"][ia] - pipe_ref["poses"][ib]).max()) if common else None
    limit = 2.0 * JAX_CPU_PIPELINE_ATE_M
    rec = dict(registered=len(p0["registered"]), maps=p0["maps"], ate=p0["ate"],
               ate_1rank=pipe_ref["ate"], closures=p0["closures"],
               closures_1rank=pipe_ref["closures"],
               wall_s=[r["pipeline"]["wall"] for r in ranks], wall_1rank_s=pipe_ref["wall"],
               host_ms_per_slot=[r["pipeline"]["slot_ms"] for r in ranks],
               host_ms_per_slot_1rank=pipe_ref["slot_ms"], slots=p0["slots"],
               global_ba_s=[r["pipeline"]["global_ba_s"] for r in ranks],
               collective_s=[r["pipeline"]["collective_s"] for r in ranks],
               max_pose_diff_vs_1rank=pose_d,
               launches=[r["pipeline"]["launches"] for r in ranks],
               timings_s=[{k: round(v, 4) for k, v in r["pipeline"]["timings"].items()}
                          for r in ranks])
    print("mesh (b) pipeline " + json.dumps(rec), flush=True)
    if len(p0["registered"]) < JAX_CPU_PIPELINE_REGISTERED or p0["maps"] != 1:
        raise AssertionError(f"mesh (b): registered {len(p0['registered'])}/{SURVEY_IMAGES} "
                             f"in {p0['maps']} maps")
    if not p0["ate"] < limit:
        raise AssertionError(f"mesh (b): ATE {p0['ate']} m >= {limit} m")
    if p0["closures"] <= 0:
        raise AssertionError("mesh (b): no loop closure committed")
    if p0["registered"] != pipe_ref["registered"] or p0["closures"] != pipe_ref["closures"]:
        raise AssertionError(f"mesh (b): {len(p0['registered'])} registered and "
                             f"{p0['closures']} closures against one process's "
                             f"{len(pipe_ref['registered'])} and {pipe_ref['closures']}")
    if not pose_d <= MESH_PIPELINE_POSE_TOL:
        raise AssertionError(f"mesh (b): poses {pose_d} from one process's "
                             f"(bound {MESH_PIPELINE_POSE_TOL})")
    for r in ranks:
        for what, launches in (("(a)", r["ba"][0]["launches"]),
                               ("(b)", r["pipeline"]["launches"])):
            need = ("seg_accum_full", "seg_accum_sorted") + (("match",) if what == "(b)" else ())
            for k in need:
                if launches[k] <= 0:
                    raise AssertionError(f"mesh {what}: rank {r['rank']} never launched {k}")
        if r["step"]["launches"]["match"] != 1:
            raise AssertionError(f"mesh (c): rank {r['rank']} launched K1 "
                                 f"{r['step']['launches']['match']} times")
    total = {k: sum(r["pipeline"]["launches"][k] for r in ranks)
             for k in r0["pipeline"]["launches"]}
    return total, check_shard_shapes(torch, dev, raw)


def check_shard_shapes(torch, dev, raw):
    """The kernels at one rank's shapes of the mesh phase: K2 and K3 at
    rank 0's shard of the survey's global problem (the CG matvec's (O, 6)
    into the I images and (O, 3) into its dense points), K1 at the
    register_view_pairs block of MESH_RANKS ranks (16 slots), each held to
    its plain version and timed as in the kernels phase."""
    import numpy as np
    from mavmap_tpu_torch.parallel import partition_problem

    _phase("kernels at a rank's shapes")
    prob, _, _ = partition_problem(
        raw["poses"], raw["points"], raw["cam_params"], raw["cam_models"], raw["obs_image"],
        raw["obs_point"], raw["obs_cam"], raw["obs_uv"], MESH_RANKS,
        pose_states=_global_states(len(raw["poses"])), bucket=True, shard=0)
    rng = np.random.default_rng(4)
    O, I = prob.obs_image.shape[0], prob.poses.shape[0]
    c = torch.as_tensor(rng.normal(size=(O, 6)).astype(np.float32), device=dev)
    full = _check_seg_full_shape(torch, c, torch.as_tensor(prob.obs_image, device=dev), I,
                                 "rank 0's shard")
    Pd = prob.point_rows.shape[0]
    c = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32), device=dev)
    srt = _check_seg_sorted_shape(torch, c, torch.as_tensor(prob.pt_offsets, device=dev), Pd,
                                  "rank 0's shard")
    batched = check_match_batched(torch, dev, ((GEOMETRY_SLOTS[-1] // MESH_RANKS, 0, True),))
    return dict(full=[full], sorted=[srt], batched=batched)


# ------------------------------------------------------------------ submaps


def blackout(feats, frames):
    """`feats` with the descriptors of `frames` (in that order) replaced by
    unit rows of rng.normal, rng = default_rng(0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    feats = list(feats)
    for i in frames:
        d = rng.normal(size=feats[i][1].shape).astype(np.float32)
        feats[i] = (feats[i][0], d / np.linalg.norm(d, axis=1, keepdims=True))
    return feats


def submap_scenes(synthetic):
    """The submaps phase's two inputs, from `synthetic` (this package's
    utils.synthetic, or the JAX package's in the yardstick): {run: (scene,
    features (capacity 1024), descriptor rows for the vocabulary tree or
    None)}."""
    import numpy as np

    scene = synthetic.make_uav_scene(num_images=NUM_IMAGES, num_points=4000, relief=10.0,
                                     rows=2, seed=11)
    feats, _ = synthetic.render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
    out = {"restart": (scene, blackout([(k[:1024], d[:1024]) for k, d in feats],
                                       RESTART_FRAMES), None)}
    scene = synthetic.make_uav_scene(num_images=SEGMENT_IMAGES, num_points=120 * SEGMENT_IMAGES,
                                     relief=10.0, rows=2, extent=None, seed=13)
    feats, _ = synthetic.render_features(scene, pixel_noise=0.3, clutter=64, seed=13)
    feats = [(k[:1024], d[:1024]) for k, d in feats]
    desc = np.concatenate([d for _, d in feats[::5]])
    out["segments"] = (scene, feats, desc[np.random.default_rng(0).permutation(len(desc))[:8000]])
    return out


def submaps_phase(torch, dev):
    """run_pipeline over two runs that end in sub-maps (see the module
    docstring, 11): each must end in one merged map with at least the JAX
    package's registered count and under 2x its ATE, a "merge" stage, K2
    and K3 launched, on the native track store; the segments run must also
    launch batched K1 inside SequentialMapper.merge (its cross-loop
    closures) and end the closures with more common images than before."""
    from mavmap_tpu_torch.loop import train_voc_tree
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.sfm import SequentialMapper
    from mavmap_tpu_torch.sfm.pipeline import PipelineOptions, run_pipeline
    from mavmap_tpu_torch.utils import synthetic

    _phase("submaps")
    in_merge = {}
    merge = SequentialMapper.merge

    def counted_merge(self, other, **kw):
        before = build.launches["match_batched"], build.slots["match_batched"]
        try:
            return merge(self, other, **kw)
        finally:
            in_merge["match_batched"] = (in_merge.get("match_batched", 0)
                                         + build.launches["match_batched"] - before[0])
            in_merge["slots"] = in_merge.get("slots", 0) + build.slots["match_batched"] - before[1]

    total = {}
    SequentialMapper.merge = counted_merge
    try:
        for name, (scene, feats, tree_rows) in submap_scenes(synthetic).items():
            tree = None
            if tree_rows is not None:
                t0 = time.perf_counter()
                tree = train_voc_tree(tree_rows, branching=8, depth=2, iters=3, device=dev)
                print(f"submaps {name}: vocabulary tree of {tree.num_words} words trained in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
            in_merge.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            build.reset_launches()
            _sync(torch, dev)
            t0 = time.perf_counter()
            opts = RESTART_OPTS if name == "restart" else SEGMENT_OPTS
            res = run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                               _provider(feats), PipelineOptions(**opts), voc_tree=tree,
                               device=dev)
            _sync(torch, dev)
            wall = time.perf_counter() - t0
            launches, slots = dict(build.launches), dict(build.slots)
            for k, v in dict(launches, match_batched_slots=slots["match_batched"]).items():
                total[k] = total.get(k, 0) + v
            _check_submaps(torch, dev, name, res, scene, wall, launches, slots, dict(in_merge))
    finally:
        SequentialMapper.merge = merge
    return total


def _check_submaps(torch, dev, name, res, scene, wall, launches, slots, in_merge):
    from mavmap_tpu_torch.utils.synthetic import mapper_ate

    m = res.main_mapper
    n = len(scene.image_cameras)
    ref = JAX_CPU_SUBMAPS[name]
    ate = float(mapper_ate(m, scene))
    rep = m.report()
    peak = torch.cuda.max_memory_allocated(dev)
    single = launches["match"] - launches["match_batched"]
    slot_ms = 1000 * rep.get("batch_register_s", 0.0) / max(rep.get("batch_register_slots", 0), 1)
    print(f"submaps {name}: registered {m.num_proc_images}/{n} in {len(res.mappers)} map(s) in "
          f"{wall:.3f} s = {n / wall:.3f} frames/s; ATE {ate!r} m (limit {2 * ref['ate_m']} m, "
          f"the JAX package's {ref['ate_m']} m); {m.store.num_points3D} 3-D points; "
          f"store {rep['store_backend']}", flush=True)
    print(f"submaps {name} timings_s " + json.dumps({k: round(v, 4)
                                                     for k, v in res.timings.items()}), flush=True)
    print(f"submaps {name} counters " + json.dumps(rep), flush=True)
    print(f"submaps {name}: {rep.get('merges', 0)} merge(s), common images "
          f"{rep.get('merge_common_before', 0)} before the cross-loop closures, "
          f"{rep.get('merge_common_after', 0)} after ({rep.get('merge_closures', 0)} closures); "
          f"K1 {single} single, {launches['match_batched']} batched with "
          f"{slots['match_batched']} slots ({in_merge.get('match_batched', 0)} batched launches "
          f"with {in_merge.get('slots', 0)} slots inside merge); K2 "
          f"{launches['seg_accum_full']}, K3 {launches['seg_accum_sorted']} launches; batched "
          f"registration {slot_ms:.2f} ms of host time per slot over "
          f"{rep.get('batch_register_slots', 0)} slots; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    _check_map(m, n, ref["registered"], ate, 2 * ref["ate_m"], f"submaps {name}")
    if len(res.mappers) != 1 or rep.get("merges", 0) < 1:
        raise AssertionError(f"submaps {name}: {len(res.mappers)} maps, "
                             f"{rep.get('merges', 0)} merges")
    if "merge" not in res.timings:
        raise AssertionError(f"submaps {name}: no merge stage in {sorted(res.timings)}")
    if rep["store_backend"] != "native":
        raise AssertionError(f"submaps {name}: store {rep['store_backend']}, not native")
    for k in ("seg_accum_full", "seg_accum_sorted"):
        if launches[k] <= 0:
            raise AssertionError(f"submaps {name}: {k} never launched")
    if launches["match"] < n // 2:
        raise AssertionError(f"submaps {name}: match kernel launched {launches['match']} times")
    if name == "segments":
        if in_merge.get("match_batched", 0) <= 0:
            raise AssertionError("submaps segments: no batched K1 launch inside the merge")
        if not rep.get("merge_common_after", 0) > rep.get("merge_common_before", 0):
            raise AssertionError(f"submaps segments: common images "
                                 f"{rep.get('merge_common_before', 0)} -> "
                                 f"{rep.get('merge_common_after', 0)} over the closures")


# ------------------------------------------------------------------ cli


def _rotmat_np(rvec):
    """Rodrigues in float64 numpy (the smoke's own checks)."""
    import numpy as np

    rvec = np.asarray(rvec, np.float64)
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = rvec / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _euler_np(R):
    """(rx, ry, rz) with R = Rz(rz) Ry(ry) Rx(rx), float64."""
    import numpy as np

    return (np.arctan2(R[2, 1], R[2, 2]), np.arctan2(-R[2, 0], np.hypot(R[2, 1], R[2, 2])),
            np.arctan2(R[1, 0], R[0, 0]))


def _rot_from_euler_np(rx, ry, rz):
    import numpy as np

    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    return np.array([[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
                     [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
                     [-sy, cy * sx, cy * cx]])


def cli_scene():
    """The cli phase's survey: 40 images in 2 rows at the scene's own
    800x600 and focal 700."""
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene

    return make_uav_scene(num_images=CLI_IMAGES, num_points=6000, relief=10.0, rows=2, seed=21)


def write_cli_dataset(root, device):
    """Write the cli phase's files under `root`: data/img<i>.png (rendered,
    written by utils/imageio.py), data/imagedata.txt (one PINHOLE camera;
    roll/pitch/yaw of the true rotations plus 0.005 rad of noise),
    control_points.txt (6 points, the first 4 fixed, projected into every
    image that sees them, as tests/test_pipeline.py does) and tree.npz (a
    vocabulary tree trained on the descriptors the port detects, on
    `device`, in every 10th image). Returns (scene, priors, control points
    as (name, xyz, fixed))."""
    import numpy as np
    from mavmap_tpu_torch.features.detector import detect_image
    from mavmap_tpu_torch.loop import train_voc_tree
    from mavmap_tpu_torch.utils.imageio import write_png
    from mavmap_tpu_torch.utils.synthetic import imu_priors, render_images

    scene = cli_scene()
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    imgs = render_images(scene, texture_contrast=0.25, seed=21)
    priors = imu_priors(scene, noise=0.005, seed=21)
    lines = ["# imagedata"]
    for i, im in enumerate(imgs):
        write_png(os.path.join(data, f"img{i}.png"), im)
        # imagedata's angles give the prior as rvec_from_euler(roll, pitch, yaw).
        roll, pitch, yaw = (float(a) for a in _euler_np(_rotmat_np(priors[i])))
        cam_def = ", 1, PINHOLE, 700.0, 700.0, 400.0, 300.0" if i == 0 else ""
        lines.append(f"img{i}, {roll!r}, {pitch!r}, {yaw!r}, 0, 0, 0, 0, 0, 0, 0{cam_def}")
    with open(os.path.join(data, "imagedata.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    rng = np.random.default_rng(21)
    cps, cp_lines = [], []
    for k in range(6):
        X = [rng.uniform(3.0, 44.0), rng.uniform(1.0, 9.0), rng.uniform(0.0, 3.0)]
        obs = []
        for i in range(len(scene.rvecs)):
            Xc = _rotmat_np(scene.rvecs[i]) @ np.array(X) + scene.tvecs[i]
            if Xc[2] < 1:
                continue
            u = float(700.0 * Xc[0] / Xc[2] + 400.0)
            v = float(700.0 * Xc[1] / Xc[2] + 300.0)
            if 0 <= u < 800 and 0 <= v < 600:
                obs.append((i, u, v))
        fixed = k < 4
        cps.append((f"cp{k}", np.array(X), fixed))
        cp_lines.append(("## " if fixed else "# ") + f"cp{k}, {X[0]!r}, {X[1]!r}, {X[2]!r}")
        cp_lines += [f"{i}, {u!r}, {v!r}" for i, u, v in obs]
    with open(os.path.join(root, "control_points.txt"), "w") as f:
        f.write("\n".join(cp_lines) + "\n")

    desc = np.concatenate([detect_image(imgs[i].astype(np.float32), hessian_threshold=1000.0,
                                        max_features=1024, device=device)[1]
                           for i in range(0, len(imgs), 10)])
    tree = train_voc_tree(desc, branching=8, depth=2, iters=3, device=device)
    tree.save(os.path.join(root, "tree.npz"))
    return scene, priors, cps


def cli_args(root, out, extra=()):
    """The cli phase's flags: tests/test_pipeline.py's rendered-image
    settings, loop detection every 20 frames with the phase's tree over 10
    candidates, the IMU priors at weight 20, the control points and the
    filter. No frame of the survey's second row registers against the first
    (in either package), and each of them is retried with the loop-detection
    rescue, one registration per candidate: at the default 30 candidates
    that took 262 s of host time over the two runs on the card, most of the
    phase (PERF.md)."""
    return ["--input-path", os.path.join(root, "data"), "--output-path", out,
            "--cache-path", os.path.join(root, "cache"),
            "--max-features", "1024", "--min-track-len", "2", "--tri-min-angle", "1.0",
            "--init-tri-min-angle", "2.0", "--ransac-min-inlier-threshold", "15",
            "--surf-hessian-threshold", "1000",
            "--voc-tree-path", os.path.join(root, "tree.npz"), "--loop-detection-period", "20",
            "--loop-detection-num-images", "10",
            "--constrain-rotation", "--constrain-rotation-weight", "20",
            "--use-control-points",
            "--control-point-data-path", os.path.join(root, "control_points.txt"),
            "--filter-max-error", str(CLI_FILTER_MAX_ERROR), "--quiet", *extra]


def cli_outputs(out):
    """Read back what the CLI wrote: every output file of a one-map run must
    exist and parse. Returns {name: (rx, ry, rz, C)} from imagedataout.txt,
    the control points' estimates {name: xyz}, and the point counts."""
    import numpy as np

    names = ["imagedataout.txt", "points3D.txt", "points3D.ply", "cameras.wrl",
             "points3D-min-track-len-2.wrl", "points3D-min-track-len-3.wrl", "points3D.wrl",
             "points3D-all.wrl", "connections.wrl", "control_points_out.txt"]
    for n in names:
        if not os.path.exists(os.path.join(out, n)):
            raise AssertionError(f"cli: {n} was not written")
    poses = {}
    for line in open(os.path.join(out, "imagedataout.txt")):
        if line.startswith("#"):
            continue
        f = [v.strip() for v in line.split(",")]
        poses[f[0]] = (float(f[1]), float(f[2]), float(f[3]),
                       np.array([float(f[8]), float(f[9]), float(f[10])]))
    pts = np.loadtxt(os.path.join(out, "points3D.txt"), delimiter=",", comments="#", ndmin=2)
    ply = open(os.path.join(out, "points3D.ply")).read().splitlines()
    n_ply = int(ply[2].split()[-1])
    if len(ply) != ply.index("end_header") + 1 + n_ply or n_ply != len(pts):
        raise AssertionError(f"cli: points3D.ply holds {n_ply} vertices, points3D.txt {len(pts)}")
    for n in names[3:9]:
        txt = open(os.path.join(out, n)).read()
        if not txt.startswith("#VRML V2.0 utf8") or txt.count("[") != txt.count("]"):
            raise AssertionError(f"cli: {n} is not a VRML file")
    cps = {}
    for line in open(os.path.join(out, "control_points_out.txt")):
        if not line.startswith("#"):
            f = [v.strip() for v in line.split(",")]
            cps[f[0]] = np.array([float(v) for v in f[1:4]])
    return poses, cps, len(pts)


def cli_metrics(out, scene, priors, cps):
    """The cli phase's numbers from the CLI's own output files: registered
    count, the absolute camera-centre RMSE in the control points' frame (no
    similarity fit), the largest rotation-matrix entry difference to the
    priors, and |estimate - truth| of each free control point."""
    import numpy as np

    poses, est, n_points = cli_outputs(out)
    idx = [int(n[3:]) for n in poses]
    C = np.stack([p[3] for p in poses.values()])
    abs_rmse = float(np.sqrt(np.mean(np.sum((C - scene.camera_centers()[idx]) ** 2, -1))))
    # The writer stores the Euler angles of the camera-to-world rotation.
    rot = max(float(np.abs(_rot_from_euler_np(*p[:3]).T - _rotmat_np(priors[i])).max())
              for i, p in zip(idx, poses.values()))
    gcp = {n: float(np.linalg.norm(est[n] - X)) for n, X, fixed in cps if not fixed}
    return {"registered": len(poses), "abs_rmse_m": abs_rmse, "rot_prior_max": rot,
            "gcp_err_m": gcp, "points": n_points, "centers": dict(zip(poses, C.tolist()))}


def _timed_detect(torch, dev, img, **kw):
    """One detect_and_describe call: (kept keypoints, ms between two CUDA
    events around it on the stream, host ms to the synchronised result).
    Where the host launches slower than the card runs, the event span is
    the host's pace: _detect_kernel_ms gives the kernels' own time."""
    from mavmap_tpu_torch.features.detector import detect_and_describe

    x = torch.as_tensor(img.astype("float32"), device=dev)
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    mask = detect_and_describe(x, hessian_threshold=1000.0, **kw)[3]
    b.record()
    torch.cuda.synchronize(dev)
    host_ms = 1000 * (time.perf_counter() - t0)
    return int(mask.sum()), a.elapsed_time(b), host_ms


def _detect_kernel_ms(torch, dev, img, calls=3, **kw):
    """(device ms of all kernels per detect_and_describe call, kernel
    launches per call) as torch.profiler (CUPTI) reports them; (None, None)
    where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    from mavmap_tpu_torch.features.detector import detect_and_describe

    x = torch.as_tensor(img.astype("float32"), device=dev)
    detect_and_describe(x, hessian_threshold=1000.0, **kw)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            detect_and_describe(x, hessian_threshold=1000.0, **kw)
        torch.cuda.synchronize(dev)
    us, n = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
        if t > 0:
            us += t
            n += e.count
    return (us / calls / 1000, n / calls) if us > 0 else (None, None)


def detector_timing(torch, dev, root):
    """The detector's time per frame on the card: the cli phase's frames at
    800x600 (their PNGs decoded again, max_features 1024, as the phase ran)
    and one 4000x3000 frame, a 12 MP survey photo (render_images of a scene
    at that size, focal 3500; the CLI's default max_features 2048). Each
    first call warms up and is not counted."""
    import numpy as np
    from mavmap_tpu_torch.utils.imageio import read_gray
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene, render_images

    _phase("detector timing")
    frames = [read_gray(os.path.join(root, "data", f"img{i}.png")) for i in range(CLI_IMAGES)]
    _timed_detect(torch, dev, frames[0], max_features=1024)
    torch.cuda.reset_peak_memory_stats(dev)
    rows = [_timed_detect(torch, dev, f, max_features=1024) for f in frames]
    peak = torch.cuda.max_memory_allocated(dev)
    kept, dev_ms, host_ms = (np.array(c) for c in zip(*rows))
    kernel_ms, kernels = _detect_kernel_ms(torch, dev, frames[0], max_features=1024)
    small = {"frames": len(rows), "size": [800, 600], "kernel_ms": kernel_ms,
             "kernels_per_call": kernels, "event_ms_median": float(np.median(dev_ms)),
             "event_ms_range": [float(dev_ms.min()), float(dev_ms.max())],
             "host_ms_median": float(np.median(host_ms)),
             "host_ms_range": [float(host_ms.min()), float(host_ms.max())],
             "kept": kept.tolist(), "peak_mib": peak / 2**20}
    print("detector 800x600: " + json.dumps(small), flush=True)

    t0 = time.perf_counter()
    big_scene = make_uav_scene(num_images=2, num_points=6000, relief=10.0, rows=1, seed=21,
                               image_size=(4000, 3000), focal=3500.0)
    big = render_images(big_scene, texture_contrast=0.25, seed=21)[0]
    render_s = time.perf_counter() - t0
    _timed_detect(torch, dev, big, max_features=2048)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = [_timed_detect(torch, dev, big, max_features=2048) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    kernel_ms, kernels = _detect_kernel_ms(torch, dev, big, max_features=2048)
    large = {"size": [4000, 3000], "render_s": render_s, "kernel_ms": kernel_ms,
             "kernels_per_call": kernels, "event_ms": [r[1] for r in runs],
             "host_ms": [r[2] for r in runs],
             "kept": runs[0][0], "peak_mib": peak / 2**20}
    print("detector 4000x3000: " + json.dumps(large), flush=True)
    return {"800x600": small, "4000x3000": large}


def cli_phase(torch, dev):
    """The command-line mapper from pixels (see the module docstring, 11):
    run 1 maps the phase's files with detection on the card, loop
    detection, IMU priors, control points, the filter and --save-map; run 2
    resumes with --load-map. Checks: the registered count at least the JAX
    package's on the same files, the absolute camera-centre RMSE under 2x
    JAX's, rotations within 0.02 of the priors (tests/test_pipeline.py's
    bound), each free control point within 2x JAX's error, every output
    file written and parsed, run 2 within 0.02 m of run 1 (the checkpoint
    test's bound), and K1-K3 launched in the phase."""
    import tempfile

    import numpy as np
    from mavmap_tpu_torch import cli
    from mavmap_tpu_torch.ops.cuda import build

    _phase("cli")
    tmp = tempfile.mkdtemp(prefix="mavmap_cli_")
    t0 = time.perf_counter()
    scene, priors, cps = write_cli_dataset(tmp, dev)
    print(f"cli: {CLI_IMAGES} PNG images, imagedata.txt, {len(cps)} control points "
          f"({sum(c[2] for c in cps)} fixed) and a vocabulary tree written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ckpt = os.path.join(tmp, "map.npz")
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    r1 = cli.run(cli_args(tmp, os.path.join(tmp, "out1"), ["--save-map", ckpt, "--device",
                                                         str(dev)]))
    _sync(torch, dev)
    wall1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2 = cli.run(cli_args(tmp, os.path.join(tmp, "out2"), ["--load-map", ckpt, "--device",
                                                         str(dev)]))
    _sync(torch, dev)
    wall2 = time.perf_counter() - t0
    launches, slots = dict(build.launches), dict(build.slots)
    peak = torch.cuda.max_memory_allocated(dev)
    if r1.rc != 0 or r2.rc != 0:
        raise AssertionError(f"cli: return codes {r1.rc} / {r2.rc}")
    m1 = cli_metrics(os.path.join(tmp, "out1"), scene, priors, cps)
    m2 = cli_metrics(os.path.join(tmp, "out2"), scene, priors, cps)
    for name, r, wall, m in (("run 1", r1, wall1, m1), ("run 2 (resumed)", r2, wall2, m2)):
        stages = dict(detection=r.detection_s, **r.result.timings)
        print(f"cli {name}: registered {m['registered']}/{CLI_IMAGES} in {wall:.3f} s; absolute "
              f"camera-centre RMSE {m['abs_rmse_m']!r} m; rotation vs priors {m['rot_prior_max']:.5f};"
              f" free control points {json.dumps(m['gcp_err_m'])} m; {m['points']} points",
              flush=True)
        print(f"cli {name} stages_s " + json.dumps({k: round(v, 4) for k, v in stages.items()}),
              flush=True)
        print(f"cli {name} counters " + json.dumps(r.result.main_mapper.report()), flush=True)
    common = sorted(set(m1["centers"]) & set(m2["centers"]))
    drift = max(float(np.abs(np.array(m1["centers"][n]) - np.array(m2["centers"][n])).max())
                for n in common)
    print(f"cli: run 2 against run 1: {len(common)} common images, largest centre "
          f"coordinate difference {drift!r} m (limit 0.02); launches {json.dumps(launches)}, "
          f"batched K1 slots {slots['match_batched']}; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    timing = detector_timing(torch, dev, tmp)
    if m1["registered"] < JAX_CPU_CLI_REGISTERED:
        raise AssertionError(f"cli: registered {m1['registered']} < the JAX package's "
                             f"{JAX_CPU_CLI_REGISTERED}")
    if not m1["abs_rmse_m"] < 2 * JAX_CPU_CLI_ABS_RMSE_M:
        raise AssertionError(f"cli: absolute RMSE {m1['abs_rmse_m']} m >= 2x the JAX "
                             f"package's {JAX_CPU_CLI_ABS_RMSE_M} m")
    if not m1["rot_prior_max"] < 0.02:
        raise AssertionError(f"cli: rotations {m1['rot_prior_max']} off the priors")
    for n, e in m1["gcp_err_m"].items():
        if not e < 2 * JAX_CPU_CLI_GCP_ERR_M[n]:
            raise AssertionError(f"cli: control point {n} off by {e} m >= 2x the JAX "
                                 f"package's {JAX_CPU_CLI_GCP_ERR_M[n]} m")
    if len(common) != len(m1["centers"]) or not drift < 0.02:
        raise AssertionError(f"cli: run 2 differs from run 1 ({len(common)} common images, "
                             f"{drift} m)")
    if launches["match"] < CLI_IMAGES - 1:
        raise AssertionError(f"cli: match kernel launched {launches['match']} times")
    for k in ("seg_accum_full", "seg_accum_sorted"):
        if launches[k] <= 0:
            raise AssertionError(f"cli: {k} never launched")
    return dict(launches, match_batched_slots=slots["match_batched"]), timing


def _kernel_line(phases, k1, k2, k3, ks, kp, floor_ms):
    """The kernels' JSON line: each kernel's launches on the main path and
    per phase, and its numbers at its headline shape (K1 1024x1024x128, K2
    the survey's CG matvec (2O, 9), K3 the survey's (O, 3)), with every
    timed shape listed and the launch floor beside them."""
    def launches(k):
        return phases["main"][k], {p: n[k] for p, n in phases.items()}

    rows = []
    for name, source, replaces, shapes, head, err in (
            ("match", "mavmap_tpu_torch/csrc/match.cu", "mavmap_tpu/ops/pallas/match.py:106",
             k1["shapes"] + k1["batched"], k1["shapes"][0],
             max([k1["max_abs_err"]] + [r["max_abs_err"] for r in k1["batched"]])),
            ("seg_accum_full", "mavmap_tpu_torch/csrc/ba_accum.cu",
             "mavmap_tpu/ops/pallas/ba_accum.py:79", k2["shapes"] + ks["full"] + kp,
             ks["full"][0], max([k2["max_abs_err"], ks["max_abs_err"]]
                                + [r["max_abs_err"] for r in kp])),
            ("seg_accum_sorted", "mavmap_tpu_torch/csrc/ba_accum.cu",
             "mavmap_tpu/ops/pallas/ba_accum.py:179", k3["shapes"] + ks["sorted"],
             ks["sorted"][0], max(k3["max_abs_err"], ks["sorted_err"]))):
        n_main, by_phase = launches(name)
        row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=n_main,
                   launches_by_phase=by_phase, max_abs_err=err)
        row.update({k: head[k] for k in ("shape", "ms", "call_us", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "bound_resource", "share",
                                          "profiler_us")})
        row["launch_floor_ms"] = floor_ms
        if name == "match":
            row["library_note"] = "no single PyTorch call gives both directions' top-2"
            row["launches_batched_by_phase"] = {p: n["match_batched"] for p, n in phases.items()}
        row["shapes"] = shapes
        rows.append(row)
    return json.dumps({"kernels": rows})


# The smoke's time limit on the card, the kernels' builds included.
SMOKE_LIMIT_S = 1200


def main():
    import torch

    t_start = time.perf_counter()
    dev, name, smi = device_phase()
    import mavmap_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_phase()
    floor_ms = timer_check(torch)
    _phase("kernels")
    k1 = check_match(torch, dev)
    k1["batched"] = check_match_batched(torch, dev)
    k2 = check_seg_full(torch, dev)
    k3 = check_seg_sorted(torch, dev)
    phases = {"main": main_path_phase(torch, dev)}
    phases["chained"], first, m, window_prob = chained_phase(torch, dev)
    phases["chained_repeat"], second, _, _ = chained_phase(torch, dev, "chained repeat")
    check_repeat(first, second)
    kp = check_ptblk_shapes(torch, dev, m, window_prob)
    del m, window_prob
    scene, feats, gt = _survey_scene()
    phases["survey"], survey_prob, survey_raw = survey_phase(torch, dev, scene, feats)
    _phase("kernels at the survey's shapes")
    ks = check_survey_shapes(torch, dev, survey_prob)
    del survey_prob
    phases["cg_vs_dense"] = cg_vs_dense_phase(torch, dev)
    batched_geometry_phase(torch, dev, scene, feats, gt)
    phases["pipeline"], pipe_ref = pipeline_phase(torch, dev, scene, feats)
    phases["mesh"], km = mesh_phase(torch, dev, scene, feats, gt, survey_raw, pipe_ref)
    k1["batched"] += km["batched"]
    ks["full"] += km["full"]
    ks["sorted"] += km["sorted"]
    ks["max_abs_err"] = max([ks["max_abs_err"]] + [r["max_abs_err"] for r in km["full"]])
    ks["sorted_err"] = max([ks["sorted_err"]] + [r["max_abs_err"] for r in km["sorted"]])
    del scene, feats, gt, survey_raw
    phases["submaps"] = submaps_phase(torch, dev)
    phases["cli"], _ = cli_phase(torch, dev)
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s of its {SMOKE_LIMIT_S} s limit",
          flush=True)
    print(_kernel_line(phases, k1, k2, k3, ks, kp, floor_ms))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
