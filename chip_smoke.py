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
 5. prints the kernels' JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package.
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


def main_path_phase(torch, dev):
    """bench.py's scene through the port's per-frame mapping loop."""
    import numpy as np
    from mavmap_tpu_torch.ba import BAOptions
    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
    from mavmap_tpu_torch.utils.synthetic import make_uav_scene, mapper_ate, render_features

    _phase("main path")
    scene = make_uav_scene(num_images=NUM_IMAGES, num_points=4000, relief=10.0,
                           rows=2, seed=11)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
    cap = 1024
    prov = ArrayFeatureProvider([(k[:cap], d[:cap]) for k, d in feats], capacity=cap)
    opts = SequentialMapperOptions(tri_min_angle=1.0, final_cost_threshold=2.0,
                                   essential_ransac_trials=512, p3p_ransac_trials=512)
    init_opts = SequentialMapperOptions(tri_min_angle=4.0, final_cost_threshold=2.0,
                                        essential_ransac_trials=512, p3p_ransac_trials=512)
    window_ba = BAOptions(max_num_iterations=6, refine_camera_params=True)
    global_ba = BAOptions(max_num_iterations=30, refine_camera_params=True)

    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         prov, dev, seed=0)
    stages = {"init_s": 0.0, "register_s": 0.0, "window_ba_s": 0.0, "global_ba_s": 0.0}
    window_iters = 0
    build.reset_launches()
    torch.cuda.synchronize()
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
    torch.cuda.synchronize()
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

    reg = [iid for iid in range(m.store.num_images) if m.store.image_registered[iid]]
    poses = np.concatenate([m.store.image_rvecs[reg], m.store.image_tvecs[reg]], axis=1)
    if not (np.isfinite(poses).all() and poses.shape == (NUM_IMAGES, 6)):
        raise AssertionError("non-finite or missing poses")
    if not np.isfinite(m.store.point3D_xyz[m.store.point3D_valid]).all():
        raise AssertionError("non-finite 3-D points")
    if nreg != NUM_IMAGES:
        raise AssertionError(f"registered {nreg}/{NUM_IMAGES}")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    # One match per registration attempt: the initial pair and each of the
    # NUM_IMAGES - 2 later frames, so NUM_IMAGES - 1 in all.
    if launches["match"] < NUM_IMAGES - 1:
        raise AssertionError(f"match kernel launched {launches['match']} < "
                             f"{NUM_IMAGES - 1} times")
    for k in ("seg_accum_full", "seg_accum_sorted"):
        if launches[k] < lm_iters:
            raise AssertionError(f"{k} launched {launches[k]} times for {lm_iters} LM iterations")
    return launches


def main():
    import torch

    dev, name, smi = device_phase()
    import mavmap_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_phase()
    _phase("kernels")
    k1 = check_match(torch, dev)
    k2 = check_seg_full(torch, dev)
    k3 = check_seg_sorted(torch, dev)
    launches = main_path_phase(torch, dev)

    kernels = [
        dict(name="match", route="cuda", source="mavmap_tpu_torch/csrc/match.cu",
             replaces="mavmap_tpu/ops/pallas/match.py:106", launches=launches["match"], **k1),
        dict(name="seg_accum_full", route="cuda", source="mavmap_tpu_torch/csrc/ba_accum.cu",
             replaces="mavmap_tpu/ops/pallas/ba_accum.py:79",
             launches=launches["seg_accum_full"], **k2),
        dict(name="seg_accum_sorted", route="cuda", source="mavmap_tpu_torch/csrc/ba_accum.cu",
             replaces="mavmap_tpu/ops/pallas/ba_accum.py:179",
             launches=launches["seg_accum_sorted"], **k3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
