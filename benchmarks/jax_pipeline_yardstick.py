"""The JAX package's run_pipeline over chip_smoke.py's pipeline phase, on the CPU.

    JAX_PLATFORMS=cpu python benchmarks/jax_pipeline_yardstick.py [seeds...]

The scene, the vocabulary tree and the options are those of
benchmarks/pipeline_scale.py cut to 200 images in 4 rows (the survey of
chip_smoke.py): make_uav_scene(num_images=200, num_points=24000,
relief=10.0, rows=4, extent=None, seed=13), render_features(pixel_noise=0.3,
clutter=32, seed=13), capacity 1024, a tree of every 10th image's
descriptors (default_rng(0) permutation, the first 8000; branching 8, depth
2, 3 iterations), loop detection every 20 frames, one closure sweep of
every 2nd frame, chains of 4, 15 window LM iterations, self-calibration on.
Mapper seeds default to 0 1 2 (run_pipeline gives sub-map k the seed
seed + k). Prints one JSON line per seed: registered count, ATE, the ATE
profile per 50 frames, the closure counters and the stage times. The
constants of chip_smoke.py's pipeline phase come from these lines.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mavmap_tpu.sfm.pipeline as pipeline  # noqa: E402
from mavmap_tpu.features import ArrayFeatureProvider  # noqa: E402
from mavmap_tpu.loop import train_voc_tree  # noqa: E402
from mavmap_tpu.sfm.mapper import SequentialMapper  # noqa: E402
from mavmap_tpu.utils.synthetic import (  # noqa: E402
    make_uav_scene, mapper_ate, mapper_ate_profile, render_features)

N, ROWS, CAP = 200, 4, 1024
COUNTERS = ("loop_closures", "detect_runnable", "sweep_cands", "sweep_jobs",
            "sweep_closures")


def main(seeds):
    scene = make_uav_scene(num_images=N, num_points=120 * N, relief=10.0, rows=ROWS,
                           extent=None, seed=13)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=32, seed=13)
    feats = [(k[:CAP], d[:CAP]) for k, d in feats]
    prov = ArrayFeatureProvider(feats, capacity=CAP)
    desc = np.concatenate([d for _, d in feats[::10]])
    tree = train_voc_tree(desc[np.random.default_rng(0).permutation(len(desc))[:8000]],
                          branching=8, depth=2, iters=3)
    opts = pipeline.PipelineOptions(
        verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
        loop_detection_period=20, final_closure_sweeps=1, final_closure_step=2,
        chain_len=4, ba_local_max_iters=15)
    for seed in seeds:
        class Seeded(SequentialMapper):
            def __init__(self, *a, seed=0, **kw):
                super().__init__(*a, seed=seed + seed_base, **kw)

        seed_base = seed
        pipeline.SequentialMapper = Seeded
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                                    prov, opts, voc_tree=tree)
        wall = time.perf_counter() - t0
        m = res.main_mapper
        c = m.counters
        print(json.dumps({
            "seed": seed, "registered": int(m.num_proc_images), "mappers": len(res.mappers),
            "ate_m": float(mapper_ate(m, scene)),
            "ate_profile_50": [[s, n, e] for s, n, e in mapper_ate_profile(m, scene, block=50)],
            "counters": {k: c.get(k, 0) for k in COUNTERS},
            "seconds": {k: v for k, v in c.items() if k.endswith("_s")},
            "timings_s": res.timings, "wall_s": wall}), flush=True)
    pipeline.SequentialMapper = SequentialMapper


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0, 1, 2])
