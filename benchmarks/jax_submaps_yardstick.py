"""The JAX package's run_pipeline over chip_smoke.py's submaps phase, on the CPU.

    JAX_PLATFORMS=cpu python benchmarks/jax_submaps_yardstick.py [runs]

The inputs and options are chip_smoke.py's (submap_scenes, RESTART_OPTS,
SEGMENT_OPTS), built here with the JAX package's own utils.synthetic and
vocabulary tree:
  - restart: bench.py's scene (30 images, 2 rows, seed 11, clutter 64),
    frames 13 and 14 given unit rows of default_rng(0).normal as
    descriptors, max_subsequent_trials=1, no loop detection, no closure
    sweep;
  - segments: make_uav_scene(num_images=60, num_points=7200, relief=10.0,
    rows=2, extent=None, seed=13), render_features(pixel_noise=0.3,
    clutter=64, seed=13), a tree (branching 8, depth 2, 3 iterations) of
    8000 rows drawn with default_rng(0) from every 5th frame's descriptors,
    parallel_segments=2, segment_overlap=4, loop detection every 20 frames,
    one closure sweep of every 2nd frame.
Both at capacity 1024, mapper seed 0 (sub-map k seeded k), chains of 4, 15
window LM iterations. Each run goes twice in one process (the first
compiles; `runs` picks which, default both), and prints one JSON line per
pass: registered count, maps, ATE, points, the common images of each merge
before and after its cross-loop closures (the JAX merge prints them only
under verbose: parsed from that line), the stage times and the wall
seconds. chip_smoke.JAX_CPU_SUBMAPS comes from these lines.
"""

import contextlib
import io
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mavmap_tpu.sfm.pipeline as pipeline  # noqa: E402
from mavmap_tpu.features import ArrayFeatureProvider  # noqa: E402
from mavmap_tpu.loop import train_voc_tree  # noqa: E402
from mavmap_tpu.sfm.mapper import SequentialMapper  # noqa: E402
from mavmap_tpu.utils import synthetic  # noqa: E402

_MERGED = re.compile(r"Merged mappers with (\d+) common images \((\d+) before closure\)")


def main(runs):
    scenes = chip_smoke.submap_scenes(synthetic)
    merges = []
    merge = SequentialMapper.merge

    def noted_merge(self, other, **kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ok = merge(self, other, **dict(kw, verbose=True))
        m = _MERGED.search(buf.getvalue())
        merges.append({"ok": ok, "common_before": int(m.group(2)) if m else None,
                       "common_after": int(m.group(1)) if m else None})
        return ok

    SequentialMapper.merge = noted_merge
    try:
        for name in runs:
            scene, feats, tree_rows = scenes[name]
            tree = None if tree_rows is None else train_voc_tree(tree_rows, branching=8, depth=2,
                                                                 iters=3)
            opts = chip_smoke.RESTART_OPTS if name == "restart" else chip_smoke.SEGMENT_OPTS
            for p in (1, 2):
                merges.clear()
                t0 = time.perf_counter()
                res = pipeline.run_pipeline(scene.image_cameras, scene.cam_models,
                                            scene.cam_params,
                                            ArrayFeatureProvider(feats, capacity=1024),
                                            pipeline.PipelineOptions(**opts), voc_tree=tree)
                wall = time.perf_counter() - t0
                m = res.main_mapper
                print(json.dumps({
                    "run": name, "pass": p, "registered": int(m.num_proc_images),
                    "mappers": len(res.mappers), "ate_m": float(synthetic.mapper_ate(m, scene)),
                    "points": int(m.store.num_points3D), "merges": list(merges),
                    "registered_frames": sorted(int(i) for i in m.image_idx_to_id),
                    "timings_s": res.timings, "wall_s": wall}), flush=True)
    finally:
        SequentialMapper.merge = merge


if __name__ == "__main__":
    main(sys.argv[1:] or ["restart", "segments"])
