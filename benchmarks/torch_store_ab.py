"""The port's two track stores side by side on chip_smoke.py's pipeline run.

    python3 benchmarks/torch_store_ab.py [backend ...]   (default: python native)

Maps chip_smoke.py's pipeline phase (the 200-image survey through
run_pipeline with its vocabulary tree and options, on the CUDA card) once
per named store backend, in the order given, in one process: 'python'
(fm/map_store.py) or 'native' (the C++ track store). Prints one JSON line
per run: registered count, maps, ATE, points, closures, the stage seconds
(`timings`: sequential loop, back-fill, global BA, closure sweeps), the
host seconds spent inside the map store's methods (outermost calls only)
and the card's name and power limit; then one line saying whether the runs
mapped the same outcome, and whether their poses and points are equal bit
for bit.
"""

import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mavmap_tpu_torch.fm import MapStore  # noqa: E402
from mavmap_tpu_torch.fm.native_map_store import NativeMapStore  # noqa: E402
from mavmap_tpu_torch.sfm import pipeline  # noqa: E402
from mavmap_tpu_torch.utils.synthetic import mapper_ate  # noqa: E402

# The store's public work: every method a mapper or the pipeline calls.
TIMED = ("add_image", "add_correspondence", "add_correspondences_bulk", "set_point3D",
         "delete_point3D", "find_tri_points", "observation_table", "load_state", "_sync",
         "track_len", "point3D_status")


def _timed_store_methods(seconds):
    """Wrap TIMED on both store classes with host timers that add into
    `seconds`, counting only the outermost store call; returns an undo."""
    depth = [0]
    saved = []
    for cls in (MapStore, NativeMapStore):
        for name in TIMED:
            if name not in cls.__dict__:
                continue
            fn = cls.__dict__[name]

            @functools.wraps(fn)
            def timed(*a, _fn=fn, _name=name, **kw):
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:
                        seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t0

            saved.append((cls, name, fn))
            setattr(cls, name, timed)

    def undo():
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return undo


def run(backend, dev, scene, feats, tree):
    mapper_cls = pipeline.SequentialMapper

    class Mapper(mapper_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, store_backend=backend))

    store_s = {}
    undo = _timed_store_methods(store_s)
    pipeline.SequentialMapper = Mapper
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                                    chip_smoke._provider(feats),
                                    pipeline.PipelineOptions(**chip_smoke.PIPELINE_OPTS),
                                    voc_tree=tree, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        pipeline.SequentialMapper = mapper_cls
        undo()
    m = res.main_mapper
    rep = m.report()
    s = m.store
    state = {"rvecs": s.image_rvecs.copy(), "tvecs": s.image_tvecs.copy(),
             "points": s.point3D_xyz[s.point3D_valid].copy()}
    out = {"backend": rep["store_backend"], "registered": int(m.num_proc_images),
           "mappers": len(res.mappers), "ate_m": float(mapper_ate(m, scene)),
           "points": int(s.num_points3D), "loop_closures": rep.get("loop_closures", 0),
           "sweep_closures": rep.get("sweep_closures", 0), "wall_s": wall,
           "timings_s": res.timings, "store_s": store_s,
           "store_total_s": sum(store_s.values())}
    return out, state


def main(backends):
    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        raise RuntimeError("torch_store_ab.py runs on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    scene, feats, _ = chip_smoke._survey_scene()
    tree = chip_smoke.pipeline_tree(feats, dev)
    outs, states = [], []
    for backend in backends:
        out, state = run(backend, dev, scene, feats, tree)
        print(json.dumps(dict(out, card=smi)), flush=True)
        outs.append(out)
        states.append(state)
    keys = ("registered", "mappers", "ate_m", "points", "loop_closures", "sweep_closures")
    same = all(o[k] == outs[0][k] for o in outs for k in keys)
    bits = all(np.array_equal(st[k], states[0][k]) for st in states for k in states[0])
    print(json.dumps({"same_outcome": same, "same_bits": bits, "backends": backends,
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["python", "native"])
