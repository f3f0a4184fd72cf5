"""Speculative chain pipelining against the synchronous chained loop, in
turns on the CUDA card.

    python3 benchmarks/torch_pipelined_ab.py [bench_pairs] [survey_pairs]   (default 3 2)

Two workloads of chip_smoke.py, each run synchronous (S) and pipelined (P)
in pairs whose order alternates (S P, P S, S P, ...), in one process after
one unreported bench run:
  - bench: bench.py's loop over its 30-image scene (chip_smoke.bench_loop,
    pipelined=False / True: chains of 6, a continuation on each full chain
    in flight);
  - survey: the 200-image survey through run_pipeline with chip_smoke.py's
    pipeline options and vocabulary tree, pipeline_chains=False / True.
Prints one JSON line per run: wall seconds, frames/s, registered count,
ATE, the mapper's counters (chains, continuation chains and abandons,
pulls, seconds of the chain steps, window solves and pull waits, LM
iterations) and the host seconds spent inside the mapper's chain methods
(chain_dispatch, chain_dispatch_cont, chain_complete, chain_abandon, and
inside them the deferred window solves and the commits), then one line of
medians per workload and mode, with the card's name and power limit.
"""

import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mavmap_tpu_torch.sfm.mapper import SequentialMapper  # noqa: E402
from mavmap_tpu_torch.sfm.pipeline import PipelineOptions, run_pipeline  # noqa: E402
from mavmap_tpu_torch.utils.synthetic import mapper_ate  # noqa: E402

TIMED = ("chain_dispatch", "chain_dispatch_cont", "chain_complete", "chain_abandon",
         "_dispatch_deferred_ba", "_register_commit")
COUNTERS = ("chains", "cont_chains", "cont_abandoned", "pulls", "seq_chain_s", "ba_solve_s",
            "ba_iters", "global_ba_iters", "reg_wait_s", "seq_detect_s", "batch_register_s")


def _timed_methods(seconds):
    """Wrap TIMED on SequentialMapper with host timers adding into
    `seconds` (a method called inside another of them counts in both);
    returns an undo."""
    saved = {}
    for name in TIMED:
        fn = saved[name] = SequentialMapper.__dict__[name]

        @functools.wraps(fn)
        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t0

        setattr(SequentialMapper, name, timed)
    return lambda: [setattr(SequentialMapper, k, v) for k, v in saved.items()]


def _run(workload, pipelined, dev, survey):
    seconds = {}
    undo = _timed_methods(seconds)
    try:
        torch.cuda.synchronize(dev)
        if workload == "bench":
            scene, prov = chip_smoke._bench_scene()
            m, s = chip_smoke.bench_loop(torch, dev, scene, prov, chip_smoke.NUM_IMAGES,
                                         pipelined=pipelined)
            wall, n = s["wall_s"], chip_smoke.NUM_IMAGES
        else:
            scene, feats, tree = survey
            t0 = time.perf_counter()
            res = run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                               chip_smoke._provider(feats),
                               PipelineOptions(**chip_smoke.PIPELINE_OPTS,
                                               pipeline_chains=pipelined),
                               voc_tree=tree, device=dev)
            torch.cuda.synchronize(dev)
            wall, n, m = time.perf_counter() - t0, chip_smoke.SURVEY_IMAGES, res.main_mapper
    finally:
        undo()
    c = m.counters
    return {"workload": workload, "mode": "P" if pipelined else "S", "wall_s": wall,
            "frames_per_s": n / wall, "registered": int(m.num_proc_images),
            "ate_m": float(mapper_ate(m, scene)),
            "counters": {k: c.get(k, 0) for k in COUNTERS}, "method_s": seconds}


def main(bench_pairs, survey_pairs):
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    chip_smoke.build_phase()
    scene, feats, _ = chip_smoke._survey_scene()
    survey = (scene, feats, chip_smoke.pipeline_tree(feats, dev))
    runs = []
    for workload, pairs in (("bench", bench_pairs), ("survey", survey_pairs)):
        if workload == "bench":
            _run(workload, False, dev, survey)  # warm-up (builds, allocator), not reported
        for k in range(pairs):
            for pipelined in ((False, True) if k % 2 == 0 else (True, False)):
                runs.append(_run(workload, pipelined, dev, survey))
                print(json.dumps(runs[-1]), flush=True)
    for workload in ("bench", "survey"):
        for mode in ("S", "P"):
            walls = [r["wall_s"] for r in runs if r["workload"] == workload and r["mode"] == mode]
            if walls:
                print(json.dumps({"workload": workload, "mode": mode, "runs": len(walls),
                                  "median_wall_s": statistics.median(walls),
                                  "walls_s": walls, "card": smi.strip()}), flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*(args + [3, 2][len(args):]))
