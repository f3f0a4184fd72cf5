"""The JAX package's speculative chain pipelining on the CPU, over
chip_smoke.py's pipelined phase.

    JAX_PLATFORMS=cpu python benchmarks/jax_pipelined_yardstick.py [seeds...]

Two runs per mapper seed (default 0 1 2):

  - bench: bench.py's run() with its pipelining option
    (MAVMAP_BENCH_PIPELINE=1, bench.py:182-220) over bench.py's 30-image
    scene: chains of 6 (pad_to=6), a continuation chain dispatched on each
    full chain in flight, one deferred 10-image self-calibrating window BA
    (6 LM iterations) per committed chain, flush_ba, a 30-iteration global
    BA. A chain that fails at its first frame sends that frame through
    process() (bench.py would dispatch the same chain again);
  - survey: run_pipeline(pipeline_chains=True) over
    benchmarks/jax_pipeline_yardstick.py's scene, tree and options (the
    200-image survey of chip_smoke.py's pipeline phase).

Prints one JSON line per run: registered count, ATE, the continuation
chains dispatched and abandoned (counted here: the JAX mapper counts
neither) and the wall seconds. The constants of chip_smoke.py's pipelined
phase come from these lines.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mavmap_tpu.sfm.pipeline as pipeline  # noqa: E402
from mavmap_tpu.ba import BAOptions  # noqa: E402
from mavmap_tpu.features import ArrayFeatureProvider  # noqa: E402
from mavmap_tpu.loop import train_voc_tree  # noqa: E402
from mavmap_tpu.sfm import SequentialMapperOptions  # noqa: E402
from mavmap_tpu.sfm.mapper import SequentialMapper  # noqa: E402
from mavmap_tpu.utils.synthetic import make_uav_scene, mapper_ate, render_features  # noqa: E402

CHAIN = 6
N, ROWS, CAP = 200, 4, 1024


class Counted(SequentialMapper):
    """The JAX mapper, counting continuation chains and abandons."""

    def chain_dispatch_cont(self, *a, **kw):
        self.counters["cont_chains"] = self.counters.get("cont_chains", 0) + 1
        return super().chain_dispatch_cont(*a, **kw)

    def chain_abandon(self, token):
        self.counters["cont_abandoned"] = self.counters.get("cont_abandoned", 0) + 1
        return super().chain_abandon(token)


def bench_pipelined(seed):
    """bench.py's pipelined loop; returns (mapper, scene, wall s)."""
    scene = make_uav_scene(num_images=30, num_points=4000, relief=10.0, rows=2, seed=11)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
    prov = ArrayFeatureProvider([(k[:CAP], d[:CAP]) for k, d in feats], capacity=CAP)
    opts = SequentialMapperOptions(tri_min_angle=1.0, final_cost_threshold=2.0,
                                   essential_ransac_trials=512, p3p_ransac_trials=512)
    init_opts = SequentialMapperOptions(tri_min_angle=4.0, final_cost_threshold=2.0,
                                        essential_ransac_trials=512, p3p_ransac_trials=512)
    ba_opts = BAOptions(max_num_iterations=6, refine_camera_params=True)
    n = 30
    t0 = time.perf_counter()
    m = Counted(scene.image_cameras, scene.cam_models, scene.cam_params, prov, seed=seed)
    assert m.process_initial(0, 1, init_opts)

    def local_ba():
        window = sorted(m.image_idx_to_id.keys())[-10:]
        if len(window) > 2:
            m.adjust_bundle(window[2:], window[:2], ba_options=ba_opts, async_=True,
                            defer=True)

    last, i, per_frame = 1, 2, False
    tok = tok_chain = None
    while i < n or tok is not None:
        if tok is not None:
            nstart = tok_chain[-1] + 1
            nxt = list(range(nstart, min(nstart + CHAIN, n)))
            tok_nxt = None
            if len(tok_chain) == CHAIN and len(nxt) >= 2:
                tok_nxt = m.chain_dispatch_cont(nxt, tok, opts, pad_to=CHAIN)
            committed = sum(m.chain_complete(tok))
            if committed:
                last = tok_chain[committed - 1]
                local_ba()
            if committed == len(tok_chain) and tok_nxt is not None:
                tok, tok_chain = tok_nxt, nxt
                i = nxt[-1] + 1
            else:
                if tok_nxt is not None:
                    m.chain_abandon(tok_nxt)
                i, per_frame = (last + 1, False) if committed else (tok_chain[0], True)
                tok = tok_chain = None
            continue
        chain = [j for j in range(i, min(i + CHAIN, n)) if not m.is_image_processed(j)]
        if not per_frame and len(chain) >= 2 and chain == list(range(chain[0], chain[-1] + 1)):
            if len(chain) == CHAIN:
                tok, tok_chain = m.chain_dispatch(chain, last, opts, pad_to=CHAIN), chain
                continue
            committed = sum(m.process_chain_k(chain, last, opts, pad_to=CHAIN))
            if committed:
                last = chain[committed - 1]
                local_ba()
                i = last + 1
                continue
        if m.process(i, last, opts):
            last = i
            local_ba()
        i, per_frame = i + 1, False
    m.flush_ba()
    m.adjust_global_bundle(BAOptions(max_num_iterations=30, refine_camera_params=True))
    return m, scene, time.perf_counter() - t0


def survey_pipelined(seed, scene, prov, tree):
    """run_pipeline(pipeline_chains=True) over the survey; returns (result,
    wall s)."""
    opts = pipeline.PipelineOptions(
        verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
        loop_detection_period=20, final_closure_sweeps=1, final_closure_step=2,
        chain_len=4, ba_local_max_iters=15, pipeline_chains=True)

    class Seeded(Counted):
        def __init__(self, *a, seed=0, **kw):
            super().__init__(*a, seed=seed + seed_base, **kw)

    seed_base = seed
    pipeline.SequentialMapper = Seeded
    try:
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                                    prov, opts, voc_tree=tree)
        return res, time.perf_counter() - t0
    finally:
        pipeline.SequentialMapper = SequentialMapper


def _line(run, seed, m, scene, wall, **extra):
    c = m.counters
    return json.dumps(dict({
        "run": run, "seed": seed, "registered": int(m.num_proc_images),
        "ate_m": float(mapper_ate(m, scene)), "cont_chains": c.get("cont_chains", 0),
        "cont_abandoned": c.get("cont_abandoned", 0), "wall_s": wall}, **extra))


def main(seeds):
    for seed in seeds:
        m, scene, wall = bench_pipelined(seed)
        print(_line("bench", seed, m, scene, wall), flush=True)
    scene = make_uav_scene(num_images=N, num_points=120 * N, relief=10.0, rows=ROWS,
                           extent=None, seed=13)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=32, seed=13)
    feats = [(k[:CAP], d[:CAP]) for k, d in feats]
    prov = ArrayFeatureProvider(feats, capacity=CAP)
    desc = np.concatenate([d for _, d in feats[::10]])
    tree = train_voc_tree(desc[np.random.default_rng(0).permutation(len(desc))[:8000]],
                          branching=8, depth=2, iters=3)
    for seed in seeds:
        res, wall = survey_pipelined(seed, scene, prov, tree)
        m = res.main_mapper
        c = m.counters
        print(_line("survey", seed, m, scene, wall, mappers=len(res.mappers),
                    loop_closures=c.get("loop_closures", 0),
                    sweep_closures=c.get("sweep_closures", 0), timings_s=res.timings),
              flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0, 1, 2])
