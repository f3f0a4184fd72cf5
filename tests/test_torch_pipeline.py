"""The sequential pipeline of the PyTorch port held against the JAX package.

One 16-image, 2-row survey (capacity 512, 128 RANSAC trials, one
vocabulary tree carried across with voc_tree_from_jax) goes through both
packages. The two draw different RANSAC samples (torch.Generator against
jax.random), so the checks are on outcomes, each exact where the scene
leaves no doubt:

  - run_pipeline with a short loop-detection period and neighborhood, so
    that the periodic detection and the closure sweep both fire: the same
    registered frames, at least one loop closed in both packages, and the
    port's ATE under min(0.05 m, 2x JAX's);
  - detect_loop and batch_detect_closures on the same chained map: the same
    closure pairs committed (pair_graph);
  - process_remaining_images over a map of every other frame: the same
    frames filled;
  - every option the port does not carry raises NotImplementedError
    (mesh_devices runs: tests/test_torch_parallel.py).
Sub-map merging and segment-parallel mapping are held in
tests/test_torch_merge.py and tests/test_torch_segments.py.
"""

import numpy as np
import pytest
import torch

from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.loop import LoopDetector as JLoopDetector
from mavmap_tpu.loop import train_voc_tree as j_train
from mavmap_tpu.sfm import SequentialMapper as JMapper, SequentialMapperOptions as JOpts
from mavmap_tpu.sfm import pipeline as jpipe
from mavmap_tpu.utils.synthetic import (
    make_uav_scene as j_scene, mapper_ate as j_ate, render_features as j_render)

from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.interop import voc_tree_from_jax
from mavmap_tpu_torch.loop import LoopDetector
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.utils.synthetic import (
    make_uav_scene, mapper_ate, mapper_ate_profile, render_features)

torch.set_num_threads(2)
CPU = torch.device("cpu")
N, CAP, TRIALS = 16, 512, 128
SCENE = dict(num_images=N, num_points=150 * N, relief=10.0, rows=2, extent=None, seed=13)
OPTS = dict(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
            loop_detection_period=4, loop_detection_nh_dist=3, loop_detection_num_images=6,
            final_closure_sweeps=1, final_closure_step=2, chain_len=4, ba_local_max_iters=8,
            essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)


def _feats(render, scene):
    feats, _ = render(scene, pixel_noise=0.3, clutter=20, seed=13)
    return [(k[:CAP], d[:CAP]) for k, d in feats]


@pytest.fixture(scope="module")
def survey():
    """(port scene, provider, tree), (JAX scene, provider, tree): one tree
    trained by the JAX package, carried into the port."""
    js = j_scene(**SCENE)
    jf = _feats(j_render, js)
    desc = np.concatenate([d for _, d in jf[::4]])
    jt = j_train(desc[np.random.default_rng(0).permutation(len(desc))[:4000]], branching=8,
                 depth=2, iters=3)
    ts = make_uav_scene(**SCENE)
    tf = _feats(render_features, ts)
    return ((ts, ArrayFeatureProvider(tf, capacity=CAP), voc_tree_from_jax(jt, CPU)),
            (js, JProvider(jf, capacity=CAP), jt))


@pytest.fixture(scope="module")
def runs(survey):
    (ts, tp, tt), (js, jp, jt) = survey
    rt = tpipe.run_pipeline(ts.image_cameras, ts.cam_models, ts.cam_params, tp,
                            tpipe.PipelineOptions(**OPTS), voc_tree=tt, device=CPU)
    rj = jpipe.run_pipeline(js.image_cameras, js.cam_models, js.cam_params, jp,
                            jpipe.PipelineOptions(**OPTS), voc_tree=jt)
    return rt, rj


def test_run_pipeline_matches_jax(survey, runs):
    (ts, _, _), (js, _, _) = survey
    rt, rj = runs
    mt, mj = rt.main_mapper, rj.main_mapper
    assert len(rt.mappers) == len(rj.mappers) == 1
    assert sorted(mt.image_idx_to_id) == sorted(mj.image_idx_to_id) == list(range(N))
    ct, cj = mt.report(), mj.counters
    for c in (ct, cj):
        assert c["loop_closures"] >= 1 and c["sweep_closures"] >= 1
        assert c["global_ba_runs"] == 2  # once, then again after the sweep added closures
    ate_t, ate_j = mapper_ate(mt, ts), j_ate(mj, js)
    assert ate_t < min(0.05, 2.0 * ate_j), (ate_t, ate_j)
    assert set(rt.timings) == {"sequential_loop", "backfill", "global_ba", "closure_sweeps"}
    assert ct["batch_register_slots"] > 0 and ct["chains"] >= 3
    prof = mapper_ate_profile(mt, ts, block=8)
    assert [(s, n) for s, n, _ in prof] == [(0, 8), (8, 8)]
    assert max(e for _, _, e in prof) < 0.05


def _chained_map(mapper, opts, init_opts, chain_len=4):
    """Initial pair (0, 1), then chains of chain_len frames (pad_to), no BA."""
    assert mapper.process_initial(0, 1, init_opts)
    last = 1
    while last < N - 1:
        chain = list(range(last + 1, min(last + 1 + chain_len, N)))
        oks = mapper.process_chain_k(chain, last, opts, pad_to=chain_len)
        assert all(oks), oks
        last = chain[-1]


def test_detect_loop_and_closure_sweep_commit_same_pairs(survey):
    """On the same chained map of the survey, detect_loop at the last frame
    and then one closure sweep of every 2nd frame commit the same closure
    pairs in both packages."""
    (ts, tp, tt), (js, jp, jt) = survey
    kw = dict(tri_min_angle=1.0, final_cost_threshold=2.0, essential_ransac_trials=TRIALS,
              p3p_ransac_trials=TRIALS)
    mt = SequentialMapper(ts.image_cameras, ts.cam_models, ts.cam_params, tp, CPU, seed=0,
                          loop_detector=LoopDetector(tt))
    mj = JMapper(js.image_cameras, js.cam_models, js.cam_params, jp, seed=0,
                 store_backend="python", loop_detector=JLoopDetector(jt))
    _chained_map(mt, SequentialMapperOptions(**kw),
                 SequentialMapperOptions(**dict(kw, tri_min_angle=4.0)))
    _chained_map(mj, JOpts(**kw), JOpts(**dict(kw, tri_min_angle=4.0)))
    assert mt.pair_graph == mj.pair_graph
    chain_pairs = set(mt.pair_graph)
    opts_t, opts_j = SequentialMapperOptions(**kw), JOpts(**kw)
    nt = mt.detect_loop(N - 1, num_images=6, num_nh_images=2, nh_distance=3, options=opts_t)
    nj = mj.detect_loop(N - 1, num_images=6, num_nh_images=2, nh_distance=3, options=opts_j)
    assert nt == nj >= 1
    assert mt.pair_graph == mj.pair_graph and len(mt.pair_graph) == len(chain_pairs) + nt
    reg = sorted(mt.image_idx_to_id)[::2]
    st = mt.batch_detect_closures(reg, num_images=6, nh_distance=3, options=opts_t)
    sj = mj.batch_detect_closures(reg, num_images=6, nh_distance=3, options=opts_j)
    assert st == sj >= 1
    assert mt.pair_graph == mj.pair_graph
    assert mt.report()["sweep_jobs"] == mj.counters["sweep_jobs"]


def test_process_remaining_images_fills_same_frames(survey):
    """tests/test_pipeline.py's back-fill: even frames registered (the
    batched initial search, then chains of 4 over the even frames), the odd
    ones filled by process_remaining_images through the batched pair step;
    the same frames filled in both packages."""
    (ts, tp, _), (js, jp, _) = survey
    filled = []
    for pkg, mapper, opts_cls, pipe in (
            ("torch", SequentialMapper(ts.image_cameras, ts.cam_models, ts.cam_params, tp,
                                       CPU, seed=0), SequentialMapperOptions, tpipe),
            ("jax", JMapper(js.image_cameras, js.cam_models, js.cam_params, jp, seed=0,
                            store_backend="python"), JOpts, jpipe)):
        o = opts_cls(tri_min_angle=1.0, min_track_len=2, essential_ransac_trials=TRIALS,
                     p3p_ransac_trials=TRIALS)
        assert mapper.process_initial_batch(0, [2, 3], o) == 2
        assert all(mapper.process_chain_k([4, 6, 8, 10], 2, o, pad_to=4))
        before = set(mapper.image_idx_to_id)
        n = pipe.process_remaining_images(mapper, 0, 11, pipe.PipelineOptions(
            verbose=False, tri_min_angle=1.0, min_track_len=2, essential_ransac_trials=TRIALS,
            p3p_ransac_trials=TRIALS))
        filled.append((n, sorted(set(mapper.image_idx_to_id) - before)))
    (nt, ft), (nj, fj) = filled
    assert nt == nj >= 4 and ft == fj
    assert set(ft) >= {1, 3, 5, 7, 9}


@pytest.mark.parametrize("option,value,item", [
    ("pipeline_chains", True, "do-not-port"),
    ("matcher_backend", "pallas", "K1"),
    ("matcher_backend", "xla", "K1"),
])
def test_unported_options_raise(option, value, item):
    """Every option of the JAX pipeline that the port does not carry raises
    at entry, before any work, naming where it is queued; none falls back.
    (The options ported with the CLI slice run in tests/test_torch_options.py,
    mesh_devices in tests/test_torch_parallel.py.)"""
    with pytest.raises(NotImplementedError, match=item):
        tpipe.run_pipeline(np.zeros(4, np.int32), np.ones(1, np.int32),
                           np.zeros((1, 9), np.float32), None,
                           tpipe.PipelineOptions(**{option: value}), device=CPU)


def test_run_pipeline_needs_a_card_by_default():
    """Without device=... the pipeline runs on the CUDA card, and raises
    where there is none (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_pipeline(np.zeros(4, np.int32), np.ones(1, np.int32),
                           np.zeros((1, 9), np.float32), None)
