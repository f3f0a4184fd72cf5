"""Sub-map merging and segment-parallel mapping of the PyTorch port held
against the JAX package.

The scene is tests/test_torch_pipeline.py's 16-image, 2-row survey
(capacity 512, 128 RANSAC trials). The packages draw different RANSAC
samples, so the pipeline checks are on outcomes; the mapper-level merge
starts both packages from the same two maps (built by the JAX package,
saved and loaded by both) and without a loop detector, so nothing random
runs in it and its results are compared number for number:

  - a restart: frames 4-5 of 8 carry unrelated descriptors, so the map
    restarts; with merge=True both packages end in one map with the same
    registered frames and the port's ATE under max(2x JAX's, 0.05 m); with
    merge=False both return the same two sub-maps;
  - the merge's adjacency fallback (tests/test_pipeline.py's case) with
    parallel_segments=2: frames 4-6 blacked out eat the segments' overlap
    and there is no vocabulary tree, so the merge finds one common image and
    registers the other map's frames next to its own; one map of the same
    frames in both packages;
  - SequentialMapper.merge of two overlapping halves: the same common and
    cloned images, track count and pair graph, the similarity within 1e-4
    and the cloned poses within 1e-4 (float32 solves in two libraries),
    on the port's native and Python stores.
Segment-parallel mapping with loop detection is held in
tests/test_torch_segments.py, through this file's helpers (the two files
run on separate workers).
"""

import numpy as np
import pytest
import torch

from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.loop import train_voc_tree as j_train
from mavmap_tpu.ops import similarity as j_similarity
from mavmap_tpu.sfm import SequentialMapper as JMapper, SequentialMapperOptions as JOpts
from mavmap_tpu.sfm import pipeline as jpipe
from mavmap_tpu.utils import checkpoint as jckpt
from mavmap_tpu.utils.synthetic import (
    make_uav_scene as j_scene, mapper_ate as j_ate, render_features as j_render)

from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.interop import voc_tree_from_jax
from mavmap_tpu_torch.ops import similarity as t_similarity
from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.utils import checkpoint as tckpt
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, mapper_ate, render_features

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


def _blackout(feats, frames):
    """Unrelated unit descriptors on `frames` (default_rng(0), in order)."""
    rng = np.random.default_rng(0)
    feats = list(feats)
    for i in frames:
        d = rng.normal(size=feats[i][1].shape).astype(np.float32)
        feats[i] = (feats[i][0], d / np.linalg.norm(d, axis=1, keepdims=True))
    return feats


@pytest.fixture(scope="module")
def survey():
    """(port scene, features, tree), (JAX scene, features, tree): one tree
    trained by the JAX package, carried into the port."""
    js = j_scene(**SCENE)
    jf = _feats(j_render, js)
    desc = np.concatenate([d for _, d in jf[::4]])
    jt = j_train(desc[np.random.default_rng(0).permutation(len(desc))[:4000]], branching=8,
                 depth=2, iters=3)
    ts = make_uav_scene(**SCENE)
    return (ts, _feats(render_features, ts), voc_tree_from_jax(jt, CPU)), (js, jf, jt)


def _run_both(survey, feats_of, n, opts, tree=True):
    (ts, tf, tt), (js, jf, jt) = survey
    rt = tpipe.run_pipeline(ts.image_cameras[:n], ts.cam_models, ts.cam_params,
                            ArrayFeatureProvider(feats_of(tf)[:n], capacity=CAP),
                            tpipe.PipelineOptions(**opts), voc_tree=tt if tree else None,
                            device=CPU)
    rj = jpipe.run_pipeline(js.image_cameras[:n], js.cam_models, js.cam_params,
                            JProvider(feats_of(jf)[:n], capacity=CAP),
                            jpipe.PipelineOptions(**opts), voc_tree=jt if tree else None)
    return rt, rj


def _frames(res):
    return sorted(sorted(m.image_idx_to_id) for m in res.mappers)


@pytest.mark.parametrize("merge", [True, False])
def test_submap_restart_and_merge_matches_jax(survey, merge):
    """A failed frame restarts a sub-map (max_subsequent_trials=1, no loop
    detection to rescue it); merge=True joins the sub-maps into one map, in
    the port as in the JAX package, merge=False returns both."""
    kw = dict(OPTS, loop_detection=False, max_subsequent_trials=1, final_closure_sweeps=0,
              merge=merge)
    rt, rj = _run_both(survey, lambda f: _blackout(f, (4, 5)), 8, kw, tree=False)
    assert _frames(rt) == _frames(rj)
    if not merge:
        assert len(rt.mappers) == len(rj.mappers) == 2
        assert "merge" not in rt.timings
        return
    assert len(rt.mappers) == len(rj.mappers) == 1
    assert len(_frames(rt)[0]) >= 6
    assert "merge" in rt.timings
    rep = rt.main_mapper.report()
    assert rep["merges"] == 1 and rep["merge_common_after"] >= 3
    (ts, _, _), (js, _, _) = survey
    ate_t, ate_j = mapper_ate(rt.main_mapper, ts), j_ate(rj.main_mapper, js)
    assert ate_t < max(2.0 * ate_j, 0.05), (ate_t, ate_j)


def test_segment_merge_fallback_matches_jax(survey):
    """The blackout of frames 4-6 leaves the segments [0, 7] and [4, 15]
    one common image and no tree closes loops between them: the adjacency
    registration widens the overlap, and both packages end in one map of
    the same frames."""
    kw = dict(OPTS, loop_detection=False, parallel_segments=2, segment_overlap=4,
              max_subsequent_trials=5, final_closure_sweeps=0)
    rt, rj = _run_both(survey, lambda f: _blackout(f, (4, 5, 6)), N, kw, tree=False)
    assert len(rt.mappers) == len(rj.mappers) == 1
    assert _frames(rt) == _frames(rj)
    assert len(_frames(rt)[0]) >= 13
    rep = rt.main_mapper.report()
    assert rep["merges"] == 1
    assert rep.get("merge_common_before", 0) < 3 <= rep["merge_common_after"]


def _jax_half(js, jf, frames, opts, init_opts):
    m = JMapper(js.image_cameras, js.cam_models, js.cam_params, JProvider(jf, capacity=CAP),
                seed=0, store_backend="python")
    assert m.process_initial(frames[0], frames[1], init_opts)
    last = frames[1]
    for k in range(2, len(frames), 4):
        chain = frames[k:k + 4]
        assert all(m.process_chain_k(chain, last, opts, pad_to=4))
        last = chain[-1]
    return m


def _copies(path, ts, tf, backend):
    """A JAX mapper and a port mapper on `backend`, each holding the map
    saved at `path` (both packages read the same checkpoint format)."""
    _, jm = path
    j = jckpt.load_map(JMapper(jm.image_cameras, jm.cam_models, jm.cam_params, jm.provider,
                               seed=0, store_backend="python"), path[0])
    t = tckpt.load_map(SequentialMapper(ts.image_cameras, ts.cam_models, ts.cam_params,
                                        ArrayFeatureProvider(tf, capacity=CAP), device=CPU,
                                        store_backend=backend), path[0])
    return j, t


@pytest.fixture(scope="module")
def halves(survey, tmp_path_factory):
    """Frames 0-9 and 6-15 of the survey, each mapped by the JAX package
    (process_initial, then chains of 4, no BA) and saved as a checkpoint:
    [(path, JAX mapper)] for each half."""
    _, (js, jf, _) = survey
    kw = dict(tri_min_angle=1.0, final_cost_threshold=2.0, essential_ransac_trials=TRIALS,
              p3p_ransac_trials=TRIALS)
    opts, init = JOpts(**kw), JOpts(**dict(kw, tri_min_angle=4.0))
    out = []
    for k, frames in enumerate((list(range(0, 10)), list(range(6, 16)))):
        m = _jax_half(js, jf, frames, opts, init)
        path = str(tmp_path_factory.mktemp("halves") / f"half{k}.npz")
        jckpt.save_map(m, path)
        out.append((path, m))
    return out


def _center(m, idx):
    rv, tv = m.store.get_pose(m.image_idx_to_id[idx])
    R = rotmat_from_rvec(torch.as_tensor(rv, dtype=torch.float32)).numpy()
    return -R.T @ tv


@pytest.mark.parametrize("backend", ["native", "python"])
def test_merge_matches_jax(survey, halves, backend, monkeypatch):
    """The first half absorbs the second in both packages, starting from
    the same maps (one checkpoint per half): the same common images (the overlap, 6-9), the same
    cloned images, point count and pair graph, the similarity solved on
    the same centres and within 1e-4, and every cloned camera centre within
    1e-4 m of the JAX package's."""
    (ts, tf, _), _ = survey
    ja, ta = _copies(halves[0], ts, tf, backend)
    jb, tb = _copies(halves[1], ts, tf, backend)
    solved = {}
    j_umeyama = j_similarity.solve_umeyama
    for name, mod in (("jax", j_similarity), ("torch", t_similarity)):
        def spy(src, dst, _orig=mod.solve_umeyama, _name=name, **kw):
            T = _orig(src, dst, **kw)
            solved[_name] = (np.asarray(src), np.asarray(dst), np.asarray(T))
            return T
        monkeypatch.setattr(mod, "solve_umeyama", spy)
    kw = dict(tri_min_angle=1.0, essential_ransac_trials=TRIALS, p3p_ransac_trials=TRIALS)
    assert ja.merge(jb, num_skip_images=5, options=JOpts(**kw))
    assert ta.merge(tb, num_skip_images=5, options=SequentialMapperOptions(**kw))
    rep = ta.report()
    assert rep["merge_common_before"] == rep["merge_common_after"] == 4
    assert rep["store_backend"] == backend
    assert sorted(ta.image_idx_to_id) == sorted(ja.image_idx_to_id) == list(range(N))
    assert ta.pair_graph == ja.pair_graph
    assert ta.store.num_points3D == ja.store.num_points3D > 0
    # The centres differ in float32's last bits (rotation matrices from two
    # libraries); the similarity of the port's centres solved by both.
    src, dst, T = solved["torch"]
    for k, c in ((0, src), (1, dst)):
        np.testing.assert_allclose(c, solved["jax"][k], atol=1e-5)
    np.testing.assert_allclose(T, np.asarray(j_umeyama(src, dst)), atol=1e-4)
    np.testing.assert_allclose(T, solved["jax"][2], atol=1e-4)
    for idx in range(10, N):
        np.testing.assert_allclose(_center(ta, idx), _center(ja, idx), atol=1e-4)
