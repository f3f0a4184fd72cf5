"""Speculative chain pipelining of the PyTorch port held against the JAX
package: a chain dispatched on the in-flight chain's end state on the
device (register_chain_cont, SequentialMapper.chain_dispatch_cont), and
dropped where that chain does not commit whole (chain_abandon).

  - register_chain_cont on JAX register_chain's end state, every frame's
    RANSAC samples derived from the JAX package's in-program keys: match
    rows and counts exactly equal, refined poses at 1e-4, the end state as
    tests/test_torch_sfm.py holds register_chain's;
  - tests/test_sfm.py's speculative loop (14 images, chains of 4,
    deferred window BA) through both mappers, held on outcomes since the
    two PRNGs differ: 14/14 each, the port's ATE at most max(2 x JAX's,
    0.03 m), 2 continuation chains and no abandon;
  - the same loop with one frame's descriptors replaced by noise: the
    chain over it fails mid-way, the continuation dispatched behind it is
    abandoned (its frames stay out of the store, the solves pending at the
    abandon land), and both packages register the same frames;
  - the two ValueErrors: a continuation of a padded chain, and completing
    a continuation before its anchor has committed;
  - run_pipeline(pipeline_chains=True) on tests/test_pipeline.py's
    12-image scene through both packages: 12/12 each at ATE < 0.02 m, and
    the port registers the frames of its own synchronous run;
  - the gate: under constrain_rotation or debug no continuation chain is
    dispatched.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ba import BAOptions as JBAOptions
from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.ops.ransac import sample_indices
from mavmap_tpu.sfm import SequentialMapper as JMapper, SequentialMapperOptions as JOpts
from mavmap_tpu.sfm import pipeline as jpipe
from mavmap_tpu.sfm.kernels import (
    _derive_chain_state as j_derive, register_chain as j_register_chain,
    register_chain_cont as j_register_chain_cont)
from mavmap_tpu.utils.synthetic import make_uav_scene as j_scene, mapper_ate as j_ate

from mavmap_tpu_torch.ba import BAOptions
from mavmap_tpu_torch.features import ArrayFeatureProvider
from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.sfm.kernels import register_chain_cont
from mavmap_tpu_torch.utils.synthetic import make_uav_scene, mapper_ate, render_features
from tests.test_torch_sfm import F, TRIALS, _image, _t

torch.set_num_threads(2)
CPU = torch.device("cpu")
K = 3
# tests/test_sfm.py's speculative loop: its scene, options and chain length.
LOOP_SCENE = dict(num_images=14, num_points=2600, relief=10.0, rows=1, seed=25)
LOOP_RENDER = dict(pixel_noise=0.3, clutter=24, seed=25)
LOOP_OPTS = dict(tri_min_angle=1.0, essential_ransac_trials=256, p3p_ransac_trials=256)
LOOP_INIT = dict(LOOP_OPTS, tri_min_angle=2.0)
CH = 4
# tests/test_pipeline.py's pipeline_chains scene and options, at 128 RANSAC
# trials instead of 512 (both packages still map 12/12 there; the JAX
# run's compiles set the test's time).
PIPE_SCENE = dict(num_images=12, num_points=2200, relief=10.0, rows=1, seed=41)
PIPE_OPTS = dict(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0, min_track_len=2,
                 loop_detection=False, essential_ransac_trials=128, p3p_ransac_trials=128)


@pytest.fixture(scope="module")
def cont_scene():
    scene = make_uav_scene(num_images=8, num_points=1300, relief=10.0, seed=2)
    feats, gt = render_features(scene, pixel_noise=0.3, clutter=20, seed=2, max_features=F)
    return scene, feats, gt


def _scal(scene, counter):
    scal = np.zeros(12 + 12 * K, np.float32)
    scal[0:3], scal[3:6] = scene.rvecs[1], scene.tvecs[1]
    scal[6], scal[7] = 0.9, 1e9
    scal[8], scal[9], scal[10], scal[11] = np.deg2rad(1.0), 2, counter, -1
    per = scal[12:].reshape(K, 12)
    per[:, 0] = per[:, 1] = 4.0 / 700.0
    per[:, 2] = 1
    per[:, 3:12] = scene.cam_params[0]
    return scal


def test_register_chain_cont_matches_jax(cont_scene, rng):
    """JAX register_chain over frames 2-4 anchored on image 1, then both
    packages' register_chain_cont over frames 5-7 on its end state and
    frame 4's features, every frame's samples from JAX's keys
    (fold_in(base_key, counter), split(K), register_view's split) with the
    masks from JAX's outputs: match rows exactly equal, counts equal,
    anchor has_tri states equal, refined poses at 1e-4; the end state's
    flags and lengths exactly, its pose at 1e-4 and its 3-D points at 1e-4
    of the map's extent."""
    scene, feats, gt = cont_scene
    ids = np.full(F, -1)
    ids[: len(gt[1])] = gt[1]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    lens = np.where(has_tri, rng.integers(2, 4, F), 0)
    track_state = np.zeros((F, 7), np.float32)
    track_state[has_tri, :3] = scene.points3D[ids[has_tri]] + rng.normal(
        size=(has_tri.sum(), 3)) * 0.01
    track_state[:, 3] = has_tri
    track_state[:, 4] = has_tri & (lens >= 2)
    track_state[:, 5] = lens
    track_state[:, 6] = -1.0
    imgs = [_image(scene, feats, i) for i in range(8)]

    def jfeats(idxs):
        return tuple(tuple(map(jnp.asarray, imgs[i])) for i in idxs)

    base_key = jax.random.PRNGKey(7)
    first = j_register_chain(base_key, *map(jnp.asarray, imgs[1]), jfeats([2, 3, 4]),
                             jnp.asarray(track_state), jnp.asarray(_scal(scene, 1)),
                             p3p_trials=TRIALS)
    es0, ep0 = np.array(first[3]), np.array(first[4])
    scal = _scal(scene, 2)
    scal[0:6] = 0.0  # ignored by a continuation chain
    rows_j, sc_j, ht_j, es_j, ep_j = map(np.asarray, j_register_chain_cont(
        base_key, *map(jnp.asarray, imgs[4]), jfeats([5, 6, 7]), jnp.asarray(es0),
        jnp.asarray(ep0), jnp.asarray(scal), p3p_trials=TRIALS))

    keys = jax.random.split(jax.random.fold_in(base_key, 2), K)
    xyz, ht, st = jnp.asarray(es0[:, :3]), jnp.asarray(es0[:, 3] > 0.5), jnp.asarray(
        es0[:, 4] > 0.5)
    ln = jnp.asarray(es0[:, 5].astype(np.int32))
    samples = []
    for k in range(K):
        valid = jnp.asarray(rows_j[k, :, 1] > 0.5)
        k_h, k_p = jax.random.split(keys[k])
        samples.append((np.asarray(sample_indices(k_h, 128, 4, F, valid)),
                        np.asarray(sample_indices(k_p, TRIALS, 4, F, valid & st & ht))))
        xyz, ht, st, ln, _, _ = j_derive(jnp.asarray(rows_j[k]), jnp.asarray(sc_j[k]), xyz,
                                         ht, ln, jnp.float32(scal[12 + 12 * k + 1]),
                                         jnp.float32(scal[8]), 2)

    rows_t, sc_t, ht_t, es_t, ep_t = (o.numpy() for o in register_chain_cont(
        None, *_t(*imgs[4]), tuple(tuple(_t(*imgs[i])) for i in (5, 6, 7)),
        torch.as_tensor(es0), torch.as_tensor(ep0), scal, p3p_trials=TRIALS,
        samples=samples))
    assert rows_t.shape == rows_j.shape and sc_t.shape == sc_j.shape
    np.testing.assert_array_equal(ht_t, ht_j)
    np.testing.assert_array_equal(ht_t[0], es0[:, 3] > 0.5)
    for k in range(K):
        np.testing.assert_array_equal(rows_t[k, :, :3], rows_j[k, :, :3])
        np.testing.assert_array_equal(sc_t[k, [0, 2, 3, 4, 5]], sc_j[k, [0, 2, 3, 4, 5]])
        assert sc_t[k, 5] == 1.0 and sc_t[k, 4] > 20
        np.testing.assert_allclose(sc_t[k, 7:13], sc_j[k, 7:13], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(es_t[:, 3:], es_j[:, 3:])
    assert es_t[:, 3].sum() > 20
    np.testing.assert_allclose(ep_t, ep_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(es_t[:, :3], es_j[:, :3], rtol=0,
                               atol=1e-4 * np.abs(es_j[:, :3]).max())


def _speculative_loop(m, opts, init_opts, ba_cls, n):
    """bench.py's pipelined loop at chains of CH: a full chain dispatched
    from the committed frontier, a continuation dispatched on each chain in
    flight before it completes, one deferred window-8 BA per committed
    chain; a chain that does not commit whole abandons the continuation
    behind it and the loop goes on from the committed frames (a frame whose
    chain failed at once goes through process())."""
    assert m.process_initial(0, 1, init_opts)

    def local_ba():
        w = sorted(m.image_idx_to_id.keys())[-8:]
        if len(w) > 2:
            m.adjust_bundle(w[2:], w[:2], ba_options=ba_cls(max_num_iterations=6),
                            async_=True, defer=True)

    last, i, per_frame = 1, 2, False
    tok = tok_chain = None
    while i < n or tok is not None:
        if tok is not None:
            nstart = tok_chain[-1] + 1
            nxt = list(range(nstart, min(nstart + CH, n)))
            tok_nxt = None
            if len(tok_chain) == CH and len(nxt) >= 2:
                tok_nxt = m.chain_dispatch_cont(nxt, tok, opts, pad_to=CH)
            committed = sum(m.chain_complete(tok))
            if committed:
                last = tok_chain[committed - 1]
                local_ba()
            if committed == len(tok_chain) and tok_nxt is not None:
                tok, tok_chain = tok_nxt, nxt
            else:
                if tok_nxt is not None:
                    m.chain_abandon(tok_nxt)
                i, per_frame = (last + 1, False) if committed else (tok_chain[0], True)
                tok = tok_chain = None
            continue
        chain = list(range(i, min(i + CH, n)))
        if len(chain) == CH and not per_frame:
            tok, tok_chain = m.chain_dispatch(chain, last, opts, pad_to=CH), chain
            continue
        if m.process(i, last, opts):
            last = i
            local_ba()
        i, per_frame = i + 1, False
    m.flush_ba()
    m.adjust_global_bundle(ba_cls(max_num_iterations=30))
    return m


def _loop_both(blackout=()):
    """The speculative loop over LOOP_SCENE through both mappers, with the
    descriptors of the frames in `blackout` replaced by unit noise rows."""
    scene = make_uav_scene(**LOOP_SCENE)
    feats, _ = render_features(scene, **LOOP_RENDER)
    noise = np.random.default_rng(0)
    for i in blackout:
        d = noise.normal(size=feats[i][1].shape).astype(np.float32)
        feats[i] = (feats[i][0], d / np.linalg.norm(d, axis=1, keepdims=True))
    cap = int(np.ceil(max(len(k) for k, _ in feats) / 256)) * 256
    n = LOOP_SCENE["num_images"]
    mt = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                          ArrayFeatureProvider(feats, capacity=cap), device=CPU, seed=0)
    js = j_scene(**LOOP_SCENE)
    mj = JMapper(js.image_cameras, js.cam_models, js.cam_params, JProvider(feats, capacity=cap),
                 seed=0, store_backend="python")
    return scene, js, mt, mj, lambda m, o, io, b: _speculative_loop(m, o, io, b, n)


def test_speculative_loop_matches_jax():
    """tests/test_sfm.py's speculative loop through both mappers: 14/14
    each, the port's ATE at most max(2 x JAX's, 0.03 m) (the JAX test's
    bound for this loop), two continuation chains and no abandon, every
    window solve landed."""
    scene, js, mt, mj, run = _loop_both()
    run(mt, SequentialMapperOptions(**LOOP_OPTS), SequentialMapperOptions(**LOOP_INIT),
        BAOptions)
    run(mj, JOpts(**LOOP_OPTS), JOpts(**LOOP_INIT), JBAOptions)
    ate_t, ate_j = mapper_ate(mt, scene), j_ate(mj, js)
    assert int(mt.store.image_registered.sum()) == int(mj.store.image_registered.sum()) == 14
    assert ate_t <= max(2.0 * ate_j, 0.03), (ate_t, ate_j)
    rep = mt.report()
    assert rep["cont_chains"] == 2 and "cont_abandoned" not in rep
    assert rep["chains"] == 3 and rep["pulls"] == 3
    assert not mt._pending_ba and not mt._deferred_ba


def test_failed_chain_abandons_its_continuation():
    """Frame 8's descriptors replaced by noise: chain 6-9 fails at frame 8,
    so the continuation 10-13 dispatched on its end state is abandoned. At
    the abandon its frames are not in the store, the solves pending before
    it have landed and the deferred one has been dispatched; both packages
    register the same frames in the end, frame 8 not among them."""
    scene, js, mt, mj, run = _loop_both(blackout=(8,))
    seen = []
    abandon = mt.chain_abandon

    def watched(token):
        before = (len(mt._pending_ba), len(mt._deferred_ba), mt.counters.get("ba_applied", 0))
        abandon(token)
        seen.append((token.idxs[:token.n_real], before, len(mt._pending_ba),
                     len(mt._deferred_ba), mt.counters.get("ba_applied", 0),
                     [mt.is_image_processed(i) for i in token.idxs]))

    mt.chain_abandon = watched
    run(mt, SequentialMapperOptions(**LOOP_OPTS), SequentialMapperOptions(**LOOP_INIT),
        BAOptions)
    run(mj, JOpts(**LOOP_OPTS), JOpts(**LOOP_INIT), JBAOptions)
    frames, (pending, deferred, applied), pending_after, deferred_after, applied_after, \
        processed = seen[0]
    assert frames == [10, 11, 12, 13] and not any(processed)
    assert applied_after == applied + pending
    assert deferred_after == 0 and pending_after == deferred
    reg_t = sorted(mt.image_idx_to_id)
    assert reg_t == sorted(mj.image_idx_to_id)
    assert 8 not in reg_t and len(reg_t) >= 12
    rep = mt.report()
    assert rep["cont_abandoned"] == len(seen) >= 1 and rep["cont_chains"] >= 2
    assert not mt._pending_ba and not mt._deferred_ba


@pytest.mark.parametrize("case", ["padded previous chain", "anchor not committed"])
def test_continuation_chain_errors(cont_scene, case):
    """A continuation of a padded chain raises (its end state is not the
    last real frame's), and so does completing a continuation before its
    anchor has committed (the caller must abandon it)."""
    scene, feats, _ = cont_scene
    m = SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                         ArrayFeatureProvider(feats, capacity=F), device=CPU, seed=0)
    opts = SequentialMapperOptions(tri_min_angle=1.0, essential_ransac_trials=TRIALS,
                                   p3p_ransac_trials=TRIALS)
    assert m.process_initial(0, 1, opts)
    if case == "padded previous chain":
        tok = m.chain_dispatch([2, 3], 1, opts, pad_to=3)
        with pytest.raises(ValueError, match="unpadded"):
            m.chain_dispatch_cont([4, 5], tok, opts)
        return
    tok = m.chain_dispatch([2, 3], 1, opts)
    cont = m.chain_dispatch_cont([4, 5], tok, opts)
    with pytest.raises(ValueError, match="before its anchor committed"):
        m.chain_complete(cont)
    assert m.chain_complete(tok) == [True, True]
    assert m.chain_complete(cont) == [True, True]


@pytest.fixture(scope="module")
def pipe_scene():
    scene = make_uav_scene(**PIPE_SCENE)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=12, seed=41)
    return scene, feats, int(np.ceil(max(len(k) for k, _ in feats) / 256)) * 256


def _port_pipeline(pipe_scene, **kw):
    scene, feats, cap = pipe_scene
    return tpipe.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                              ArrayFeatureProvider(feats, capacity=cap),
                              tpipe.PipelineOptions(**dict(PIPE_OPTS, **kw)),
                              device=CPU).main_mapper


def test_run_pipeline_pipelined_matches_jax(pipe_scene):
    """run_pipeline(pipeline_chains=True) on tests/test_pipeline.py's
    12-image scene: both packages 12/12 at ATE < 0.02 m (that test's
    bound), the port through continuation chains and registering the
    frames of its own synchronous run."""
    scene, feats, cap = pipe_scene
    js = j_scene(**PIPE_SCENE)
    mj = jpipe.run_pipeline(js.image_cameras, js.cam_models, js.cam_params,
                            JProvider(feats, capacity=cap),
                            jpipe.PipelineOptions(**PIPE_OPTS, pipeline_chains=True)).main_mapper
    sync = _port_pipeline(pipe_scene)
    mt = _port_pipeline(pipe_scene, pipeline_chains=True)
    assert mj.num_proc_images == mt.num_proc_images == 12
    assert sorted(mt.image_idx_to_id) == sorted(sync.image_idx_to_id)
    assert j_ate(mj, js) < 0.02 and mapper_ate(mt, scene) < 0.02
    assert mt.report()["cont_chains"] >= 1 and "cont_chains" not in sync.report()


@pytest.mark.parametrize("gate", ["constrain_rotation", "debug"])
def test_pipelining_gate(pipe_scene, gate, capsys):
    """Under constrain_rotation (the IMU pre-alignment rotates the model
    between chains) or debug, run_pipeline(pipeline_chains=True) dispatches
    no continuation chain and maps as the chained loop does."""
    m = _port_pipeline(pipe_scene, pipeline_chains=True, end_image_idx=7, **{gate: True})
    assert m.num_proc_images == 8 and m.report()["chains"] >= 1
    assert "cont_chains" not in m.report()
