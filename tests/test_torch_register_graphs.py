"""Registration's chain frame steps as CUDA graphs (sfm/kernels.py
_graphed_frame on ba/core.py's _Stretches "reg" runner).

On a CUDA device each frame step of a chain, after its match (K1) and its
RANSAC draw, runs as two graphs with the pose LM (K4) cut out between
them, captured on the first step of its key (F, camera model, trial
counts, LM iterations, dtype) in the process and replayed by every later
step of any chain of any mapper. Every frame copies its match, samples,
keypoints, anchor state and packed scalars into the key's static inputs,
so nothing of a frame is baked into a graph. The CPU, injected samples and
the batched steps stay eager.

On the CPU: the graphing rule; a chain run through the frame
graphs' path with an eager runner gives the eager chain's bits (the static
inputs, the copies, the key per camera model); the batched steps and
register_view never reach the runner; the thresholds read as device
slices give the bits of the host floats; the eager runner passes the K4
cut through. On the card (tests marked `gpu`, which skip without a CUDA
device): a graphed chain gives the eager chain's bits in rows, scalars,
has_tri_in, end_state and end_pose, with the same K1 / K4 launches and
host syncs, for register_chain and register_chain_fresh, PINHOLE and the
two-camera rig; each key is captured once and replayed after; a replay
reads new thresholds and camera parameters; a second mapper replays only.

This file imports neither jax nor mavmap_tpu, so it runs on a GPU machine
without JAX:

    python -m pytest --noconftest tests/test_torch_register_graphs.py -q
"""

import numpy as np
import pytest
import torch

from mavmap_tpu_torch.ba import core
from mavmap_tpu_torch.models import camera as cam
from mavmap_tpu_torch.ops.cuda import build
from mavmap_tpu_torch.sfm import kernels as kern
from mavmap_tpu_torch.utils.synthetic import (
    make_multi_camera_scene, make_uav_scene, render_features)
from mavmap_tpu_torch.utils.timer import span

CPU = torch.device("cpu")
F, K, P3P = 512, 4, 256
GRAPH_COUNTERS = ("reg_graph_captures", "reg_graph_replays")


class _Owner:
    """A stand-in for the mapper that owns the spans: its counters."""

    def __init__(self):
        self.counters = {}


class _Recorder(core._Stretches):
    """An eager runner that records the key of every stretch it runs."""

    def __init__(self):
        super().__init__(False)
        self.keys = []

    def __call__(self, key, fn):
        self.keys.append(key)
        return fn()


@pytest.fixture(scope="module", params=["pinhole", "rig"])
def scene(request):
    """A 6-frame scene and its features: one PINHOLE camera, or frames that
    alternate a PINHOLE and an OPENCV camera."""
    make = make_uav_scene if request.param == "pinhole" else make_multi_camera_scene
    sc = make(num_images=6, num_points=1500, relief=10.0, seed=3)
    feats, gt = render_features(sc, pixel_noise=0.3, clutter=20, seed=3, max_features=F)
    return request.param, sc, feats, gt


def _frame(sc, feats, i, dev):
    """Frame i's (kp, desc, mask, normalized) at capacity F on `dev`."""
    kp, de = feats[i]
    k, d, m = np.zeros((F, 2), np.float32), np.zeros((F, 128), np.float32), np.zeros(F, bool)
    k[:len(kp)], d[:len(kp)], m[:len(kp)] = kp, de, True
    c = sc.image_cameras[i]
    n = cam.image2normalized_np(k, int(sc.cam_models[c]), sc.cam_params[c])
    return tuple(torch.as_tensor(a, device=dev) for a in (k, d, m, n.astype(np.float32)))


def _chain_inputs(scene, seed=3, px=8.0, focal_scale=1.0, min_angle=1.0, min_len=2):
    """A chain of K frames (2..5) anchored on frame 1: its track state,
    packed scalars (each frame's threshold of `px` pixels, camera and the
    track rules), and the window-BA outputs a fresh chain reads (the
    anchor at row 2 of the poses, every third tracked row's point from the
    points)."""
    _, sc, _, gt = scene
    rng = np.random.default_rng(seed)
    ids = np.full(F, -1)
    ids[:len(gt[1])] = gt[1]
    has_tri = (ids >= 0) & (rng.random(F) < 0.8)
    lens = np.where(has_tri, rng.integers(2, 4, F), 0)
    track_state = np.zeros((F, 7), np.float32)
    track_state[has_tri, :3] = sc.points3D[ids[has_tri]] + rng.normal(
        size=(has_tri.sum(), 3)) * 0.01
    track_state[:, 3], track_state[:, 4] = has_tri, has_tri & (lens >= 2)
    track_state[:, 5], track_state[:, 6] = lens, -1.0
    rows = np.flatnonzero(has_tri)[::3]
    track_state[rows, 6] = np.arange(len(rows))
    ba_points = (sc.points3D[ids[rows]] + rng.normal(size=(len(rows), 3)) * 0.005)
    ba_poses = rng.normal(size=(4, 6)) * 0.01
    ba_poses[2, :3], ba_poses[2, 3:] = sc.rvecs[1], sc.tvecs[1] + 0.003
    scal = np.zeros(12 + 12 * K, np.float32)
    scal[0:3], scal[3:6] = sc.rvecs[1], sc.tvecs[1]
    scal[6], scal[7] = 0.9, 1e9
    scal[8], scal[9], scal[10], scal[11] = np.deg2rad(min_angle), min_len, 1, 2
    per = scal[12:].reshape(K, 12)
    for k, i in enumerate(range(2, 2 + K)):
        c = sc.image_cameras[i]
        p = sc.cam_params[c].copy()
        p[:2] *= focal_scale
        per[k, 0] = per[k, 1] = px / float(p[0] + p[1])
        per[k, 2] = sc.cam_models[c]
        per[k, 3:12] = p
    return track_state, scal, ba_poses.astype(np.float32), ba_points.astype(np.float32)


def _chain(scene, dev, inputs, fresh, seed=5, eager=False, samples=None):
    """One chain on `dev` inside a span owned by a stand-in mapper:
    (outputs as numpy, the owner's counters, K1 / K4 launches)."""
    _, sc, feats, _ = scene
    track_state, scal, ba_poses, ba_points = inputs
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ba = (torch.as_tensor(ba_poses, device=dev), torch.as_tensor(ba_points, device=dev)) \
        if fresh else (None, None)
    owner = _Owner()
    before = dict(build.launches)
    with span("register.dispatch", "reg_dispatch_s", owner):
        out = kern._register_chain_impl(
            g, *_frame(sc, feats, 1, dev), tuple(_frame(sc, feats, i, dev)
                                                  for i in range(2, 2 + K)),
            track_state, scal, *ba, P3P, 128, 30, samples, "pallas", eager=eager)
        out = [o.cpu().numpy() for o in out]
    launched = {k: build.launches[k] - before.get(k, 0) for k in ("match", "pose_lm")}
    return out, owner.counters, launched


def _assert_same_bits(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)


# ------------------------------------------------------------------ CPU


def test_frame_graphs_only_for_a_cuda_chain_drawing_its_samples():
    """The rule rests on what the chain sees: a CUDA device and samples it
    draws itself; the CPU, injected samples and `eager` stay eager."""
    cuda = torch.device("cuda", 0)
    assert kern._graph_chain(cuda, None) and kern._graph_chain("cuda", None)
    assert not kern._graph_chain(cuda, None, eager=True)
    assert not kern._graph_chain(cuda, [(np.zeros((128, 4)), np.zeros((256, 4)))])
    assert not kern._graph_chain(CPU, None)


@pytest.mark.parametrize("fresh", [False, True])
def test_chain_through_the_frame_graphs_path_gives_the_eager_bits(scene, monkeypatch, fresh):
    """With the rule forced and an eager runner, the CPU runs the graphed
    path's own code (each frame's inputs copied into its key's static
    inputs, the outputs copied into the chain's tensors, the anchor state
    carried from frame to frame) and gets the eager chain's bits, the same
    draws and launches. A frame's key is its camera model's: the rig's
    frames alternate two keys, each with its static inputs."""
    run = _Recorder()
    monkeypatch.setattr(kern, "_graph_chain", lambda d, s, eager=False: not eager)
    monkeypatch.setattr(kern, "_FRAME_RUNNERS", {CPU: run})
    monkeypatch.setattr(kern, "_FRAME_INPUTS", {})
    inputs = _chain_inputs(scene)
    g, cnt_g, _ = _chain(scene, CPU, inputs, fresh)
    e, cnt_e, _ = _chain(scene, CPU, inputs, fresh, eager=True)
    _assert_same_bits(g, e)
    assert g[1][:, 5].sum() == K and g[2].any()  # every frame's P3P succeeded
    codes = [int(c) for c in inputs[1][12:].reshape(K, 12)[:, 2]]
    assert run.keys == [(F, c, P3P, 128, 30, torch.float32) for c in codes]
    assert len(kern._FRAME_INPUTS) == len(set(codes))
    assert not any(k in cnt for cnt in (cnt_g, cnt_e)
                   for k in GRAPH_COUNTERS + ("reg_eager_steps",))


def test_batched_steps_and_register_view_never_reach_the_frame_runner(scene, monkeypatch):
    """register_view and the batched steps stay eager even where the rule
    would graph a chain: their shapes change with the slot count, or they
    run once per frame."""
    _, sc, feats, _ = scene
    run = _Recorder()
    monkeypatch.setattr(kern, "_graph_chain", lambda *a, **kw: True)
    monkeypatch.setattr(kern, "_FRAME_RUNNERS", {CPU: run})
    track_state, scal, _, _ = _chain_inputs(scene)
    xyz = torch.as_tensor(track_state[:, :3])
    ht = torch.as_tensor(track_state[:, 3] > 0.5)
    rv, tv = torch.as_tensor(scal[0:3]), torch.as_tensor(scal[3:6])
    kp = torch.as_tensor(sc.cam_params[0])
    prev, curr = _frame(sc, feats, 1, CPU), _frame(sc, feats, 2, CPU)
    g = torch.Generator()
    g.manual_seed(0)
    code = int(sc.cam_models[0])
    kern.register_view(g, *prev, *curr, xyz, ht, ht, rv, tv, kp, code, 0.9, 1e9, 0.01,
                       p3p_trials=64)
    stack = [torch.stack([t, t]) for t in prev]
    kern.register_view_batch(g, *stack, *curr, xyz.expand(2, -1, -1), ht.expand(2, -1),
                             ht.expand(2, -1), rv.expand(2, -1), tv.expand(2, -1), kp, code,
                             0.9, 1e9, 0.01, p3p_trials=64)
    kern.register_view_pairs(g, *stack, *[torch.stack([t, t]) for t in curr],
                             xyz.expand(2, -1, -1), ht.expand(2, -1), ht.expand(2, -1),
                             rv.expand(2, -1), tv.expand(2, -1), kp.expand(2, -1), [code] * 2,
                             0.9, 1e9, [0.01, 0.02], p3p_trials=64)
    assert run.keys == []


def test_thresholds_as_device_slices_give_the_host_floats_bits(scene):
    """_register_geometry with its norm threshold and camera from slices of
    the chain's device copy of `scal`, and _derive_chain_state with its
    three rules as 0-dim slices, give the bits of the same float32 values
    passed from the host."""
    _, sc, feats, _ = scene
    track_state, scal, _, _ = _chain_inputs(scene, min_len=3)
    scal_d = torch.as_tensor(scal)
    per_h, per_d = scal[12:].reshape(K, 12)[0], scal_d[12:].reshape(K, 12)[0]
    prev, curr = _frame(sc, feats, 1, CPU), _frame(sc, feats, 2, CPU)
    from mavmap_tpu_torch.ops.matching import match_features

    matches, valid = match_features(prev[1], curr[1], prev[2], curr[2], prev[0], curr[0],
                                    ratio=0.9, max_distance=1e9)
    ts = torch.as_tensor(track_state)
    xyz, ht, st, lens = ts[:, :3], ts[:, 3] > 0.5, ts[:, 4] > 0.5, ts[:, 5].long()
    g = torch.Generator()
    g.manual_seed(1)
    samples = kern.draw_samples(g, [(128, 4, valid[None]), (P3P, 4, (valid & st & ht)[None])])
    one = [a[None] for a in (matches, valid, prev[0], prev[3], curr[0], curr[3], xyz, ht, st,
                             scal_d[0:3], scal_d[3:6])]
    code = int(per_h[2])
    host = kern._register_geometry(None, *one, torch.as_tensor(per_h[3:12])[None], [code], None,
                                   kern._slot_thresholds(float(per_h[0]), 1, CPU), P3P, 128, 30,
                                   samples)
    dev = kern._register_geometry(None, *one, per_d[None, 3:12], [code], None, per_d[0:1], P3P,
                                  128, 30, samples)
    _assert_same_bits([t.numpy() for t in host], [t.numpy() for t in dev])
    rows, scalars = host[0][0], host[1][0]
    assert float(scalars[5]) == 1.0
    a = kern._derive_chain_state(rows, scalars, xyz, ht, lens, float(per_h[1]), float(scal[8]),
                                 int(scal[9]))
    b = kern._derive_chain_state(rows, scalars, xyz, ht, lens, per_d[1], scal_d[8], scal_d[9])
    _assert_same_bits([t.numpy() for t in a], [t.numpy() for t in b])
    assert 0 < int(a[2].sum()) < int(a[1].sum())


def test_eager_runner_passes_the_k4_cut_through():
    """Outside a capture a hand-kernel cut is a plain call: _kernel returns
    the callable's own result (a tuple from K4's), and a stretch run by
    an eager runner returns what the K4 cut inside it gave, in the
    register.pose_lm span that the cut's callable opens."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor((rng.normal(size=(1, 64, 3)) * [3, 3, 1] + [0, 0, 10])
                        .astype(np.float32))
    uv = X[..., :2] / X[..., 2:] * 700.0 + torch.tensor([400.0, 300.0])
    uv = uv + torch.as_tensor(rng.normal(size=(1, 64, 2)).astype(np.float32)) * 0.3
    K9 = torch.tensor([[700.0, 700.0, 400.0, 300.0, 0, 0, 0, 0, 0]])
    pose = torch.tensor([[0.01, -0.02, 0.0, 0.1, 0.0, 0.05]])
    mask = torch.ones((1, 64), dtype=torch.bool)
    args = (pose, X, uv, mask, K9, [cam.PINHOLE], 30, None)
    assert core._capture is None
    direct = kern._pose_lm(*args)
    sentinel = (torch.zeros(1), torch.ones(1))
    assert core._kernel(lambda: sentinel) is sentinel
    owner = _Owner()
    with span("register.dispatch", "reg_dispatch_s", owner):
        out = core._Stretches(False)("frame", lambda: core._kernel(kern._pose_lm, *args))
    _assert_same_bits([t.numpy() for t in out], [t.numpy() for t in direct])
    ref = core._pose_refine_loop(pose, X, uv, mask, K9, [cam.PINHOLE], 1.0, 30)
    _assert_same_bits([t.numpy() for t in out], [t.numpy() for t in ref])
    assert owner.counters["reg_pose_lm_s"] > 0 and bool(torch.isfinite(out[1]).all())


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh_graphs(monkeypatch):
    """A registration runner of its own (on the process's "reg" pool), so
    a test sees its keys captured."""
    monkeypatch.setattr(kern, "_FRAME_RUNNERS", {})
    monkeypatch.setattr(kern, "_FRAME_INPUTS", {})


@pytest.mark.gpu
@pytest.mark.parametrize("fresh", [False, True])
def test_graphed_chain_gives_the_eager_bits(dev, scene, fresh_graphs, fresh):
    """register_chain (fresh False) and register_chain_fresh (True) on the
    card, graphed and eagerly, from generators seeded alike: the same bits
    in all five outputs, the same K1 and K4 launches and host syncs. The
    graphed chain captures each key on its first frame (one for PINHOLE,
    two for the rig) and replays it on the rest; the eager one counts its
    frames as reg_eager_steps. A second graphed chain replays only, with
    the same bits."""
    inputs = _chain_inputs(scene)
    g, cnt_g, launched_g = _chain(scene, dev, inputs, fresh)
    e, cnt_e, launched_e = _chain(scene, dev, inputs, fresh, eager=True)
    _assert_same_bits(g, e)
    assert g[1][:, 5].sum() == K
    assert launched_g == launched_e == {"match": K, "pose_lm": K}
    assert cnt_g["host_syncs"] == cnt_e["host_syncs"]
    keys = 1 if scene[0] == "pinhole" else 2
    assert cnt_g["reg_graph_captures"] == keys
    assert cnt_g["reg_graph_replays"] == K - keys
    assert "reg_eager_steps" not in cnt_g
    assert cnt_e["reg_eager_steps"] == K and not any(k in cnt_e for k in GRAPH_COUNTERS)
    assert cnt_g["reg_pose_lm_s"] > 0 and cnt_e["reg_pose_lm_s"] > 0
    g2, cnt_g2, _ = _chain(scene, dev, inputs, fresh)
    _assert_same_bits(g2, g)
    assert cnt_g2["reg_graph_replays"] == K and "reg_graph_captures" not in cnt_g2


@pytest.mark.gpu
def test_replays_read_each_chains_thresholds_and_cameras(dev, scene, fresh_graphs):
    """Two chains in a row whose thresholds, camera parameters and track
    rules differ: the second replays the first's graphs and gets the bits
    of an eager chain on its own inputs, which differ from the first's."""
    first = _chain_inputs(scene)
    second = _chain_inputs(scene, seed=4, px=6.0, focal_scale=1.01, min_angle=2.0, min_len=3)
    g1, cnt1, _ = _chain(scene, dev, first, True)
    g2, cnt2, _ = _chain(scene, dev, second, True, seed=6)
    e2, _, _ = _chain(scene, dev, second, True, seed=6, eager=True)
    _assert_same_bits(g2, e2)
    assert cnt1["reg_graph_captures"] >= 1 and "reg_graph_captures" not in cnt2
    assert cnt2["reg_graph_replays"] == K
    assert not np.array_equal(g1[1], g2[1]) and not np.array_equal(g1[3], g2[3])


@pytest.mark.gpu
def test_injected_samples_stay_eager_on_the_card(dev, scene, fresh_graphs):
    """A chain given its samples runs eagerly on the card and counts each
    frame as reg_eager_steps; with the samples a graphed chain drew, it
    gives that chain's bits."""
    from mavmap_tpu_torch.sfm import kernels

    drawn = []
    draw = kernels.draw_samples

    def recording(*a, **kw):
        drawn.append(draw(*a, **kw))
        return drawn[-1]

    inputs = _chain_inputs(scene)
    kernels.draw_samples = recording
    try:
        g, _, _ = _chain(scene, dev, inputs, False)
    finally:
        kernels.draw_samples = draw
    samples = [tuple(s[0] for s in d) for d in drawn]
    e, cnt, _ = _chain(scene, dev, inputs, False, samples=samples)
    _assert_same_bits(g, e)
    assert cnt["reg_eager_steps"] == K and not any(k in cnt for k in GRAPH_COUNTERS)


@pytest.mark.gpu
def test_a_second_mapper_replays_only(dev, fresh_graphs, monkeypatch):
    """Two mappers of one process map the same frames through chains of
    4: the first captures the one key, the second replays it on every
    chain frame; both give the map of a mapper whose chains run eagerly,
    bit for bit, with the same host syncs."""
    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.sfm import SequentialMapper, SequentialMapperOptions

    sc = make_uav_scene(num_images=14, num_points=2400, relief=10.0, seed=13)
    feats, _ = render_features(sc, pixel_noise=0.3, clutter=20, seed=13, max_features=F)
    opts = SequentialMapperOptions(tri_min_angle=1.0, essential_ransac_trials=256,
                                   p3p_ransac_trials=P3P)

    def mapped():
        m = SequentialMapper(sc.image_cameras, sc.cam_models, sc.cam_params,
                             ArrayFeatureProvider(feats, capacity=F), device=dev, seed=0)
        assert m.process_initial(0, 1, SequentialMapperOptions(
            tri_min_angle=4.0, essential_ransac_trials=256, p3p_ransac_trials=P3P))
        for first in (2, 6, 10):
            assert m.process_chain_k(list(range(first, first + 4)), first - 1, opts) == \
                [True] * 4
        ids = sorted(m.image_idx_to_id.values())
        poses = np.array([np.concatenate(m.store.get_pose(i)) for i in ids])
        return poses, m.store.num_points3D, m.counters

    a = mapped()
    b = mapped()
    eager = kern._graph_chain
    monkeypatch.setattr(kern, "_graph_chain", lambda d, s, e=False: eager(d, s, True))
    c = mapped()
    for x in (b, c):
        assert np.array_equal(x[0], a[0]) and x[1] == a[1]
    assert a[2]["reg_graph_captures"] == 1 and a[2]["reg_graph_replays"] == 11
    assert "reg_graph_captures" not in b[2] and b[2]["reg_graph_replays"] == 12
    assert c[2]["reg_eager_steps"] == 12 and not any(k in c[2] for k in GRAPH_COUNTERS)
    assert a[2]["host_syncs"] == b[2]["host_syncs"] == c[2]["host_syncs"]
