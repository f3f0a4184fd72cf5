"""Bundle adjustment's LM loop as CUDA graphs (ba/core.py _Stretches).

On a CUDA device without psum each stretch of device work between two
host reads (the solve's start; the dense solver's iteration; CG's
assembly, each CG iteration, its back-substitution and accept/reject) is
captured once per solve key (core._solve_key: the bucketed sizes, the
camera models, the solver and the numbers baked into the graphs) and
replayed by every later solve with that key. The CPU and the psum path
run the same stretches eagerly, with the bits of the plain loops: they
never build a key. On the card (tests marked `gpu`, which skip without a
CUDA device) a graphed solve gives the eager solve's bits, iterations, CG
iterations, kernel launch counts and host syncs; it captures each
stretch once per key and replays it on every later run, a second solve
of the key with other data only replays, every K2 / K3 launch still goes
through its Python entry point (with the solve's own plans), where the
benchmark logs each launch's bound, solves of one key keep their own
results, and a key past the cap is evicted.

This file imports neither jax nor mavmap_tpu, so it runs on a GPU machine
without JAX:

    python -m pytest --noconftest tests/test_torch_ba_graphs.py -q
"""

import numpy as np
import pytest
import torch

from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust, bundle_adjust_async
from mavmap_tpu_torch.ba import core
from mavmap_tpu_torch.models import camera as cam
from mavmap_tpu_torch.ops.cuda import ba_accum as ka
from mavmap_tpu_torch.ops.cuda import build
from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec
from mavmap_tpu_torch.utils.timer import span

CPU = torch.device("cpu")
GRAPH_COUNTERS = ("ba_graph_captures", "ba_graph_replays", "ba_graph_evictions")
# The benchmark's rig: a PINHOLE camera and an OPENCV lens.
CAMERAS = {
    "pinhole": [(cam.PINHOLE, [700.0, 700.0, 400.0, 300.0])],
    "rig": [(cam.PINHOLE, [700.0, 700.0, 400.0, 300.0]),
            (cam.OPENCV, [620.0, 620.0, 406.0, 296.0, -0.15, 0.03, 0.0005, -0.0005])],
}
LM = (1.0, 1e-4, 10.0, 0.5)  # scale, lambda_init, lambda_up, lambda_down
CG_TOL = 1e-3


@pytest.fixture(autouse=True)
def fresh_solves(monkeypatch):
    """Each test starts with no solve key's graphs kept (core._SOLVES), and
    resets those it made."""
    solves = {}
    monkeypatch.setattr(core, "_SOLVES", solves)
    yield solves
    for cache in solves.values():
        for run, *_ in cache.values():
            run.close()


class _Owner:
    """A stand-in for the mapper that owns the spans: its counters."""

    def __init__(self):
        self.counters = {}


def _problem(cameras="pinhole", I=10, P=300, per_image=150, noise=0.5, focal_err=0.01,
             seed=7):
    """A bucketed problem of I views of P points, view i on camera
    i % len(cameras), 0.5 px noise, the intrinsics' focal lengths off by
    `focal_err`; the first view fixed, the second's x-translation too."""
    rng = np.random.default_rng(seed)
    cams = CAMERAS[cameras]
    K = np.zeros((len(cams), 9), np.float32)
    for c, (_, params) in enumerate(cams):
        K[c, :len(params)] = params
    models = np.array([m for m, _ in cams], np.int32)
    X = (rng.normal(size=(P, 3)) * [4, 4, 2] + [0, 0, 14]).astype(np.float32)
    poses = np.concatenate([rng.normal(size=(I, 3)) * 0.03,
                            np.stack([np.arange(I) * 0.7, np.zeros(I), np.zeros(I)], 1)],
                           axis=1).astype(np.float32)
    R = rotmat_from_rvec(torch.as_tensor(poses[:, :3])).numpy()
    oi, op, oc, uv = [], [], [], []
    for i in range(I):
        c = i % len(cams)
        Xc = (X @ R[i].T + poses[i, 3:]).astype(np.float32)
        u = cam.world2image(torch.as_tensor(Xc), int(models[c]), torch.as_tensor(K[c])).numpy()
        sel = np.sort(rng.permutation(P)[:per_image])
        oi += [i] * len(sel)
        op += list(sel)
        oc += [c] * len(sel)
        uv += list(u[sel] + rng.normal(size=(len(sel), 2)) * noise)
    poses0 = poses + rng.normal(size=poses.shape).astype(np.float32) * [0.003] * 3 \
        + np.concatenate([np.zeros((I, 3)), rng.normal(size=(I, 3)) * 0.02], 1)
    poses0[:2] = poses[:2]
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    K0 = K.copy()
    K0[:, :2] *= 1.0 + focal_err
    return build_problem(poses0.astype(np.float32), X0.astype(np.float32), K0, models,
                         np.array(oi, np.int32), np.array(op, np.int32),
                         np.array(oc, np.int32), np.array(uv, np.float32),
                         pose_states=[1, 2] + [0] * (I - 2), bucket=True)


def _key(host, selfcal, solver, function_tolerance=1e-4):
    return core._solve_key(host, selfcal, solver, *LM, function_tolerance, CG_TOL)


def _solve(host, device, selfcal, solver, *, eager=False, psum=None, max_iters=10,
           function_tolerance=1e-4):
    """The LM loop of bundle_adjust on `device` inside a span owned by a
    stand-in mapper, under the solve's key where bundle_adjust would build
    one (a CUDA device, no psum) unless `eager`: (results as numpy, CG
    iterations, the mapper's counters, the kernels' launch counts)."""
    prob = core.problem_to_device(core.with_plans(host, core.solver_plans(selfcal, solver)),
                                  device)
    owner = _Owner()
    stats = {}
    key = (None if eager or not core._graphed(device, psum)
           else _key(host, selfcal, solver, function_tolerance))
    kw = dict(solver=solver, cg_max_iters=100, cg_tol=CG_TOL, stats=stats, key=key)
    before = dict(build.launches)
    with span("ba.solve", "ba_solve_s", owner):
        if selfcal:
            out = core._lm_loop_selfcal(prob, core._selfcal_cam_free(prob), *LM,
                                        function_tolerance, max_iters, **kw)
        else:
            out = core._lm_loop(prob, *LM, function_tolerance, max_iters, psum=psum, **kw)
    launched = {k: build.launches[k] - before[k] for k in before}
    res = [t.cpu().numpy() if torch.is_tensor(t) else t for t in out]
    return res, stats.get("cg_iters", []), owner.counters, launched


def _assert_same_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)
        else:
            assert x == y


# ------------------------------------------------------------------ CPU


def test_graphs_only_on_a_cuda_device_without_psum():
    """The choice rests on what the solve can see, the device and psum;
    an eager runner calls each stretch and its K2 / K3 calls, and copies
    the state it carries into the loop's own tensors."""
    assert core._graphed(torch.device("cuda", 0), None)
    assert core._graphed("cuda", None)
    assert not core._graphed(torch.device("cuda", 0), lambda x: x)
    assert not core._graphed(CPU, None)
    run = core._Stretches(False)
    x = torch.zeros(2)
    state = {"x": x}
    assert run("step", lambda: run.carry(state, x=torch.ones(2)) or 5) == 5
    assert state["x"] is x and x.tolist() == [1.0, 1.0] and not run.runs
    assert core._capture is None and core._kernel(torch.add, x, 2.0).tolist() == [3.0, 3.0]


@pytest.mark.parametrize("cameras", ["pinhole", "rig"])
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("selfcal", [False, True])
def test_cpu_solves_never_capture(cameras, solver, selfcal):
    """bundle_adjust on the CPU runs its stretches eagerly: the owning
    mapper's graph counters stay at 0, and the loop's `eager` keyword
    changes nothing there."""
    host = _problem(cameras, I=8, per_image=120)
    owner = _Owner()
    with span("ba.solve", "ba_solve_s", owner):
        _, _, info = bundle_adjust(host, BAOptions(max_num_iterations=4, solver=solver,
                                                   refine_camera_params=selfcal), device=CPU)
    assert info["iterations"] >= 1 and owner.counters.get("ba_host_syncs", 0) > 0
    assert all(owner.counters.get(k, 0) == 0 for k in GRAPH_COUNTERS)
    a, cg_a, counters, _ = _solve(host, CPU, selfcal, solver, max_iters=3)
    b, cg_b, _, _ = _solve(host, CPU, selfcal, solver, max_iters=3, eager=True)
    _assert_same_bits(a, b)
    assert cg_a == cg_b and (solver == "dense") == (not cg_a)
    assert all(counters.get(k, 0) == 0 for k in GRAPH_COUNTERS)


def _plain_pcg(matvec, Minv, b, free, cg_iters, cg_tol):
    """CG as one Python loop that tests the residual before each
    iteration: what _pcg computes, stretch by stretch."""
    r0n = torch.sqrt(torch.sum(b * b))
    x, r = torch.zeros_like(b), b
    z = torch.einsum("iab,ib->ia", Minv, r) * free
    p, rz = z, torch.sum(r * z)
    it = 0
    while it < cg_iters and bool(torch.sqrt(torch.sum(r * r)) > cg_tol * r0n):
        Sp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Sp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Sp
        z = torch.einsum("iab,ib->ia", Minv, r) * free
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
        it += 1
    return x, it


@pytest.mark.parametrize("cameras", ["pinhole", "rig"])
@pytest.mark.parametrize("selfcal", [False, True])
def test_cg_stretches_give_the_plain_loops_bits(cameras, selfcal):
    """One CG step through _pcg's stretches (the assembly with the first
    residual test, then one stretch per CG iteration) equals the plain CG
    loop on the same system bit for bit, iteration count included."""
    host = _problem(cameras, I=8, per_image=120)
    prob = core.problem_to_device(core.with_plans(host, core.PLANS), CPU)
    pts = core._gather_dense_points(prob, prob.points)
    lam = torch.tensor(0.1)
    stats = {}
    if selfcal:
        free_k = core._selfcal_cam_free(prob)
        system = core._cg_system_selfcal(prob, prob.poses, pts, prob.cam_params, free_k, lam,
                                         1.0)
        step = core._lm_step_selfcal_cg(prob, prob.poses, pts, prob.cam_params, free_k, lam,
                                        1.0, 100, 1e-6, stats)
    else:
        system = core._cg_system(prob, prob.poses, pts, lam, 1.0)
        step = core._lm_step_cg(prob, prob.poses, pts, lam, 1.0, 100, 1e-6, stats)
    matvec, Minv, b, free, finish = system
    x, it = _plain_pcg(matvec, Minv, b, free, 100, 1e-6)
    assert 1 < it < 100 and stats["cg_iters"] == [it]
    _assert_same_bits([t.numpy() for t in step], [t.numpy() for t in finish(x)])


def test_problems_in_the_same_buckets_share_a_key():
    """Two problems of other values and other real sizes in the same
    buckets (images to 8, points and dense points to 1024, observations to
    4096) get one key."""
    a = _problem(seed=7)
    b = _problem(I=12, P=500, per_image=170, seed=8)
    assert [len(x) for x in (a.poses, a.points, a.point_rows, a.obs_image)] == \
        [len(x) for x in (b.poses, b.points, b.point_rows, b.obs_image)]
    assert not np.array_equal(a.obs_uv, b.obs_uv)
    for selfcal in (False, True):
        for solver in ("dense", "cg"):
            assert _key(a, selfcal, solver) == _key(b, selfcal, solver)


# Each changes one thing a solve's graphs are shaped by or bake in.
KEY_CHANGES = {
    "images": lambda h, kw: (h._replace(poses=np.zeros((len(h.poses) + 8, 6), np.float32)), kw),
    "cameras": lambda h, kw: (h._replace(cam_params=np.zeros((2, 9), np.float32),
                                         cam_models=np.array([cam.PINHOLE] * 2, np.int32)), kw),
    "points": lambda h, kw: (h._replace(points=np.zeros((len(h.points) + 1024, 3), np.float32)),
                             kw),
    "dense_points": lambda h, kw: (h._replace(point_rows=np.zeros(len(h.point_rows) + 1024,
                                                                  np.int32)), kw),
    "observations": lambda h, kw: (h._replace(obs_image=np.zeros(len(h.obs_image) + 4096,
                                                                 np.int32)), kw),
    "camera_models": lambda h, kw: (h._replace(cam_models=np.array([cam.OPENCV], np.int32)), kw),
    "solver": lambda h, kw: (h, dict(kw, solver="cg")),
    "selfcal": lambda h, kw: (h, dict(kw, selfcal=True)),
    "loss_scale": lambda h, kw: (h, dict(kw, scale=2.0)),
    "lambda_init": lambda h, kw: (h, dict(kw, lambda_init=1e-3)),
    "lambda_up": lambda h, kw: (h, dict(kw, lambda_up=5.0)),
    "lambda_down": lambda h, kw: (h, dict(kw, lambda_down=0.25)),
    "function_tolerance": lambda h, kw: (h, dict(kw, function_tolerance=1e-6)),
    "cg_tol": lambda h, kw: (h, dict(kw, cg_tol=1e-2)),
    "dtype": lambda h, kw: (h._replace(poses=h.poses.astype(np.float64)), kw),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_the_key_changes_with_what_shapes_or_is_baked_into_the_graphs(change):
    """A change of any one bucketed size (I, C, P, Pd, O), of the camera
    models, the solver, selfcal, a number the stretches bake in (the loss
    scale, lambda's start, up and down factors, the function tolerance,
    CG's target) or of the dtype gives another key."""
    host = _problem()
    kw = dict(selfcal=False, solver="dense", scale=LM[0], lambda_init=LM[1],
              lambda_up=LM[2], lambda_down=LM[3], function_tolerance=1e-4, cg_tol=CG_TOL)
    other, other_kw = KEY_CHANGES[change](host, kw)
    assert core._solve_key(other, **other_kw) != core._solve_key(host, **kw)


def test_cpu_and_psum_solves_never_build_a_key(monkeypatch, fresh_solves):
    """bundle_adjust on the CPU and the loop with a psum hook (the
    point-sharded solve's) run eagerly: no key is built and nothing is
    kept."""
    def no_key(*args, **kwargs):
        raise AssertionError("a key was built")

    monkeypatch.setattr(core, "_solve_key", no_key)
    host = _problem(I=8, per_image=120)
    for solver in ("dense", "cg"):
        for selfcal in (False, True):
            bundle_adjust(host, BAOptions(max_num_iterations=2, solver=solver,
                                          refine_camera_params=selfcal), device=CPU)
        a, cg_a, counters, _ = _solve(host, CPU, False, solver, psum=lambda x: x, max_iters=2)
        b, cg_b, _, _ = _solve(host, CPU, False, solver, eager=True, max_iters=2)
        _assert_same_bits(a, b)
        assert cg_a == cg_b and all(counters.get(k, 0) == 0 for k in GRAPH_COUNTERS)
    assert fresh_solves == {}


class _EagerKeyRunner(core._Stretches):
    """The "ba" runner of a key, run eagerly on the CPU: each stretch is a
    plain call, with hand-kernel calls routed through the runner as a
    capture routes them (so its swap applies); it records the stretches and
    whether it was closed."""

    def __init__(self, graphed, device=None, name="ba"):
        super().__init__(False)
        self.stretches, self.closed = [], False

    def __call__(self, key, fn):
        self.stretches.append(key)
        core._capture = self
        try:
            return fn()
        finally:
            core._capture = None

    def kernel(self, fn, args):
        return fn(*self.bound(args))

    def close(self):
        self.closed = True
        super().close()


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("selfcal", [False, True])
def test_keyed_solves_on_the_cpu_give_the_eager_bits(monkeypatch, fresh_solves, solver,
                                                    selfcal):
    """The cached path run by an eager runner on the CPU: two problems of
    one key share the key's runner and static inputs, each solve copies its
    problem in, hands the K2 / K3 calls its own plans and offsets, and gets
    its eager solve's bits; past the cap the least recently used key is
    evicted, closed and counted."""
    monkeypatch.setattr(core, "_Stretches", _EagerKeyRunner)
    monkeypatch.setattr(core, "SOLVE_KEYS", 2)
    first, second = _problem("rig", seed=7), _problem("rig", I=12, P=500, seed=8)
    key = _key(first, selfcal, solver)

    def solve(host, key, **kw):
        prob = core.problem_to_device(
            core.with_plans(host, core.solver_plans(selfcal, solver)), CPU)
        extra = (core._selfcal_cam_free(prob),) if selfcal else ()
        loop = core._lm_loop_selfcal if selfcal else core._lm_loop
        owner = _Owner()
        with span("ba.solve", "ba_solve_s", owner):
            out = loop(prob, *extra, *LM, kw.get("function_tolerance", 1e-4), 4, solver=solver,
                       cg_max_iters=100, cg_tol=CG_TOL, key=key)
        return [t.numpy() if torch.is_tensor(t) else t for t in out], owner.counters

    keyed_first, _ = solve(first, key)
    keyed_second, _ = solve(second, key)
    _assert_same_bits(keyed_first, solve(first, None)[0])
    _assert_same_bits(keyed_second, solve(second, None)[0])
    (cache,) = fresh_solves.values()
    run = cache[key][0]
    assert list(cache) == [key] and run.stretches[0] == "start"
    assert run.stretches.count("start") == 2 and len(run.stretches) > 4
    solve(first, _key(first, selfcal, solver, 1e-5), function_tolerance=1e-5)
    _, counters = solve(first, _key(first, selfcal, solver, 1e-6), function_tolerance=1e-6)
    assert run.closed and key not in cache and len(cache) == 2
    assert counters["ba_graph_evictions"] == 1


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cameras", ["pinhole", "rig"])
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("selfcal", [False, True])
def test_graphed_solve_gives_the_eager_bits(dev, cameras, solver, selfcal):
    """The same bucketed problem solved on the card with graphs and
    eagerly: the same bits of poses, points (and intrinsics), both costs,
    the same iterations and CG iterations, the same K2/K3 launch counts and
    host syncs. Each stretch is captured once and replayed on every later
    run: the start; the dense solver's one stretch per iteration; CG's
    assembly and back-substitution per iteration and one stretch per CG
    iteration. A second solve of the key replays only, with the same bits
    and host syncs."""
    host = _problem(cameras)
    g, cg_g, cnt_g, launched_g = _solve(host, dev, selfcal, solver)
    e, cg_e, cnt_e, launched_e = _solve(host, dev, selfcal, solver, eager=True)
    _assert_same_bits(g, e)
    assert cg_g == cg_e
    assert launched_g == launched_e and launched_g["seg_accum_sorted"] > 0
    assert cnt_g["host_syncs"] == cnt_e["host_syncs"]
    assert cnt_g["ba_host_syncs"] == cnt_e["ba_host_syncs"]
    assert all(cnt_e.get(k, 0) == 0 for k in GRAPH_COUNTERS)
    iters = g[-1]
    runs = 1 + (iters if solver == "dense" else 2 * iters + sum(cg_g))
    stretches = 2 if solver == "dense" else 3 + (sum(cg_g) > 0)
    assert iters >= 2
    assert cnt_g["ba_graph_captures"] == stretches
    assert cnt_g["ba_graph_replays"] == runs - stretches
    # A second graphed solve of the key replays only, with the same bits.
    g2, _, cnt_g2, _ = _solve(host, dev, selfcal, solver)
    _assert_same_bits(g2, g)
    assert cnt_g2 == {k: v for k, v in cnt_g.items() if k != "ba_graph_captures"} | {
        "ba_graph_replays": runs, "ba_solve_s": cnt_g2["ba_solve_s"]}


@pytest.mark.gpu
def test_bundle_adjust_captures_once_per_dense_solve(dev):
    """Every dense bundle_adjust on the card captures its two stretches
    (the start and the iteration) once per key and replays them on each
    later run: over a pinhole solve, a rig solve and another pinhole
    problem's solve, four captures and 3 + iterations - 4 replays."""
    owner = _Owner()
    iters = 0
    with span("ba.solve", "ba_solve_s", owner):
        for seed, (cameras, selfcal) in enumerate((("pinhole", False), ("rig", True),
                                                   ("pinhole", False))):
            _, _, info = bundle_adjust(_problem(cameras, seed=seed), BAOptions(
                max_num_iterations=8, solver="dense", refine_camera_params=selfcal),
                device=dev)
            iters += info["iterations"]
    assert owner.counters["ba_graph_captures"] == 4
    assert owner.counters["ba_graph_replays"] == 3 + iters - 4


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_psum_solve_on_the_card_never_captures(dev, fresh_solves, solver):
    """With a psum hook the loop stays eager on the card (collectives stay
    out of graphs) and keeps nothing, and one rank's sum gives the graphed
    solve's bits."""
    host = _problem(focal_err=0.0)
    a, cg_a, counters, _ = _solve(host, dev, False, solver, psum=lambda x: x)
    assert fresh_solves == {}
    b, cg_b, _, _ = _solve(host, dev, False, solver)
    _assert_same_bits(a, b)
    assert cg_a == cg_b
    assert all(counters.get(k, 0) == 0 for k in GRAPH_COUNTERS)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("selfcal", [False, True])
def test_every_k2_k3_launch_calls_its_entry_point(dev, monkeypatch, solver, selfcal):
    """A graphed solve calls K2's and K3's entry points (ops/cuda/ba_accum.py
    `_seg_accum_full_cuda`, `_seg_accum_sorted_cuda`, looked up on every
    call) once per launch, on replays too, with the arguments of the eager
    solve's calls: what wraps them sees every launch, and the graphs hold
    no hand kernel."""
    seen = []

    def wrap(name):
        orig = getattr(ka, name)

        def call(contrib, *rest):
            seen.append((name, tuple(contrib.shape)))
            return orig(contrib, *rest)

        monkeypatch.setattr(ka, name, call)

    wrap("_seg_accum_full_cuda")
    wrap("_seg_accum_sorted_cuda")
    host = _problem("rig")
    g, _, cnt_g, launched_g = _solve(host, dev, selfcal, solver)
    calls_g, seen[:] = list(seen), []
    e, _, _, launched_e = _solve(host, dev, selfcal, solver, eager=True)
    _assert_same_bits(g, e)
    assert calls_g == seen and cnt_g["ba_graph_replays"] > 0
    names = [n for n, _ in seen]
    assert launched_g == launched_e
    assert launched_g["seg_accum_full"] == names.count("_seg_accum_full_cuda")
    assert launched_g["seg_accum_sorted"] == names.count("_seg_accum_sorted_cuda") > 0


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("selfcal", [False, True])
def test_a_second_solve_of_a_key_with_other_data_only_replays(dev, solver, selfcal):
    """A solve of a key that another problem's solve captured copies its
    own problem in and only replays, with the bits, iterations, CG
    iterations, K2 / K3 launch counts and host syncs of its eager solve:
    the hand-kernel calls take its own plans and offsets."""
    first, second = _problem("rig", seed=7), _problem("rig", I=12, P=500, seed=8)
    assert _key(first, selfcal, solver) == _key(second, selfcal, solver)
    _solve(first, dev, selfcal, solver)
    g, cg_g, cnt_g, launched_g = _solve(second, dev, selfcal, solver)
    e, cg_e, cnt_e, launched_e = _solve(second, dev, selfcal, solver, eager=True)
    _assert_same_bits(g, e)
    assert cg_g == cg_e and launched_g == launched_e
    assert cnt_g["host_syncs"] == cnt_e["host_syncs"]
    assert cnt_g["ba_host_syncs"] == cnt_e["ba_host_syncs"]
    assert "ba_graph_captures" not in cnt_g and cnt_g["ba_graph_replays"] > g[-1]


@pytest.mark.gpu
def test_a_solve_in_another_bucket_captures(dev, fresh_solves):
    """A problem in another image bucket is another key: its solve
    captures, and the first key's next solve still only replays."""
    small, large = _problem(), _problem(I=20, seed=8)
    assert _key(small, True, "dense") != _key(large, True, "dense")
    _, _, cnt_a, _ = _solve(small, dev, True, "dense")
    _, _, cnt_b, _ = _solve(large, dev, True, "dense")
    _, _, cnt_c, _ = _solve(small, dev, True, "dense")
    assert cnt_a["ba_graph_captures"] == cnt_b["ba_graph_captures"] == 2
    assert "ba_graph_captures" not in cnt_c and cnt_c["ba_graph_replays"] > 2
    assert [len(c) for c in fresh_solves.values()] == [2]


@pytest.mark.gpu
@pytest.mark.parametrize("selfcal", [False, True])
def test_solves_of_one_key_dispatched_back_to_back_keep_their_results(dev, fresh_solves,
                                                                     selfcal):
    """As the mapper's deferred window solves: two solves of one key
    dispatched one after the other, then finalized in order, each give
    what they give when finalized at once: poses, points, costs,
    iterations, intrinsics and point errors."""
    opts = BAOptions(max_num_iterations=6, solver="dense", refine_camera_params=selfcal,
                     update_point3D_errors=True)
    hosts = (_problem("rig", seed=7), _problem("rig", I=12, P=500, seed=8))
    alone = [bundle_adjust(h, opts, device=dev) for h in hosts]
    handles = [bundle_adjust_async(h, opts, device=dev) for h in hosts]
    assert [len(c) for c in fresh_solves.values()] == [1]
    assert not np.array_equal(alone[0][0], alone[1][0])
    for (poses, points, info), finalize in zip(alone, handles):
        poses2, points2, info2 = finalize()
        assert np.array_equal(poses, poses2) and np.array_equal(points, points2)
        for k in ("initial_cost", "final_cost", "iterations"):
            assert info[k] == info2[k]
        assert np.array_equal(info["point_errors"], info2["point_errors"])
        if selfcal:
            assert np.array_equal(info["cam_params"], info2["cam_params"])


@pytest.mark.gpu
def test_a_solve_past_the_cap_evicts(dev, monkeypatch, fresh_solves):
    """With room for two keys a third key evicts the least recently used
    one: its graphs are reset and the eviction counted. Solving that key
    again captures anew into the same pool, with the eager bits."""
    monkeypatch.setattr(core, "SOLVE_KEYS", 2)
    host = _problem()
    tolerances = (1e-4, 1e-5, 1e-6)
    _solve(host, dev, False, "dense", function_tolerance=tolerances[0])
    (cache,) = fresh_solves.values()
    evicted = cache[_key(host, False, "dense", tolerances[0])][0]
    assert evicted.runs
    for tol in tolerances[1:]:
        _, _, cnt, _ = _solve(host, dev, False, "dense", function_tolerance=tol)
    assert list(cache) == [_key(host, False, "dense", t) for t in tolerances[1:]]
    assert cnt["ba_graph_evictions"] == 1 and not evicted.runs
    g, _, cnt, _ = _solve(host, dev, False, "dense")
    e, _, _, _ = _solve(host, dev, False, "dense", eager=True)
    _assert_same_bits(g, e)
    assert cnt["ba_graph_captures"] == 2 and cnt["ba_graph_evictions"] == 1
