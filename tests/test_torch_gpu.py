"""CUDA kernels of mavmap_tpu_torch against their plain PyTorch versions,
on the card. Every test is marked `gpu` and skips without a CUDA device.

This file imports neither jax nor mavmap_tpu, so it runs on a GPU machine
without JAX — without the suite's conftest.py, which imports jax:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: K1 distances 1e-5 with indices equal except at near-ties
(best and second within 1e-5: f32 dot products summed in another order
may swap them); K2/K3 1e-5 of the per-segment sum of |contrib| (K2 adds
with atomics, in an order that changes from run to run).
"""

import numpy as np
import pytest
import torch

from mavmap_tpu_torch.ba import BAOptions, build_problem, bundle_adjust
from mavmap_tpu_torch.ops.cuda import ba_accum as ka
from mavmap_tpu_torch.ops.cuda import build
from mavmap_tpu_torch.ops.cuda import match as km
from mavmap_tpu_torch.ops.matching import match_features
from mavmap_tpu_torch.ops.rotation import rotmat_from_rvec

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _pair(rng, N1, N2, D=128):
    d1 = rng.normal(size=(N1, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    src = rng.integers(0, N1, N2)
    d2 = d1[src] + rng.normal(size=(N2, D)).astype(np.float32) * 0.02
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    m1 = rng.random(N1) > 0.05
    m2 = rng.random(N2) > 0.05
    kp1 = (rng.random((N1, 2)) * [800, 600]).astype(np.float32)
    kp2 = (kp1[src] + rng.normal(size=(N2, 2)) * 30).astype(np.float32)
    return d1, d2, m1, m2, kp1, kp2


@pytest.mark.parametrize("N1,N2", [(1024, 1024), (1000, 937)])
def test_match_kernel_vs_plain(dev, rng, N1, N2):
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, N1, N2)
    args = km.padded_operands(*[torch.as_tensor(a, device=dev)
                                for a in (d1, d2, m1, m2, kp1, kp2)], max_distance=60.0)
    before = build.launches["match"]
    got = km.match_raw(*args)
    ref = km.match_raw_plain(*args)
    torch.cuda.synchronize()
    assert build.launches["match"] == before + 1
    for a, b, s in ((0, 1, 2), (3, 4, 5)):
        near_tie = (ref[s] - ref[b]) <= 1e-5
        assert bool(((got[a] == ref[a]) | near_tie).all())
        real = ref[b] < 1e29
        assert float((got[b] - ref[b]).abs()[real].max()) <= 1e-5
        assert torch.equal(got[b][~real], ref[b][~real])
    mk, _ = match_features(*[torch.as_tensor(a, device=dev) for a in (d1, d2, m1, m2)])
    mc, _ = match_features(*[torch.as_tensor(a) for a in (d1, d2, m1, m2)])
    assert int((mk.cpu() != mc).sum()) <= 2


@pytest.mark.parametrize("O,K,S", [(8192, 9, 17), (8192, 81, 17), (32768, 81, 289),
                                   (32768, 81, 1089), (5000, 42, 2500)])
def test_seg_accum_full_kernel_vs_plain(dev, rng, O, K, S):
    c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
    ids = torch.as_tensor(rng.integers(0, S, O).astype(np.int32), device=dev)
    got = ka.seg_accum_full(c, ids, S)
    ref = ka.seg_accum_full_plain(c, ids, S)
    scale = ka.seg_accum_full_plain(c.abs(), ids, S)
    assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("O,K", [(8192, 12), (20480, 3)])
def test_seg_accum_sorted_kernel_vs_plain(dev, rng, O, K):
    lens = rng.integers(2, 10, size=O // 6)
    S = -(-len(lens) // 1024) * 1024
    off = torch.as_tensor(ka.offsets_from_sorted_ids(np.repeat(np.arange(len(lens)), lens), S),
                          device=dev)
    c = torch.as_tensor(rng.normal(size=(O, K)).astype(np.float32), device=dev)
    got = ka.seg_accum_sorted(c, off, S)
    ref = ka.seg_accum_sorted_plain(c, off, S)
    scale = ka.seg_accum_sorted_plain(c.abs(), off, S)
    assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all())


def _ba_problem(rng, I=8, P=240, per_image=140):
    """tests/test_torch_ba.py's scene: rotated views, 0.5 px noise, a 1 %
    focal error. The rotations keep focal length and depth apart; with
    pure translation along x the two trade off almost freely, and f32
    rounding then moves the result by far more than it does here."""
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = (rng.normal(size=(P, 3)) * [4, 4, 2] + [0, 0, 14]).astype(np.float32)
    poses = np.concatenate([rng.normal(size=(I, 3)) * 0.03,
                            np.stack([np.arange(I) * 0.7, np.zeros(I), np.zeros(I)], 1)],
                           axis=1).astype(np.float32)
    R = rotmat_from_rvec(torch.as_tensor(poses[:, :3])).numpy()
    oi, op, uv = [], [], []
    for i in range(I):
        Xc = X @ R[i].T + poses[i, 3:]
        u = Xc[:, :2] / Xc[:, 2:] * 700.0 + [400.0, 300.0]
        sel = np.sort(rng.permutation(P)[:per_image])
        oi += [i] * len(sel)
        op += list(sel)
        uv += list(u[sel] + rng.normal(size=(len(sel), 2)) * 0.5)
    poses0 = poses + rng.normal(size=poses.shape).astype(np.float32) * [0.003] * 3 \
        + np.concatenate([np.zeros((I, 3)), rng.normal(size=(I, 3)) * 0.02], 1)
    poses0[:2] = poses[:2]
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    K0 = K.copy()
    K0[0, :2] *= 1.01
    return build_problem(poses0.astype(np.float32), X0.astype(np.float32), K0, [1],
                         oi, op, np.zeros(len(oi), np.int32), np.array(uv, np.float32),
                         pose_states=[1, 2] + [0] * (I - 2), bucket=True)


@pytest.mark.parametrize("selfcal", [True, False])
def test_bundle_adjust_gpu_vs_cpu(dev, rng, selfcal):
    """One BA through K2/K3 on the card vs the CPU path, 6 iterations:
    final cost and intrinsics at 1e-4 relative, poses and points at 1e-3
    relative to their scale. The scale of the scene is pinned only by
    the second view's x-translation, so the cost is nearly flat along
    it: on the CPU, moving the observations by 1e-7 relative (f32
    rounding, as summing in another order on the card does) moves the
    x-translations by up to 1.1e-4 of the scale after 6 iterations, and
    the cost and intrinsics by under 3e-5."""
    prob = _ba_problem(rng)
    opts = BAOptions(max_num_iterations=6, refine_camera_params=selfcal,
                     function_tolerance=0.0)
    before = dict(build.launches)
    pg, xg, ig = bundle_adjust(prob, opts, dev)
    assert build.launches["seg_accum_full"] > before["seg_accum_full"]
    assert build.launches["seg_accum_sorted"] > before["seg_accum_sorted"]
    pc, xc, ic = bundle_adjust(prob, opts, torch.device("cpu"))
    assert ig["iterations"] == ic["iterations"] == 6
    assert ic["final_cost"] < 0.1 * ic["initial_cost"]
    np.testing.assert_allclose(ig["final_cost"], ic["final_cost"], rtol=1e-4)
    for g, c in ((pg, pc), (xg, xc)):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-3 * np.abs(c).max())
    if selfcal:
        np.testing.assert_allclose(ig["cam_params"], ic["cam_params"], rtol=1e-4)
