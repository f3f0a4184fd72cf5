"""Descriptor matching of the PyTorch port held against the JAX package.

Match indices must be exactly equal: against JAX `match_brute_force` (the
plain XLA version) for the port's plain `match_brute_force`, and against
the interpreted Pallas kernel for the port's fused path (`match_features`,
whose CPU branch is the plain version of CUDA kernel K1). Distances agree
to 1e-5 (f32 sums of 128 products in a different order).

The kernel itself runs only on a GPU: see tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ops.matching import match_brute_force as j_match
from mavmap_tpu_torch.ops.cuda import match as km
from mavmap_tpu_torch.ops.matching import match_brute_force as t_match, match_features

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX matcher's Pallas kernel in interpret mode (as in
    tests/test_pallas_match.py)."""
    import jax.experimental.pallas as pl
    import mavmap_tpu.ops.pallas.match as pm

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pm.pl, "pallas_call", patched)
    return pm


def _pair(rng, N1=256, N2=256, D=128, noise=0.02):
    d1 = rng.normal(size=(N1, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    src = rng.integers(0, N1, N2)
    d2 = d1[src] + rng.normal(size=(N2, D)).astype(np.float32) * noise
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    m1 = np.ones(N1, bool)
    m1[-30:] = False
    m2 = np.ones(N2, bool)
    m2[-10:] = False
    kp1 = (rng.random((N1, 2)) * [800, 600]).astype(np.float32)
    kp2 = (kp1[src] + rng.normal(size=(N2, 2)) * 30).astype(np.float32)
    return d1, d2, m1, m2, kp1, kp2


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("shape,max_distance", [
    ((256, 256), None), ((256, 256), 60.0), ((200, 150), 60.0), ((150, 200), None),
])
def test_plain_matcher_equals_jax(rng, shape, max_distance):
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, *shape)
    mt, okt = t_match(*_t(d1, d2, m1, m2, kp1, kp2), ratio=0.9,
                      max_distance=max_distance)
    mj, okj = j_match(*_j(d1, d2, m1, m2, kp1, kp2), ratio=0.9,
                      max_distance=max_distance)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 40


@pytest.mark.parametrize("shape,max_distance", [
    ((256, 256), None), ((256, 256), 60.0), ((200, 150), 60.0),
])
def test_fused_matcher_equals_pallas(rng, interpret_pallas, shape, max_distance):
    pm = interpret_pallas
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, *shape)
    mt, okt = match_features(*_t(d1, d2, m1, m2, kp1, kp2), ratio=0.9,
                             max_distance=max_distance)
    mp, okp = pm.match_brute_force_pallas(*_j(d1, d2, m1, m2, kp1, kp2), ratio=0.9,
                                          max_distance=max_distance)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mp))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okp))
    # ... and equal to the plain matcher (the JAX tests assert the same).
    mx, _ = t_match(*_t(d1, d2, m1, m2, kp1, kp2), ratio=0.9, max_distance=max_distance)
    np.testing.assert_array_equal(mt.numpy(), mx.numpy())


def test_kernel_plain_version_equals_pallas_raw(rng, interpret_pallas):
    """The kernel's plain version yields the Pallas kernel's raw 2-NN
    statistics: indices exact, distances to 1e-5."""
    pm = interpret_pallas
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, 256, 256)
    ops = km.padded_operands(*_t(d1, d2, m1, m2, kp1, kp2), max_distance=60.0)
    got = km.match_raw_plain(*ops)
    rowpen, pen2 = ops[1].numpy(), ops[3].numpy()
    ref = pm._match_pallas_raw(*_j(d1, rowpen[:, None], d2, pen2[None, :], kp1, kp2), 60.0)
    for k in (0, 3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in (1, 2, 4, 5):
        g, r = got[k].numpy(), np.asarray(ref[k])
        real = r < 1e29
        np.testing.assert_allclose(g[real], r[real], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g[~real], r[~real])
