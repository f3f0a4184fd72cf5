"""Descriptor matching of the PyTorch port held against the JAX package.

Match indices must be exactly equal: against JAX `match_brute_force` (the
plain XLA version) for the port's plain `match_brute_force`, and against
the interpreted Pallas kernel for the port's fused path (`match_features`,
whose CPU branch is the plain version of CUDA kernel K1). Distances agree
to 1e-5 (f32 sums of 128 products in a different order).

The batched plain version (a slot axis, each side per slot or shared) is
held against jax.vmap of the interpreted Pallas kernel the same way, and
the batched matcher equals the single-pair matcher slot by slot.

The kernel itself runs only on a GPU: see tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.ops.matching import match_brute_force as j_match
from mavmap_tpu_torch.ops.cuda import match as km
from mavmap_tpu_torch.ops.matching import (match_brute_force as t_match, match_features,
                                           match_features_batched)

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


def test_kernel_plain_version_exact_ties_equal_pallas(rng, interpret_pallas):
    """Exact ties in both directions (a row of d1 copied into two columns
    of d2, a column of d2 copied into two rows of d1) go to the lower index
    in the kernel's plain version as in the Pallas kernel; the CUDA kernel
    is held to the plain version on the card (tests/test_torch_gpu.py)."""
    pm = interpret_pallas
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, 256, 256)
    m1[:] = True
    m2[:] = True
    for r, (a, b) in {100: (3, 70), 7: (5, 9)}.items():
        d2[a], d2[b], kp2[a], kp2[b] = d1[r], d1[r], kp1[r], kp1[r]
    for c, (a, b) in {40: (10, 200), 30: (17, 31)}.items():
        d1[a], d1[b], kp1[a], kp1[b] = d2[c], d2[c], kp2[c], kp2[c]
    ops = km.padded_operands(*_t(d1, d2, m1, m2, kp1, kp2), max_distance=60.0)
    got = km.match_raw_plain(*ops)
    rowpen, pen2 = ops[1].numpy(), ops[3].numpy()
    ref = pm._match_pallas_raw(*_j(d1, rowpen[:, None], d2, pen2[None, :], kp1, kp2), 60.0)
    for k in (0, 3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert int(got[0][100]) == 3 and int(got[0][7]) == 5
    assert int(got[3][40]) == 10 and int(got[3][30]) == 17


@pytest.mark.parametrize("D", [100, 128])
def test_padded_operands_pad_descriptors_to_the_kernel_stage(rng, D):
    """padded_operands pads rows and columns to 128 and the descriptor to a
    multiple of 32 dims with zeros: the plain version's 2-NN statistics on
    the padded operands equal those of the unpadded descriptors."""
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, 200, 150, D=D)
    ops = km.padded_operands(*_t(d1, d2, m1, m2, kp1, kp2), max_distance=60.0)
    assert ops[0].shape == (256, -(-D // 32) * 32) and ops[2].shape == (256, ops[0].shape[1])
    got = km.match_raw_plain(*ops)
    ref = km.match_raw_plain(torch.nn.functional.pad(torch.as_tensor(d1), (0, 0, 0, 56)),
                             ops[1],
                             torch.nn.functional.pad(torch.as_tensor(d2), (0, 0, 0, 106)),
                             ops[3], *ops[4:])
    for k in (0, 3):
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    for k in (1, 2, 4, 5):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-5)


def _slots(rng, B, shared1, ties):
    """B pairs of 256 x 200 descriptors; side 1 one image for every slot
    when shared1 (each slot's second image then derived from it); with
    ties, exact ties in both directions in every slot (only row ties when
    side 1 is shared)."""
    pairs = [list(_pair(rng, 256, 200)) for _ in range(B)]
    for b, p in enumerate(pairs):
        if shared1:
            p[0], p[2], p[4] = pairs[0][0], pairs[0][2], pairs[0][4]
            src = rng.integers(0, 256, 200)
            d2 = p[0][src] + rng.normal(size=(200, 128)).astype(np.float32) * 0.02
            p[1] = d2 / np.linalg.norm(d2, axis=1, keepdims=True)
            p[5] = (p[4][src] + rng.normal(size=(200, 2)) * 30).astype(np.float32)
        if ties:
            d1, d2, m1, m2, kp1, kp2 = p
            m1[:] = True
            m2[:] = True
            for r, (a, c) in {100: (3, 70), 7: (5 + b, 9 + b)}.items():
                d2[a], d2[c], kp2[a], kp2[c] = d1[r], d1[r], kp1[r], kp1[r]
            if not shared1:
                for c, (a, r) in {40: (10, 200), 30: (17, 31)}.items():
                    d1[a], d1[r], kp1[a], kp1[r] = d2[c], d2[c], kp2[c], kp2[c]
    return [pairs[0][i] if shared1 and i in (0, 2, 4) else np.stack([p[i] for p in pairs])
            for i in range(6)]


@pytest.mark.parametrize("shared1", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_batched_plain_version_equals_vmapped_pallas(rng, interpret_pallas, shared1, ties):
    """match_raw_batched_plain on 3 slots equals jax.vmap of the Pallas
    kernel's raw 2-NN statistics (side 1 shared: in_axes None): indices
    exact, distances to 1e-5, masked distances exact; exact ties to the
    lower index in both."""
    import functools
    import jax

    pm = interpret_pallas
    B = 3
    arrays = _slots(rng, B, shared1, ties)
    ops = km.padded_operands(*_t(*arrays), max_distance=60.0)
    got = km.match_raw_batched_plain(*ops)
    assert got[0].shape == (B, 256) and got[3].shape == (B, 256)
    rowpen, pen2 = ops[1].numpy(), ops[3].numpy()
    a1 = None if shared1 else 0
    raw = jax.vmap(functools.partial(pm._match_pallas_raw, max_distance=60.0),
                   in_axes=(a1, a1, 0, 0, a1, 0))
    ref = raw(*_j(ops[0].numpy(), rowpen[..., None], ops[2].numpy(), pen2[..., None, :],
                  ops[4].numpy(), ops[5].numpy()))
    for k in (0, 3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in (1, 2, 4, 5):
        g, r = got[k].numpy(), np.asarray(ref[k])
        real = r < 1e29
        np.testing.assert_allclose(g[real], r[real], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g[~real], r[~real])
    if ties:
        assert (got[0][:, 100] == 3).all()
        if not shared1:
            assert (got[3][:, 40] == 10).all() and (got[3][:, 30] == 17).all()


@pytest.mark.parametrize("shared", ["first", "second", "none"])
@pytest.mark.parametrize("max_distance", [None, 60.0])
def test_batched_matcher_equals_single_per_slot(rng, shared, max_distance):
    """match_features_batched equals match_features on every slot's pair,
    bit for bit (the plain version runs match_raw_plain slot by slot), with
    the first side, the second side or neither shared by the slots."""
    B = 4
    arrays = _slots(rng, B, shared != "none", False)
    if shared == "second":  # the slots' images first, against the one shared image
        arrays = [arrays[k] for k in (1, 0, 3, 2, 5, 4)]
    batched = [a.ndim == (3 if k in (0, 1, 4, 5) else 2) for k, a in enumerate(arrays)]
    mb, okb = match_features_batched(*_t(*arrays), ratio=0.9, max_distance=max_distance)
    assert mb.shape == (B, arrays[0].shape[-2]) and mb.dtype == torch.int32
    for b in range(B):
        one = [a[b] if bat else a for a, bat in zip(arrays, batched)]
        ms, oks = match_features(*_t(*one), ratio=0.9, max_distance=max_distance)
        np.testing.assert_array_equal(mb[b].numpy(), ms.numpy())
        np.testing.assert_array_equal(okb[b].numpy(), oks.numpy())
    assert int(okb.sum()) > 30 * B


@pytest.mark.parametrize("shared", ["first", "second", "none"])
@pytest.mark.parametrize("max_distance", [None, 60.0])
def test_xla_batched_matcher_equals_vmapped_jax(rng, shared, max_distance):
    """The 'xla' backend over a slot axis (the port's match_brute_force on
    (B, N, D) sides) equals jax.vmap of the JAX package's plain matcher,
    the shared side at in_axes None, exactly."""
    import jax

    B = 3
    arrays = _slots(rng, B, shared != "none", False)
    if shared == "second":
        arrays = [arrays[k] for k in (1, 0, 3, 2, 5, 4)]
    axes = tuple(0 if a.ndim == (3 if k in (0, 1, 4, 5) else 2) else None
                 for k, a in enumerate(arrays))
    mt, okt = match_features_batched(*_t(*arrays), ratio=0.9, max_distance=max_distance,
                                     backend="xla")
    mj, okj = jax.vmap(lambda *a: j_match(*a, ratio=0.9, max_distance=max_distance),
                       in_axes=axes)(*_j(*arrays))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert int(okt.sum()) > 30 * B


@pytest.mark.parametrize("max_distance", [None, 60.0])
def test_matcher_backends_agree(rng, max_distance):
    """The JAX package's backend names: 'auto' and 'pallas' run the fused
    path (K1's plain version on CPU tensors), 'xla' the plain matcher; all
    three match the same rows to the same columns, single and batched. An
    unknown name raises instead of falling back."""
    d1, d2, m1, m2, kp1, kp2 = _pair(rng, 200, 180)
    single = [match_features(*_t(d1, d2, m1, m2, kp1, kp2), ratio=0.9,
                             max_distance=max_distance, backend=b)
              for b in ("auto", "pallas", "xla")]
    for m, ok in single[1:]:
        np.testing.assert_array_equal(m.numpy(), single[0][0].numpy())
        np.testing.assert_array_equal(ok.numpy(), single[0][1].numpy())
    arrays = _slots(rng, 2, True, False)
    batched = [match_features_batched(*_t(*arrays), ratio=0.9, max_distance=max_distance,
                                      backend=b) for b in ("pallas", "xla")]
    np.testing.assert_array_equal(batched[0][0].numpy(), batched[1][0].numpy())
    for bad in ("cuda", "XLA", None):
        with pytest.raises(ValueError, match="matcher backend"):
            match_features(*_t(d1, d2), backend=bad)
