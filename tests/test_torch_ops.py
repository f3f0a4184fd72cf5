"""Geometry operators of the PyTorch port held against the JAX package.

The same numpy inputs (made from a seed) go through each JAX function and
its mavmap_tpu_torch counterpart on the CPU. Tolerances:
  - camera, rotation, projection: 1e-5 relative — both run the same f32
    arithmetic, differing only in the order of a few roundings;
  - solvers (homography, P3P, 5-/8-point): compared up to sign and scale
    where an SVD is involved (LAPACK and XLA pick opposite singular-vector
    signs), at 1e-3 — f32 solves of normal equations and polynomial roots
    differ at ~eps * condition number, and the JAX package itself moves
    by that much between backends; triangulation at 1e-4;
  - RANSAC with JAX's `sample_indices` injected: equal inlier counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mavmap_tpu.models import camera as jcam
from mavmap_tpu.ops import essential as jess
from mavmap_tpu.ops import homography as jhom
from mavmap_tpu.ops import p3p as jp3p
from mavmap_tpu.ops import polynomial as jpoly
from mavmap_tpu.ops import projection as jproj
from mavmap_tpu.ops import rotation as jrot
from mavmap_tpu.ops import similarity as jsim
from mavmap_tpu.ops import triangulation as jtri
from mavmap_tpu.ops.matching import median_feature_disparity as j_median
from mavmap_tpu.ops.ransac import ransac as jransac, sample_indices

from mavmap_tpu_torch.models import camera as tcam
from mavmap_tpu_torch.ops import essential as tess
from mavmap_tpu_torch.ops import homography as thom
from mavmap_tpu_torch.ops import p3p as tp3p
from mavmap_tpu_torch.ops import polynomial as tpoly
from mavmap_tpu_torch.ops import projection as tproj
from mavmap_tpu_torch.ops import rotation as trot
from mavmap_tpu_torch.ops import similarity as tsim
from mavmap_tpu_torch.ops import triangulation as ttri
from mavmap_tpu_torch.ops.matching import median_feature_disparity as t_median
from mavmap_tpu_torch.ops.ransac import ransac as transac

torch.set_num_threads(2)
CPU = torch.device("cpu")
PINHOLE_PARAMS = [651.123, 655.123, 386.123, 511.123]
OPENCV_PARAMS = [651.123, 655.123, 386.123, 511.123, -0.171, 0.023, -0.001, 0.001]
CATA_PARAMS = OPENCV_PARAMS + [0.5]


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def J(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


def close(t, j, rtol=1e-5, atol=None):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    if atol is None:
        atol = rtol * max(float(np.abs(j).max()), 1e-6)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _rvecs(rng, n, scale=0.8):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


# ------------------------------------------------------------------ camera


@pytest.mark.parametrize("code,params", [
    (1, PINHOLE_PARAMS), (2, OPENCV_PARAMS), (3, CATA_PARAMS),
    (3, OPENCV_PARAMS + [0.0]), (3, OPENCV_PARAMS + [1.0]),
])
def test_camera_models_match_jax(code, params, rng):
    pj = jcam.pad_params(params)
    pt = tcam.pad_params(params, device=CPU)
    uv = (rng.random((300, 2)) * [780, 1000]).astype(np.float32)
    close(tcam.image2world(T(uv), code, pt), jcam.image2world(J(uv), code, pj))
    close(tcam.image2normalized(T(uv), code, pt),
          jcam.image2normalized(J(uv), code, pj))
    close(tcam.image2normalized_np(uv, code, np.asarray(pt)),
          jcam.image2normalized_np(uv, code, np.asarray(pj)))
    pts = (rng.normal(size=(300, 3)) * [0.3, 0.3, 0.1] + [0, 0, 1.0]).astype(np.float32)
    close(tcam.world2image(T(pts), code, pt), jcam.world2image(J(pts), code, pj))


def test_camera_model_names_match_jax():
    """camera_model_name inverts camera_model_code for every model, as the
    JAX package's does, and raises on an unknown code."""
    for code in jcam.CAMERA_MODEL_NAMES:
        assert tcam.camera_model_name(code) == jcam.camera_model_name(code)
        assert tcam.camera_model_code(tcam.camera_model_name(code)) == code
    assert tcam.camera_model_name(np.int64(2)) == "OPENCV"
    with pytest.raises(KeyError):
        tcam.camera_model_name(99)


def test_image2normalized_np_guards_zero_focal():
    """Deliberate divergence: a zero-padded camera row (f = 0) divides by
    1 in the port instead of producing inf/nan like the JAX version."""
    uv = np.array([[10.0, 20.0], [0.0, 0.0]], np.float32)
    p = np.zeros(9, np.float32)
    out = tcam.image2normalized_np(uv, tcam.PINHOLE, p)
    np.testing.assert_array_equal(out, uv)
    with np.errstate(divide="ignore", invalid="ignore"):
        ref = jcam.image2normalized_np(uv, jcam.PINHOLE, p)
    assert not np.isfinite(ref).all()


# ---------------------------------------------------------------- rotation


def test_rotation_conversions_match_jax(rng):
    rv = np.concatenate([_rvecs(rng, 200), np.zeros((1, 3), np.float32),
                         [[np.pi - 1e-3, 0, 0]], [[1e-7, -2e-7, 0]]]).astype(np.float32)
    Rt = trot.rotmat_from_rvec(T(rv))
    Rj = jrot.rotmat_from_rvec(J(rv))
    close(Rt, Rj)
    close(trot.rvec_from_rotmat(T(np.asarray(Rj))), jrot.rvec_from_rotmat(Rj), rtol=1e-4)
    close(trot.quat_from_rotmat(T(np.asarray(Rj))), jrot.quat_from_rotmat(Rj), rtol=1e-5)
    e = rng.normal(size=(3, 50)).astype(np.float32)
    close(trot.rotmat_from_euler(*T(e)), jrot.rotmat_from_euler(*J(e)))
    for a, b in zip(trot.euler_from_rotmat(Rt), jrot.euler_from_rotmat(Rj)):
        close(a, b, rtol=1e-4)
    pts = rng.normal(size=(200, 4, 3)).astype(np.float32)
    close(trot.rotate_points(T(rv[:200, None]), T(pts)), jrot.rotate_points(J(rv[:200, None]), J(pts)))


# -------------------------------------------------------------- projection


def test_projection_matches_jax(rng):
    rv = _rvecs(rng, 5, 0.2)
    tv = rng.normal(size=(5, 3)).astype(np.float32)
    Pt = tproj.compose_proj_matrix(T(rv), T(tv))
    Pj = jproj.compose_proj_matrix(J(rv), J(tv))
    close(Pt, Pj)
    close(tproj.invert_proj_matrix(Pt), jproj.invert_proj_matrix(Pj))
    close(tproj.camera_center(T(rv), T(tv)), jproj.camera_center(J(rv), J(tv)))
    X = (rng.normal(size=(5, 100, 3)) + [0, 0, 6]).astype(np.float32)
    x2 = rng.normal(size=(5, 100, 2)).astype(np.float32) * 0.1
    close(tproj.calc_depth(Pt, T(X)), jproj.calc_depth(Pj, J(X)))
    close(tproj.project_normalized(Pt, T(X)), jproj.project_normalized(Pj, J(X)))
    close(tproj.calc_reproj_errors(T(x2), T(X), Pt), jproj.calc_reproj_errors(J(x2), J(X), Pj))
    for a, b in zip(tproj.invert_pose(T(rv), T(tv)), jproj.invert_pose(J(rv), J(tv))):
        close(a, b, rtol=1e-4)


def test_world_pose_from_proj_matches_jax(rng):
    """The cam->world pose of a world->cam [R|t], batched and single, and
    at the identity: 1e-5 (rvec 1e-4, through the log map as above)."""
    rv = np.concatenate([_rvecs(rng, 6, 0.6), np.zeros((1, 3), np.float32)])
    tv = rng.normal(size=(7, 3)).astype(np.float32)
    Pt = tproj.compose_proj_matrix(T(rv), T(tv))
    Pj = jproj.compose_proj_matrix(J(rv), J(tv))
    for pt, pj in ((Pt, Pj), (Pt[2], Pj[2])):
        (rt, tt), (rj, tj) = tproj.world_pose_from_proj(pt), jproj.world_pose_from_proj(pj)
        close(rt, rj, rtol=1e-4)
        close(tt, tj)
    # Its pose composes back to the inverse of the projection.
    rt, tt = tproj.world_pose_from_proj(Pt)
    close(tproj.compose_proj_matrix(rt, tt), tproj.invert_proj_matrix(Pt), rtol=1e-4)


# --------------------------------------------------------------- polynomial


def test_polynomial_roots_match_jax(rng):
    c = rng.normal(size=(40, 11)).astype(np.float32)
    tr, ti = tpoly.roots_durand_kerner(T(c))
    jr, ji = jpoly.roots_durand_kerner(J(c))
    # Same real-pair iteration, compared as root SETS (each root of one
    # lies within 1e-3 of a root of the other).
    t_set = tr.numpy() + 1j * ti.numpy()
    j_set = np.asarray(jr) + 1j * np.asarray(ji)
    d = np.abs(t_set[:, :, None] - j_set[:, None, :])
    assert d.min(axis=2).max() < 1e-3 and d.min(axis=1).max() < 1e-3
    q = rng.normal(size=(200, 5)).astype(np.float32)
    (rt, mt), (rj, mj) = tpoly.solve_quartic_real(T(q)), jpoly.solve_quartic_real(J(q))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    close(torch.where(mt, rt, 0.0), np.where(mj, rj, 0.0), rtol=1e-4)
    close(tpoly.poly_eval(T(q), T(q[:, 0])), jpoly.poly_eval(J(q), J(q[:, 0])))


# ---------------------------------------------------------------- solvers


def _two_view(rng, n=60, noise=0.0):
    X = (rng.normal(size=(n, 3)) * [2, 2, 1] + [0, 0, 8]).astype(np.float64)
    R = np.asarray(jrot.rotmat_from_rvec(J([0.05, -0.1, 0.02])), np.float64)
    t = np.array([1.0, 0.1, 0.05])
    x1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(n, 2)) * noise
    return x1.astype(np.float32), x2.astype(np.float32), X.astype(np.float32), R, t


def _up_to_sign(a, b, tol):
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < tol


def test_homography_matches_jax(rng):
    src = rng.random((64, 4, 2)).astype(np.float32)
    dst = src + rng.normal(size=src.shape).astype(np.float32) * 0.05
    Ht, mt = thom.solve_homography(T(src), T(dst))
    Hj, mj = jax.vmap(jhom.solve_homography)(J(src), J(dst))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # Both solve the 8x8 normal equations in f32 (h33 = 1 fixes the
    # scale); their solutions differ at ~eps * cond, so they are compared
    # where cond < 1e4, at 1e-3.
    A = np.concatenate([
        np.stack([src[..., 0], src[..., 1], np.ones_like(src[..., 0]),
                  *([np.zeros_like(src[..., 0])] * 3),
                  -src[..., 0] * dst[..., 0], -src[..., 1] * dst[..., 0]], -1),
        np.stack([*([np.zeros_like(src[..., 0])] * 3), src[..., 0], src[..., 1],
                  np.ones_like(src[..., 0]),
                  -src[..., 0] * dst[..., 1], -src[..., 1] * dst[..., 1]], -1)], 1)
    cond = np.linalg.cond(np.einsum("tki,tkj->tij", A.astype(np.float64), A))
    good = cond < 1e4
    assert good.sum() >= 8
    for k in np.where(good)[0]:
        _up_to_sign(Ht[k, 0].numpy(), Hj[k, 0], 1e-3)
    pts = rng.random((50, 2)).astype(np.float32)
    close(thom.homography_residuals(T(pts), T(pts), Ht[good][:3, 0]),
          jax.vmap(lambda H: jhom.homography_residuals(J(pts), J(pts), H))(Hj[good][:3, 0]),
          rtol=1e-4)


def test_p3p_matches_jax(rng):
    x1, x2, X, R, t = _two_view(rng, n=4 * 32)
    s2 = x2.reshape(32, 4, 2)
    s3 = (X @ R.T.astype(np.float32) * 0 + X).reshape(32, 4, 3)
    Mt, vt = tp3p.solve_p3p(T(s2), T(s3))
    Mj, vj = jax.vmap(jp3p.solve_p3p)(J(s2), J(s3))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    v = np.asarray(vj)
    # 1e-3: the f32 quartic roots (Newton-polished) carry ~1e-4 relative
    # error in both packages, and the rigid fit amplifies it.
    close(Mt.numpy()[v], np.asarray(Mj)[v], rtol=1e-3)
    Bt, bt = tp3p.solve_p3p_best(T(s2), T(s3))
    Bj, bj = jax.vmap(jp3p.solve_p3p_best)(J(s2), J(s3))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    close(Bt.numpy()[bt.numpy()], np.asarray(Bj)[np.asarray(bj)], rtol=1e-3)
    # The pose that generated the data is among the solutions.
    truth = np.concatenate([R, t[:, None]], axis=1)
    assert np.abs(Bt.numpy()[0, 0] - truth).max() < 1e-3


def test_essential_solvers_match_jax(rng):
    x1, x2, _, R, t = _two_view(rng, n=5 * 16)
    p1, p2 = x1.reshape(16, 5, 2), x2.reshape(16, 5, 2)
    Et, mt = tess.solve_essential_5pt(T(p1), T(p2))
    Ej, mj = jax.vmap(jess.solve_essential_5pt)(J(p1), J(p2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = tx @ R
    En = E_true / np.linalg.norm(E_true)

    def best(E, m):
        err = [min(np.abs(e / np.linalg.norm(e) - En).max(),
                   np.abs(e / np.linalg.norm(e) + En).max()) if ok else np.inf
               for e, ok in zip(np.asarray(E), np.asarray(m))]
        return int(np.argmin(err)), min(err)

    # The f32 resultant occasionally loses the true root of a sample in
    # either package (on different samples: rounding differs); RANSAC
    # absorbs that. Where both recover the true E (up to sign and scale),
    # they agree on it.
    both = 0
    for k in range(16):
        it, et = best(Et[k].numpy(), mt[k].numpy())
        ij, ej = best(Ej[k], mj[k])
        if et < 1e-3 and ej < 1e-3:
            both += 1
            _up_to_sign(Et[k, it].numpy(), Ej[k, ij], 2e-3)
    assert both >= 13
    w = (rng.random(80) > 0.2).astype(np.float32)
    E8t, _ = tess.solve_essential_8pt(T(x1), T(x2), weights=T(w))
    E8j, _ = jess.solve_essential_8pt(J(x1), J(x2), weights=J(w))
    _up_to_sign(E8t[0].numpy(), E8j[0], 1e-3)
    close(tess.abs_sampson_residuals(T(x1), T(x2), T(E_true)),
          jess.abs_sampson_residuals(J(x1), J(x2), J(E_true)), rtol=1e-4, atol=1e-6)
    Rt_, tt_, nt_ = tess.pose_from_essential_matrix(E8t[0], T(x1), T(x2), T(w > 0, torch.bool))
    Rj_, tj_, nj_ = jess.pose_from_essential_matrix(E8j[0], J(x1), J(x2), J(w > 0, bool))
    assert int(nt_) == int(nj_)
    close(Rt_, Rj_, rtol=1e-3)
    _up_to_sign(tt_.numpy(), tj_, 1e-3)


@pytest.mark.parametrize("imag_tol", [1e-2, 1e-6, 10.0])
def test_essential_5pt_accepts_imag_tol_like_jax(rng, imag_tol):
    """imag_tol is accepted and changes nothing, in either package: the JAX
    function deletes the real-root mask it makes from it
    (mavmap_tpu/ops/essential.py:394). Models and masks equal the call
    without it, bit for bit, on both sides."""
    x1, x2, _, _, _ = _two_view(rng, n=5 * 8)
    p1, p2 = x1.reshape(8, 5, 2), x2.reshape(8, 5, 2)
    Et, mt = tess.solve_essential_5pt(T(p1), T(p2), imag_tol=imag_tol)
    E0, m0 = tess.solve_essential_5pt(T(p1), T(p2))
    np.testing.assert_array_equal(Et.numpy(), E0.numpy())
    np.testing.assert_array_equal(mt.numpy(), m0.numpy())
    Ej, mj = jax.vmap(lambda a, b: jess.solve_essential_5pt(a, b, imag_tol=imag_tol))(
        J(p1), J(p2))
    Ej0, mj0 = jax.vmap(jess.solve_essential_5pt)(J(p1), J(p2))
    np.testing.assert_array_equal(np.asarray(Ej), np.asarray(Ej0))
    np.testing.assert_array_equal(np.asarray(mj), np.asarray(mj0))


def test_essential_8pt_refit_solves_in_f64(rng):
    """Deliberate divergence: the 8-point refit's smallest eigenvector of
    D^T D is taken in f64 (the JAX package takes it in f32). On a nadir
    pair (500 points at ~30 m, 2.5 m baseline, 0.3 px noise) the f32 normal
    matrix is off by up to 1e-2 of E on the CPU, and on an H100 it turned
    the recovered translation by 4 degrees; f64 agrees with an SVD of D in
    numpy f64 to 1e-6."""
    N = 500
    X = np.stack([rng.uniform(-12, 12, N), rng.uniform(-9, 9, N),
                  30 + rng.normal(size=N) * 2], 1)
    R = np.asarray(jrot.rotmat_from_rvec(jnp.asarray([0.01, -0.02, 0.005])), np.float64)
    Xc = X @ R.T + np.array([-2.5, 0.1, 0.05])
    x1 = (X[:, :2] / X[:, 2:] + rng.normal(size=(N, 2)) * 0.3 / 700).astype(np.float32)
    x2 = (Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(N, 2)) * 0.3 / 700).astype(np.float32)
    a, b = x1.astype(np.float64), x2.astype(np.float64)
    D = np.stack([b[:, 0] * a[:, 0], b[:, 0] * a[:, 1], b[:, 0], b[:, 1] * a[:, 0],
                  b[:, 1] * a[:, 1], b[:, 1], a[:, 0], a[:, 1], np.ones(N)], 1)
    U, sv, Vt = np.linalg.svd(np.linalg.svd(D)[2][-1].reshape(3, 3))
    E_ref = U @ np.diag([(sv[0] + sv[1]) / 2] * 2 + [0.0]) @ Vt
    E, ok = tess.solve_essential_8pt(T(x1), T(x2))
    assert E.dtype == torch.float32 and bool(ok[0])
    _up_to_sign(E[0].numpy(), E_ref / np.linalg.norm(E_ref), 1e-6)


def test_essential_solvers_mask_non_finite_samples_like_jax(rng):
    """A RANSAC sample with a non-finite coordinate (or one whose resultant
    diverges) yields no candidate, as XLA's SVD yields NaNs there; torch's
    would raise. The other samples of the batch are untouched, and a
    non-finite E decomposes to NaNs instead of raising."""
    x1, x2, _, _, _ = _two_view(rng, n=5 * 4)
    p1, p2 = x1.reshape(4, 5, 2).copy(), x2.reshape(4, 5, 2).copy()
    p1[1, 2, 0] = np.nan
    p2[3, 0, 1] = np.nan
    Ej, mj = jax.vmap(jess.solve_essential_5pt)(J(p1), J(p2))
    p2[3, 0, 1] = np.inf  # XLA's SVD does not return on an infinite entry
    Et, mt = tess.solve_essential_5pt(T(p1), T(p2))
    assert not bool(mt[1].any()) and not bool(mt[3].any())
    assert not np.asarray(mj[1]).any() and not np.asarray(mj[3]).any()
    assert bool(mt[0].any()) and bool(mt[2].any())
    clean, _ = tess.solve_essential_5pt(T(p1[[0, 2]]), T(p2[[0, 2]]))
    assert torch.equal(Et[[0, 2]], clean)
    R1, R2, t = tess.decompose_essential_matrix(torch.full((3, 3), float("nan")))
    assert torch.isnan(R1).all() and torch.isnan(t).all()


def test_triangulation_matches_jax(rng):
    x1, x2, X, R, t = _two_view(rng, n=100, noise=1e-3)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2 = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    Xt = ttri.triangulate_points(T(P1), T(P2), T(x1), T(x2))
    Xj = jtri.triangulate_points(J(P1), J(P2), J(x1), J(x2))
    close(Xt, Xj, rtol=1e-4)
    close(ttri.calc_tri_angles(T(P1), T(P2), Xt), jtri.calc_tri_angles(J(P1), J(P2), Xj),
          rtol=1e-4)
    # The N-view DLT of one track (the control points' triangulation), a
    # view masked out.
    P3 = np.concatenate([R.T, (-R.T @ t)[:, None]], 1).astype(np.float32)
    x3 = X[:1] @ R + (-R.T @ t)
    x3 = (x3[:, :2] / x3[:, 2:]).astype(np.float32)
    projs, pts = np.stack([P1, P2, P3]), np.stack([x1[0], x2[0], x3[0] + 0.5])
    mask = np.array([True, True, False])
    Vt = ttri.triangulate_points_multiview(T(projs), T(pts), T(mask, torch.bool))
    Vj = jtri.triangulate_points_multiview(J(projs), J(pts), J(mask, bool))
    close(Vt, Vj, rtol=1e-4)


def test_similarity_matches_jax(rng):
    src = rng.normal(size=(40, 3)).astype(np.float32)
    dst = (2.0 * src @ np.asarray(jrot.rotmat_from_rvec(J([0.3, -0.2, 0.1]))).T
           + [1, 2, 3]).astype(np.float32)
    Tt = tsim.solve_umeyama(T(src), T(dst))
    Tj = jsim.solve_umeyama(J(src), J(dst))
    close(Tt, Tj, rtol=1e-4)
    close(tsim.transform_points(Tt, T(src)), jsim.transform_points(Tj, J(src)), rtol=1e-4)
    close(tsim.similarity_scale(Tt), jsim.similarity_scale(Tj), rtol=1e-5)


# ------------------------------------------------------------------ RANSAC


def test_ransac_with_injected_samples_matches_jax(rng):
    x1, x2, _, _, _ = _two_view(rng, n=200, noise=1e-3)
    out = rng.random(200) < 0.3
    x2 = np.where(out[:, None], rng.random((200, 2)).astype(np.float32) - 0.5, x2)
    valid = rng.random(200) > 0.1
    key = jax.random.PRNGKey(3)
    idx = np.asarray(sample_indices(key, 64, 5, 200, J(valid, bool)))
    rj = jransac(key, J(x1), J(x2), jess.solve_essential_5pt, jess.abs_sampson_residuals,
                 sample_size=5, num_trials=64, threshold=2e-3, valid_mask=J(valid, bool))
    rt = transac(None, T(x1), T(x2), tess.solve_essential_5pt, tess.abs_sampson_residuals,
                 sample_size=5, num_trials=64, threshold=2e-3,
                 valid_mask=T(valid, torch.bool), samples=idx)
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert bool(rt.success) == bool(rj.success)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask))
    _up_to_sign(rt.model.numpy(), rj.model, 1e-3)


def test_ransac_samples_from_generator_respect_mask():
    from mavmap_tpu_torch.ops.ransac import sample_indices as t_sample

    g = torch.Generator().manual_seed(0)
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 11, 19, 23, 42]] = True
    idx = t_sample(g, 100, 4, 50, valid)
    assert idx.shape == (100, 4)
    assert valid[idx].all()
    assert all(len(set(row.tolist())) == 4 for row in idx)


def test_median_disparity_matches_jax(rng):
    kp1 = (rng.random((64, 2)) * 500).astype(np.float32)
    kp2 = (rng.random((64, 2)) * 500).astype(np.float32)
    m = rng.integers(-1, 64, 64).astype(np.int32)
    for valid in (m >= 0, np.zeros(64, bool)):
        close(t_median(T(kp1), T(kp2), T(m, torch.int32), T(valid, torch.bool)),
              j_median(J(kp1), J(kp2), J(m, jnp.int32), J(valid, bool)))
