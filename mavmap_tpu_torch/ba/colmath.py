"""Column-arithmetic residuals, Jacobians, and block products for BA.

Port of mavmap_tpu/ba/colmath.py. Per-observation quantities are lists of
(O,) columns, as in the JAX package, so the two stay comparable term by
term; the cost model is that of reference bundle_adjustment.cc:289-387
(autodiff BACostFunction):

  - the rotation is expanded to its 9 Rodrigues component columns;
  - d(xc)/d(rvec) and the projection Jacobian come from torch.func.jvp with
    basis tangents (exact forward mode, all three camera models), the
    tangents batched with vmap;
  - the small matrix products (J^T W J blocks, couplings, matvec pieces)
    broadcast over (O, m, n) tensors. XLA fuses the JAX package's unrolled
    column loops into a few kernels; run eagerly, the same loops would
    launch one kernel per column operation (thousands per LM iteration).
    The broadcast forms do the same f32 operations in the same order.
"""

import torch
from torch.func import jvp, vmap

from ..models import camera as cam


def rodrigues_cols(r1, r2, r3, eps=1e-12):
    """Rotation matrix entries as 9 columns from rvec columns.

    R = cos(t) I + sinc(t) [r]_x + (1-cos t)/t^2 rr^T with Taylor guards.
    """
    t2 = r1 * r1 + r2 * r2 + r3 * r3
    t = torch.sqrt(torch.clamp(t2, min=eps * eps))
    small = t2 < 1e-8
    a = torch.cos(t)
    b = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    c = torch.where(small, 0.5 - t2 / 24.0, (1.0 - a) / torch.clamp(t2, min=eps))
    return [a + c * r1 * r1, c * r1 * r2 - b * r3, c * r1 * r3 + b * r2,
            c * r1 * r2 + b * r3, a + c * r2 * r2, c * r2 * r3 - b * r1,
            c * r1 * r3 - b * r2, c * r2 * r3 + b * r1, a + c * r3 * r3]


def _rotate_cols(rvec3, X3):
    """xc columns = R(rvec) X as elementwise column arithmetic."""
    R = rodrigues_cols(rvec3[0], rvec3[1], rvec3[2])
    x = R[0] * X3[0] + R[1] * X3[1] + R[2] * X3[2]
    y = R[3] * X3[0] + R[4] * X3[1] + R[5] * X3[2]
    z = R[6] * X3[0] + R[7] * X3[1] + R[8] * X3[2]
    return [x, y, z], R


def _world2image_multicode(xc, codes, params, eps=1e-12):
    """world2image with PER-OBSERVATION model codes: the three models
    evaluated elementwise and selected. xc (O, 3); codes (O,) int;
    params (O, 9). Returns (O, 2)."""
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    fx, fy = params[:, 0], params[:, 1]
    cx, cy = params[:, 2], params[:, 3]
    k1, k2 = params[:, 4], params[:, 5]
    p1, p2 = params[:, 6], params[:, 7]
    xi = params[:, 8]

    def safe(d):
        return torch.where(d.abs() < eps, torch.full_like(d, eps), d)

    zs = safe(z)
    u0, v0 = x / zs, y / zs

    def distort(u, v):
        r2 = u * u + v * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        dv = v * radial + 2.0 * p2 * u * v + p1 * (r2 + 2.0 * v * v)
        return u + du, v + dv

    u_cv, v_cv = distort(u0, v0)
    nrm = torch.sqrt(x * x + y * y + z * z)
    zz = safe(z + xi * nrm)
    u_ca, v_ca = distort(x / zz, y / zz)

    pin = codes == cam.PINHOLE
    ocv = codes == cam.OPENCV
    u = torch.where(pin, u0, torch.where(ocv, u_cv, u_ca))
    v = torch.where(pin, v0, torch.where(ocv, v_cv, v_ca))
    return torch.stack([fx * u + cx, fy * v + cy], dim=-1)


def _project(xc_cols, codes, params):
    return _world2image_multicode(torch.stack(xc_cols, dim=-1), codes, params)


def residual_cols(poses_o, X_o, cams_o, codes_o, uv_o):
    """Residual columns only (no Jacobians) — for cost evaluation."""
    rv = [poses_o[:, 0], poses_o[:, 1], poses_o[:, 2]]
    X3 = [X_o[:, 0], X_o[:, 1], X_o[:, 2]]
    xcR, _ = _rotate_cols(rv, X3)
    xc = [xcR[i] + poses_o[:, 3 + i] for i in range(3)]
    uv_pred = _project(xc, codes_o, cams_o)
    return [uv_pred[:, 0] - uv_o[:, 0], uv_pred[:, 1] - uv_o[:, 1]]


def _basis_jvps(f, primals):
    """Derivatives of f along each basis direction of `primals`, a tuple
    of same-shaped tensors: one jvp per direction, batched with vmap.
    Returns f's tangent output with a leading axis over the directions
    (primal index major, then the primal's trailing entries)."""
    shape = primals[0].shape
    n = len(primals) * (shape[-1] if len(shape) > 1 else 1)
    eye = torch.eye(n, dtype=primals[0].dtype, device=primals[0].device)
    ones = torch.ones_like(primals[0])

    def one(e):
        e = e.reshape((len(primals),) + shape[1:])
        return jvp(f, primals, tuple(ones * e[i] for i in range(len(primals))))[1]

    return vmap(one)(eye)


def residual_jacobian_cols(poses_o, X_o, cams_o, codes_o, uv_o,
                           with_intrinsics=False):
    """Per-observation residual + Jacobian columns.

    poses_o (O,6), X_o (O,3), cams_o (O,9), codes_o (O,), uv_o (O,2), all
    pre-gathered. Returns (r2, Jc, Jp[, Jk]): r2 = [ru, rv]; Jc 2x6, Jp 2x3
    and Jk 2x9 lists of columns.
    """
    rv = (poses_o[:, 0], poses_o[:, 1], poses_o[:, 2])
    tv = [poses_o[:, 3], poses_o[:, 4], poses_o[:, 5]]
    X3 = [X_o[:, 0], X_o[:, 1], X_o[:, 2]]

    xcR, R = _rotate_cols(list(rv), X3)
    xc = [xcR[i] + tv[i] for i in range(3)]

    def rotate(r1, r2, r3):
        return torch.stack(_rotate_cols([r1, r2, r3], X3)[0])

    dxc = _basis_jvps(rotate, rv)  # (3 rvec, 3 xc, O)
    A = [[dxc[j, i] for j in range(3)] for i in range(3)]  # A[i][j] = d xc_i / d rvec_j

    def project(c1, c2, c3):
        return _project([c1, c2, c3], codes_o, cams_o)

    uv_pred = project(*xc)
    duv = _basis_jvps(project, tuple(xc))  # (3 xc, O, 2)
    Jproj = [[duv[j, :, k] for j in range(3)] for k in range(2)]  # (2, 3)

    r2 = [uv_pred[:, 0] - uv_o[:, 0], uv_pred[:, 1] - uv_o[:, 1]]

    # Jc = [Jproj @ A | Jproj] (2 x 6); Jp = Jproj @ R (2 x 3).
    Jc = [[None] * 6 for _ in range(2)]
    Jp = [[None] * 3 for _ in range(2)]
    for k in range(2):
        for j in range(3):
            Jc[k][j] = (Jproj[k][0] * A[0][j] + Jproj[k][1] * A[1][j]
                        + Jproj[k][2] * A[2][j])
            Jc[k][3 + j] = Jproj[k][j]
            Jp[k][j] = (Jproj[k][0] * R[j] + Jproj[k][1] * R[3 + j]
                        + Jproj[k][2] * R[6 + j])

    if not with_intrinsics:
        return r2, Jc, Jp

    xcs = torch.stack(xc, dim=-1)
    duv = _basis_jvps(lambda kp: _world2image_multicode(xcs, codes_o, kp),
                      (cams_o,))  # (9 intrinsics, O, 2)
    Jk = [[duv[j, :, k] for j in range(9)] for k in range(2)]
    return r2, Jc, Jp, Jk


# --------------------------------------------------------- block products


def stack_cols(cols):
    """List of (O,) columns -> (O, K) array."""
    return torch.stack(cols, dim=-1)


def _rows(J):
    """2 x m list of (O,) columns -> the two (O, m) rows of J."""
    return torch.stack(J[0], dim=-1), torch.stack(J[1], dim=-1)


def _cols(t):
    """(O, ...) tensor -> list of its (O,) columns, row-major."""
    return list(t.reshape(t.shape[0], -1).unbind(-1))


def jtwj_cols(J1, J2, w):
    """Columns of J1^T diag(w) J2 summed over the 2 residual rows
    (J1: 2 x m, J2: 2 x n lists of columns -> m*n columns, row-major)."""
    a0, a1 = _rows(J1)
    b0, b1 = _rows(J2)
    return _cols(w[:, None, None] * (a0[:, :, None] * b0[:, None, :]
                                     + a1[:, :, None] * b1[:, None, :]))


def jtwr_cols(J, r2, w):
    """Columns of J^T diag(w) r (m entries)."""
    a0, a1 = _rows(J)
    return _cols(w[:, None] * (a0 * r2[0][:, None] + a1 * r2[1][:, None]))


def matmul_cols(Aflat, Bflat, m, k, n):
    """Row-major flat column lists: (m,k) @ (k,n) -> (m,n) flat columns."""
    A = stack_cols(Aflat).reshape(-1, m, k)
    B = stack_cols(Bflat).reshape(-1, k, n)
    acc = A[:, :, 0, None] * B[:, None, 0, :]
    for kk in range(1, k):
        acc = acc + A[:, :, kk, None] * B[:, None, kk, :]
    return _cols(acc)


def matvec_cols(Aflat, x, m, k):
    """(m,k) flat columns @ (k,) column list -> m columns."""
    A = stack_cols(Aflat).reshape(-1, m, k)
    acc = A[:, :, 0] * x[0][:, None]
    for kk in range(1, k):
        acc = acc + A[:, :, kk] * x[kk][:, None]
    return _cols(acc)


def matTvec_cols(Aflat, x, m, k):
    """(m,k)^T flat columns @ (m,) columns -> k columns."""
    A = stack_cols(Aflat).reshape(-1, m, k)
    acc = A[:, 0, :] * x[0][:, None]
    for i in range(1, m):
        acc = acc + A[:, i, :] * x[i][:, None]
    return _cols(acc)


def cols_of(arr):
    """(O, K) array -> list of K columns."""
    return [arr[:, i] for i in range(arr.shape[1])]


def inv3x3_cols(Vflat):
    """Closed-form inverse of flat 3x3 columns (list of 9 -> list of 9)."""
    a, b, c, d, e, f, g, h, i = Vflat
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    return [A * inv_det, B * inv_det, C * inv_det,
            D * inv_det, E * inv_det, F * inv_det,
            G * inv_det, H * inv_det, I * inv_det]
