"""Batched 5-point essential-matrix solver + pose recovery.

Port of mavmap_tpu/ops/essential.py (reference
src/base3d/essential_matrix.{h,cc}), batched over a leading trial axis:

  1. nullspace of the 5x9 epipolar constraint matrix -> E = xE1+yE2+zE3+E4;
  2. the 10 cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0)
     assembled numerically from monomial multiplication tables;
  3. Nister's Gauss-Jordan elimination to three equations B(z) [x, y, 1]^T
     = 0 and det B(z), an exact degree-10 polynomial by convolution;
  4. roots by Durand-Kerner (ops/polynomial.py);
  5. (x, y) per root from the nullvector of the hidden-variable matrix
     A(z), then a Gauss-Newton polish on the original cubic system.

Residual: first-order Sampson distance, signed like the reference
(essential_matrix.cc:131-162); callers threshold its absolute value.
"""

import numpy as np
import torch

from ..utils.timer import sync
from .reduce import det3, matmul_ordered, one_by_one, sum_pairwise

# ----------------------------------------------------------------------------
# Static monomial tables (numpy, built at import time).
# Monomials are exponent triples (ex, ey, ez) over (x, y, z), w = 1.
# ----------------------------------------------------------------------------


def _monomials_upto(deg):
    out = []
    for total in range(deg, -1, -1):
        for ex in range(total, -1, -1):
            for ey in range(total - ex, -1, -1):
                out.append((ex, ey, total - ex - ey))
    return out


_M1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_M2 = _monomials_upto(2)  # 10 monomials
_M3 = _monomials_upto(3)  # 20 monomials
_M3_IDX = {m: i for i, m in enumerate(_M3)}


def _mul_table(basis_a, basis_b, basis_out):
    idx_out = {m: i for i, m in enumerate(basis_out)}
    T = np.zeros((len(basis_a), len(basis_b), len(basis_out)), np.float32)
    for i, a in enumerate(basis_a):
        for j, b in enumerate(basis_b):
            T[i, j, idx_out[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]] = 1.0
    return T


_T11_2 = _mul_table(_M1, _M1, _M2)  # (4, 4, 10)
_T21_3 = _mul_table(_M2, _M1, _M3)  # (10, 4, 20)

# Nister elimination layout: 10 "high" ((x,y)-degree >= 2) and 10 "low"
# deg-3 monomials.
_HIGH = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0),
    (2, 0, 1), (2, 0, 0), (0, 2, 1), (0, 2, 0),
    (1, 1, 1), (1, 1, 0),
]
_LOW = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0),
    (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_HIGH_IDX = [_M3_IDX[m] for m in _HIGH]
_LOW_IDX = [_M3_IDX[m] for m in _LOW]
# Rows of the reduced system for B(z): e = x^2 z, f = x^2, g = y^2 z,
# h = y^2, i = xyz, j = xy (indices in _HIGH).
_ROW_E, _ROW_F, _ROW_G, _ROW_H, _ROW_I, _ROW_J = 4, 5, 6, 7, 8, 9

# Hidden-variable layout: columns of A(z) are the (x, y) monomials.
_XY_COLS = [
    (3, 0), (2, 1), (1, 2), (0, 3),
    (2, 0), (1, 1), (0, 2),
    (1, 0), (0, 1), (0, 0),
]
_XY_IDX = {c: i for i, c in enumerate(_XY_COLS)}
# A(z)'s coefficient of z^k at (row e, column c) is eq[e, _AZ_IDX[k, c]]
# (20: no monomial, a zero appended).
_AZ_IDX = np.full((4, 10), 20, np.int64)
for _i, (_ex, _ey, _ez) in enumerate(_M3):
    _AZ_IDX[_ez, _XY_IDX[(_ex, _ey)]] = _i

# Exponent table of the 20 deg-3 monomials for the Gauss-Newton polish.
_M3_EXP = np.array(_M3, np.float32)  # (20, 3)


def _gather_index(T):
    """A 0/1 product table T (I, J, M), each (i, j) in at most one m, as
    (M, S) indices into the I*J products a_i b_j (flattened), each m's in
    ascending order, padded with I*J (a zero appended after the products)."""
    I, J, M = T.shape
    rows = [[i * J + j for i in range(I) for j in range(J) if T[i, j, m]] for m in range(M)]
    S = max(len(r) for r in rows)
    return np.array([r + [I * J] * (S - len(r)) for r in rows], np.int64)


_T11_IDX = _gather_index(_T11_2)  # (10, 2)
_T21_IDX = _gather_index(_T21_3)  # (20, 3)

_TABLE_CACHE = {}


def _table(name, ref):
    """Device copy of a static numpy table (made once per device/dtype;
    index tables stay int64)."""
    table = globals()[name]
    dtype = torch.int64 if table.dtype == np.int64 else ref.dtype
    key = (name, ref.device, dtype)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = torch.as_tensor(table, dtype=dtype, device=ref.device)
    return _TABLE_CACHE[key]


def _with_zero(x):
    """x with a zero appended along its last axis (the index tables' pad)."""
    return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)


def _table_product(a, b, name):
    """sum_ij a[..., i] b[..., j] T[i, j, m] for the 0/1 product table
    whose gather index is `name` (_T11_IDX, _T21_IDX): each m's products
    added in a fixed order. As an einsum the contraction is a batched GEMM,
    and on the card cuBLAS picks its kernel by the batch, so a trial's bits
    would depend on how many trials share the call (ops/reduce.py)."""
    idx = _table(name, a)
    prods = _with_zero((a[..., :, None] * b[..., None, :]).flatten(-2))[..., idx]
    out = prods[..., 0]
    for k in range(1, idx.shape[1]):
        out = out + prods[..., k]
    return out


# ----------------------------------------------------------------------------
# Solver
# ----------------------------------------------------------------------------


def _epipolar_design(points1, points2):
    """(..., N, 2) x2 -> (..., N, 9) rows of x2^T E x1 = 0 (E row-major)."""
    x1 = torch.cat([points1, torch.ones_like(points1[..., :1])], dim=-1)
    x2 = torch.cat([points2, torch.ones_like(points2[..., :1])], dim=-1)
    return (x2[..., :, None] * x1[..., None, :]).reshape(points1.shape[:-1] + (9,))


def _build_constraints(C):
    """C: (T, 3, 3, 4) linear-form coeffs of E entries -> (T, 10, 20) cubic
    coeffs of [det(E); 2 E E^T E - tr(E E^T) E], every product and sum in
    an order fixed by one trial's shapes (_table_product)."""
    T = C.shape[0]
    Ce = C.reshape(T, 9, 4)
    Q = _table_product(Ce[:, :, None], Ce[:, None], "_T11_IDX")  # (T, 9, 9, 10): C_e C_f
    tr = sum_pairwise(Q.diagonal(dim1=1, dim2=2), dim=-1)        # (T, 10)
    # EEt[i][l] = sum_k C[i][k] C[l][k]: (T, i, l, 10, k).
    eet = Q.reshape(T, 3, 3, 3, 3, 10).diagonal(dim1=2, dim2=4)
    eet = eet[..., 0] + eet[..., 1] + eet[..., 2]                 # (T, 3, 3, 10)
    minors = torch.stack([Q[:, 4, 8] - Q[:, 5, 7], Q[:, 3, 8] - Q[:, 5, 6],
                          Q[:, 3, 7] - Q[:, 4, 6]], dim=1)        # (T, 3, 10)
    d = _table_product(minors, C[:, 0], "_T21_IDX")               # (T, 3, 20)
    det = d[:, 0] - d[:, 1] + d[:, 2]
    # sum_l EEt[i][l] C[l][j]: (T, i, l, j, 20) summed over l in order.
    r = _table_product(eet[:, :, :, None], C[:, None], "_T21_IDX")
    acc = r[:, :, 0] + r[:, :, 1] + r[:, :, 2]                    # (T, 3, 3, 20)
    trc = _table_product(tr[:, None, None], C, "_T21_IDX")       # (T, 3, 3, 20)
    return torch.cat([det[:, None], (2.0 * acc - trc).reshape(T, 9, 20)], dim=1)


def _monomials3(x, y, z):
    """(...,) x, y, z -> (..., 20) monomial vector over _M3 (0^0 = 1)."""
    e = _table("_M3_EXP", x)
    v = torch.stack([x, y, z], dim=-1)[..., None, :]  # (..., 1, 3)
    base = torch.where(e == 0, torch.ones_like(v * e), v ** e)
    return base[..., 0] * base[..., 1] * base[..., 2]


def _monomials3_jac(x, y, z):
    """d(monomials)/d(x,y,z): (..., 20, 3)."""
    e = _table("_M3_EXP", x)
    v = torch.stack([x, y, z], dim=-1)[..., None, :]
    cols = []
    for k in range(3):
        ek = e.clone()
        ek[:, k] -= 1.0
        ek = torch.clamp(ek, min=0.0)
        base = torch.where(ek == 0, torch.ones_like(v * ek), v ** ek)
        cols.append(e[:, k] * (base[..., 0] * base[..., 1] * base[..., 2]))
    return torch.stack(cols, dim=-1)


def _polish_xyz(eq, x, y, z, num_iters=3, damping=1e-10):
    """Gauss-Newton refinement of candidate roots on the 10 cubic
    constraints; eq (T, 10, 20), x/y/z (T, R). The products are summed in
    a fixed order (sum_pairwise), not by batched matmuls, whose bits on
    the card depend on the number of trials."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    eqb = eq[:, None]  # (T, 1, 10, 20)
    for _ in range(num_iters):
        F = sum_pairwise(eqb * _monomials3(x, y, z)[..., None, :], dim=-1)      # (T, R, 10)
        J = sum_pairwise(eqb[..., None] * _monomials3_jac(x, y, z)[..., None, :, :],
                         dim=-2)                                                  # (T, R, 10, 3)
        JtJ = sum_pairwise(J[..., :, None] * J[..., None, :], dim=-3) + damping * eye
        JtF = sum_pairwise(J * F[..., None], dim=-2)[..., None]
        delta = solve_or_nan(JtJ, JtF)[..., 0]
        x, y, z = x - delta[..., 0], y - delta[..., 1], z - delta[..., 2]
    return x, y, z


def solve_or_nan(A, B):
    """Batched solve; NaN where A is singular (XLA's behavior — linalg.solve
    would raise)."""
    X, info = torch.linalg.solve_ex(A, B)
    bad = (info != 0).reshape(info.shape + (1,) * (X.dim() - info.dim()))
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def inv_or_nan(A):
    """Batched inverse; NaN where A is singular (XLA's behavior — linalg.inv
    would raise)."""
    X, info = torch.linalg.inv_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def _svd_or_nan(A, full_matrices=True, per_matrix=False):
    """Batched SVD; NaN factors where a matrix holds a non-finite entry
    (XLA's behavior — torch.linalg.svd would raise). Degenerate RANSAC
    samples give such matrices; their candidates are masked out after.
    per_matrix: one matrix per call (reduce.one_by_one), for the per-slot
    matrices of a batched step."""
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    A = torch.where(finite[..., None, None], A, torch.zeros_like(A))
    # On the card each torch.linalg.svd call syncs the host twice.
    if per_matrix:
        U, S, Vh = one_by_one(lambda m: torch.linalg.svd(m, full_matrices=full_matrices), A)
        sync(2 * max(finite.numel(), 1))
    else:
        U, S, Vh = torch.linalg.svd(A, full_matrices=full_matrices)
        sync(2)

    def nan_where_bad(X, k):
        keep = finite.reshape(finite.shape + (1,) * k)
        return torch.where(keep, X, torch.full_like(X, float("nan")))

    return nan_where_bad(U, 2), nan_where_bad(S, 1), nan_where_bad(Vh, 2)


def _conv(p, q):
    """Product of two ascending-coefficient polynomials given as lists of
    (T,) coefficient tensors."""
    out = [None] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] = a * b if out[i + j] is None else out[i + j] + a * b
    return out


def solve_essential_5pt(points1, points2, num_dk_iters=60, imag_tol=1e-2):
    """5-point minimal solver, batched: points1/2 (T, S>=5, 2) normalized.

    Returns (models (T, 10, 3, 3), mask (T, 10)): up to 10 candidates with
    x2^T E x1 = 0 and unit Frobenius norm, masked where non-finite.
    `imag_tol` is accepted and unused: the JAX version computes a
    real-root mask from it and deletes it unread
    (mavmap_tpu/ops/essential.py:394), keeping every candidate for the
    polish and RANSAC's scoring, as this one does.
    """
    from .polynomial import roots_durand_kerner

    T = points1.shape[0]
    D = _epipolar_design(points1, points2)  # (T, S, 9)
    _, _, Vt = _svd_or_nan(D, full_matrices=True)
    basis = Vt[:, -4:].reshape(T, 4, 3, 3)  # E1..E4
    C = basis.permute(0, 2, 3, 1)           # (T, 3, 3, 4)

    eq = _build_constraints(C)              # (T, 10, 20)
    A1 = eq[:, :, _HIGH_IDX]
    A2 = eq[:, :, _LOW_IDX]
    sync(2)  # each list index is copied to the device
    X = solve_or_nan(A1, A2)               # high_i + X[i] . low = 0

    def row_polys(i):
        r = X[:, i]
        return ([r[:, 2], r[:, 1], r[:, 0]],
                [r[:, 5], r[:, 4], r[:, 3]],
                [r[:, 9], r[:, 8], r[:, 7], r[:, 6]])

    zero = torch.zeros_like(X[:, 0, 0])

    def sub_shift(p, q, n):
        """pad(p, n) - z q  (ascending coefficient lists)."""
        p = p + [zero] * (n - len(p))
        qs = [zero] + q
        qs = qs + [zero] * (n - len(qs))
        return [p[k] - qs[k] for k in range(n)]

    B = []
    for re1, re2 in ((_ROW_E, _ROW_F), (_ROW_G, _ROW_H), (_ROW_I, _ROW_J)):
        (pa, pb, pc), (qa, qb, qc) = row_polys(re1), row_polys(re2)
        B.append((sub_shift(pa, qa, 4), sub_shift(pb, qb, 4), sub_shift(pc, qc, 5)))
    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = B

    def sub(p, q):
        return [p[k] - q[k] for k in range(len(p))]

    p1 = sub(_conv(b2, c3), _conv(b3, c2))   # 8 coeffs
    p2 = sub(_conv(a3, c2), _conv(a2, c3))
    p3 = sub(_conv(a2, b3), _conv(a3, b2))   # 7 coeffs
    t1 = _conv(a1, p1)[:11]
    t2 = _conv(b1, p2)[:11]
    t3 = _conv(c1, p3)
    t3 = t3 + [zero] * (11 - len(t3))
    det_coeffs = torch.stack([t1[k] + t2[k] + t3[k] for k in range(11)], dim=-1)

    roots_re, _ = roots_durand_kerner(det_coeffs, num_iters=num_dk_iters)
    z = roots_re  # (T, 10)

    # (x, y) per root from the nullvector of A(z) over the (x, y) monomials,
    # by degree-consistent ratio least squares (JAX essential.py:365-389).
    # A(z) = sum_k z^k Az[k], Az[k] gathered from eq, added in order of k.
    Az = _with_zero(eq)[:, :, _table("_AZ_IDX", eq)].transpose(1, 2)  # (T, 4, 10, 10)
    zpow = torch.stack([torch.ones_like(z), z, z * z, z * z * z], dim=-1)
    A = zpow[..., 0, None, None] * Az[:, None, 0]
    for k in range(1, 4):
        A = A + zpow[..., k, None, None] * Az[:, None, k]  # (T, 10 roots, 10, 10)
    _, _, VtA = _svd_or_nan(A)
    m = VtA[..., -1, :]  # (T, 10, 10)

    x_den = torch.stack([m[..., 4], m[..., 7], m[..., 5], m[..., 8], m[..., 6]], dim=-1)
    x_num = torch.stack([m[..., 0], m[..., 4], m[..., 1], m[..., 5], m[..., 2]], dim=-1)
    x = sum_pairwise(x_num * x_den) / torch.clamp(sum_pairwise(x_den * x_den), min=1e-20)
    y_den = torch.stack([m[..., 6], m[..., 8], m[..., 5], m[..., 7], m[..., 4]], dim=-1)
    y_num = torch.stack([m[..., 3], m[..., 6], m[..., 2], m[..., 5], m[..., 1]], dim=-1)
    y = sum_pairwise(y_num * y_den) / torch.clamp(sum_pairwise(y_den * y_den), min=1e-20)

    ok = torch.isfinite(x) & torch.isfinite(y)
    x, y, z = _polish_xyz(eq, x, y, z, num_iters=8)
    ok = ok & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)

    E = (x[..., None, None] * basis[:, None, 0] + y[..., None, None] * basis[:, None, 1]
         + z[..., None, None] * basis[:, None, 2] + basis[:, None, 3])
    norm = torch.sqrt(sum_pairwise(E.reshape(T, 10, 9) ** 2))
    E = E / torch.clamp(norm, min=1e-20)[..., None, None]
    ok = ok & torch.isfinite(E).all(dim=-1).all(dim=-1)
    return E, ok


def solve_essential_8pt(points1, points2, weights=None):
    """Linear 8-point solver with rank-2 projection, for non-minimal inlier
    refits (`weights` masks constraint rows), over leading slot dims:
    points (..., N, 2), weights (..., N). Returns ((..., 1, 3, 3),
    (..., 1)).

    The normal matrix D^T D squares the condition number of D, and its
    smallest eigenvector in f32 is off by eps * cond(D)^2: on an H100
    (cuSOLVER) that turned the two-view translation of a nadir survey's
    first pair by 4 degrees. So the solve runs in f64 and returns the
    input's dtype. Deliberate divergence from the JAX package, which
    solves in f32 (mavmap_tpu/ops/essential.py solve_essential_8pt)."""
    D = _epipolar_design(points1.double(), points2.double())
    if weights is not None:
        D = D * weights.double()[..., None]
    # D^T D summed over the rows in a fixed order, and its eigenvectors and
    # E's SVD one slot at a time: a batched matmul's and a batched Jacobi
    # solver's bits depend on the batch on the card (ops/reduce.py).
    _, V = one_by_one(torch.linalg.eigh,
                      sum_pairwise(D[..., :, :, None] * D[..., :, None, :], dim=-3))
    sync(max(V[..., 0, 0].numel(), 1))  # one per torch.linalg.eigh call
    E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, s, Vt = _svd_or_nan(E, per_matrix=True)
    sbar = (s[..., 0] + s[..., 1]) / 2.0
    S = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    E = matmul_ordered(U * S[..., None, :], Vt)
    norm = torch.linalg.norm(E.flatten(-2), dim=-1)
    E = (E / torch.clamp(norm, min=1e-20)[..., None, None]).to(points1.dtype)
    return E[..., None, :, :], torch.isfinite(E).all(dim=-1).all(dim=-1)[..., None]


def sampson_residuals(points1, points2, E):
    """Signed first-order Sampson distance per correspondence: points
    (..., N, 2), E (..., 3, 3) -> (..., N), leading dims broadcast
    (reference essential_matrix.cc:131-162)."""
    u1, v1 = points1[..., 0], points1[..., 1]
    u2, v2 = points2[..., 0], points2[..., 1]

    def e(i, j):
        return E[..., i, j, None]

    # E x1 and E^T x2 entry by entry, in a fixed order (a batched matmul's
    # bits depend on the batch on the card).
    ex1 = [e(i, 0) * u1 + e(i, 1) * v1 + e(i, 2) for i in range(3)]
    etx2 = [e(0, j) * u2 + e(1, j) * v2 + e(2, j) for j in range(2)]
    x2tEx1 = u2 * ex1[0] + v2 * ex1[1] + ex1[2]
    denom = torch.sqrt(ex1[0] ** 2 + ex1[1] ** 2 + etx2[0] ** 2 + etx2[1] ** 2)
    return x2tEx1 / torch.clamp(denom, min=1e-20)


def abs_sampson_residuals(points1, points2, E):
    return torch.abs(sampson_residuals(points1, points2, E))


_W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def decompose_essential_matrix(E):
    """E (..., 3, 3) -> (R1, R2, t) candidate decomposition (reference
    :165-191)."""
    U, _, Vt = _svd_or_nan(E, per_matrix=True)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = _table("_W", E)
    return (matmul_ordered(matmul_ordered(U, W), Vt), matmul_ordered(matmul_ordered(U, W.T), Vt),
            U[..., :, 2])


def pose_from_essential_matrix(E, points1, points2, inlier_mask, max_depth=100.0):
    """Cheirality test: the (R, t) of the 4 candidates with the most points
    at positive bounded depth in both views (reference :194-269), over
    leading slot dims: E (..., 3, 3), points (..., N, 2), inlier_mask
    (..., N). Returns (R (..., 3, 3), t (..., 3), num_good (...)); the
    first camera is [I | 0]."""
    from .projection import calc_depth
    from .triangulation import triangulate_points

    R1, R2, t = decompose_essential_matrix(E)
    Rs = torch.stack([R1, R2, R1, R2], dim=-3)
    ts = torch.stack([t, t, -t, -t], dim=-2)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    proj1 = torch.cat([eye, torch.zeros((3, 1), dtype=E.dtype, device=E.device)], dim=1)
    proj2 = torch.cat([Rs, ts[..., None]], dim=-1)  # (..., 4, 3, 4)
    X = triangulate_points(proj1, proj2, points1[..., None, :, :],
                           points2[..., None, :, :])  # (..., 4, N, 3)
    d1 = calc_depth(proj1, X)
    d2 = calc_depth(proj2, X)
    good = ((d1 > 0) & (d1 < max_depth) & (d2 > 0) & (d2 < max_depth)
            & inlier_mask[..., None, :])
    counts = torch.sum(good, dim=-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)  # (..., 1)
    R = torch.gather(Rs, -3, best[..., None, None].expand(best.shape + (3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None].expand(best.shape + (3,)))[..., 0, :]
    return R, t, torch.gather(counts, -1, best)[..., 0]
