"""Batched polynomial evaluation and root finding.

Port of mavmap_tpu/ops/polynomial.py (reference src/util/math.{h,cc}
`poly_eval`, `poly_solve`). Complex arithmetic stays on explicit real
(re, im) pairs, like the JAX version, so both packages run the same
arithmetic step for step.

Coefficient convention: **ascending** — ``p(z) = sum_k coeffs[..., k] z^k``.
"""

import math

import torch

from .reduce import elementwise_fixed


def poly_eval(coeffs, x):
    """Evaluate p(x) by Horner. coeffs: (..., D+1) ascending; x: (...)."""
    D = coeffs.shape[-1] - 1
    acc = coeffs[..., D]
    for k in range(D - 1, -1, -1):
        acc = acc * x + coeffs[..., k]
    return acc


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi, eps=1e-30):
    d = torch.clamp(br * br + bi * bi, min=eps)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _fujiwara_scale(monic):
    """Fujiwara root bound 2 * max_k |c_{D-k}|^{1/k} of a monic ascending
    polynomial batch (..., D+1)."""
    D = monic.shape[-1] - 1
    kk = torch.arange(1, D + 1, dtype=monic.dtype, device=monic.device)
    mags = torch.abs(monic[..., :-1].flip(-1))  # |c_{D-1}|, ..., |c_0|
    radius = 2.0 * torch.amax(elementwise_fixed(torch.pow, torch.clamp(mags, min=1e-30), 1.0 / kk),
                              dim=-1)
    return torch.clamp(radius, min=1e-6)


def roots_durand_kerner(coeffs, num_iters=60):
    """All complex roots of a batch of degree-D polynomials.

    coeffs: (..., D+1) ascending real coefficients. Returns (roots_re,
    roots_im), each (..., D). Fixed `num_iters` Weierstrass iterations in
    the scaled variable u = z / radius (all magnitudes O(1), f32-safe),
    from a spiral of initial guesses.
    """
    dtype = coeffs.dtype
    D = coeffs.shape[-1] - 1
    lead = coeffs[..., -1:]
    lead = torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30), lead)
    monic = coeffs / lead
    radius = _fujiwara_scale(monic)
    powers = elementwise_fixed(torch.pow, radius[..., None],
                               torch.arange(-D, 1, dtype=dtype, device=coeffs.device))
    monic = monic * powers

    k = torch.arange(D, dtype=dtype, device=coeffs.device)
    ang = math.atan2(0.9, 0.4) * (k + 1.0)
    mod = 0.5 + 0.5 * (k + 1.0) / D
    zr = (mod * torch.cos(ang)).expand(radius.shape + (D,))
    zi = (mod * torch.sin(ang)).expand(radius.shape + (D,))
    eye = torch.eye(D, dtype=dtype, device=coeffs.device)

    for _ in range(num_iters):
        # Horner on the monic ascending coefficients, batched over roots.
        pr = torch.zeros_like(zr)
        pi = torch.zeros_like(zi)
        for i in range(D, -1, -1):
            pr, pi = _cmul(pr, pi, zr, zi)
            pr = pr + monic[..., i][..., None]
        dr = zr[..., :, None] - zr[..., None, :] + eye  # (..., D, D)
        di = zi[..., :, None] - zi[..., None, :]
        qr = torch.ones_like(zr)
        qi = torch.zeros_like(zi)
        for j in range(D):  # product over the last axis, in order
            qr, qi = _cmul(qr, qi, dr[..., j], di[..., j])
        sr, si = _cdiv(pr, pi, qr, qi)
        # Clamp absurd steps (rare stalls with coincident guesses).
        smag = torch.sqrt(sr * sr + si * si)
        scale = torch.where(smag > 4.0, 4.0 / torch.clamp(smag, min=1e-30),
                            torch.ones_like(smag))
        zr = zr - sr * scale
        zi = zi - si * scale
    r = radius[..., None]
    return zr * r, zi * r


def solve_quartic_real(coeffs):
    """Closed-form (Ferrari) real roots of a batch of quartics.

    coeffs: (..., 5) ascending. Returns (roots, mask), each (..., 4): the
    real roots (garbage where mask is False) of c4 x^4 + ... + c0, by the
    branch-free resolvent-cubic + two-quadratics factorization.
    """
    lead = coeffs[..., 4:5]
    lead = torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30), lead)
    monic = coeffs / lead
    R = _fujiwara_scale(monic)
    powers = elementwise_fixed(torch.pow, R[..., None],
                               torch.arange(-4, 1, dtype=coeffs.dtype, device=coeffs.device))
    u = monic * powers

    a, b, c, d = u[..., 3], u[..., 2], u[..., 1], u[..., 0]
    # Depressed quartic y^4 + p y^2 + q y + r, x = y - a/4.
    a2 = a * a
    p = b - 0.375 * a2
    q = c - 0.5 * a * b + 0.125 * a2 * a
    r = d - 0.25 * a * c + 0.0625 * a2 * b - (3.0 / 256.0) * a2 * a2

    # Resolvent cubic m^3 + e2 m^2 + e1 m + e0 = 0 (largest real root >= 0).
    e2 = p
    e1 = 0.25 * p * p - r
    e0 = -0.125 * q * q
    P = e1 - e2 * e2 / 3.0
    Q = 2.0 * e2 * e2 * e2 / 27.0 - e2 * e1 / 3.0 + e0
    half_q = 0.5 * Q
    disc = half_q * half_q + (P / 3.0) ** 3

    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(x):
        return torch.sign(x) * elementwise_fixed(torch.pow, torch.abs(x), 1.0 / 3.0)

    t_single = cbrt(-half_q + sq) + cbrt(-half_q - sq)
    mp3 = torch.clamp(-P / 3.0, min=1e-30)
    smp3 = torch.sqrt(mp3)
    cosphi = torch.clamp(-half_q / torch.clamp(smp3 ** 3, min=1e-30), -1.0, 1.0)
    t_triple = 2.0 * smp3 * torch.cos(torch.arccos(cosphi) / 3.0)
    t = torch.where(disc >= 0, t_single, t_triple)
    m = torch.clamp(t - e2 / 3.0, min=0.0)

    s = torch.sqrt(2.0 * m)
    qs = torch.where(s > 1e-12, q / torch.clamp(2.0 * s, min=1e-30),
                     torch.zeros_like(q))
    B1 = 0.5 * p + m - qs
    B2 = 0.5 * p + m + qs
    d1 = s * s - 4.0 * B1
    d2 = s * s - 4.0 * B2
    sd1 = torch.sqrt(torch.clamp(d1, min=0.0))
    sd2 = torch.sqrt(torch.clamp(d2, min=0.0))
    y = torch.stack([0.5 * (-s + sd1), 0.5 * (-s - sd1),
                     0.5 * (s + sd2), 0.5 * (s - sd2)], dim=-1)
    mask = torch.stack([d1, d1, d2, d2], dim=-1) >= 0
    roots = (y - 0.25 * a[..., None]) * R[..., None]
    return roots, mask


def real_roots_mask(roots_re, roots_im, imag_tol=1e-4):
    """Mask of roots that are (numerically) real, relative to their magnitude."""
    mag = torch.sqrt(roots_re * roots_re + roots_im * roots_im)
    return roots_im.abs() <= imag_tol * torch.clamp(mag, min=1.0)
