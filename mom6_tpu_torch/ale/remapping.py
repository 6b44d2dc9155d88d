"""Conservative 1-D vertical remapping (twin of mom6_tpu/ale/remapping.py:
reconstruct, remap_column, remap_columns_multi).

Each source cell carries a polynomial reconstruction; the cumulative
integral of the reconstruction at every target interface is

    I(z) = sum_k h0_k * P_k( clip((z - z0_k) / h0_k, 0, 1) )

(each cell's antiderivative clipped at its own boundaries), and the
target cell means are differences of I divided by the target
thicknesses, clipped to the source column's [min, max].

:func:`remap_columns_multi` is the kernel wrapper: a CUDA tensor
launches the hand-written kernel of ``csrc/remap.cu``, which replaces
the Pallas kernel ``mom6_tpu/ale/remap_pallas.py::_remap_kernel``; a CPU
tensor runs :func:`remap_integrals_plain`, the reference's scan path as a
loop over k.  Both follow the scan path, not the Pallas kernel: a floor
of 1e-30 on the thicknesses, and target interfaces min(cumsum(h1), col).

The kernel walks the source cells k once and does O(nz0 + nz1) work per
column, yet forms every interface's sum in ascending k as the plain
version does.  It divides only where an interface cuts a cell: with
d = z1_t - z0_k and hk = max(h0_k, 1e-30), d <= 0 clips xi to 0 and the
term, +-0, leaves the sum as it is; d >= hk clips xi to 1 (an IEEE
quotient is >= 1 exactly when d >= hk) and the term is the whole cell,
h0_k times the sum of the coefficients.  An interface that every cell so
far covered whole has the running sum S of the whole cells, which is kept
once per column; its own sum starts from S at the first cell that does
not cover it whole.  :func:`remap_integrals_cellwise` states that order
in plain PyTorch; the tests hold it bitwise against
:func:`remap_integrals_plain`, ties and vanished layers included.

Schemes: PCM, PLM, PPM_H4, PPM_IH4 and PPM_H6 (three coefficients a
cell; PPM_IH4's edge values solve the compact fourth-order tridiagonal
system of each column with the Thomas kernel, its two boundary rows a
cubic fitted to the four cells nearest each end; PPM_H6's are the
explicit sixth-order uniform-grid weights, H4's within three cells of
either end), P3M_H4 (the monotone cubic through the limited H4 edge
values and slopes, shifted to keep the cell mean or else the PPM
parabola, five coefficients of which the last is 0) and
PQM_IH4IH3 (five: the White & Adcroft quartic through the explicit H4
edge values and the interface slopes, the PPM parabola where the quartic
leaves its cell's bounds).  The five-coefficient schemes take the
kernel's NPOLY = 5 form.
"""

from __future__ import annotations

import numpy as np
import torch

from mom6_tpu_torch.framework import kernels
from mom6_tpu_torch.framework.arith import ipow, rdiv, sdiv, vcumsum, vsum
from mom6_tpu_torch.framework.solvers import tridiag_solve

__all__ = ["remap_column", "remap_columns_multi", "remap_coefficients",
           "remap_integrals_plain", "remap_integrals_cellwise", "reconstruct",
           "PCM", "PLM", "PPM_H4", "PPM_IH4", "PPM_H6", "P3M_H4",
           "PQM_IH4IH3"]

PCM = "PCM"
PLM = "PLM"
PPM_H4 = "PPM_H4"
PPM_IH4 = "PPM_IH4"
PPM_H6 = "PPM_H6"
P3M_H4 = "P3M_H4"
PQM_IH4IH3 = "PQM_IH4IH3"

_EPS = 1e-30
# antiderivative scaling of the reconstruction's coefficients:
# P(xi) = xi*(c0 + xi*(c1/2 + xi*(c2/3 + ...)))
_SCALE = (1.0, 0.5, 1.0 / 3.0, 0.25, 0.2)


def _plm_slopes(u, h):
    """Monotonic-limited non-uniform PLM slopes (du across the cell),
    with zero-gradient ends."""
    u_m = torch.cat([u[:1], u[:-1]], dim=0)
    u_p = torch.cat([u[1:], u[-1:]], dim=0)
    h_m = torch.cat([h[:1], h[:-1]], dim=0)
    h_p = torch.cat([h[1:], h[-1:]], dim=0)
    denom = h_m + 2.0 * h + h_p
    slp = 2.0 * h * (u_p - u_m) / torch.clamp(denom, min=_EPS)
    d_p = u_p - u
    d_m = u - u_m
    max_slp = 2.0 * torch.minimum(torch.abs(d_p), torch.abs(d_m))
    return torch.where(d_p * d_m > 0.0,
                       torch.sign(slp) * torch.minimum(torch.abs(slp),
                                                       max_slp), 0.0)


def _edge_values_h4(u, h):
    """Explicit 4th-order interior edge values, 2nd-order next to the ends
    and the cell means at the ends.  Returns (e_top, e_bot)."""
    nz = u.shape[0]
    u_m2 = torch.cat([u[:1], u[:1], u[:-2]], dim=0) if nz >= 2 else u
    u_m1 = torch.cat([u[:1], u[:-1]], dim=0)
    u_p1 = torch.cat([u[1:], u[-1:]], dim=0)
    e_top = (7.0 / 12.0) * (u_m1 + u) - (1.0 / 12.0) * (u_m2 + u_p1)
    e_top[0] = u[0] + 0.5 * (u[0] - u_m1[0])           # == u[0]
    if nz >= 2:
        e_top[1] = 0.5 * (u[0] + u[1])
        e_top[nz - 1] = 0.5 * (u[nz - 2] + u[nz - 1])
    e_bot = torch.cat([e_top[1:], u[-1:]], dim=0)
    return e_top, e_bot


def _edge_values_h6(u, h):
    """Explicit sixth-order edge values with the uniform-grid weights
    (37, -8, 1)/60 on the stencil u[k-3..k+2] of interface k (the ends
    replicated), the H4 values within three cells of either end and for
    columns of fewer than six cells.  Returns (e_top, e_bot)."""
    nz = u.shape[0]
    if nz < 6:
        return _edge_values_h4(u, h)

    def sh(k):
        """u shifted k cells toward the surface, the end cell repeated."""
        if k > 0:
            return torch.cat([u[:1].expand((k,) + u.shape[1:]), u[:-k]], 0)
        return torch.cat([u[-k:], u[-1:].expand((-k,) + u.shape[1:])], 0)

    c1, c2, c3 = 37.0 / 60.0, -8.0 / 60.0, 1.0 / 60.0
    e_top = (c1 * (sh(1) + u) + c2 * (sh(2) + sh(-1))
             + c3 * (sh(3) + sh(-2)))
    e4_t, e4_b = _edge_values_h4(u, h)
    k = torch.arange(nz, device=u.device).reshape((nz,) + (1,) * (u.dim() - 1))
    e_top = torch.where((k >= 3) & (k <= nz - 3), e_top, e4_t)
    return e_top, torch.cat([e_top[1:], e4_b[-1:]], 0)


def _edge_values_implicit_h4(u, h):
    """Compact fourth-order edge values on a non-uniform column
    (edge_values_implicit_h4): at the interface between cells of widths
    h0 and h1, alpha e_{i-1} + e_i + beta e_{i+1} = a u0 + b u1 with
    alpha = h1^2/(h0+h1)^2, beta = h0^2/(h0+h1)^2 and
    a = 2 alpha (alpha + 2 beta + 3 ab), b = 2 beta (beta + 2 alpha + 3 ab),
    ab = h0 h1/(h0+h1)^2; the two boundary edges are pinned to the cubic
    of :func:`_boundary_fit`.  Each layer of a pair is floored at 1% of
    the pair, which keeps the unit-diagonal system strictly diagonally
    dominant where thin and thick layers alternate.  One tridiagonal
    solve of (nz+1, ...).  Returns (e_top, e_bot)."""
    nz = u.shape[0]
    pair = h[:-1] + h[1:] + 1e-30
    h0 = torch.maximum(h[:-1], 0.01 * pair)
    h1 = torch.maximum(h[1:], 0.01 * pair)
    i_h2 = rdiv(1.0, (h0 + h1) ** 2)
    alpha = h1 * h1 * i_h2
    beta = h0 * h0 * i_h2
    abmix = h0 * h1 * i_h2
    a = 2.0 * alpha * (alpha + 2.0 * beta + 3.0 * abmix)
    b = 2.0 * beta * (beta + 2.0 * alpha + 3.0 * abmix)
    z1 = torch.zeros_like(u[:1])
    lo = torch.cat([z1, alpha, z1], dim=0)
    up = torch.cat([z1, beta, z1], dim=0)
    di = torch.ones_like(lo)
    nfit = min(4, nz)
    e_sfc = _boundary_fit(u[:nfit], h[:nfit])
    e_bot = _boundary_fit(torch.flip(u, (0,))[:nfit],
                          torch.flip(h, (0,))[:nfit])
    rhs = torch.cat([e_sfc[None], a * u[:-1] + b * u[1:], e_bot[None]],
                    dim=0)
    e = tridiag_solve(lo, di, up, rhs)
    return e[:-1], e[1:]


def _lu_solve_lapack(A, rhs):
    """``A x = rhs`` for a stack of small systems (..., n, n), (..., n) on
    the CPU, each by LAPACK's getrf and two BLAS trsm (scipy's, the
    routines the reference's CPU solve calls), so the result is the
    reference's to the bit."""
    from scipy.linalg import blas, lapack
    a = A.detach().numpy()
    r = rhs.detach().numpy()
    n = a.shape[-1]
    getrf, trsm = ((lapack.dgetrf, blas.dtrsm) if a.dtype == np.float64
                   else (lapack.sgetrf, blas.strsm))
    flat_a = a.reshape(-1, n, n)
    flat_r = r.reshape(-1, n, 1)
    out = np.empty_like(flat_r)
    with np.errstate(all="ignore"):
        for i in range(flat_a.shape[0]):
            lu, piv, _ = getrf(flat_a[i])
            perm = np.arange(n)
            for k, pk in enumerate(piv):
                perm[[k, pk]] = perm[[pk, k]]
            x = trsm(1.0, lu, flat_r[i][perm], side=0, lower=1, trans_a=0,
                     diag=1)
            out[i] = trsm(1.0, lu, x, side=0, lower=0, trans_a=0, diag=0)
    return torch.from_numpy(out.reshape(r.shape))


def _boundary_fit(u, h):
    """The value at the outer boundary of the polynomial of degree n-1
    whose means over the ``n = u.shape[0]`` cells nearest the boundary
    (outermost first) are u: a Vandermonde-style system in z normalised
    by the stack's depth, vanished layers floored at 1e-3/n of it, solved
    by LU with partial pivoting (on the CPU LAPACK's, as the reference;
    on the card ``torch.linalg.solve``), the outermost cell mean where
    the solve degenerates."""
    n = u.shape[0]
    total = vsum(h, keepdim=True) + 1e-30
    hn = torch.maximum(h, (1e-3 / n) * total) / total
    zi = torch.cat([torch.zeros_like(hn[:1]), vcumsum(hn)], dim=0)
    rows = [(ipow(zi[1:], m + 1) - ipow(zi[:-1], m + 1))
            / (float(m + 1) * hn) for m in range(n)]
    A = torch.movedim(torch.stack(rows, dim=-1), 0, -2)   # (..., n, n)
    rhs = torch.movedim(u, 0, -1)                         # (..., n)
    if u.device.type == "cpu":
        coef = _lu_solve_lapack(A, rhs)[..., 0]
    else:
        coef = torch.linalg.solve(A, rhs)[..., 0]
    return torch.where(torch.isfinite(coef), coef, u[0])


def _ppm_limit(u, e_l, e_r):
    """Colella & Woodward monotonizing limiter."""
    u_m = torch.cat([u[:1], u[:-1]], dim=0)
    u_p = torch.cat([u[1:], u[-1:]], dim=0)
    e_l = torch.clamp(e_l, torch.minimum(u_m, u), torch.maximum(u_m, u))
    e_r = torch.clamp(e_r, torch.minimum(u_p, u), torch.maximum(u_p, u))
    not_mono = (e_r - u) * (u - e_l) <= 0.0
    diff = e_r - e_l
    mean = 0.5 * (e_r + e_l)
    fac = 6.0 * diff * (u - mean)
    diff2 = diff * diff
    e_l2 = torch.where(fac > diff2, 3.0 * u - 2.0 * e_r, e_l)
    e_r2 = torch.where(fac < -diff2, 3.0 * u - 2.0 * e_l, e_r)
    return torch.where(not_mono, u, e_l2), torch.where(not_mono, u, e_r2)


def _edge_slopes(u, h):
    """The slopes du/dz [u m-1] at the top and the bottom interface of
    each cell from the neighbouring cell means, 0 at the ends."""
    du = u[1:] - u[:-1]
    dz = torch.clamp(0.5 * (h[:-1] + h[1:]), min=_EPS)
    s_int = du / dz
    zeros = torch.zeros_like(u[:1])
    return (torch.cat([zeros, s_int], dim=0),
            torch.cat([s_int, zeros], dim=0))


def _pqm_coeffs(u, h, e_l, e_r, s_l, s_r):
    """The quartic through (eL, sL) and (eR, sR) with the cell mean u
    (White & Adcroft 2008); the slopes in xi units are s h."""
    sl = s_l * h
    sr = s_r * h
    r1 = u - e_l - 0.5 * sl
    r2 = e_r - e_l - sl
    r3 = sr - sl
    return (e_l, sl,
            30.0 * r1 - 12.0 * r2 + 1.5 * r3,
            -60.0 * r1 + 28.0 * r2 - 4.0 * r3,
            30.0 * r1 - 15.0 * r2 + 2.5 * r3)


def _p3m(u, h):
    """P3M_H4's coefficients (c0, .., c3, 0): the cubic through the
    limited H4 edge values with the edge slopes, each limited by twice
    the one-sided slope; where the cubic's derivative would change sign
    on [0, 1] (at an end or at its vertex) the slopes are dropped and the
    derivative is 6 (eR - eL) xi (1 - xi).

    A cubic through the edges and slopes alone has the mean
    (eL + eR) / 2 + (u1l - u1r) / 12, not the cell's: c0 takes up the
    difference d where eL + d and eR + d stay within the means of the
    cell and its neighbours, and elsewhere the cell takes the PPM
    parabola on the same edges, so that the remap keeps each column's
    content and its clip to the column's range stays idle (MOM6 puts d
    back in each source cell's thickest sub-cell, remap_via_sub_cells;
    the reference does neither, ROADMAP queue 3)."""
    e_l, e_r = _ppm_limit(u, *_edge_values_h4(u, h))
    s_l, s_r = _edge_slopes(u, h)
    u_m = torch.cat([u[:1], u[:-1]], dim=0)
    u_p = torch.cat([u[1:], u[-1:]], dim=0)
    hn = torch.clamp(h, min=_EPS)
    sig_l = 2.0 * (u - u_m) / hn
    sig_r = 2.0 * (u_p - u) / hn
    s_l = torch.where(torch.abs(s_l) > torch.abs(sig_l), sig_l, s_l)
    s_r = torch.where(torch.abs(s_r) > torch.abs(sig_r), sig_r, s_r)
    u1l, u1r = s_l * h, s_r * h

    def cubic(u1l, u1r):
        return (u1l, 3.0 * (e_r - e_l) - u1r - 2.0 * u1l,
                u1r + u1l + 2.0 * (e_l - e_r))

    a1, a2, a3 = cubic(u1l, u1r)
    q0 = a1
    q1 = a1 + 2.0 * a2 + 3.0 * a3
    tiny = torch.where(a3 >= 0, torch.full_like(a3, 1e-30),
                       torch.full_like(a3, -1e-30))
    xi_v = torch.where(torch.abs(a3) > 1e-12, -a2 / (3.0 * a3 + tiny),
                       torch.full_like(a3, 0.5))
    xi_v = torch.clamp(xi_v, 0.0, 1.0)
    qv = a1 + xi_v * (2.0 * a2 + 3.0 * a3 * xi_v)
    non_mono = (q0 * q1 < 0.0) | (q0 * qv < 0.0) | (qv * q1 < 0.0)
    zero = torch.zeros_like(u)
    a1, a2, a3 = cubic(torch.where(non_mono, zero, u1l),
                       torch.where(non_mono, zero, u1r))
    d = u - (e_l + 0.5 * a1 + sdiv(a2, 3.0) + 0.25 * a3)
    lo = torch.minimum(torch.minimum(u_m, u), u_p)
    hi = torch.maximum(torch.maximum(u_m, u), u_p)
    ok = ((e_l + d >= lo) & (e_l + d <= hi) & (e_r + d >= lo)
          & (e_r + d <= hi))
    return (e_l + torch.where(ok, d, zero),
            torch.where(ok, a1, 6.0 * u - 4.0 * e_l - 2.0 * e_r),
            torch.where(ok, a2, 3.0 * ((e_l + e_r) - 2.0 * u)),
            torch.where(ok, a3, zero), zero)


def _pqm(u, h):
    """PQM_IH4IH3's five coefficients: the limited explicit H4 edges, the
    edge slopes zeroed where the cell is an extremum or where they
    disagree with eR - eL, the quartic; the PPM parabola where the
    quartic at xi = 1/4, 1/2 or 3/4 leaves [min, max](eL, u, eR) by more
    than 1e-6 of its width."""
    e_l, e_r = _ppm_limit(u, *_edge_values_h4(u, h))
    s_l, s_r = _edge_slopes(u, h)
    de = e_r - e_l
    hn = torch.clamp(h, min=_EPS)
    s_l = torch.where(s_l * de / hn > 0.0, s_l, 0.0)
    s_r = torch.where(s_r * de / hn > 0.0, s_r, 0.0)
    a0, a1, a2, a3, a4 = _pqm_coeffs(u, h, e_l, e_r, s_l, s_r)
    lo = torch.minimum(torch.minimum(e_l, e_r), u)
    hi = torch.maximum(torch.maximum(e_l, e_r), u)
    slack = 1e-6 * (hi - lo + 1e-30)
    ok = torch.ones_like(u, dtype=torch.bool)
    for xi in (0.25, 0.5, 0.75):
        val = a0 + xi * (a1 + xi * (a2 + xi * (a3 + xi * a4)))
        ok = ok & (val >= lo - slack) & (val <= hi + slack)
    zero = torch.zeros_like(u)
    return (torch.where(ok, a0, e_l),
            torch.where(ok, a1, 6.0 * u - 4.0 * e_l - 2.0 * e_r),
            torch.where(ok, a2, 3.0 * ((e_l + e_r) - 2.0 * u)),
            torch.where(ok, a3, zero), torch.where(ok, a4, zero))


def reconstruct(u, h, scheme: str):
    """Per-cell coefficients (c0, c1, c2) of u(xi) = c0 + c1 xi + c2 xi^2
    on [0, 1] (the reference returns five, the last two zero for these
    schemes), and for P3M_H4 and PQM_IH4IH3 the five (c0, .., c4)."""
    if scheme == PCM:
        z = torch.zeros_like(u)
        return u, z, z
    if scheme == PLM:
        slp = _plm_slopes(u, h)
        return u - 0.5 * slp, slp, torch.zeros_like(u)
    if scheme in (PPM_H4, PPM_IH4, PPM_H6):
        edges = {PPM_H4: _edge_values_h4, PPM_IH4: _edge_values_implicit_h4,
                 PPM_H6: _edge_values_h6}[scheme]
        e_l, e_r = _ppm_limit(u, *edges(u, h))
        # u(xi) = eL + xi[(eR-eL) + 6(1-xi)(u - (eL+eR)/2)]  (CW84)
        return (e_l, 6.0 * u - 4.0 * e_l - 2.0 * e_r,
                3.0 * ((e_l + e_r) - 2.0 * u))
    if scheme == P3M_H4:
        return _p3m(u, h)
    if scheme == PQM_IH4IH3:
        return _pqm(u, h)
    raise ValueError(f"unknown remapping scheme {scheme}")


def _target_interfaces(h0, h1):
    """min(cumsum(h1), col) as (nz1 + 1, ...), the sums sequential in k."""
    nz0, nz1 = h0.shape[0], h1.shape[0]
    col = torch.zeros_like(h0[0])
    for k in range(nz0):
        col = col + h0[k]
    z1 = torch.empty((nz1 + 1,) + h1.shape[1:], dtype=h1.dtype,
                     device=h1.device)
    z = torch.zeros_like(h1[0])
    z1[0] = z
    for t in range(nz1):
        z = z + h1[t]
        z1[t + 1] = z
    z1 = torch.minimum(z1, col[None])
    return z1


def remap_integrals_plain(coef, h0, h1, lo, hi):
    """The remap in plain PyTorch, a loop over the source cells k.

    coef: (nf, npoly, nz0, ...) antiderivative coefficients; h0: (nz0,
    ...); h1: (nz1, ...); lo/hi: (nf, ...) output bounds.  Returns
    (nf, nz1, ...)."""
    npoly, nz0 = coef.shape[1], coef.shape[2]
    z1 = _target_interfaces(h0, h1)
    acc = torch.zeros((coef.shape[0],) + z1.shape, dtype=coef.dtype,
                      device=coef.device)
    z0 = torch.zeros_like(h0[0])
    for k in range(nz0):
        xi = torch.clamp((z1 - z0[None]) / torch.clamp(h0[k], min=_EPS)[None],
                         0.0, 1.0)
        b = coef[:, :, k, None]                 # (nf, npoly, 1, ...)
        poly = b[:, npoly - 1]
        for p in range(npoly - 2, -1, -1):
            poly = b[:, p] + xi * poly
        acc = acc + h0[k] * (xi * poly)
        z0 = z0 + h0[k]
    u1 = (acc[:, 1:] - acc[:, :-1]) / torch.clamp(h1, min=_EPS)[None]
    return torch.clamp(u1, lo[:, None], hi[:, None])


def remap_integrals_cellwise(coef, h0, h1, lo, hi):
    """The remap with each interface's sum formed as the kernel of
    ``csrc/remap.cu`` forms it, for the tests.  Cell k adds nothing where
    the interface lies at or above its top, the whole cell
    ``w_k = h0_k * P_k(1)`` without a division where it lies at or below
    its bottom, and takes the division and the Horner pass otherwise; an
    interface that every cell so far covered whole (``fresh``) has no sum
    of its own yet but the shared ``S = ((0 + w_0) + w_1) + ...``.  Same
    arguments and, to the bit, the same result as
    :func:`remap_integrals_plain` (for finite inputs)."""
    npoly, nz0 = coef.shape[1], coef.shape[2]
    z1 = _target_interfaces(h0, h1)
    acc = torch.zeros((coef.shape[0],) + z1.shape, dtype=coef.dtype,
                      device=coef.device)
    S = torch.zeros_like(acc[:, :1])
    fresh = torch.ones_like(z1, dtype=torch.bool)
    z0 = torch.zeros_like(h0[0])
    for k in range(nz0):
        hk = torch.clamp(h0[k], min=_EPS)[None]
        d = z1 - z0[None]
        b = coef[:, :, k, None]                 # (nf, npoly, 1, ...)
        ones = b[:, npoly - 1]
        for p in range(npoly - 2, -1, -1):
            ones = b[:, p] + ones
        whole = h0[k] * ones                    # (nf, 1, ...)
        xi = torch.clamp(d / hk, 0.0, 1.0)
        poly = b[:, npoly - 1]
        for p in range(npoly - 2, -1, -1):
            poly = b[:, p] + xi * poly
        cut = h0[k] * (xi * poly)
        base = torch.where(fresh, S, acc)
        acc = torch.where(d >= hk, acc + whole,
                          torch.where(d > 0.0, base + cut, base))
        fresh = fresh & (d >= hk)
        S = S + whole
        z0 = z0 + h0[k]
    acc = torch.where(fresh, S, acc)
    u1 = (acc[:, 1:] - acc[:, :-1]) / torch.clamp(h1, min=_EPS)[None]
    return torch.clamp(u1, lo[:, None], hi[:, None])


def _remap_launch(coef, h0, h1, lo, hi):
    name = "remap_columns_multi"
    nf, npoly, nz0 = coef.shape[:3]
    nz1 = h1.shape[0]
    plane = h0.shape[1:]
    if (npoly not in (3, 5) or h0.shape[0] != nz0
            or h1.shape[1:] != plane or coef.shape[3:] != plane
            or lo.shape != (nf,) + plane or hi.shape != lo.shape):
        raise ValueError(f"{name}: coef (nf, 3|5, nz0, ...), h0 (nz0, ...), "
                         "h1 (nz1, ...) and lo/hi (nf, ...) must agree")
    for t in (h0, h1, lo, hi):
        if t.device != coef.device or t.dtype != coef.dtype:
            raise TypeError(f"{name}: every input must be a {coef.dtype} "
                            f"tensor on {coef.device}")
    coef, h0, h1, lo, hi = (t.contiguous() for t in (coef, h0, h1, lo, hi))
    out = torch.empty((nf, nz1) + plane, dtype=coef.dtype,
                      device=coef.device)
    rc = kernels.entry("mom6_remap", coef.dtype)(
        coef.data_ptr(), h0.data_ptr(), h1.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), out.data_ptr(), nf, npoly, nz0, nz1,
        h0[0].numel(), kernels.stream_of(coef))
    kernels.check(rc, name)
    return out


def remap_coefficients(fields, h0, scheme: str = PPM_H4):
    """The remap's inputs besides the thicknesses: the antiderivative
    coefficients (nf, npoly, nz0, ...) of each field's reconstruction and
    the bounds lo/hi (nf, ...), each column's min and max."""
    recon = [reconstruct(fields[i], h0, scheme)
             for i in range(fields.shape[0])]
    npoly = len(recon[0])
    coef = torch.stack([torch.stack([_SCALE[p] * r[p] for p in range(npoly)])
                        for r in recon])
    return coef, torch.amin(fields, dim=1), torch.amax(fields, dim=1)


def remap_columns_multi(fields, h0, h1, scheme: str = PPM_H4):
    """Remap several fields (nf, nz0, ...) sharing one column geometry
    from thicknesses ``h0`` to ``h1`` (same column sums).

    CPU tensors take :func:`remap_integrals_plain`; CUDA tensors launch
    the kernel (float32 or float64), counted in
    ``remap_columns_multi.launches``, and its quartic instance (NPOLY = 5,
    P3M_H4 and PQM_IH4IH3) also in ``remap_columns_multi.quartic_launches``."""
    coef, lo, hi = remap_coefficients(fields, h0, scheme)
    if fields.device.type == "cpu":
        return remap_integrals_plain(coef, h0, h1, lo, hi)
    if fields.device.type != "cuda":
        raise TypeError(f"remap_columns_multi: no kernel for device "
                        f"{fields.device}")
    out = _remap_launch(coef, h0, h1, lo, hi)
    remap_columns_multi.launches += 1
    if coef.shape[1] == 5:
        remap_columns_multi.quartic_launches += 1
    return out


remap_columns_multi.launches = 0
remap_columns_multi.quartic_launches = 0


def remap_column(u0, h0, h1, scheme: str = PPM_H4):
    """Remap cell averages ``u0`` (nz0, ...) on thicknesses ``h0`` to the
    grid ``h1`` (nz1, ...)."""
    return remap_columns_multi(u0[None], h0, h1, scheme)[0]
