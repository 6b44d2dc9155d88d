"""Neutral (epineutral) tracer diffusion (twin of
mom6_tpu/tracers/neutral_diffusion.py).

Two schemes:

* :func:`neutral_diffusion` ("redi"), the small-slope rotated tensor with
  the Griffies stability split: the explicit along-layer flux with the
  slope cross term at the faces, the explicit cross term at the
  interfaces, and the remaining K S^2 vertical part returned as an
  interface diffusivity ``kd_redi`` for the implicit vertical solve;
* :func:`neutral_diffusion_surfaces` ("surfaces"), matched neutral-surface
  positions: each column's interface densities are located in its
  neighbour's column, the tracers are exchanged between a layer and the
  matched sublayer (a limited-parabolic PPM_H4 mean over the span) and the
  received flux is deposited over the neighbour's layers by overlap.

Both are in flux form and conserve.  The reference's two scans over the
layers are loops over the layers here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mom6_tpu_torch.ale.remapping import PPM_H4, reconstruct
from mom6_tpu_torch.core.isopycnal_slopes import isopycnal_slopes
from mom6_tpu_torch.framework.arith import vcumsum, vsum
from mom6_tpu_torch.framework.stencil import (fold_ghost, im1, ip1, jm1,
                                              jm1_s0, jp1)

__all__ = ["neutral_diffusion", "neutral_diffusion_surfaces"]

_H_EPS = 1e-3


def _interfaces(h):
    """Interface depths (nz+1, ...) from the surface down."""
    return torch.cat([torch.zeros_like(h[:1]), vcumsum(h)], 0)


def _interface_density(T, S, eos, rho0, p_ref: float):
    """Potential density referenced to ``p_ref``, made monotone by a
    running maximum, at the nz+1 interfaces (the end layers' values at
    the ends)."""
    p = torch.full_like(T, p_ref)
    rho_c = rho0 + eos.density(T, S, p, rho_ref=rho0)
    rho_c = torch.cummax(rho_c, dim=0).values
    rho_i = 0.5 * (rho_c[:-1] + rho_c[1:])
    return torch.cat([rho_c[:1], rho_i, rho_c[-1:]], 0)


def _position_of_density(rho_tgt, rho_i, z_i):
    """The depth where a column's interface density profile ``rho_i`` at
    depths ``z_i`` (nz+1, ny, nx) equals each of ``rho_tgt`` (nt, ny, nx),
    by piecewise-linear inversion; returns (nt, ny, nx)."""
    r_lo, r_hi = rho_i[:-1], rho_i[1:]
    z_lo, z_hi = z_i[:-1], z_i[1:]
    dr = torch.clamp(r_hi - r_lo, min=1e-12)
    frac = torch.clamp((rho_tgt[:, None] - r_lo[None]) / dr[None], 0.0, 1.0)
    frac = torch.where((r_hi - r_lo)[None] < 1e-12,
                       (r_lo[None] < rho_tgt[:, None]).to(frac.dtype), frac)
    return vsum(((z_hi - z_lo)[None] * frac).transpose(0, 1))


def _mean_over_spans(tr, h, z_lo, z_hi):
    """The mean of each tracer (n_tr, nz, ny, nx) over the depth spans
    [z_lo, z_hi) (ns, ny, nx) of its column, from the PPM_H4 parabola of
    each layer; returns (mean (n_tr, ns, ny, nx), span)."""
    z_i = _interfaces(h)
    coef = [reconstruct(tr[i], h, PPM_H4) for i in range(tr.shape[0])]
    c0, c1, c2 = (torch.stack([c[j] for c in coef]) for j in range(3))

    def integral_to(z):
        # sum_k h_k xi (a0 + a1 xi/2 + a2 xi^2/3), xi the clipped position
        # of z in layer k, added layer by layer from the top
        acc = torch.zeros(tr.shape[:1] + z.shape, dtype=tr.dtype,
                          device=tr.device)
        for k in range(h.shape[0]):
            h_k = h[k]
            xi = torch.clamp((z - z_i[k][None])
                             / torch.clamp(h_k, min=_H_EPS)[None], 0.0, 1.0)
            poly = c0[:, k][:, None] + xi[None] * (
                0.5 * c1[:, k][:, None] + (1.0 / 3.0) * c2[:, k][:, None]
                * xi[None])
            acc = acc + h_k[None, None] * xi[None] * poly
        return acc

    span = torch.clamp(z_hi - z_lo, min=0.0)
    mean = (integral_to(z_hi) - integral_to(z_lo)) \
        / torch.clamp(span, min=_H_EPS)[None]
    return mean, span


def _deposit(F, z_lo, z_hi, h):
    """Spread the per-span fluxes ``F`` (n_tr, ns, ny, nx) on the spans
    [z_lo, z_hi) over the layers of the column by depth overlap (the sum
    over the layers is the sum of F); returns (n_tr, nz, ny, nx)."""
    z_i = _interfaces(h)
    span = torch.clamp(z_hi - z_lo, min=_H_EPS)
    out = torch.zeros(F.shape[:1] + h.shape, dtype=F.dtype, device=F.device)
    for k in range(F.shape[1]):
        ov = torch.clamp(torch.minimum(z_i[1:], z_hi[k][None])
                         - torch.maximum(z_i[:-1], z_lo[k][None]), min=0.0)
        out = out + F[:, k][:, None] * (ov / span[k][None])[None]
    return out


def neutral_diffusion_surfaces(tr, h, T, S, G, GV, eos, khtr, dt, *,
                               p_ref: float = 2e7):
    """Neutral-surface diffusion of the tracers ``tr`` (n_tr, nz, ny, nx)
    by matched density positions: every cell exchanges with its four
    neighbours, each face flux counted at half weight from either side;
    positions from potential density referenced to ``p_ref``.  Land
    columns keep their values."""
    rho_i = _interface_density(T, S, eos, GV.rho0, p_ref)
    z_i = _interfaces(h)

    def exchange(shift_p, shift_m, face_len, inv_dx, mask):
        rho_nb = shift_p(rho_i)
        z_nb = shift_p(z_i)
        h_nb = shift_p(h)
        tr_nb = shift_p(tr)
        # the positions of this column's interface densities next door
        zs = _position_of_density(rho_i, rho_nb, z_nb)
        zs = torch.cummax(zs, dim=0).values
        z_lo, z_hi = zs[:-1], zs[1:]
        tr_match, span = _mean_over_spans(tr_nb, h_nb, z_lo, z_hi)
        h_eff = 2.0 * h * span / (h + span + _H_EPS)
        # only the part of a layer's density range that the neighbour
        # holds is connected
        num = torch.clamp(torch.minimum(rho_i[1:], rho_nb[-1:])
                          - torch.maximum(rho_i[:-1], rho_nb[:1]), min=0.0)
        den = torch.clamp(rho_i[1:] - rho_i[:-1], min=1e-12)
        w_match = torch.clamp(num / den, 0.0, 1.0)
        F = -khtr * (face_len * inv_dx * mask * h_eff * w_match)[None] \
            * (tr - tr_match)
        recv = _deposit(-F, z_lo, z_hi, h_nb)
        return F, shift_m(recv)

    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None

    def jp1_fold(a):
        return jp1(a, kh)

    def jm1_fold(a):
        # the fold row also takes the deposit of its mirror partner; the
        # row-0 wrap is a solid southern wall on a tripolar grid
        r = jm1_s0(a, fold)
        g = fold_ghost(a, "h") if fold else None
        if g is not None:
            r[..., -1, :] = r[..., -1, :] + g
        return r

    fe, re_ = exchange(ip1, im1, G.dyCu, G.IdxCu, G.mask2dCu)
    fw, rw = exchange(im1, ip1, im1(G.dyCu), im1(G.IdxCu),
                      im1(G.mask2dCu))
    fn, rn = exchange(jp1_fold, jm1_fold, G.dxCv, G.IdyCv, G.mask2dCv)
    fs, rs = exchange(jm1, jp1, jm1(G.dxCv), jm1(G.IdyCv),
                      jm1_s0(G.mask2dCv, fold))
    vol = torch.clamp(h * G.areaT, min=_H_EPS)
    dtr = 0.5 * dt * (((fe + re_) + (fw + rw))
                      + ((fn + rn) + (fs + rs))) / vol[None]
    return torch.where(G.mask2dT[None, None] > 0.5, tr + dtr, tr)


def _ddz_centers(f, h):
    """d(f)/dz at the layer centres along axis -3 (z up, the index down;
    one-sided at the ends); ``h`` broadcasts against ``f``."""
    def up(a):
        return torch.cat([a[..., :1, :, :], a[..., :a.shape[-3] - 1, :, :]],
                         -3)

    def dn(a):
        return torch.cat([a[..., 1:, :, :], a[..., a.shape[-3] - 1:, :, :]],
                         -3)

    dz = 0.5 * (up(h) + 2.0 * h + dn(h))
    return (up(f) - dn(f)) / torch.clamp(dz, min=_H_EPS)


def neutral_diffusion(tr, h, T, S, G, GV, eos, khtr, dt, *,
                      slope_max: float = 0.01, bld=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Redi scheme on the tracers ``tr`` (n_tr, nz, ny, nx) with the
    neutral directions of ``T`` and ``S`` and the epineutral diffusivity
    ``khtr`` [m2 s-1].  Returns (tr_new, kd_redi): apply ``kd_redi``
    (nz+1, ny, nx) in the implicit vertical solve.

    ``bld`` (ny, nx), the boundary-layer depth [m]: the slopes taper to
    zero above it, over the next 20% of it below (NDIFF_INTERIOR_ONLY)."""
    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    sx, sy = isopycnal_slopes(h, T, S, G, GV, eos, slope_max=slope_max)
    if bld is not None:
        z_c = vcumsum(h) - 0.5 * h
        bldz = torch.clamp(bld, min=_H_EPS)[None]
        ramp = torch.clamp((z_c - bldz) / (0.2 * bldz), 0.0, 1.0)
        sx = sx * 0.5 * (ramp + ip1(ramp))
        sy = sy * 0.5 * (ramp + jp1(ramp, kh))

    # harmonic means at the faces: no flux into a vanished layer
    h_u = (2.0 * h * ip1(h) / (h + ip1(h) + _H_EPS)) * G.mask2dCu
    h_v = (2.0 * h * jp1(h, kh) / (h + jp1(h, kh) + _H_EPS)) * G.mask2dCv
    vol = torch.clamp(h * G.areaT, min=_H_EPS)

    dtr_dz = _ddz_centers(tr, h[None])

    # the explicit horizontal flux with the slope cross term
    gx = (ip1(tr) - tr) * G.IdxCu
    dtdz_u = 0.5 * (dtr_dz + ip1(dtr_dz))
    fx = -khtr * (gx + sx[None] * dtdz_u) * (h_u * G.dyCu)[None] \
        * G.mask2dCu
    gy = (jp1(tr, kh) - tr) * G.IdyCv
    dtdz_v = 0.5 * (dtr_dz + jp1(dtr_dz, kh))
    fy = -khtr * (gy + sy[None] * dtdz_v) * (h_v * G.dxCv)[None] \
        * G.mask2dCv

    # the explicit vertical cross term at the interior interfaces
    gx_c = 0.5 * (gx + im1(gx))
    gy_c = 0.5 * (gy + jm1_s0(gy, fold))
    sx_c = 0.5 * (sx + im1(sx))
    sy_c = 0.5 * (sy + jm1_s0(sy, fold))
    sdot = sx_c[None] * gx_c + sy_c[None] * gy_c
    sdot_int = 0.5 * (sdot[:, :-1] + sdot[:, 1:])
    fz = -khtr * sdot_int * G.areaT[None, None] * G.mask2dT[None, None]
    h_int_min = torch.minimum(h[:-1], h[1:])
    fz = fz * (h_int_min / (h_int_min + _H_EPS))[None]
    zeros = torch.zeros_like(fz[:, :1])
    fz_full = torch.cat([zeros, fz, zeros], 1)

    div = ((fx - im1(fx)) + (fy - jm1_s0(fy, fold))) \
        + (fz_full[:, :-1] - fz_full[:, 1:])
    tr_new = tr - dt * div / vol[None]
    tr_new = torch.where(G.mask2dT[None, None] > 0.5, tr_new, tr)

    # the implicit K S^2 vertical diffusivity
    s2_c = sx_c * sx_c + sy_c * sy_c
    s2_int = 0.5 * (s2_c[:-1] + s2_c[1:])
    kd_redi = torch.cat([torch.zeros_like(h[:1]), khtr * s2_int,
                         torch.zeros_like(h[:1])], 0) * G.mask2dT[None]
    return tr_new, kd_redi
