"""Horizontal (lateral) viscosity: Laplacian and biharmonic friction
(twin of mom6_tpu/physics/lateral/hor_visc.py).

Stress-tensor form on the C grid: tension sh_xx at h points, shear sh_xy
at q points (no slip through the q mask), constant and Smagorinsky
coefficients with the explicit stability bound, the Laplacian one
scaled by VarMix's resolution function where given; the biharmonic
operator is the same stress divergence applied to -del2(u).  Leith, QG
Leith, anisotropic viscosity and MEKE backscatter are not ported and
raise.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_tpu_torch.framework.arith import csqrt, rdiv
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["HorViscParams", "horizontal_viscosity"]


@dataclasses.dataclass(frozen=True)
class HorViscParams:
    kh: float = 0.0            # constant Laplacian viscosity [m2 s-1]
    ah: float = 0.0            # constant biharmonic viscosity [m4 s-1]
    smag_lap_const: float = 0.0
    smag_bi_const: float = 0.0
    leith_lap_const: float = 0.0
    use_qg_leith: bool = False
    kh_aniso: float = 0.0      # [m2 s-1], not ported when set
    bound_coef: bool = True
    dt: float = 0.0            # for the stability bound


def _strains(u, v, G):
    """(sh_xx at h, sh_xy at q)."""
    ku = "u" if getattr(G, "fold_north", False) else None
    sh_xx = ((u - im1(u)) * G.IdxT - (v - jm1(v)) * G.IdyT) * G.mask2dT
    sh_xy = ((ip1(v) - v) / G.dxBu + (jp1(u, ku) - u) / G.dyBu) \
        * G.mask2dBu
    return sh_xx, sh_xy


def _stress_accel(h, str_xx, str_xy, G):
    """Thickness-weighted divergence of the stress tensor; h at corners is
    the harmonic mean of the 4 cells, so a vanished neighbour carries no
    corner stress."""
    eps = 1e-10
    kh = "h" if getattr(G, "fold_north", False) else None
    jh = jp1(h, kh)
    h_q = rdiv(4.0, 1.0 / (h + eps) + 1.0 / (ip1(h) + eps)
               + 1.0 / (jh + eps) + 1.0 / (ip1(jh) + eps))
    h_u = torch.clamp(0.5 * (h + ip1(h)), min=1e-3)
    h_v = torch.clamp(0.5 * (h + jh), min=1e-3)
    fx = ((ip1(h * str_xx) - h * str_xx) * G.IdxCu
          + (h_q * str_xy - jm1(h_q * str_xy)) * G.IdyCu)
    fy = (-(jp1(h * str_xx, kh) - h * str_xx) * G.IdyCv
          + (h_q * str_xy - im1(h_q * str_xy)) * G.IdxCv)
    return fx / h_u * G.mask2dCu, fy / h_v * G.mask2dCv


def _coefficients(sh_xx, sh_xy, G, p: HorViscParams):
    """Laplacian and biharmonic coefficients at h points."""
    dx2 = G.dxT * G.dyT
    sh_xy_h = 0.25 * ((sh_xy + im1(sh_xy)) + (jm1(sh_xy) + im1(jm1(sh_xy))))
    shear_mag = csqrt(sh_xx * sh_xx + sh_xy_h * sh_xy_h)
    kh = torch.full_like(sh_xx, p.kh)
    if p.smag_lap_const:
        kh = kh + (p.smag_lap_const ** 2) * dx2 * shear_mag
    ah = torch.full_like(sh_xx, p.ah)
    if p.smag_bi_const:
        ah = ah + (p.smag_bi_const ** 2) * dx2 * dx2 * shear_mag
    if p.bound_coef and p.dt > 0.0:
        # explicit diffusion stability: KH < 1/(4 dt (Idx^2+Idy^2))
        denom = G.IdxT ** 2 + G.IdyT ** 2
        kh = torch.minimum(kh, rdiv(0.2, p.dt * denom))
        ah = torch.minimum(ah, rdiv(0.2, p.dt * denom * denom * 16.0))
    return kh, ah


def horizontal_viscosity(u, v, h, G, p: HorViscParams,
                         ku_backscatter=None, kh_scale=None):
    """Frictional accelerations (diffu, diffv) [m s-2] on (nz, ny, nx)."""
    for name, on in (("leith_lap_const", p.leith_lap_const),
                     ("use_qg_leith", p.use_qg_leith),
                     ("kh_aniso", p.kh_aniso),
                     ("ku_backscatter", ku_backscatter is not None)):
        if on:
            raise NotImplementedError(f"horizontal_viscosity: {name} is "
                                      "not ported")
    sh_xx, sh_xy = _strains(u, v, G)
    kh_h, ah_h = _coefficients(sh_xx, sh_xy, G, p)
    if kh_scale is not None:
        # VarMix's resolution function (RESOLN_SCALED_KH)
        kh_h = kh_h * kh_scale
    kfold = "h" if getattr(G, "fold_north", False) else None
    diffu = torch.zeros_like(u)
    diffv = torch.zeros_like(v)
    if p.kh or p.smag_lap_const:
        jkh = jp1(kh_h, kfold)
        kh_q = 0.25 * ((kh_h + ip1(kh_h)) + (jkh + ip1(jkh)))
        du, dv = _stress_accel(h, kh_h * sh_xx, kh_q * sh_xy, G)
        diffu = diffu + du
        diffv = diffv + dv
    if p.ah or p.smag_bi_const:
        lap_u, lap_v = _stress_accel(h, sh_xx, sh_xy, G)
        sh2_xx, sh2_xy = _strains(lap_u, lap_v, G)
        jah = jp1(ah_h, kfold)
        ah_q = 0.25 * ((ah_h + ip1(ah_h)) + (jah + ip1(jah)))
        du, dv = _stress_accel(h, ah_h * sh2_xx, ah_q * sh2_xy, G)
        diffu = diffu - du     # biharmonic: minus the double Laplacian
        diffv = diffv - dv
    return diffu, diffv
