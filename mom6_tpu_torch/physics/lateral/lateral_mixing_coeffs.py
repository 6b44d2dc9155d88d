"""Variable lateral mixing coefficients, VarMix
(twin of mom6_tpu/physics/lateral/lateral_mixing_coeffs.py).

* :func:`calc_resoln_function`: how well the first-mode deformation
  radius is resolved,

      Res_fn = dx_term / (dx_term + (Res_coef cg1)^2),
      dx_term = f^2 dx^2 + cg1 beta dx^2,

  (the power-2 form; KH_RES_FN_POWER = 2n raises both terms to the n-th
  power), which scales Kh, KhTh and KhTr under RESOLN_SCALED_*.
* :func:`calc_slope_functions`: the Eady slope-stratification product
  SN = sqrt(sum_k H_geom S2 N2 / depth) at the u and v faces, with the
  squared interface slopes masked where an interface meets the
  topography, for the Visbeck diffusivity KHTH_SLOPE_CFF L^2 SN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_tpu_torch.framework.arith import csqrt, ipow, vcumsum, vsum
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["VarMixParams", "calc_resoln_function", "calc_slope_functions"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class VarMixParams:
    resoln_scaled_kh: bool = False      # RESOLN_SCALED_KH
    resoln_scaled_khth: bool = False    # RESOLN_SCALED_KHTH
    resoln_scaled_khtr: bool = False    # RESOLN_SCALED_KHTR
    use_visbeck: bool = False           # USE_VISBECK
    res_coef: float = 1.0               # KH_RES_SCALE_COEF
    res_fn_power: int = 2               # KH_RES_FN_POWER (even)
    khth_slope_cff: float = 0.0         # KHTH_SLOPE_CFF
    khtr_slope_cff: float = 0.0         # KHTR_SLOPE_CFF
    visbeck_l_scale: float = 0.0        # VISBECK_L_SCALE [m]


def _f2_beta(G):
    """f^2 at h points (the mean of the four corners) and |grad f|."""
    f_q = G.CoriolisBu
    f2 = 0.25 * ((f_q ** 2 + im1(jm1(f_q ** 2)))
                 + (im1(f_q ** 2) + jm1(f_q ** 2)))
    dfdx = (f_q - im1(f_q)) * G.IdxT
    dfdy = (f_q - jm1(f_q)) * G.IdyT
    return f2, csqrt(dfdx * dfdx + dfdy * dfdy)


def calc_resoln_function(cg1, G, p: VarMixParams):
    """Res_fn (ny, nx) at h points from the first-mode speed cg1."""
    f2, beta = _f2_beta(G)
    dx2 = G.dxT * G.dyT
    dx_term = f2 * dx2 + cg1 * beta * dx2
    if p.res_fn_power == 2:
        return dx_term / (dx_term + (p.res_coef * cg1) ** 2 + _EPS)
    dt_p = ipow(dx_term, p.res_fn_power // 2)
    return dt_p / (dt_p + ipow(p.res_coef * cg1, p.res_fn_power) + _EPS)


def calc_slope_functions(h, G, GV, p: VarMixParams,
                         e: Optional[torch.Tensor] = None,
                         n2_int: Optional[torch.Tensor] = None):
    """(SN_u, SN_v) [s-1] at the u and v faces.  ``e``: the interface
    heights (nz+1, ny, nx), positive up (from h and the bathymetry when
    None); ``n2_int``: N^2 at the interior interfaces (nz-1, ny, nx),
    else g'_K / max(Hdn, Hup) from the layered reduced gravities."""
    nz = h.shape[0]
    h_neglect = GV.h_subroundoff
    h_cutoff = 2.0 * nz * (GV.angstrom + h_neglect)
    if e is None:
        csum_below = torch.flip(vcumsum(torch.flip(h, (0,))), (0,))
        e = torch.cat([csum_below, torch.zeros_like(h[:1])], dim=0) \
            - G.bathyT[None]
    eK = e[1:nz]
    ex = (ip1(eK) - eK) * G.IdxCu
    ey = (jp1(eK, "h" if getattr(G, "fold_north", False) else None)
          - eK) * G.IdyCv
    h_up, h_dn = h[:-1], h[1:]
    thin_u = (torch.minimum(torch.minimum(h_up, ip1(h_up)),
                            torch.minimum(h_dn, ip1(h_dn))) < h_cutoff)
    thin_v = (torch.minimum(torch.minimum(h_up, jp1(h_up)),
                            torch.minimum(h_dn, jp1(h_dn))) < h_cutoff)
    ex = torch.where(thin_u, 0.0, ex) * G.mask2dCu
    ey = torch.where(thin_v, 0.0, ey) * G.mask2dCv
    ex2, ey2 = ex * ex, ey * ey
    s2_u = ex2 + 0.25 * ((ey2 + ip1(jm1(ey2))) + (ip1(ey2) + jm1(ey2)))
    s2_v = ey2 + 0.25 * ((ex2 + im1(jp1(ex2))) + (jp1(ex2) + im1(ex2)))
    hdn = 2.0 * h_dn * h_up / (h_dn + h_up + h_neglect)
    hdn_u, hup_u = hdn, ip1(hdn)
    hdn_v, hup_v = hdn, jp1(hdn)
    hgeom_u = csqrt(hdn_u * hup_u)
    hgeom_v = csqrt(hdn_v * hup_v)
    if n2_int is not None:
        n2_u = 0.5 * (n2_int + ip1(n2_int))
        n2_v = 0.5 * (n2_int + jp1(n2_int))
        s2n2_u = hgeom_u * s2_u * torch.clamp(n2_u, min=0.0)
        s2n2_v = hgeom_v * s2_v * torch.clamp(n2_v, min=0.0)
    else:
        gp = GV.g_prime[1:nz, None, None]
        s2n2_u = hgeom_u * s2_u * gp \
            / torch.clamp(torch.maximum(hdn_u, hup_u), min=1e-3)
        s2n2_v = hgeom_v * s2_v * gp \
            / torch.clamp(torch.maximum(hdn_v, hup_v), min=1e-3)
    depth_u = torch.clamp(torch.maximum(G.bathyT, ip1(G.bathyT)), min=1e-3)
    depth_v = torch.clamp(torch.maximum(G.bathyT, jp1(G.bathyT)), min=1e-3)
    sn_u = csqrt(vsum(s2n2_u) / depth_u) * G.mask2dCu
    sn_v = csqrt(vsum(s2n2_v) / depth_v) * G.mask2dCv
    return sn_u, sn_v
