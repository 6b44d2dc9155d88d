"""Hydrostatic pressure force (twin of mom6_tpu/core/pressure_force.py:
find_eta, pressure_force_montgomery for the layered stack, the
Boussinesq finite-volume form pressure_force_fv with a full EOS, and the
non-Boussinesq one, pressure_force_fv_nonbous, in pressure coordinates
with specific-volume integrals, with spv_avg, geometric_to_mass_h and
the geometric free surface find_eta_nonbouss).

    M_1 = g'_1 e_1,  M_k = M_{k-1} + g'_k e_k,   PF_k = -grad M_k

``pbce`` is the sensitivity of each layer's pressure force to the free
surface (Set_pbce_Bouss, non-EOS branch) and ``eta_PF`` the free surface
used, so btstep can form pressure-force anomalies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mom6_tpu_torch.ale.remapping import _plm_slopes
from mom6_tpu_torch.framework.arith import sdiv, vcumsum, vsum
from mom6_tpu_torch.framework.stencil import ip1, jp1

__all__ = ["PressureForceOut", "find_eta", "pressure_force_montgomery",
           "pressure_force_fv", "pressure_force_fv_nonbous", "spv_avg",
           "geometric_to_mass_h", "find_eta_nonbouss"]


class PressureForceOut(NamedTuple):
    PFu: torch.Tensor      # (nz, ny, nx) zonal accel [m s-2]
    PFv: torch.Tensor
    pbce: torch.Tensor     # (nz, ny, nx) d(accel)/d(eta)
    eta_PF: torch.Tensor   # (ny, nx) free surface used [m]


def find_eta(h, G):
    """Free-surface height (positive up) from thicknesses and bathymetry."""
    return vsum(h) - G.bathyT


def pressure_force_montgomery(h, G, GV, e_tidal=None) -> PressureForceOut:
    """Montgomery-potential pressure force of the layered stack."""
    # e[k] = top interface of layer k = -D + sum_{m>=k} h_m
    csum_below = torch.flip(torch.cumsum(torch.flip(h, (0,)), dim=0), (0,))
    e = csum_below - G.bathyT[None]
    if e_tidal is not None:
        e = e - e_tidal[None]
    gp = GV.g_prime[:, None, None]
    M = torch.cumsum(gp * e, dim=0)
    pfu = -(ip1(M) - M) * G.IdxCu * G.mask2dCu
    kh = "h" if getattr(G, "fold_north", False) else None
    pfv = -(jp1(M, kh) - M) * G.IdyCv * G.mask2dCv
    # a free-surface rise d(eta) moves interface K by
    # d(eta)*(e_K - e_bot)/htot; layer k's potential gains the g'-weighted
    # sum of those moves above it
    e_bot = e[0] - vsum(h)
    ihtot = 1.0 / torch.clamp(e[0] - e_bot, min=1e-10)
    frac = (e - e_bot[None]) * ihtot[None]
    frac[0] = 1.0                        # frac is a fresh tensor
    pbce = torch.cumsum(gp * frac, dim=0)
    return PressureForceOut(pfu, pfv, pbce.to(h.dtype), e[0])


# Boole's rule weights for 5-point quadrature over 4 equal intervals
_BOOLE = (7.0 / 90.0, 32.0 / 90.0, 12.0 / 90.0, 32.0 / 90.0, 7.0 / 90.0)
_H_NEGLECT = 1e-10


def _dpa_column(T, S, e_t, e_b, g, rho0, eos, dT=None, dS=None):
    """Pressure-anomaly change through a layer and its in-layer integral
    (int_density_dz): the EOS's analytic integral where it has one and
    T/S are layer-constant, else 5-point Boole quadrature of
    g*(rho(T, S, p(z)) - rho0) with T(z) = T + dT*(zfrac - 1/2) under a
    PLM reconstruction.  Returns (dpa = pa(e_b) - pa(e_t) [Pa],
    intz_dpa [Pa m])."""
    if dT is None and eos.int_density_dz is not None:
        return eos.int_density_dz(T, S, e_t, e_b, g, rho0, rho_ref=rho0)
    dz = e_t - e_b
    gxrho = g * rho0
    rho5 = []
    for n in range(5):
        z_n = e_t - (n / 4.0) * dz
        p_n = -gxrho * z_n
        T_n = T if dT is None else T + dT * (n / 4.0 - 0.5)
        S_n = S if dS is None else S + dS * (n / 4.0 - 0.5)
        rho5.append(eos.density(T_n, S_n, p_n, rho_ref=rho0))
    dpa = (g * dz) * sum(w * r for w, r in zip(_BOOLE, rho5))
    # pa(z) - pa(e_t) at the 5 points by the trapezoid rule
    pa_rel = [torch.zeros_like(dpa)]
    for n in range(1, 5):
        pa_rel.append(pa_rel[-1] + (g * dz / 8.0) * (rho5[n - 1] + rho5[n]))
    intz = dz * sum(w * p for w, p in zip(_BOOLE, pa_rel))
    return dpa, intz


def _dpa_face(T_l, S_l, T_r, S_r, et_l, eb_l, et_r, eb_r, dpa_l, dpa_r,
              bathy_l, bathy_r, g, rho0, eos, dT_l=None, dT_r=None,
              dS_l=None, dS_r=None):
    """Integral along a face of the pressure-anomaly change through a
    layer: the end points reuse the column integrals, 3 interior points
    interpolate geometry and properties, Boole-combined.  Properties are
    mass-weighted toward the thicker column where one side's layer lies
    below the other side's bathymetry (the hWght guard)."""
    eps = _H_NEGLECT
    hL = (et_l - eb_l) + eps
    hR = (et_r - eb_r) + eps
    hwght = torch.clamp(torch.maximum(-bathy_l - et_r, -bathy_r - et_l),
                        min=0.0)
    hwght = hwght * ((hL - hR) / (hL + hR)) ** 2
    iden = 1.0 / (hwght * (hR + hL) + hL * hR)
    hwt_ll = (hwght * hL + hR * hL) * iden
    hwt_lr = (hwght * hR) * iden
    hwt_rr = (hwght * hR + hR * hL) * iden
    hwt_rl = (hwght * hL) * iden

    total = _BOOLE[0] * dpa_l + _BOOLE[4] * dpa_r
    for m in (1, 2, 3):
        w = m / 4.0
        wt_l, wt_r = 1.0 - w, w
        wtt_l = wt_l * hwt_ll + wt_r * hwt_rl
        wtt_r = wt_l * hwt_lr + wt_r * hwt_rr
        T_m = wtt_l * T_l + wtt_r * T_r
        S_m = wtt_l * S_l + wtt_r * S_r
        et_m = wt_l * et_l + wt_r * et_r
        eb_m = wt_l * eb_l + wt_r * eb_r
        dT_m = (wtt_l * dT_l + wtt_r * dT_r) if dT_l is not None else None
        dS_m = (wtt_l * dS_l + wtt_r * dS_r) if dS_l is not None else None
        dpa_m, _ = _dpa_column(T_m, S_m, et_m, eb_m, g, rho0, eos,
                               dT=dT_m, dS=dS_m)
        total = total + _BOOLE[m] * dpa_m
    return total


def pressure_force_fv(h, T, S, G, GV, eos, p_surf=None, e_tidal=None,
                      varT=None, plm_ts: bool = False) -> PressureForceOut:
    """Boussinesq finite-volume pressure gradient with a full EOS
    (PressureForce_FV_Bouss).  Per layer k at a u face:

      PFu = [ (pa_i h_i + intz_i) - (pa_{i+1} h_{i+1} + intz_{i+1})
              + (h_{i+1} - h_i) intx_pa(K)
              - (e_{i+1,K+1} - e_{i,K+1}) intx_dpa(k) ]
            * 2 / (rho0 dx (h_i + h_{i+1}))

    ``plm_ts`` samples T/S from a PLM reconstruction inside each layer
    (RECONSTRUCT_FOR_PRESSURE).  The tidal geopotential ``e_tidal`` and
    the Stanley variance ``varT`` are not ported."""
    if e_tidal is not None:
        raise NotImplementedError("pressure_force_fv: e_tidal is not ported")
    if varT is not None:
        raise NotImplementedError("pressure_force_fv: varT (Stanley) is not "
                                  "ported")
    g = GV.g_earth
    rho0 = GV.rho0
    # interface heights, positive up: e[K] for K = 0..nz
    csum_below = torch.flip(torch.cumsum(torch.flip(h, (0,)), dim=0), (0,))
    e = torch.cat([csum_below, torch.zeros_like(h[:1])], dim=0) \
        - G.bathyT[None]
    e_t, e_b = e[:-1], e[1:]
    dT = dS = None
    if plm_ts:
        dT = _plm_slopes(T, h)
        dS = _plm_slopes(S, h)
    dpa, intz_dpa = _dpa_column(T, S, e_t, e_b, g, rho0, eos, dT=dT, dS=dS)

    pa_top = g * rho0 * e[0]
    if p_surf is not None:
        pa_top = pa_top + p_surf
    pa = torch.cat([pa_top[None], pa_top[None] + torch.cumsum(dpa, dim=0)],
                   dim=0)
    i_rho0 = 1.0 / rho0

    def pf_dir(roll_fn, idx_metric, mask_face):
        intx_dpa = _dpa_face(
            T, S, roll_fn(T), roll_fn(S), e_t, e_b, roll_fn(e_t),
            roll_fn(e_b), dpa, roll_fn(dpa), G.bathyT[None],
            roll_fn(G.bathyT)[None], g, rho0, eos, dT_l=dT,
            dT_r=roll_fn(dT) if dT is not None else None, dS_l=dS,
            dS_r=roll_fn(dS) if dS is not None else None)
        intx_pa_top = 0.5 * (pa[0] + roll_fn(pa[0]))
        intx_pa = torch.cat([intx_pa_top[None], intx_pa_top[None]
                             + torch.cumsum(intx_dpa, dim=0)], dim=0)
        h_r = roll_fn(h)
        pf = (((pa[:-1] * h + intz_dpa)
               - (roll_fn(pa[:-1]) * h_r + roll_fn(intz_dpa)))
              + ((h_r - h) * intx_pa[:-1]
                 - (roll_fn(e_b) - e_b) * intx_dpa)) \
            * (2.0 * i_rho0 * idx_metric) / ((h + h_r) + _H_NEGLECT)
        # no massless-face gate: the hWght face integral is the guard,
        # and the form telescopes exactly at rest
        return pf * mask_face

    kh = "h" if getattr(G, "fold_north", False) else None
    pfu = pf_dir(ip1, G.IdxCu, G.mask2dCu)
    pfv = pf_dir(lambda a: jp1(a, kh), G.IdyCv, G.mask2dCv)

    # pbce with the stratification's response to column stretching
    # (Set_pbce_Bouss, EOS branch)
    g_rho0 = g / rho0
    htot = torch.clamp(e[0] - e[-1], min=1e-10)
    p_sfc = -g * rho0 * e[0]
    rho_sfc = rho0 + eos.density(T[0], S[0], p_sfc, rho_ref=rho0)
    pbce1 = (g_rho0 * rho_sfc)[None]
    t_i = 0.5 * (T[:-1] + T[1:])
    s_i = 0.5 * (S[:-1] + S[1:])
    p_i = -g * rho0 * e[1:-1]
    dr_dt, dr_ds = eos.density_derivs(t_i, s_i, p_i)
    frac = (e[1:-1] - e[-1][None]) / htot[None]
    dpbce = g_rho0 * frac * (dr_dt * (T[1:] - T[:-1])
                             + dr_ds * (S[1:] - S[:-1]))
    pbce = torch.cumsum(torch.cat([pbce1, dpbce], dim=0), dim=0)
    return PressureForceOut(pfu, pfv, pbce.to(h.dtype), e[0])


# --- the non-Boussinesq mode: h is mass / RHO_0 ----------------------------

def _vcumsum_up(x):
    """The running sum along axis 0 from the bottom up."""
    return torch.flip(vcumsum(torch.flip(x, (0,))), (0,))


def _interface_pressure(dp, p_surf=None):
    """(nz+1, ...) pressures from the top pressure down the layers."""
    p_top = torch.zeros_like(dp[:1]) if p_surf is None else p_surf[None]
    return torch.cat([p_top, p_top + vcumsum(dp)], dim=0)


def _dza_column(T, S, p_t, p_b, alpha_ref, eos):
    """The geopotential-anomaly change through a layer of constant T and
    S and its integral in pressure (int_spec_vol_dp, PCM): 5-point Boole
    quadrature of alpha(T, S, p) - alpha_ref over [p_t, p_b].  Returns
    (dza = za(p_t) - za(p_b), intp_dza = int (za(p) - za(p_b)) dp)."""
    dp = p_b - p_t
    a5 = [eos.specific_volume(T, S, p_t + (n / 4.0) * dp, spv_ref=alpha_ref)
          for n in range(5)]
    dza = dp * sum(w * a for w, a in zip(_BOOLE, a5))
    za_rel = [torch.zeros_like(dza)]
    for n in range(3, -1, -1):
        za_rel.insert(0, za_rel[0] + (dp / 8.0) * (a5[n] + a5[n + 1]))
    return dza, dp * sum(w * z for w, z in zip(_BOOLE, za_rel))


def _dza_face(T_l, S_l, T_r, S_r, pt_l, pb_l, pt_r, pb_r, dza_l, dza_r,
              pbot_l, pbot_r, alpha_ref, eos):
    """The integral along a face of the geopotential-anomaly change
    through a layer (the dual of _dpa_face, with the hWght guard in
    pressure)."""
    eps = 1e-3
    hL = (pb_l - pt_l) + eps
    hR = (pb_r - pt_r) + eps
    hwght = torch.clamp(torch.maximum(pb_r - pbot_l, pb_l - pbot_r), min=0.0)
    hwght = hwght * ((hL - hR) / (hL + hR)) ** 2
    iden = 1.0 / (hwght * (hR + hL) + hL * hR)
    hwt_ll = (hwght * hL + hR * hL) * iden
    hwt_lr = (hwght * hR) * iden
    hwt_rr = (hwght * hR + hR * hL) * iden
    hwt_rl = (hwght * hL) * iden
    total = _BOOLE[0] * dza_l + _BOOLE[4] * dza_r
    for m in (1, 2, 3):
        w = m / 4.0
        wt_l, wt_r = 1.0 - w, w
        wtt_l = wt_l * hwt_ll + wt_r * hwt_rl
        wtt_r = wt_l * hwt_lr + wt_r * hwt_rr
        dza_m, _ = _dza_column(wtt_l * T_l + wtt_r * T_r,
                               wtt_l * S_l + wtt_r * S_r,
                               wt_l * pt_l + wt_r * pt_r,
                               wt_l * pb_l + wt_r * pb_r, alpha_ref, eos)
        total = total + _BOOLE[m] * dza_m
    return total


def spv_avg(h, T, S, GV, eos, p_surf=None):
    """The layer-mean in-situ specific volume [m3 kg-1] at the hydrostatic
    pressures of the mass column ``h`` (rho0-equivalent metres)."""
    dp = GV.g_earth * GV.rho0 * h
    p = _interface_pressure(dp, p_surf)
    dza, _ = _dza_column(T, S, p[:-1], p[1:], 0.0, eos)
    return dza / torch.clamp(dp, min=1e-3)


def geometric_to_mass_h(h_geom, T, S, GV, eos, n_iter: int = 5):
    """Geometric layer thicknesses [m] as h = mass / rho0, the in-situ
    density at each layer's own hydrostatic pressure found by ``n_iter``
    fixed-point steps (convert_thickness)."""
    g = GV.g_earth
    rho = GV.rho0 + eos.density(T, S, torch.zeros_like(T), rho_ref=GV.rho0)
    for _ in range(n_iter):
        p_int = _interface_pressure(g * rho * h_geom)
        p_mid = 0.5 * (p_int[:-1] + p_int[1:])
        rho = GV.rho0 + eos.density(T, S, p_mid, rho_ref=GV.rho0)
    return sdiv(h_geom * rho, GV.rho0)


def find_eta_nonbouss(h, T, S, G, GV, eos, p_surf=None):
    """The geometric free-surface height [m] of a non-Boussinesq column,
    sum_k (rho0 h_k) SpV_avg_k - depth: it rises as the column warms at
    constant mass."""
    dz = (GV.rho0 * h) * spv_avg(h, T, S, GV, eos, p_surf=p_surf)
    return vsum(dz) - G.bathyT


def pressure_force_fv_nonbous(h_mass, T, S, G, GV, eos,
                              p_surf=None) -> PressureForceOut:
    """The non-Boussinesq finite-volume pressure gradient
    (PressureForce_FV_nonBouss), the dual of pressure_force_fv with
    pressure for height and specific volume for density.  ``h_mass``:
    the layers' mass [kg m-2].  Per layer k at a u face:

      PFu = [ (za_b dp + intp_dza)_i - (za_b dp + intp_dza)_{i+1}
              + (dp_{i+1} - dp_i) intx_za(K+1)
              - (p_{i+1,K} - p_{i,K}) intx_dza(k) ]
            * 2 / (dx (dp_i + dp_{i+1}))

    with za = Phi + alpha_ref p accumulated up from the sea floor and
    intx_za down from the surface; faces with less than 20 Pa of mass on
    either side carry no force.  ``pbce`` (Set_pbce_nonBouss) is taken
    per unit of the column-mass free surface ``eta_PF`` = sum h - D."""
    g = GV.g_earth
    alpha_ref = 1.0 / GV.rho0
    dp = g * h_mass
    p = _interface_pressure(dp, p_surf)
    p_t, p_b = p[:-1], p[1:]
    dza, intp_dza = _dza_column(T, S, p_t, p_b, alpha_ref, eos)
    za_bot = -g * G.bathyT + alpha_ref * p[-1]
    za = torch.cat([za_bot[None] + _vcumsum_up(dza), za_bot[None]], dim=0)

    def pf_dir(roll_fn, idx_metric, mask_face):
        intx_dza = _dza_face(T, S, roll_fn(T), roll_fn(S), p_t, p_b,
                             roll_fn(p_t), roll_fn(p_b), dza, roll_fn(dza),
                             p[-1][None], roll_fn(p[-1])[None], alpha_ref,
                             eos)
        intx_za_top = 0.5 * (za[0] + roll_fn(za[0]))
        intx_za = torch.cat([intx_za_top[None],
                             intx_za_top[None] - vcumsum(intx_dza)], dim=0)
        dp_r = roll_fn(dp)
        pf = (((za[1:] * dp + intp_dza)
               - (roll_fn(za[1:]) * dp_r + roll_fn(intp_dza)))
              + ((dp_r - dp) * intx_za[1:]
                 - (roll_fn(p_t) - p_t) * intx_dza)) \
            * (2.0 * idx_metric) / ((dp + dp_r) + 1e-3)
        gate = (torch.minimum(dp, dp_r) > 20.0).to(pf.dtype)
        return pf * gate * mask_face

    kh = "h" if getattr(G, "fold_north", False) else None
    pfu = pf_dir(ip1, G.IdxCu, G.mask2dCu)
    pfv = pf_dir(lambda a: jp1(a, kh), G.IdyCv, G.mask2dCv)

    rho0 = GV.rho0
    g_rho0 = g / rho0
    # geometric interface heights, dz = int alpha dp / g
    dz = sdiv(dza + alpha_ref * dp, g)
    e = torch.cat([_vcumsum_up(dz), torch.zeros_like(dz[:1])], dim=0) \
        - G.bathyT[None]
    htot = torch.clamp(e[0] - e[-1], min=1e-10)
    rho_sfc = rho0 + eos.density(T[0], S[0], p[0], rho_ref=rho0)
    pbce1 = (g_rho0 * rho_sfc)[None]
    t_i = 0.5 * (T[:-1] + T[1:])
    s_i = 0.5 * (S[:-1] + S[1:])
    dr_dt, dr_ds = eos.density_derivs(t_i, s_i, p[1:-1])
    frac = (e[1:-1] - e[-1][None]) / htot[None]
    dpbce = g_rho0 * frac * (dr_dt * (T[1:] - T[:-1])
                             + dr_ds * (S[1:] - S[:-1]))
    pbce = vcumsum(torch.cat([pbce1, dpbce], dim=0))
    alpha_sfc = eos.specific_volume(T[0], S[0], p[0])
    pbce = pbce * (rho0 * alpha_sfc)[None]
    eta_h = sdiv(vsum(h_mass), rho0) - G.bathyT
    return PressureForceOut(pfu, pfv, pbce.to(h_mass.dtype), eta_h)
