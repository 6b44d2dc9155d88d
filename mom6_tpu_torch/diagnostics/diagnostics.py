"""The coupler-facing surface state and the diagnostics the catalog reads
(twin of mom6_tpu/diagnostics/diagnostics.py: extract_surface_state, the
role of src/core/MOM.F90 extract_surface_state :3954; kinetic_energy_3d,
ke_budget and column_speed).

In the non-Boussinesq mode, given the EOS, the surface height is the
geometric one (find_eta_nonbouss).  On a tripolar fold the v faces south of row 0 are read as the southern wall
(``v_south``), where the reference's kinetic_energy_3d, ke_budget and
column_speed read the fold row through the wrap; the two agree wherever
row 0 is land, as on every global grid of the repo.

The spatial means (global_area_mean, zonal_mean, meridional_mean,
global_layer_mean, global_volume_mean, global_mass_integral; the role of
MOM_spatial_means.F90) copy their fields to the host as float64 numpy and
do the reference's numpy arithmetic there: the products are single
float64 multiplications, the global sums the exact reproducing sum
(framework/repro_sum.py) and the zonal and meridional sums numpy's
pairwise ``sum``, so a field on the card gives the CPU's number to the
bit, and the reference's below 2^17 elements, where its reproducing sum
is exact too.  They run at the diagnostics' cadence, not in a step."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mom6_tpu_torch.framework.arith import csqrt, sdiv, vsum
from mom6_tpu_torch.framework.repro_sum import reproducing_sum
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jm1_s0, jp1

__all__ = ["SurfaceState", "extract_surface_state", "kinetic_energy_3d",
           "ke_budget", "column_speed", "v_south", "global_area_mean",
           "zonal_mean", "meridional_mean", "global_layer_mean",
           "global_volume_mean", "global_mass_integral"]


class SurfaceState(NamedTuple):
    """The fields a coupler consumes (MOM6's ``surface`` type)."""
    sst: torch.Tensor          # [degC], averaged over HMIX_SFC
    sss: torch.Tensor          # [ppt]
    ssh: torch.Tensor          # [m]
    u_sfc: torch.Tensor        # surface velocity at h points [m s-1]
    v_sfc: torch.Tensor        # (averaged over HMIX_UV_SFC)
    speed: torch.Tensor
    mld: Optional[torch.Tensor] = None
    # heat available to melt ice, -rho0 cp Int_0^HMIX (T - T_freeze) dz
    # [J m-2] <= 0
    melt_potential: Optional[torch.Tensor] = None
    ocean_mass: Optional[torch.Tensor] = None   # column mass [kg m-2]
    ocean_heat: Optional[torch.Tensor] = None   # [degC kg m-2]
    ocean_salt: Optional[torch.Tensor] = None   # [kgSalt m-2]
    frazil: Optional[torch.Tensor] = None       # accrued frazil heat [J m-2]


def _top_average(w3, h, depth: float):
    """Thickness-weighted mean of a 3-D field over the top ``depth``
    metres of water."""
    z_top = torch.cumsum(h, dim=0) - h
    ov = torch.clamp(z_top + h, max=depth) - torch.clamp(z_top, max=depth)
    return vsum(w3 * ov) / torch.clamp(vsum(ov), min=1e-6)


def extract_surface_state(state, G, GV, *, hmix_sfc: float = 0.0,
                          hmix_uv_sfc: float = 0.0, tfreeze_fn=None,
                          cp: float = 3991.87, frazil=None,
                          eos=None) -> SurfaceState:
    """T/S averaged over HMIX_SFC (0: the top layer), velocities over
    HMIX_UV_SFC, the melt potential over the same depth (1 m without
    HMIX_SFC) from the surface freezing point ``tfreeze_fn(S, p)`` (the
    TFREEZE_FORM of eos/tfreeze.py; without it the linear TFREEZE_S0_P
    default), the column mass, heat and salt, and ``frazil`` [J m-2]
    passed through.  With ``eos`` and a non-Boussinesq ``GV`` the
    surface height is the geometric, steric one."""
    h = state.h
    if not GV.boussinesq and eos is not None and state.T is not None:
        from mom6_tpu_torch.core.pressure_force import find_eta_nonbouss
        eta = find_eta_nonbouss(h, state.T, state.S, G, GV, eos)
    else:
        eta = vsum(h) - G.bathyT
    if hmix_uv_sfc > 0.0:
        h_u = 0.5 * (h + ip1(h))
        h_v = 0.5 * (h + jp1(h))
        u_f = _top_average(state.u, h_u, hmix_uv_sfc)
        v_f = _top_average(state.v, h_v, hmix_uv_sfc)
    else:
        u_f, v_f = state.u[0], state.v[0]
    u_c = 0.5 * (u_f + im1(u_f))
    v_c = 0.5 * (v_f + jm1(v_f))
    if state.T is not None and hmix_sfc > 0.0:
        sst = _top_average(state.T, h, hmix_sfc)
        sss = _top_average(state.S, h, hmix_sfc)
    else:
        sst = state.T[0] if state.T is not None else torch.zeros_like(eta)
        sss = state.S[0] if state.S is not None else torch.zeros_like(eta)
    melt_pot = ocean_heat = ocean_salt = None
    ocean_mass = GV.rho0 * vsum(h) * G.mask2dT
    if state.T is not None:
        ocean_heat = GV.rho0 * vsum(h * state.T) * G.mask2dT
        ocean_salt = GV.rho0 * 1e-3 * vsum(h * state.S) * G.mask2dT
        depth_ml = hmix_sfc if hmix_sfc > 0.0 else 1.0
        if tfreeze_fn is not None:
            t_fr = tfreeze_fn(sss, torch.zeros_like(sss))
        else:
            t_fr = -0.054 * sss
        z_top = torch.cumsum(h, dim=0) - h
        ov = torch.clamp(z_top + h, max=depth_ml) \
            - torch.clamp(z_top, max=depth_ml)
        delT = vsum((state.T - t_fr[None]) * ov)
        melt_pot = -GV.rho0 * cp * torch.clamp(delT, min=0.0) * G.mask2dT
    return SurfaceState(
        sst=sst * G.mask2dT, sss=sss * G.mask2dT, ssh=eta * G.mask2dT,
        u_sfc=u_c * G.mask2dT, v_sfc=v_c * G.mask2dT,
        speed=csqrt(u_c * u_c + v_c * v_c) * G.mask2dT,
        melt_potential=melt_pot, ocean_mass=ocean_mass,
        ocean_heat=ocean_heat, ocean_salt=ocean_salt, frazil=frazil)


def v_south(a, G):
    """The value at the v face south of each cell: jm1, with the wrapped
    row at j = 0 zeroed on a tripolar fold, whose top row of faces is the
    fold and not the southern edge."""
    return jm1_s0(a, getattr(G, "fold_north", False))


def kinetic_energy_3d(state, G):
    """Kinetic energy per unit mass at h points, per layer [m2 s-2]
    (MOM_diagnostics' KE)."""
    u2 = 0.5 * (state.u ** 2 + im1(state.u) ** 2)
    v2 = 0.5 * (state.v ** 2 + v_south(state.v, G) ** 2)
    return 0.5 * (u2 + v2) * G.mask2dT[None]


def ke_budget(state_old, state_new, accel, G, dt: float):
    """The kinetic-energy budget term by term, h u·accel averaged to h
    points [m3 s-3] (KE_CorAdv, KE_PG, KE_horvisc, KE_visc and KE_BT of
    MOM_diagnostics.F90 calculate_energy_diagnostics), with the new
    velocities; dKE_dt, the actual change, and KE_residual, its
    difference from the sum of the terms.  ``accel``: the AccelDiag of
    ``step_dynamics_split_rk2(..., return_accel=True)``."""
    h, u, v = state_new.h, state_new.u, state_new.v
    kh = "h" if getattr(G, "fold_north", False) else None
    h_u = 0.5 * (h + ip1(h)) * G.mask2dCu
    h_v = 0.5 * (h + jp1(h, kh)) * G.mask2dCv

    def t2h(fu, fv):
        ku = h_u * u * fu
        kv = h_v * v * fv
        return (0.5 * (ku + im1(ku)) + 0.5 * (kv + v_south(kv, G))) \
            * G.mask2dT[None]

    terms = {
        "KE_CorAdv": t2h(accel.CAu, accel.CAv),
        "KE_PG": t2h(accel.PFu, accel.PFv),
        "KE_horvisc": t2h(accel.diffu, accel.diffv),
        "KE_visc": t2h(accel.du_dt_visc, accel.dv_dt_visc),
        "KE_BT": t2h(accel.u_bt_accel, accel.v_bt_accel),
    }
    ke_new = state_new.h * kinetic_energy_3d(state_new, G)
    ke_old = state_old.h * kinetic_energy_3d(state_old, G)
    terms["dKE_dt"] = sdiv(ke_new - ke_old, dt)
    total = terms["KE_CorAdv"]
    for k in ("KE_PG", "KE_horvisc", "KE_visc", "KE_BT"):
        total = total + terms[k]
    terms["KE_residual"] = terms["dKE_dt"] - total
    return terms


def column_speed(state, G):
    """The speed of the depth-mean current [m s-1]."""
    h = state.h
    col = torch.clamp(vsum(h), min=1e-10)
    u_c = 0.5 * (state.u + im1(state.u))
    v_c = 0.5 * (state.v + v_south(state.v, G))
    ub = vsum(h * u_c) / col
    vb = vsum(h * v_c) / col
    return csqrt(ub * ub + vb * vb) * G.mask2dT


def _f64(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _wet_area(G) -> np.ndarray:
    return _f64(G.areaT) * _f64(G.mask2dT)


def global_area_mean(field, G, h=None) -> float:
    """The area-weighted (with ``h``, thickness-weighted) global mean,
    order-invariant (MOM_spatial_means.F90 global_area_mean)."""
    area = _wet_area(G)
    f = _f64(field)
    if h is not None:
        w = _f64(h) * area[None]
        return reproducing_sum(f * w) / max(reproducing_sum(w), 1e-300)
    return reproducing_sum(f * area) / max(reproducing_sum(area), 1e-300)


def zonal_mean(field, G) -> np.ndarray:
    """The wet-area-weighted zonal (x) mean, (ny,) or (nz, ny)."""
    area = _wet_area(G)
    num = (_f64(field) * area).sum(axis=-1)
    return num / np.maximum(area.sum(axis=-1), 1e-300)


def meridional_mean(field, G) -> np.ndarray:
    """The wet-area-weighted meridional (y) mean, (nx,) or (nz, nx)."""
    area = _wet_area(G)
    num = (_f64(field) * area).sum(axis=-2)
    return num / np.maximum(area.sum(axis=-2), 1e-300)


def global_layer_mean(field, h, G) -> np.ndarray:
    """The thickness-weighted global mean of each layer, (nz,),
    order-invariant (MOM_spatial_means.F90 global_layer_mean)."""
    f = _f64(field)
    w = _f64(h) * _wet_area(G)[None]
    return np.array([reproducing_sum(f[k] * w[k])
                     / max(reproducing_sum(w[k]), 1e-300)
                     for k in range(f.shape[0])])


def global_volume_mean(field, h, G) -> float:
    """The volume-weighted global mean over the whole ocean
    (MOM_spatial_means.F90 global_volume_mean)."""
    return global_area_mean(field, G, h=h)


def global_mass_integral(h, G, field=None, rho0: float = 1035.0) -> float:
    """The ocean's mass [kg], or the mass-weighted integral of ``field``
    (MOM_spatial_means.F90 global_mass_integral), order-invariant."""
    w = _f64(h) * _wet_area(G)[None] * rho0
    if field is None:
        return reproducing_sum(w)
    return reproducing_sum(_f64(field) * w)
