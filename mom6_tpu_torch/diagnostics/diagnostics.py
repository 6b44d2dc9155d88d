"""The coupler-facing surface state and the diagnostics the catalog reads
(twin of mom6_tpu/diagnostics/diagnostics.py: extract_surface_state, the
role of src/core/MOM.F90 extract_surface_state :3954; kinetic_energy_3d,
ke_budget and column_speed).

In the non-Boussinesq mode, given the EOS, the surface height is the
geometric one (find_eta_nonbouss).  On a tripolar fold the v faces south of row 0 are read as the southern wall
(``v_south``), where the reference's kinetic_energy_3d, ke_budget and
column_speed read the fold row through the wrap; the two agree wherever
row 0 is land, as on every global grid of the repo.  The global and
zonal means of the reference's module are not ported."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mom6_tpu_torch.framework.arith import csqrt, sdiv, vsum
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jm1_s0, jp1

__all__ = ["SurfaceState", "extract_surface_state", "kinetic_energy_3d",
           "ke_budget", "column_speed", "v_south"]


class SurfaceState(NamedTuple):
    """The fields a coupler consumes (MOM6's ``surface`` type)."""
    sst: torch.Tensor          # [degC], averaged over HMIX_SFC
    sss: torch.Tensor          # [ppt]
    ssh: torch.Tensor          # [m]
    u_sfc: torch.Tensor        # surface velocity at h points [m s-1]
    v_sfc: torch.Tensor        # (averaged over HMIX_UV_SFC)
    speed: torch.Tensor
    # heat available to melt ice, -rho0 cp Int_0^HMIX (T - T_freeze) dz
    # [J m-2] <= 0
    melt_potential: Optional[torch.Tensor] = None
    ocean_mass: Optional[torch.Tensor] = None   # column mass [kg m-2]
    ocean_heat: Optional[torch.Tensor] = None   # [degC kg m-2]
    ocean_salt: Optional[torch.Tensor] = None   # [kgSalt m-2]


def _top_average(w3, h, depth: float):
    """Thickness-weighted mean of a 3-D field over the top ``depth``
    metres of water."""
    z_top = torch.cumsum(h, dim=0) - h
    ov = torch.clamp(z_top + h, max=depth) - torch.clamp(z_top, max=depth)
    return vsum(w3 * ov) / torch.clamp(vsum(ov), min=1e-6)


def extract_surface_state(state, G, GV, *, hmix_sfc: float = 0.0,
                          hmix_uv_sfc: float = 0.0,
                          cp: float = 3991.87, eos=None) -> SurfaceState:
    """T/S averaged over HMIX_SFC (0: the top layer), velocities over
    HMIX_UV_SFC, the melt potential over the same depth from the linear
    freezing temperature (the TFREEZE_S0_P default), and the column
    mass, heat and salt.  With ``eos`` and a non-Boussinesq ``GV`` the
    surface height is the geometric, steric one."""
    h = state.h
    if not GV.boussinesq and eos is not None and state.T is not None:
        from mom6_tpu_torch.core.pressure_force import find_eta_nonbouss
        eta = find_eta_nonbouss(h, state.T, state.S, G, GV, eos)
    else:
        eta = vsum(h) - G.bathyT
    if hmix_uv_sfc > 0.0:
        h_u = 0.5 * (h + torch.roll(h, -1, -1))
        h_v = 0.5 * (h + torch.roll(h, -1, -2))
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
        ocean_heat=ocean_heat, ocean_salt=ocean_salt)


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
