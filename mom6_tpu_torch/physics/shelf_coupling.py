"""The ice shelf's coupling to the ocean: its pressure, the melt fluxes
and the trimming of the initial columns
(twin of mom6_tpu/physics/shelf_coupling.py).

With a prescribed shelf mass (the data-override mode of
MOM_ice_shelf.F90):

* the shelf's weight frac g mass joins the surface pressure the
  pressure force sees (add_shelf_pressure);
* under the shelf the surface heat, salt and fresh-water fluxes are cut
  by the open fraction and the three-equation melt's fluxes take their
  place, and the shortwave flux is cut (add_shelf_flux);
* the wind stress is cut by the shelf fraction at the faces;
* at start the columns are trimmed from the top until the weight taken
  off balances the shelf's pressure (trim_for_ice, TRIM_IC_FOR_P_SURF).

All of it is elementwise or a running sum over the layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_tpu_torch.framework.arith import csqrt, vcumsum
from mom6_tpu_torch.framework.containers import TensorDataclass, fields_equal
from mom6_tpu_torch.framework.stencil import ip1, jp1
from mom6_tpu_torch.physics.ice_shelf import (IceShelfParams,
                                              three_equation_melt)

__all__ = ["ShelfCoupling", "apply_shelf_coupling", "shelf_melt_fluxes",
           "trim_columns_for_p_surf"]


@dataclasses.dataclass(frozen=True, eq=False)
class ShelfCoupling(TensorDataclass):
    """A prescribed shelf and its melt parameters.  Two are equal when
    every field is, tensors to the bit."""
    mass_shelf: Optional[torch.Tensor] = None    # (ny, nx) [kg m-2]
    frac_shelf_h: Optional[torch.Tensor] = None  # (ny, nx) area fraction
    melt: IceShelfParams = IceShelfParams()
    flux_factor: float = 1.0       # SHELF_FLUX_FACTOR
    # gamma_T = gam_t_star u*_shelf with u*_shelf = sqrt(cdrag (u_ml^2 +
    # utide^2)) where ustar_dependent, else the constant melt.gamma_t
    ustar_dependent: bool = False
    gam_t_star: float = 0.02
    cdrag_shelf: float = 2.5e-3
    utide: float = 0.0             # [m s-1]

    def __eq__(self, other):
        if not isinstance(other, ShelfCoupling):
            return NotImplemented
        return fields_equal(self, other)


def shelf_melt_fluxes(T_top, S_top, shelf: ShelfCoupling, g_earth: float,
                      u_ml=None):
    """(melt [m ice s-1], heat [W m-2, into the ocean], salt [ppt m s-1],
    water [m s-1 of fresh water]), zero where there is no shelf."""
    p_base = g_earth * shelf.mass_shelf
    mp = shelf.melt
    if shelf.ustar_dependent:
        u2 = shelf.utide ** 2 if u_ml is None else u_ml ** 2 + \
            shelf.utide ** 2
        ustar = csqrt(torch.as_tensor(shelf.cdrag_shelf * u2,
                                      dtype=p_base.dtype,
                                      device=p_base.device))
        gam_t = shelf.gam_t_star * torch.clamp(ustar, min=1e-6)
        # the reference's heat:salt exchange ratio kept
        gam_s = gam_t * (mp.gamma_s / mp.gamma_t)
        mp = mp.replace(gamma_t=gam_t, gamma_s=gam_s)
    melt, heat, salt = three_equation_melt(T_top, S_top, p_base, mp)
    under = shelf.frac_shelf_h > 0.0
    zero = torch.zeros_like(shelf.frac_shelf_h)
    melt = torch.where(under, melt, zero)
    heat = torch.where(under, heat, zero)
    salt = torch.where(under, salt, zero)
    # the melt water in fresh-water metres
    water = melt * (shelf.melt.rho_i / shelf.melt.rho_w)
    return melt, heat, salt, torch.where(under, water, zero)


def apply_shelf_coupling(state, forcing, G, GV, shelf: ShelfCoupling):
    """(forcing with the shelf's pressure and fluxes folded in, melt
    rate)."""
    frac = shelf.frac_shelf_h
    open_frac = torch.clamp(1.0 - frac, min=0.0)
    press_ice = frac * (GV.g_earth * shelf.mass_shelf)
    mech = forcing.mech
    p_surf = press_ice if mech.p_surf is None else mech.p_surf + press_ice
    # the wind stress the shelf intercepts at the faces
    frac_u = torch.clamp(0.5 * (frac + ip1(frac)), max=1.0)
    frac_v = torch.clamp(0.5 * (frac + jp1(frac)), max=1.0)
    mech = mech.replace(
        taux=None if mech.taux is None else mech.taux * (1.0 - frac_u),
        tauy=None if mech.tauy is None else mech.tauy * (1.0 - frac_v),
        p_surf=p_surf,
        u10=None if mech.u10 is None else mech.u10 * open_frac)
    buoy = forcing.buoy
    if state.T is not None:
        u_ml = None
        if shelf.ustar_dependent and state.u is not None:
            u_c = 0.5 * (state.u[0] + ip1(state.u[0]))
            v_c = 0.5 * (state.v[0] + jp1(state.v[0]))
            u_ml = csqrt(u_c * u_c + v_c * v_c)
        melt, heat, salt, water = shelf_melt_fluxes(
            state.T[0], state.S[0], shelf, GV.g_earth, u_ml=u_ml)
        ff = shelf.flux_factor

        def mix(old, shelf_flux):
            if old is None:
                return frac * ff * shelf_flux
            return open_frac * old + frac * ff * shelf_flux
        buoy = buoy.replace(
            heat_flux=mix(buoy.heat_flux, heat),
            salt_flux=mix(buoy.salt_flux, salt),
            fw_flux=mix(buoy.fw_flux, water),
            sw_flux=None if buoy.sw_flux is None
            else open_frac * buoy.sw_flux)
    else:
        melt = torch.zeros_like(frac)
    return forcing.replace(mech=mech, buoy=buoy), melt


def trim_columns_for_p_surf(h, T, S, rho, p_surf, g_earth: float,
                            min_thickness: float = 1e-10):
    """Mass taken off the top of each column until its weight balances
    ``p_surf`` (TRIM_IC_FOR_P_SURF: trim_for_ice, cut_off_column_top),
    with ``rho`` the layers' density; T and S are kept.  Returns
    (h, T, S)."""
    dp = g_earth * rho * h
    p_int = torch.cat([torch.zeros_like(dp[:1]), vcumsum(dp)], dim=0)
    keep = torch.clamp((p_int[1:] - p_surf[None])
                       / torch.clamp(dp, min=1e-30), 0.0, 1.0)
    return torch.clamp(h * keep, min=min_thickness), T, S
