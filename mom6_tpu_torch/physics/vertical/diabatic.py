"""Diabatic column physics
(twin of mom6_tpu/physics/vertical/diabatic.py: diabatic_ale and
diabatic_layered).

ALE mode (diabatic_ale):
  geothermal heating of each column's deepest massive layer
  -> set_diffusivity (background / BBL mixing / Bryan-Lewis + the extras
     passed in)
  -> surface heat, salt and fresh-water fluxes, restoring and the
     shortwave flux without an opacity profile, into the top layer
  -> implicit vertical diffusion of T, S and any passive tracers
  -> frazil: layers below their freezing point (TFREEZE_FORM at the
     hydrostatic mid-layer pressure) are reset to it and the heat
     deficit is returned.

Layered mode (diabatic_layered, BULKMIXEDLAYER): the surface fluxes into
the top layer, the bulk mixed layer, the background diffusivity as
entrainment between the density layers, then u and v remapped onto the
new layers.

Opacity, convection, double diffusion and the brine plume are not
ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_tpu_torch.ale.remapping import remap_column
from mom6_tpu_torch.eos.tfreeze import get_tfreeze
from mom6_tpu_torch.framework.arith import csqrt, sdiv, vcumsum, vsum
from mom6_tpu_torch.framework.containers import TensorDataclass
from mom6_tpu_torch.framework.stencil import ip1, jp1
from mom6_tpu_torch.physics.vertical.bulk_mixed_layer import (
    BulkMLParams, bulkmixedlayer)
from mom6_tpu_torch.physics.vertical.entrain_diffusive import (
    EntrainDiffusiveParams, entrainment_diffusive)
from mom6_tpu_torch.physics.vertical.opacity import (GeothermalParams,
                                                     geothermal_heating)
from mom6_tpu_torch.physics.vertical.set_diffusivity import (
    DiffusivityParams, set_diffusivity)
from mom6_tpu_torch.tracers.vert_diff import tracer_vertdiff

__all__ = ["BuoyancyForcing", "DiabaticParams", "diabatic_ale",
           "diabatic_layered"]


@dataclasses.dataclass(frozen=True)
class BuoyancyForcing(TensorDataclass):
    """Surface buoyancy forcing, (ny, nx) tensors."""
    heat_flux: Optional[torch.Tensor] = None   # net heat [W m-2], +down
    salt_flux: Optional[torch.Tensor] = None   # [ppt m s-1]
    sw_flux: Optional[torch.Tensor] = None     # shortwave [W m-2]
    fw_flux: Optional[torch.Tensor] = None     # net fresh water [m s-1]
    t_restore: Optional[torch.Tensor] = None   # target SST [degC]
    s_restore: Optional[torch.Tensor] = None   # target SSS [ppt]
    restore_rate: float = 0.0                  # piston velocity [m s-1]
    salt_left_behind: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class DiabaticParams:
    diff: DiffusivityParams = DiffusivityParams()
    cp: float = 3991.87            # C_P [J kg-1 K-1]
    boundary_layer_scheme: str = "NONE"   # NONE | KPP | EPBL | BULKML
    use_shear_mixing: bool = False
    shear_scheme: str = "LMD94"           # LMD94 | PP81 | JHL
    # the layered mode's (BULKML)
    bulkml: Optional[BulkMLParams] = None
    entrain: Optional[EntrainDiffusiveParams] = None
    geothermal: Optional[GeothermalParams] = None
    frazil: bool = False                  # make_frazil
    tfreeze_form: str = "LINEAR"          # TFREEZE_FORM
    # not ported when set
    opacity: Optional[object] = None
    convection: Optional[object] = None
    ddiff: Optional[object] = None
    do_brine_plume: bool = False


def _make_frazil(T, S, h, GV, cp, tfreeze_form: str = "LINEAR"):
    """Frazil formation (make_frazil, MOM_diabatic_aux.F90): a layer
    below its freezing point at the hydrostatic mid-layer pressure is
    reset to it, the heat deficit [J m-2] summed over the column.
    Returns (T_new, frazil heat, the deficit per layer [degC m])."""
    z_mid = vcumsum(h) - 0.5 * h
    p_mid = GV.rho0 * GV.g_earth * z_mid
    t_fr = get_tfreeze(tfreeze_form)(S, p_mid)
    deficit = torch.clamp(t_fr - T, min=0.0)
    frazil = vsum(deficit * h) * GV.rho0 * cp
    return torch.maximum(T, t_fr), frazil, deficit * h


def diabatic_ale(T, S, h, forcing: BuoyancyForcing, dt, G, GV,
                 p: DiabaticParams, kd_extra=None, extra_tracers=None,
                 eos=None, u=None, v=None, mld=None,
                 collect: Optional[dict] = None):
    """One thermodynamic step of column physics.  ``eos``, ``u`` and
    ``v`` feed the BBL mixing and ``mld`` only the brine plume, which is
    not ported (it raises where it is set).
    ``collect`` (a dict), if given, receives the masked surface deposits
    of the solve, ``t_flux`` and ``s_flux`` [conc m s-1] (None without
    one), and with geothermal heating ``geo_heat3d``, with frazil
    ``frazil3d`` [degC m s-1], for the tendency diagnostics.
    Returns (T_new, S_new, kd, extra_tracers_new, frazil), the frazil
    heat [J m-2] None without FRAZIL."""
    for name in ("convection", "ddiff", "do_brine_plume"):
        if getattr(p, name):
            raise NotImplementedError(f"diabatic_ale: {name} is not ported")
    if p.geothermal is not None:
        geo = geothermal_heating(h, GV, p.geothermal, cp=p.cp) \
            * G.mask2dT[None]
        T = T + dt * geo
        if collect is not None:
            collect["geo_heat3d"] = geo * h
    kd = set_diffusivity(h, G, GV, p.diff, kd_extra=kd_extra, T=T, S=S,
                         eos=eos, u=u, v=v)

    sw_top = None
    if forcing.sw_flux is not None:
        if p.opacity is not None:
            raise NotImplementedError("diabatic_ale: opacity is not ported")
        sw_top = sdiv(forcing.sw_flux, GV.rho0 * p.cp)

    # surface fluxes as tracer fluxes [conc m s-1] into the top layer
    t_flux = None
    if forcing.heat_flux is not None:
        t_flux = sdiv(forcing.heat_flux, GV.rho0 * p.cp)
    if sw_top is not None:
        t_flux = sw_top if t_flux is None else t_flux + sw_top
    s_flux = forcing.salt_flux
    if forcing.t_restore is not None:
        rt = forcing.restore_rate * (forcing.t_restore - T[0])
        t_flux = rt if t_flux is None else t_flux + rt
    if forcing.s_restore is not None:
        rs = forcing.restore_rate * (forcing.s_restore - S[0])
        s_flux = rs if s_flux is None else s_flux + rs
    if forcing.fw_flux is not None:
        vsf = -S[0] * forcing.fw_flux          # dilution: virtual salt flux
        s_flux = vsf if s_flux is None else s_flux + vsf
    # land columns hold Angstrom-thin layers: mask every surface flux
    if t_flux is not None:
        t_flux = t_flux * G.mask2dT
    if s_flux is not None:
        s_flux = s_flux * G.mask2dT
    if collect is not None:
        collect["t_flux"] = t_flux
        collect["s_flux"] = s_flux

    stack = [T, S]
    fluxes = [t_flux if t_flux is not None else torch.zeros_like(T[0]),
              s_flux if s_flux is not None else torch.zeros_like(S[0])]
    if extra_tracers is not None:
        for i in range(extra_tracers.shape[0]):
            stack.append(extra_tracers[i])
            fluxes.append(torch.zeros_like(T[0]))
    out = tracer_vertdiff(torch.stack(stack), h, kd, dt,
                          sfc_flux=torch.stack(fluxes))
    extra_new = out[2:] if extra_tracers is not None else None
    T_new = out[0]
    frazil = None
    if p.frazil:
        T_new, frazil, fz3d = _make_frazil(T_new, out[1], h, GV, p.cp,
                                           p.tfreeze_form)
        if collect is not None:
            collect["frazil3d"] = sdiv(fz3d, dt)
    return T_new, out[1], kd, extra_new, frazil


def diabatic_layered(T, S, h, u, v, forcing: BuoyancyForcing, taux, tauy,
                     dt, G, GV, p: DiabaticParams, eos):
    """The layered diabatic sequence (the layered branch of
    MOM_diabatic_driver.F90: bulkmixedlayer, then entrainment_diffusive),
    u and v remapped conservatively onto the new layers.  Returns (h_new,
    T_new, S_new, u_new, v_new, h_ml)."""
    bml = p.bulkml if p.bulkml is not None else BulkMLParams()
    ent = p.entrain if p.entrain is not None else EntrainDiffusiveParams()

    # the surface fluxes into the top layer
    q = forcing.heat_flux if forcing.heat_flux is not None else \
        torch.zeros_like(G.mask2dT)
    if forcing.sw_flux is not None:
        q = q + forcing.sw_flux
    h_top = torch.clamp(h[0], min=1e-3)
    T = T.clone()
    T[0] = T[0] + q * dt / (GV.rho0 * p.cp * h_top) * G.mask2dT
    if forcing.salt_flux is not None:
        S = S.clone()
        S[0] = S[0] + forcing.salt_flux * dt / h_top * G.mask2dT

    # the bulk mixed layer, driven by u* and the surface buoyancy loss
    # (positive under cooling)
    ustar = csqrt(sdiv(csqrt(taux ** 2 + tauy ** 2), GV.rho0))
    drho_dT, _ = eos.density_derivs(T[0], S[0], T.new_zeros(()))
    buoy_loss = sdiv(bml.g_accel * drho_dT * q, GV.rho0 ** 2 * p.cp)
    h_old = h
    h, T, S, hml = bulkmixedlayer(h, u, v, T, S, G, GV, eos, dt, ustar,
                                  buoy_loss, bml)

    # the interior's diapycnal mixing as entrainment
    kd = set_diffusivity(h, G, GV, p.diff, T=T, S=S, eos=eos)
    h, T, S, _, _ = entrainment_diffusive(h, T, S, G, GV, kd, dt, ent)

    # u and v onto the new layers, conserving momentum
    u_new = remap_column(u, 0.5 * (h_old + ip1(h_old)),
                         0.5 * (h + ip1(h))) * G.mask2dCu
    v_new = remap_column(v, 0.5 * (h_old + jp1(h_old)),
                         0.5 * (h + jp1(h))) * G.mask2dCv
    return h, T, S, u_new, v_new, hml
