"""The model step over one thermodynamic cycle
(twin of mom6_tpu/core/mom.py: MOMParams, Forcing, step_mom and
assemble_diffusivity_extras).

  with an ice shelf: its pressure into the surface pressure, its melt
      fluxes into the buoyancy forcing, the wind stress cut under it
  with VarMix: the resolution function (from the WKB first-mode speed)
      and the Visbeck slope function of the cycle's starting state
  with thermodynamics and GM on: thickness diffusion of h with KHTH (plus
      the MEKE diffusivity when MEKE is on, whose energy then steps with
      the GM PE release, and the VarMix scalings), its bolus transports
      added to uhtr/vhtr
  with thermodynamics and the mixed-layer restratification on: the
      mixed-layer depth, then the Fox-Kemper overturning
  for each of the n_dyn_per_thermo baroclinic steps:
      split-RK2 dynamics with the FV pressure force (in the
      non-Boussinesq mode its specific-volume form on the layer masses
      rho0 h), lateral friction (Kh scaled by VarMix's Res_fn),
      the boundary-layer and shear viscosity ``kv_shear`` of the last
      cycle and, with ``bbl_visc``, the BBL's bottom-drag piston
      velocities, accumulating the transports uhtr/vhtr (or, with
      ``unsplit``, the unsplit RK3 or RK2 step); then, with open
      boundaries, apply_obc with the step's starting velocities and,
      with thermodynamics and reservoir lengths, the tracer reservoirs
  then, with thermodynamics on, on the stack of T, S and the registered
  passive tracers (T, S, then the registry's order):
      tracer advection with the accumulated transports
      along-layer tracer diffusion (KHTR > 0, with VarMix's scalings), or
      neutral diffusion:
      the Redi scheme (whose K S^2 part ``kd_redi`` joins the column
      solve) or the matched-surfaces scheme (``ndiff_scheme``)
      the KPP or ePBL (with the Langmuir number of ``waves``) and
      shear-mixing (LMD94, PP81 or JHL's kappa_shear) diffusivities,
      which also set kv_shear, and with
      ``int_tides`` the low-mode internal tides (the mode speed, one
      propagation step of En_itide, the lowmode tidal mixing of its
      losses)
      diabatic column physics (geothermal heating, one column solve with
      the tidal mixing of ``diabatic.diff.tidal``, frazil, whose heat
      accumulates in the state's ``frazil`` where it is allocated), then
      the KPP nonlocal transport of the surface heat and salt fluxes
      the tracer packages' sources and sinks
      the sponge
      ALE regrid (z*, sigma, SIGMA_SHELF_ZSTAR, RHO, HYCOM1 or ADAPTIVE)
      and conservative remap
      reset of the transport accumulators
  or, in the layered mode with the bulk mixed layer (BULKML): the
  surface fluxes, the bulk mixed layer and the entrainment
  (diabatic_layered), the packages and the sponge, and no regrid

Land columns are held exactly as they were (the ``keep`` masking; the
packages' 0-dim clocks pass through).  The reference's scan over the
baroclinic steps is a Python loop.

``step_mom(..., collect_tend=True)`` also returns the content tendencies
of the cycle by process (the register_tracer_diagnostics tier of
MOM_tracer_registry.F90), which sum to the total change;
``dyn_accel_diag`` runs one split step that returns its accelerations,
for the KE budget.  Both serve the diagnostic catalog.

Ported: the thermo ALE branch and the adiabatic branch, the
non-Boussinesq mode (``GV.boussinesq`` False), the unsplit steppers, the
open boundaries (``obc``, with the forcing's time-dependent
``obc_data``), the ice shelf (``shelf``), VarMix (``varmix``), GM with a
constant KHTH or KHTH + MEKE, MEKE, the mixed-layer restratification,
the plain KHTR and the neutral tracer diffusion, KPP, ePBL, the LF17
Langmuir number, the LMD94/PP81 and JHL shear mixing, the BBL viscosity
and its mixing, the tidal mixing, the internal tides, geothermal
heating, frazil, the sponge, the bulk mixed layer and the tracer
packages.  Every other optional subsystem of the reference's MOMParams
(tides, SPPT/SKEB, porous barriers, ZB, Stanley, DIABATIC_FIRST, the
passivity, capped and boundary-layer forms of tracer diffusion, MEKE's
backscatter and friction source...) raises ``NotImplementedError``
naming itself when it is set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mom6_tpu_torch.ale.ale import LAYER, ALEParams, ale_regrid_remap
from mom6_tpu_torch.core.dynamics_split_rk2 import (DynParams, MechForcing,
                                                    step_dynamics_split_rk2)
from mom6_tpu_torch.core.open_boundary import (OBCData, OBCParams,
                                               apply_obc, merge_obc_data,
                                               update_tracer_reservoirs)
from mom6_tpu_torch.core.dynamics_unsplit import (UnsplitParams,
                                                  step_dynamics_unsplit_rk2,
                                                  step_dynamics_unsplit_rk3)
from mom6_tpu_torch.core.pressure_force import (pressure_force_fv,
                                                 pressure_force_fv_nonbous)
from mom6_tpu_torch.core.state import OceanState
from mom6_tpu_torch.diagnostics.mld import diagnose_mld
from mom6_tpu_torch.diagnostics.wave_speed import (wave_speed, wave_speed_wkb,
                                                   wave_speeds)
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.arith import csqrt, sdiv, vsum
from mom6_tpu_torch.framework.stencil import im1, jm1
from mom6_tpu_torch.physics.lateral.hor_visc import (HorViscParams,
                                                     horizontal_viscosity)
from mom6_tpu_torch.physics.lateral.internal_tides import (
    InternalTidesParams, step_internal_tides)
from mom6_tpu_torch.physics.lateral.lateral_mixing_coeffs import (
    VarMixParams, calc_resoln_function, calc_slope_functions)
from mom6_tpu_torch.physics.lateral.meke import (MEKEParams, gm_pe_release,
                                                 meke_diffusivity, step_meke)
from mom6_tpu_torch.physics.lateral.mixed_layer_restrat import (
    MLRestratParams, mixedlayer_restrat)
from mom6_tpu_torch.physics.lateral.thickness_diffuse import (
    GMParams, thickness_diffuse)
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams,
                                                      diabatic_ale,
                                                      diabatic_layered)
from mom6_tpu_torch.physics.shelf_coupling import (ShelfCoupling,
                                                   apply_shelf_coupling)
from mom6_tpu_torch.physics.vertical.epbl import epbl_diffusivity
from mom6_tpu_torch.physics.vertical.kappa_shear import kappa_shear
from mom6_tpu_torch.physics.vertical.kpp import (apply_nonlocal_transport,
                                                 kpp_diffusivity)
from mom6_tpu_torch.physics.vertical.set_viscosity import (SetViscParams,
                                                           bbl_piston)
from mom6_tpu_torch.physics.vertical.shear_mixing import (ShearMixingParams,
                                                          shear_mixing_kd)
from mom6_tpu_torch.physics.vertical.sponge import SpongeParams, apply_sponge
from mom6_tpu_torch.physics.vertical.tidal_mixing import (
    TidalMixingParams, int_tide_input_tke, tidal_mixing_kd)
from mom6_tpu_torch.physics.waves import WaveParams, make_la_fn
from mom6_tpu_torch.tracers.advect import advect_tracers
from mom6_tpu_torch.tracers.hor_diff import tracer_hordiff
from mom6_tpu_torch.tracers.neutral_diffusion import (
    neutral_diffusion, neutral_diffusion_surfaces)
from mom6_tpu_torch.tracers.packages import TracerFlowControl

__all__ = ["MOMParams", "Forcing", "step_mom", "dyn_accel_diag",
           "assemble_diffusivity_extras"]

# the reference's optional subsystems; each raises unless it keeps the
# default given below
_UNPORTED = ("khtr_passivity_coeff", "khtr_max",
             "khtr_bl", "diabatic_first", "homogenize_forcings",
             "interface_filter", "porous", "zb",
             "stanley_coeff", "tides", "sal_harmonics", "sppt",
             "skeb_scale")


@dataclasses.dataclass(frozen=True)
class MOMParams:
    dyn: DynParams
    thermo_enabled: bool = False
    eos_name: str = "WRIGHT"
    diabatic: DiabaticParams = DiabaticParams()
    ale: ALEParams = ALEParams(mode=LAYER)
    hor_visc: Optional[HorViscParams] = None
    n_dyn_per_thermo: int = 1
    tracer_advect_sub: int = 2
    pf_recon: bool = False          # PLM T/S in the FV pressure force
    gm: Optional[GMParams] = None   # thickness diffusion
    khtr: float = 0.0               # along-layer tracer diffusivity [m2 s-1]
    khtr_n_sub: int = 1             # its subcycles
    # KHTR along the neutral surfaces: "redi" (the rotated tensor, its
    # K S^2 part in the column solve) or "surfaces" (matched positions)
    neutral_diffusion: bool = False
    ndiff_scheme: str = "redi"
    mlrestrat: Optional[MLRestratParams] = None
    meke: Optional[MEKEParams] = None   # needs gm and the state's E_meke
    obc: Optional[OBCParams] = None     # open boundaries
    sponge: Optional[SpongeParams] = None       # restoring of T and S
    bbl_visc: Optional[SetViscParams] = None    # BOTTOMDRAGLAW
    waves: Optional[WaveParams] = None          # Langmuir mixing
    # low-mode internal tides (needs the state's En_itide)
    int_tides: Optional[InternalTidesParams] = None
    varmix: Optional[VarMixParams] = None       # USE_VARIABLE_MIXING
    shelf: Optional[ShelfCoupling] = None       # ICE_SHELF
    # not ported: set to anything but these defaults, they raise
    khtr_passivity_coeff: float = 0.0
    khtr_max: float = 0.0
    khtr_bl: float = 0.0
    diabatic_first: bool = False
    homogenize_forcings: bool = False
    interface_filter: Optional[object] = None
    porous: Optional[object] = None
    zb: Optional[object] = None
    stanley_coeff: float = -1.0
    tides: Optional[object] = None
    sal_harmonics: Optional[object] = None
    sppt: Optional[object] = None
    skeb_scale: float = 0.0
    tfc: Optional[TracerFlowControl] = None     # passive tracer packages
    # unsplit stepping (SPLIT = False): "RK3" or "RK2"
    unsplit: Optional[UnsplitParams] = None
    unsplit_scheme: str = "RK3"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Forcing:
    mech: MechForcing = MechForcing()
    buoy: BuoyancyForcing = BuoyancyForcing()
    # the open boundaries' exterior data at this time (replaces those of
    # MOMParams.obc; update_OBC_segment_data)
    obc_data: Optional[OBCData] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None):
        return Forcing(self.mech.to(device, dtype),
                       self.buoy.to(device, dtype),
                       None if self.obc_data is None
                       else self.obc_data.to(device, dtype))


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(MOMParams)}


def _check_ported(p: MOMParams) -> None:
    for name in _UNPORTED:
        if getattr(p, name) != _DEFAULTS[name]:
            raise NotImplementedError(f"MOMParams.{name} is not ported")
    if p.meke is not None and (p.meke.ku_coeff != 0.0
                               or p.meke.fr_coeff != 0.0):
        raise NotImplementedError("MOMParams.meke: the backscatter "
                                  "(ku_coeff) and the friction source "
                                  "(fr_coeff) are not ported")


def _wind_stress(forcing: Forcing, G):
    """(taux, tauy) of the forcing, zero where it has none."""
    zero = torch.zeros_like(G.mask2dT)
    m = forcing.mech
    return (m.taux if m.taux is not None else zero,
            m.tauy if m.tauy is not None else zero)


def _passive(state, names):
    """The registered tracers ``names`` as one (n, nz, ny, nx) stack, or
    None without any."""
    return torch.stack([state.tr[n] for n in names]) if names else None


def _with_passive(state, passive, names):
    """The state with the registered tracers from the stack ``passive``."""
    tr = dict(state.tr)
    for i, n in enumerate(names):
        tr[n] = passive[i]
    return state.replace(tr=tr)


def dyn_accel_diag(state, forcing: Forcing, G, GV, p: MOMParams):
    """One split-RK2 step returning (state, AccelDiag) for the KE budget
    (MOM_diagnostics.F90 calculate_energy_diagnostics).  As the
    reference's, it uses the FV pressure force without the PLM
    reconstruction and the lateral friction, and neither ``kv_shear``
    nor the unsplit stepper."""
    pf_fn = hv_fn = None
    if p.thermo_enabled:
        eos = get_eos(p.eos_name)

        def pf_fn(h, st):
            return pressure_force_fv(h, st.T, st.S, G, GV, eos,
                                     p_surf=forcing.mech.p_surf)
    if p.hor_visc is not None:
        def hv_fn(u, v, h):
            return horizontal_viscosity(u, v, h, G, p.hor_visc)
    return step_dynamics_split_rk2(state, forcing.mech, G, GV, p.dyn,
                                   pf_fn=pf_fn, hv_fn=hv_fn,
                                   return_accel=True)


def step_mom(state: OceanState, forcing: Forcing, G, GV, p: MOMParams, *,
             collect_tend: bool = False):
    """Advance one thermo cycle = ``p.n_dyn_per_thermo`` baroclinic steps.

    Land columns are held exactly inert: their Angstrom-thin layers are
    ill-conditioned in the column solves, and a value that overflows
    there would spread through the masked stencils (NaN * 0 = NaN).

    ``collect_tend=True`` returns ``(state, tend)``: ``tend`` maps the
    tendency diagnostics' names to per-layer content tendencies [degC m
    s-1] and [ppt m s-1] (the catalog scales them to W m-2 and kg m-2
    s-1): advective, epineutral, diapycnal, boundary forcing, frazil and
    vertical remap, which sum to the total change of the cycle, and the
    totals "opottemptend" and "osalttend"."""
    _check_ported(p)
    tend = {} if collect_tend else None
    out = _step_mom_impl(state, forcing, G, GV, p, tend)
    wet = G.mask2dT[None] > 0.5

    def keep(new, old):
        if new.dim() == 0:              # the packages' clocks
            return new
        return torch.where(wet, new, old)

    out = out.replace(h=keep(out.h, state.h))
    if out.T is not None:
        out = out.replace(T=keep(out.T, state.T), S=keep(out.S, state.S))
    if out.tr is not None and state.tr is not None:
        out = out.replace(tr={k: keep(v, state.tr[k])
                              for k, v in out.tr.items()})
    if tend is None:
        return out
    dt_therm = p.dyn.dt * p.n_dyn_per_thermo
    if out.T is not None:
        # the totals from the masked states the caller sees
        tend["opottemptend"] = sdiv(out.T * out.h - state.T * state.h,
                                    dt_therm)
        tend["osalttend"] = sdiv(out.S * out.h - state.S * state.h,
                                 dt_therm)
    return out, {k: v * G.mask2dT[None] for k, v in tend.items()}


def _step_mom_impl(state: OceanState, forcing: Forcing, G, GV,
                   p: MOMParams, tend: Optional[dict] = None
                   ) -> OceanState:
    dt_therm = p.dyn.dt * p.n_dyn_per_thermo
    if p.shelf is not None:
        # the shelf's pressure and melt fluxes in the forcing every part
        # of the cycle sees (add_shelf_pressure, add_shelf_flux)
        forcing, _ = apply_shelf_coupling(state, forcing, G, GV, p.shelf)
    pf_fn = eos = None
    if p.thermo_enabled:
        eos = get_eos(p.eos_name)
        if not GV.boussinesq:
            # h is mass / rho0: the specific-volume form on the masses
            def pf_fn(h, st):
                return pressure_force_fv_nonbous(
                    GV.rho0 * h, st.T, st.S, G, GV, eos,
                    p_surf=forcing.mech.p_surf)
        else:
            def pf_fn(h, st):
                return pressure_force_fv(h, st.T, st.S, G, GV, eos,
                                         p_surf=forcing.mech.p_surf,
                                         plm_ts=p.pf_recon)
    res_fn, sn_h = _varmix(state, G, GV, p, eos)
    hv_fn = None
    if p.hor_visc is not None:
        kh_scale = res_fn if (p.varmix is not None
                              and p.varmix.resoln_scaled_kh) else None

        def hv_fn(u, v, h):
            return horizontal_viscosity(u, v, h, G, p.hor_visc,
                                        kh_scale=kh_scale)

    # the tracer advection starts from the thickness before the bolus
    # updates: uhtr accumulates those same bolus transports
    h_before_dyn = state.h
    if p.thermo_enabled and p.gm is not None:
        use_meke = p.meke is not None and state.E_meke is not None
        khth_2d = None
        if use_meke:
            khth_2d = p.gm.khth + meke_diffusivity(state.E_meke, state.h,
                                                   G, p.meke)
        if p.varmix is not None:
            vm = p.varmix
            base = khth_2d if khth_2d is not None \
                else torch.full_like(G.mask2dT, p.gm.khth)
            if sn_h is not None and vm.khth_slope_cff > 0.0:
                base = base + vm.khth_slope_cff \
                    * vm.visbeck_l_scale ** 2 * sn_h
            if res_fn is not None and vm.resoln_scaled_khth:
                base = base * res_fn
            khth_2d = base
        h_gm, uhd, vhd = thickness_diffuse(state.h, G, GV, dt_therm, p.gm,
                                           khth_2d=khth_2d, T=state.T,
                                           S=state.S, eos=eos)
        if use_meke:
            src = gm_pe_release(state.h, uhd, vhd, G, GV)
            state = state.replace(E_meke=step_meke(
                state.E_meke, src, state.h, G, dt_therm, p.meke))
        state = state.replace(h=h_gm, uhtr=state.uhtr + dt_therm * uhd,
                              vhtr=state.vhtr + dt_therm * vhd)
    if p.thermo_enabled and p.mlrestrat is not None:
        mld = diagnose_mld(state.h, state.T, state.S, G, GV, eos)
        h_mlr, uh_m, vh_m = mixedlayer_restrat(state.h, state.T, state.S,
                                               mld, G, GV, eos, dt_therm,
                                               p.mlrestrat)
        state = state.replace(h=h_mlr, uhtr=state.uhtr + dt_therm * uh_m,
                              vhtr=state.vhtr + dt_therm * vh_m)
    obc = p.obc
    if obc is not None:
        obc = merge_obc_data(obc, forcing.obc_data)
    for _ in range(p.n_dyn_per_thermo):
        st = state
        if p.unsplit is not None:
            # neither the lateral friction nor kv_shear: as the reference
            stepper = step_dynamics_unsplit_rk2 \
                if p.unsplit_scheme.upper() == "RK2" \
                else step_dynamics_unsplit_rk3
            pf1 = (lambda hh: pf_fn(hh, st)) if pf_fn is not None else None
            state = stepper(st, forcing.mech, G, GV, p.unsplit, pf_fn=pf1)
        else:
            # the BBL's bottom drag (set_viscous_BBL) from this step's
            # starting state
            piston = None if p.bbl_visc is None else bbl_piston(
                st.u, st.v, st.h, G, p.bbl_visc)
            state = step_dynamics_split_rk2(st, forcing.mech, G, GV,
                                            p.dyn, pf_fn=pf_fn, hv_fn=hv_fn,
                                            kv_int=st.kv_shear, obc=obc,
                                            bbl_piston=piston)
        if obc is not None:
            state = apply_obc(state, obc, G, GV, p.dyn.dt, u_old=st.u,
                              v_old=st.v)
            if p.thermo_enabled and obc.res_len_in > 0.0:
                state = update_tracer_reservoirs(state, obc, G, p.dyn.dt)
    if not p.thermo_enabled:
        return state

    # tracer transport of T, S and the registered tracers, in that order,
    # with the accumulated transports
    names = p.tfc.registry.names if p.tfc is not None else []
    tr = torch.stack([state.T, state.S] + [state.tr[n] for n in names])
    T_pre_adv, S_pre_adv = tr[0], tr[1]
    tr, _ = advect_tracers(tr, h_before_dyn, state.uhtr, state.vhtr, G,
                           n_sub=p.tracer_advect_sub)
    if tend is not None:
        # the advective change, bolus transports included, with the
        # model's own post-dynamics h so that the captures add up to the
        # total
        tend["T_advection_xy"] = sdiv(tr[0] * state.h
                                      - T_pre_adv * h_before_dyn, dt_therm)
        tend["S_advection_xy"] = sdiv(tr[1] * state.h
                                      - S_pre_adv * h_before_dyn, dt_therm)
    T_pre_pm, S_pre_pm = tr[0], tr[1]
    kd_redi = None
    if p.khtr > 0.0:
        if p.neutral_diffusion and p.ndiff_scheme == "surfaces":
            tr = neutral_diffusion_surfaces(tr, state.h, tr[0], tr[1], G,
                                            GV, eos, p.khtr, dt_therm)
        elif p.neutral_diffusion:
            tr, kd_redi = neutral_diffusion(tr, state.h, tr[0], tr[1], G,
                                            GV, eos, p.khtr, dt_therm)
        else:
            khtr_eff = p.khtr
            if p.varmix is not None:
                vm = p.varmix
                khtr_eff = torch.full_like(G.mask2dT, p.khtr)
                if sn_h is not None and vm.khtr_slope_cff > 0.0:
                    khtr_eff = khtr_eff + vm.khtr_slope_cff \
                        * vm.visbeck_l_scale ** 2 * sn_h
                if res_fn is not None and vm.resoln_scaled_khtr:
                    khtr_eff = khtr_eff * res_fn
            tr = tracer_hordiff(tr, state.h, khtr_eff, dt_therm, G,
                                n_sub=p.khtr_n_sub)
    if tend is not None:
        tend["opottemppmdiff"] = sdiv((tr[0] - T_pre_pm) * state.h,
                                      dt_therm)
        tend["osaltpmdiff"] = sdiv((tr[1] - S_pre_pm) * state.h, dt_therm)
    state = state.replace(T=tr[0], S=tr[1],
                          uhtr=torch.zeros_like(state.uhtr),
                          vhtr=torch.zeros_like(state.vhtr))
    if names:
        state = _with_passive(state, tr[2:], names)
    return _thermo_block(state, forcing, G, GV, p, eos, dt_therm, names,
                         tend, kd_redi=kd_redi)


def _varmix(state, G, GV, p: MOMParams, eos):
    """(Res_fn or None, SN at h points or None) of VarMix from the
    cycle's starting state: the resolution function from the WKB
    first-mode speed (the layered stack's sum sqrt(g' hbar) / pi without
    thermodynamics), the Visbeck slope function where a slope
    coefficient is on."""
    vm = p.varmix
    if vm is None:
        return None, None
    res_fn = sn_h = None
    if vm.resoln_scaled_kh or vm.resoln_scaled_khth or vm.resoln_scaled_khtr:
        if p.thermo_enabled:
            cg1 = wave_speed_wkb(state.h, state.T, state.S, G, GV, eos)
        else:
            gp = GV.g_prime[1:, None, None]
            hbar = 0.5 * (state.h[:-1] + state.h[1:])
            cg1 = sdiv(vsum(csqrt(torch.clamp(gp * hbar, min=0.0))),
                       math.pi)
        res_fn = calc_resoln_function(cg1, G, vm)
    if vm.use_visbeck and (vm.khth_slope_cff > 0.0
                           or vm.khtr_slope_cff > 0.0):
        sn_u, sn_v = calc_slope_functions(state.h, G, GV, vm)
        sn_h = 0.25 * ((sn_u + im1(sn_u)) + (sn_v + jm1(sn_v)))
    return res_fn, sn_h


def assemble_diffusivity_extras(state, forcing, G, GV, p: MOMParams, eos,
                                dt_therm: float, kd_redi=None,
                                components: Optional[dict] = None):
    """The interface diffusivities that feed the diabatic solve besides
    the background, summed in this order: the Redi scheme's ``kd_redi``,
    the boundary layer's (KPP or ePBL), the shear mixing's and, with
    ``int_tides`` and the state's En_itide, the lowmode tidal mixing of
    the internal tides' losses after one propagation step.
    ``components`` (a dict), if given, receives them as "Kd_BL",
    "Kd_shear" and "Kd_lowmode".  Returns (kd_extra, boundary-layer
    depth, KPP nonlocal shape, En_itide after the step); the depth is
    None without a boundary-layer scheme, the shape None without KPP,
    the energy None without internal tides."""
    d = p.diabatic
    if d.boundary_layer_scheme not in ("NONE", "KPP", "EPBL", "BULKML"):
        raise NotImplementedError(f"boundary_layer_scheme "
                                  f"{d.boundary_layer_scheme} is not ported")
    kd_extra = kd_redi
    bl_mld = kpp_nonlocal = None
    taux, tauy = _wind_stress(forcing, G)
    # the Langmuir number at the boundary-layer scheme's own depth
    la_fn = None
    if p.waves is not None:
        ustar = csqrt(sdiv(csqrt(taux ** 2 + tauy ** 2),
                                GV.rho0))
        la_fn = make_la_fn(p.waves, ustar, u10=forcing.mech.u10)
    if d.boundary_layer_scheme in ("KPP", "EPBL"):
        if d.boundary_layer_scheme == "KPP":
            kd_bl, bl_mld, kpp_nonlocal = kpp_diffusivity(
                state.h, state.u, state.v, state.T, state.S, G, GV, eos,
                taux, tauy, forcing.buoy.heat_flux, cp=d.cp, la_fn=la_fn)
        else:
            kd_bl, bl_mld = epbl_diffusivity(
                state.h, state.T, state.S, G, GV, eos, taux, tauy,
                forcing.buoy.heat_flux, cp=d.cp, dt=dt_therm, la_fn=la_fn,
                waves=p.waves)
        if components is not None:
            components["Kd_BL"] = kd_bl
        kd_extra = kd_bl if kd_extra is None else kd_extra + kd_bl
    if d.use_shear_mixing:
        if d.shear_scheme == "JHL":
            kd_sh, _ = kappa_shear(state.h, state.u, state.v, state.T,
                                   state.S, G, GV, eos, dt=dt_therm)
        elif d.shear_scheme in ("LMD94", "PP81"):
            kd_sh = shear_mixing_kd(state.h, state.u, state.v, state.T,
                                    state.S, G, GV, eos,
                                    ShearMixingParams(scheme=d.shear_scheme))
        else:
            raise NotImplementedError(f"shear_scheme {d.shear_scheme} is "
                                      "not ported")
        if components is not None:
            components["Kd_shear"] = kd_sh
        kd_extra = kd_sh if kd_extra is None else kd_extra + kd_sh
    en_new = None
    if p.int_tides is not None and state.En_itide is not None:
        tmp = d.diff.tidal if d.diff.tidal is not None \
            else TidalMixingParams()
        tke_in, _ = int_tide_input_tke(state.h, state.T, state.S, G, GV,
                                       eos, tmp)
        if p.int_tides.n_mode > 1:
            cn = wave_speeds(state.h, state.T, state.S, G, GV, eos,
                             n_modes=p.int_tides.n_mode)
        else:
            cn = wave_speed(state.h, state.T, state.S, G, GV, eos)
        en_new, loss = step_internal_tides(state.En_itide, tke_in, cn, G,
                                           GV, dt_therm, p.int_tides)
        # the propagated losses deposited with the mixing efficiency
        kd_low = tidal_mixing_kd(
            state.h, state.T, state.S, G, GV, eos, tmp,
            tke_input=sdiv(loss, max(tmp.gamma_itides, 1e-6)))
        if components is not None:
            components["Kd_lowmode"] = kd_low
        kd_extra = kd_low if kd_extra is None else kd_extra + kd_low
    return kd_extra, bl_mld, kpp_nonlocal, en_new


def _thermo_block(state, forcing, G, GV, p: MOMParams, eos,
                  dt_therm: float, names, tend: Optional[dict] = None,
                  kd_redi=None):
    """Column physics, the tracer packages, the sponge, then the ALE
    regrid and remap (step_MOM_thermo); ``names`` the registered passive
    tracers; ``kd_redi`` the Redi scheme's K S^2 diffusivity for the
    column solve; ``tend`` (a dict) receives the boundary-forcing, frazil,
    diapycnal, sponge and remap tendencies.  In the layered mode of the
    bulk mixed layer, diabatic_layered, the packages and the sponge, and
    no regrid."""
    if p.diabatic.boundary_layer_scheme == "BULKML":
        taux, tauy = _wind_stress(forcing, G)
        h_n, T, S, u_n, v_n, _ = diabatic_layered(
            state.T, state.S, state.h, state.u, state.v, forcing.buoy,
            taux, tauy, dt_therm, G, GV, p.diabatic, eos)
        state = state.replace(h=h_n, T=T, S=S, u=u_n, v=v_n)
        if p.tfc is not None and state.tr is not None:
            state = state.replace(tr=p.tfc.column_physics(
                state.tr, state.h, dt_therm, G, GV, T=state.T, S=state.S,
                forcing=forcing))
        if p.sponge is not None:
            state = apply_sponge(state, dt_therm, p.sponge, G)
        return state
    kd_parts = {}
    kd_extra, bl_mld, kpp_nonlocal, en_new = assemble_diffusivity_extras(
        state, forcing, G, GV, p, eos, dt_therm, kd_redi=kd_redi,
        components=kd_parts)
    if en_new is not None:
        state = state.replace(En_itide=en_new)
    # the boundary-layer and shear diffusivities are also the momentum
    # viscosity (unit Prandtl number) of the next cycle's vertical
    # friction, where the builder allocated the field
    kv_parts = [kd_parts[k] for k in ("Kd_BL", "Kd_shear") if k in kd_parts]
    if kv_parts and state.kv_shear is not None:
        kv_sh = kv_parts[0]
        for extra in kv_parts[1:]:
            kv_sh = kv_sh + extra
        state = state.replace(kv_shear=kv_sh)

    buoy = forcing.buoy
    collect = {} if tend is not None else None
    T, S, _, passive, frazil = diabatic_ale(
        state.T, state.S, state.h, buoy, dt_therm, G, GV, p.diabatic,
        kd_extra=kd_extra, extra_tracers=_passive(state, names), eos=eos,
        u=state.u, v=state.v, mld=bl_mld, collect=collect)
    if frazil is not None and state.frazil is not None:
        # the heat deficit accumulated for a coupler to collect
        state = state.replace(frazil=state.frazil + frazil)
    # KPP's nonlocal transport of the heat flux and of the salt and
    # fresh-water fluxes
    if kpp_nonlocal is not None:
        if buoy.heat_flux is not None:
            t_sfc = sdiv(buoy.heat_flux, GV.rho0 * p.diabatic.cp)
            T = apply_nonlocal_transport(T, state.h, kpp_nonlocal, t_sfc,
                                         dt_therm)
        s_sfc = buoy.salt_flux
        if buoy.fw_flux is not None:
            vsf = -S[0] * buoy.fw_flux
            s_sfc = vsf if s_sfc is None else s_sfc + vsf
        if s_sfc is not None:
            S = apply_nonlocal_transport(S, state.h, kpp_nonlocal, s_sfc,
                                         dt_therm)
    if tend is not None:
        # the surface deposit lands in the top layer of the column solve,
        # the geothermal heat in the deepest massive layer; the
        # diapycnal tendency is the rest of the diabatic change (the KPP
        # nonlocal transport included)
        zcol = torch.zeros_like(T)
        bT, bS = zcol.clone(), zcol.clone()
        if collect["t_flux"] is not None:
            bT[0] += collect["t_flux"]
        if "geo_heat3d" in collect:
            bT = bT + collect["geo_heat3d"]
        if collect["s_flux"] is not None:
            bS[0] += collect["s_flux"]
        fz = collect.get("frazil3d", zcol)
        tend["boundary_forcing_heat_tendency"] = bT
        tend["boundary_forcing_salt_tendency"] = bS
        tend["frazil_heat_tendency"] = fz
        tend["opottempdiff"] = sdiv((T - state.T) * state.h, dt_therm) \
            - bT - fz
        tend["osaltdiff"] = sdiv((S - state.S) * state.h, dt_therm) - bS
    state = state.replace(T=T, S=S)
    if names:
        state = _with_passive(state, passive, names)
    # the packages' sources and sinks (call_tracer_column_fns)
    if p.tfc is not None and state.tr is not None:
        state = state.replace(tr=p.tfc.column_physics(
            state.tr, state.h, dt_therm, G, GV, T=state.T, S=state.S,
            forcing=forcing))
    # the sponge, after the diabatic solve (MOM_diabatic_driver.F90:1770)
    if p.sponge is not None:
        T_pre, S_pre, h_pre = state.T, state.S, state.h
        state = apply_sponge(state, dt_therm, p.sponge, G)
        if tend is not None:
            tend["T_tendency_sponge"] = sdiv(
                state.T * state.h - T_pre * h_pre, dt_therm)
            tend["S_tendency_sponge"] = sdiv(
                state.S * state.h - S_pre * h_pre, dt_therm)

    T_pre, S_pre, h_pre = state.T, state.S, state.h
    state, passive = ale_regrid_remap(state, G, GV, p.ale,
                                      extra_tracers=_passive(state, names))
    if tend is not None:
        # the remap's residual (~0 in the column integral)
        tend["Th_tendency_vert_remap"] = sdiv(
            state.T * state.h - T_pre * h_pre, dt_therm)
        tend["Sh_tendency_vert_remap"] = sdiv(
            state.S * state.h - S_pre * h_pre, dt_therm)
    if names and passive is not None:
        state = _with_passive(state, passive, names)
    return state
