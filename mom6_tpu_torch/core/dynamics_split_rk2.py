"""Split barotropic/baroclinic RK2 time stepping
(twin of mom6_tpu/core/dynamics_split_rk2.py, the "RK2" scheme).

  predictor:  PF(h); CorAd(u, h, uh_prev); viscous couplings and remnants;
              continuity fluxes of (u, h); btstep over be*dt;
              up = u + be*dt*accel; implicit vertvisc(up);
              continuity -> hp matched to the BT transports
  corrector:  PF(hp); CorAd(up, hp, uh_pred); btstep over dt;
              u_new = u + dt*accel; vertvisc(u_new); the filtered BT
              velocity replaces the vertical mean; final continuity

``return_accel=True`` also returns the corrector's accelerations
(:class:`AccelDiag`), which the KE budget of the diagnostics reads.  With
``bt.use_bt_cont`` the barotropic transport curves are built once a step
from the starting thickness (set_bt_cont) and both btstep calls use
them; ``obc`` (an OBCParams) goes to both btstep calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from mom6_tpu_torch.core.barotropic import BTParams, btstep
from mom6_tpu_torch.core.continuity_ppm import continuity_ppm, set_bt_cont
from mom6_tpu_torch.core.coriolis_adv import SADOURNY75_ENERGY, coriolis_adv
from mom6_tpu_torch.core.pressure_force import (find_eta,
                                                pressure_force_montgomery)
from mom6_tpu_torch.core.state import OceanState
from mom6_tpu_torch.framework.arith import sdiv, vsum
from mom6_tpu_torch.framework.containers import TensorDataclass
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jp1
from mom6_tpu_torch.physics.vertical.vert_friction import (gl90_coupling,
                                                           limit_velocity,
                                                           vertvisc,
                                                           vertvisc_coef,
                                                           vertvisc_remnant)

__all__ = ["DynParams", "MechForcing", "AccelDiag",
           "step_dynamics_split_rk2"]


class AccelDiag(NamedTuple):
    """The corrector stage's accelerations [m s-2] at the u and v faces
    (the accel_diag_ptrs of MOM_variables.F90), for the KE budget."""
    PFu: torch.Tensor
    PFv: torch.Tensor
    CAu: torch.Tensor
    CAv: torch.Tensor
    diffu: torch.Tensor          # lateral friction
    diffv: torch.Tensor
    u_bt_accel: torch.Tensor     # barotropic correction
    v_bt_accel: torch.Tensor
    du_dt_visc: torch.Tensor     # implicit vertical friction
    dv_dt_visc: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DynParams:
    dt: float                    # baroclinic time step [s]
    bt: BTParams                 # barotropic solver parameters
    be: float = 0.6              # predictor fraction
    kv: float = 1e-4             # background vertical viscosity [m2 s-1]
    kappa_gl90: float = 0.0      # GL90 interface viscosity [m2 s-1]
    alpha_gl90: float = 0.0      # [m2]
    hbbl_gl90: float = 5.0       # [m]
    bottom_drag: float = 0.0     # linear bottom drag piston velocity [m s-1]
    cdrag: float = 0.0           # quadratic bottom drag coefficient
    coriolis_scheme: str = SADOURNY75_ENERGY
    continuity_monotonic: bool = False
    massless_h: float = 1e-3     # [m]; 0 disables the massless-face ramp
    scheme: str = "RK2"
    x_first: bool = True         # FIRST_DIRECTION of the split sweeps

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MechForcing(TensorDataclass):
    taux: Optional[torch.Tensor] = None   # (ny, nx) zonal wind stress [Pa]
    tauy: Optional[torch.Tensor] = None
    p_surf: Optional[torch.Tensor] = None  # surface pressure [Pa] (FV PF)


def _face_thickness(h, G):
    kh = "h" if getattr(G, "fold_north", False) else None
    h_u = 0.5 * (h + ip1(h)) * G.mask2dCu
    h_v = 0.5 * (h + jp1(h, kh)) * G.mask2dCv
    return h_u, h_v


def _massless_ramp(h, G, h0: float):
    """Per-face factors ~1 where both neighbours have mass, ~0 where the
    thinner one is vanished."""
    kh = "h" if getattr(G, "fold_north", False) else None
    hu = torch.minimum(h, ip1(h))
    hv = torch.minimum(h, jp1(h, kh))
    return hu / (hu + h0), hv / (hv + h0)


def _bot_avg(w, hf):
    """Mean of ``w`` over the deepest ~10 m of actual water."""
    z_fb = torch.flip(torch.cumsum(torch.flip(hf, (0,)), dim=0), (0,))
    ov = torch.clamp(z_fb, max=10.0) - torch.clamp(z_fb - hf, max=10.0)
    return (vsum(w * ov)
            / torch.clamp(vsum(ov), min=1e-3))


def _visc_setup(h, u, v, G, GV, p: DynParams, kv_int=None):
    """Face thicknesses, implicit-viscosity couplings and the viscous
    remnants over dt (vertvisc_coef + vertvisc_remnant).  ``kv_int``:
    the boundary-layer and shear viscosity at h-point interfaces
    (nz+1, ny, nx); its interior interfaces, averaged to the faces and
    divided by the interface distance, are added to the couplings."""
    h_u, h_v = _face_thickness(h, G)
    u_bot = _bot_avg(u, h_u)
    v_bot = _bot_avg(v, h_v)
    agl_u = agl_v = None
    if p.kappa_gl90 > 0.0 or p.alpha_gl90 > 0.0:
        f_u = 0.5 * (G.CoriolisBu + jm1(G.CoriolisBu))
        f_v = 0.5 * (G.CoriolisBu + im1(G.CoriolisBu))
        kw = dict(kappa_gl90=p.kappa_gl90, alpha_gl90=p.alpha_gl90,
                  hbbl_gl90=p.hbbl_gl90)
        agl_u = gl90_coupling(h_u, f_u ** 2, GV.g_prime, **kw)
        agl_v = gl90_coupling(h_v, f_v ** 2, GV.g_prime, **kw)
    if kv_int is not None:
        kh = "h" if getattr(G, "fold_north", False) else None
        kv_c = kv_int[1:-1]
        kv_u = 0.5 * (kv_c + ip1(kv_c))
        kv_v = 0.5 * (kv_c + jp1(kv_c, kh))
        dz_u = torch.clamp(0.5 * (h_u[:-1] + h_u[1:]), min=1e-3)
        dz_v = torch.clamp(0.5 * (h_v[:-1] + h_v[1:]), min=1e-3)
        a_kv_u = kv_u / dz_u
        a_kv_v = kv_v / dz_v
        agl_u = a_kv_u if agl_u is None else agl_u + a_kv_u
        agl_v = a_kv_v if agl_v is None else agl_v + a_kv_v
    cu = vertvisc_coef(h_u, p.kv, bottom_drag=p.bottom_drag,
                       u_bot=u_bot, cdrag=p.cdrag, a_gl90=agl_u)
    cv = vertvisc_coef(h_v, p.kv, bottom_drag=p.bottom_drag,
                       u_bot=v_bot, cdrag=p.cdrag, a_gl90=agl_v)
    visc_rem_u = vertvisc_remnant(h_u, cu, p.dt)
    visc_rem_v = vertvisc_remnant(h_v, cv, p.dt)
    return h_u, h_v, cu, cv, visc_rem_u, visc_rem_v


def step_dynamics_split_rk2(state: OceanState, forces: MechForcing,
                            G, GV, p: DynParams, *, pf_fn=None,
                            hv_fn=None, kv_int=None, obc=None,
                            return_accel: bool = False):
    """One baroclinic step; returns the new state (the input's tensors
    are not modified), and with ``return_accel`` also the corrector's
    :class:`AccelDiag`.  ``pf_fn(h, state) -> PressureForceOut`` replaces
    the Montgomery pressure force (the FV/EOS form of the thermo path);
    ``hv_fn(u, v, h) -> (diffu, diffv)`` adds lateral friction.  The
    predictor and the corrector each call both.  ``kv_int``: the
    boundary-layer and shear interface viscosity (see _visc_setup);
    ``obc``: the open boundaries of both barotropic solves."""
    if p.scheme.upper() != "RK2":
        raise NotImplementedError(f"scheme {p.scheme} is not ported")
    dt = p.dt
    dt_pred = p.be * dt
    h, u, v = state.h, state.u, state.v
    eta = find_eta(h, G)
    cont = dict(monotonic=p.continuity_monotonic, x_first=p.x_first)
    if pf_fn is None:
        def pf_fn(hh, st):
            return pressure_force_montgomery(hh, G, GV)

    def accel_bc(cau, cav, pf, uu, vv, hh):
        """Coriolis + pressure force (+ friction) at the faces, and the
        friction (0.0 without)."""
        au, av = cau + pf.PFu, cav + pf.PFv
        diffu = diffv = 0.0
        if hv_fn is not None:
            diffu, diffv = hv_fn(uu, vv, hh)
            au, av = au + diffu, av + diffv
        return au * G.mask2dCu, av * G.mask2dCv, diffu, diffv

    h_u, h_v, cu, cv, visc_rem_u, visc_rem_v = _visc_setup(
        h, u, v, G, GV, p, kv_int=kv_int)
    # continuity fluxes of the initial state (btstep's uhbt0)
    _, uh_in, vh_in, _, _ = continuity_ppm(u, v, h, dt, G, GV, **cont)
    # the barotropic transport curves of the starting thickness
    bt_cont = set_bt_cont(h, dt, G, GV, monotonic=p.continuity_monotonic) \
        if p.bt.use_bt_cont else None
    bt_kw = dict(taux=forces.taux, tauy=forces.tauy, x_first=p.x_first,
                 bt_cont=bt_cont, obc=obc)

    # ---- predictor ---------------------------------------------------------
    pf = pf_fn(h, state)
    cau, cav = coriolis_adv(u, v, h, state.uh, state.vh, G, GV,
                            scheme=p.coriolis_scheme)
    u_bc, v_bc, _, _ = accel_bc(cau, cav, pf, u, v, h)

    # the predictor covers be*dt with proportionally fewer substeps
    nstep_pred = max(1, math.ceil(p.be * p.bt.nstep))
    nfilt_pred = max(1, round(p.bt.nfilter * nstep_pred / p.bt.nstep))
    bt_pred = p.bt.replace(nstep=nstep_pred, nfilter=nfilt_pred)
    bt1 = btstep(u, v, eta, u_bc, v_bc, h, uh_in, vh_in,
                 visc_rem_u, visc_rem_v, pf.pbce, pf.eta_PF,
                 dt_pred, G, GV, bt_pred, **bt_kw)

    up = (u + dt_pred * (u_bc + bt1.accel_layer_u)) * G.mask2dCu
    vp = (v + dt_pred * (v_bc + bt1.accel_layer_v)) * G.mask2dCv
    up = vertvisc(up, h_u, cu, dt_pred, tau=forces.taux,
                  rho0=GV.rho0) * G.mask2dCu
    vp = vertvisc(vp, h_v, cv, dt_pred, tau=forces.tauy,
                  rho0=GV.rho0) * G.mask2dCv
    up, vp, _ = limit_velocity(up, vp, dt_pred, G)
    if p.massless_h > 0.0:
        ru, rv = _massless_ramp(h, G, p.massless_h)
        up, vp = up * ru, vp * rv

    hp, uh_p, vh_p, up_adj, vp_adj = continuity_ppm(
        up, vp, h, dt_pred, G, GV, uhbt=bt1.uhbt_av, vhbt=bt1.vhbt_av,
        visc_rem_u=visc_rem_u, visc_rem_v=visc_rem_v, **cont)

    # ---- corrector ---------------------------------------------------------
    pf2 = pf_fn(hp, state)
    cau2, cav2 = coriolis_adv(up_adj, vp_adj, hp, uh_p, vh_p, G, GV,
                              scheme=p.coriolis_scheme)
    u_bc2, v_bc2, diffu, diffv = accel_bc(cau2, cav2, pf2, up_adj, vp_adj,
                                          hp)

    bt2 = btstep(u, v, eta, u_bc2, v_bc2, h, uh_in, vh_in,
                 visc_rem_u, visc_rem_v, pf2.pbce, pf2.eta_PF,
                 dt, G, GV, p.bt, **bt_kw)

    u_pre = (u + dt * (u_bc2 + bt2.accel_layer_u)) * G.mask2dCu
    v_pre = (v + dt * (v_bc2 + bt2.accel_layer_v)) * G.mask2dCv
    u_new = vertvisc(u_pre, h_u, cu, dt, tau=forces.taux,
                     rho0=GV.rho0) * G.mask2dCu
    v_new = vertvisc(v_pre, h_v, cv, dt, tau=forces.tauy,
                     rho0=GV.rho0) * G.mask2dCv
    accel = None
    if return_accel:
        accel = AccelDiag(
            PFu=pf2.PFu * G.mask2dCu, PFv=pf2.PFv * G.mask2dCv,
            CAu=cau2 * G.mask2dCu, CAv=cav2 * G.mask2dCv,
            diffu=diffu * torch.ones_like(u),
            diffv=diffv * torch.ones_like(v),
            u_bt_accel=bt2.accel_layer_u * G.mask2dCu,
            v_bt_accel=bt2.accel_layer_v * G.mask2dCv,
            du_dt_visc=sdiv(u_new - u_pre, dt),
            dv_dt_visc=sdiv(v_new - v_pre, dt))
    # the vertical mean becomes the time-filtered barotropic velocity
    tot_hu = torch.clamp(vsum(h_u), min=1e-10)
    tot_hv = torch.clamp(vsum(h_v), min=1e-10)
    ubar = vsum(h_u * u_new) / tot_hu
    vbar = vsum(h_v * v_new) / tot_hv
    u_new = (u_new + (bt2.ubt_av - ubar)[None]) * G.mask2dCu
    v_new = (v_new + (bt2.vbt_av - vbar)[None]) * G.mask2dCv
    u_new, v_new, _ = limit_velocity(u_new, v_new, dt, G)
    if p.massless_h > 0.0:
        ru, rv = _massless_ramp(h, G, p.massless_h)
        u_new, v_new = u_new * ru, v_new * rv

    # the flux adjustment changes only the transports
    h_new, uh, vh, _, _ = continuity_ppm(
        u_new, v_new, h, dt, G, GV, uhbt=bt2.uhbt_av, vhbt=bt2.vhbt_av,
        visc_rem_u=visc_rem_u, visc_rem_v=visc_rem_v, **cont)

    uhtr = state.uhtr + dt * uh if state.uhtr is not None else None
    vhtr = state.vhtr + dt * vh if state.vhtr is not None else None
    out = state.replace(h=h_new, u=u_new, v=v_new, uh=uh, vh=vh,
                        uhtr=uhtr, vhtr=vhtr)
    return (out, accel) if return_accel else out
