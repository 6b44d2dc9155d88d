"""Split-explicit barotropic solver, dense path
(twin of mom6_tpu/core/barotropic.py).

Each substep is a dissipative forward-backward scheme: eta predictor with
the current transports, the pressure force of the ``bebt``-weighted eta,
velocity updates with Coriolis anomalies in alternating u-first/v-first
order, then the eta corrector with the new transports.  The reference's
``lax.scan`` over substep PAIRS (static update order inside a pair, a
trailing odd substep) is a Python loop here; the averaging weights and
the order parity come from :func:`_weights` in float64 numpy.

Transports are linear, Datu*ubt + uhbt0, or with ``use_bt_cont`` and a
``BTCont`` the response curves of the layer continuity's PPM
reconstruction (find_uhbt), offset to agree with the layer transports
at the initial velocities.  With ``obc`` the Flather condition acts on
the barotropic velocities inside every substep and the exterior strip's
eta is held at its exterior value (apply_velocity_OBCs); SPECIFIED faces
are clamped to their depth-mean inflow.

With ``dynamic_psurf`` and a coupler's ice rigidity map the substeps feel
a viscous surface pressure under rigid ice (DYNAMIC_SURFACE_PRESSURE,
btloop_add_dyn_PF): p = dyn_coef (eta_pred - eta), dyn_coef the smaller
of the ice's strength 4 rigidity / (ICE_LENGTH_DYN_PSURF^2 dtbt) and
CONST_DYN_PSURF times the gravity-wave stability limit of the substep.

The scalar self-attraction and loading (SAL_SCALAR_VALUE, ``sal_scalar``)
scales the free surface's pressure gradient in the substeps by 1 - beta.

On a mesh of ranks (parallel/mesh.py) the substeps' shifts exchange with
the neighbour ranks, one exchange a shift.  With ``wide_halo``
(BT_WIDE_HALO) the subcycle on the active mesh runs instead in the
wide-halo form of core/bt_widehalo.py, a rim exchange every few
substeps; AUTO (-1) takes its width from the mesh and the tile
(:func:`auto_wide_halo`).  Without a mesh the wide halo is off, as on
the reference's single device.  The reference binds its mesh into the
parameters (its parallel/mesh.py::bind_mesh) because JAX has no ambient
context; here the mesh that ``with mesh:`` makes active is the one
every shift, sum and subcycle reads, so there is no such binding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mom6_tpu_torch.core.bt_widehalo import run_subcycle_widehalo
from mom6_tpu_torch.core.continuity_ppm import find_uhbt, find_vhbt
from mom6_tpu_torch.framework.arith import cpow, csqrt, rdiv, sdiv, vsum
from mom6_tpu_torch.framework.containers import fields_equal
from mom6_tpu_torch.framework import stencil
from mom6_tpu_torch.framework.repro_sum import global_max, global_min
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jm1_s0, jp1

__all__ = ["BTParams", "BTOut", "btstep", "set_dtbt", "btcalc",
           "dtbt_max_from_state", "auto_wide_halo"]


@dataclasses.dataclass(frozen=True, eq=False)
class BTParams:
    """Two are equal when every field is, a lin_drag map to the bit."""
    nstep: int                  # substeps covering dt
    nfilter: int                # extra filter substeps
    bebt: float = 0.2           # backward weighting of eta in the PF
    dgeo_de: float = 1.0        # geopotential over-relaxation
    use_bt_cont: bool = False   # nonlinear transport curves (BT_cont)
    lin_drag: float = 0.0       # linear BT drag piston velocity [m s-1],
    #                             a number or a (ny, nx) map
    cdrag: float = 0.0          # quadratic BT drag coefficient
    sal_scalar: float = 0.0     # scalar SAL: the substeps' g scaled by 1 - it
    # the viscous surface pressure under rigid ice
    # (DYNAMIC_SURFACE_PRESSURE), with a rigidity map from the coupler
    dynamic_psurf: bool = False
    const_dyn_psurf: float = 0.9        # CONST_DYN_PSURF
    ice_strength_length: float = 1.0e4  # ICE_LENGTH_DYN_PSURF [m]
    dmin_dyn_psurf: float = 1.0e-6      # the depth floor [m]
    # the wide-halo subcycle (BT_WIDE_HALO, core/bt_widehalo.py): the
    # rim width, 0 the dense path, -1 AUTO; it needs an active mesh
    wide_halo: int = 0
    halo_per_substep: int = 2   # rim cells a substep consumes

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def __eq__(self, other):
        if not isinstance(other, BTParams):
            return NotImplemented
        return fields_equal(self, other)


def auto_wide_halo(params: BTParams, grid_shape, layout=None) -> int:
    """BT_WIDE_HALO = AUTO (-1): the reference's choice (its
    auto_wide_halo, the BTHALO default logic of MOM_barotropic.F90:5450).
    0 (dense) without a mesh, on one rank or where the tiles are too
    small for a useful rim; else a width aiming at ~8 substeps an
    exchange (8 * halo_per_substep), capped at half the smaller tile
    side.  ``grid_shape``: the global (..., ny, nx); ``layout``: the
    mesh's (Py, Px), by default the active mesh's."""
    if layout is None:
        if stencil._MESH is None:
            return 0
        layout = stencil._MESH.shape
    my, mx = layout
    if my * mx == 1:
        return 0
    ny, nx = grid_shape[-2:]
    min_shard = min(ny // max(my, 1), nx // max(mx, 1))
    r = max(1, int(params.halo_per_substep))
    w = min(8 * r, (min_shard // 2) // 2 * 2)
    return w if w >= 2 * r else 0


class BTOut(NamedTuple):
    accel_layer_u: torch.Tensor   # (nz, ny, nx) layer accel from BT [m s-2]
    accel_layer_v: torch.Tensor
    uhbt_av: torch.Tensor         # (ny, nx) time-mean BT transport
    vhbt_av: torch.Tensor
    ubt_av: torch.Tensor          # time-filtered BT velocity [m s-1]
    vbt_av: torch.Tensor
    eta_out: torch.Tensor         # eta at the end of the subcycle [m]
    e_anom: torch.Tensor          # time-mean eta anomaly vs eta_PF [m]


class BTFields(NamedTuple):
    """Every (ny, nx) field the substep body reads."""
    eta_PF: torch.Tensor
    gtot: torch.Tensor
    bt_force_u: torch.Tensor
    bt_force_v: torch.Tensor
    q_f: torch.Tensor
    tot_hu: torch.Tensor
    tot_hv: torch.Tensor
    cor_ref_u: torch.Tensor
    cor_ref_v: torch.Tensor
    rem_u: torch.Tensor
    rem_v: torch.Tensor
    mask_u: torch.Tensor
    mask_v: torch.Tensor
    IareaT: torch.Tensor
    IdxCu: torch.Tensor
    IdyCv: torch.Tensor
    drag_u: Optional[torch.Tensor] = None
    drag_v: Optional[torch.Tensor] = None
    # the open boundaries inside the subcycle, or None: the Flather faces
    # (with the SPECIFIED faces), the exterior strip, the face signs, the
    # exterior data and the per-face wave speeds (0 on SPECIFIED faces)
    obc_mask_u: Optional[torch.Tensor] = None
    obc_mask_v: Optional[torch.Tensor] = None
    obc_mask_cell: Optional[torch.Tensor] = None
    obc_sign_u: Optional[torch.Tensor] = None
    obc_sign_v: Optional[torch.Tensor] = None
    obc_uvel_ext: Optional[torch.Tensor] = None
    obc_vvel_ext: Optional[torch.Tensor] = None
    obc_eta_ext: Optional[torch.Tensor] = None
    obc_c_fl_u: Optional[torch.Tensor] = None
    obc_c_fl_v: Optional[torch.Tensor] = None
    # the dynamic surface pressure's coefficient at the T points, or None
    dyn_coef: Optional[torch.Tensor] = None


def _np(t):
    return t.detach().cpu().numpy()


def set_dtbt(G, GV, max_depth: float, dt: float, cfl: float = 0.7):
    """Barotropic substep count from the external gravity-wave CFL
    (set_dtbt).  Host side; returns (nstep, dt/nstep)."""
    wet = _np(G.mask2dT) > 0.5
    if global_max(wet) < 0.5:               # no wet cell on any tile
        wet = np.ones_like(wet)
    dx = global_min(np.where(wet, _np(G.dxT), np.inf))
    dy = global_min(np.where(wet, _np(G.dyT), np.inf))
    cg = np.sqrt(GV.g_earth * max_depth)
    dtbt = cfl * min(dx, dy) / (np.sqrt(2.0) * cg)
    nstep = max(1, int(np.ceil(dt / dtbt)))
    return nstep, dt / nstep


def dtbt_max_from_state(h, pbce, G, bebt: float, dgeo_de: float = 1.0):
    """Largest stable barotropic substep [s] for the current state, a
    0-dim tensor: the per-cell bound of set_dtbt
    (MOM_barotropic.F90:3570-3627),

      1/dt^2 = (1+2*bebt)/2 * [ IareaT * sum_faces(gtot_face * Dat_face
               * Idx_face) + sum_corners f^2 ],

    ``gtot_face`` the pbce column sum weighted by that face's layer
    fractions, maximised over wet cells.  The solo driver re-evaluates it
    every DTBT_RESET_PERIOD and rebuilds the stepper when the substep
    count changes."""
    h_u, h_v, frac_u, frac_v = btcalc(h, G)
    DatIdx_u = G.dyCu * vsum(h_u) * G.mask2dCu * G.IdxCu
    DatIdy_v = G.dxCv * vsum(h_v) * G.mask2dCv * G.IdyCv
    gtot_E = vsum(pbce * frac_u)           # east face of cell i
    gtot_W = vsum(pbce * im1(frac_u))
    gtot_N = vsum(pbce * frac_v)
    gtot_S = vsum(pbce * jm1(frac_v))
    f2 = G.CoriolisBu ** 2
    cor2 = (f2 + im1(jm1(f2))) + (im1(f2) + jm1(f2))
    idt2 = 0.5 * (1.0 + 2.0 * bebt) * (
        G.IareaT * ((gtot_E * DatIdx_u + gtot_W * im1(DatIdx_u))
                    + (gtot_N * DatIdy_v + gtot_S * jm1(DatIdy_v)))
        + cor2)
    idt2_max = torch.amax(torch.where(G.mask2dT > 0.5, idt2,
                                      torch.zeros_like(idt2)))
    if stencil._MESH is not None:
        idt2_max = stencil._MESH.all_max(idt2_max)
    return csqrt(1.0 / torch.clamp(idt2_max * dgeo_de, min=1e-30))


def btcalc(h, G, *, h_u=None, h_v=None):
    """Face thicknesses and per-layer column fractions at faces (btcalc).
    Returns (h_u, h_v, frac_u, frac_v)."""
    kh = "h" if getattr(G, "fold_north", False) else None
    if h_u is None:
        h_u = 0.5 * (h + ip1(h)) * G.mask2dCu
    if h_v is None:
        h_v = 0.5 * (h + jp1(h, kh)) * G.mask2dCv
    tot_u = torch.clamp(vsum(h_u), min=1e-30)
    tot_v = torch.clamp(vsum(h_v), min=1e-30)
    return h_u, h_v, h_u / tot_u, h_v / tot_v


def _coriolis_u(q, Vw):
    """Sadourny energy-conserving BT Coriolis on depth-weighted flow."""
    fv_q = q * 0.5 * (Vw + ip1(Vw))
    return 0.5 * (fv_q + jm1(fv_q))


def _coriolis_v(q, Uw, ku=None):
    fu_q = q * 0.5 * (Uw + jp1(Uw, ku))
    return -0.5 * (fu_q + im1(fu_q))


def _weights(nstep: int, nfilter: int, x_first: bool = True):
    """Per-substep transport and velocity weights and the update-order
    parity, in float64 numpy: a flat-top window of half-width
    ``nfilter`` centred on substep ``nstep`` (wt_vel) and its normalized
    reverse cumulative sum (wt_trans), the reference's filter shapes."""
    n_tot = nstep + nfilter
    n = np.arange(1, n_tot + 1, dtype=np.float64)
    wt_eta = np.where(np.abs(n - nstep) <= nfilter, 1.0, 0.0)
    wt_vel = wt_eta / wt_eta.sum()
    rev = np.cumsum(wt_eta[::-1])[::-1]
    wt_trans = rev / rev.sum()
    parity = (n % 2 == 0) if x_first else (n % 2 == 1)
    return wt_trans, wt_vel, parity.astype(np.int32)


def dense_kit(G):
    """Stencil kit of the dense path: global rolls, with the fold ghost
    rows where the grid has one."""
    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    ku = "u" if fold else None
    return dict(ip1=ip1, im1=im1, jm1=jm1,
                jp1_h=lambda a: jp1(a, kh),
                jp1_u=lambda a: jp1(a, ku),
                jm1_s0=lambda a: jm1_s0(a, kh),
                jm1_q=lambda a: jm1_s0(a, kh))


def _make_half_step(F: BTFields, consts: dict, kit: dict, transports):
    """The forward-backward substep (the body of the reference's substep
    loop), with a static u/v update order per call; ``transports(ubt,
    vbt)`` gives the barotropic transports of the velocities."""
    dtbt = consts["dtbt"]
    bebt = consts["bebt"]
    geo = consts["geo"]
    ip1_, im1_ = kit["ip1"], kit["im1"]
    jp1_h, jp1_u, jm1_s0_ = kit["jp1_h"], kit["jp1_u"], kit["jm1_s0"]
    jm1_q = kit["jm1_q"]

    def cor_u(Vw):
        fv_q = F.q_f * 0.5 * (Vw + ip1_(Vw))
        return 0.5 * (fv_q + jm1_q(fv_q))

    def cor_v(Uw):
        fu_q = F.q_f * 0.5 * (Uw + jp1_u(Uw))
        return -0.5 * (fu_q + im1_(fu_q))

    def div_eta(uhbt, vhbt):
        return -F.IareaT * ((uhbt - im1_(uhbt)) + (vhbt - jm1_s0_(vhbt)))

    def pf_anom(eta_w):
        ge = F.gtot * (eta_w - F.eta_PF) * geo
        pfu = -(ip1_(ge) - ge) * F.IdxCu * F.mask_u
        pfv = -(jp1_h(ge) - ge) * F.IdyCv * F.mask_v
        return pfu, pfv

    def dragged_u(x):
        x = F.rem_u * x
        return (x * F.drag_u if F.drag_u is not None else x) * F.mask_u

    def dragged_v(x):
        x = F.rem_v * x
        return (x * F.drag_v if F.drag_v is not None else x) * F.mask_v

    if F.obc_mask_u is not None:
        def obc_bt(ubt, vbt, eta):
            eta_u = torch.where(F.obc_sign_u >= 0.0, eta, ip1_(eta))
            eta_v = torch.where(F.obc_sign_v >= 0.0, eta, jp1_h(eta))
            u_fl = F.obc_uvel_ext + F.obc_sign_u * F.obc_c_fl_u \
                * (eta_u - F.obc_eta_ext)
            v_fl = F.obc_vvel_ext + F.obc_sign_v * F.obc_c_fl_v \
                * (eta_v - F.obc_eta_ext)
            return (ubt * (1.0 - F.obc_mask_u) + F.obc_mask_u * u_fl,
                    vbt * (1.0 - F.obc_mask_v) + F.obc_mask_v * v_fl)

        def obc_eta(eta):
            return torch.where(F.obc_mask_cell > 0.5, F.obc_eta_ext, eta)
    else:
        def obc_bt(ubt, vbt, eta):
            return ubt, vbt

        def obc_eta(eta):
            return eta

    def half_step(ubt, vbt, eta, uhbt, vhbt, u_leads: bool):
        """One substep; ``uhbt``/``vhbt`` are the transports of the entry
        velocities, carried from the previous substep."""
        eta_pred = eta + dtbt * div_eta(uhbt, vhbt)
        eta_w = (1.0 - bebt) * eta + bebt * eta_pred
        pfu, pfv = pf_anom(eta_w)
        if F.dyn_coef is not None:
            # the under-ice pressure resisting d(eta)/dt
            p_dyn = F.dyn_coef * (eta_pred - eta)
            pfu = pfu - (ip1_(p_dyn) - p_dyn) * F.IdxCu * F.mask_u
            pfv = pfv - (jp1_h(p_dyn) - p_dyn) * F.IdyCv * F.mask_v
        if u_leads:
            cu = cor_u(F.tot_hv * vbt) - F.cor_ref_u
            ubt = dragged_u(ubt + dtbt * (F.bt_force_u + cu + pfu))
            cv = cor_v(F.tot_hu * ubt) - F.cor_ref_v
            vbt = dragged_v(vbt + dtbt * (F.bt_force_v + cv + pfv))
        else:
            cv = cor_v(F.tot_hu * ubt) - F.cor_ref_v
            vbt = dragged_v(vbt + dtbt * (F.bt_force_v + cv + pfv))
            cu = cor_u(F.tot_hv * vbt) - F.cor_ref_u
            ubt = dragged_u(ubt + dtbt * (F.bt_force_u + cu + pfu))
        ubt, vbt = obc_bt(ubt, vbt, eta_w)
        uhbt, vhbt = transports(ubt, vbt)
        eta = obc_eta(eta + dtbt * div_eta(uhbt, vhbt))
        return ubt, vbt, eta, uhbt, vhbt, cu + pfu, cv + pfv

    return half_step


def _acc_add(acc, w_t, w_v, out):
    """Accumulate one substep's weighted contribution."""
    ubt, vbt, eta, uhbt, vhbt, uac, vac = out
    return dict(
        uhbt_av=acc["uhbt_av"] + w_t * uhbt,
        vhbt_av=acc["vhbt_av"] + w_t * vhbt,
        ubt_av=acc["ubt_av"] + w_v * ubt,
        vbt_av=acc["vbt_av"] + w_v * vbt,
        eta_av=acc["eta_av"] + w_v * eta,
        u_acc=acc["u_acc"] + w_t * uac,
        v_acc=acc["v_acc"] + w_t * vac,
    )


def _acc_zero(ubt_in, vbt_in, eta_in):
    z2u = torch.zeros_like(ubt_in)
    z2v = torch.zeros_like(vbt_in)
    z2h = torch.zeros_like(eta_in)
    return dict(uhbt_av=z2u, vhbt_av=z2v, ubt_av=z2u, vbt_av=z2v,
                eta_av=z2h, u_acc=z2u, v_acc=z2v)


def _run_subcycle_dense(half_step, evolve0, wt_trans, wt_vel,
                        nstep: int, nfilter: int, first_u_leads: bool):
    """The substeps in pairs (u-first/v-first fixed inside a pair), then
    a trailing odd substep.  ``wt_trans``/``wt_vel`` are sequences of
    Python floats already rounded to the working precision."""
    ubt, vbt, eta, uhbt, vhbt = evolve0
    n_tot = nstep + nfilter
    acc = _acc_zero(ubt, vbt, eta)
    for p in range(n_tot // 2):
        o1 = half_step(ubt, vbt, eta, uhbt, vhbt, first_u_leads)
        acc = _acc_add(acc, wt_trans[2 * p], wt_vel[2 * p], o1)
        o2 = half_step(o1[0], o1[1], o1[2], o1[3], o1[4],
                       not first_u_leads)
        acc = _acc_add(acc, wt_trans[2 * p + 1], wt_vel[2 * p + 1], o2)
        ubt, vbt, eta, uhbt, vhbt = o2[:5]
    if n_tot % 2 == 1:
        o = half_step(ubt, vbt, eta, uhbt, vhbt, first_u_leads)
        acc = _acc_add(acc, wt_trans[-1], wt_vel[-1], o)
        ubt, vbt, eta = o[0], o[1], o[2]
    return dict(acc, ubt=ubt, vbt=vbt, eta=eta)


def btstep(u_in, v_in, eta_in, bc_accel_u, bc_accel_v, h, uh_in, vh_in,
           visc_rem_u, visc_rem_v, pbce, eta_PF, dt, G, GV,
           params: BTParams, taux=None, tauy=None, x_first: bool = True,
           bt_cont=None, obc=None, rigidity_ice=None, u_uh0=None,
           v_uh0=None) -> BTOut:
    """One barotropic cycle covering a baroclinic step of length ``dt``
    (dense path).  ``bt_cont``: the BTCont curves (set_bt_cont), used
    with ``params.use_bt_cont``; ``obc``: an OBCParams, the open
    boundaries inside each substep; ``rigidity_ice``: the coupler's (ny,
    nx) ice rigidity [m3 s-1], which with ``params.dynamic_psurf`` sets
    the viscous surface pressure under the ice.  ``u_uh0``/``v_uh0``:
    the velocities that produced ``uh_in``/``vh_in`` where they are not
    ``u_in``/``v_in`` (the RK2b corrector's transports come from the
    time-filtered velocities, its initial velocity is the instantaneous
    one); the transport mismatch uhbt0 is taken at their barotropic
    projection."""
    np_dtype = np.float32 if u_in.dtype == torch.float32 else np.float64
    rnd = lambda x: float(np_dtype(x))     # round a scalar to the dtype
    nstep, nfilter = params.nstep, params.nfilter
    dtbt = rnd(dt / nstep)
    bebt = rnd(params.bebt)
    dgeo = rnd(params.dgeo_de)

    h_u, h_v, frac_u, frac_v = btcalc(h, G)
    tot_hu = vsum(h_u)
    tot_hv = vsum(h_v)
    Datu = G.dyCu * tot_hu * G.mask2dCu
    Datv = G.dxCv * tot_hv * G.mask2dCv

    # barotropic projections of the 3-D state (btstep_ubt_from_layer)
    wt_u = frac_u * visc_rem_u
    wt_v = frac_v * visc_rem_v
    norm_u = torch.clamp(vsum(wt_u), min=1e-30)
    norm_v = torch.clamp(vsum(wt_v), min=1e-30)
    ubt_in = vsum(wt_u * u_in) / norm_u
    vbt_in = vsum(wt_v * v_in) / norm_v

    # the transports of the velocities, linear or the BT_cont curves,
    # offset by the layer-sum transport mismatch at the initial velocities
    if params.use_bt_cont and bt_cont is not None:
        def curves(ubt, vbt):
            return find_uhbt(ubt, bt_cont), find_vhbt(vbt, bt_cont)
    else:
        def curves(ubt, vbt):
            return Datu * ubt, Datv * vbt
    ubt_uh0, vbt_uh0 = ubt_in, vbt_in
    if u_uh0 is not None:
        ubt_uh0 = vsum(wt_u * u_uh0) / norm_u
        vbt_uh0 = vsum(wt_v * v_uh0) / norm_v
    uh_c, vh_c = curves(ubt_uh0, vbt_uh0)
    uhbt0 = vsum(uh_in) - uh_c
    vhbt0 = vsum(vh_in) - vh_c

    def transports(ubt, vbt):
        uh, vh = curves(ubt, vbt)
        return uh + uhbt0, vh + vhbt0

    frac_h = h / torch.clamp(vsum(h, keepdim=True), min=1e-30)
    gtot = vsum(frac_h * pbce)

    bt_force_u = vsum(wt_u * bc_accel_u) / norm_u
    bt_force_v = vsum(wt_v * bc_accel_v) / norm_v
    if taux is not None:
        bt_force_u = bt_force_u + taux / (
            GV.rho0 * torch.clamp(tot_hu, min=1e-10))
    if tauy is not None:
        bt_force_v = bt_force_v + tauy / (
            GV.rho0 * torch.clamp(tot_hv, min=1e-10))
    bt_force_u = bt_force_u * G.mask2dCu
    bt_force_v = bt_force_v * G.mask2dCv

    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    kus = "us" if fold else None
    ku = "u" if fold else None
    d_q = 0.25 * (tot_hu + jp1(tot_hu, kus) + tot_hv + ip1(tot_hv))
    q_f = G.CoriolisBu / torch.clamp(d_q, min=1e-3)
    cor_ref_u = _coriolis_u(q_f, tot_hv * vbt_in)
    cor_ref_v = _coriolis_v(q_f, tot_hu * ubt_in, ku)

    # implicit barotropic drag r = (lin + cdrag |u0|) / H_face; lin_drag
    # is a number or a (ny, nx) piston-velocity map at the T points (the
    # tidal wave drag), averaged to the faces
    drag_u = drag_v = None
    lin_is_map = torch.is_tensor(params.lin_drag)
    if lin_is_map or params.lin_drag > 0.0 or params.cdrag > 0.0:
        if lin_is_map:
            lin_u = 0.5 * (params.lin_drag + ip1(params.lin_drag))
            lin_v = 0.5 * (params.lin_drag + jp1(params.lin_drag, kh))
        else:
            lin_u = lin_v = params.lin_drag
        rdrag_u = (lin_u + params.cdrag * torch.abs(ubt_in)) \
            / torch.clamp(tot_hu, min=1e-3)
        rdrag_v = (lin_v + params.cdrag * torch.abs(vbt_in)) \
            / torch.clamp(tot_hv, min=1e-3)
        drag_u = 1.0 / (1.0 + dtbt * rdrag_u)
        drag_v = 1.0 / (1.0 + dtbt * rdrag_v)

    wt_trans, wt_vel, _ = _weights(nstep, nfilter, x_first)
    wt_trans = [rnd(w) for w in wt_trans]
    wt_vel = [rnd(w) for w in wt_vel]

    # per-substep viscous remnant bt_rem = (sum frac*visc_rem)^(1/nstep)
    av_rem_u = vsum(frac_u * visc_rem_u)
    av_rem_v = vsum(frac_v * visc_rem_v)
    instep = rnd(1.0 / max(nstep, 1))
    zero = torch.zeros((), dtype=u_in.dtype, device=u_in.device)
    bt_rem_u = torch.where(av_rem_u > 0.0,
                           cpow(torch.clamp(av_rem_u, min=1e-30), instep),
                           zero) * G.mask2dCu
    bt_rem_v = torch.where(av_rem_v > 0.0,
                           cpow(torch.clamp(av_rem_v, min=1e-30), instep),
                           zero) * G.mask2dCv

    # the open boundaries inside the subcycle, on apply_obc's faces; the
    # SPECIFIED faces take their depth-mean inflow with no wave speed
    obc_fields = {}
    if obc is not None:
        c_fl = csqrt(rdiv(GV.g_earth, torch.clamp(G.bathyT, min=1.0)))
        c_u, c_v = c_fl, c_fl
        mask_u_all, mask_v_all = obc.mask_u, obc.mask_v
        if obc.mask_u_spec is not None:
            c_u = c_fl * (1.0 - obc.mask_u_spec)
            mask_u_all = torch.clamp(obc.mask_u + obc.mask_u_spec, 0.0, 1.0)
        if obc.mask_v_spec is not None:
            c_v = c_fl * (1.0 - obc.mask_v_spec)
            mask_v_all = torch.clamp(obc.mask_v + obc.mask_v_spec, 0.0, 1.0)
        obc_fields = dict(
            obc_mask_u=mask_u_all, obc_mask_v=mask_v_all,
            obc_mask_cell=obc.mask_cell, obc_sign_u=obc.sign_u,
            obc_sign_v=obc.sign_v, obc_uvel_ext=obc.uvel_ext,
            obc_vvel_ext=obc.vvel_ext, obc_eta_ext=obc.eta_ext,
            obc_c_fl_u=c_u, obc_c_fl_v=c_v)

    # the viscous surface pressure under rigid ice: dyn_coef relates
    # d(eta) over a substep to a pressure, capped by the substep's
    # gravity-wave stability limit; the T-point rigidity stands in for the
    # sum over the four faces (4 rigidity)
    dyn_coef = None
    if params.dynamic_psurf and rigidity_ice is not None:
        f = np_dtype
        du_dx = Datu * G.IdxCu
        dv_dy = Datv * G.IdyCv
        open_sum = (du_dx + im1(du_dx)) + (dv_dy + jm1_s0(dv_dy, kh))
        f2 = G.CoriolisBu ** 2
        f2_sum = (f2 + im1(f2)) + (jm1(f2) + im1(jm1(f2)))
        c_bebt = float(f(0.5) * (f(dgeo) * (f(1.0) + f(2.0) * f(bebt))))
        idt_max2 = c_bebt * (G.IareaT * gtot * open_sum + f2_sum)
        h_eff_dx2 = torch.maximum(
            params.dmin_dyn_psurf * (G.IdxT ** 2 + G.IdyT ** 2),
            G.IareaT * open_sum)
        dtbt2 = float(f(dtbt) ** 2)
        dyn_coef_max = params.const_dyn_psurf \
            * torch.clamp(1.0 - dtbt2 * idt_max2, min=0.0) \
            / (dtbt2 * h_eff_dx2)
        l2dt = float(f(params.ice_strength_length ** 2) * f(dtbt))
        ice_strength = sdiv(4.0 * rigidity_ice, l2dt)
        dyn_coef = torch.minimum(dyn_coef_max, ice_strength) * G.mask2dT

    F = BTFields(
        eta_PF=eta_PF, gtot=gtot, bt_force_u=bt_force_u,
        bt_force_v=bt_force_v, q_f=q_f, tot_hu=tot_hu, tot_hv=tot_hv,
        cor_ref_u=cor_ref_u, cor_ref_v=cor_ref_v,
        rem_u=bt_rem_u, rem_v=bt_rem_v,
        mask_u=G.mask2dCu, mask_v=G.mask2dCv, IareaT=G.IareaT,
        IdxCu=G.IdxCu, IdyCv=G.IdyCv, drag_u=drag_u, drag_v=drag_v,
        dyn_coef=dyn_coef, **obc_fields)
    sal_fac = rnd(1.0 - params.sal_scalar)
    consts = dict(dtbt=dtbt, bebt=bebt, geo=rnd(dgeo * sal_fac))

    uhbt_0, vhbt_0 = transports(ubt_in, vbt_in)
    evolve0 = (ubt_in, vbt_in, eta_in, uhbt_0, vhbt_0)
    mesh = stencil._MESH
    w_eff = params.wide_halo
    if w_eff < 0 and mesh is not None:         # AUTO (BT_WIDE_HALO = -1)
        w_eff = auto_wide_halo(params, (mesh.ny, mesh.nx))
    if w_eff > 0 and mesh is not None:
        if params.use_bt_cont and bt_cont is not None:
            curves = dict(btc=bt_cont)
        else:
            curves = dict(Datu=Datu, Datv=Datv)
        carry = run_subcycle_widehalo(
            F, dict(curves, uhbt0=uhbt0, vhbt0=vhbt0), consts, evolve0,
            wt_trans, wt_vel, nstep, nfilter, bool(x_first), int(w_eff),
            max(1, int(params.halo_per_substep)), G, mesh, _make_half_step,
            _acc_zero, _acc_add)
    else:
        half_step = _make_half_step(F, consts, dense_kit(G), transports)
        carry = _run_subcycle_dense(half_step, evolve0, wt_trans, wt_vel,
                                    nstep, nfilter,
                                    first_u_leads=bool(x_first))

    e_anom = dgeo * (carry["eta_av"] - eta_PF)
    # per-layer acceleration (btstep_layer_accel)
    pg = (pbce - gtot[None]) * e_anom[None]
    alu = (carry["u_acc"][None] - (ip1(pg) - pg) * G.IdxCu) * G.mask2dCu
    alv = (carry["v_acc"][None] - (jp1(pg, kh) - pg) * G.IdyCv) \
        * G.mask2dCv
    return BTOut(
        accel_layer_u=alu, accel_layer_v=alv,
        uhbt_av=carry["uhbt_av"], vhbt_av=carry["vhbt_av"],
        ubt_av=carry["ubt_av"], vbt_av=carry["vbt_av"],
        eta_out=carry["eta"], e_anom=e_anom)
