"""Open boundary conditions (twin of mom6_tpu/core/open_boundary.py).

A segment is an edge strip (N/S/E/W and an index range) with exterior
data (sea surface height, normal velocity, T, S).  ``build_obc`` turns
the segments into dense (ny, nx) masks and data once, on the host, and
puts them on the caller's device; ``apply_obc`` is masked arithmetic on
the state after each dynamics step:

* FLATHER radiation of the barotropic normal flow,
  u_b = u_ext +- sqrt(g/D) (eta - eta_ext), on every layer of the face
  (the barotropic solver applies it inside each substep as well);
* ORLANSKI radiation of the layer velocities, the outward phase speed
  rx = clip(dhdt/dhdx) diagnosed from the previous step's velocities,
  u_B <- (u_B + rx u_{B-1}) / (1 + rx);
* OBLIQUE radiation, which adds the upwinded tangential phase speed;
* GRADIENT, u_B <- u_{B-1};
* SPECIFIED faces clamped to per-layer inflow profiles;
* the exterior strip's column rescaled to the exterior surface height,
  and its tracers relaxed to the exterior values.

``update_tracer_reservoirs`` advances the per-cell tracer reservoirs of
the strip.  As in the reference, the updates act on the last interior
face (the wall face stays masked) and the outermost cell row is the
exterior reservoir.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mom6_tpu_torch.framework.arith import rdiv, vsum
from mom6_tpu_torch.framework.containers import TensorDataclass
from mom6_tpu_torch.framework.device import DEFAULT_DEVICE, resolve_device
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["OBCSegment", "OBCParams", "OBCData", "build_obc",
           "apply_obc", "merge_obc_data", "segment_slices",
           "update_tracer_reservoirs"]

FLATHER = "FLATHER"
ORLANSKI = "ORLANSKI"
OBLIQUE = "OBLIQUE"
GRADIENT = "GRADIENT"
SPECIFIED = "SPECIFIED"
SCHEMES = (FLATHER, ORLANSKI, OBLIQUE, GRADIENT, SPECIFIED)
# the CFL cap on the phase speed that Orlanski and oblique diagnose
RX_MAX = 1.0


class OBCSegment(NamedTuple):
    edge: str                      # 'N' | 'S' | 'E' | 'W'
    lo: int = 0                    # first index along the edge
    hi: int = -1                   # end index (exclusive; -1: to the end)
    eta_ext: float = 0.0           # exterior sea surface height [m]
    vel_ext: float = 0.0           # exterior normal velocity [m s-1]
    T_ext: Optional[float] = None
    S_ext: Optional[float] = None
    nudge_timescale: float = 3600.0
    # one scheme of SCHEMES, or several joined with '+' (the reference's
    # lists such as "FLATHER,ORLANSKI")
    scheme: str = FLATHER
    # SPECIFIED per-layer data: normal velocity (nz, seg_len) or (nz,),
    # tracer profiles (nz,) or (nz, seg_len); host arrays
    vel_profile: Optional[object] = None
    T_profile: Optional[object] = None
    S_profile: Optional[object] = None


@dataclasses.dataclass(frozen=True, eq=False)
class OBCParams(TensorDataclass):
    """The dense masks and data of the segments.  Two are equal when
    every field is, tensors to the bit."""
    mask_u: torch.Tensor           # (ny, nx) 1 on zonal FLATHER faces
    mask_v: torch.Tensor
    sign_u: torch.Tensor           # +1 at an east boundary, -1 at west
    sign_v: torch.Tensor
    eta_ext: torch.Tensor          # at the exterior strip's cells
    uvel_ext: torch.Tensor
    vvel_ext: torch.Tensor
    mask_cell: torch.Tensor        # the exterior strip's cells
    T_ext: Optional[torch.Tensor] = None   # (ny, nx) or (nz, ny, nx)
    S_ext: Optional[torch.Tensor] = None
    inv_tau: Optional[torch.Tensor] = None
    # faces of the radiation schemes; the sign arrays select the interior
    # direction
    mask_u_rad: Optional[torch.Tensor] = None
    mask_v_rad: Optional[torch.Tensor] = None
    mask_u_obl: Optional[torch.Tensor] = None
    mask_v_obl: Optional[torch.Tensor] = None
    mask_u_grad: Optional[torch.Tensor] = None
    mask_v_grad: Optional[torch.Tensor] = None
    # tracer reservoir length scales [m] of inflow and outflow; 0 turns
    # the reservoirs off
    res_len_in: float = 0.0
    res_len_out: float = 0.0
    # SPECIFIED faces and their (nz, ny, nx) velocity profiles
    mask_u_spec: Optional[torch.Tensor] = None
    mask_v_spec: Optional[torch.Tensor] = None
    uvel_spec: Optional[torch.Tensor] = None
    vvel_spec: Optional[torch.Tensor] = None

    def __eq__(self, other):
        if not isinstance(other, OBCParams):
            return NotImplemented
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
                if not (isinstance(a, torch.Tensor)
                        and isinstance(b, torch.Tensor)
                        and torch.equal(a, b)):
                    return False
            elif a != b:
                return False
        return True


def segment_slices(edge: str, lo: int, hi: int, ny: int, nx: int):
    """(face slice, cell slice) of a segment in the dense (ny, nx)
    arrays: the last interior u/v face and the outermost cell strip."""
    hi = hi if hi >= 0 else (nx if edge in "NS" else ny)
    if edge == "E":
        return (slice(lo, hi), -2), (slice(lo, hi), -1)
    if edge == "W":
        return (slice(lo, hi), 0), (slice(lo, hi), 0)
    if edge == "N":
        return (-2, slice(lo, hi)), (-1, slice(lo, hi))
    if edge == "S":
        return (0, slice(lo, hi)), (0, slice(lo, hi))
    raise ValueError(f"bad OBC edge {edge}")


@dataclasses.dataclass(frozen=True)
class OBCData(TensorDataclass):
    """Time-dependent dense replacements of OBCParams' exterior data,
    which the forcing provider makes each coupling interval
    (update_OBC_segment_data)."""
    eta_ext: Optional[torch.Tensor] = None
    uvel_ext: Optional[torch.Tensor] = None
    vvel_ext: Optional[torch.Tensor] = None
    T_ext: Optional[torch.Tensor] = None
    S_ext: Optional[torch.Tensor] = None


def merge_obc_data(obc: OBCParams, data: Optional[OBCData]) -> OBCParams:
    """``obc`` with the fields that ``data`` sets."""
    if data is None:
        return obc
    rep = {f.name: getattr(data, f.name) for f in dataclasses.fields(data)
           if getattr(data, f.name) is not None}
    return obc.replace(**rep)


def _schemes(seg: OBCSegment):
    out = [s.strip().upper() for s in seg.scheme.split("+") if s.strip()]
    for sch in out:
        if sch not in SCHEMES:
            raise ValueError(f"OBC scheme {sch!r}: expected one of "
                             f"{sorted(SCHEMES)}")
    return out


def build_obc(segments: List[OBCSegment], ny: int, nx: int,
              dtype=torch.float32, *, res_len_in: float = 0.0,
              res_len_out: float = 0.0, nz: int = 0,
              device=DEFAULT_DEVICE) -> OBCParams:
    """The segments as dense masks and data on ``device`` (the card
    unless the caller asks for the CPU), built in float64 numpy and cast
    once to ``dtype``.  ``nz`` is needed where a segment is SPECIFIED or
    carries tracer profiles (those become (nz, ny, nx))."""
    device = resolve_device(device)

    def z():
        return np.zeros((ny, nx))
    masks = {sch: (z(), z()) for sch in SCHEMES}      # (u faces, v faces)
    us3 = vs3 = None
    su, sv = z(), z()
    eta, ue, ve, mc, te, se, itau = z(), z(), z(), z(), z(), z(), z()
    prof_writes = []
    any_ts = False
    for seg in segments:
        schemes = _schemes(seg)
        sl, cell = segment_slices(seg.edge, seg.lo, seg.hi, ny, nx)
        if SPECIFIED in schemes:
            if seg.vel_profile is None or nz <= 0:
                raise ValueError("SPECIFIED OBC segments need a "
                                 "vel_profile and build_obc(..., nz=nz)")
            prof = np.asarray(seg.vel_profile, np.float64)
            if prof.ndim == 1:
                prof = prof[:, None]
            prof = np.broadcast_to(prof, (nz, su[sl].size))
            if seg.edge in ("E", "W"):
                if us3 is None:
                    us3 = np.zeros((nz, ny, nx))
                us3[(slice(None),) + sl] = prof
                ue[sl] = prof.mean(axis=0)    # the barotropic clamp
            else:
                if vs3 is None:
                    vs3 = np.zeros((nz, ny, nx))
                vs3[(slice(None),) + sl] = prof
                ve[sl] = prof.mean(axis=0)
        for sch in schemes:
            if seg.edge in ("E", "W"):
                masks[sch][0][sl] = 1.0
                su[sl] = 1.0 if seg.edge == "E" else -1.0
            else:
                masks[sch][1][sl] = 1.0
                sv[sl] = 1.0 if seg.edge == "N" else -1.0
            if sch != SPECIFIED:
                (ue if seg.edge in ("E", "W") else ve)[sl] = seg.vel_ext
        mc[cell] = 1.0
        eta[cell] = seg.eta_ext
        itau[cell] = 1.0 / max(seg.nudge_timescale, 1e-6)
        if seg.T_ext is not None:
            te[cell] = seg.T_ext
            any_ts = True
        if seg.S_ext is not None:
            se[cell] = seg.S_ext
        if seg.T_profile is not None or seg.S_profile is not None:
            any_ts = True
            prof_writes.append((cell, seg.T_profile, seg.S_profile))

    # the tracer data become (nz, ny, nx) only where a profile was given
    if prof_writes:
        if nz <= 0:
            raise ValueError("tracer profiles need build_obc(..., nz=nz)")
        te3 = np.broadcast_to(te, (nz, ny, nx)).copy()
        se3 = np.broadcast_to(se, (nz, ny, nx)).copy()
        for cell, tp, sp in prof_writes:
            for a3, a2, p in ((te3, te, tp), (se3, se, sp)):
                if p is not None:
                    a3[(slice(None),) + cell] = np.broadcast_to(
                        np.asarray(p, np.float64).reshape(nz, -1),
                        (nz, a2[cell].size))
        te, se = te3, se3

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    def opt(a):
        return t(a) if a is not None and a.any() else None

    return OBCParams(
        mask_u=t(masks[FLATHER][0]), mask_v=t(masks[FLATHER][1]),
        sign_u=t(su), sign_v=t(sv), eta_ext=t(eta), uvel_ext=t(ue),
        vvel_ext=t(ve), mask_cell=t(mc),
        T_ext=t(te) if any_ts else None, S_ext=t(se) if any_ts else None,
        inv_tau=t(itau),
        mask_u_rad=opt(masks[ORLANSKI][0]),
        mask_v_rad=opt(masks[ORLANSKI][1]),
        mask_u_obl=opt(masks[OBLIQUE][0]), mask_v_obl=opt(masks[OBLIQUE][1]),
        mask_u_grad=opt(masks[GRADIENT][0]),
        mask_v_grad=opt(masks[GRADIENT][1]),
        res_len_in=res_len_in, res_len_out=res_len_out,
        mask_u_spec=opt(masks[SPECIFIED][0]),
        mask_v_spec=opt(masks[SPECIFIED][1]),
        uvel_spec=None if us3 is None else t(us3),
        vvel_spec=None if vs3 is None else t(vs3))


def _where0(cond, a):
    """``a`` where ``cond``, else 0."""
    return torch.where(cond, a, torch.zeros_like(a))


def _radiate_normal(w, w_old, sign, mask_rad, mask_obl, mask_grad,
                    shift_in_pos, shift_in_neg, tshift_m, tshift_p):
    """Orlanski, oblique and gradient updates of the normal velocity ``w``
    on their faces (MOM_open_boundary.F90:2486-2545).  ``shift_in_pos``
    steps one cell inward on sign > 0 edges (E/N), ``shift_in_neg`` on
    sign < 0 edges; ``tshift_m/p`` are the tangential shifts."""
    pos = sign[None] > 0

    def inward(a):
        return torch.where(pos, shift_in_pos(a), shift_in_neg(a))

    nb1 = inward(w)
    nb2 = torch.where(pos, shift_in_pos(shift_in_pos(w)),
                      shift_in_neg(shift_in_neg(w)))
    dhdt = torch.zeros_like(w) if w_old is None else inward(w_old) - nb1
    dhdx = nb1 - nb2
    out = w
    if mask_rad is not None:
        ratio = dhdt * dhdx / (dhdx * dhdx + 1e-20)
        rx = torch.clamp(_where0(dhdt * dhdx > 0.0, ratio), 0.0, RX_MAX)
        w_rad = (w + rx * nb1) / (1.0 + rx)
        out = out * (1.0 - mask_rad)[None] + (mask_rad[None] * w_rad)
    if mask_obl is not None:
        gj_m = nb1 - tshift_m(nb1)
        gj_p = tshift_p(nb1) - nb1
        ssel = dhdt * (gj_m + gj_p)
        dhdy = torch.where(ssel > 0.0, gj_m, _where0(ssel < 0.0, gj_p))
        dhdt0 = _where0(~(dhdt * dhdx < 0.0), dhdt)
        cff = torch.clamp(dhdx * dhdx + dhdy * dhdy, min=1e-20)
        rx = torch.minimum(dhdt0 * dhdx, cff * RX_MAX)
        ry = torch.clamp(dhdt0 * dhdy, min=-cff, max=cff)
        bj_m = w - tshift_m(w)
        bj_p = tshift_p(w) - w
        w_obl = (cff * w + rx * nb1
                 - (torch.clamp(ry, min=0.0) * bj_m
                    + torch.clamp(ry, max=0.0) * bj_p)) / (cff + rx)
        out = out * (1.0 - mask_obl)[None] + (mask_obl[None] * w_obl)
    if mask_grad is not None:
        out = out * (1.0 - mask_grad)[None] + (mask_grad[None] * nb1)
    return out


def apply_obc(state, obc: OBCParams, G, GV, dt, u_old=None, v_old=None):
    """The open boundaries after a dynamics step: the radiation schemes,
    Flather, the SPECIFIED clamp, the exterior strip's surface height and
    tracer relaxation.  ``u_old``/``v_old`` are the previous step's
    velocities, from which Orlanski and oblique diagnose the phase speed
    (without them those faces are clamped)."""
    h = state.h
    eta = vsum(h) - G.bathyT
    d = torch.clamp(G.bathyT, min=1.0)
    c_fac = torch.sqrt(rdiv(GV.g_earth, d))
    # Flather's eta is taken on the interior side of each face: the face's
    # own cell on E/N edges, one cell inward on W/S edges
    east_u, north_v = obc.sign_u >= 0.0, obc.sign_v >= 0.0
    eta_u = torch.where(east_u, eta, ip1(eta))
    eta_v = torch.where(north_v, eta, jp1(eta))
    u_fl = obc.uvel_ext + obc.sign_u * c_fac * (eta_u - obc.eta_ext)
    v_fl = obc.vvel_ext + obc.sign_v * c_fac * (eta_v - obc.eta_ext)

    m_u_bc = sum((m for m in (obc.mask_u_rad, obc.mask_u_obl,
                              obc.mask_u_grad) if m is not None),
                 torch.zeros_like(obc.mask_u))
    m_v_bc = sum((m for m in (obc.mask_v_rad, obc.mask_v_obl,
                              obc.mask_v_grad) if m is not None),
                 torch.zeros_like(obc.mask_v))
    m_u_both = torch.clamp(obc.mask_u * m_u_bc, 0.0, 1.0)
    m_v_both = torch.clamp(obc.mask_v * m_v_bc, 0.0, 1.0)

    # the baroclinic radiation schemes act on the velocities before Flather
    u, v = state.u, state.v
    if any(m is not None for m in (obc.mask_u_rad, obc.mask_u_obl,
                                   obc.mask_u_grad)):
        u = _radiate_normal(u, u_old, obc.sign_u, obc.mask_u_rad,
                            obc.mask_u_obl, obc.mask_u_grad,
                            im1, ip1, jm1, jp1)
    if any(m is not None for m in (obc.mask_v_rad, obc.mask_v_obl,
                                   obc.mask_v_grad)):
        v = _radiate_normal(v, v_old, obc.sign_v, obc.mask_v_rad,
                            obc.mask_v_obl, obc.mask_v_grad,
                            jm1, jp1, im1, ip1)

    # Flather: faces with it alone take the barotropic value in every
    # layer; faces with a radiation scheme as well keep the radiated layer
    # structure and have its thickness-weighted mean set to it
    h_u = torch.where(east_u[None], h, ip1(h))
    h_v = torch.where(north_v[None], h, jp1(h))
    ubar = vsum(h_u * u) / torch.clamp(vsum(h_u), min=1e-10)
    vbar = vsum(h_v * v) / torch.clamp(vsum(h_v), min=1e-10)
    m_u_only = obc.mask_u * (1.0 - m_u_both)
    m_v_only = obc.mask_v * (1.0 - m_v_both)
    u = (u * (1.0 - m_u_only)[None] + (m_u_only * u_fl)[None]
         + (m_u_both * (u_fl - ubar))[None])
    v = (v * (1.0 - m_v_only)[None] + (m_v_only * v_fl)[None]
         + (m_v_both * (v_fl - vbar))[None])

    # SPECIFIED faces: every layer clamped to the inflow profile
    if obc.mask_u_spec is not None:
        u = u * (1.0 - obc.mask_u_spec)[None] \
            + obc.mask_u_spec[None] * obc.uvel_spec
    if obc.mask_v_spec is not None:
        v = v * (1.0 - obc.mask_v_spec)[None] \
            + obc.mask_v_spec[None] * obc.vvel_spec

    # the exterior strip's columns take the exterior surface height (the
    # open boundary exchanges volume with the exterior)
    col = torch.clamp(vsum(h), min=1e-10)
    col_ext = torch.clamp(d + obc.eta_ext, min=1e-3)
    scale = torch.where(obc.mask_cell > 0.5, col_ext / col,
                        torch.ones_like(col))
    out = state.replace(h=h * scale[None], u=u * G.mask2dCu,
                        v=v * G.mask2dCv)

    # the strip's tracers relax to the exterior values, uniform in k or
    # per layer
    if obc.T_ext is not None and state.T is not None:
        w = (dt * obc.inv_tau * obc.mask_cell)[None]
        denom = rdiv(1.0, 1.0 + w)
        t_ext = obc.T_ext if obc.T_ext.dim() == 3 else obc.T_ext[None]
        s_ext = obc.S_ext if obc.S_ext.dim() == 3 else obc.S_ext[None]
        out = out.replace(
            T=(out.T + w * t_ext) * denom,
            S=(out.S + w * s_ext) * denom if state.S is not None else out.S)
    return out


def update_tracer_reservoirs(state, obc: OBCParams, G, dt):
    """Advance the segments' tracer reservoirs and put them on the
    exterior strip (update_segment_tracer_reservoirs,
    MOM_open_boundary.F90:41-60):

        res <- (res + a T_adjacent) / (1 + a),
        a = |u_n| dt / L,   L = L_in for inflow, L_out for outflow,

    so each reservoir relaxes toward the adjacent interior tracer at a
    rate set by the depth-mean normal flow.  Returns the state with new
    obc_res_T, obc_res_S and strip T, S."""
    if state.T is None or obc.res_len_in <= 0.0:
        return state
    res_T = state.obc_res_T if state.obc_res_T is not None else state.T
    res_S = state.obc_res_S if state.obc_res_S is not None else state.S

    col = torch.clamp(vsum(state.h), min=1e-10)
    ubar = vsum(state.h * state.u) / col
    vbar = vsum(state.h * state.v) / col
    # the edges' masks on the cell strip (E/N faces lie one index inward
    # of their strip cells, W/S faces on them)
    m_e = im1(_where0(obc.sign_u > 0.5, obc.mask_u))
    m_w = _where0(obc.sign_u < -0.5, obc.mask_u)
    m_n = jm1(_where0(obc.sign_v > 0.5, obc.mask_v))
    m_s = _where0(obc.sign_v < -0.5, obc.mask_v)
    msum = m_e + m_w + m_n + m_s
    on_strip = torch.clamp(msum, 0.0, 1.0)
    strip = on_strip[None] > 0.5
    inv = rdiv(1.0, torch.clamp(msum, min=1.0))
    # the outward depth-mean normal flow at the strip's cells
    u_norm = (m_e * im1(ubar) - m_w * ubar
              + m_n * jm1(vbar) - m_s * vbar) * inv
    L = torch.where(u_norm >= 0.0, u_norm.new_tensor(obc.res_len_out),
                    u_norm.new_tensor(obc.res_len_in))
    a = torch.abs(u_norm) * dt / torch.clamp(L, min=1e-3)

    def adjacent(f):
        adj = (m_e[None] * im1(f) + m_w[None] * ip1(f)
               + m_n[None] * jm1(f) + m_s[None] * jp1(f)) * inv[None]
        return torch.where(strip, adj, f)

    w = (a * on_strip)[None]
    res_T = (res_T + w * adjacent(state.T)) / (1.0 + w)
    res_S = (res_S + w * adjacent(state.S)) / (1.0 + w)
    return state.replace(T=torch.where(strip, res_T, state.T),
                         S=torch.where(strip, res_S, state.S),
                         obc_res_T=res_T, obc_res_S=res_S)
