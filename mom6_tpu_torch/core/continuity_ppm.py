"""Finite-volume thickness transport with PPM reconstruction
(twin of mom6_tpu/core/continuity_ppm.py).

Each directional pass is two kernels, on the schedule of the reference's
XLA path: the edge reconstruction (``zonal_edges``/``merid_edges``) runs
once per continuity call, and the face flux (``zonal_flux``/
``merid_flux``) once plus once per Newton iterate of the barotropic flux
adjustment.  On a CUDA tensor each launches the hand-written kernel of
``csrc/ppm_continuity.cu``, which replaces the Pallas kernels
``mom6_tpu/core/pallas_continuity.py::_zonal_kernel`` and
``::_merid_kernel``; on a CPU tensor each runs its plain PyTorch version
(``_recon_core`` and ``_flux_pre_core`` + ``_flux_eval_core``, the same
operations in the same order).  The y pass serves the periodic wrap and,
with ``fold=True``, the tripolar northern fold: there the j+1 neighbour
of the top row is the x-mirrored top row, its slope changes sign and its
south/north edge pair swaps.  The Newton bookkeeping (column sums, the
``du`` update and its clip) stays in PyTorch.

``set_bt_cont`` builds the barotropic solver's transport response curves
(BT_cont, USE_BT_CONT_TYPE) from one more x and y edge reconstruction of
the step's starting thickness, through the same ``zonal_edges`` and
``merid_edges``; ``find_uhbt``/``find_vhbt`` evaluate them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mom6_tpu_torch.framework.arith import rdiv, vsum
from mom6_tpu_torch.framework import kernels
from mom6_tpu_torch.framework.stencil import (im1, ip1, jm1, jm1_s0, jp1,
                                              jp1_sn)

__all__ = ["continuity_ppm", "zonal_mass_flux", "meridional_mass_flux",
           "zonal_edges", "merid_edges", "zonal_flux", "merid_flux",
           "BTCont", "set_bt_cont", "find_uhbt", "find_vhbt"]

# fixed Newton iterates of the barotropic flux adjustment (as the
# reference: f32 round-off after 3)
_N_NEWTON = 3

_DIR_X, _DIR_Y = 0, 1
_LIM_POS, _LIM_CW84, _LIM_SIMPLE2 = 0, 1, 2


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _ppm_edges(h, hm, hp, mask_m, mask_c, mask_p, h_min, monotonic):
    """Masked neighbours and the Lin (1994) limited slope, zeroed at
    coasts.  Returns (h_m, h_p, slp)."""
    h_m = mask_m * hm + (1.0 - mask_m) * h
    h_p = mask_p * hp + (1.0 - mask_p) * h
    slp = 0.5 * (h_p - h_m)
    dMx = torch.maximum(torch.maximum(h_p, h_m), h) - h
    dMn = h - torch.minimum(torch.minimum(h_p, h_m), h)
    slp = torch.sign(slp) * torch.minimum(torch.abs(slp),
                                          2.0 * torch.minimum(dMx, dMn))
    slp = slp * (mask_m * mask_c * mask_p)
    return h_m, h_p, slp


def _ppm_limit_pos(h, h_L, h_R, h_min):
    """Positive-definite limiter (PPM_limit_pos)."""
    curv = 3.0 * ((h_L + h_R) - 2.0 * h)
    dh = h_R - h_L
    min_inside = (curv > 0.0) & (torch.abs(dh) < curv)
    flatten = min_inside & (h <= h_min)
    denom = curv * curv + 3.0 * dh * dh
    num = 12.0 * curv * (h - h_min)
    needs_scale = min_inside & (~flatten) & (num < denom)
    scale = torch.where(needs_scale,
                        num / torch.clamp(denom, min=1e-30),
                        torch.ones_like(h))
    h_L2 = h + scale * (h_L - h)
    h_R2 = h + scale * (h_R - h)
    return torch.where(flatten, h, h_L2), torch.where(flatten, h, h_R2)


def _ppm_limit_cw84(h, h_L, h_R):
    """Colella & Woodward (1984) monotonic limiter."""
    not_mono = (h_R - h) * (h - h_L) <= 0.0
    rl_diff = h_R - h_L
    rl_mean = 0.5 * (h_R + h_L)
    fun_fac = 6.0 * rl_diff * (h - rl_mean)
    rl_diff2 = rl_diff * rl_diff
    h_L2 = torch.where(fun_fac > rl_diff2, 3.0 * h - 2.0 * h_R, h_L)
    h_R2 = torch.where(fun_fac < -rl_diff2, 3.0 * h - 2.0 * h_L, h_R)
    return torch.where(not_mono, h, h_L2), torch.where(not_mono, h, h_R2)


def _recon_core(h, mask_t, h_min, monotonic, simple_2nd, m1_fn, p1_fn,
                p1_slp_fn):
    """PPM edge values (h_L, h_R) of ``h`` along the direction of the
    shifts ``m1_fn``/``p1_fn``; ``p1_slp_fn`` is the plus-shift of the
    slope, which is antisymmetric across a tripolar fold."""
    hm, hp = m1_fn(h), p1_fn(h)
    mm, mp = m1_fn(mask_t), p1_fn(mask_t)
    if simple_2nd:
        h_m = mm * hm + (1.0 - mm) * h
        h_p = mp * hp + (1.0 - mp) * h
        return 0.5 * (h_m + h), 0.5 * (h_p + h)
    h_m, h_p, slp = _ppm_edges(h, hm, hp, mm, mask_t, mp, h_min, monotonic)
    one_sixth = 1.0 / 6.0
    h_L = 0.5 * (h_m + h) + one_sixth * (m1_fn(slp) - slp)
    h_R = 0.5 * (h_p + h) + one_sixth * (slp - p1_slp_fn(slp))
    if monotonic:
        return _ppm_limit_cw84(h, h_L, h_R)
    return _ppm_limit_pos(h, h_L, h_R, h_min)


def _flux_pre_core(h, h_L, h_R, face, d_p, d_m, p1_fn, p1_pair_fn):
    """Velocity-independent pieces of the PPM flux: ``h_L``/``h_R`` the
    upstream/downstream edges for positive flow, ``d_p``/``d_m`` = dt/dx
    of the donor cell for positive/negative flow.  ``p1_pair_fn`` shifts
    the edge pair to the plus neighbour (across a fold the pair swaps)."""
    L_p, R_p = p1_pair_fn(h_L, h_R)
    curv_p = (h_L + h_R) - 2.0 * h
    curv_m = p1_fn(curv_p)
    h_zero = 0.5 * (L_p + h_R)
    return (face, d_p, d_m, h_L, h_R, L_p, R_p, curv_p, curv_m, h_zero)


def _flux_eval_core(w, pre):
    """PPM flux and its velocity derivative at velocity ``w``: the exact
    integral of the parabola over the CFL swept region.  Returns
    (wh [m3 s-1], dwh/dw [m2])."""
    (face, d_p, d_m, h_L, h_R, L_p, R_p, curv_p, curv_m, h_zero) = pre
    cfl_p = w * d_p
    cfl_m = -w * d_m
    h_avg_p = h_R + cfl_p * (0.5 * (h_L - h_R) + curv_p * (cfl_p - 1.5))
    h_avg_m = L_p + cfl_m * (0.5 * (R_p - L_p) + curv_m * (cfl_m - 1.5))
    h_marg_p = h_R + cfl_p * ((h_L - h_R) + 3.0 * curv_p * (cfl_p - 1.0))
    h_marg_m = L_p + cfl_m * ((R_p - L_p) + 3.0 * curv_m * (cfl_m - 1.0))
    h_avg = torch.where(w > 0.0, h_avg_p,
                        torch.where(w < 0.0, h_avg_m, h_zero))
    h_marg = torch.where(w > 0.0, h_marg_p,
                         torch.where(w < 0.0, h_marg_m, h_zero))
    return face * w * h_avg, face * h_marg


def _shifts(direction, fold):
    """(minus, plus, plus of the slope, plus of the edge pair) along
    ``direction``; ``fold`` only with the y direction."""
    if direction == _DIR_X:
        if fold:
            raise ValueError("the fold is a boundary of the y direction")
        return im1, ip1, ip1, lambda l, r: (ip1(l), ip1(r))
    kh, kdh = ("h", "dh") if fold else (None, None)
    return (jm1, lambda a: jp1(a, kh), lambda a: jp1(a, kdh),
            lambda s, n: jp1_sn(s, n, kh))


def ppm_edges_plain(h, mask_t, h_min, monotonic, simple_2nd, direction,
                    fold=False):
    m1_fn, p1_fn, p1_slp_fn, _ = _shifts(direction, fold)
    return _recon_core(h, mask_t, h_min, monotonic, simple_2nd, m1_fn,
                       p1_fn, p1_slp_fn)


def ppm_edges_padded(h, mask_t, h_min, monotonic, simple_2nd, direction,
                     fold=False):
    """:func:`ppm_edges_plain` in the order of the CUDA kernel, for the
    tests: ``h`` and the mask padded along ``direction`` with two halo
    cells on each side (the wrap of torch.roll; with ``fold`` the rows
    beyond the top are the x-mirrored top rows), each limited slope formed
    once for the cells -1 .. n, then the edges from the three slopes and
    the limiter.  Two slopes are special across the fold: the image of the
    top row (position ny) is taken in its own orientation (minus and plus
    neighbours swapped) and negated, and the halo cell -1, which is the
    top row, has its fold image and not row 0 as its plus neighbour."""
    if fold and direction != _DIR_Y:
        raise ValueError("the fold is a boundary of the y direction")
    ax = -1 if direction == _DIR_X else -2
    n = h.shape[ax]
    rows = torch.arange(-2, n + 2, device=h.device) % n
    if fold:
        rows, top = rows[:n + 2], torch.tensor([n - 1, n - 2],
                                                device=h.device)

    def pad(a):
        p = a.index_select(ax, rows)
        if fold:
            p = torch.cat([p, a.index_select(ax, top).flip(-1)], dim=ax)
        return p

    def at(a, lo, hi):          # entries lo .. hi-1 along the axis
        return a.narrow(ax, lo, hi - lo)

    hp, mp = pad(h), pad(mask_t)
    hc = at(hp, 2, n + 2)
    if simple_2nd:
        h_m = at(mp, 1, n + 1) * at(hp, 1, n + 1) \
            + (1.0 - at(mp, 1, n + 1)) * hc
        h_p = at(mp, 3, n + 3) * at(hp, 3, n + 3) \
            + (1.0 - at(mp, 3, n + 3)) * hc
        return 0.5 * (h_m + hc), 0.5 * (h_p + hc)
    # positions -1 .. n: the centres and their minus and plus neighbours
    c, m_c = at(hp, 1, n + 3), at(mp, 1, n + 3)
    lo, m_lo = at(hp, 0, n + 2).clone(), at(mp, 0, n + 2).clone()
    hi, m_hi = at(hp, 2, n + 4).clone(), at(mp, 2, n + 4).clone()
    if fold:
        # position -1, the top row: its plus neighbour is its own image
        hi.select(ax, 0).copy_(h.select(ax, n - 1).flip(-1))
        m_hi.select(ax, 0).copy_(mask_t.select(ax, n - 1).flip(-1))
        # position n, the image: upside down, minus and plus swap
        for a, b in ((lo, hi), (m_lo, m_hi)):
            a_n = a.select(ax, n + 1).clone()
            a.select(ax, n + 1).copy_(b.select(ax, n + 1))
            b.select(ax, n + 1).copy_(a_n)
    hm_all, hp_all, slp = _ppm_edges(c, lo, hi, m_lo, m_c, m_hi, h_min,
                                     monotonic)
    if fold:
        slp.select(ax, n + 1).neg_()
    one_sixth = 1.0 / 6.0
    s_c = at(slp, 1, n + 1)
    h_L = 0.5 * (at(hm_all, 1, n + 1) + hc) \
        + one_sixth * (at(slp, 0, n) - s_c)
    h_R = 0.5 * (at(hp_all, 1, n + 1) + hc) \
        + one_sixth * (s_c - at(slp, 2, n + 2))
    if monotonic:
        return _ppm_limit_cw84(hc, h_L, h_R)
    return _ppm_limit_pos(hc, h_L, h_R, h_min)


def ppm_flux_plain(h, h_L, h_R, face, d_p, d_m, u, dw, rem, direction,
                   fold=False):
    _, p1_fn, _, p1_pair_fn = _shifts(direction, fold)
    pre = _flux_pre_core(h, h_L, h_R, face, d_p, d_m, p1_fn, p1_pair_fn)
    w = u if dw is None else u + dw * rem
    return _flux_eval_core(w, pre)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_cuda(name, like, *ts):
    for t in ts:
        if t.device != like.device or t.dtype != like.dtype:
            raise TypeError(f"{name}: every input must be a {like.dtype} "
                            f"tensor on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _edges_launch(name, h, mask_t, h_min, monotonic, simple_2nd, direction,
                  fold=False):
    if h.dim() != 3 or mask_t.shape != h.shape[1:]:
        raise ValueError(f"{name}: h must be (nz, ny, nx) and the mask "
                         "(ny, nx)")
    _check_cuda(name, h, h, mask_t)
    lim = _LIM_SIMPLE2 if simple_2nd else (_LIM_CW84 if monotonic
                                          else _LIM_POS)
    h_L = torch.empty_like(h)
    h_R = torch.empty_like(h)
    nz, ny, nx = h.shape
    rc = kernels.entry("mom6_ppm_edges", h.dtype)(
        h.data_ptr(), mask_t.data_ptr(), h_L.data_ptr(), h_R.data_ptr(),
        nz, ny, nx, direction, int(fold), lim, float(h_min),
        kernels.stream_of(h))
    kernels.check(rc, name)
    return h_L, h_R


def _flux_launch(name, h, h_L, h_R, face, d_p, d_m, u, dw, rem, direction,
                 fold=False):
    if (dw is None) != (rem is None):
        raise ValueError(f"{name}: dw and rem go together")
    if u.dim() != 3 or any(t.shape != u.shape for t in (h, h_L, h_R)) \
            or any(t.shape != u.shape[1:] for t in (face, d_p, d_m)):
        raise ValueError(f"{name}: 3-D fields must be (nz, ny, nx) and "
                         "face, d_p, d_m (ny, nx)")
    ts = [h, h_L, h_R, face, d_p, d_m, u]
    if dw is not None:
        if dw.shape != u.shape[1:] or rem.shape != u.shape:
            raise ValueError(f"{name}: dw must be (ny, nx), rem like u")
        ts += [dw, rem]
    _check_cuda(name, u, *ts)
    uh = torch.empty_like(u)
    duhdu = torch.empty_like(u)
    nz, ny, nx = u.shape
    rc = kernels.entry("mom6_ppm_flux", u.dtype)(
        h.data_ptr(), h_L.data_ptr(), h_R.data_ptr(), face.data_ptr(),
        d_p.data_ptr(), d_m.data_ptr(), u.data_ptr(),
        None if dw is None else dw.data_ptr(),
        None if rem is None else rem.data_ptr(),
        uh.data_ptr(), duhdu.data_ptr(), nz, ny, nx, direction, int(fold),
        kernels.stream_of(u))
    kernels.check(rc, name)
    return uh, duhdu


def _on_cpu(name, t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise TypeError(f"{name}: no kernel for device {t.device}")
    return False


def zonal_edges(h, mask_t, h_min, monotonic=False, simple_2nd=False):
    """(h_W, h_E): PPM edge values in x (PPM_reconstruction_x)."""
    if _on_cpu("zonal_edges", h):
        return ppm_edges_plain(h, mask_t, h_min, monotonic, simple_2nd,
                               _DIR_X)
    out = _edges_launch("zonal_edges", h, mask_t, h_min, monotonic,
                        simple_2nd, _DIR_X)
    zonal_edges.launches += 1
    return out


def merid_edges(h, mask_t, h_min, monotonic=False, simple_2nd=False,
                fold=False):
    """(h_S, h_N): PPM edge values in y (PPM_reconstruction_y), with the
    periodic wrap of torch.roll or, with ``fold``, the tripolar northern
    fold.  Fold launches are counted in ``fold_launches``."""
    if _on_cpu("merid_edges", h):
        return ppm_edges_plain(h, mask_t, h_min, monotonic, simple_2nd,
                               _DIR_Y, fold)
    out = _edges_launch("merid_edges", h, mask_t, h_min, monotonic,
                        simple_2nd, _DIR_Y, fold)
    if fold:
        merid_edges.fold_launches += 1
    else:
        merid_edges.launches += 1
    return out


def zonal_flux(h, h_W, h_E, face, d_p, d_m, u, dw=None, rem=None):
    """(uh, duh/du) of the x pass at w = u, or w = u + dw*rem."""
    if _on_cpu("zonal_flux", u):
        return ppm_flux_plain(h, h_W, h_E, face, d_p, d_m, u, dw, rem,
                              _DIR_X)
    out = _flux_launch("zonal_flux", h, h_W, h_E, face, d_p, d_m, u, dw,
                       rem, _DIR_X)
    zonal_flux.launches += 1
    return out


def merid_flux(h, h_S, h_N, face, d_p, d_m, v, dw=None, rem=None,
               fold=False):
    """(vh, dvh/dv) of the y pass at w = v, or w = v + dw*rem; with
    ``fold`` across the tripolar northern fold (``d_m`` then carries the
    fold image of the top row, ``jp1(IdyT, "h")``).  Fold launches are
    counted in ``fold_launches``."""
    if _on_cpu("merid_flux", v):
        return ppm_flux_plain(h, h_S, h_N, face, d_p, d_m, v, dw, rem,
                              _DIR_Y, fold)
    out = _flux_launch("merid_flux", h, h_S, h_N, face, d_p, d_m, v, dw,
                       rem, _DIR_Y, fold)
    if fold:
        merid_flux.fold_launches += 1
    else:
        merid_flux.launches += 1
    return out


for _fn in (zonal_edges, merid_edges, zonal_flux, merid_flux):
    _fn.launches = 0
merid_edges.fold_launches = 0
merid_flux.fold_launches = 0


# ---------------------------------------------------------------------------
# mass fluxes and the continuity update
# ---------------------------------------------------------------------------

def _newton(eval_at, uh, duhdu, uhbt, rem, mask, cap):
    """Fixed-count Newton adjustment of the layer transports to the
    barotropic transport ``uhbt`` (zonal_flux_adjust): each iterate
    reuses the previous evaluation's derivative.  Returns (uh, du)."""
    du = torch.zeros_like(uhbt)
    for _ in range(_N_NEWTON):
        err = vsum(uh) - uhbt
        denom = vsum(duhdu * rem)
        du = du - err / torch.clamp(denom, min=1e-30) * mask
        du = torch.clamp(du, -cap, cap)
        uh, duhdu = eval_at(du, rem)
    return uh, du


def zonal_mass_flux(u, h, dt, G, *, uhbt: Optional[torch.Tensor] = None,
                    visc_rem: Optional[torch.Tensor] = None,
                    monotonic=False, simple_2nd=False, h_min=1e-10,
                    return_cor: bool = False):
    """Zonal thickness flux; with ``uhbt`` Newton-adjusted so its column
    sum matches that barotropic transport.  Returns (uh, u_adj) and, with
    ``return_cor``, also the 2-D correction du (u_adj = u + du*rem)."""
    face = G.dyCu * G.mask2dCu
    d_p, d_m = dt * G.IdxT, dt * ip1(G.IdxT)
    h_W, h_E = zonal_edges(h, G.mask2dT, h_min, monotonic, simple_2nd)
    uh, duhdu = zonal_flux(h, h_W, h_E, face, d_p, d_m, u)
    if uhbt is None:
        if return_cor:
            return uh, u, torch.zeros_like(u[0])
        return uh, u
    rem = visc_rem if visc_rem is not None else torch.ones_like(u)
    # bound on the correction (zonal_flux_adjust's du_max/du_min)
    du_cap = rdiv(0.45, dt * torch.clamp(G.IdxT, min=1e-30))
    uh, du = _newton(
        lambda du, rem: zonal_flux(h, h_W, h_E, face, d_p, d_m, u, du, rem),
        uh, duhdu, uhbt, rem, G.mask2dCu, du_cap)
    if return_cor:
        return uh, u + du * rem, du
    return uh, u + du * rem


def meridional_mass_flux(v, h, dt, G, *,
                         vhbt: Optional[torch.Tensor] = None,
                         visc_rem: Optional[torch.Tensor] = None,
                         monotonic=False, simple_2nd=False, h_min=1e-10,
                         return_cor: bool = False):
    """Meridional twin of :func:`zonal_mass_flux`: periodic or walled y,
    or the tripolar northern fold of a ``G.fold_north`` grid."""
    fold = bool(getattr(G, "fold_north", False))
    face = G.dxCv * G.mask2dCv
    d_p, d_m = dt * G.IdyT, dt * jp1(G.IdyT, "h" if fold else None)
    h_S, h_N = merid_edges(h, G.mask2dT, h_min, monotonic, simple_2nd, fold)
    vh, dvhdv = merid_flux(h, h_S, h_N, face, d_p, d_m, v, fold=fold)
    if vhbt is None:
        if return_cor:
            return vh, v, torch.zeros_like(v[0])
        return vh, v
    rem = visc_rem if visc_rem is not None else torch.ones_like(v)
    dv_cap = rdiv(0.45, dt * torch.clamp(G.IdyT, min=1e-30))
    vh, dv = _newton(
        lambda dv, rem: merid_flux(h, h_S, h_N, face, d_p, d_m, v, dv, rem,
                                   fold),
        vh, dvhdv, vhbt, rem, G.mask2dCv, dv_cap)
    if return_cor:
        return vh, v + dv * rem, dv
    return vh, v + dv * rem


def continuity_ppm(u, v, h, dt, G, GV, *,
                   uhbt: Optional[torch.Tensor] = None,
                   vhbt: Optional[torch.Tensor] = None,
                   visc_rem_u: Optional[torch.Tensor] = None,
                   visc_rem_v: Optional[torch.Tensor] = None,
                   monotonic=False, simple_2nd=False, x_first: bool = True,
                   return_cor: bool = False):
    """Directionally split thickness update (continuity_PPM).  Returns
    (h_new, uh, vh, u_adj, v_adj), and with ``return_cor`` also the 2-D
    corrections (du, dv)."""
    h_min = GV.angstrom
    fold = bool(getattr(G, "fold_north", False))
    kw = dict(monotonic=monotonic, simple_2nd=simple_2nd, h_min=h_min,
              return_cor=True)

    def x_pass(hh):
        uh, u_adj, du = zonal_mass_flux(u, hh, dt, G, uhbt=uhbt,
                                        visc_rem=visc_rem_u, **kw)
        h_out = torch.clamp(hh - dt * G.IareaT * (uh - im1(uh)), min=h_min)
        return h_out, uh, u_adj, du

    def y_pass(hh):
        vh, v_adj, dv = meridional_mass_flux(v, hh, dt, G, vhbt=vhbt,
                                             visc_rem=visc_rem_v, **kw)
        h_out = torch.clamp(hh - dt * G.IareaT * (vh - jm1_s0(vh, fold)),
                            min=h_min)
        return h_out, vh, v_adj, dv

    if x_first:
        h_x, uh, u_adj, du = x_pass(h)
        h_new, vh, v_adj, dv = y_pass(h_x)
    else:
        h_y, vh, v_adj, dv = y_pass(h)
        h_new, uh, u_adj, du = x_pass(h_y)
    if return_cor:
        return h_new, uh, vh, u_adj, v_adj, du, dv
    return h_new, uh, vh, u_adj, v_adj


# ---------------------------------------------------------------------------
# the barotropic transport response curves (BT_cont)
# ---------------------------------------------------------------------------

class BTCont(NamedTuple):
    """Piecewise transport response curves uhbt(ubt) per face, the
    BT_cont_type of MOM_continuity_PPM.F90:set_BT_cont, read by
    find_uhbt (MOM_barotropic.F90:4610).  For flow from the west through
    a u face:

      uhbt(u) = u (FA_W0 + crvW u^2)            for 0 <= u <= uBT_WW
              = (u - uBT_WW) FA_WW + uh(uBT_WW) for u > uBT_WW

    and likewise with the E fields for flow from the east; (ny, nx)
    each, the column sums of the layers' curves."""
    FA_u_W0: torch.Tensor
    FA_u_WW: torch.Tensor
    uBT_WW: torch.Tensor
    uh_crvW: torch.Tensor
    FA_u_E0: torch.Tensor
    FA_u_EE: torch.Tensor
    uBT_EE: torch.Tensor
    uh_crvE: torch.Tensor
    FA_v_S0: torch.Tensor
    FA_v_SS: torch.Tensor
    vBT_SS: torch.Tensor
    vh_crvS: torch.Tensor
    FA_v_N0: torch.Tensor
    FA_v_NN: torch.Tensor
    vBT_NN: torch.Tensor
    vh_crvN: torch.Tensor


# the CFL at which set_bt_cont's cubic hands over to the linear tail
BT_CONT_CFL = 0.5


def _curve_params(fa0, fa_mean_cap, fa_marg_cap, u_cap):
    """The cubic uh(u) = u (fa0 + crv u^2) through the mean face area at
    the transition velocity, crv clipped to keep it monotone, and the
    marginal area beyond it."""
    crv = (fa_mean_cap - fa0) / torch.clamp(u_cap * u_cap, min=1e-30)
    crv = torch.maximum(crv, -fa0 / torch.clamp(3.0 * u_cap * u_cap,
                                                min=1e-30))
    return crv, torch.clamp(fa_marg_cap, min=0.0)


def _mean_marg(h_d, edge, other_edge, cfl):
    """The PPM swept mean and marginal thickness at CFL ``cfl`` of a
    donor cell whose reconstruction runs from ``other_edge`` to the
    downstream face value ``edge``."""
    curv = (edge + other_edge) - 2.0 * h_d
    h_avg = edge + cfl * (0.5 * (other_edge - edge) + curv * (cfl - 1.5))
    h_marg = edge + cfl * ((other_edge - edge) + 3.0 * curv * (cfl - 1.0))
    return h_avg, h_marg


def set_bt_cont(h, dt, G, GV, *, monotonic=False) -> BTCont:
    """The response curves of ``h``'s PPM reconstruction (set_BT_cont),
    the cubic handing over to the linear tail at CFL ``BT_CONT_CFL``.
    The edges come from ``zonal_edges`` and ``merid_edges``."""
    h_min = GV.angstrom
    fold = bool(getattr(G, "fold_north", False))
    kh = "h" if fold else None
    h_W, h_E = zonal_edges(h, G.mask2dT, h_min, monotonic)
    h_S, h_N = merid_edges(h, G.mask2dT, h_min, monotonic, fold=fold)
    face_u = (G.dyCu * G.mask2dCu)[None]
    face_v = (G.dxCv * G.mask2dCv)[None]
    c = BT_CONT_CFL

    def curve(face, h_d, edge, other_edge, u_cap):
        h_avg, h_marg = _mean_marg(h_d, edge, other_edge, c)
        fa0 = face * edge
        crv, fa_marg = _curve_params(fa0, face * h_avg, face * h_marg,
                                     u_cap[None])
        return vsum(fa0), vsum(fa_marg), vsum(crv)

    # u faces: from the west the donor is cell i with downstream edge
    # h_E(i); from the east cell i+1 with h_W(i+1)
    ubt_ww = rdiv(c, dt * G.IdxT)
    ubt_ee = rdiv(-c, dt * ip1(G.IdxT))
    fa_w0, fa_ww, crv_w = curve(face_u, h, h_E, h_W, ubt_ww)
    fa_e0, fa_ee, crv_e = curve(face_u, ip1(h), ip1(h_W), ip1(h_E),
                                -ubt_ee)
    # v faces
    vbt_ss = rdiv(c, dt * G.IdyT)
    vbt_nn = rdiv(-c, dt * jp1(G.IdyT, kh))
    fa_s0, fa_ss, crv_s = curve(face_v, h, h_N, h_S, vbt_ss)
    jS, jN = jp1_sn(h_S, h_N, kh)
    fa_n0, fa_nn, crv_n = curve(face_v, jp1(h, kh), jS, jN, -vbt_nn)
    return BTCont(
        FA_u_W0=fa_w0, FA_u_WW=fa_ww, uBT_WW=ubt_ww, uh_crvW=crv_w,
        FA_u_E0=fa_e0, FA_u_EE=fa_ee, uBT_EE=ubt_ee, uh_crvE=crv_e,
        FA_v_S0=fa_s0, FA_v_SS=fa_ss, vBT_SS=vbt_ss, vh_crvS=crv_s,
        FA_v_N0=fa_n0, FA_v_NN=fa_nn, vBT_NN=vbt_nn, vh_crvN=crv_n)


def _find_hbt(u, fa_p0, fa_pp, u_pp, crv_p, fa_m0, fa_mm, u_mm, crv_m):
    """The curve's transport at velocity ``u`` (p: flow in the positive
    direction, m: in the negative)."""
    uh_pp = u_pp * (fa_p0 + crv_p * (u_pp * u_pp))
    uh_mm = u_mm * (fa_m0 + crv_m * (u_mm * u_mm))
    return torch.where(
        u > u_pp, (u - u_pp) * fa_pp + uh_pp,
        torch.where(u >= 0.0, u * (fa_p0 + crv_p * u * u),
                    torch.where(u > u_mm, u * (fa_m0 + crv_m * u * u),
                                (u - u_mm) * fa_mm + uh_mm)))


def find_uhbt(u, btc: BTCont):
    """Barotropic zonal transport from the curves (find_uhbt,
    MOM_barotropic.F90:4610)."""
    return _find_hbt(u, btc.FA_u_W0, btc.FA_u_WW, btc.uBT_WW, btc.uh_crvW,
                     btc.FA_u_E0, btc.FA_u_EE, btc.uBT_EE, btc.uh_crvE)


def find_vhbt(v, btc: BTCont):
    """Barotropic meridional transport from the curves (find_vhbt)."""
    return _find_hbt(v, btc.FA_v_S0, btc.FA_v_SS, btc.vBT_SS, btc.vh_crvS,
                     btc.FA_v_N0, btc.FA_v_NN, btc.vBT_NN, btc.vh_crvN)
