"""Target grids of the ALE vertical coordinate
(twin of mom6_tpu/ale/regridding.py: build_zstar_grid, build_sigma_grid,
build_sigma_shelf_zstar_grid, build_rho_grid, build_hycom1_grid,
AdaptParams with build_adaptive_grid, build_hybgen_grid, hybgen_unmix
and uniform_dz_profile).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_tpu_torch.framework.arith import rdiv, sdiv, vcumsum, vsum
from mom6_tpu_torch.framework.solvers import tridiag_solve
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["AdaptParams", "build_zstar_grid", "build_sigma_grid",
           "build_sigma_shelf_zstar_grid", "build_rho_grid",
           "build_hycom1_grid", "build_adaptive_grid", "build_hybgen_grid",
           "hybgen_unmix", "uniform_dz_profile"]


def uniform_dz_profile(nz: int, max_depth: float) -> np.ndarray:
    return np.full(nz, max_depth / nz)


def build_zstar_grid(h, bathy, dz_nominal, min_thickness: float = 1e-10):
    """New z* thicknesses for columns of thickness ``h`` (nz, ny, nx):
    the nominal interfaces -cumsum(dz_nominal) stretched by the column's
    (D + eta)/D, clipped at the bottom, floored at ``min_thickness`` and
    renormalised so each column keeps its sum."""
    dz = torch.as_tensor(dz_nominal, dtype=h.dtype, device=h.device)
    depth_nom = vsum(dz)
    col = vsum(h)                     # D + eta
    d = torch.minimum(bathy, depth_nom)
    z_nom = torch.cat([torch.zeros(1, dtype=h.dtype, device=h.device),
                       torch.cumsum(dz, dim=0)])[:, None, None]
    stretch = col / torch.clamp(d, min=1e-10)
    z = torch.minimum(z_nom * stretch, col[None])
    h_new = torch.clamp(z[1:] - z[:-1], min=min_thickness)
    scale = col / torch.clamp(vsum(h_new), min=1e-30)
    return h_new * scale[None]


def build_sigma_grid(h, nz: int = None, min_thickness: float = 1e-10):
    """Terrain-following thicknesses: each column split into ``nz``
    (default h's) equal fractions."""
    nz = nz or h.shape[0]
    frac = torch.full((nz,), 1.0 / nz, dtype=h.dtype, device=h.device)
    return torch.clamp(frac[:, None, None] * vsum(h)[None],
                       min=min_thickness)


def build_sigma_shelf_zstar_grid(h, bathy, dz_nominal, shelf_depth,
                                 min_thickness: float = 1e-10):
    """SIGMA_SHELF_ZSTAR: sigma where the column is shallower than
    ``shelf_depth`` (under an ice shelf, on a shelf), z* where it is
    deeper than twice that, blended linearly in between; renormalised so
    each column keeps its sum."""
    z_sig = build_sigma_grid(h, nz=len(dz_nominal),
                             min_thickness=min_thickness)
    z_str = build_zstar_grid(h, bathy, dz_nominal, min_thickness)
    col = vsum(h)
    w_sig = torch.clamp(sdiv(2.0 * shelf_depth - col,
                             max(shelf_depth, 1e-3)), 0.0, 1.0)
    h_new = w_sig[None] * z_sig + (1.0 - w_sig[None]) * z_str
    scale = col / torch.clamp(vsum(h_new), min=1e-30)
    return torch.clamp(h_new * scale[None], min=min_thickness)


def build_rho_grid(h, T, S, GV, eos, rho_targets, *,
                   min_thickness: float = 1e-10, p_ref: float = 2e7):
    """Isopycnal target grid (the RHO coordinate): interface k moves to
    the depth where the column's potential density referenced to
    ``p_ref``, made monotone by a running maximum, equals the mean of the
    targets on either side, interpolated linearly between layer centres.
    The interfaces are clamped to the column and kept in order, so each
    column keeps its sum.  As many layers as targets."""
    rho_t = torch.as_tensor(rho_targets, dtype=h.dtype, device=h.device)
    nz = rho_t.shape[0]
    rho_int_t = 0.5 * (rho_t[:-1] + rho_t[1:])

    z_c = torch.cumsum(h, dim=0) - 0.5 * h
    rho_c = GV.rho0 + eos.density(T, S, torch.full_like(T, p_ref),
                                  rho_ref=GV.rho0)
    rho_mono = torch.cummax(rho_c, dim=0).values

    col = vsum(h)
    r_lo = torch.cat([rho_mono[:1], rho_mono[:-1]], 0)
    z_lo = torch.cat([torch.zeros_like(z_c[:1]), z_c[:-1]], 0)
    seg = z_c - z_lo
    drho = rho_mono - r_lo

    def depth_of(rho_target):
        frac = torch.clamp((rho_target - r_lo)
                           / torch.clamp(drho, min=1e-12), 0.0, 1.0)
        frac = torch.where(drho < 1e-12,
                           (r_lo < rho_target).to(frac.dtype), frac)
        return vsum(seg * frac)

    z_int = torch.stack([depth_of(rho_int_t[k]) for k in range(nz - 1)])
    z_int = torch.minimum(torch.clamp(z_int, min=0.0), col[None])
    z_int = torch.cummax(z_int, dim=0).values
    z_full = torch.cat([torch.zeros_like(col[None]), z_int, col[None]], 0)
    h_new = torch.clamp(z_full[1:] - z_full[:-1], min=min_thickness)
    scale = col / torch.clamp(vsum(h_new), min=1e-30)
    return h_new * scale[None]


def build_hycom1_grid(h, T, S, GV, eos, rho_targets, dz_nominal, *,
                      min_thickness: float = 1e-10, p_ref: float = 2e7):
    """The HYCOM1 hybrid coordinate (build_hycom1_column): the interfaces
    of the isopycnal target grid (:func:`build_rho_grid`), each pushed
    down to at least its nominal z* depth stretched by the column over
    the nominal total, z_k = min(max(z_rho_k, z*_k), bottom), then kept
    in order.  The upper ocean stays z-like at the nominal resolution
    where the stratified interior follows the isopycnals."""
    dz = torch.as_tensor(dz_nominal, dtype=h.dtype, device=h.device)
    col = vsum(h)
    h_rho = build_rho_grid(h, T, S, GV, eos, rho_targets,
                           min_thickness=min_thickness, p_ref=p_ref)
    z_rho = vcumsum(h_rho)
    z_nom = vcumsum(dz)[:, None, None] * (
        col / torch.clamp(vsum(dz), min=1e-30))[None]
    z_int = torch.minimum(torch.maximum(z_rho[:-1], z_nom[:-1]), col[None])
    z_int = torch.cummax(z_int, dim=0).values
    z_full = torch.cat([torch.zeros_like(col[None]), z_int, col[None]], 0)
    h_new = torch.clamp(z_full[1:] - z_full[:-1], min=min_thickness)
    scale = col / torch.clamp(vsum(h_new), min=1e-30)
    return h_new * scale[None]


@dataclasses.dataclass(frozen=True)
class AdaptParams:
    """The ADAPTIVE coordinate's constants (the ADAPT_* keys)."""
    time_ratio: float = 0.1
    zoom_depth: float = 200.0
    zoom_coeff: float = 0.2
    buoy_coeff: float = 0.8
    alpha: float = 1.0
    drho0: float = 0.5
    do_min: bool = False


def build_adaptive_grid(h, T, S, G, GV, eos, p: AdaptParams = None, *,
                        dz_nominal=None, min_thickness: float = 1e-10):
    """The ADAPTIVE coordinate (build_adapt_column):

    1. each interior interface moves toward horizontal neutral-density
       flatness: dh = del2(sigma) * hbar / (drho/dz), del2 the masked
       4-neighbour Laplacian of interface density, limited to half the
       upwind layer times ``alpha`` / 2;
    2. the interfaces are smoothed by an implicit vertical grid diffusion
       (surface zooming, stratification attraction, a uniform
       background): one Thomas solve of (nz-1) levels over all columns;
    3. with ``do_min`` the interfaces are pushed down to the nominal z*
       depths, then clamped to the column and kept in order."""
    if p is None:
        p = AdaptParams()
    nz = h.shape[0]
    col = vsum(h)
    zero = torch.zeros_like(col[None])
    z = torch.cat([zero, vcumsum(h)], 0)                 # (nz+1,) down

    # interface T and S: means of the bounding layers, the end layers'
    tI = torch.cat([T[:1], 0.5 * (T[:-1] + T[1:]), T[-1:]], 0)
    sI = torch.cat([S[:1], 0.5 * (S[:-1] + S[1:]), S[-1:]], 0)
    p0 = torch.zeros((), dtype=h.dtype, device=h.device)
    a_full, b_full = eos.density_derivs(tI, sI, p0)      # (nz+1, ny, nx)

    def contrib(shift, face_mask):
        dT = shift(tI) - tI
        dS = shift(sI) - sI
        return face_mask[None] * (a_full * dT + b_full * dS)

    mCu, mCv = G.mask2dCu, G.mask2dCv
    del2 = (contrib(ip1, mCu) + contrib(im1, im1(mCu))
            + contrib(jp1, mCv) + contrib(jm1, jm1(mCv)))

    drho_v = a_full[1:-1] * (T[1:] - T[:-1]) + b_full[1:-1] * (S[1:] - S[:-1])
    hbar = 0.5 * (h[:-1] + h[1:])
    dh = del2[1:-1] * hbar / torch.clamp(drho_v, min=1e-10)
    h_up = torch.where(dh > 0, h[1:], h[:-1])
    dh = torch.sign(dh) * torch.minimum(torch.abs(dh), 0.5 * h_up) \
        * (0.5 * p.alpha)
    z_next = torch.cat([z[:1], z[1:-1] + dh, z[-1:]], 0)

    drdz = torch.clamp(
        (0.5 * (a_full[:-1] + a_full[1:]) * (tI[1:] - tI[:-1])
         + 0.5 * (b_full[:-1] + b_full[1:]) * (sI[1:] - sI[:-1]))
        / torch.clamp(z_next[1:] - z_next[:-1], min=1e-6), min=0.0)
    z_mid = 0.5 * (z_next[:-1] + z_next[1:])
    depth = torch.clamp(col, min=1.0)[None]
    k_grid = (p.time_ratio * nz ** 2 * depth) * (
        rdiv(p.zoom_coeff, p.zoom_depth + z_mid)
        + sdiv(p.buoy_coeff * drdz, p.drho0)
        + rdiv(max(1.0 - p.zoom_coeff - p.buoy_coeff, 0.0), depth))

    # implicit smoothing of the interior interfaces, the end ones fixed:
    # (1 + kG[k-1] + kG[k]) z_k - kG[k-1] z_{k-1} - kG[k] z_{k+1} = rhs_k
    kg_up = k_grid[:-1]
    kg_dn = k_grid[1:]
    b_diag = 1.0 + kg_up + kg_dn
    rhs = z_next[1:-1].clone()
    rhs[0] = rhs[0] + kg_up[0] * z_next[0]
    rhs[-1] = rhs[-1] + kg_dn[-1] * z_next[-1]
    a_sub = -kg_up.clone()
    a_sub[0] = 0.0
    c_sup = -kg_dn.clone()
    c_sup[-1] = 0.0
    z_int = tridiag_solve(a_sub, b_diag, c_sup, rhs)

    if p.do_min and dz_nominal is not None:
        dz = torch.as_tensor(dz_nominal, dtype=h.dtype, device=h.device)
        z_nom = vcumsum(dz)[:-1, None, None] * (
            col / torch.clamp(vsum(dz), min=1e-30))[None]
        z_int = torch.maximum(z_int, z_nom)

    z_int = torch.minimum(torch.clamp(z_int, min=0.0), col[None])
    z_int = torch.cummax(z_int, dim=0).values
    z_full = torch.cat([zero, z_int, col[None]], 0)
    h_new = torch.clamp(z_full[1:] - z_full[:-1], min=min_thickness)
    scale = col / torch.clamp(vsum(h_new), min=1e-30)
    return h_new * scale[None]


def build_hybgen_grid(h, T, S, GV, eos, rho_targets, dz_min_profile, *,
                      qhybrlx: float = 0.25, min_thickness: float = 1e-10,
                      p_ref: float = 2e7):
    """HYCOM's hybrid generator (MOM_hybgen_regrid.F90): each interior
    interface moves ``qhybrlx`` (1 / HYBGEN_RELAX_PERIOD) of the way from
    where it is toward its isopycnal position (:func:`build_rho_grid`),
    is pushed down to at least the running sum of ``dz_min_profile``
    (the minimum z-layer profile, clipped to the column), clamped to the
    column and kept in order; each column keeps its sum."""
    dz0 = torch.as_tensor(dz_min_profile, dtype=h.dtype, device=h.device)
    col = vsum(h)
    z_old = vcumsum(h)
    h_rho = build_rho_grid(h, T, S, GV, eos, rho_targets,
                           min_thickness=min_thickness, p_ref=p_ref)
    z_rho = vcumsum(h_rho)
    z_int = z_old[:-1] + qhybrlx * (z_rho[:-1] - z_old[:-1])
    zmin = vcumsum(dz0)[:-1, None, None]
    z_int = torch.maximum(z_int, torch.minimum(zmin, col[None]))
    z_int = torch.minimum(torch.clamp(z_int, min=0.0), col[None])
    z_int = torch.cummax(z_int, dim=0).values
    z_full = torch.cat([torch.zeros_like(col[None]), z_int, col[None]], 0)
    h_new = torch.clamp(z_full[1:] - z_full[:-1], min=min_thickness)
    scale = col / torch.clamp(vsum(h_new), min=1e-30)
    return h_new * scale[None]


def hybgen_unmix(T, S, h, GV, eos, rho_targets, *, k_fixed: int = 2,
                 q_max: float = 0.25, p_ref: float = 2e7):
    """HYCOM's unmixing (MOM_hybgen_unmix.F90): top down over the pairs
    (k, k+1), a volume delta = h_k (target_k - rho_k) / (rho_k+1 - rho_k),
    clipped to [0, q_max min(h_k, h_k+1)], is swapped between the two
    layers so that layer k's potential density (referenced to ``p_ref``)
    returns toward its target; none where the pair is not stably
    stratified by more than 1e-6 or above ``k_fixed``.  The swap is
    antisymmetric, so each column keeps its heat and salt.  A loop over
    the nz - 1 pairs on whole (ny, nx) planes, each pair seeing the lower
    layer as the previous swap left it.  Returns (T, S)."""
    nz = h.shape[0]
    rho_t = torch.as_tensor(rho_targets, dtype=h.dtype, device=h.device)
    p = torch.full_like(T[0], p_ref)
    T, S = T.clone(), S.clone()

    def rho_of(Tk, Sk):
        return GV.rho0 + eos.density(Tk, Sk, p, rho_ref=GV.rho0)

    for k in range(nz - 1):
        Tk, Sk, Tk1, Sk1 = T[k], S[k], T[k + 1], S[k + 1]
        hk, hk1 = h[k], h[k + 1]
        r_k = rho_of(Tk, Sk)
        denom = rho_of(Tk1, Sk1) - r_k
        delta = hk * (rho_t[k] - r_k) / torch.where(
            torch.abs(denom) > 1e-6, denom, 1e30)
        delta = torch.minimum(torch.clamp(delta, min=0.0),
                              q_max * torch.minimum(hk, hk1))
        delta = torch.where((denom > 1e-6) & (k >= k_fixed), delta, 0.0)
        fT = delta * (Tk1 - Tk)
        fS = delta * (Sk1 - Sk)
        ik = torch.clamp(hk, min=1e-3)
        ik1 = torch.clamp(hk1, min=1e-3)
        T[k], T[k + 1] = Tk + fT / ik, Tk1 + -fT / ik1
        S[k], S[k + 1] = Sk + fS / ik, Sk1 + -fS / ik1
    return T, S
