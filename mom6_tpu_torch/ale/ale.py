"""ALE driver: regrid to the target coordinate, remap the state
conservatively (twin of mom6_tpu/ale/ale.py: ALEParams and
ale_regrid_remap).

One call builds the new grid for the current columns, remaps T, S and
any passive tracers on cell columns in one multi-field remap, and u and
v on face columns (face thicknesses are the means of the adjacent
columns, before and after): three launches of the remap kernel on the
card.  Ported modes: LAYER (no regridding), ZSTAR, SIGMA,
SIGMA_SHELF_ZSTAR (sigma on shallow columns, z* on deep ones), RHO
(isopycnal targets), HYCOM1 (isopycnal below a nominal z* floor),
ADAPTIVE (the interfaces flattened toward neutral density and smoothed
by one Thomas solve) and HYBGEN (the interfaces relaxed toward the
isopycnal ones above a minimum z profile; after the remap, T and S are
unmixed back toward the layers' targets, pair by pair).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_tpu_torch.ale.regridding import (AdaptParams, build_adaptive_grid,
                                           build_hybgen_grid,
                                           build_hycom1_grid, build_rho_grid,
                                           build_sigma_grid,
                                           build_sigma_shelf_zstar_grid,
                                           build_zstar_grid, hybgen_unmix)
from mom6_tpu_torch.ale.remapping import (PPM_H4, remap_column,
                                          remap_columns_multi)
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.stencil import ip1, jp1

__all__ = ["ALEParams", "ale_regrid_remap", "LAYER", "ZSTAR", "SIGMA",
           "SIGMA_SHELF_ZSTAR", "RHO", "HYCOM1", "ADAPTIVE", "HYBGEN"]

LAYER = "LAYER"
ZSTAR = "ZSTAR"
SIGMA = "SIGMA"
SIGMA_SHELF_ZSTAR = "SIGMA_SHELF_ZSTAR"
RHO = "RHO"
HYCOM1 = "HYCOM1"
ADAPTIVE = "ADAPTIVE"
HYBGEN = "HYBGEN"


@dataclasses.dataclass(frozen=True)
class ALEParams:
    mode: str = ZSTAR
    dz_nominal: tuple = ()         # nominal z* thicknesses (nz,)
    shelf_depth: float = 200.0     # SIGMA_SHELF_ZSTAR's transition [m]
    rho_targets: tuple = ()        # RHO, HYCOM1, HYBGEN target densities
    scheme: str = PPM_H4
    min_thickness: float = 1e-10
    eos_name: str = "WRIGHT"       # the density modes' EOS
    # the ADAPTIVE mode's constants (the ADAPT_* keys)
    adapt_time_ratio: float = 0.1
    adapt_zoom_depth: float = 200.0
    adapt_zoom_coeff: float = 0.2
    adapt_buoy_coeff: float = 0.8
    adapt_alpha: float = 1.0
    adapt_drho0: float = 0.5
    adapt_do_min: bool = False
    # the HYBGEN mode's relaxation fraction (1 / HYBGEN_RELAX_PERIOD)
    hybgen_qrlx: float = 0.25


def ale_regrid_remap(state, G, GV, p: ALEParams,
                     extra_tracers: Optional[torch.Tensor] = None):
    """Returns (new_state, extra_tracers_new)."""
    if p.mode == LAYER:
        return state, extra_tracers
    h = state.h
    if p.mode == ZSTAR:
        h_new = build_zstar_grid(h, G.bathyT, p.dz_nominal, p.min_thickness)
    elif p.mode == SIGMA:
        h_new = build_sigma_grid(h, min_thickness=p.min_thickness)
    elif p.mode == SIGMA_SHELF_ZSTAR:
        h_new = build_sigma_shelf_zstar_grid(h, G.bathyT, p.dz_nominal,
                                             p.shelf_depth, p.min_thickness)
    elif p.mode == RHO:
        h_new = build_rho_grid(h, state.T, state.S, GV, get_eos(p.eos_name),
                               p.rho_targets, min_thickness=p.min_thickness)
    elif p.mode == HYCOM1:
        h_new = build_hycom1_grid(h, state.T, state.S, GV,
                                  get_eos(p.eos_name), p.rho_targets,
                                  p.dz_nominal, min_thickness=p.min_thickness)
    elif p.mode == HYBGEN:
        h_new = build_hybgen_grid(h, state.T, state.S, GV,
                                  get_eos(p.eos_name), p.rho_targets,
                                  p.dz_nominal, qhybrlx=p.hybgen_qrlx,
                                  min_thickness=p.min_thickness)
    elif p.mode == ADAPTIVE:
        ap = AdaptParams(time_ratio=p.adapt_time_ratio,
                         zoom_depth=p.adapt_zoom_depth,
                         zoom_coeff=p.adapt_zoom_coeff,
                         buoy_coeff=p.adapt_buoy_coeff,
                         alpha=p.adapt_alpha, drho0=p.adapt_drho0,
                         do_min=p.adapt_do_min)
        h_new = build_adaptive_grid(
            h, state.T, state.S, G, GV, get_eos(p.eos_name), ap,
            dz_nominal=p.dz_nominal if p.dz_nominal else None,
            min_thickness=p.min_thickness)
    else:
        raise ValueError(f"unknown ALE mode {p.mode}")
    h_new = torch.where(G.mask2dT[None] > 0.5, h_new, h)

    cell_fields = []
    if state.T is not None:
        cell_fields += [state.T, state.S]
    n_extra = 0 if extra_tracers is None else extra_tracers.shape[0]
    cell_fields += [extra_tracers[i] for i in range(n_extra)]
    T_new = S_new = extra_new = None
    if cell_fields:
        out = remap_columns_multi(torch.stack(cell_fields), h, h_new,
                                  p.scheme)
        idx = 0
        if state.T is not None:
            T_new, S_new = out[0], out[1]
            idx = 2
        if n_extra:
            extra_new = out[idx:idx + n_extra]
    if p.mode == HYBGEN and T_new is not None and p.rho_targets:
        T_new, S_new = hybgen_unmix(T_new, S_new, h_new, GV,
                                    get_eos(p.eos_name), p.rho_targets)

    # the faces' remap kept on the wet faces with torch.where (the
    # reference multiplies by the mask, which keeps a NaN of a land face)
    h_u_old = 0.5 * (h + ip1(h))
    h_u_new = 0.5 * (h_new + ip1(h_new))
    u_new = torch.where(G.mask2dCu > 0.5,
                        remap_column(state.u, h_u_old, h_u_new, p.scheme),
                        torch.zeros_like(state.u))
    kh = "h" if getattr(G, "fold_north", False) else None
    h_v_old = 0.5 * (h + jp1(h, kh))
    h_v_new = 0.5 * (h_new + jp1(h_new, kh))
    v_new = torch.where(G.mask2dCv > 0.5,
                        remap_column(state.v, h_v_old, h_v_new, p.scheme),
                        torch.zeros_like(state.v))
    return state.replace(h=h_new, T=T_new, S=S_new, u=u_new,
                         v=v_new), extra_new
