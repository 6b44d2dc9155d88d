"""Model state (twin of mom6_tpu/core/state.py).

Dense ``(nz, ny, nx)`` tensors: ``h`` layer thickness [m] at h-points,
``u``/``v`` velocities [m s-1] at u/v-points, ``uh``/``vh`` the last
step's volume transports [m3 s-1], ``uhtr``/``vhtr`` their time
integrals [m3], and optional ``T``/``S``; the optional ``E_meke``
(ny, nx) eddy energy of MEKE [m2 s-2] and ``kv_shear`` (nz+1, ny, nx),
the boundary-layer and shear-mixing viscosity at h-point interfaces
[m2 s-1] that the thermo block sets and the next cycle's vertical
friction uses; and ``tr``, the passive tracers of the registered
packages (tracers/packages.py), one (nz, ny, nx) tensor per registered
name plus the packages' 0-dim clocks (names starting with "_"), which
are never stacked, advected or masked; and ``obc_res_T``/``obc_res_S``
(nz, ny, nx), the open boundaries' tracer reservoirs
(core/open_boundary.py::update_tracer_reservoirs); and ``En_itide``, the
internal tides' energy density (n_angle, ny, nx) or (n_freq, n_mode,
n_angle, ny, nx) [J m-2 a bin] (physics/lateral/internal_tides.py); and
``frazil`` (ny, nx), the frazil heat [J m-2] accumulated since a coupler
last collected it (None: not tracked, as build_model_from_params leaves
it, like the reference's builder).
build_model_from_params allocates the others where their scheme is on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mom6_tpu_torch.framework.arith import vcumsum
from mom6_tpu_torch.framework.containers import TensorDataclass

__all__ = ["OceanState", "init_state_resting"]


@dataclasses.dataclass(frozen=True)
class OceanState(TensorDataclass):
    h: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    T: Optional[torch.Tensor] = None
    S: Optional[torch.Tensor] = None
    uh: Optional[torch.Tensor] = None
    vh: Optional[torch.Tensor] = None
    uhtr: Optional[torch.Tensor] = None
    vhtr: Optional[torch.Tensor] = None
    E_meke: Optional[torch.Tensor] = None
    kv_shear: Optional[torch.Tensor] = None
    tr: Optional[Dict[str, torch.Tensor]] = None
    obc_res_T: Optional[torch.Tensor] = None
    obc_res_S: Optional[torch.Tensor] = None
    En_itide: Optional[torch.Tensor] = None
    frazil: Optional[torch.Tensor] = None


def init_state_resting(grid, vgrid, thicknesses, dtype=torch.float32,
                       with_thermo: bool = False) -> OceanState:
    """Resting state with the (nz,) thickness profile clipped against the
    local bathymetry (THICKNESS_CONFIG="uniform").  Tensors are made on
    the grid's device."""
    nz = vgrid.nz
    ny, nx = grid.ny, grid.nx
    dev = grid.bathyT.device
    prof = torch.as_tensor(thicknesses, dtype=dtype).to(dev)
    # the nominal interfaces added in order in ``dtype``, as the
    # reference's cumsum does
    e_nom = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                       vcumsum(prof)])
    depth = grid.bathyT[None, :, :]
    e = torch.minimum(e_nom[:, None, None], depth)
    h = torch.clamp(e[1:] - e[:-1], min=vgrid.angstrom)
    h = h * grid.mask2dT[None] + vgrid.angstrom * (1.0 - grid.mask2dT[None])

    def z():
        # every field its own allocation: no two fields alias
        return torch.zeros((nz, ny, nx), dtype=dtype, device=dev)

    st = OceanState(h=h.to(dtype), u=z(), v=z(), uh=z(), vh=z(),
                    uhtr=z(), vhtr=z())
    if with_thermo:
        st = st.replace(
            T=torch.full((nz, ny, nx), 10.0, dtype=dtype, device=dev),
            S=torch.full((nz, ny, nx), 35.0, dtype=dtype, device=dev))
    return st
