"""Config-driven model construction: MOM_input -> runnable model
(twin of mom6_tpu/drivers/config_driver.py::build_model_from_params).

Ported: what the four configurations of the reference's golden tests
(``configs/double_gyre``, ``benchmark``, ``rho_basin`` and
``global_2deg``), ``configs/global_half_deg``, ``configs/tracer_batch``
and the analytic gates (``configs/external_gwave``, ``soliton`` and the
parameter texts of tests/test_analytic_parity.py) read, and the defaults
they leave in force: the Cartesian grid with flat or bowl topography,
the spherical and Mercator grids and the mosaic grid with file
topography and the northern fold, REENTRANT_Y, the seamount, dome2d,
dumbbell, Neverworld, Kelvin, shelfwave, DOME and slope topographies, the
layered vertical grid, the split-RK2 dynamics with every CORIOLIS_SCHEME
and Laplacian, Smagorinsky, Leith (LEITH_KH, USE_QG_LEITH_VISC) and
anisotropic (ANISOTROPIC_VISCOSITY) friction, the Zanna-Bolton closure
(USE_ZB2020), the interface filter (APPLY_INTERFACE_FILTER) and the
porous barriers (POROUS_BARRIER), the BT_cont transports (USE_BT_CONT_TYPE), the barotropic
drags (BT_LIN_DRAG, BT_CDRAG) and GL90 (USE_GL90_IN_SSW), the open
boundaries (OBC_NUMBER_OF_SEGMENTS: both segment syntaxes, their _DATA
strings with ``value:`` and ``file:`` data, the Kelvin, shelfwave and DOME
data of OBC_USER_CONFIG and the tracer reservoirs), the unsplit RK3 and
RK2 steppers (SPLIT = False), the adiabatic
(ENABLE_THERMODYNAMICS = False) and the thermo cycle, z*, RHO, HYCOM1
and ADAPTIVE ALE with the PCM, PLM, PPM_H4 and PQM_IH4IH3 remaps, the
Wright, full-range Wright (WRIGHT_FULL), linear, UNESCO, ROQUET_RHO,
TEOS10 (ROQUET_SPV) and JACKETT06 EOS with the Stanley correction of the
pressure force (USE_STANLEY_PGF), the astronomical tides (TIDES, on a
spherical grid only, as the reference) and the self-attraction and
loading (SAL_SCALAR_VALUE, SAL_HARMONICS), SPPT and SKEB (DO_SPPT,
DO_SKEB, STOCH_SEED), GM with a constant
KHTH, MEKE (with MEKE_VISCOSITY_COEFF_KU and MEKE_FRCOEFF), the
mixed-layer restratification, KHTR along the layers
(with KHTR_PASSIVITY_COEFF/_MIN and KHTR_MAX) or the neutral surfaces
(USE_NEUTRAL_DIFFUSION, NDIFF_SCHEME), the diffusion within the boundary
layer (USE_HORIZONTAL_BOUNDARY_DIFFUSION, LBD_KHTR), the background
diffusivity, CVMix convection (USE_CVMIX_CONVECTION) and double
diffusion (DOUBLE_DIFFUSION, USE_CVMIX_DDIFF), the tidal mixing
(INT_TIDE_DISSIPATION), the low-mode internal tides (INTERNAL_TIDES),
the tidal wave drag on the barotropic flow (TIDAL_WAVE_DRAG), the dynamic surface pressure under
ice (DYNAMIC_SURFACE_PRESSURE), the BBL viscosity and its mixing
(BOTTOMDRAGLAW, BBL_EFFIC), KPP, ePBL
(ENERGETICS_SFC_PBL) with the Langmuir number (USE_LA_LI2016, or
USE_WAVES with WAVE_METHOD = LF17, DHH85, SURFBANDS or EFACTOR), the
penetrating shortwave (PEN_SW_NBANDS), the brine plume (DO_BRINE_PLUME),
the layered bulk mixed layer
(BULKMIXEDLAYER), CVMix shear mixing, the NS_bands and uniform sponges
(SPONGE), the tracer packages (ideal
age, regional dyes, boundary impulse, pseudo-salt, OCMIP2 CFCs, the NPZD
ecosystem of USE_generic_tracer), the
``gyres``, ``global`` and ``constant`` wind, the idealized hurricane
(``ideal_hurr``, ``SCM_ideal_hurr``) and the wind and buoyancy fluxes
from a file (``file``), the ``NS_heating`` and ``const`` fluxes and SST
restoring, DIABATIC_FIRST and HOMOGENIZE_FORCINGS, the resting initial
state (THICKNESS_CONFIG = uniform) and its ``internal_wave``,
``sloshing``, ``gwave``, ``soliton``, ``phillips`` and ``circle_obcs``
displacements, and the T_REF/T_RANGE profile, the
``front`` or the ``rossby_front`` of TS_CONFIG.  Time-dependent forcing
(the hurricane, the file records, the open boundaries' series) comes
with ``ModelSetup.forcing_provider``, model time [s] -> Forcing.  An OBC
scheme token the port does not know raises NotImplementedError (the
reference warns and drops it).  An EQN_OF_STATE, REMAPPING_SCHEME or
REGRIDDING_COORDINATE_MODE that the port lacks raises
NotImplementedError here, before anything is written (the reference
raises at the first step).  DRHO_DT, which the reference reads only for
the DOME inflow (its LINEAR EOS is fixed at -0.2), is read wherever it is
set and only -0.2 is accepted elsewhere.  With ``doc_dir`` the parameters
read are written out as ``MOM_parameter_doc.all`` and ``.short`` there.

Every switch that the reference's function reads is read here too;
:data:`_INERT` would list one the port does not have, with the only
value it accepts (none is left).  A key that this module does not know
raises ``ValueError``.

With ``mesh`` (parallel/mesh.py) the model is built whole on the host
and each rank keeps its tile on the mesh's device
(parallel/mesh.py::shard_model); an option whose whole-domain work is
not decomposed over ranks raises NotImplementedError there, naming it.

Where the supergrid file of a mosaic is missing, the pair is generated
in memory (grid/tripolar.py) for the sizes of :data:`_GENERATED`, as
``configs/global_half_deg/make_inputs.py`` would write it; no file is
written.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from mom6_tpu_torch.ale.ale import (ADAPTIVE, HYBGEN, HYCOM1, LAYER, SIGMA,
                                    SIGMA_SHELF_ZSTAR, ZSTAR, ALEParams)
from mom6_tpu_torch.ale.remapping import (P3M_H4, PCM, PLM, PPM_H4, PPM_H6,
                                          PPM_IH4, PQM_IH4IH3)
from mom6_tpu_torch.core.barotropic import BTParams, set_dtbt
from mom6_tpu_torch.core.dynamics_split_rk2 import DynParams, MechForcing
from mom6_tpu_torch.core.dynamics_unsplit import UnsplitParams
from mom6_tpu_torch.core.mom import Forcing, MOMParams
from mom6_tpu_torch.core.porous_barriers import PorousBarrier
from mom6_tpu_torch.core.pressure_force import geometric_to_mass_h
from mom6_tpu_torch.core.open_boundary import (SCHEMES, OBCData, OBCSegment,
                                               build_obc, segment_slices)
from mom6_tpu_torch.core.state import OceanState, init_state_resting
from mom6_tpu_torch.drivers import user_cases
from mom6_tpu_torch.drivers.user_cases import (hurricane_wind_fn,
                                               neverworld_depth)
from mom6_tpu_torch.eos import check_ported as check_eos_ported
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.arith import csqrt, sdiv, vcumsum
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.data_override import (TimeSeriesField,
                                                    build_bilinear_map,
                                                    data_override)
from mom6_tpu_torch.framework.device import DEFAULT_DEVICE, resolve_device
from mom6_tpu_torch.grid.grid import (Grid, build_cartesian_grid,
                                      build_spherical_grid)
from mom6_tpu_torch.grid.mosaic import (build_grid_from_supergrid,
                                        read_supergrid)
from mom6_tpu_torch.grid.tripolar import make_mosaic
from mom6_tpu_torch.grid.vertical import VerticalGrid, build_layered_vgrid
from mom6_tpu_torch.io.netcdf import read_nc
from mom6_tpu_torch.physics.lateral.hor_visc import HorViscParams
from mom6_tpu_torch.physics.ice_shelf import IceShelfParams
from mom6_tpu_torch.physics.lateral.internal_tides import (
    InternalTidesParams, init_int_tide_energy)
from mom6_tpu_torch.physics.lateral.lateral_mixing_coeffs import \
    VarMixParams
from mom6_tpu_torch.physics.lateral.interface_filter import \
    InterfaceFilterParams
from mom6_tpu_torch.physics.lateral.meke import MEKEParams
from mom6_tpu_torch.physics.lateral.zanna_bolton import ZBParams
from mom6_tpu_torch.physics.lateral.self_attr_load import build_sal_harmonics
from mom6_tpu_torch.physics.lateral.tidal_forcing import TidalForcingParams
from mom6_tpu_torch.physics.stochastic import SPPTParams
from mom6_tpu_torch.framework.random import PRNGKey
from mom6_tpu_torch.physics.lateral.mixed_layer_restrat import \
    MLRestratParams
from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
from mom6_tpu_torch.physics.lateral.wave_drag import wave_drag_piston
from mom6_tpu_torch.physics.shelf_coupling import (ShelfCoupling,
                                                   trim_columns_for_p_surf)
from mom6_tpu_torch.physics.vertical.bulk_mixed_layer import BulkMLParams
from mom6_tpu_torch.physics.vertical.convection import (ConvectionParams,
                                                        DDiffParams)
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams)
from mom6_tpu_torch.physics.vertical.opacity import (GeothermalParams,
                                                     OpacityParams)
from mom6_tpu_torch.physics.vertical.set_diffusivity import DiffusivityParams
from mom6_tpu_torch.physics.vertical.set_viscosity import SetViscParams
from mom6_tpu_torch.physics.vertical.sponge import SpongeParams
from mom6_tpu_torch.physics.vertical.tidal_mixing import TidalMixingParams
from mom6_tpu_torch.physics.waves import WaveParams
from mom6_tpu_torch.framework.stencil import ip1, jp1
from mom6_tpu_torch.tracers import packages
from mom6_tpu_torch.tracers.bgc import NPZD

__all__ = ["build_model_from_params", "ModelSetup"]

# switches the reference reads whose subsystem is not ported: the one
# value accepted (the reference's default, which leaves it off) and the
# module the reference logs it under
_INERT = {}
# (NIGLOBAL, NJGLOBAL) -> arguments of grid/tripolar.py::make_mosaic for
# the mosaics that are generated and not committed
_GENERATED = {(720, 400): dict(nx=720, ny_reg=336, ny_cap=64)}
# the remap schemes and the regrid coordinates the port has
_SCHEMES = (PCM, PLM, PPM_H4, PPM_IH4, PPM_H6, P3M_H4, PQM_IH4IH3)
_COORDINATES = ("Z*", "ZSTAR", SIGMA, SIGMA_SHELF_ZSTAR, "RHO", HYCOM1,
                HYBGEN, ADAPTIVE)


class ModelSetup(NamedTuple):
    grid: Grid
    vgrid: VerticalGrid
    state: OceanState
    params: MOMParams
    forcing: Forcing
    param_file: ParamFile
    # model time [s] -> Forcing where a surface field changes in time
    forcing_provider: Optional[object] = None


# the barotropic switches, which the reference reads in split mode only
# (with the barotropic parameters)
_SPLIT_ONLY = ("BT_LIN_DRAG", "BT_CDRAG", "BT_WIDE_HALO")


def _check_inert(pf: ParamFile) -> None:
    """Raise for a switch of :data:`_INERT` set otherwise; log the others
    with their defaults where the reference logs them.  Without SPLIT a
    barotropic switch that is set is read and left out of the doc, as
    the reference leaves it unread."""
    split = pf.get("SPLIT", bool, default=True, module="MOM")
    if not split:
        for key in _SPLIT_ONLY:
            if key not in _INERT and pf.has(key):
                pf.get(key, float)
    for key, (only, module) in _INERT.items():
        if key in _SPLIT_ONLY and not split:
            if not pf.has(key):
                continue
            value = pf.get(key, type(only))
        else:
            value = pf.get(key, type(only), default=only, module=module)
        if value != only:
            raise NotImplementedError(
                f"{key} = {value!r} is not ported (only {only!r})")


def _porous_sills(G) -> PorousBarrier:
    """The sill depths of each face from the depths of its two columns:
    the shallower is d_min, the deeper d_max.  On a tripolar grid the v
    faces of the fold row take their fold partner's depth (the
    reference's roll takes row 0's)."""
    bat = G.bathyT
    bat_e = ip1(bat)
    bat_n = jp1(bat, "h" if getattr(G, "fold_north", False) else None)
    return PorousBarrier(d_min_u=torch.minimum(bat, bat_e),
                         d_max_u=torch.maximum(bat, bat_e),
                         d_min_v=torch.minimum(bat, bat_n),
                         d_max_v=torch.maximum(bat, bat_n))


def _ndiff_scheme(pf: ParamFile) -> str:
    """NDIFF_SCHEME, lower case: "redi" or "surfaces"."""
    value = pf.get("NDIFF_SCHEME", str, default="redi",
                   module="MOM_neutral_diffusion").lower()
    if value not in ("redi", "surfaces"):
        raise ValueError(f"NDIFF_SCHEME = {value!r}: expected redi or "
                         "surfaces")
    return value


def _one_of(pf: ParamFile, key: str, default: str, ported, module: str):
    value = pf.get(key, str, default=default, module=module)
    if value not in ported:
        raise NotImplementedError(f"{key} = {value!r} is not ported "
                                  f"(only {', '.join(ported)})")
    return value


def _bowl(nx: int, ny: int, max_depth: float) -> np.ndarray:
    """TOPO_CONFIG = bowl: a paraboloid, 20% of MAXIMUM_DEPTH at the
    middle of each side."""
    x = (np.arange(nx) + 0.5) / nx - 0.5
    y = (np.arange(ny) + 0.5) / ny - 0.5
    r2 = (2 * x[None, :]) ** 2 + (2 * y[:, None]) ** 2
    return max_depth * (1.0 - 0.8 * r2)


def _named_topography(topo_config, nx, ny, max_depth, min_depth):
    """TOPO_CONFIG = benchmark (a reentrant channel to the south with
    ridges, benchmark_initialization.F90) or halfpipe (a zonally uniform
    channel of half-sine section, initialize_topography_named)."""
    y = ((np.arange(ny) + 0.5) / ny)[:, None]
    if topo_config == "benchmark":
        x = ((np.arange(nx) + 0.5) / nx)[None, :]
        d0 = max_depth / 0.5
        depth = -d0 * (y * (1.0 + 0.6 * np.cos(4.0 * np.pi * x))
                       + 0.75 * np.exp(-6.0 * y)
                       + 0.05 * np.cos(10.0 * np.pi * x) - 0.7)
        return np.clip(depth, 0.0, max_depth)
    return (min_depth + (max_depth - min_depth)
            * np.abs(np.sin(np.pi * y))) * np.ones((ny, nx))


def _analytic_topography(pf, topo_config, nx, ny, lenlon, lenlat,
                         max_depth, min_depth, m) -> np.ndarray:
    """TOPO_CONFIG = seamount, dome2d, dumbbell, slope, Kelvin, shelfwave,
    DOME or Neverworld (the reference's branches, config_driver.py:
    124-215, in its float64 numpy arithmetic)."""
    if topo_config == "seamount":
        # Gaussian seamount on a flat bottom (seamount_initialization.F90)
        delta = pf.get("SEAMOUNT_DELTA", float, default=0.5, module=m,
                       desc="Fractional height of the seamount")
        Lsm = pf.get("SEAMOUNT_LENGTH_SCALE", float, default=20.0,
                     units="km", module=m)
        x = ((np.arange(nx) + 0.5) / nx - 0.5) * lenlon
        y = ((np.arange(ny) + 0.5) / ny - 0.5) * lenlat
        r2 = (x[None, :] ** 2 + y[:, None] ** 2) / max(Lsm, 1e-3) ** 2
        return max_depth * (1.0 - delta * np.exp(-r2))
    if topo_config == "dome2d":
        # shelf + linear slope to the deep basin (DOME2d_initialization.F90)
        shelf_frac = pf.get("DOME2D_SHELF_DEPTH", float, default=0.2,
                            module=m, desc="Shelf depth / max depth")
        ls = pf.get("DOME2D_SHELF_FRAC", float, default=0.25, module=m)
        lb = pf.get("DOME2D_BASIN_FRAC", float, default=0.45, module=m)
        xf = ((np.arange(nx) + 0.5) / nx)[None, :]
        d = np.where(xf < ls, shelf_frac,
                     np.where(xf < 1.0 - lb,
                              shelf_frac + (1.0 - shelf_frac)
                              * (xf - ls) / max(1.0 - lb - ls, 1e-6),
                              1.0))
        return max_depth * d * np.ones((ny, nx))
    if topo_config == "dumbbell":
        # two deep basins joined by a shallow narrow strait
        # (dumbbell_initialization.F90)
        sill = pf.get("DUMBBELL_SILL_DEPTH", float,
                      default=0.1 * max_depth, units="m", module=m)
        lenf = pf.get("DUMBBELL_LEN_FRAC", float, default=0.2, module=m,
                      desc="Strait length fraction of the domain")
        widf = pf.get("DUMBBELL_WIDTH_FRAC", float, default=0.25,
                      module=m)
        xf = np.abs((np.arange(nx) + 0.5) / nx - 0.5)[None, :]
        yf = np.abs((np.arange(ny) + 0.5) / ny - 0.5)[:, None]
        in_strait = (xf < 0.5 * lenf)
        strait_open = (yf < 0.5 * widf)
        return np.where(in_strait & ~strait_open, 0.0,
                        np.where(in_strait, sill, max_depth)
                        ) * np.ones((ny, nx))
    if topo_config == "slope":
        # a linear cross-shore slope from the shelf to the deep ocean
        shelf_d = pf.get("SHELF_DEPTH", float, default=100.0, units="m",
                         module=m)
        yf = ((np.arange(ny) + 0.5) / ny)[:, None]
        return (shelf_d + (max_depth - shelf_d) * yf) * np.ones((ny, nx))
    dmin = max(min_depth, 1e-3)
    if topo_config == "Kelvin":
        # angled-coast channel (Kelvin_initialize_topography)
        return user_cases.kelvin_depth(
            nx, ny, lenlon, lenlat, max_depth, dmin,
            coast_offset1=pf.get("ROTATED_COAST_OFFSET_1", float,
                                 default=100.0, units="km", module=m),
            coast_offset2=pf.get("ROTATED_COAST_OFFSET_2", float,
                                 default=10.0, units="km", module=m),
            coast_angle_deg=pf.get("ROTATED_COAST_ANGLE", float,
                                   default=11.3, units="degrees",
                                   module=m))
    if topo_config == "shelfwave":
        # exponential cross-shore shelf (shelfwave_initialize_topography)
        return user_cases.shelfwave_depth(
            nx, ny, lenlat, max_depth, dmin,
            ly=pf.get("SHELFWAVE_Y_LENGTH_SCALE", float, default=50.0,
                      units="km", module=m))
    if topo_config == "DOME":
        # slope basin and shelf embayment (DOME_initialize_topography)
        return user_cases.dome_depth(
            nx, ny, lenlon, lenlat, max_depth, dmin,
            shelf_depth=pf.get("DOME_SHELF_DEPTH", float, default=600.0,
                               units="m", module=m),
            shelf_edge_lat=pf.get("DOME_SHELF_EDGE_LAT", float,
                                  default=600.0, units="km", module=m),
            inflow_lon=pf.get("DOME_INFLOW_LON", float, default=1000.0,
                              units="km", module=m),
            inflow_width=pf.get("DOME_INFLOW_WIDTH", float, default=100.0,
                                units="km", module=m),
            slope=pf.get("DOME_TOPOG_SLOPE", float, default=0.01,
                         module=m))
    # Neverworld: two basins and a reentrant southern channel
    # (Neverworld_initialization.F90)
    return neverworld_depth(
        nx, ny, max_depth,
        roughness_amp=pf.get("NL_ROUGHNESS_AMP", float, default=0.05,
                             module=m),
        continent_amp=pf.get("NL_CONTINENT_AMP", float, default=1.0,
                             module=m))


def _build_grid(pf: ParamFile, dtype, device, input_dir):
    """The Cartesian, spherical or Mercator grid with flat, bowl, file or
    analytic topography, or the mosaic grid with file topography (the
    reference's _build_grid, those branches).  REENTRANT_Y joins the
    north and south edges of the Cartesian and mosaic grids (the
    spherical one ignores it, as the reference's does).  Returns (Grid,
    MAXIMUM_DEPTH)."""
    m = "MOM_grid_init"
    nx = pf.get("NIGLOBAL", int, module=m)
    ny = pf.get("NJGLOBAL", int, module=m)
    grid_config = _one_of(pf, "GRID_CONFIG", "cartesian",
                          ("cartesian", "spherical", "mercator", "mosaic"),
                          m)
    lenlon = pf.get("LENLON", float, default=1000.0, units="km", module=m)
    lenlat = pf.get("LENLAT", float, default=1000.0, units="km", module=m)
    max_depth = pf.get("MAXIMUM_DEPTH", float, default=4000.0, units="m",
                       module=m)
    min_depth = pf.get("MINIMUM_DEPTH", float, default=0.0, units="m",
                       module=m)
    f0 = pf.get("F_0", float, default=0.0, units="s-1", module=m)
    beta = pf.get("BETA", float, default=0.0, units="m-1 s-1", module=m)
    topo_config = _one_of(pf, "TOPO_CONFIG", "flat",
                          ("flat", "bowl", "file", "benchmark", "halfpipe",
                           "seamount", "dome2d", "dumbbell", "slope",
                           "Kelvin", "shelfwave", "DOME", "Neverworld"), m)
    cyclic_x = pf.get("REENTRANT_X", bool, default=False, module=m)
    reentrant_y = pf.get("REENTRANT_Y", bool, default=False, module=m)

    if topo_config == "file":
        tfile = pf.get("TOPO_FILE", str, default="ocean_topog.nc", module=m)
        tvar = pf.get("TOPO_VARNAME", str, default="depth", module=m)

    def read_topography():
        data = read_nc(_input_path(pf, tfile, input_dir))
        if tvar not in data:
            raise ValueError(f"{tfile} has no variable {tvar!r}")
        return np.asarray(data[tvar], np.float64)

    if grid_config != "mosaic":
        depth = None
        if topo_config == "bowl":
            depth = _bowl(nx, ny, max_depth)
        elif topo_config in ("benchmark", "halfpipe"):
            depth = _named_topography(topo_config, nx, ny, max_depth,
                                      min_depth)
        elif topo_config == "file":
            depth = read_topography()
        elif topo_config != "flat":
            depth = _analytic_topography(pf, topo_config, nx, ny, lenlon,
                                         lenlat, max_depth, min_depth, m)
        if depth is not None:
            if depth.shape != (ny, nx):
                raise ValueError(f"topography shape {depth.shape} != "
                                 f"({ny}, {nx})")
            # no wet point deeper than MAXIMUM_DEPTH (limit_topography)
            depth = np.minimum(depth, max_depth)
    if grid_config in ("spherical", "mercator"):
        # LENLON/LENLAT in degrees here; the Mercator rows are isotropic
        west = pf.get("WESTLON", float, default=0.0, units="degrees",
                      module=m)
        south = pf.get("SOUTHLAT", float, default=-40.0, units="degrees",
                       module=m)
        iso = grid_config == "mercator" or pf.get("ISOTROPIC", bool,
                                                  default=False, module=m)
        G = build_spherical_grid(nx, ny, west, south, lenlon, lenlat,
                                 depth=depth, max_depth=max_depth,
                                 min_depth=min_depth, cyclic_x=cyclic_x,
                                 isotropic=iso, dtype=dtype, device=device)
        return G, max_depth
    if grid_config == "cartesian":
        G = build_cartesian_grid(
            nx, ny, lenlon, lenlat, depth=depth, max_depth=max_depth,
            min_depth=min_depth, f0=f0, beta=beta, cyclic_x=cyclic_x,
            reentrant_y=reentrant_y,
            south_lat_km=pf.get("SOUTHLAT", float, default=0.0, units="km",
                                module=m),
            west_lon_km=pf.get("WESTLON", float, default=0.0, units="km",
                               module=m),
            dtype=dtype, device=device)
        return G, max_depth

    if topo_config != "file":
        raise ValueError("GRID_CONFIG = mosaic needs TOPO_CONFIG = file")
    gfile = _input_path(pf, pf.get("GRID_FILE", str,
                                   default="ocean_hgrid.nc", module=m),
                        input_dir)
    if not os.path.exists(gfile) and (nx, ny) in _GENERATED:
        sg, depth = make_mosaic(max_depth=4000.0, **_GENERATED[(nx, ny)])
    else:
        sg = read_supergrid(gfile)
        depth = read_topography()
    if depth.shape != (ny, nx):
        raise ValueError(f"topography shape {depth.shape} != ({ny}, {nx})")
    depth = np.minimum(depth, max_depth)
    G = build_grid_from_supergrid(
        sg, depth, min_depth=max(min_depth, 1e-3), cyclic_x=cyclic_x,
        reentrant_y=reentrant_y,
        fold_north=pf.get("TRIPOLAR_N", bool, default=False, module=m),
        dtype=dtype, device=device)
    if (G.nx, G.ny) != (nx, ny):
        raise ValueError(f"supergrid implies {G.nx}x{G.ny}, MOM_input says "
                         f"{nx}x{ny}")
    return G, max_depth


def _tracer_packages(pf: ParamFile):
    """The TracerFlowControl of the tracer flags, or None without one
    (the reference's MOM_tracer_flow_control block)."""
    m = "MOM_tracer_flow_control"
    pkgs = []
    if pf.get("USE_IDEAL_AGE_TRACER", bool, default=False, module=m):
        pkgs.append(packages.IdealAge())
    if pf.get("USE_REGIONAL_DYES", bool, default=False, module=m):
        n_dyes = pf.get("NUM_DYE_TRACERS", int, default=0, module=m)
        if n_dyes > 0:
            def dl(name):
                v = pf.get_list(name, default=(), module=m)
                if len(v) not in (0, n_dyes):
                    raise ValueError(
                        f"{name}: expected {n_dyes} values, got {len(v)}")
                return tuple(v)
            pkgs.append(packages.RegionalDyes(
                minlon=dl("DYE_SOURCE_MINLON"),
                maxlon=dl("DYE_SOURCE_MAXLON"),
                minlat=dl("DYE_SOURCE_MINLAT"),
                maxlat=dl("DYE_SOURCE_MAXLAT"),
                mindepth=dl("DYE_SOURCE_MINDEPTH"),
                maxdepth=dl("DYE_SOURCE_MAXDEPTH")))
        else:
            pkgs.append(packages.RegionalDye(
                i_min=pf.get("DYE_SOURCE_MINI", int, default=0, module=m),
                i_max=pf.get("DYE_SOURCE_MAXI", int, default=4, module=m),
                j_min=pf.get("DYE_SOURCE_MINJ", int, default=0, module=m),
                j_max=pf.get("DYE_SOURCE_MAXJ", int, default=4, module=m)))
    if pf.get("USE_BOUNDARY_IMPULSE_TRACER", bool, default=False, module=m):
        pkgs.append(packages.BoundaryImpulse())
    if pf.get("USE_PSEUDO_SALT_TRACER", bool, default=False, module=m):
        pkgs.append(packages.PseudoSalt())
    if pf.get("USE_OCMIP2_CFC", bool, default=False, module=m):
        pkgs.append(packages.CFCPackage())
    if pf.get("USE_generic_tracer", bool, default=False, module=m):
        pkgs.append(NPZD())
    return packages.TracerFlowControl(pkgs) if pkgs else None


def _xfrac(a):
    """``a`` (numpy, the grid's working precision) normalised to [0, 1]."""
    return (a - a.min()) / max(a.max() - a.min(), 1e-30)


def _displaced(pf: ParamFile, thick_cfg: str, G, gv, state, max_depth,
               dtype, device) -> dict:
    """The fields THICKNESS_CONFIG = internal_wave, sloshing, gwave or
    soliton sets on the resting state (the reference's branches, in its
    numpy arithmetic on the grid's working precision)."""
    m = "MOM_state_initialization"
    nz = gv.nz
    lon = G.geoLonT.cpu().numpy()
    h0 = state.h.cpu().numpy()

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    if thick_cfg in ("sloshing", "internal_wave"):
        # interior interfaces displaced: "sloshing" tilts every one with
        # the first vertical mode (sloshing_initialization.F90),
        # "internal_wave" displaces one sinusoidally
        amp = pf.get("IC_AMPLITUDE", float, default=20.0, units="m",
                     module=m)
        xfrac = _xfrac(lon)
        e = np.concatenate([np.zeros((1, G.ny, G.nx)),
                            np.cumsum(h0, axis=0)], axis=0)
        col = e[-1]
        if thick_cfg == "sloshing":
            for k in range(1, nz):
                mode = np.sin(np.pi * e[k] / np.maximum(col, 1e-3))
                e[k] = e[k] + amp * np.sin(np.pi * xfrac) * mode
        else:
            k0 = pf.get("IC_INTERFACE", int, default=nz // 2, module=m)
            wl = pf.get("IC_WAVELENGTH_FRAC", float, default=0.5, module=m)
            e[k0] = e[k0] + amp * np.sin(2.0 * np.pi * xfrac / wl)
        e = np.minimum(np.maximum.accumulate(e, axis=0), col[None])
        return dict(h=t(np.maximum(e[1:] - e[:-1], float(gv.angstrom))))
    if thick_cfg == "phillips":
        return _phillips(pf, G, gv, h0, t, m)
    if thick_cfg == "gwave":
        # a free-surface wave: each column scaled by (D + eta)/D with
        # eta = a sin(2 pi x / L) (external_gwave_initialization.F90)
        amp = pf.get("SSH_ANOMALY_HEIGHT", float, default=1.0, units="m",
                     module=m)
        wl = pf.get("SSH_ANOMALY_WAVELENGTH_FRAC", float, default=0.5,
                    module=m)
        eta0 = amp * np.sin(2.0 * np.pi * _xfrac(lon) / wl)
        col = h0.sum(0)
        scale = (col + eta0) / np.maximum(col, 1e-6)
        return dict(h=t(h0 * scale[None]))
    # soliton: the equatorial Rossby soliton of Boyd (1980)
    # (soliton_initialization.F90), eta and u of the sech^2 solution on
    # the equatorial beta plane in the equatorial deformation scales; the
    # equator is the line y = 0 of the Cartesian grid [km]
    amp = pf.get("SOLITON_AMPLITUDE", float, default=0.395, module=m)
    ssh_scale = pf.get("SOLITON_SSH_SCALE", float, default=-1.0, units="m",
                       module=m)
    c0 = np.sqrt(9.8 * max_depth)
    if ssh_scale < 0.0:
        ssh_scale = 0.771 * amp * amp * max_depth
    beta_eq = pf.get("BETA", float, default=2.3e-11, module=m)
    L_eq = np.sqrt(c0 / max(beta_eq, 1e-13))
    lat = G.geoLatT.cpu().numpy()
    x_nd = (lon - 0.5 * (lon.min() + lon.max())) * 1e3 / L_eq
    y_nd = lat * 1e3 / L_eq
    B = amp
    sech2 = 1.0 / np.cosh(B * x_nd) ** 2
    phi = 0.25 * (6.0 * y_nd ** 2 + 3.0) * np.exp(-0.5 * y_nd ** 2)
    eta0 = ssh_scale * sech2 * phi
    u0 = ssh_scale * (9.8 / c0) * sech2 * 0.25 \
        * (6.0 * y_nd ** 2 - 9.0) * np.exp(-0.5 * y_nd ** 2)
    col = h0.sum(0)
    scale = (col + eta0) / np.maximum(col, 1e-6)
    h_new = h0 * scale[None]
    return dict(h=t(h_new),
                u=t(np.broadcast_to(u0[None], h_new.shape)) * G.mask2dCu)


def _phillips(pf, G, gv, h0, t, m) -> dict:
    """THICKNESS_CONFIG = phillips: interior interfaces tilted by a tanh
    jet in y with the geostrophically balanced zonal flow, the bottom
    layer at rest (Phillips_initialization.F90; the reference's branch,
    config_driver.py:1439, in its numpy arithmetic)."""
    nz = gv.nz
    jet_h = pf.get("JET_HEIGHT", float, default=200.0, units="m", module=m)
    jet_w = pf.get("JET_WIDTH", float, default=0.1, module=m,
                   desc="Jet width as a fraction of the domain")
    arg = (_xfrac(G.geoLatT.cpu().numpy()) - 0.5) / max(jet_w, 1e-6)
    e = np.concatenate([np.zeros((1, G.ny, G.nx)),
                        np.cumsum(h0, axis=0)], axis=0)
    col = e[-1]
    for k in range(1, nz):
        e[k] = e[k] + jet_h * np.tanh(arg) * np.sin(np.pi * k / nz)
    e = np.minimum(np.maximum.accumulate(e, axis=0), col[None])
    h_new = np.maximum(e[1:] - e[:-1], float(gv.angstrom))
    # thermal wind from the interface slopes: f (u_k - u_{k+1}) =
    # g' d(e_{k+1})/dy, centred in y and averaged to the u faces
    f_h = G.CoriolisBu.cpu().numpy()
    f_h = 0.25 * (f_h + np.roll(f_h, 1, 0) + np.roll(f_h, 1, 1)
                  + np.roll(np.roll(f_h, 1, 0), 1, 1))
    f_h = np.where(np.abs(f_h) < 1e-12, 1e-12, f_h)
    dy = G.dyT.cpu().numpy()
    gp = gv.g_prime.cpu().numpy()
    u = np.zeros_like(h0)
    for k in range(nz - 2, -1, -1):
        de = (np.roll(e[k + 1], -1, axis=0)
              - np.roll(e[k + 1], 1, axis=0)) / (2.0 * dy)
        de_u = 0.5 * (de + np.roll(de, -1, axis=1))
        u[k] = u[k + 1] + gp[k + 1] / f_h * de_u
    return dict(h=t(h_new), u=t(u) * G.mask2dCu)


def _rossby_front(pf, G, t_ref, nz, max_depth, m) -> np.ndarray:
    """TS_CONFIG = rossby_front: a mixed layer deepening linearly in y
    over a stratified interior (Rossby_front_2d_initialization.F90; the
    reference's branch, config_driver.py:1580); (nz, ny, nx)."""
    trange = pf.get("T_RANGE", float, default=2.0, units="degC", module=m)
    hml_max = pf.get("ML_DEPTH_MAX", float, default=0.5 * max_depth,
                     units="m", module=m)
    hml = hml_max * _xfrac(G.geoLatT.cpu().numpy())
    zc = (np.cumsum(np.full(nz, max_depth / nz))
          - max_depth / nz / 2)[:, None, None]
    in_ml = zc < hml[None]
    t_deep = t_ref - 0.5 * trange - trange * (zc - hml[None]) / max_depth
    return np.where(in_ml, t_ref + 0.5 * trange, t_deep)


def _front(pf: ParamFile, G, t_ref: float, m: str) -> np.ndarray:
    """TS_CONFIG = front: T jumps by T_RANGE across a front at mid-domain,
    straight or perturbed along it (lock_exchange_initialization.F90,
    adjustment_initialization.F90); (ny, nx)."""
    trange = pf.get("T_RANGE", float, default=2.0, units="degC", module=m)
    axis = pf.get("FRONT_AXIS", str, default="x", module=m)
    lf = pf.get("FRONT_WIDTH_FRAC", float, default=0.02, module=m)
    wavelen = pf.get("FRONT_WAVE_FRAC", float, default=0.0, module=m)
    wamp = pf.get("FRONT_WAVE_AMP", float, default=0.05, module=m)
    xfr = _xfrac(G.geoLonT.cpu().numpy())
    yfr = _xfrac(G.geoLatT.cpu().numpy())
    across, along = (xfr, yfr) if axis == "x" else (yfr, xfr)
    x0 = 0.5 * np.ones_like(across)
    if wavelen > 0.0:
        x0 = x0 + wamp * np.sin(2.0 * np.pi * along / wavelen)
    return t_ref + 0.5 * trange * np.tanh((across - x0) / max(lf, 1e-6))


def _input_path(pf: ParamFile, fname: str, input_dir) -> str:
    """``fname`` resolved against INPUTDIR (itself against ``input_dir``
    or the parameter file's directory)."""
    if os.path.isabs(fname):
        return fname
    idir = pf.get("INPUTDIR", str, default=".", module="MOM_get_input")
    if not os.path.isabs(idir):
        idir = os.path.join(input_dir or pf.dir, idir)
    return os.path.join(idir, fname)


def _ts_from_z(pf: ParamFile, G, h, input_dir, m: str):
    """TS_CONFIG = from_Z (MOM_temp_salt_initialize_from_Z): T and S of a
    z-level climatology file (``z_edges``, the two variables, and on a
    grid of its own ``lon`` and ``lat``) remapped onto the layers ``h``
    by grid/z_init.py.  A climatology on its own grid is first
    interpolated and filled onto every wet cell on the host
    (grid/horiz_regrid.py; periodic in longitude on the spherical,
    Mercator and mosaic grids)."""
    from mom6_tpu_torch.grid.horiz_regrid import \
        horiz_interp_and_extrap_tracer
    from mom6_tpu_torch.grid.z_init import init_tracer_from_z
    zfile = pf.get("TEMP_SALT_Z_INIT_FILE", str, module=m,
                   desc="NetCDF with z_edges + ptemp + salt")
    tvar = pf.get("Z_INIT_FILE_PTEMP_VAR", str, default="ptemp", module=m)
    svar = pf.get("Z_INIT_FILE_SALT_VAR", str, default="salt", module=m)
    raw = read_nc(_input_path(pf, zfile, input_dir))
    z_edges = np.asarray(raw["z_edges"], np.float64)
    t_raw = np.asarray(raw[tvar], np.float64)
    s_raw = np.asarray(raw[svar], np.float64)
    if "lon" in raw and "lat" in raw and t_raw.ndim == 3 \
            and t_raw.shape[1:] != (G.ny, G.nx):
        missv = pf.get("Z_INIT_DATA_MISSING", float, default=np.nan,
                       module=m, desc="Missing value in the climatology "
                       "(NaN always treated as missing)")
        per = 360.0 if pf.get(
            "GRID_CONFIG", str, default="cartesian",
            module="MOM_grid_init") in ("spherical", "mercator",
                                        "mosaic") else 0.0
        kw = dict(wet=G.mask2dT.cpu().numpy() > 0.5,
                  dst_lon=G.geoLonT.cpu().numpy(),
                  dst_lat=G.geoLatT.cpu().numpy(),
                  missing_value=None if np.isnan(missv) else missv,
                  periodic_lon=per, cyclic_x=bool(G.cyclic_x))
        t_raw = horiz_interp_and_extrap_tracer(raw["lon"], raw["lat"],
                                               t_raw, **kw)
        s_raw = horiz_interp_and_extrap_tracer(raw["lon"], raw["lat"],
                                               s_raw, **kw)
    return (init_tracer_from_z(z_edges, t_raw, h, G.bathyT),
            init_tracer_from_z(z_edges, s_raw, h, G.bathyT))


def _bilinear(raw: dict, G):
    """The bilinear map from a file's lon/lat axes to the T points, or
    None when the file is on the model grid."""
    if "lon" not in raw or "lat" not in raw:
        return None
    return build_bilinear_map(raw["lon"], raw["lat"],
                              G.geoLonT.cpu().numpy(),
                              G.geoLatT.cpu().numpy())


def _obc_extent(tok, size):
    """One end of the reference's I=a:b extent (a number or N)."""
    tok = tok.strip().upper()
    return size if tok == "N" else int(tok)


def _obc_data(pf, n, edge, lo, hi, G, input_dir, obc_ts, m) -> dict:
    """OBC_SEGMENT_nnn_DATA: constants ("U=value:0.1") into the returned
    dict, file series ('SSH=file:bay.nc(ssh)') appended to ``obc_ts`` as
    (key, slice, series); the reference's update_OBC_segment_data
    forms."""
    data = pf.get(f"OBC_SEGMENT_{n:03d}_DATA", str, default="", module=m)
    dvals = {}
    fsl, csl = segment_slices(edge, lo, hi, G.ny, G.nx)
    for item in data.split(","):
        if "=" not in item:
            continue
        key, val = item.split("=", 1)
        key = key.strip().upper()
        val = val.strip()
        if val.lower().startswith("file:"):
            fname, var = val[5:].split("(")
            var = var.rstrip(")")
            raw = read_nc(_input_path(pf, fname, input_dir))
            tax = raw.get("time", np.arange(raw[var].shape[0], dtype=float))
            ts = TimeSeriesField(np.asarray(tax, np.float64),
                                 np.asarray(raw[var], np.float64),
                                 periodic=True)
            obc_ts.append((key, fsl if key in ("U", "V") else csl, ts))
        elif ":" in val:
            dvals[key] = float(val.split(":", 1)[1])
        else:
            dvals[key] = float(val)
    return dvals


def _obc_segments(pf, G, input_dir, obc_ts, m):
    """The OBC_SEGMENT_nnn strings as OBCSegments, in either syntax: the
    reference's "J=N,I=N:0,FLATHER,ORLANSKI" (the fixed edge, an optional
    extent, the schemes) or "EDGE=E,SCHEME=ORLANSKI[,ETA=..][,VEL=..]
    [,TEMP=..][,SALT=..][,TAU=..][,LO=..][,HI=..]"."""
    segs = []
    for n in range(1, pf.get("OBC_NUMBER_OF_SEGMENTS", int, default=0,
                             module=m) + 1):
        spec = pf.get(f"OBC_SEGMENT_{n:03d}", str, module=m)
        items = [it.strip() for it in spec.split(",")]
        if items[0].split("=", 1)[0].strip().upper() in ("I", "J"):
            axis, pos = items[0].split("=", 1)
            pos = pos.strip().upper()
            if axis.strip().upper() == "J":
                edge, size = ("N" if pos == "N" else "S"), G.nx
            else:
                edge, size = ("E" if pos == "N" else "W"), G.ny
            lo, hi = 0, -1
            rest = items[1:]
            if rest and ":" in rest[0] and "=" in rest[0]:
                # the extent; its order marks the orientation only
                a, b = (_obc_extent(t, size)
                        for t in rest[0].split("=", 1)[1].split(":"))
                lo, hi = min(a, b), max(a, b)
                rest = rest[1:]
            schemes = [it.upper() for it in rest if "=" not in it]
            extra = [sch for sch in schemes if sch not in SCHEMES]
            if extra:
                raise NotImplementedError(
                    f"OBC_SEGMENT_{n:03d}: the scheme tokens {extra} are "
                    f"not ported (only {', '.join(SCHEMES)})")
            dvals = _obc_data(pf, n, edge, lo, hi, G, input_dir, obc_ts, m)
            segs.append(OBCSegment(
                edge=edge, lo=lo, hi=hi,
                scheme="+".join(schemes) if schemes else "FLATHER",
                eta_ext=dvals.get("SSH", 0.0),
                vel_ext=dvals.get("U" if edge in ("E", "W") else "V", 0.0),
                T_ext=dvals.get("TEMP"), S_ext=dvals.get("SALT")))
            continue
        kv = dict(item.split("=", 1) for item in spec.split(","))
        lo, hi = int(kv.get("LO", 0)), int(kv.get("HI", -1))
        edge = kv["EDGE"].strip().upper()
        dvals = _obc_data(pf, n, edge, lo, hi, G, input_dir, obc_ts, m)
        segs.append(OBCSegment(
            edge=edge, lo=lo, hi=hi,
            scheme=kv.get("SCHEME", "FLATHER").strip().upper(),
            eta_ext=float(kv.get("ETA", dvals.get("SSH", 0.0))),
            vel_ext=float(kv.get("VEL", dvals.get(
                "U" if edge in ("E", "W") else "V", 0.0))),
            T_ext=float(kv["TEMP"]) if "TEMP" in kv else dvals.get("TEMP"),
            S_ext=float(kv["SALT"]) if "SALT" in kv else dvals.get("SALT"),
            nudge_timescale=float(kv.get("TAU", 3600.0))))
    return segs


def _dome_segments(pf, segs, G, gv, ale, nz, max_depth, f0, m):
    """OBC_USER_CONFIG = DOME: the SPECIFIED segments with the steady
    constant-Ri inflow and its layer temperatures (DOME_set_OBC_data);
    in an ALE coordinate sampled in depth on the local column."""
    inflow_lon = pf.get("DOME_INFLOW_LON", float, default=1000.0,
                        units="km", module="MOM_grid_init")
    rlay = gv.Rlay.cpu().numpy().astype(np.float64)
    drho_dt = pf.get("DRHO_DT", float, default=-0.2, units="kg m-3 degC-1",
                     module="MOM_EOS")
    t_top = pf.get("DOME_T_LIGHT", float, default=25.0, units="degC",
                   module=m)
    t_prof = t_top + (rlay - rlay[0]) / drho_dt
    lonT = G.geoLonT.cpu().numpy().astype(np.float64)
    out = []
    for seg in segs:
        if "SPECIFIED" not in seg.scheme.upper():
            out.append(seg)
            continue
        fsl, csl = segment_slices(seg.edge, seg.lo, seg.hi, G.ny, G.nx)
        x_face = lonT[fsl]
        kw = dict(
            density_range=pf.get("DENSITY_RANGE", float, default=2.0,
                                 units="kg m-3", module="MOM_coord_init"),
            d_edge=pf.get("DOME_INFLOW_THICKNESS", float, default=300.0,
                          units="m", module=m),
            ri_trans=pf.get("DOME_INFLOW_RI_TRANS", float,
                            default=1.0 / 3.0, module=m),
            f_inflow=pf.get("DOME_INFLOW_F", float, default=f0, units="s-1",
                            module=m),
            inflow_lon=inflow_lon)
        if ale.mode != LAYER:
            # in depth on the local column (the reference remaps segment
            # data onto the local grid)
            d_face = G.bathyT.cpu().numpy().astype(np.float64)[csl]
            v_prof, rc, _ = user_cases.dome_inflow_z(
                nz, x_face, d_face, max_depth, gv.g_earth, gv.rho0, **kw)
            t_seg = t_top + kw["density_range"] * (1.0 + rc) / drho_dt
        else:
            v_prof, _ = user_cases.dome_inflow(nz, x_face, gv.g_earth,
                                               gv.rho0, **kw)
            t_seg = t_prof
        out.append(seg._replace(
            vel_profile=v_prof, T_profile=t_seg,
            S_profile=np.full(nz, pf.get(
                "S_REF", float, default=35.0, units="ppt",
                module="MOM_state_initialization"))))
    return out


def _open_boundaries(pf, G, gv, ale, nz, max_depth, dtype, device,
                     input_dir):
    """(OBCParams or None, the file and analytic series of the segment
    data as (key, slice, series)): the reference's MOM_open_boundary
    block, config_driver.py:719-938."""
    m = "MOM_open_boundary"
    obc_ts = []
    segs = _obc_segments(pf, G, input_dir, obc_ts, m)
    if not segs:
        return None, obc_ts
    # the analytic segment data of OBC_USER_CONFIG (MOM_boundary_update)
    user_cfg = pf.get("OBC_USER_CONFIG", str, default="", module=m,
                      desc="Analytic segment data: Kelvin, shelfwave "
                      "(time series) or DOME (steady per-layer inflow)")
    if user_cfg:
        f0 = pf.get("F_0", float, default=0.0, units="s-1",
                    module="MOM_grid_init")
        if user_cfg == "Kelvin":
            obc_ts.extend(user_cases.kelvin_obc_series(
                segs, G, gv.g_earth, f0,
                ssh_amp=pf.get("KELVIN_WAVE_SSH_AMP", float, default=1.0,
                               units="m", module=m),
                wave_period=pf.get("KELVIN_WAVE_PERIOD", float,
                                   default=12.42 * 3600.0, units="s",
                                   module=m)))
        elif user_cfg == "shelfwave":
            obc_ts.extend(user_cases.shelfwave_obc_series(
                segs, G, f0,
                amp=pf.get("SHELFWAVE_AMPLITUDE", float, default=0.1,
                           units="m s-1", module=m),
                lx=pf.get("SHELFWAVE_X_WAVELENGTH", float, default=100.0,
                          units="km", module=m),
                ly=pf.get("SHELFWAVE_Y_LENGTH_SCALE", float, default=50.0,
                          units="km", module=m),
                y_mode=pf.get("SHELFWAVE_Y_MODE", float, default=1.0,
                              module=m),
                lenlat=pf.get("LENLAT", float, default=1000.0, units="km",
                              module="MOM_grid_init")))
        elif user_cfg == "DOME":
            segs = _dome_segments(pf, segs, G, gv, ale, nz, max_depth, f0,
                                  m)
        else:
            raise NotImplementedError(f"OBC_USER_CONFIG = {user_cfg!r} is "
                                      "not ported (only Kelvin, shelfwave, "
                                      "DOME)")
    res_in = pf.get("OBC_TRACER_RESERVOIR_LENGTH_SCALE_IN", float,
                    default=0.0, units="m", module=m,
                    desc="Reservoir memory length for inflow")
    res_out = pf.get("OBC_TRACER_RESERVOIR_LENGTH_SCALE_OUT", float,
                     default=0.0, units="m", module=m)
    return build_obc(segs, G.ny, G.nx, dtype, res_len_in=res_in,
                     res_len_out=res_out, nz=nz, device=device), obc_ts


def _circle_obcs(pf, G, state, nz, m):
    """THICKNESS_CONFIG = circle_obcs: interfaces raised over a disk
    (circle_obcs_initialize_thickness, circle_obcs_initialization.F90:
    100-117), in the working precision's numpy as the reference."""
    diskrad = pf.get("DISK_RADIUS", float, module=m,
                     desc="Radius of the elevated disk (grid units)")
    ic_amp = pf.get("DISK_IC_AMPLITUDE", float, default=5.0, units="m",
                    module=m)
    lon = G.geoLonT.cpu().numpy()
    lat = G.geoLatT.cpu().numpy()
    lon_c = 0.5 * (lon.min() + lon.max())
    lat_c = 0.5 * (lat.min() + lat.max())
    rad = np.sqrt((lon - lon_c) ** 2 + (lat - lat_c) ** 2) / diskrad
    rad = np.minimum(rad, 1.0) * np.pi
    bell = 0.5 * (1.0 + np.cos(rad))
    h = state.h.cpu().numpy().copy()
    if nz == 1:
        h[0] += ic_amp * bell
    else:
        for k in range(nz):
            h[k] -= bell * ic_amp * (2 * (k + 1) - nz)
    return torch.tensor(np.maximum(h, 1e-10), dtype=state.h.dtype,
                        device=state.h.device)


class _ForcingProvider:
    """Model time [s] -> Forcing: the open boundaries' segment series,
    the hurricane's stress, the file records of wind (A-grid stress
    averaged to the C-grid faces) and of the buoyancy fluxes, on the base
    forcing (the reference's forcing_provider, config_driver.py:
    1811-1876).  The files' times are days."""

    _OBC_NAMES = {"SSH": "eta_ext", "U": "uvel_ext", "V": "vvel_ext",
                  "TEMP": "T_ext", "SALT": "S_ext"}

    def __init__(self, base: Forcing, G, wind_fn, wind_ts, buoy_ts, dtype,
                 device, obc=None, obc_ts=()):
        self.base, self.G = base, G
        self.wind_fn, self.wind_ts, self.buoy_ts = wind_fn, wind_ts, buoy_ts
        self.dtype, self.device = dtype, device
        self.obc_ts = list(obc_ts)
        # host copies of the exterior data the segment series write into
        self.obc_base = None
        if self.obc_ts:
            def host(t):
                return t.cpu().numpy().astype(np.float64)
            zero = np.zeros((G.ny, G.nx))
            self.obc_base = {
                "SSH": host(obc.eta_ext), "U": host(obc.uvel_ext),
                "V": host(obc.vvel_ext),
                "TEMP": host(obc.T_ext) if obc.T_ext is not None else zero,
                "SALT": host(obc.S_ext) if obc.S_ext is not None else zero}

    def _obc_at(self, t_days) -> OBCData:
        arrs = {k: v.copy() for k, v in self.obc_base.items()}
        used = []
        for key, sl, ts in self.obc_ts:
            arrs[key][sl] = ts.at_time(t_days)
            if key not in used:
                used.append(key)
        return OBCData(**{self._OBC_NAMES[k]: torch.tensor(
            arrs[k], dtype=self.dtype, device=self.device) for k in used})

    def _override(self, ts, t_days, bmap, mask=None):
        return data_override(ts, t_days, bmap, mask, dtype=self.dtype,
                             device=self.device)

    def __call__(self, t_seconds: float) -> Forcing:
        G = self.G
        mech, buoy = self.base.mech, self.base.buoy
        t_days = float(t_seconds) / 86400.0
        obc_data = self._obc_at(t_days) if self.obc_ts else None
        if self.wind_ts is not None:
            fx, fy, bmap = self.wind_ts
            tx_t = self._override(fx, t_days, bmap)
            ty_t = self._override(fy, t_days, bmap)
            mech = mech.replace(
                taux=0.5 * (tx_t + ip1(tx_t)) * G.mask2dCu,
                tauy=0.5 * (ty_t + jp1(ty_t)) * G.mask2dCv)
        if self.wind_fn is not None:
            tx, ty = self.wind_fn(float(t_seconds))
            mech = mech.replace(
                taux=torch.tensor(tx, dtype=self.dtype, device=self.device),
                tauy=torch.tensor(ty, dtype=self.dtype, device=self.device))
        if self.buoy_ts is not None:
            h_ts, sw_ts, fw_ts, bmap = self.buoy_ts
            upd = dict(heat_flux=self._override(h_ts, t_days, bmap,
                                                G.mask2dT))
            if sw_ts is not None:
                upd["sw_flux"] = self._override(sw_ts, t_days, bmap,
                                                G.mask2dT)
            if fw_ts is not None:
                upd["fw_flux"] = self._override(fw_ts, t_days, bmap,
                                                G.mask2dT)
            buoy = buoy.replace(**upd)
        return Forcing(mech=mech, buoy=buoy, obc_data=obc_data)


def _eos_np(fn, dtype, *arrays, **kw):
    """``fn`` (an EOS function) of float64 numpy arrays evaluated in the
    working precision on the CPU, as the reference evaluates it in its
    default precision, the results as float64 numpy."""
    out = fn(*(torch.tensor(np.asarray(a, np.float64), dtype=dtype)
               for a in arrays), **kw)
    if isinstance(out, tuple):
        return tuple(o.double().numpy() for o in out)
    return out.double().numpy()


def _coordinate(pf: ParamFile, gv, eos_name, use_thermo, dtype, device):
    """COORD_CONFIG: the layered grid of GINT (``gprime``, any value but
    ts_range, as the reference reads it) or, with thermodynamics,
    ``ts_range`` (set_coord_from_TS_range): the layers' target densities
    the EOS's at P_REF of a T/S range, the bulk mixed layer's and buffer
    layers' extrapolated above it, g' from their differences."""
    mc = "MOM_coord_initialization"
    coord_cfg = pf.get("COORD_CONFIG", str, default="gprime", module=mc)
    if coord_cfg != "ts_range" or not use_thermo:
        return gv
    nz = gv.nz
    t_ref = pf.get("T_REF", float, default=10.0, units="degC", module=mc)
    t_light = pf.get("TS_RANGE_T_LIGHT", float, default=t_ref,
                     units="degC", module=mc)
    t_dense = pf.get("TS_RANGE_T_DENSE", float, default=t_ref, units="degC",
                     module=mc)
    s_ref = pf.get("S_REF", float, default=35.0, units="ppt", module=mc)
    s_light = pf.get("TS_RANGE_S_LIGHT", float, default=s_ref, units="ppt",
                     module=mc)
    s_dense = pf.get("TS_RANGE_S_DENSE", float, default=s_ref, units="ppt",
                     module=mc)
    res_rat = pf.get("TS_RANGE_RESOLN_RATIO", float, default=1.0, module=mc)
    gfs = pf.get("GFS", float, default=gv.g_earth, units="m s-2", module=mc)
    p_ref = pf.get("P_REF", float, default=2e7, units="Pa", module=mc)
    kl0 = 0
    if pf.get("BULKMIXEDLAYER", bool, default=False, module=mc):
        kl0 = (pf.get("NKML", int, default=2, module=mc)
               + pf.get("NKBL", int, default=2, module=mc))
    if nz < kl0 + 2:
        raise ValueError("COORD_CONFIG=ts_range needs NK >= NKML+NKBL+2")
    T0 = np.full(nz, float(t_light))
    S0 = np.full(nz, float(s_light))
    a1 = 2.0 * res_rat / (1.0 + res_rat)
    for k in range(kl0 + 1, nz):
        kf = (k - kl0) / (nz - 1 - kl0)
        fd = a1 * kf + (1.0 - a1) * kf * kf
        T0[k] = t_light + fd * (t_dense - t_light)
        S0[k] = s_light + fd * (s_dense - s_light)
    rho0 = float(gv.rho0)
    rlay = rho0 + _eos_np(get_eos(eos_name).density, dtype, T0, S0,
                          np.full(nz, p_ref), rho_ref=rho0)
    for k in range(kl0 - 1, -1, -1):
        rlay[k] = 2.0 * rlay[k + 1] - rlay[k + 2]
    gp = np.empty(nz, np.float64)
    gp[0] = gfs
    gp[1:] = gv.g_earth * np.diff(rlay) / rho0
    return gv.replace(g_prime=torch.tensor(gp, dtype=dtype, device=device),
                      Rlay=torch.tensor(rlay, dtype=dtype, device=device))


def _benchmark_t_profile(pf, gv, eos_name, nz, G, m, dtype):
    """The benchmark case's layer temperatures and SST
    (benchmark_initialization.F90): T0(k) Newton-solved so that the EOS
    density at (T0, S_REF, P_REF) is Rlay(k), the mixed and buffer layers
    (above k1) carrying a latitude-cosine SST.  Returns (T0 (nz,), k1,
    SST (ny, nx)), float64."""
    eos = get_eos(eos_name)
    s_ref = pf.get("S_REF", float, default=35.0, units="ppt", module=m)
    t_light = pf.get("BENCHMARK_T_LIGHT", float, default=29.0,
                     units="degC", module=m)
    p_ref = pf.get("P_REF", float, default=2e7, units="Pa", module=m)
    k1 = 0
    if pf.get("BULKMIXEDLAYER", bool, default=False, module=m):
        k1 = (pf.get("NKML", int, default=2, module=m)
              + pf.get("NKBL", int, default=2, module=m))
    k1 = min(k1, nz - 1)
    rlay = gv.Rlay.cpu().numpy().astype(np.float64)
    rho0 = float(gv.rho0)
    S = np.full(nz, s_ref)
    P = np.full(nz, p_ref)

    def rho_of(T):
        return rho0 + _eos_np(eos.density, dtype, T, S, P, rho_ref=rho0)

    dT1, _ = _eos_np(eos.density_derivs, dtype, t_light, s_ref, p_ref)
    T0 = t_light + (rlay - rho_of(np.full(nz, t_light))[k1]) / float(dT1)
    for _ in range(6):
        dT, _ = _eos_np(eos.density_derivs, dtype, T0, S, P)
        T0 = T0 + (rlay - rho_of(T0)) / dT
    lat = G.geoLatT.cpu().numpy().astype(np.float64)
    yfrac = (lat - lat.min()) / max(lat.max() - lat.min(), 1e-30)
    sst = (0.5 * (T0[k1] + T0[-1])
           - 0.45 * (T0[k1] - T0[-1]) * np.cos(np.pi * yfrac))
    return T0, k1, sst


def _benchmark_thickness(pf, G, gv, eos_name, nz, max_depth, m, dtype):
    """THICKNESS_CONFIG = benchmark (benchmark_initialize_thickness): each
    interface where the latitude-dependent profile (an exponential
    thermocline over a linear stratification) crosses the mean of its
    layers' target temperatures, Newton-solved, kept below the mixed
    layer and above the bottom; float64 numpy (nz, ny, nx)."""
    T0, _, sst = _benchmark_t_profile(pf, gv, eos_name, nz, G, m, dtype)
    ml_depth = pf.get("BENCHMARK_ML_DEPTH_IC", float, default=50.0,
                      units="m", module=m)
    ts_scale = pf.get("BENCHMARK_THERMOCLINE_SCALE", float, default=500.0,
                      units="m", module=m)
    a_exp = 0.9
    depth = G.bathyT.cpu().numpy().astype(np.float64)
    eta = np.zeros((nz + 1, G.ny, G.nx))
    eta[nz] = -depth
    t_bot = T0[nz - 1]
    for K in range(nz - 1, 0, -1):
        t_int = 0.5 * (T0[K] + T0[K - 1])
        t_frac = (t_int - t_bot) / np.maximum(sst - t_bot, 1e-10)
        z = np.zeros_like(depth)
        for _ in range(6):
            ez = np.exp(z / ts_scale)
            err = a_exp * ez + (1.0 - a_exp) * (z / max_depth + 1.0) - t_frac
            derr = a_exp * ez / ts_scale + (1.0 - a_exp) / max_depth
            z = z - err / derr
        e = np.minimum(np.maximum(z, -depth), -ml_depth)
        eta[K] = np.maximum(e, eta[K + 1] + float(gv.angstrom))
    return np.maximum(eta[:-1] - eta[1:], float(gv.angstrom))


def _ice_shelf(pf, G, gv, state, use_thermo, eos_name, dtype, device,
               input_dir):
    """ICE_SHELF: a prescribed shelf (ICE_PROFILE_CONFIG = linear, a draft
    tapering from the western edge to SHELF_EDGE_FRAC, or file) floating
    hydrostatically with SHELF_MIN_OCEAN_GAP of water under it, its melt
    parameters, and with TRIM_IC_FOR_P_SURF the initial columns trimmed
    to the shelf's weight (the density the EOS's at the mid-layer
    pressure).  Returns (ShelfCoupling or None, state)."""
    m = "MOM_ice_shelf"
    if not pf.get("ICE_SHELF", bool, default=False, module=m):
        return None, state
    rho_ice = pf.get("DENSITY_ICE", float, default=918.0, units="kg m-3",
                     module=m)
    prof = _one_of(pf, "ICE_PROFILE_CONFIG", "linear", ("linear", "file"), m)
    if prof == "linear":
        draft_max = pf.get("SHELF_MAX_DRAFT", float, default=700.0,
                           units="m", module=m)
        edge = pf.get("SHELF_EDGE_FRAC", float, default=0.5, module=m)
        xf = (np.arange(G.nx) + 0.5) / G.nx
        draft = draft_max * np.maximum(0.0, 1.0 - xf / max(edge, 1e-6))
        draft = np.broadcast_to(draft[None, :], (G.ny, G.nx)).copy()
    else:
        sfile = pf.get("SHELF_FILE", str, module=m)
        svar = pf.get("SHELF_DRAFT_VAR", str, default="draft", module=m)
        draft = np.asarray(read_nc(_input_path(pf, sfile, input_dir))[svar],
                           np.float64)
    gap = pf.get("SHELF_MIN_OCEAN_GAP", float, default=10.0, units="m",
                 module=m)
    # in the grid's working precision, as the reference's numpy
    draft = np.minimum(draft, G.bathyT.cpu().numpy() - gap)
    draft = np.maximum(draft, 0.0) * G.mask2dT.cpu().numpy()
    mass_shelf = torch.tensor(gv.rho0 * draft, dtype=dtype, device=device)
    frac = torch.tensor((draft > 1.0).astype(np.float64), dtype=dtype,
                        device=device)
    melt = IceShelfParams(
        gamma_t=pf.get("SHELF_GAMMA_T", float, default=1e-4, units="m s-1",
                       module=m),
        gamma_s=pf.get("SHELF_GAMMA_S", float, default=2.86e-6,
                       units="m s-1", module=m),
        rho_i=rho_ice, rho_w=gv.rho0)
    shelf = ShelfCoupling(
        mass_shelf=mass_shelf, frac_shelf_h=frac, melt=melt,
        flux_factor=pf.get("SHELF_FLUX_FACTOR", float, default=1.0,
                           module=m),
        ustar_dependent=pf.get("SHELF_USTAR_GAMMA", bool, default=False,
                               module=m),
        utide=pf.get("SHELF_UTIDE", float, default=0.0, units="m s-1",
                     module=m))
    if pf.get("TRIM_IC_FOR_P_SURF", bool, default=True, module=m) \
            and use_thermo:
        press = gv.g_earth * mass_shelf * frac
        rho = gv.rho0 + get_eos(eos_name).density(
            state.T, state.S, gv.rho0 * gv.g_earth
            * (vcumsum(state.h) - 0.5 * state.h), rho_ref=gv.rho0)
        h_t, _, _ = trim_columns_for_p_surf(state.h, state.T, state.S, rho,
                                            press, gv.g_earth,
                                            min_thickness=float(gv.angstrom))
        state = state.replace(h=h_t)
    return shelf, state


def build_model_from_params(pf: ParamFile, *, dtype=torch.float32,
                            device=DEFAULT_DEVICE,
                            input_dir: Optional[str] = None,
                            doc_dir: Optional[str] = None,
                            mesh=None) -> ModelSetup:
    """The model that ``pf`` describes, on ``device`` (the card unless
    the caller asks for the CPU).  ``input_dir`` is where INPUTDIR-relative
    files are looked for (default: ``doc_dir``, else the directory of the
    parameter file); with ``doc_dir`` the parameter documentation is
    written there.  With ``mesh`` (parallel/mesh.py) the model is built
    whole on the host and this rank's tile is returned on the mesh's
    device (``device`` is not used)."""
    if mesh is not None:
        from mom6_tpu_torch.parallel.mesh import shard_model, shard_over
        ms = build_model_from_params(pf, dtype=dtype, device="cpu",
                                     input_dir=input_dir, doc_dir=doc_dir)
        G, gv, st, p, f = shard_model(mesh, ms.grid, ms.vgrid, ms.state,
                                      ms.params, ms.forcing)
        provider = ms.forcing_provider
        if provider is not None:
            whole = provider
            provider = lambda t: shard_over(mesh, whole(t))   # noqa: E731
        return ModelSetup(G, gv, st, p, f, pf, forcing_provider=provider)
    device = resolve_device(device)
    input_dir = input_dir or doc_dir
    _check_inert(pf)
    G, max_depth = _build_grid(pf, dtype, device, input_dir)

    m = "MOM_verticalGrid"
    nz = pf.get("NK", int, module=m)
    gv = build_layered_vgrid(
        nz,
        g_earth=pf.get("G_EARTH", float, default=9.8, units="m s-2", module=m),
        rho0=pf.get("RHO_0", float, default=1035.0, units="kg m-3", module=m),
        gprime_int=pf.get("GINT", float, default=9.8e-3, units="m s-2",
                          module=m),
        dtype=dtype, device=device,
        boussinesq=pf.get("BOUSSINESQ", bool, default=True, module=m))

    m = "MOM"
    dt = pf.get("DT", float, module=m, units="s")
    dt_therm = pf.get("DT_THERM", float, default=dt, units="s", module=m)
    n_dyn_per_thermo = max(1, int(round(dt_therm / dt)))
    split = pf.get("SPLIT", bool, default=True, module=m)
    use_thermo = pf.get("ENABLE_THERMODYNAMICS", bool, default=True,
                        module=m)
    eos_name = pf.get("EQN_OF_STATE", str, default="WRIGHT", module=m)
    check_eos_ported(eos_name)
    gv = _coordinate(pf, gv, eos_name, use_thermo, dtype, device)

    m = "MOM_barotropic"
    unsplit = None
    unsplit_scheme = "RK3"
    if split:
        nstep_auto, _ = set_dtbt(G, gv, max_depth, dt)
        dtbt = pf.get("DTBT", float, default=-0.98, module=m)
        nstep = nstep_auto if dtbt < 0 else max(1, int(np.ceil(dt / dtbt)))
        # DT_BT_FILTER: < 0 a fraction of DT, >= 0 seconds
        dt_filt = pf.get("DT_BT_FILTER", float, default=-0.25, module=m)
        nfilter = int(np.ceil(abs(dt_filt) * nstep)) if dt_filt < 0 \
            else int(np.ceil(dt_filt / (dt / nstep)))
        bt = BTParams(nstep=nstep, nfilter=max(1, nfilter),
                      bebt=pf.get("BEBT", float, default=0.2, module=m),
                      use_bt_cont=pf.get("USE_BT_CONT_TYPE", bool,
                                         default=False, module=m),
                      lin_drag=pf.get("BT_LIN_DRAG", float, default=0.0,
                                      units="m s-1", module=m),
                      cdrag=pf.get("BT_CDRAG", float, default=0.0, module=m),
                      dynamic_psurf=pf.get("DYNAMIC_SURFACE_PRESSURE",
                                           bool, default=False, module=m),
                      const_dyn_psurf=pf.get("CONST_DYN_PSURF", float,
                                             default=0.9, module=m),
                      ice_strength_length=pf.get(
                          "ICE_LENGTH_DYN_PSURF", float, default=1.0e4,
                          units="m", module=m),
                      wide_halo=pf.get(
                          "BT_WIDE_HALO", int, default=0, module=m,
                          desc="March-inward barotropic halo width "
                          "(BT_HALO_SIZE analogue): each rank's tile "
                          "carries an N-cell rim and exchanges once per "
                          "N/2 substeps instead of at every shift. 0 keeps "
                          "the dense path; -1 = AUTO (width from the mesh "
                          "and the tile shape, off on one rank); takes "
                          "effect on a mesh of ranks (parallel/mesh.py)"))
    else:
        # the unsplit steppers: no barotropic solver
        bt = BTParams(nstep=1, nfilter=0)
        mv = "MOM_vert_friction"
        unsplit = UnsplitParams(
            dt=dt,
            kv=pf.get("KV", float, default=1e-4, units="m2 s-1", module=mv),
            bottom_drag=pf.get("DRAG_BG_VEL", float, default=0.0,
                               units="m s-1", module=mv)
            * pf.get("CDRAG", float, default=0.003, module=mv))
        # RK2 (MOM_dynamics_unsplit_RK2), else RK3 (MOM_dynamics_unsplit)
        unsplit_scheme = pf.get("UNSPLIT_SCHEME", str, default="RK3",
                                module="MOM").upper()

    m = "MOM_vert_friction"
    cdrag = pf.get("CDRAG", float, default=0.003, module=m)
    dyn = DynParams(
        dt=dt, bt=bt,
        scheme=("RK2B" if pf.get("SPLIT_RK2B", bool, default=False,
                                 module="MOM") else "RK2"),
        be=pf.get("BE", float, default=0.6, module=m),
        kv=pf.get("KV", float, default=1e-4, units="m2 s-1", module=m),
        bottom_drag=pf.get("DRAG_BG_VEL", float, default=0.0, units="m s-1",
                           module=m) * cdrag,
        cdrag=cdrag,
        coriolis_scheme=pf.get("CORIOLIS_SCHEME", str,
                               default="SADOURNY75_ENERGY",
                               module="MOM_CoriolisAdv").upper())
    if pf.get("USE_GL90_IN_SSW", bool, default=False, module=m):
        # GL90's interface viscosity, ALPHA_GL90 only with USE_GL90_N2
        dyn = dyn.replace(
            kappa_gl90=pf.get("KD_GL90", float, default=0.0,
                              units="m2 s-1", module=m),
            alpha_gl90=pf.get("ALPHA_GL90", float, default=0.0, units="m2",
                              module=m)
            if pf.get("USE_GL90_N2", bool, default=False, module=m)
            else 0.0,
            hbbl_gl90=pf.get("HBBL_GL90", float, default=5.0, units="m",
                             module=m))

    m = "MOM_hor_visc"
    hv = None
    kh = pf.get("KH", float, default=0.0, units="m2 s-1", module=m)
    ah = pf.get("AH", float, default=0.0, units="m4 s-1", module=m)
    smag_lap_c = pf.get("SMAG_LAP_CONST", float, default=0.15, module=m) \
        if pf.get("SMAGORINSKY_KH", bool, default=False, module=m) else 0.0
    smag_bi_c = pf.get("SMAG_BI_CONST", float, default=0.06, module=m) \
        if pf.get("SMAGORINSKY_AH", bool, default=False, module=m) else 0.0
    leith_c = pf.get("LEITH_LAP_CONST", float, default=1.0, module=m) \
        if pf.get("LEITH_KH", bool, default=False, module=m) else 0.0
    qg_leith = pf.get("USE_QG_LEITH_VISC", bool, default=False, module=m)
    kh_aniso, aniso_mode, aniso_n = 0.0, 0, (1.0, 0.0)
    if pf.get("ANISOTROPIC_VISCOSITY", bool, default=False, module=m):
        # along a fixed direction (mode 0) or along the flow (mode 2)
        kh_aniso = pf.get("KH_ANISO", float, default=0.0, units="m2 s-1",
                          module=m)
        aniso_mode = pf.get("ANISOTROPIC_MODE", int, default=0, module=m)
        aniso_n = (pf.get("ANISO_GRID_DIR_X", float, default=1.0, module=m),
                   pf.get("ANISO_GRID_DIR_Y", float, default=0.0, module=m))
    if kh or ah or smag_lap_c or smag_bi_c or leith_c or kh_aniso:
        hv = HorViscParams(kh=kh, ah=ah, smag_lap_const=smag_lap_c,
                           smag_bi_const=smag_bi_c, leith_lap_const=leith_c,
                           use_qg_leith=qg_leith, kh_aniso=kh_aniso,
                           aniso_mode=aniso_mode, aniso_n=aniso_n, dt=dt)

    m = "MOM_thickness_diffuse"
    gm = None
    if pf.get("THICKNESSDIFFUSE", bool, default=False, module=m):
        gm = GMParams(khth=pf.get("KHTH", float, default=10.0,
                                  units="m2 s-1", module=m))

    m = "MOM_MEKE"
    meke = None
    if pf.get("USE_MEKE", bool, default=False, module=m):
        def mk(key, default):
            return pf.get(key, float, default=default, module=m)
        meke = MEKEParams(
            damping=mk("MEKE_DAMPING", 1e-6), ke_coeff=mk("MEKE_KHCOEFF", 0.2),
            gm_src_frac=mk("MEKE_GMCOEFF", 1.0), bgsrc=mk("MEKE_BGSRC", 0.0),
            cd_scale=mk("MEKE_CD_SCALE", 0.0), cb=mk("MEKE_CB", 25.0),
            ct=mk("MEKE_CT", 50.0), uscale=mk("MEKE_USCALE", 0.0),
            kh_meke=mk("MEKE_KH", 100.0), cdrag=cdrag,
            a_deform=mk("MEKE_ALPHA_DEFORM", 0.0),
            a_frict=mk("MEKE_ALPHA_FRICT", 0.0),
            a_rhines=mk("MEKE_ALPHA_RHINES", 0.0),
            a_eady=mk("MEKE_ALPHA_EADY", 0.0),
            a_grid=mk("MEKE_ALPHA_GRID", 0.0),
            l_fixed=mk("MEKE_FIXED_MIXING_LENGTH", 0.0),
            topo_beta=mk("MEKE_TOPOGRAPHIC_BETA", 0.0),
            fr_coeff=mk("MEKE_FRCOEFF", 0.0),
            ku_coeff=mk("MEKE_VISCOSITY_COEFF_KU", 0.0))

    m = "MOM_mixed_layer_restrat"
    mlr = None
    if pf.get("MIXEDLAYER_RESTRAT", bool, default=False, module=m):
        mlr = MLRestratParams(fox_kemper_coef=pf.get(
            "FOX_KEMPER_ML_RESTRAT_COEF", float, default=0.0625, module=m))

    m = "MOM_tracer_hor_diff"
    khtr = pf.get("KHTR", float, default=0.0, units="m2 s-1", module=m)
    khtr_pass = pf.get("KHTR_PASSIVITY_COEFF", float, default=0.0, module=m)
    khtr_pass_min = pf.get("KHTR_PASSIVITY_MIN", float, default=0.5,
                           module=m)
    khtr_max = pf.get("KHTR_MAX", float, default=0.0, units="m2 s-1",
                      module=m)
    max_tr_cfl = pf.get("MAX_TR_DIFFUSION_CFL", float, default=-1.0,
                        module=m)
    # static subcycle count of the tracer diffusion from the grid-scale
    # CFL bound 8 KhTr dt / min(dx, dy)^2
    n_sub_tr = 1
    if max_tr_cfl > 0.0 and khtr > 0.0:
        wet = G.mask2dT.cpu().numpy() > 0.5
        dmin = float(min(np.where(wet, G.dxT.cpu().numpy(), np.inf).min(),
                         np.where(wet, G.dyT.cpu().numpy(), np.inf).min()))
        n_sub_tr = max(1, int(np.ceil(8.0 * khtr * dt * n_dyn_per_thermo
                                      / (dmin * dmin * max_tr_cfl))))
    use_ndiff = pf.get("USE_NEUTRAL_DIFFUSION", bool, default=False,
                       module=m)
    khtr_bl = (pf.get("LBD_KHTR", float, default=khtr, units="m2 s-1",
                      module=m)
               if pf.get("USE_HORIZONTAL_BOUNDARY_DIFFUSION", bool,
                         default=False, module=m) else 0.0)

    # the tidal mixing (INT_TIDE_DISSIPATION)
    m = "MOM_tidal_mixing"
    tidal = None
    if pf.get("INT_TIDE_DISSIPATION", bool, default=False, module=m):
        tidal = TidalMixingParams(
            profile=pf.get("INT_TIDE_PROFILE", str, default="STLAURENT_02",
                           module=m).upper(),
            int_tide_decay_scale=pf.get("INT_TIDE_DECAY_SCALE", float,
                                        default=500.0, units="m", module=m),
            mu_itides=pf.get("MU_ITIDES", float, default=0.2, module=m),
            gamma_itides=pf.get("GAMMA_ITIDES", float, default=0.3333,
                                module=m),
            kappa_h2_factor=pf.get("KAPPA_H2_FACTOR", float, default=0.85,
                                   module=m),
            utide=pf.get("UTIDE", float, default=0.0, units="m s-1",
                         module=m),
            h2=pf.get("TIDAL_ROUGHNESS_H2", float, default=100.0,
                      units="m2", module=m),
            kd_max=pf.get("KD_MAX_ITIDES", float, default=50e-4,
                          units="m2 s-1", module=m))

    m = "MOM_bulk_mixed_layer"
    bulkml = None
    if pf.get("BULKMIXEDLAYER", bool, default=False, module=m):
        bulkml = BulkMLParams(
            nkml=pf.get("NKML", int, default=2, module=m),
            nkbl=pf.get("NKBL", int, default=2, module=m),
            mstar=pf.get("MSTAR", float, default=1.2, module=m),
            bulk_ri_ml=pf.get("BULK_RI_ML", float, default=0.8, module=m),
            tke_decay=pf.get("TKE_DECAY", float, default=2.5, module=m),
            hmix_min=pf.get("HMIX_MIN", float, default=2.0, units="m",
                            module=m))
        if nz < bulkml.nkml + bulkml.nkbl + 2:
            raise ValueError("BULKMIXEDLAYER needs NK >= NKML + NKBL + 2")

    m = "MOM_diabatic_driver"
    diab = DiabaticParams(
        diff=DiffusivityParams(
            kd=pf.get("KD", float, default=1e-5, units="m2 s-1", module=m),
            kd_min=pf.get("KD_MIN", float, default=0.0, module=m),
            tidal=tidal),
        cp=pf.get("C_P", float, default=3991.87, units="J kg-1 K-1",
                  module=m),
        bulkml=bulkml,
        boundary_layer_scheme=(
            "BULKML" if bulkml is not None
            else "KPP" if pf.get("USE_KPP", bool, default=False, module=m)
            else ("EPBL" if pf.get("ENERGETICS_SFC_PBL", bool,
                                   default=False, module=m) else "NONE")),
        use_shear_mixing=(pf.get("USE_CVMIX_SHEAR", bool, default=False,
                                 module=m)
                          or pf.get("USE_JACKSON_PARAM", bool, default=False,
                                    module=m)),
        shear_scheme=("JHL" if pf.get("USE_JACKSON_PARAM", bool,
                                      default=False, module=m)
                      else "LMD94"),
        frazil=pf.get("FRAZIL", bool, default=False, module=m),
        tfreeze_form=_one_of(pf, "TFREEZE_FORM", "LINEAR",
                             ("LINEAR", "MILLERO_78", "TEOS_POLY", "TEOS10"),
                             m))
    geo_scale = pf.get("GEOTHERMAL_SCALE", float, default=0.0,
                       units="W m-2", module="MOM_geothermal")
    if geo_scale > 0.0:
        diab = dataclasses.replace(diab, geothermal=GeothermalParams(
            heat_flux=geo_scale))
    m = "MOM_opacity"
    if pf.get("PEN_SW_NBANDS", int, default=0, module=m) > 0:
        diab = dataclasses.replace(diab, opacity=OpacityParams(
            r_frac=pf.get("PEN_SW_FRAC_R", float, default=0.58, module=m),
            zeta1=pf.get("PEN_SW_ZETA1", float, default=0.35, units="m",
                         module=m),
            zeta2=pf.get("PEN_SW_ZETA2", float, default=23.0, units="m",
                         module=m)))
    m = "MOM_diabatic_driver"
    if pf.get("USE_CVMIX_CONVECTION", bool, default=False, module=m):
        diab = dataclasses.replace(diab, convection=ConvectionParams(
            kd_conv=pf.get("KD_CONV", float, default=1.0, units="m2 s-1",
                           module=m)))
    if pf.get("DOUBLE_DIFFUSION", bool, default=False, module=m) or \
            pf.get("USE_CVMIX_DDIFF", bool, default=False, module=m):
        diab = dataclasses.replace(diab, ddiff=DDiffParams())
    m = "MOM_diabatic_aux"
    if pf.get("DO_BRINE_PLUME", bool, default=False, module=m):
        diab = dataclasses.replace(
            diab, do_brine_plume=True,
            brine_plume_n=pf.get("BRINE_PLUME_EXPONENT", int, default=5,
                                 module=m),
            brine_plume_frac=pf.get("BRINE_PLUME_FRACTION", float,
                                    default=1.0, module=m))

    # the bottom boundary layer: set_viscous_BBL and the mixing its drag
    # sustains
    m = "MOM_set_viscosity"
    bbl_visc = None
    if pf.get("BOTTOMDRAGLAW", bool, default=False, module=m):
        bbl_visc = SetViscParams(
            cdrag=pf.get("CDRAG", float, default=0.003, module=m),
            hbbl=pf.get("HBBL", float, default=10.0, units="m", module=m),
            bbl_thick_min=pf.get("BBL_THICK_MIN", float, default=0.1,
                                 units="m", module=m),
            kv_bbl_min=pf.get("KV_BBL_MIN", float, default=1e-4,
                              units="m2 s-1", module=m),
            drag_bg_vel=pf.get("DRAG_BG_VEL", float, default=0.0,
                               units="m s-1", module=m))
        diab = dataclasses.replace(diab, diff=dataclasses.replace(
            diab.diff, bbl_effic=pf.get("BBL_EFFIC", float, default=0.2,
                                        module="MOM_set_diffusivity")))

    # the lateral extras: the interface filter, the porous barriers' sills
    # from the bathymetry and the Zanna-Bolton closure
    m = "MOM_interface_filter"
    iface_filter = None
    if pf.get("APPLY_INTERFACE_FILTER", bool, default=False, module=m):
        iface_filter = InterfaceFilterParams(
            time_scale=pf.get("INTERFACE_FILTER_TIME_SCALE", float,
                              default=3600.0, units="s", module=m),
            order=pf.get("INTERFACE_FILTER_ORDER", int, default=2,
                         module=m))
    porous = None
    if pf.get("POROUS_BARRIER", bool, default=False,
              module="MOM_porous_barriers"):
        porous = _porous_sills(G)
    m = "MOM_Zanna_Bolton"
    zb = None
    if pf.get("USE_ZB2020", bool, default=False, module=m):
        zb = ZBParams(amplitude=pf.get("ZB_SCALING", float, default=0.3,
                                       module=m))

    # the Stanley correction, the tides and the SAL, the stochastic physics
    m = "MOM_stoch_eos"
    stanley = -1.0
    if pf.get("USE_STANLEY_PGF", bool, default=False, module=m):
        stanley = pf.get("STANLEY_COEFF", float, default=0.5, module=m)
    m = "MOM_tidal_forcing"
    tides = None
    if pf.get("TIDES", bool, default=False, module=m):
        tides = TidalForcingParams(names=tuple(pf.get(
            "TIDE_CONSTITUENTS", str, default="M2", module=m
        ).replace(" ", "").split(",")))
        if pf.get("GRID_CONFIG", str, default="cartesian",
                  module="MOM_grid_init") != "spherical":
            raise ValueError("TIDES requires GRID_CONFIG=spherical "
                             "(astronomical potential needs lat/lon)")
    m = "MOM_self_attr_load"
    sal_scalar = pf.get("SAL_SCALAR_VALUE", float, default=0.0, module=m,
                        desc="Scalar SAL coefficient applied inside the "
                             "barotropic subcycle")
    if sal_scalar != 0.0:
        dyn = dyn.replace(bt=dyn.bt.replace(sal_scalar=sal_scalar))
    sal_h = None
    if pf.get("SAL_HARMONICS", bool, default=False, module=m):
        sal_h = build_sal_harmonics(
            G, nmax=pf.get("SAL_HARMONICS_DEGREE", int, default=12,
                           module=m))
    m = "MOM_stochastics"
    sppt = None
    skeb_scale = 0.0
    do_sppt = pf.get("DO_SPPT", bool, default=False, module=m)
    do_skeb = pf.get("DO_SKEB", bool, default=False, module=m)
    if do_sppt or do_skeb:
        sppt = SPPTParams(
            amplitude=pf.get("SPPT_AMPLITUDE", float, default=0.5,
                             module=m),
            tau=pf.get("SPPT_TAU", float, default=6.0 * 3600.0, units="s",
                       module=m))
        if do_skeb:
            skeb_scale = pf.get("SKEB_SCALE", float, default=1.0,
                                units="m2 s-1", module=m)

    # surface waves: the Langmuir number for KPP and ePBL
    m = "MOM_wave_interface"
    waves = None
    use_waves = pf.get("USE_WAVES", bool, default=False, module=m)
    la_li2016 = pf.get("USE_LA_LI2016", bool, default=False, module=m)
    if (use_waves or la_li2016) and \
            pf.get("LANGMUIR_MIXING", bool, default=True, module=m):
        method = "LF17" if (la_li2016 and not use_waves) else \
            pf.get("WAVE_METHOD", str, default="LF17", module=m).upper()
        if method not in ("LF17", "DHH85", "SURFBANDS", "EFACTOR"):
            raise NotImplementedError(f"WAVE_METHOD = {method!r} is not "
                                      "ported (only LF17, DHH85, "
                                      "SURFBANDS, EFACTOR)")
        waves = WaveParams(
            method=method,
            la_frac_hbl=pf.get("LA_DEPTH_RATIO", float, default=0.04,
                               module=m),
            la_hbl_min=pf.get("LA_DEPTH_MIN", float, default=0.1,
                              units="m", module=m),
            misalignment=pf.get("LA_MISALIGNMENT", bool, default=False,
                                module=m),
            wave_age=pf.get("WAVE_AGE", float, default=1.2, module=m),
            wave_wind=pf.get("WAVE_WIND", float, default=10.0,
                             units="m s-1", module=m),
            band_stokes_x=tuple(pf.get_list("SURFBAND_STOKES_X",
                                            default=(), module=m)),
            band_stokes_y=tuple(pf.get_list("SURFBAND_STOKES_Y",
                                            default=(), module=m)),
            band_wavenumbers=tuple(pf.get_list("SURFBAND_WAVENUMBERS",
                                               default=(), module=m)))

    m = "MOM_ALE"
    ale = ALEParams(mode=LAYER)
    remap_scheme = pf.get("REMAPPING_SCHEME", str, default="PPM_H4",
                          module=m).upper()
    if remap_scheme not in _SCHEMES:
        raise NotImplementedError(f"REMAPPING_SCHEME = {remap_scheme!r} is "
                                  f"not ported (only {', '.join(_SCHEMES)})")
    if pf.get("USE_REGRIDDING", bool, default=False, module=m):
        mode = pf.get("REGRIDDING_COORDINATE_MODE", str, default="Z*",
                      module=m).upper()
        if mode not in _COORDINATES:
            raise NotImplementedError(
                f"REGRIDDING_COORDINATE_MODE = {mode!r} is not ported "
                f"(only {', '.join(_COORDINATES)})")
        dz = pf.get_list("ALE_RESOLUTION", default=[max_depth / nz] * nz,
                         module=m)
        if mode in ("RHO", HYCOM1, HYBGEN):
            rlay = pf.get_list("ALE_RHO_TARGETS",
                               default=gv.Rlay.cpu().numpy().tolist(),
                               module=m)
            qrlx = 0.25
            if mode == HYBGEN:
                qrlx = 1.0 / max(pf.get("HYBGEN_RELAX_PERIOD", float,
                                        default=4.0, module=m), 1.0)
            ale = ALEParams(mode=mode, rho_targets=tuple(rlay),
                            dz_nominal=tuple(dz) if mode != "RHO" else (),
                            eos_name=eos_name, scheme=remap_scheme,
                            hybgen_qrlx=qrlx)
        elif mode == SIGMA:
            ale = ALEParams(mode=SIGMA, scheme=remap_scheme)
        elif mode == SIGMA_SHELF_ZSTAR:
            ale = ALEParams(
                mode=SIGMA_SHELF_ZSTAR, dz_nominal=tuple(dz),
                scheme=remap_scheme,
                shelf_depth=pf.get("SIGMA_SHELF_ZSTAR_DEPTH", float,
                                   default=200.0, units="m", module=m))
        elif mode == ADAPTIVE:
            ale = ALEParams(
                mode=ADAPTIVE, dz_nominal=tuple(dz), eos_name=eos_name,
                scheme=remap_scheme,
                adapt_time_ratio=pf.get("ADAPT_TIME_RATIO", float,
                                        default=0.1, module=m),
                adapt_zoom_depth=pf.get("ADAPT_ZOOM_DEPTH", float,
                                        default=200.0, units="m", module=m),
                adapt_zoom_coeff=pf.get("ADAPT_ZOOM_COEFF", float,
                                        default=0.2, module=m),
                adapt_buoy_coeff=pf.get("ADAPT_BUOY_COEFF", float,
                                        default=0.8, module=m),
                adapt_alpha=pf.get("ADAPT_ALPHA", float, default=1.0,
                                   module=m),
                adapt_drho0=pf.get("ADAPT_DRHO0", float, default=0.5,
                                   units="kg m-3", module=m),
                adapt_do_min=pf.get("ADAPT_DO_MIN_DEPTH", bool,
                                    default=False, module=m))
        else:
            ale = ALEParams(mode=ZSTAR, dz_nominal=tuple(dz),
                            scheme=remap_scheme)

    obc, obc_ts = _open_boundaries(pf, G, gv, ale, nz, max_depth, dtype,
                                   device, input_dir)

    # the low-mode internal tides: the M2, S2, K1 and O1 frequencies by
    # count, the conversion split equally
    m = "MOM_internal_tides"
    int_tides = None
    if pf.get("INTERNAL_TIDES", bool, default=False, module=m):
        freq_table = (1.4052e-4, 1.4544e-4, 7.2921e-5, 6.7598e-5)
        nfreq = max(1, min(pf.get("INTERNAL_TIDE_FREQS", int, default=1,
                                  module=m), 4))
        int_tides = InternalTidesParams(
            n_angle=pf.get("INTERNAL_TIDE_ANGLES", int, default=8,
                           module=m),
            freqs=freq_table[:nfreq], freq_frac=(1.0,) * nfreq,
            n_mode=pf.get("INTERNAL_TIDE_MODES", int, default=1, module=m),
            decay_rate=pf.get("INT_TIDE_BACKGROUND_DECAY", float,
                              default=0.0, units="s-1", module=m),
            drag_coef=pf.get("INT_TIDE_DRAG_COEF", float, default=1e-4,
                             module=m))
    tfc = _tracer_packages(pf)

    m = "MOM_lateral_mixing_coeffs"
    varmix = None
    if pf.get("USE_VARIABLE_MIXING", bool, default=False, module=m):
        varmix = VarMixParams(
            resoln_scaled_kh=pf.get("RESOLN_SCALED_KH", bool, default=False,
                                    module=m),
            resoln_scaled_khth=pf.get("RESOLN_SCALED_KHTH", bool,
                                      default=False, module=m),
            resoln_scaled_khtr=pf.get("RESOLN_SCALED_KHTR", bool,
                                      default=False, module=m),
            use_visbeck=pf.get("USE_VISBECK", bool, default=False, module=m),
            res_coef=pf.get("KH_RES_SCALE_COEF", float, default=1.0,
                            module=m),
            res_fn_power=pf.get("KH_RES_FN_POWER", int, default=2, module=m),
            khth_slope_cff=pf.get("KHTH_SLOPE_CFF", float, default=0.0,
                                  module="MOM_thickness_diffuse"),
            khtr_slope_cff=pf.get("KHTR_SLOPE_CFF", float, default=0.0,
                                  module="MOM_tracer_hor_diff"),
            visbeck_l_scale=pf.get("VISBECK_L_SCALE", float, default=0.0,
                                   units="m", module=m))

    params = MOMParams(
        dyn=dyn, thermo_enabled=use_thermo, eos_name=eos_name,
        diabatic=diab, ale=ale, hor_visc=hv, gm=gm, meke=meke,
        mlrestrat=mlr, khtr=khtr, khtr_n_sub=n_sub_tr,
        khtr_passivity_coeff=khtr_pass, khtr_passivity_min=khtr_pass_min,
        khtr_max=khtr_max, khtr_bl=khtr_bl,
        diabatic_first=pf.get("DIABATIC_FIRST", bool, default=False,
                              module="MOM"),
        homogenize_forcings=pf.get("HOMOGENIZE_FORCINGS", bool,
                                   default=False, module="MOM"),
        n_dyn_per_thermo=n_dyn_per_thermo, tfc=tfc, obc=obc,
        bbl_visc=bbl_visc, waves=waves, unsplit=unsplit,
        interface_filter=iface_filter, porous=porous, zb=zb,
        stanley_coeff=stanley, tides=tides, sal_harmonics=sal_h, sppt=sppt,
        skeb_scale=skeb_scale,
        unsplit_scheme=unsplit_scheme, int_tides=int_tides,
        neutral_diffusion=use_ndiff, varmix=varmix,
        ndiff_scheme=_ndiff_scheme(pf),
        tracer_advect_sub=pf.get("TRACER_ADVECT_SUB", int,
                                 default=max(2, n_dyn_per_thermo),
                                 module="MOM_tracer_advect"),
        # the reference's default is use_ALE
        pf_recon=pf.get("RECONSTRUCT_FOR_PRESSURE", bool,
                        default=ale.mode != LAYER,
                        module="MOM_PressureForce"))

    # -- initial state: resting layers clipped to the bathymetry and
    # displaced as THICKNESS_CONFIG says, with the T_REF/T_RANGE profile
    # or a front and uniform S_REF under thermodynamics -------------------
    m = "MOM_state_initialization"
    thick_cfg = _one_of(pf, "THICKNESS_CONFIG", "uniform",
                        ("uniform", "circle_obcs", "benchmark", "sloshing",
                         "internal_wave", "gwave", "soliton", "phillips"), m)
    state = init_state_resting(G, gv, np.full(nz, max_depth / nz),
                               dtype=dtype, with_thermo=use_thermo)
    if thick_cfg == "benchmark":
        if use_thermo:
            state = state.replace(h=torch.tensor(
                _benchmark_thickness(pf, G, gv, eos_name, nz, max_depth, m,
                                     dtype), dtype=dtype, device=device))
    elif thick_cfg == "circle_obcs":
        state = state.replace(h=_circle_obcs(pf, G, state, nz, m))
    elif thick_cfg != "uniform":
        state = state.replace(**_displaced(pf, thick_cfg, G, gv, state,
                                           max_depth, dtype, device))
    if meke is not None:
        state = state.replace(E_meke=torch.zeros((G.ny, G.nx), dtype=dtype,
                                                 device=device))
    if int_tides is not None:
        state = state.replace(En_itide=init_int_tide_energy(
            int_tides, G.ny, G.nx, dtype, device))
    if use_thermo:
        ts_cfg = _one_of(pf, "TS_CONFIG", "fit",
                         ("fit", "benchmark", "front", "rossby_front",
                          "from_Z"), m)
        t_ref = pf.get("T_REF", float, default=10.0, units="degC", module=m)
        s_ref = pf.get("S_REF", float, default=35.0, units="ppt", module=m)
        shape = tuple(state.h.shape)
        S = None
        if ts_cfg == "from_Z":
            T, S = _ts_from_z(pf, G, state.h, input_dir, m)
            if pf.has("T_RANGE"):
                # the profile's, which from_Z leaves unused (the
                # reference leaves it unread): a run directory that sets
                # it for the other TS_CONFIGs still builds
                pf.get("T_RANGE", float, module=m)
        elif ts_cfg == "benchmark":
            # the layers' target temperatures, the SST in the mixed and
            # buffer layers
            T0, k1, sst = _benchmark_t_profile(pf, gv, eos_name, nz, G, m,
                                               dtype)
            tprof = np.broadcast_to(T0[:, None, None], shape).copy()
            tprof[:k1] = sst[None]
            T = torch.tensor(tprof, dtype=dtype, device=device)
        elif ts_cfg == "front":
            tfield = _front(pf, G, t_ref, m)
            T = torch.tensor(np.broadcast_to(tfield[None], shape),
                             dtype=dtype, device=device)
        elif ts_cfg == "rossby_front":
            tfield = _rossby_front(pf, G, t_ref, nz, max_depth, m)
            T = torch.tensor(np.broadcast_to(tfield, shape), dtype=dtype,
                             device=device)
        else:
            trange = pf.get("T_RANGE", float, default=0.0, units="degC",
                            module=m)
            zc = np.cumsum(np.full(nz, max_depth / nz)) - max_depth / nz / 2
            tprof = t_ref + trange * (0.5 - zc / max_depth)
            T = torch.tensor(np.broadcast_to(tprof[:, None, None], shape),
                             dtype=dtype, device=device)
        if S is None:
            S = torch.full(shape, s_ref, dtype=dtype, device=device)
        state = state.replace(T=T, S=S)
    if use_thermo and ale.mode != LAYER and (
            diab.boundary_layer_scheme in ("KPP", "EPBL")
            or diab.use_shear_mixing):
        # the boundary-layer and shear viscosity carried across cycles
        state = state.replace(kv_shear=torch.zeros(
            (nz + 1, G.ny, G.nx), dtype=dtype, device=device))

    # -- surface forcing ----------------------------------------------------
    m = "MOM_surface_forcing"
    # in the working precision, as the reference evaluates the profiles
    lat = G.geoLatT.cpu().numpy()

    def field(a):
        return torch.tensor(np.array(a, dtype=np.float64), dtype=dtype,
                            device=device)

    taux = tauy = None
    wind = _one_of(pf, "WIND_CONFIG", "zero",
                   ("zero", "gyres", "global", "constant", "ideal_hurr",
                    "SCM_ideal_hurr", "file"), m)
    wind_fn = wind_ts = None
    if wind == "gyres":
        # taux = sin_amp sin(n pi y) + cos_amp cos(n pi y) of the
        # normalised y; without amplitudes -TAUX_MAGNITUDE cos(2 pi y)
        sin_amp = pf.get("TAUX_SIN_AMP", float, default=0.0, units="Pa",
                         module=m)
        cos_amp = pf.get("TAUX_COS_AMP", float, default=0.0, units="Pa",
                         module=m)
        n_pis = pf.get("TAUX_N_PIS", float, default=1.0, module=m)
        yfrac = (lat - lat.min()) / max(lat.max() - lat.min(), 1e-30)
        if sin_amp or cos_amp:
            prof = (sin_amp * np.sin(n_pis * np.pi * yfrac)
                    + cos_amp * np.cos(n_pis * np.pi * yfrac))
        else:
            tau0 = pf.get("TAUX_MAGNITUDE", float, default=0.1, units="Pa",
                          module=m)
            prof = -tau0 * np.cos(2 * np.pi * yfrac)
        taux = field(prof) * G.mask2dCu
        tauy = torch.zeros_like(G.mask2dCv)
    elif wind == "global":
        # idealized zonal-mean wind stress on geographic latitude:
        # easterly trades, mid-latitude westerlies (stronger in the
        # Southern Ocean), weak polar easterlies, tapered beyond 65 degrees
        tau0 = pf.get("TAUX_MAGNITUDE", float, default=0.1, units="Pa",
                      module=m)
        prof = -np.cos(np.pi * lat / 35.0) * np.exp(-(lat / 65.0) ** 4)
        prof = prof * np.where(lat < -30.0, 1.4, 1.0)
        taux = field(tau0 * prof) * G.mask2dCu
        tauy = torch.zeros_like(G.mask2dCv)
    elif wind == "constant":
        taux = torch.full((G.ny, G.nx), pf.get(
            "CONST_WIND_TAUX", float, default=0.0, module=m),
            dtype=dtype, device=device) * G.mask2dCu
        tauy = torch.full((G.ny, G.nx), pf.get(
            "CONST_WIND_TAUY", float, default=0.0, module=m),
            dtype=dtype, device=device) * G.mask2dCv
    elif wind in ("ideal_hurr", "SCM_ideal_hurr"):
        # translating Holland-profile cyclone, evaluated per segment by
        # the provider (Idealized_Hurricane.F90:336-456)
        def hp(key, default, units=""):
            return pf.get(key, float, default=default, units=units,
                          module=m)
        wind_fn = hurricane_wind_fn(G, dict(
            rad_max=hp("IDL_HURR_RAD_MAX_WIND", 50.0e3, "m"),
            vmax=hp("IDL_HURR_MAX_WIND", 65.0, "m s-1"),
            trans_spd=hp("IDL_HURR_TRAN_SPEED", 5.0, "m s-1"),
            trans_dir_deg=hp("IDL_HURR_TRAN_DIR", 180.0, "degrees"),
            x0=hp("IDL_HURR_X0", 0.0, "m"),
            y0=hp("IDL_HURR_Y0", 0.0, "m"),
            p_ambient=hp("IDL_HURR_AMBIENT_PRESSURE", 101200.0, "Pa"),
            p_central=hp("IDL_HURR_CENTRAL_PRESSURE", 96800.0, "Pa")))
    elif wind == "file":
        # wind_forcing_from_file (MOM_surface_forcing.F90:418-560), A-grid
        # stress time-interpolated from the records, averaged to the faces
        wfile = pf.get("WIND_FILE", str, module=m,
                       desc="NetCDF file with wind stress time series")
        xvar = pf.get("WINDSTRESS_X_VAR", str, default="STRESS_X", module=m)
        yvar = pf.get("WINDSTRESS_Y_VAR", str, default="STRESS_Y", module=m)
        wscale = pf.get("WIND_STRESS_MULTIPLIER", float, default=1.0,
                        module=m)
        periodic = pf.get("WIND_PERIODIC", bool, default=True, module=m,
                          desc="Treat the wind records as a climatology")
        raw = read_nc(_input_path(pf, wfile, input_dir))
        tax = raw.get("time", np.arange(raw[xvar].shape[0], dtype=float))
        wind_ts = (TimeSeriesField(tax, raw[xvar] * wscale,
                                   periodic=periodic),
                   TimeSeriesField(tax, raw[yvar] * wscale,
                                   periodic=periodic),
                   _bilinear(raw, G))
    heat = t_restore = None
    restore_rate = 0.0
    buoy = _one_of(pf, "BUOY_CONFIG", "zero",
                   ("zero", "NS_heating", "const", "global", "file",
                    "linear"), m)
    buoy_ts = None
    if buoy == "NS_heating":
        # HEATING_MAGNITUDE cos(pi y / LENLAT), y the distance north [m]
        q0 = pf.get("HEATING_MAGNITUDE", float, default=50.0, units="W m-2",
                    module=m)
        ly = pf.get("LENLAT", float, default=1000.0) * 1e3
        heat = field(q0 * np.cos(np.pi * (lat * 1e3) / ly)) * G.mask2dT
    elif buoy == "const":
        q0 = pf.get("SENSIBLE_HEAT_FLUX", float, default=0.0, units="W m-2",
                    module=m)
        heat = torch.full((G.ny, G.nx), q0, dtype=dtype,
                          device=device) * G.mask2dT
    elif buoy == "global":
        if not use_thermo:
            raise NotImplementedError("BUOY_CONFIG = 'global' needs "
                                      "ENABLE_THERMODYNAMICS")
        # restore SST toward T*(lat) = T_POLE + (T_EQ - T_POLE) cos^2(lat)
        # with piston velocity FLUXCONST [m day-1]
        restore_rate = pf.get("FLUXCONST", float, default=0.5,
                              units="m day-1", module=m) / 86400.0
        t_eq = pf.get("SST_EQUATOR", float, default=27.0, units="degC",
                      module=m)
        t_po = pf.get("SST_POLE", float, default=-1.0, units="degC",
                      module=m)
        t_restore = field(t_po + (t_eq - t_po) * np.cos(np.deg2rad(lat)) ** 2)
    elif buoy == "file":
        if not use_thermo:
            raise NotImplementedError("BUOY_CONFIG = 'file' needs "
                                      "ENABLE_THERMODYNAMICS")
        # one file with the net heat flux (HEAT_VAR, +down), optionally a
        # shortwave part (SW_VAR) and a fresh-water flux (FW_VAR), each a
        # (time, lat, lon) record (the reference's condensed
        # buoyancy_forcing_from_files)
        bfile = pf.get("BUOY_FILE", str, module=m,
                       desc="NetCDF file with surface buoyancy fluxes")
        hvar = pf.get("HEAT_VAR", str, default="heat", module=m)
        swvar = pf.get("SW_VAR", str, default="", module=m)
        fwvar = pf.get("FW_VAR", str, default="", module=m)
        periodic = pf.get("BUOY_PERIODIC", bool, default=True, module=m)
        raw = read_nc(_input_path(pf, bfile, input_dir))
        tax = raw.get("time", np.arange(raw[hvar].shape[0], dtype=float))

        def series(var):
            return TimeSeriesField(tax, raw[var], periodic=periodic) \
                if var else None
        buoy_ts = (series(hvar), series(swvar), series(fwvar),
                   _bilinear(raw, G))
    elif buoy == "linear" and not use_thermo:
        raise NotImplementedError("BUOY_CONFIG = 'linear' needs "
                                  "ENABLE_THERMODYNAMICS")
    elif buoy == "linear" and pf.get("RESTOREBUOY", bool, default=False,
                                     module=m):
        # buoyancy_forcing_linear: SST restored with the piston velocity
        # FLUXCONST [m day-1] toward a profile linear in latitude
        restore_rate = pf.get("FLUXCONST", float, default=0.0,
                              units="m day-1", module=m) / 86400.0
        sst_n = pf.get("SST_NORTH", float, default=25.0, units="degC",
                       module=m)
        sst_s = pf.get("SST_SOUTH", float, default=10.0, units="degC",
                       module=m)
        yfrac = (lat - lat.min()) / max(lat.max() - lat.min(), 1e-30)
        t_restore = field(sst_s + (sst_n - sst_s) * yfrac)
    forcing = Forcing(mech=MechForcing(taux=taux, tauy=tauy),
                      buoy=BuoyancyForcing(heat_flux=heat,
                                           t_restore=t_restore,
                                           restore_rate=restore_rate))
    provider = None
    if wind_fn is not None or wind_ts is not None or buoy_ts is not None \
            or obc_ts:
        provider = _ForcingProvider(forcing, G, wind_fn, wind_ts, buoy_ts,
                                    dtype, device, obc=obc, obc_ts=obc_ts)
        forcing = provider(0.0)
    if waves is not None:
        # the 10 m wind of the Langmuir number from the stress by the bulk
        # formula tau = rho_air cd U10^2 (on the base forcing only, as the
        # reference's)
        tx = taux if taux is not None else torch.zeros_like(G.mask2dT)
        ty = tauy if tauy is not None else torch.zeros_like(G.mask2dT)
        forcing = forcing.replace(mech=forcing.mech.replace(u10=csqrt(
            sdiv(csqrt(tx * tx + ty * ty), 1.225 * 1.3e-3))))

    if tfc is not None:
        state = state.replace(tr=tfc.init_tracers(tuple(state.h.shape), dtype,
                                                  device))
    if obc is not None and obc.res_len_in > 0.0 and use_thermo:
        # the segments' tracer reservoirs start from the initial state
        state = state.replace(obc_res_T=state.T.clone(),
                              obc_res_S=state.S.clone())
    if tides is not None:
        state = state.replace(time=torch.zeros((), dtype=dtype, device=device))
    if dyn.scheme == "RK2B":
        # the RK2b restart pair: the corrections from the time-filtered
        # velocities to the instantaneous ones, zero at the start
        state = state.replace(
            du_av_inst=torch.zeros((G.ny, G.nx), dtype=dtype, device=device),
            dv_av_inst=torch.zeros((G.ny, G.nx), dtype=dtype, device=device))
    if sppt is not None:
        state = state.replace(rng_key=PRNGKey(
            pf.get("STOCH_SEED", int, default=0, module="MOM_stochastics"),
            device=device))
        zero = torch.zeros((G.ny, G.nx), dtype=dtype, device=device)
        if do_sppt:
            state = state.replace(sppt_pattern=zero)
        if do_skeb:
            state = state.replace(skeb_pattern=zero.clone())

    # the sponge: damping bands (or the whole domain) relaxing T and S to
    # the initial state (the reference builds the damping analytically
    # in place of SPONGE_DAMPING_FILE)
    m = "MOM_sponge"
    if pf.get("SPONGE", bool, default=False, module=m) and use_thermo:
        idamp_max = pf.get("SPONGE_IDAMP", float, default=1.0 / 86400.0,
                           units="s-1", module=m)
        sp_cfg = _one_of(pf, "SPONGE_CONFIG", "NS_bands",
                         ("NS_bands", "uniform"), m)
        width = pf.get("SPONGE_WIDTH_FRAC", float, default=0.1, module=m)
        yfrac = (np.arange(G.ny) + 0.5) / G.ny
        if sp_cfg == "NS_bands":
            prof = np.maximum(np.maximum(1.0 - yfrac / width,
                                         1.0 - (1.0 - yfrac) / width), 0.0)
        else:
            prof = np.ones(G.ny)
        idamp = torch.tensor(
            np.broadcast_to((idamp_max * prof)[:, None], (G.ny, G.nx)),
            dtype=dtype, device=device) * G.mask2dT
        params = params.replace(sponge=SpongeParams(
            idamp=idamp, T_ref=state.T, S_ref=state.S))

    shelf, state = _ice_shelf(pf, G, gv, state, use_thermo, eos_name, dtype,
                              device, input_dir)
    if shelf is not None:
        params = params.replace(shelf=shelf)
    if not gv.boussinesq and use_thermo:
        # the prognostic h of the non-Boussinesq mode is mass / rho0: the
        # geometric thicknesses above converted with the hydrostatic
        # in-situ density (convert_thickness)
        state = state.replace(h=geometric_to_mass_h(
            state.h, state.T, state.S, gv, get_eos(eos_name)).to(dtype))

    # the reference reads DRHO_DT only for the DOME inflow; its LINEAR EOS
    # is fixed at -0.2, the one value accepted elsewhere
    if pf.has("DRHO_DT") and "DRHO_DT" not in pf.logged_keys():
        drho_dt = pf.get("DRHO_DT", float, default=-0.2,
                         units="kg m-3 degC-1", module="MOM_EOS")
        if drho_dt != -0.2:
            raise NotImplementedError(f"DRHO_DT = {drho_dt!r} is not "
                                      "ported (only -0.2, the LINEAR EOS's)")

    # the tidal wave drag on the barotropic flow: a piston-velocity map
    # from the initial T and S (the reference reads these keys after
    # writing its parameter doc, so only where they are set)
    m = "MOM_wave_drag"
    if pf.has("TIDAL_WAVE_DRAG") and pf.get("TIDAL_WAVE_DRAG", bool,
                                            module=m) and use_thermo:
        piston = wave_drag_piston(
            state.h, state.T, state.S, G, gv, get_eos(eos_name),
            gamma=pf.get("WAVE_DRAG_SCALE", float, default=1.0, module=m),
            h2=pf.get("TIDAL_ROUGHNESS_H2", float, default=100.0,
                      units="m2", module=m))
        params = params.replace(dyn=params.dyn.replace(
            bt=params.dyn.bt.replace(lin_drag=piston)))

    # a run directory's MOM_input also holds the driver's own keys
    from mom6_tpu_torch.drivers.solo import driver_keys
    unknown = [k for k in pf.unused_params() if k not in driver_keys()]
    if unknown:
        raise ValueError("build_model_from_params does not know "
                         + ", ".join(unknown))
    if doc_dir:
        pf.write_doc(doc_dir)
    return ModelSetup(G, gv, state, params, forcing, pf,
                      forcing_provider=provider)
