"""Config-driven model construction: MOM_input -> runnable model
(twin of mom6_tpu/drivers/config_driver.py::build_model_from_params).

Ported: what the four configurations of the reference's golden tests
(``configs/double_gyre``, ``benchmark``, ``rho_basin`` and
``global_2deg``), ``configs/global_half_deg``, ``configs/tracer_batch``
and the analytic gates (``configs/external_gwave``, ``soliton`` and the
parameter texts of tests/test_analytic_parity.py) read, and the defaults
they leave in force: the Cartesian grid with flat or bowl topography,
the spherical and Mercator grids and the mosaic grid with file
topography and the northern fold, the seamount, dome2d, dumbbell,
Neverworld, Kelvin, shelfwave and DOME topographies, the layered
vertical grid, the split-RK2 dynamics with Laplacian or Smagorinsky
friction and the BT_cont transports (USE_BT_CONT_TYPE), the open
boundaries (OBC_NUMBER_OF_SEGMENTS: both segment syntaxes, their _DATA
strings with ``value:`` and ``file:`` data, the Kelvin, shelfwave and DOME
data of OBC_USER_CONFIG and the tracer reservoirs), the unsplit RK3 and
RK2 steppers (SPLIT = False), the adiabatic
(ENABLE_THERMODYNAMICS = False) and the thermo cycle, z* and RHO ALE,
the Wright or linear EOS, GM with a constant KHTH, MEKE, the mixed-layer
restratification, KHTR, the background diffusivity, KPP, ePBL
(ENERGETICS_SFC_PBL), CVMix shear mixing, the tracer packages (ideal
age, regional dyes, boundary impulse, pseudo-salt, OCMIP2 CFCs), the
``gyres``, ``global`` and ``constant`` wind, the idealized hurricane
(``ideal_hurr``, ``SCM_ideal_hurr``) and the wind and buoyancy fluxes
from a file (``file``), the ``NS_heating`` and ``const`` fluxes and SST
restoring, the resting initial state (THICKNESS_CONFIG = uniform) and
its ``internal_wave``, ``sloshing``, ``gwave``, ``soliton``, ``phillips``
and ``circle_obcs`` displacements, and the T_REF/T_RANGE profile, the
``front`` or the ``rossby_front`` of TS_CONFIG.  Time-dependent forcing
(the hurricane, the file records, the open boundaries' series) comes
with ``ModelSetup.forcing_provider``, model time [s] -> Forcing.  An OBC
scheme token the port does not know raises NotImplementedError (the
reference warns and drops it).  With ``doc_dir`` the parameters read
are written out as ``MOM_parameter_doc.all`` and ``.short`` there.

Every other switch that the reference's function reads is listed in
:data:`_INERT` with the only value the port accepts for it (the
reference's default); a file that sets it otherwise raises
``NotImplementedError`` naming the key (``ENERGETICS_SFC_PBL = True``,
say).  A key that this module does not know raises ``ValueError``.

Where the supergrid file of a mosaic is missing, the pair is generated
in memory (grid/tripolar.py) for the sizes of :data:`_GENERATED`, as
``configs/global_half_deg/make_inputs.py`` would write it; no file is
written.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from mom6_tpu_torch.ale.ale import LAYER, RHO, ZSTAR, ALEParams
from mom6_tpu_torch.core.barotropic import BTParams, set_dtbt
from mom6_tpu_torch.core.dynamics_split_rk2 import DynParams, MechForcing
from mom6_tpu_torch.core.dynamics_unsplit import UnsplitParams
from mom6_tpu_torch.core.mom import Forcing, MOMParams
from mom6_tpu_torch.core.open_boundary import (SCHEMES, OBCData, OBCSegment,
                                               build_obc, segment_slices)
from mom6_tpu_torch.core.state import OceanState, init_state_resting
from mom6_tpu_torch.drivers import user_cases
from mom6_tpu_torch.drivers.user_cases import (hurricane_wind_fn,
                                               neverworld_depth)
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
from mom6_tpu_torch.physics.lateral.meke import MEKEParams
from mom6_tpu_torch.physics.lateral.mixed_layer_restrat import \
    MLRestratParams
from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams)
from mom6_tpu_torch.physics.vertical.set_diffusivity import DiffusivityParams
from mom6_tpu_torch.framework.stencil import ip1, jp1
from mom6_tpu_torch.tracers import packages

__all__ = ["build_model_from_params", "ModelSetup"]

# switches the reference reads whose subsystem is not ported: the one
# value accepted (the reference's default, which leaves it off) and the
# module the reference logs it under (None: read only where it is set,
# as the reference reads it only where MEKE is on or after its doc)
_INERT = {
    "BOUSSINESQ": (True, "MOM_verticalGrid"),
    "SPLIT_RK2B": (False, "MOM"),
    "COORD_CONFIG": ("gprime", "MOM_coord_initialization"),
    "REENTRANT_Y": (False, "MOM_grid_init"),
    "BT_LIN_DRAG": (0.0, "MOM_barotropic"),
    "BT_CDRAG": (0.0, "MOM_barotropic"),
    "DYNAMIC_SURFACE_PRESSURE": (False, "MOM_barotropic"),
    "BT_WIDE_HALO": (0, "MOM_barotropic"),
    "USE_GL90_IN_SSW": (False, "MOM_vert_friction"),
    "LEITH_KH": (False, "MOM_hor_visc"),
    "USE_QG_LEITH_VISC": (False, "MOM_hor_visc"),
    "ANISOTROPIC_VISCOSITY": (False, "MOM_hor_visc"),
    "MEKE_VISCOSITY_COEFF_KU": (0.0, None),
    "MEKE_FRCOEFF": (0.0, None),
    "KHTR_PASSIVITY_COEFF": (0.0, "MOM_tracer_hor_diff"),
    "KHTR_PASSIVITY_MIN": (0.5, "MOM_tracer_hor_diff"),
    "KHTR_MAX": (0.0, "MOM_tracer_hor_diff"),
    "USE_NEUTRAL_DIFFUSION": (False, "MOM_tracer_hor_diff"),
    "NDIFF_SCHEME": ("redi", "MOM_neutral_diffusion"),
    "USE_HORIZONTAL_BOUNDARY_DIFFUSION": (False, "MOM_tracer_hor_diff"),
    "INT_TIDE_DISSIPATION": (False, "MOM_tidal_mixing"),
    "BULKMIXEDLAYER": (False, "MOM_bulk_mixed_layer"),
    "USE_JACKSON_PARAM": (False, "MOM_diabatic_driver"),
    "INTERNAL_TIDES": (False, "MOM_internal_tides"),
    "GEOTHERMAL_SCALE": (0.0, "MOM_geothermal"),
    "PEN_SW_NBANDS": (0, "MOM_opacity"),
    "USE_CVMIX_CONVECTION": (False, "MOM_diabatic_driver"),
    "DOUBLE_DIFFUSION": (False, "MOM_diabatic_driver"),
    "USE_CVMIX_DDIFF": (False, "MOM_diabatic_driver"),
    "FRAZIL": (False, "MOM_diabatic_driver"),
    "TFREEZE_FORM": ("LINEAR", "MOM_diabatic_driver"),
    "DO_BRINE_PLUME": (False, "MOM_diabatic_aux"),
    "BOTTOMDRAGLAW": (False, "MOM_set_viscosity"),
    "APPLY_INTERFACE_FILTER": (False, "MOM_interface_filter"),
    "POROUS_BARRIER": (False, "MOM_porous_barriers"),
    "USE_ZB2020": (False, "MOM_Zanna_Bolton"),
    "USE_STANLEY_PGF": (False, "MOM_stoch_eos"),
    "TIDES": (False, "MOM_tidal_forcing"),
    "SAL_SCALAR_VALUE": (0.0, "MOM_self_attr_load"),
    "SAL_HARMONICS": (False, "MOM_self_attr_load"),
    "DO_SPPT": (False, "MOM_stochastics"),
    "DO_SKEB": (False, "MOM_stochastics"),
    "USE_WAVES": (False, "MOM_wave_interface"),
    "USE_LA_LI2016": (False, "MOM_wave_interface"),
    "USE_GENERIC_TRACER": (False, "MOM_tracer_flow_control"),
    "USE_VARIABLE_MIXING": (False, "MOM_lateral_mixing_coeffs"),
    "DIABATIC_FIRST": (False, "MOM"),
    "HOMOGENIZE_FORCINGS": (False, "MOM"),
    "SPONGE": (False, "MOM_sponge"),
    "ICE_SHELF": (False, "MOM_ice_shelf"),
    "TIDAL_WAVE_DRAG": (False, None),
    "CONST_DYN_PSURF": (0.9, "MOM_barotropic"),
    "ICE_LENGTH_DYN_PSURF": (10000.0, "MOM_barotropic"),
}
# (NIGLOBAL, NJGLOBAL) -> arguments of grid/tripolar.py::make_mosaic for
# the mosaics that are generated and not committed
_GENERATED = {(720, 400): dict(nx=720, ny_reg=336, ny_cap=64)}


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
_SPLIT_ONLY = ("BT_LIN_DRAG", "BT_CDRAG",
               "DYNAMIC_SURFACE_PRESSURE", "CONST_DYN_PSURF",
               "ICE_LENGTH_DYN_PSURF", "BT_WIDE_HALO")


def _check_inert(pf: ParamFile) -> None:
    """Raise for a switch of :data:`_INERT` set otherwise; log the others
    with their defaults where the reference logs them."""
    split = pf.get("SPLIT", bool, default=True, module="MOM")
    for key, (only, module) in _INERT.items():
        if module is None or (key in _SPLIT_ONLY and not split):
            if not pf.has(key):
                continue
            value = pf.get(key, type(only))
        else:
            value = pf.get(key, type(only), default=only, module=module)
        if value != only:
            raise NotImplementedError(
                f"{key} = {value!r} is not ported (only {only!r})")


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


def _analytic_topography(pf, topo_config, nx, ny, lenlon, lenlat,
                         max_depth, min_depth, m) -> np.ndarray:
    """TOPO_CONFIG = seamount, dome2d, dumbbell, Kelvin, shelfwave, DOME
    or Neverworld (the reference's branches, config_driver.py:124-215, in
    its float64 numpy arithmetic)."""
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
    """The Cartesian, spherical or Mercator grid with flat, bowl or file
    topography, or the mosaic grid with file topography (the reference's
    _build_grid, those branches).  Returns (Grid, MAXIMUM_DEPTH)."""
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
                          ("flat", "bowl", "file", "seamount", "dome2d",
                           "dumbbell", "Kelvin", "shelfwave", "DOME",
                           "Neverworld"), m)
    cyclic_x = pf.get("REENTRANT_X", bool, default=False, module=m)

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


def build_model_from_params(pf: ParamFile, *, dtype=torch.float32,
                            device=DEFAULT_DEVICE,
                            input_dir: Optional[str] = None,
                            doc_dir: Optional[str] = None) -> ModelSetup:
    """The model that ``pf`` describes, on ``device`` (the card unless
    the caller asks for the CPU).  ``input_dir`` is where INPUTDIR-relative
    files are looked for (default: ``doc_dir``, else the directory of the
    parameter file); with ``doc_dir`` the parameter documentation is
    written there."""
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
        dtype=dtype, device=device)

    m = "MOM"
    dt = pf.get("DT", float, module=m, units="s")
    dt_therm = pf.get("DT_THERM", float, default=dt, units="s", module=m)
    n_dyn_per_thermo = max(1, int(round(dt_therm / dt)))
    split = pf.get("SPLIT", bool, default=True, module=m)
    use_thermo = pf.get("ENABLE_THERMODYNAMICS", bool, default=True,
                        module=m)
    eos_name = pf.get("EQN_OF_STATE", str, default="WRIGHT", module=m)

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
                                         default=False, module=m))
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
        dt=dt, bt=bt, scheme="RK2",
        be=pf.get("BE", float, default=0.6, module=m),
        kv=pf.get("KV", float, default=1e-4, units="m2 s-1", module=m),
        bottom_drag=pf.get("DRAG_BG_VEL", float, default=0.0, units="m s-1",
                           module=m) * cdrag,
        cdrag=cdrag,
        coriolis_scheme=pf.get("CORIOLIS_SCHEME", str,
                               default="SADOURNY75_ENERGY",
                               module="MOM_CoriolisAdv").upper())

    m = "MOM_hor_visc"
    hv = None
    kh = pf.get("KH", float, default=0.0, units="m2 s-1", module=m)
    ah = pf.get("AH", float, default=0.0, units="m4 s-1", module=m)
    smag_lap_c = pf.get("SMAG_LAP_CONST", float, default=0.15, module=m) \
        if pf.get("SMAGORINSKY_KH", bool, default=False, module=m) else 0.0
    smag_bi_c = pf.get("SMAG_BI_CONST", float, default=0.06, module=m) \
        if pf.get("SMAGORINSKY_AH", bool, default=False, module=m) else 0.0
    if kh or ah or smag_lap_c or smag_bi_c:
        hv = HorViscParams(kh=kh, ah=ah, smag_lap_const=smag_lap_c,
                           smag_bi_const=smag_bi_c, dt=dt)

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
            topo_beta=mk("MEKE_TOPOGRAPHIC_BETA", 0.0))

    m = "MOM_mixed_layer_restrat"
    mlr = None
    if pf.get("MIXEDLAYER_RESTRAT", bool, default=False, module=m):
        mlr = MLRestratParams(fox_kemper_coef=pf.get(
            "FOX_KEMPER_ML_RESTRAT_COEF", float, default=0.0625, module=m))

    m = "MOM_tracer_hor_diff"
    khtr = pf.get("KHTR", float, default=0.0, units="m2 s-1", module=m)
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

    m = "MOM_diabatic_driver"
    diab = DiabaticParams(
        diff=DiffusivityParams(
            kd=pf.get("KD", float, default=1e-5, units="m2 s-1", module=m),
            kd_min=pf.get("KD_MIN", float, default=0.0, module=m)),
        cp=pf.get("C_P", float, default=3991.87, units="J kg-1 K-1",
                  module=m),
        boundary_layer_scheme=(
            "KPP" if pf.get("USE_KPP", bool, default=False, module=m)
            else ("EPBL" if pf.get("ENERGETICS_SFC_PBL", bool,
                                   default=False, module=m) else "NONE")),
        use_shear_mixing=pf.get("USE_CVMIX_SHEAR", bool, default=False,
                                module=m))

    m = "MOM_ALE"
    ale = ALEParams(mode=LAYER)
    remap_scheme = pf.get("REMAPPING_SCHEME", str, default="PPM_H4",
                          module=m).upper()
    if pf.get("USE_REGRIDDING", bool, default=False, module=m):
        mode = pf.get("REGRIDDING_COORDINATE_MODE", str, default="Z*",
                      module=m).upper()
        if mode not in ("Z*", "ZSTAR", "RHO"):
            raise NotImplementedError(f"REGRIDDING_COORDINATE_MODE = "
                                      f"{mode!r} is not ported (only Z*, "
                                      "RHO)")
        dz = pf.get_list("ALE_RESOLUTION", default=[max_depth / nz] * nz,
                         module=m)
        if mode == "RHO":
            rlay = pf.get_list("ALE_RHO_TARGETS",
                               default=gv.Rlay.cpu().numpy().tolist(),
                               module=m)
            ale = ALEParams(mode=RHO, rho_targets=tuple(rlay),
                            eos_name=eos_name, scheme=remap_scheme)
        else:
            ale = ALEParams(mode=ZSTAR, dz_nominal=tuple(dz),
                            scheme=remap_scheme)

    obc, obc_ts = _open_boundaries(pf, G, gv, ale, nz, max_depth, dtype,
                                   device, input_dir)
    tfc = _tracer_packages(pf)

    params = MOMParams(
        dyn=dyn, thermo_enabled=use_thermo, eos_name=eos_name,
        diabatic=diab, ale=ale, hor_visc=hv, gm=gm, meke=meke,
        mlrestrat=mlr, khtr=khtr, khtr_n_sub=n_sub_tr,
        n_dyn_per_thermo=n_dyn_per_thermo, tfc=tfc, obc=obc,
        unsplit=unsplit,
        unsplit_scheme=unsplit_scheme,
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
                        ("uniform", "circle_obcs", "sloshing",
                         "internal_wave", "gwave", "soliton", "phillips"), m)
    state = init_state_resting(G, gv, np.full(nz, max_depth / nz),
                               dtype=dtype, with_thermo=use_thermo)
    if thick_cfg == "circle_obcs":
        state = state.replace(h=_circle_obcs(pf, G, state, nz, m))
    elif thick_cfg != "uniform":
        state = state.replace(**_displaced(pf, thick_cfg, G, gv, state,
                                           max_depth, dtype, device))
    if meke is not None:
        state = state.replace(E_meke=torch.zeros((G.ny, G.nx), dtype=dtype,
                                                 device=device))
    if use_thermo:
        ts_cfg = _one_of(pf, "TS_CONFIG", "fit",
                         ("fit", "front", "rossby_front"), m)
        t_ref = pf.get("T_REF", float, default=10.0, units="degC", module=m)
        s_ref = pf.get("S_REF", float, default=35.0, units="ppt", module=m)
        shape = tuple(state.h.shape)
        if ts_cfg == "front":
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
        state = state.replace(
            T=T, S=torch.full(shape, s_ref, dtype=dtype, device=device))
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
                   ("zero", "NS_heating", "const", "global", "file"), m)
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

    if tfc is not None:
        state = state.replace(tr=tfc.init_tracers(tuple(state.h.shape), dtype,
                                                  device))
    if obc is not None and obc.res_len_in > 0.0 and use_thermo:
        # the segments' tracer reservoirs start from the initial state
        state = state.replace(obc_res_T=state.T.clone(),
                              obc_res_S=state.S.clone())

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
