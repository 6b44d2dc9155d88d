"""The diagnostic field catalog: the OM4-standard field set
(twin of mom6_tpu/diagnostics/catalog.py: CatalogEntry, DiagContext,
CATALOG, rejection_reason, resolve and serve).

One table maps every field name a diag_table may request, the native
names and their CMOR aliases (thetao, so, volcello, zos, umo, ...), to a
rule that computes it from the model state, with its units, long name,
staggering and what it needs of the configuration.  A
:class:`DiagContext` caches the intermediates several fields share (the
surface state, in-situ density, the interface diffusivities, the wave
speed, the KE budget, the tendencies), so a post computes each once.
Unknown names raise with a near-miss hint (``resolve``); names that are
known but not servable under the configuration are rejected with the
reason (``rejection_reason``).  Every field is computed on the state's
device and stays there until the diag mediator copies it.

Divergences from the reference, each a repair of a fault it has on a
tripolar fold or in a sign:

* ``wo`` and ``wmo`` are positive upward (the reference negates the
  sign twice and so serves the downward velocity);
* the v faces south of row 0 are the southern wall, not the fold row
  the wrap reads (``wo``, ``ustar``, and the KE, KE budget and column
  speed of diagnostics/diagnostics.py): the two agree wherever row 0 is
  land, as on every global grid of the repo;
* ``PV`` averages h to the top row's corners across the fold (the
  reference wraps to row 0 there).
"""

from __future__ import annotations

import difflib
from typing import Callable, Dict, NamedTuple, Optional

import torch

from mom6_tpu_torch.core.coriolis_adv import relative_vorticity
from mom6_tpu_torch.diagnostics import diagnostics as dg
from mom6_tpu_torch.diagnostics.mld import diagnose_mld
from mom6_tpu_torch.diagnostics.wave_speed import _n2_dz, wave_speed
from mom6_tpu_torch.framework.arith import csqrt, sdiv, vcumsum, vsum
from mom6_tpu_torch.framework.stencil import im1, ip1, jm1, jp1
from mom6_tpu_torch.physics.lateral import meke

__all__ = ["CatalogEntry", "DiagContext", "CATALOG", "resolve", "serve",
           "rejection_reason"]


class CatalogEntry(NamedTuple):
    fn: Callable        # ctx -> tensor, or None when not servable now
    units: str
    long_name: str
    stagger: str = "h"          # h | u | v | q | i (h with interfaces)
    needs: str = ""             # what rejection_reason checks


class DiagContext:
    """The lazy per-post cache of the intermediates fields share.
    ``ke_budget_fn(state, forcing)`` returns the KE budget's terms and
    ``tend_fn(state, forcing)`` the tendencies of one thermo cycle from
    the posted state (drivers/solo.py makes both)."""

    def __init__(self, state, G, GV, params, forcing=None, eos=None,
                 ke_budget_fn=None, tend_fn=None):
        self.state = state
        self.G = G
        self.GV = GV
        self.params = params
        self.forcing = forcing
        self.eos = eos
        self.ke_budget_fn = ke_budget_fn
        self.tend_fn = tend_fn
        self._cache: Dict[str, object] = {}

    def _get(self, key, compute):
        if key not in self._cache:
            self._cache[key] = compute()
        return self._cache[key]

    @property
    def sfc(self):
        return self._get("sfc", lambda: dg.extract_surface_state(
            self.state, self.G, self.GV, eos=self.eos))

    @property
    def p_int(self):
        """Hydrostatic interface pressures [Pa], rho0 g z."""
        def build():
            dp = self.GV.g_earth * self.GV.rho0 * self.state.h
            return torch.cat([torch.zeros_like(dp[:1]), vcumsum(dp)], 0)
        return self._get("p_int", build)

    @property
    def rho_insitu(self):
        def build():
            p_mid = 0.5 * (self.p_int[:-1] + self.p_int[1:])
            return self.GV.rho0 + self.eos.density(
                self.state.T, self.state.S, p_mid, rho_ref=self.GV.rho0)
        return self._get("rho_insitu", build)

    @property
    def e_int(self):
        """Interface heights [m], 0 at the rest surface, positive up."""
        def build():
            h = self.state.h
            csum = torch.flip(vcumsum(torch.flip(h, (0,))), (0,))
            return torch.cat([csum, torch.zeros_like(h[:1])], 0) \
                - self.G.bathyT[None]
        return self._get("e_int", build)

    @property
    def kd_int(self):
        """The total interface diffusivity [m2 s-1] (set_diffusivity's
        Kd_interface): the background, the BBL and the tidal mixing, and
        the boundary-layer, shear and lowmode internal-tide extras; the
        per-mechanism pieces land in the cache for the Kd_* fields."""
        def build():
            from mom6_tpu_torch.core.mom import assemble_diffusivity_extras
            from mom6_tpu_torch.physics.vertical.set_diffusivity import \
                set_diffusivity
            p, st = self.params, self.state
            comp: Dict[str, object] = {}
            kd_extra, bl_mld, _, _ = assemble_diffusivity_extras(
                st, self.forcing, self.G, self.GV, p, self.eos,
                p.dyn.dt * p.n_dyn_per_thermo, components=comp)
            self._cache["bl_mld"] = bl_mld
            out = set_diffusivity(st.h, self.G, self.GV, p.diabatic.diff,
                                  kd_extra=kd_extra, T=st.T, S=st.S,
                                  eos=self.eos, u=st.u, v=st.v,
                                  components=comp)
            self._cache["kd_comp"] = comp
            return out
        return self._get("kd_int", build)

    def kd_component(self, name):
        """One mechanism's diffusivity (Kd_bkgnd, Kd_BL, Kd_shear, ...),
        or None when it is not configured."""
        if "kd_comp" not in self._cache:
            _ = self.kd_int
        return self._cache["kd_comp"].get(name)

    @property
    def tend(self):
        """The per-layer content tendencies of one thermo cycle from the
        posted state."""
        def build():
            if self.tend_fn is None or self.forcing is None:
                return {}
            return self.tend_fn(self.state, self.forcing)
        return self._get("tend", build)

    @property
    def gm_fluxes(self):
        """(uhd, vhd), the GM bolus transports [m3 s-1] of the state with
        the configured KHTH."""
        def build():
            from mom6_tpu_torch.physics.lateral.thickness_diffuse import \
                thickness_diffuse
            p = self.params
            _, uhd, vhd = thickness_diffuse(
                self.state.h, self.G, self.GV,
                p.dyn.dt * p.n_dyn_per_thermo, p.gm, T=self.state.T,
                S=self.state.S, eos=self.eos)
            return uhd, vhd
        return self._get("gm_fluxes", build)

    @property
    def bl_mld(self):
        if "bl_mld" not in self._cache:
            _ = self.kd_int
        return self._cache.get("bl_mld")

    @property
    def cg1(self):
        return self._get("cg1", lambda: wave_speed(
            self.state.h, self.state.T, self.state.S, self.G, self.GV,
            self.eos))

    @property
    def ke_terms(self):
        def build():
            if self.ke_budget_fn is None or self.forcing is None:
                return {}
            return self.ke_budget_fn(self.state, self.forcing)
        return self._get("ke_terms", build)

    def mld(self, drho_crit: float):
        return self._get(f"mld{drho_crit}", lambda: diagnose_mld(
            self.state.h, self.state.T, self.state.S, self.G, self.GV,
            self.eos, drho_crit=drho_crit))


# ---------------------------------------------------------------------------
# the entries' rules

def _state(name):
    return lambda c: getattr(c.state, name, None)


def _buoy(name):
    def f(c):
        b = getattr(c.forcing, "buoy", None) if c.forcing else None
        return None if b is None else getattr(b, name, None)
    return f


def _mech(name):
    def f(c):
        m = getattr(c.forcing, "mech", None) if c.forcing else None
        return None if m is None else getattr(m, name, None)
    return f


def _cp(c):
    return c.params.diabatic.cp if c.params.thermo_enabled else 3991.87


def _hfds(c):
    """The net downward heat flux the ocean feels [W m-2]: the fixed and
    the shortwave fluxes and the restoring against the current SST."""
    b = getattr(c.forcing, "buoy", None) if c.forcing else None
    if b is None or (b.heat_flux is None and b.sw_flux is None
                     and b.t_restore is None):
        return None
    q = 0.0
    if b.heat_flux is not None:
        q = q + b.heat_flux
    if b.sw_flux is not None:
        q = q + b.sw_flux
    if b.t_restore is not None and b.restore_rate:
        q = q + c.GV.rho0 * _cp(c) * b.restore_rate \
            * (b.t_restore - c.state.T[0])
    return q * c.G.mask2dT


def _rho_scaled(field_fn):
    def f(c):
        a = field_fn(c)
        return None if a is None else c.GV.rho0 * a
    return f


def _n2(c):
    n2, _ = _n2_dz(c.state.h, c.state.T, c.state.S, c.GV, c.eos)
    z = torch.zeros_like(n2[:1])
    return torch.cat([z, n2, z], 0) * c.G.mask2dT[None]


def _rd1(c):
    """The first-mode deformation radius [m] with the equatorial
    transition, cg1 / sqrt(f^2 + 2 beta cg1) (MOM_lateral_mixing_coeffs)."""
    f_q = c.G.CoriolisBu
    f_h = 0.25 * torch.abs(
        f_q + im1(f_q) + jm1(f_q)
        + jm1(im1(f_q)))
    beta = getattr(c.G, "beta", None)
    if beta is None:
        beta = 2.3e-11          # a generic midlatitude value
    return c.cg1 / csqrt(f_h ** 2 + 2.0 * beta * c.cg1 + 1e-24)


def _pv(c):
    h = c.state.h
    kh = "h" if getattr(c.G, "fold_north", False) else None
    h_n = jp1(h, kh)
    h_q = 0.25 * (h + ip1(h) + h_n + ip1(h_n))
    rv = relative_vorticity(c.state.u, c.state.v, c.G)
    return (c.G.CoriolisBu + rv) / torch.clamp(h_q, min=1e-3)


def _ke_term(key):
    return lambda c: c.ke_terms.get(key)


def _mint(field, scale_fn):
    """Depth-integrated content [X m-2]."""
    def f(c):
        arr = getattr(c.state, field, None)
        if arr is None:
            return None
        return scale_fn(c) * vsum(arr * c.state.h) * c.G.mask2dT
    return f


CATALOG: Dict[str, CatalogEntry] = {
    # ---- prognostic state -------------------------------------------------
    "h": CatalogEntry(_state("h"), "m", "Layer thickness"),
    "u": CatalogEntry(_state("u"), "m s-1", "Zonal velocity", "u"),
    "v": CatalogEntry(_state("v"), "m s-1", "Meridional velocity", "v"),
    "T": CatalogEntry(_state("T"), "degC", "Potential temperature",
                      needs="thermo"),
    "S": CatalogEntry(_state("S"), "psu", "Salinity", needs="thermo"),
    "e": CatalogEntry(lambda c: c.e_int, "m", "Interface heights", "i"),
    "uh": CatalogEntry(_state("uh"), "m3 s-1", "Zonal volume transport",
                       "u", needs="transport"),
    "vh": CatalogEntry(_state("vh"), "m3 s-1",
                       "Meridional volume transport", "v",
                       needs="transport"),
    "uhtr": CatalogEntry(_state("uhtr"), "m3",
                         "Accumulated zonal transport", "u",
                         needs="transport"),
    "vhtr": CatalogEntry(_state("vhtr"), "m3",
                         "Accumulated meridional transport", "v",
                         needs="transport"),
    # ---- CMOR aliases (OM4 diag_table names) ------------------------------
    "thetao": CatalogEntry(_state("T"), "degC",
                           "Sea water potential temperature",
                           needs="thermo"),
    "so": CatalogEntry(_state("S"), "psu", "Sea water salinity",
                       needs="thermo"),
    "uo": CatalogEntry(_state("u"), "m s-1", "Sea water x velocity", "u"),
    "vo": CatalogEntry(_state("v"), "m s-1", "Sea water y velocity", "v"),
    "thkcello": CatalogEntry(_state("h"), "m", "Cell thickness"),
    "volcello": CatalogEntry(
        lambda c: c.state.h * c.G.areaT[None] * c.G.mask2dT[None],
        "m3", "Ocean grid-cell volume"),
    "masscello": CatalogEntry(
        _rho_scaled(_state("h")), "kg m-2",
        "Mass per area of grid cell (rho0 h; exact mass in "
        "non-Boussinesq mode)"),
    "zos": CatalogEntry(lambda c: c.sfc.ssh, "m",
                        "Sea surface height above geoid"),
    "tos": CatalogEntry(lambda c: c.sfc.sst, "degC",
                        "Sea surface temperature", needs="thermo"),
    "sos": CatalogEntry(lambda c: c.sfc.sss, "psu",
                        "Sea surface salinity", needs="thermo"),
    "umo": CatalogEntry(_rho_scaled(_state("uh")), "kg s-1",
                        "Ocean mass x transport", "u", needs="transport"),
    "vmo": CatalogEntry(_rho_scaled(_state("vh")), "kg s-1",
                        "Ocean mass y transport", "v", needs="transport"),
    "tauuo": CatalogEntry(_mech("taux"), "Pa",
                          "Surface downward x stress", "u",
                          needs="wind"),
    "tauvo": CatalogEntry(_mech("tauy"), "Pa",
                          "Surface downward y stress", "v",
                          needs="wind"),
    "opottempmint": CatalogEntry(
        _mint("T", lambda c: c.GV.rho0 * c.params.diabatic.cp
              if c.params.thermo_enabled else None),
        "J m-2", "Depth-integrated heat content", needs="thermo"),
    "somint": CatalogEntry(
        _mint("S", lambda c: 1e-3 * c.GV.rho0), "kg m-2",
        "Depth-integrated salt content", needs="thermo"),
    # ---- surface state -----------------------------------------------------
    "SSH": CatalogEntry(lambda c: c.sfc.ssh, "m", "Sea surface height"),
    "SST": CatalogEntry(lambda c: c.sfc.sst, "degC",
                        "Sea surface temperature", needs="thermo"),
    "SSS": CatalogEntry(lambda c: c.sfc.sss, "psu",
                        "Sea surface salinity", needs="thermo"),
    "SSU": CatalogEntry(lambda c: c.state.u[0], "m s-1",
                        "Surface zonal velocity", "u"),
    "SSV": CatalogEntry(lambda c: c.state.v[0], "m s-1",
                        "Surface meridional velocity", "v"),
    "speed": CatalogEntry(lambda c: c.sfc.speed, "m s-1",
                          "Surface speed"),
    "col_speed": CatalogEntry(lambda c: dg.column_speed(c.state, c.G),
                              "m s-1", "Depth-mean speed"),
    "tob": CatalogEntry(lambda c: c.state.T[-1] * c.G.mask2dT
                        if c.state.T is not None else None,
                        "degC", "Sea water potential temperature at sea "
                        "floor", needs="thermo"),
    "sob": CatalogEntry(lambda c: c.state.S[-1] * c.G.mask2dT
                        if c.state.S is not None else None,
                        "psu", "Sea water salinity at sea floor",
                        needs="thermo"),
    # ---- barotropic transports --------------------------------------------
    "uhbt": CatalogEntry(
        lambda c: None if c.state.uh is None else vsum(c.state.uh),
        "m3 s-1", "Barotropic zonal transport", "u", needs="transport"),
    "vhbt": CatalogEntry(
        lambda c: None if c.state.vh is None else vsum(c.state.vh),
        "m3 s-1", "Barotropic meridional transport", "v",
        needs="transport"),
    # ---- density / stratification ------------------------------------------
    "rhopot0": CatalogEntry(
        lambda c: c.GV.rho0 + c.eos.density(
            c.state.T, c.state.S, torch.zeros_like(c.state.T),
            rho_ref=c.GV.rho0),
        "kg m-3", "Potential density referenced to surface",
        needs="thermo"),
    "rhopot2": CatalogEntry(
        lambda c: c.GV.rho0 + c.eos.density(
            c.state.T, c.state.S, torch.full_like(c.state.T, 2.0e7),
            rho_ref=c.GV.rho0),
        "kg m-3", "Potential density referenced to 2000 dbar",
        needs="thermo"),
    "rhoinsitu": CatalogEntry(lambda c: c.rho_insitu, "kg m-3",
                              "In-situ density", needs="thermo"),
    "N2_int": CatalogEntry(_n2, "s-2",
                           "Buoyancy frequency squared at interfaces",
                           "i", needs="thermo"),
    "p_int": CatalogEntry(lambda c: c.p_int, "Pa",
                          "Hydrostatic interface pressure", "i"),
    # ---- mixing / physics maps ----------------------------------------------
    "Kd_interface": CatalogEntry(lambda c: c.kd_int, "m2 s-1",
                                 "Total diapycnal diffusivity at "
                                 "interfaces", "i", needs="thermo"),
    "MLD_003": CatalogEntry(lambda c: c.mld(0.03), "m",
                            "Mixed layer depth (delta rho = 0.03)",
                            needs="thermo"),
    "MLD_0125": CatalogEntry(lambda c: c.mld(0.125), "m",
                             "Mixed layer depth (delta rho = 0.125)",
                             needs="thermo"),
    "h_ML": CatalogEntry(lambda c: c.bl_mld, "m",
                         "Boundary-layer scheme mixed layer depth",
                         needs="bl_scheme"),
    "MEKE": CatalogEntry(_state("E_meke"), "m2 s-2",
                         "Mesoscale eddy kinetic energy", needs="meke"),
    "cg1": CatalogEntry(lambda c: c.cg1, "m s-1",
                        "First-mode internal gravity wave speed",
                        needs="thermo"),
    "Rd1": CatalogEntry(_rd1, "m",
                        "First-mode deformation radius", needs="thermo"),
    # ---- surface fluxes -----------------------------------------------------
    "taux": CatalogEntry(_mech("taux"), "Pa", "Zonal wind stress", "u",
                         needs="wind"),
    "tauy": CatalogEntry(_mech("tauy"), "Pa", "Meridional wind stress",
                         "v", needs="wind"),
    "p_surf": CatalogEntry(_mech("p_surf"), "Pa", "Surface pressure",
                           needs="psurf"),
    "hfds": CatalogEntry(_hfds, "W m-2",
                         "Downward heat flux at sea water surface",
                         needs="heatf"),
    "rsntds": CatalogEntry(_buoy("sw_flux"), "W m-2",
                           "Net downward shortwave at sea water surface",
                           needs="sw"),
    "wfo": CatalogEntry(
        lambda c: None if _buoy("fw_flux")(c) is None
        else c.GV.rho0 * _buoy("fw_flux")(c),
        "kg m-2 s-1", "Water flux into sea water", needs="fw"),
    "sfdsi": CatalogEntry(
        lambda c: None if _buoy("salt_flux")(c) is None
        else 1e-3 * c.GV.rho0 * _buoy("salt_flux")(c),
        "kg m-2 s-1", "Downward sea ice basal salt flux",
        needs="saltf"),
    "frazil": CatalogEntry(_state("frazil"), "J m-2",
                           "Accumulated frazil heat deficit",
                           needs="frazil"),
    # ---- vorticity / energy -------------------------------------------------
    "RV": CatalogEntry(lambda c: relative_vorticity(c.state.u, c.state.v,
                                                    c.G),
                       "s-1", "Relative vorticity", "q"),
    "PV": CatalogEntry(_pv, "m-1 s-1", "Potential vorticity", "q"),
    "KE": CatalogEntry(lambda c: dg.kinetic_energy_3d(c.state, c.G),
                       "m2 s-2", "Kinetic energy per unit mass"),
    "KE_CorAdv": CatalogEntry(_ke_term("KE_CorAdv"), "m3 s-3",
                              "KE source from Coriolis+advection",
                              needs="ke_budget"),
    "KE_PG": CatalogEntry(_ke_term("KE_PG"), "m3 s-3",
                          "KE source from pressure gradient",
                          needs="ke_budget"),
    "KE_horvisc": CatalogEntry(_ke_term("KE_horvisc"), "m3 s-3",
                               "KE sink from horizontal viscosity",
                               needs="ke_budget"),
    "KE_visc": CatalogEntry(_ke_term("KE_visc"), "m3 s-3",
                            "KE sink from vertical viscosity",
                            needs="ke_budget"),
    "KE_BT": CatalogEntry(_ke_term("KE_BT"), "m3 s-3",
                          "KE source from barotropic correction",
                          needs="ke_budget"),
    "dKE_dt": CatalogEntry(_ke_term("dKE_dt"), "m3 s-3",
                           "KE tendency", needs="ke_budget"),
    "KE_residual": CatalogEntry(_ke_term("KE_residual"), "m3 s-3",
                                "KE budget residual", needs="ke_budget"),
}


# ---------------------------------------------------------------------------
# tendencies, per-mechanism diffusivities, GM and MEKE energetics,
# transports and CMOR extensions

def _heat_scale(c):
    return c.GV.rho0 * _cp(c)


def _salt_scale(c):
    return 1e-3 * c.GV.rho0


def _tend(key, scale=None, vertical_sum=False):
    """A tendency of the capture [conc m s-1], scaled to W m-2 (``scale``
    "heat") or kg m-2 s-1 ("salt"), summed over the layers for the _2d
    fields."""
    def f(c):
        arr = c.tend.get(key)
        if arr is None:
            return None
        if scale == "heat":
            arr = _heat_scale(c) * arr
        elif scale == "salt":
            arr = _salt_scale(c) * arr
        return vsum(arr) if vertical_sum else arr
    return f


def _kd_comp(key):
    return lambda c: c.kd_component(key)


def _gm_work(c):
    """The depth-integrated PE release by the GM transports [W m-2]
    (MOM_thickness_diffuse.F90's GMwork)."""
    uhd, vhd = c.gm_fluxes
    col = torch.clamp(vsum(c.state.h), min=1.0)
    rate = meke.gm_pe_release(c.state.h, uhd, vhd, c.G, c.GV)
    return c.GV.rho0 * rate * col * c.G.mask2dT


def _meke_src_gm(c):
    uhd, vhd = c.gm_fluxes
    return meke.gm_pe_release(c.state.h, uhd, vhd, c.G, c.GV) * c.G.mask2dT


def _meke_kh(c):
    return meke.meke_diffusivity(c.state.E_meke, c.state.h, c.G,
                                 c.params.meke) * c.G.mask2dT


def _meke_ku(c):
    out = meke.meke_viscosity(c.state.E_meke, c.state.h, c.G,
                              c.params.meke)
    return None if out is None else out * c.G.mask2dT


def _meke_decay(c):
    """MEKE's linear and bottom-drag damping rate [s-1] (the implicit
    rate of step_meke)."""
    p = c.params.meke
    h, G, e = c.state.h, c.G, c.state.E_meke
    depth = torch.clamp(vsum(h), min=1e-3)
    bottom2, _, _ = meke.meke_length_scales(e, h, G, p)
    drag_rate = csqrt(p.cdrag ** 2 * (
        2.0 * bottom2 * torch.clamp(e, min=0.0) + p.uscale ** 2)) / depth
    return (p.damping + drag_rate * bottom2) * G.mask2dT


def _ustar(c):
    m = c.forcing.mech if c.forcing is not None else None
    if m is None or m.taux is None:
        return None
    tx = 0.5 * (m.taux + im1(m.taux))
    ty = 0.5 * (m.tauy + dg.v_south(m.tauy, c.G)) \
        if m.tauy is not None else 0.0
    return csqrt(sdiv(csqrt(tx * tx + ty * ty), c.GV.rho0)) \
        * c.G.mask2dT


def _wo(c):
    """The upward velocity through the interfaces [m s-1] from the
    divergence of the horizontal transports, 0 at the bottom (the
    advective part of the reference's wo; its dh/dt part needs two
    states)."""
    if c.state.uh is None:
        return None
    uh, vh = c.state.uh, c.state.vh
    div = (uh - im1(uh) + vh - dg.v_south(vh, c.G)) * c.G.IareaT
    div_below = torch.flip(vcumsum(torch.flip(div, (0,))), (0,))
    return torch.cat([-div_below, torch.zeros_like(div[:1])], 0) \
        * c.G.mask2dT[None]


def _wmo(c):
    w = _wo(c)
    return None if w is None else c.GV.rho0 * c.G.areaT[None] * w


def _t_ad(component, field, scale):
    """Advective content transport, e.g. T_adx = uh * T_face [degC m3
    s-1], scaled (register_tracer_diagnostics' T_adx, T_ady, S_adx,
    S_ady)."""
    def f(c):
        tr = getattr(c.state, field, None)
        flux = getattr(c.state, "uh" if component == "x" else "vh", None)
        if tr is None or flux is None:
            return None
        if component == "x":
            t_face = 0.5 * (tr + ip1(tr))
        else:
            kh = "h" if getattr(c.G, "fold_north", False) else None
            t_face = 0.5 * (tr + jp1(tr, kh))
        return scale(c) * flux * t_face
    return f


def _sumz(fn):
    def f(c):
        arr = fn(c)
        return None if arr is None else vsum(arr)
    return f


_HEAT = "W m-2"
_SALT = "kg m-2 s-1"

CATALOG.update({
    # ---- the tendency tier (register_tracer_diagnostics,
    # MOM_tracer_registry.F90:283-651): one thermo cycle from the posted
    # state ---------------------------------------------------------------
    "opottemptend": CatalogEntry(
        _tend("opottemptend", "heat"), _HEAT,
        "Tendency of heat content: total over the thermo cycle",
        needs="tend"),
    "osalttend": CatalogEntry(
        _tend("osalttend", "salt"), _SALT,
        "Tendency of salt content: total over the thermo cycle",
        needs="tend"),
    "T_advection_xy": CatalogEntry(
        _tend("T_advection_xy"), "degC m s-1",
        "Horizontal convergence of residual-mean heat advection "
        "(incl. parameterized bolus transports)", needs="tend"),
    "S_advection_xy": CatalogEntry(
        _tend("S_advection_xy"), "ppt m s-1",
        "Horizontal convergence of residual-mean salt advection",
        needs="tend"),
    "opottempdiff": CatalogEntry(
        _tend("opottempdiff", "heat"), _HEAT,
        "Heat-content tendency from dianeutral mixing "
        "(incl. KPP nonlocal)", needs="tend"),
    "osaltdiff": CatalogEntry(
        _tend("osaltdiff", "salt"), _SALT,
        "Salt-content tendency from dianeutral mixing", needs="tend"),
    "opottemppmdiff": CatalogEntry(
        _tend("opottemppmdiff", "heat"), _HEAT,
        "Heat-content tendency from parameterized epineutral mixing",
        needs="tend"),
    "osaltpmdiff": CatalogEntry(
        _tend("osaltpmdiff", "salt"), _SALT,
        "Salt-content tendency from parameterized epineutral mixing",
        needs="tend"),
    "boundary_forcing_heat_tendency": CatalogEntry(
        _tend("boundary_forcing_heat_tendency", "heat"),
        _HEAT, "Heat-content tendency from boundary forcing "
        "(surface fluxes, penetrating SW, geothermal)", needs="tend"),
    "boundary_forcing_salt_tendency": CatalogEntry(
        _tend("boundary_forcing_salt_tendency", "salt"),
        _SALT, "Salt-content tendency from boundary forcing "
        "(salt/virtual-salt fluxes, brine plume)", needs="tend"),
    "frazil_heat_tendency": CatalogEntry(
        _tend("frazil_heat_tendency", "heat"), _HEAT,
        "Heat-content tendency from frazil formation", needs="tend_frazil"),
    "Th_tendency_vert_remap": CatalogEntry(
        _tend("Th_tendency_vert_remap", "heat"), _HEAT,
        "Heat-content tendency from vertical (ALE) remapping",
        needs="tend"),
    "Sh_tendency_vert_remap": CatalogEntry(
        _tend("Sh_tendency_vert_remap", "salt"), _SALT,
        "Salt-content tendency from vertical (ALE) remapping",
        needs="tend"),
    # the vertical sums
    "opottemptend_2d": CatalogEntry(
        _tend("opottemptend", "heat", True), _HEAT,
        "Depth-integrated total heat-content tendency", needs="tend"),
    "osalttend_2d": CatalogEntry(
        _tend("osalttend", "salt", True), _SALT,
        "Depth-integrated total salt-content tendency", needs="tend"),
    "T_advection_xy_2d": CatalogEntry(
        _tend("T_advection_xy", "heat", True), _HEAT,
        "Depth-integrated advective heat-content tendency",
        needs="tend"),
    "S_advection_xy_2d": CatalogEntry(
        _tend("S_advection_xy", "salt", True), _SALT,
        "Depth-integrated advective salt-content tendency",
        needs="tend"),
    "opottempdiff_2d": CatalogEntry(
        _tend("opottempdiff", "heat", True), _HEAT,
        "Depth-integrated dianeutral heat-content tendency",
        needs="tend"),
    "osaltdiff_2d": CatalogEntry(
        _tend("osaltdiff", "salt", True), _SALT,
        "Depth-integrated dianeutral salt-content tendency",
        needs="tend"),
    "opottemppmdiff_2d": CatalogEntry(
        _tend("opottemppmdiff", "heat", True), _HEAT,
        "Depth-integrated epineutral heat-content tendency",
        needs="tend"),
    "osaltpmdiff_2d": CatalogEntry(
        _tend("osaltpmdiff", "salt", True), _SALT,
        "Depth-integrated epineutral salt-content tendency",
        needs="tend"),
    "boundary_forcing_heat_tendency_2d": CatalogEntry(
        _tend("boundary_forcing_heat_tendency", "heat", True), _HEAT,
        "Depth-integrated boundary-forcing heat tendency", needs="tend"),
    "boundary_forcing_salt_tendency_2d": CatalogEntry(
        _tend("boundary_forcing_salt_tendency", "salt", True), _SALT,
        "Depth-integrated boundary-forcing salt tendency", needs="tend"),
    "frazil_heat_tendency_2d": CatalogEntry(
        _tend("frazil_heat_tendency", "heat", True), _HEAT,
        "Depth-integrated frazil heat tendency", needs="tend_frazil"),
    # ---- per-mechanism diffusivities (MOM_set_diffusivity's register
    # section), from the same code that feeds the column solve -------------
    "Kd_bkgnd": CatalogEntry(_kd_comp("Kd_bkgnd"), "m2 s-1",
                             "Background diapycnal diffusivity", "i",
                             needs="thermo"),
    "Kd_BL": CatalogEntry(_kd_comp("Kd_BL"), "m2 s-1",
                          "Boundary-layer-scheme diffusivity (KPP/ePBL)",
                          "i", needs="bl_scheme"),
    "Kd_shear": CatalogEntry(_kd_comp("Kd_shear"), "m2 s-1",
                             "Shear-driven diffusivity (JHL/LMD94)", "i",
                             needs="kd_shear"),
    "Kd_BBL": CatalogEntry(_kd_comp("Kd_BBL"), "m2 s-1",
                           "Bottom-drag law-of-the-wall diffusivity",
                           "i", needs="kd_bbl"),
    "Kd_itides": CatalogEntry(_kd_comp("Kd_itides"), "m2 s-1",
                              "Internal-tide dissipation diffusivity",
                              "i", needs="kd_itides"),
    "Kd_lowmode": CatalogEntry(_kd_comp("Kd_lowmode"), "m2 s-1",
                               "Propagated low-mode internal-tide "
                               "diffusivity", "i", needs="kd_lowmode"),
    # CMOR aliases of the total
    "difvho": CatalogEntry(lambda c: c.kd_int, "m2 s-1",
                           "Ocean vertical heat diffusivity", "i",
                           needs="thermo"),
    "difvso": CatalogEntry(lambda c: c.kd_int, "m2 s-1",
                           "Ocean vertical salt diffusivity", "i",
                           needs="thermo"),
    # ---- GM and MEKE energetics -------------------------------------------
    "GMwork": CatalogEntry(_gm_work, "W m-2",
                           "Depth-integrated PE release by the GM "
                           "parameterization", needs="gm"),
    "MEKE_src_GM": CatalogEntry(_meke_src_gm, "m2 s-3",
                                "MEKE source from GM PE release",
                                needs="gm_meke"),
    "MEKE_Kh": CatalogEntry(_meke_kh, "m2 s-1",
                            "MEKE-derived eddy diffusivity",
                            needs="meke"),
    "MEKE_Ku": CatalogEntry(_meke_ku, "m2 s-1",
                            "MEKE backscatter (anti-)viscosity",
                            needs="meke"),
    "MEKE_decay": CatalogEntry(_meke_decay, "s-1",
                               "MEKE linear + bottom-drag damping rate",
                               needs="meke"),
    # ---- transports and surface extras ------------------------------------
    "ustar": CatalogEntry(_ustar, "m s-1",
                          "Surface friction velocity", needs="wind"),
    "wo": CatalogEntry(_wo, "m s-1",
                       "Upward interface velocity (advective part, from "
                       "transport divergence)", "i", needs="transport"),
    "wmo": CatalogEntry(_wmo, "kg s-1",
                        "Upward ocean mass transport (advective part)", "i",
                        needs="transport"),
    "T_adx": CatalogEntry(_t_ad("x", "T", _heat_scale), "W",
                          "Advective zonal heat transport", "u",
                          needs="transport_thermo"),
    "T_ady": CatalogEntry(_t_ad("y", "T", _heat_scale), "W",
                          "Advective meridional heat transport", "v",
                          needs="transport_thermo"),
    "S_adx": CatalogEntry(_t_ad("x", "S", _salt_scale), "kg s-1",
                          "Advective zonal salt transport", "u",
                          needs="transport_thermo"),
    "S_ady": CatalogEntry(_t_ad("y", "S", _salt_scale), "kg s-1",
                          "Advective meridional salt transport", "v",
                          needs="transport_thermo"),
    "T_adx_2d": CatalogEntry(_sumz(_t_ad("x", "T", _heat_scale)), "W",
                             "Depth-integrated zonal heat transport",
                             "u", needs="transport_thermo"),
    "T_ady_2d": CatalogEntry(_sumz(_t_ad("y", "T", _heat_scale)), "W",
                             "Depth-integrated meridional heat "
                             "transport", "v", needs="transport_thermo"),
    "umo_2d": CatalogEntry(
        lambda c: None if c.state.uh is None
        else c.GV.rho0 * vsum(c.state.uh),
        "kg s-1", "Depth-integrated ocean mass x transport", "u",
        needs="transport"),
    "vmo_2d": CatalogEntry(
        lambda c: None if c.state.vh is None
        else c.GV.rho0 * vsum(c.state.vh),
        "kg s-1", "Depth-integrated ocean mass y transport", "v",
        needs="transport"),
    # ---- static geometry (CMOR fx) ----------------------------------------
    "deptho": CatalogEntry(lambda c: c.G.bathyT * c.G.mask2dT, "m",
                           "Sea floor depth below geoid"),
    "areacello": CatalogEntry(lambda c: c.G.areaT, "m2",
                              "Ocean grid-cell area"),
    "sftof": CatalogEntry(lambda c: 100.0 * c.G.mask2dT, "%",
                          "Sea area fraction"),
    # ---- CMOR aliases and simple derived fields ---------------------------
    "obvfsq": CatalogEntry(_n2, "s-2",
                           "Square of Brunt-Vaisala frequency", "i",
                           needs="thermo"),
    "mlotst": CatalogEntry(lambda c: c.mld(0.03), "m",
                           "Mixed-layer depth by sigma-t criterion "
                           "(0.03 kg m-3)", needs="thermo"),
    "zossq": CatalogEntry(lambda c: c.sfc.ssh ** 2, "m2",
                          "Square of sea surface height"),
    "tossq": CatalogEntry(lambda c: c.sfc.sst ** 2, "degC2",
                          "Square of sea surface temperature",
                          needs="thermo"),
    "sossq": CatalogEntry(lambda c: c.sfc.sss ** 2, "psu2",
                          "Square of sea surface salinity",
                          needs="thermo"),
    "pbo": CatalogEntry(
        lambda c: (c.p_int[-1] + (c.forcing.mech.p_surf
                   if (c.forcing is not None and c.forcing.mech is not
                       None and c.forcing.mech.p_surf is not None)
                   else 0.0)) * c.G.mask2dT,
        "Pa", "Sea water pressure at sea floor"),
    "KE_col": CatalogEntry(
        lambda c: vsum(dg.kinetic_energy_3d(c.state, c.G) * c.state.h)
        * c.GV.rho0,
        "J m-2", "Depth-integrated kinetic energy"),
})


def rejection_reason(name: str, state, params, forcing=None,
                     has_ke_budget: bool = True,
                     has_tend: bool = True) -> Optional[str]:
    """None if the field ``name`` is servable under this configuration,
    else the reason it is not."""
    e = CATALOG.get(name)
    if e is None:
        return f"unknown diagnostic {name!r}"
    need = e.needs
    mech = getattr(forcing, "mech", None) if forcing is not None else None
    buoy = getattr(forcing, "buoy", None) if forcing is not None else None
    d = params.diabatic
    thermo = params.thermo_enabled and state.T is not None
    transport = getattr(state, "uh", None) is not None
    meke_on = getattr(state, "E_meke", None) is not None
    reasons = {
        "thermo": (not thermo, "needs an active thermodynamic state "
                   "(ENABLE_THERMODYNAMICS)"),
        "transport": (not transport,
                      "needs transport diagnostics (split dynamics)"),
        "meke": (not meke_on, "needs USE_MEKE = True"),
        "frazil": (getattr(state, "frazil", None) is None,
                   "needs FRAZIL = True"),
        "wind": (mech is None or mech.taux is None,
                 "needs wind forcing (WIND_CONFIG)"),
        "psurf": (mech is None or mech.p_surf is None,
                  "needs surface-pressure forcing"),
        "heatf": (buoy is None or (buoy.heat_flux is None
                                   and buoy.sw_flux is None
                                   and buoy.t_restore is None),
                  "needs heat forcing (BUOY_CONFIG)"),
        "sw": (buoy is None or buoy.sw_flux is None,
               "needs penetrating shortwave forcing"),
        "fw": (buoy is None or buoy.fw_flux is None,
               "needs fresh-water forcing"),
        "saltf": (buoy is None or buoy.salt_flux is None,
                  "needs a surface salt flux"),
        "ke_budget": (not has_ke_budget,
                      "needs the KE budget (split dynamics)"),
        "bl_scheme": (d.boundary_layer_scheme in ("NONE", "BULKML"),
                      "needs KPP or EPBL"),
        "kd_shear": (not d.use_shear_mixing,
                     "needs USE_JACKSON_PARAM / shear mixing"),
        "kd_bbl": (d.diff.bbl_effic <= 0.0, "needs BBL_EFFIC > 0"),
        "kd_itides": (d.diff.tidal is None, "needs INT_TIDE_DISSIPATION"),
        "kd_lowmode": (params.int_tides is None,
                       "needs INTERNAL_TIDES = True"),
        "gm": (params.gm is None, "needs THICKNESSDIFFUSE = True"),
        "gm_meke": (params.gm is None or not meke_on,
                    "needs THICKNESSDIFFUSE and USE_MEKE"),
        "transport_thermo": (not transport or state.T is None,
                             "needs transport diagnostics and "
                             "thermodynamics"),
    }
    if need in ("tend", "tend_frazil"):
        if not thermo:
            return f"{name} " + reasons["thermo"][1]
        if d.boundary_layer_scheme == "BULKML":
            return f"{name}: tendency capture covers the ALE diabatic " \
                   "path, not BULKML"
        if not has_tend:
            return f"{name} needs the tendency capture (full step_mom)"
        if need == "tend_frazil" and not d.frazil:
            return f"{name} needs FRAZIL = True"
        return None
    bad, why = reasons.get(need, (False, ""))
    return f"{name} {why}" if bad else None


def resolve(name: str) -> CatalogEntry:
    """The entry of the field ``name``; an unknown name raises KeyError
    with the nearest known names."""
    if name in CATALOG:
        return CATALOG[name]
    close = difflib.get_close_matches(name, CATALOG.keys(), n=3)
    hint = f" (did you mean {', '.join(close)}?)" if close else ""
    raise KeyError(f"unknown diagnostic field {name!r}{hint}")


def serve(name: str, ctx: DiagContext):
    """The field ``name`` on the native grid, on the state's device, or
    None if the model lacks its inputs under the configuration."""
    entry = CATALOG.get(name)
    if entry is None:
        return None
    try:
        return entry.fn(ctx)
    except (AttributeError, TypeError):
        return None
