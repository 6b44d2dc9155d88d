"""isomip's, tc1's, tc2's and nonbouss_basin's modules (the ice shelf and
its coupling, SIGMA_SHELF_ZSTAR, the freezing point and frazil,
geothermal heating, the JHL shear mixing, PPM_IH4, VarMix and the
non-Boussinesq pressure force) against the reference, on the CPU.

* Each module on seeded inputs (numpy, seed 13) on a Cartesian channel
  with land and a ridge: the reference and the port on the same inputs,
  float32 to 1e-5 of the reference's max-abs (the reference's float32
  side op by op in a subprocess of its own) and float64 to 1e-10 (the
  reference op by op in the file's JAX_ENABLE_X64=1 subprocess,
  tests/torch_x64.py).
* The four run directories' builds equal the reference's to the bit in
  float32 and float64.
* Each runs 2 thermo cycles through the port's CLI in float64 and
  through the reference's CLI op by op: ocean.stats to 1e-12 (mass,
  heat, salt) and 1e-9 (KE, APE), the restart fields to 1e-10 of
  max-abs, and MOM_parameter_doc.all with every key of the reference's
  at the same value and module.
* A split isomip run and a split tc2 run (2 + 2 cycles through the CLI)
  equal straight ones to the bit; tc2 from a state cold enough to form
  frazil, its accumulated ``frazil`` carried by the restart (the
  reference's registry has no ``frazil``), equals a straight run too.
* What the four MOM_inputs' keys can still ask for and the port lacks
  raises at build time; ts_range with NK < NKML + NKBL + 2 raises as the
  reference does.

The reference's gates of these modules run through the port in
tests/test_torch_analytic.py (tests/torch_gates.py).
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu_torch import interop
from mom6_tpu_torch.diagnostics.sum_output import read_stats
from mom6_tpu_torch.drivers import solo
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.io.netcdf import read_nc
from test_torch_configs import _doc, _input_keys
from test_torch_obc import restart_differences_common
from test_torch_rundirs import _plain
import torch_x64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRS = ("isomip", "tc1", "tc2", "nonbouss_basin")
CYCLES = 2
TOL_OP32, TOL_F64 = 1e-5, 1e-10
TOL_CONTENT, TOL_ENERGY, TOL_FIELD = 1e-12, 1e-9, 1e-10
H_WET = 1e-3
NZ = 6


# --- the seeded inputs and the operators, in either package ----------------

def reference_grid(dtype):
    """A 12x10 channel, periodic in x, on a beta plane, with a ridge and
    land in the south-west corner."""
    from mom6_tpu.grid.grid import build_cartesian_grid
    x = np.linspace(0.0, 1.0, 12)[None, :]
    y = np.linspace(0.0, 1.0, 10)[:, None]
    depth = 3000.0 - 1200.0 * np.exp(-((x - 0.5) / 0.15) ** 2) + 0.0 * y
    depth[:2, :2] = 0.0
    return build_cartesian_grid(12, 10, 600.0, 500.0, depth=depth,
                                min_depth=1.0, f0=1e-4, beta=2e-11,
                                cyclic_x=True, dtype=dtype)


def seeded_inputs(ny, nx, seed=13):
    """float64 numpy inputs on an (ny, nx) grid with NZ layers."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape)
    h = 3000.0 / NZ * (1.0 + 0.4 * u(NZ, ny, nx))
    h[2, :3, :3] = 1e-3 * (1.0 + u(3, 3))      # thin layers among thick
    z = np.cumsum(h, axis=0) - 0.5 * h
    mass = np.where(np.arange(nx)[None, :] < nx // 2,
                    1028.0 * (300.0 + 100.0 * u(ny, nx)), 0.0)
    return dict(
        h=h, h1=h[::-1].copy(), T=20.0 - 15.0 * z / 3000.0
        + 0.4 * u(NZ, ny, nx), S=35.0 + 0.3 * u(NZ, ny, nx),
        Tcold=-2.5 + 0.5 * u(NZ, ny, nx), u=0.3 * u(NZ, ny, nx),
        v=0.3 * u(NZ, ny, nx), tr=u(NZ, ny, nx), mass=mass,
        frac=(mass > 0.0).astype(float), T0=-1.0 + 2.0 * u(ny, nx),
        S0=34.5 + 0.5 * u(ny, nx), pbase=2e6 * (1.0 + u(ny, nx)),
        uml=0.1 * (1.0 + u(ny, nx)), taux=0.1 * u(ny, nx),
        tauy=0.1 * u(ny, nx), flux=100.0 * u(ny, nx),
        fw=1e-6 * u(ny, nx), cg1=2.0 + u(ny, nx),
        psurf=1e4 * (1.0 + u(ny, nx)),
        dz=np.full(NZ, 3000.0 / NZ))


def reference_pkg():
    from mom6_tpu.ale import regridding, remapping
    from mom6_tpu.core import pressure_force
    from mom6_tpu.core.dynamics_split_rk2 import MechForcing
    from mom6_tpu.core.mom import Forcing
    from mom6_tpu.core.state import OceanState
    from mom6_tpu.eos import get_eos as ref_get_eos
    from mom6_tpu.eos import tfreeze
    from mom6_tpu.grid.vertical import build_layered_vgrid
    from mom6_tpu.physics import ice_shelf, shelf_coupling
    from mom6_tpu.physics.lateral import lateral_mixing_coeffs
    from mom6_tpu.physics.vertical import diabatic, kappa_shear, opacity
    return types.SimpleNamespace(
        regridding=regridding, remapping=remapping, pf=pressure_force,
        MechForcing=MechForcing, Forcing=Forcing,
        BuoyancyForcing=diabatic.BuoyancyForcing, OceanState=OceanState,
        get_eos=ref_get_eos, tfreeze=tfreeze, ice_shelf=ice_shelf,
        shelf=shelf_coupling, lmc=lateral_mixing_coeffs, diabatic=diabatic,
        kappa_shear=kappa_shear, opacity=opacity,
        vgrid=lambda nz, dtype, bouss=True: build_layered_vgrid(
            nz, dtype=dtype, boussinesq=bouss))


def port_pkg():
    from mom6_tpu_torch.ale import regridding, remapping
    from mom6_tpu_torch.core import pressure_force
    from mom6_tpu_torch.core.dynamics_split_rk2 import MechForcing
    from mom6_tpu_torch.core.mom import Forcing
    from mom6_tpu_torch.core.state import OceanState
    from mom6_tpu_torch.eos import tfreeze
    from mom6_tpu_torch.grid.vertical import build_layered_vgrid
    from mom6_tpu_torch.physics import ice_shelf, shelf_coupling
    from mom6_tpu_torch.physics.lateral import lateral_mixing_coeffs
    from mom6_tpu_torch.physics.vertical import (diabatic, kappa_shear,
                                                 opacity)
    return types.SimpleNamespace(
        regridding=regridding, remapping=remapping, pf=pressure_force,
        MechForcing=MechForcing, Forcing=Forcing,
        BuoyancyForcing=diabatic.BuoyancyForcing, OceanState=OceanState,
        get_eos=get_eos, tfreeze=tfreeze, ice_shelf=ice_shelf,
        shelf=shelf_coupling, lmc=lateral_mixing_coeffs, diabatic=diabatic,
        kappa_shear=kappa_shear, opacity=opacity,
        vgrid=lambda nz, dtype, bouss=True: build_layered_vgrid(
            nz, dtype=dtype, device="cpu", boussinesq=bouss))


def _ops(pk, x, G, GV, GVn):
    """{name: thunk returning a tuple of arrays} of every operator on the
    inputs ``x`` (arrays of the package), in either package; ``GVn`` the
    non-Boussinesq vertical grid."""
    eos = pk.get_eos("WRIGHT")
    h, T, S = x["h"], x["T"], x["S"]
    sc = pk.shelf
    shelf = sc.ShelfCoupling(mass_shelf=x["mass"], frac_shelf_h=x["frac"])
    shelf_u = sc.ShelfCoupling(mass_shelf=x["mass"], frac_shelf_h=x["frac"],
                               ustar_dependent=True, utide=0.05,
                               flux_factor=0.7)

    def coupling():
        st = pk.OceanState(h=h, u=x["u"], v=x["v"], T=T, S=S)
        f = pk.Forcing(
            mech=pk.MechForcing(taux=x["taux"], tauy=x["tauy"],
                                p_surf=x["psurf"], u10=x["cg1"]),
            buoy=pk.BuoyancyForcing(heat_flux=x["flux"],
                                    salt_flux=1e-3 * x["flux"],
                                    fw_flux=x["fw"], sw_flux=x["flux"]))
        out, melt = sc.apply_shelf_coupling(st, f, G, GV, shelf_u)
        m, b = out.mech, out.buoy
        return (m.taux, m.tauy, m.p_surf, m.u10, b.heat_flux, b.salt_flux,
                b.fw_flux, b.sw_flux, melt)

    def trim():
        rho = 1035.0 + eos.density(T, S, 2e7 * h / 3000.0, rho_ref=1035.0)
        return sc.trim_columns_for_p_surf(h, T, S, rho, GV.g_earth
                                          * x["mass"], GV.g_earth)[:1]

    tf = pk.tfreeze
    p_pa = 2e7 * h / 3000.0
    dg = pk.diabatic
    vm = pk.lmc.VarMixParams(resoln_scaled_kh=True, use_visbeck=True,
                             khth_slope_cff=0.1, visbeck_l_scale=3e4)
    vm4 = pk.lmc.VarMixParams(res_fn_power=4, res_coef=0.7)
    geo = pk.opacity.GeothermalParams(heat_flux=0.05)
    return {
        "three_equation_melt": lambda: pk.ice_shelf.three_equation_melt(
            x["T0"], x["S0"], x["pbase"]),
        "shelf_melt_fluxes": lambda: sc.shelf_melt_fluxes(
            x["T0"], x["S0"], shelf, GV.g_earth),
        "shelf_melt_fluxes_ustar": lambda: sc.shelf_melt_fluxes(
            x["T0"], x["S0"], shelf_u, GV.g_earth, u_ml=x["uml"]),
        "apply_shelf_coupling": coupling,
        "trim_columns_for_p_surf": trim,
        "sigma_shelf_zstar": lambda: (
            pk.regridding.build_sigma_shelf_zstar_grid(
                h, G.bathyT, x["dz"], 1500.0),
            pk.regridding.build_sigma_grid(h)),
        "tfreeze": lambda: (tf.tfreeze_linear(S, p_pa),
                            tf.tfreeze_millero(S, p_pa),
                            tf.tfreeze_teos_poly(S, p_pa)),
        "frazil_linear": lambda: dg._make_frazil(x["Tcold"], S, h, GV,
                                                 3925.0, "LINEAR"),
        "frazil_teos": lambda: dg._make_frazil(x["Tcold"], S, h, GV,
                                               3925.0, "TEOS_POLY"),
        "geothermal": lambda: (pk.opacity.geothermal_heating(
            h, GV, geo, cp=3925.0),),
        "kappa_shear": lambda: pk.kappa_shear.kappa_shear(
            h, x["u"], x["v"], T, S, G, GV, eos, dt=3600.0),
        "reconstruct_ppm_ih4": lambda: pk.remapping.reconstruct(
            T, h, "PPM_IH4")[:3],
        "remap_ppm_ih4": lambda: (pk.remapping.remap_column(
            T, h, x["h1"] * (h.sum(0) / x["h1"].sum(0))[None],
            "PPM_IH4"),),
        "resoln_function": lambda: (
            pk.lmc.calc_resoln_function(x["cg1"], G, vm),
            pk.lmc.calc_resoln_function(x["cg1"], G, vm4)),
        "slope_functions": lambda: pk.lmc.calc_slope_functions(h, G, GV,
                                                               vm),
        "pf_nonbouss": lambda: tuple(pk.pf.pressure_force_fv_nonbous(
            GVn.rho0 * h, T, S, G, GVn, eos, p_surf=x["psurf"])),
        "find_eta_nonbouss": lambda: (
            pk.pf.find_eta_nonbouss(h, T, S, G, GVn, eos),
            pk.pf.spv_avg(h, T, S, GVn, eos, p_surf=x["psurf"])),
        "geometric_to_mass_h": lambda: (pk.pf.geometric_to_mass_h(
            h, T, S, GVn, eos),),
    }


OPS = ("three_equation_melt", "shelf_melt_fluxes", "shelf_melt_fluxes_ustar",
       "apply_shelf_coupling", "trim_columns_for_p_surf",
       "sigma_shelf_zstar", "tfreeze", "frazil_linear", "frazil_teos",
       "geothermal", "kappa_shear", "reconstruct_ppm_ih4", "remap_ppm_ih4",
       "resoln_function", "slope_functions", "pf_nonbouss",
       "find_eta_nonbouss", "geometric_to_mass_h")


def reference_ops(dtype):
    """{"grid": exported grid, op: [numpy arrays]} of the reference, op by
    op."""
    pk = reference_pkg()
    G = reference_grid(dtype)
    x = seeded_inputs(G.ny, G.nx)
    xs = {k: jnp.asarray(v, dtype) for k, v in x.items()}
    xs["dz"] = tuple(float(v) for v in x["dz"])
    res = {"grid": interop.export(G)}
    with jax.disable_jit():
        for name, fn in _ops(pk, xs, G, pk.vgrid(NZ, dtype),
                             pk.vgrid(NZ, dtype, False)).items():
            res[name] = [np.asarray(a) for a in fn()]
    return res


def port_ops(rec, tdtype):
    """The port's results on the grid of ``rec``."""
    pk = port_pkg()
    G = interop.load_grid(rec["grid"], device="cpu", dtype=tdtype)
    x = seeded_inputs(G.ny, G.nx)
    xs = {k: torch.tensor(v, dtype=tdtype) for k, v in x.items()}
    xs["dz"] = tuple(float(v) for v in x["dz"])
    with torch.inference_mode():
        return {name: [a.double().numpy() for a in fn()]
                for name, fn in _ops(pk, xs, G, pk.vgrid(NZ, tdtype),
                                     pk.vgrid(NZ, tdtype, False)).items()}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-300))


# --- the reference's runs ----------------------------------------------------

def cli_dir(name, where):
    """A copy of configs/<name> in float64 with an ocean.stats line a
    thermo cycle; returns (the directory, the cycle's seconds)."""
    d = os.path.join(where, name)
    shutil.copytree(os.path.join(REPO, "configs", name), d)
    pf = ParamFile([os.path.join(d, "MOM_input")])
    dt = pf.get("DT", float)
    cycle = pf.get("DT_THERM", float, default=dt)
    with open(os.path.join(d, "MOM_override"), "w") as f:
        f.write(f"DOUBLE_PRECISION = True\nENERGYSAVEDAYS = "
                f"{cycle / 86400.0!r}\n")
    return d, cycle


def _config(name):
    return os.path.join(REPO, "configs", name, "MOM_input")


def _export_build(ms):
    return [interop.export(o) for o in (ms.grid, ms.vgrid, ms.state,
                                        ms.params, ms.forcing)]


def reference_f64(work):
    """The reference in float64: the builds, the operators and the four
    run directories through its CLI (2 cycles), op by op."""
    from mom6_tpu.drivers import solo as ref_solo
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    out = {"builds": {}, "cli": {}, "ops": reference_ops(jnp.float64)}
    for name in DIRS:
        out["builds"][name] = _export_build(
            ref_build(RefParamFile([_config(name)]), dtype=jnp.float64))
        d, cycle = cli_dir(name, os.path.join(work, "ref"))
        with jax.disable_jit():
            ref_solo.main([d, "--days", repr(CYCLES * cycle / 86400.0)])
        out["cli"][name] = d
    return out


def reference_f32():
    """The reference in float32: the operators and the builds."""
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    return {"ops": reference_ops(jnp.float32),
            "builds": {name: _export_build(ref_build(
                RefParamFile([_config(name)]), dtype=jnp.float32))
                for name in DIRS}}


_HELPER = r'''
import os, pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
jax.config.update("jax_enable_x64", True)
import test_torch_shelf_tc as m
out = m.reference_f64(os.path.dirname(%(path)r))
with open(%(path)r, "wb") as fh:
    pickle.dump(out, fh)
'''

_HELPER32 = r'''
import os, pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import test_torch_shelf_tc as m
with open(%(path)r, "wb") as fh:
    pickle.dump(m.reference_f32(), fh)
'''

ref64_run, ref64 = torch_x64.fixtures(_HELPER, "shelftc64")
ref32_run, ref32 = torch_x64.fixtures(_HELPER32, "shelftc32", x64=False,
                                      name="ref32")


def _port_build(name, dtype, text=None):
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    return build_model_from_params(ParamFile([_config(name)], text=text),
                                   dtype=dtype, device="cpu")


def _assert_same_build(ms, rec, tdt):
    """Every tensor of the reference's build equal to the port's to the
    bit, the parameters equal, the tracer packages by type and field."""
    G, GV, st, p, f = interop.load_all(*rec, device="cpu", dtype=tdt)
    for a, b in ((ms.grid, G), (ms.vgrid, GV), (ms.state, st),
                 (ms.forcing.mech, f.mech), (ms.forcing.buoy, f.buoy)):
        for name, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), t), name
        for name in tensor_fields(a):
            assert getattr(b, name) is not None, name
    assert (ms.params.tfc is None) == (p.tfc is None)
    if p.tfc is not None:
        assert [(type(k), vars(k)) for k in ms.params.tfc.packages] == \
            [(type(k), vars(k)) for k in p.tfc.packages]
    assert ms.params.replace(tfc=None) == p.replace(tfc=None)


# --- the operators -----------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_operator_f32(op, ref32):
    rec = ref32["ops"]
    got = port_ops(rec, torch.float32)[op]
    assert len(got) == len(rec[op])
    for g, w in zip(got, rec[op]):
        assert g.shape == w.shape
        assert _rel(g, w) <= TOL_OP32, (op, _rel(g, w))


@pytest.mark.parametrize("op", OPS)
def test_operator_f64(op, ref64):
    rec = ref64["ops"]
    got = port_ops(rec, torch.float64)[op]
    for g, w in zip(got, rec[op]):
        assert _rel(g, w) <= TOL_F64, (op, _rel(g, w))


# --- the builds --------------------------------------------------------------

@pytest.mark.parametrize("name", DIRS)
def test_build_equals_reference_f32(name, ref32):
    ms = _port_build(name, torch.float32)
    _assert_same_build(ms, ref32["builds"][name], torch.float32)
    p = ms.params
    assert (p.shelf is not None) == (name == "isomip")
    assert (p.ale.mode == "SIGMA_SHELF_ZSTAR") == (name == "isomip")
    assert (p.varmix is not None) == (name == "tc1")
    assert ms.vgrid.boussinesq == (name != "nonbouss_basin")
    if name != "isomip":
        assert p.diabatic.frazil and p.diabatic.shear_scheme == "JHL"
    assert (p.ale.scheme == "PPM_IH4") == (name in ("tc2",
                                                    "nonbouss_basin"))


@pytest.mark.parametrize("name", DIRS)
def test_build_equals_reference_f64(name, ref64):
    _assert_same_build(_port_build(name, torch.float64),
                       ref64["builds"][name], torch.float64)


# --- what the port lacks raises at build time --------------------------------

@pytest.mark.parametrize("name,text,exc,match", [
    ("tc1", "NK = 5\n", ValueError, "NKML"),
    ("isomip", "ICE_PROFILE_CONFIG = cosine\n", NotImplementedError,
     "ICE_PROFILE_CONFIG"),
    ("tc2", "TFREEZE_FORM = UNKNOWN\n", NotImplementedError, "TFREEZE_FORM"),
    # the opacity, the harmonic SAL, SPLIT_RK2B, double diffusion, SKEB,
    # every remapping scheme and coordinate and BT_WIDE_HALO (on ranks,
    # tests/test_torch_mesh.py) are ported: these cases (no exception)
    # hold BT_WIDE_HALO, AUTO and fixed, alone and beside the scheme or
    # coordinate each held before, off a mesh (HYBGEN on tc2: isomip's
    # file sets SIGMA_SHELF_ZSTAR_DEPTH, which HYBGEN does not read)
    ("tc2", "BT_WIDE_HALO = -1\n", None, None),
    ("tc2", "BT_WIDE_HALO = 4\n", None, None),
    ("nonbouss_basin", "REMAPPING_SCHEME = PPM_H6\nBT_WIDE_HALO = 2\n",
     None, None),
    ("tc2", "REGRIDDING_COORDINATE_MODE = HYBGEN\nBT_WIDE_HALO = 6\n",
     None, None),
    ("tc1", "REMAPPING_SCHEME = P3M_H4\nBT_WIDE_HALO = 8\n", None, None),
], ids=["ts_range-nk", "ice-profile", "tfreeze-form", "opacity",
        "double-diffusion", "remap-scheme", "coordinate", "passivity"])
def test_unported_values_refused_at_build(name, text, exc, match):
    """What the port lacks raises naming itself; BT_WIDE_HALO (no
    exception) builds: off a mesh the build reads the width and is the
    build without it otherwise."""
    if exc is None:
        from torch_widehalo import assert_build_reads_wide_halo
        assert_build_reads_wide_halo(
            lambda t: _port_build(name, torch.float32, text=t or None),
            text)
        return
    with pytest.raises(exc, match=match):
        _port_build(name, torch.float32, text=text)


# --- the CLI -----------------------------------------------------------------

@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("port_shelftc"))
    out = {}
    for name in DIRS:
        d, cycle = cli_dir(name, work)
        st = solo.main([d, "--days", repr(CYCLES * cycle / 86400.0)],
                       device="cpu")
        assert st.h.dtype == torch.float64
        out[name] = d
    return out


@pytest.mark.parametrize("name", DIRS)
def test_cli_two_cycles(name, port_cli):
    d = port_cli[name]
    lines = read_stats(os.path.join(d, "ocean.stats"))
    assert len(lines) == CYCLES
    for ln in lines:
        assert all(np.isfinite(v) for v in ln.values())
    for f in ("MOM.res.nc", "ocean_diags.nc", "chksum_diag",
              "MOM_parameter_doc.all", "ocean.cputime",
              os.path.join("RESTART", "ocean_solo.res")):
        assert os.path.exists(os.path.join(d, f)), f


@pytest.mark.parametrize("name", DIRS)
def test_cli_matches_reference(name, ref64, port_cli):
    port_dir, ref_dir = port_cli[name], ref64["cli"][name]
    got = read_stats(os.path.join(port_dir, "ocean.stats"))
    want = read_stats(os.path.join(ref_dir, "ocean.stats"))
    assert len(got) == len(want) == CYCLES
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        for k in ("Mass", "Salt", "Heat"):
            assert abs(g[k] - w[k]) <= TOL_CONTENT * abs(w[k]), (k, g, w)
        for k in ("KE", "APE", "En"):
            assert abs(g[k] - w[k]) <= TOL_ENERGY * abs(w[k]), (k, g, w)
        for k, tot in (("dM_net", "Mass"), ("dS_net", "Salt"),
                       ("dH_net", "Heat")):
            assert abs(g[k] - w[k]) <= TOL_CONTENT * abs(w[tot]), (k, g, w)
    a = read_nc(os.path.join(port_dir, "MOM.res.nc"))
    b = read_nc(os.path.join(ref_dir, "MOM.res.nc"))
    # the reference's registry has neither the passive tracers nor E_meke
    # (ROADMAP queue 3)
    assert set(b) <= set(a)
    assert all(k.startswith("tr_") or k == "E_meke"
               for k in set(a) - set(b)), set(a) - set(b)
    for k, e in restart_differences_common(a, b, H_WET).items():
        assert e <= TOL_FIELD, (k, e)


@pytest.mark.parametrize("name", DIRS)
def test_cli_parameter_doc_matches_reference(name, ref64, port_cli):
    """Every key of the reference's doc with its value and module; the
    port's adds only the driver's own keys."""
    got, want = _doc(port_cli[name]), _doc(ref64["cli"][name])
    for k, (value, module) in want.items():
        assert got.get(k) == (_plain(value), module), (k, got.get(k), value)
    assert set(_input_keys(port_cli[name])) <= set(got)


# --- split runs ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["isomip", "tc2"])
def test_split_run_equals_straight_run(name, tmp_path):
    """2 + 2 thermo cycles through the CLI equal 4 straight ones to the
    bit."""
    runs = {}
    for sub in ("straight", "first", "second"):
        runs[sub], cycle = cli_dir(name, str(tmp_path / sub))
    two, four = repr(2 * cycle / 86400.0), repr(4 * cycle / 86400.0)
    solo.main([runs["straight"], "--days", four], device="cpu")
    solo.main([runs["first"], "--days", two], device="cpu")
    shutil.copy(os.path.join(runs["first"], "RESTART", "ocean_solo.res"),
                runs["second"])
    solo.main([runs["second"], "--days", two, "--restart-in",
               os.path.join(runs["first"], "MOM.res.nc")], device="cpu")
    a = read_nc(os.path.join(runs["straight"], "MOM.res.nc"))
    b = read_nc(os.path.join(runs["second"], "MOM.res.nc"))
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "__step__":
            assert np.array_equal(a[k], b[k]), k


def test_tc2_frazil_carried_across_a_restart(tmp_path):
    """tc2 from a top layer below freezing, with the frazil accumulator
    allocated: frazil forms, and 2 cycles, a restart through the
    registry, 2 more equal 4 straight cycles to the bit, ``frazil``
    included."""
    from mom6_tpu_torch.core.mom import step_mom
    from mom6_tpu_torch.framework.restart import RestartRegistry
    ms = _port_build("tc2", torch.float64)
    T = ms.state.T.clone()
    T[0] = -2.5
    s0 = ms.state.replace(T=T, frazil=torch.zeros_like(ms.state.h[0]))

    def cycles(s, n):
        with torch.inference_mode():
            for _ in range(n):
                s = step_mom(s, ms.forcing, ms.grid, ms.vgrid, ms.params)
        return s
    straight = cycles(s0, 4)
    half = cycles(s0, 2)
    reg = RestartRegistry()
    assert "frazil" in reg.register_state(s0)
    path = str(tmp_path / "MOM.res.nc")
    reg.save_restart(path, half)
    template = ms.state.replace(frazil=torch.zeros_like(ms.state.h[0]))
    back, _, _ = reg.restore_state(path, template)
    split = cycles(back, 2)
    assert float(straight.frazil.max()) > 0.0
    for k in ("h", "u", "v", "T", "S", "frazil"):
        assert torch.equal(getattr(split, k), getattr(straight, k)), k
