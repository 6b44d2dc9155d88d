"""The six run directories the sponge, the BBL drag, REENTRANT_Y, the LF17
Langmuir number, the bulk mixed layer and hycom_basin's set free
(dense_water, tc4, adjustment, scm_lt, layered_bml, hycom_basin),
against the reference, on the CPU.

* Each build equals the reference's to the bit, float32 and float64
  (the reference's float64 side in a JAX_ENABLE_X64=1 subprocess,
  tests/torch_x64.py).
* Each runs 2 thermo cycles through the port's CLI in float64 (an
  ocean.stats line a cycle, every output file, mass kept), and through
  the reference's CLI, op by op, in the one float64 subprocess:
  ocean.stats to 1e-12 (mass, heat, salt; the drifts against their
  totals) and 1e-9 (KE, APE), the restart fields to 1e-10 of max-abs,
  and MOM_parameter_doc.all with every key of the reference's at the
  same value and module.
* An EQN_OF_STATE the port lacks raises NotImplementedError at build
  time, and the CLI on configs/spherical_gyre with such a value in its
  MOM_override writes no file; every REMAPPING_SCHEME and
  REGRIDDING_COORDINATE_MODE of the reference is ported, and
  spherical_gyre with each that the port used to refuse builds equal to
  the reference's build and runs a CLI cycle: one test per key.  DRHO_DT other than -0.2
  outside the DOME inflow raises.
* The catalog's Kd_BBL and Kd_interface on tc4 under a 0.3 m/s flow
  against the reference's catalog (float32, 1e-5 of max-abs).
* The reference's gates of these subsystems through the port
  (tests/torch_gates.py), each with its own asserts.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu_torch import interop
from mom6_tpu_torch.diagnostics import catalog as cat
from mom6_tpu_torch.diagnostics.sum_output import read_stats
from mom6_tpu_torch.drivers import solo
from mom6_tpu_torch.drivers.config_driver import build_model_from_params
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.framework.restart import restart_differences
from mom6_tpu_torch.io.netcdf import read_nc
from test_torch_configs import _doc, _input_keys
import torch_gates
import torch_x64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIX = ("dense_water", "tc4", "adjustment", "scm_lt", "layered_bml",
       "hycom_basin")
CYCLES = 2
TOL_FIELD, TOL_CONTENT, TOL_ENERGY = 1e-10, 1e-12, 1e-9
H_WET = 1e-3
GATES = ("dense_water_steps_stably", "tc4_sponge_ale",
         "adjustment_front_stays_balanced", "epbl_lf17_deepens_mld",
         "diabatic_layered_end_to_end", "bulkml_wind_deepens",
         "hycom_interior_follows_isopycnals", "hycom_via_config_driver",
         "sponge_relaxes_to_reference", "bbl_drag_diffusivity")


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


def reference_builds(dtype):
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    out = {}
    for name in SIX:
        ms = ref_build(RefParamFile([_config(name)]), dtype=dtype)
        out[name] = [interop.export(o) for o in (
            ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing)]
    return out


def reference_cli(work):
    """The six through the reference's CLI in float64, op by op."""
    from mom6_tpu.drivers import solo as ref_solo
    out = {}
    for name in SIX:
        d, cycle = cli_dir(name, os.path.join(work, "ref"))
        with jax.disable_jit():
            ref_solo.main([d, "--days", repr(CYCLES * cycle / 86400.0)])
        out[name] = d
    return out


_HELPER = r'''
import os, pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import test_torch_rundirs as m
out = {"builds": m.reference_builds(jnp.float64),
       "cli": m.reference_cli(os.path.dirname(%(path)r))}
with open(%(path)r, "wb") as fh:
    pickle.dump(out, fh)
'''

ref64_run, ref64 = torch_x64.fixtures(_HELPER, "rundirs64")


def _port_build(name, dtype, text=None):
    return build_model_from_params(ParamFile([_config(name)], text=text),
                                   dtype=dtype, device="cpu")


def _assert_same_build(ms, rec, tdt):
    G, GV, st, p, f = interop.load_all(*rec, device="cpu", dtype=tdt)
    for a, b in ((ms.grid, G), (ms.vgrid, GV), (ms.state, st),
                 (ms.forcing.mech, f.mech), (ms.forcing.buoy, f.buoy)):
        for name, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), t), name
        for name in tensor_fields(a):
            assert getattr(b, name) is not None, name
    assert ms.params == p


@pytest.mark.parametrize("name", SIX)
def test_build_equals_reference_f32(name):
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    ref = ref_build(RefParamFile([_config(name)]), dtype=jnp.float32)
    rec = [interop.export(o) for o in (ref.grid, ref.vgrid, ref.state,
                                       ref.params, ref.forcing)]
    ms = _port_build(name, torch.float32)
    _assert_same_build(ms, rec, torch.float32)
    p = ms.params
    assert (p.sponge is not None) == (name in ("dense_water", "tc4"))
    assert (p.bbl_visc is not None) == (name == "tc4")
    assert (p.waves is not None) == (name == "scm_lt")
    assert ms.grid.reentrant_y == (name == "adjustment")
    assert (p.diabatic.boundary_layer_scheme == "BULKML") == \
        (name == "layered_bml")
    assert (p.ale.mode == "HYCOM1") == (name == "hycom_basin")


# --- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("port_rundirs"))
    out = {}
    for name in SIX:
        d, cycle = cli_dir(name, work)
        st = solo.main([d, "--days", repr(CYCLES * cycle / 86400.0)],
                       device="cpu")
        assert st.h.dtype == torch.float64
        out[name] = d
    return out


@pytest.mark.parametrize("name", SIX)
def test_cli_two_cycles(name, port_cli):
    d = port_cli[name]
    lines = read_stats(os.path.join(d, "ocean.stats"))
    assert len(lines) == CYCLES
    for ln in lines:
        assert all(np.isfinite(v) for v in ln.values())
        assert abs(ln["dM_net"]) <= 1e-12 * ln["Mass"]
    for f in ("MOM.res.nc", "ocean_diags.nc", "chksum_diag",
              "MOM_parameter_doc.all", "MOM_parameter_doc.short",
              "ocean.cputime", os.path.join("RESTART", "ocean_solo.res")):
        assert os.path.exists(os.path.join(d, f)), f


# --- what the port lacks raises before anything is written ----------------

# spherical_gyre (JACKETT06, ADAPTIVE, neutral diffusion: all ported) with
# each value of the key under test that the port lacks
# (every EQN_OF_STATE of the reference is ported; NEMO, an EOS of MOM6
# that neither package has, stands for the key)
REFUSALS = {
    "EQN_OF_STATE": ("NEMO",),
}
# every coordinate and remap scheme of the reference is ported, so no
# value of these two keys is left to refuse: their tests keep their
# names and hold spherical_gyre with each value the port refused before
PORTED = {
    "REGRIDDING_COORDINATE_MODE": ("HYBGEN",),
    "REMAPPING_SCHEME": ("PPM_H6", "P3M_H4"),
}


def _refusal(key, tmp_path):
    values = REFUSALS[key]
    for value in values:
        with pytest.raises(NotImplementedError, match=f"{key}.*{value}"):
            _port_build("spherical_gyre", torch.float32,
                        text=f"{key} = {value}\n")
    # the CLI on a copy of the run directory with the first value
    d = os.path.join(str(tmp_path), "spherical_gyre")
    shutil.copytree(os.path.join(REPO, "configs", "spherical_gyre"), d)
    with open(os.path.join(d, "MOM_override"), "w") as f:
        f.write(f"{key} = {values[0]}\n")
    with pytest.raises(NotImplementedError, match=key):
        solo.main([d, "--days", "0.1"], device="cpu")
    assert sorted(os.listdir(d)) == ["MOM_input", "MOM_override"]


def test_unported_eos_refused_at_build(tmp_path):
    _refusal("EQN_OF_STATE", tmp_path)


def _ported(key, tmp_path):
    """spherical_gyre with each value of PORTED[key] in float32: the
    port's build equal to the reference's to the bit; the CLI on a copy
    with the first value for one cycle, every file written, mass kept
    to 1e-6."""
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    for value in PORTED[key]:
        text = f"{key} = {value}\n"
        ref = ref_build(RefParamFile([_config("spherical_gyre")], text=text),
                        dtype=jnp.float32)
        rec = [interop.export(o) for o in (ref.grid, ref.vgrid, ref.state,
                                           ref.params, ref.forcing)]
        ms = _port_build("spherical_gyre", torch.float32, text=text)
        _assert_same_build(ms, rec, torch.float32)
        assert value in (ms.params.ale.mode, ms.params.ale.scheme)
    d = os.path.join(str(tmp_path), "spherical_gyre")
    shutil.copytree(os.path.join(REPO, "configs", "spherical_gyre"), d)
    with open(os.path.join(d, "MOM_override"), "w") as f:
        f.write(f"{key} = {PORTED[key][0]}\n")
    solo.main([d, "--days", repr(1800.0 / 86400.0)], device="cpu")
    for f in ("MOM.res.nc", "ocean.stats", "MOM_parameter_doc.all",
              "ocean.cputime"):
        assert os.path.exists(os.path.join(d, f)), f
    ln = read_stats(os.path.join(d, "ocean.stats"))[-1]
    assert all(np.isfinite(v) for v in ln.values())
    assert abs(ln["dM_net"]) <= 1e-6 * ln["Mass"]


def test_unported_coordinate_refused_at_build(tmp_path):
    _ported("REGRIDDING_COORDINATE_MODE", tmp_path)


def test_unported_remapping_scheme_refused_at_build(tmp_path):
    _ported("REMAPPING_SCHEME", tmp_path)


def test_drho_dt_outside_dome_only_minus_0p2():
    """adjustment's DRHO_DT = -0.2 is the LINEAR EOS's own slope; another
    value raises (the reference reads the key only for the DOME
    inflow)."""
    ms = _port_build("adjustment", torch.float32)
    assert "DRHO_DT" in ms.param_file.logged_keys()
    with pytest.raises(NotImplementedError, match="DRHO_DT"):
        _port_build("adjustment", torch.float32, text="DRHO_DT = -0.25\n")


# --- the sponge's tendency ----------------------------------------------------

def test_sponge_tendency_closes_the_heat_budget():
    """dense_water in float64 with its bands 1 degC off the reference:
    one cycle's tendencies by process (step_mom(collect_tend=True)), the
    sponge's bucket among them, sum to the total change to round-off,
    and the sponge's is nonzero only in the bands and pulls back."""
    from mom6_tpu_torch.core.mom import step_mom
    ms = _port_build("dense_water", torch.float64)
    band = (ms.params.sponge.idamp > 0.0)[None]
    st = ms.state.replace(T=ms.state.T + 1.0 * band)
    with torch.inference_mode():
        _, tend = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params,
                           collect_tend=True)
    parts = ("T_advection_xy", "opottemppmdiff",
             "boundary_forcing_heat_tendency", "frazil_heat_tendency",
             "opottempdiff", "T_tendency_sponge", "Th_tendency_vert_remap")
    total = sum(tend[k] for k in parts)
    scale = float(tend["opottemptend"].abs().max())
    assert float((total - tend["opottemptend"]).abs().max()) \
        <= 1e-10 * scale
    sp = tend["T_tendency_sponge"]
    assert float(sp.abs().max()) > 1e-3 * scale
    assert float(sp[~band.expand_as(sp)].abs().max()) == 0.0
    assert float(sp[band.expand_as(sp)].sum()) < 0.0


# --- the catalog's BBL mixing ---------------------------------------------

def test_catalog_kd_bbl_on_tc4():
    """tc4 (BOTTOMDRAGLAW, BBL_EFFIC 0.2 by default) under a 0.3 m/s
    flow: Kd_BBL and the total Kd_interface as the reference's catalog
    serves them."""
    from mom6_tpu.diagnostics import catalog as ref_cat
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build
    from mom6_tpu.eos import get_eos as ref_get_eos
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    ref = ref_build(RefParamFile([_config("tc4")]))
    rst = ref.state.replace(u=jnp.full_like(ref.state.u, 0.3)
                            * ref.grid.mask2dCu)
    ms = _port_build("tc4", torch.float32)
    st = ms.state.replace(u=torch.full_like(ms.state.u, 0.3)
                          * ms.grid.mask2dCu)
    assert ms.params.diabatic.diff.bbl_effic == 0.2
    rc = ref_cat.DiagContext(rst, ref.grid, ref.vgrid, ref.params,
                             forcing=ref.forcing,
                             eos=ref_get_eos(ref.params.eos_name))
    pc = cat.DiagContext(st, ms.grid, ms.vgrid, ms.params,
                         forcing=ms.forcing,
                         eos=get_eos(ms.params.eos_name))
    assert cat.rejection_reason("Kd_BBL", st, ms.params) is None
    for name in ("Kd_BBL", "Kd_interface"):
        want = np.asarray(ref_cat.serve(name, rc), np.float64)
        got = cat.serve(name, pc).double().numpy()
        assert np.abs(want).max() > 0.0
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


# --- the reference's gates --------------------------------------------------

@pytest.mark.parametrize("name", GATES)
def test_physics_gate(name):
    rec = torch_gates.run_gate(name, "cpu")
    assert np.isfinite(rec["measured"])


# --- against the reference's float64 side (last: its subprocess runs
# while the tests above do) ------------------------------------------------

@pytest.mark.parametrize("name", SIX)
def test_build_equals_reference_f64(name, ref64):
    _assert_same_build(_port_build(name, torch.float64),
                       ref64["builds"][name], torch.float64)


def _check_cli(port_dir, ref_dir):
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
    a = os.path.join(port_dir, "MOM.res.nc")
    b = os.path.join(ref_dir, "MOM.res.nc")
    assert sorted(read_nc(a)) == sorted(read_nc(b))
    for k, e in restart_differences(a, b, H_WET).items():
        assert e <= TOL_FIELD, (k, e)


@pytest.mark.parametrize("name", SIX)
def test_cli_matches_reference(name, ref64, port_cli):
    _check_cli(port_cli[name], ref64["cli"][name])


def _plain(value):
    """A doc value with numpy's scalar repr (the reference writes its
    default ALE_RHO_TARGETS as "np.float64(1035.0), ...") as the number's
    own text."""
    return re.sub(r"np\.float(?:32|64)\(([^)]*)\)", r"\1", value)


@pytest.mark.parametrize("name", SIX)
def test_cli_parameter_doc_matches_reference(name, ref64, port_cli):
    """Every key of the reference's doc with its value and module; the
    port's adds only the driver's own keys."""
    got, want = _doc(port_cli[name]), _doc(ref64["cli"][name])
    for k, (value, module) in want.items():
        assert got.get(k) == (_plain(value), module), (k, got.get(k), value)
    keys = _input_keys(port_cli[name])
    assert set(keys) <= set(got)
