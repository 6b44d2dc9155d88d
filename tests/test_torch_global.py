"""Parity of the port's tripolar global path with the JAX reference: the
grid generator, the mosaic grid, the parameter file and
build_model_from_params, GM thickness diffusion and along-layer tracer
diffusion, the fold-aware operators on a grid with land, and one thermo
cycle of a small global model through core/mom.py::step_mom.

The small model is the reference's ``configs/global_2deg/MOM_input`` on a
generated 32x24x5 mosaic (16 regular rows from 80S to 65N and an 8-row
bipolar cap, the hand-digitized continents, ocean fraction 0.65) with
``USE_KPP = False``.  Inputs are made with numpy from a seed and handed to
both packages; float32 throughout (the float64 slice is in
tests/test_torch_x64.py).

Tolerances: what numpy builds in float64 on both sides (supergrid,
topography, metrics, profiles) is equal to the bit; single operators agree
to 1e-5 of the field's max-abs; the cycle to 1e-4.  T and S are compared
where a layer holds water (h > 1 mm): over topography the z* grid has
vanished layers of 1e-10 m, whose T and S carry no heat or salt and are
what the column solves and the remap leave of round-off there.

The reference runs the cycle op by op (``jax.disable_jit()``), because
jitted it disagrees with itself here: in float32 its finite-volume
pressure force divides a cancelling numerator by the face thickness, and
where a vanished bottom layer (1e-10 m) meets a deeper neighbour the
interpolated interface heights cancel exactly op by op but leave one ulp
of the depth under XLA's fused multiply-adds.  At face (k=4, j=22, i=22)
of this model the jitted pressure force is 97 m s-2, the op-by-op one
-5e-5 m s-2, and after one cycle the two differ by 0.26 m in h and by
94% of max|u|.  The port does the operations one by one, as the op-by-op
reference does, and is held to that.
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_global_grid as ref_tripolar  # noqa: E402

from mom6_tpu.ale.ale import ale_regrid_remap as ref_ale  # noqa: E402
from mom6_tpu.core.coriolis_adv import coriolis_adv as ref_coradv  # noqa: E402
from mom6_tpu.core.isopycnal_slopes import \
    isopycnal_slopes as ref_slopes  # noqa: E402
from mom6_tpu.core.mom import step_mom as ref_step_mom  # noqa: E402
from mom6_tpu.core.pressure_force import \
    pressure_force_fv as ref_pf_fv  # noqa: E402
from mom6_tpu.drivers.config_driver import \
    build_model_from_params as ref_build  # noqa: E402
from mom6_tpu.eos import get_eos as ref_get_eos  # noqa: E402
from mom6_tpu.framework.config import ParamFile as RefParamFile  # noqa: E402
from mom6_tpu.grid import mosaic as ref_mosaic  # noqa: E402
from mom6_tpu.physics.lateral.hor_visc import \
    horizontal_viscosity as ref_hor_visc  # noqa: E402
from mom6_tpu.physics.lateral.thickness_diffuse import \
    GMParams as RefGMParams  # noqa: E402
from mom6_tpu.physics.lateral.thickness_diffuse import \
    thickness_diffuse as ref_thickness_diffuse  # noqa: E402
from mom6_tpu.tracers.advect import advect_tracers as ref_advect  # noqa: E402
from mom6_tpu.tracers.hor_diff import tracer_hordiff as ref_hordiff  # noqa: E402
from mom6_tpu_torch import interop  # noqa: E402
from mom6_tpu_torch.ale.ale import ale_regrid_remap  # noqa: E402
from mom6_tpu_torch.core.coriolis_adv import coriolis_adv  # noqa: E402
from mom6_tpu_torch.core.dynamics_split_rk2 import (  # noqa: E402
    MechForcing, step_dynamics_split_rk2)
from mom6_tpu_torch.core.isopycnal_slopes import isopycnal_slopes  # noqa: E402
from mom6_tpu_torch.core.mom import step_mom  # noqa: E402
from mom6_tpu_torch.core.pressure_force import pressure_force_fv  # noqa: E402
from mom6_tpu_torch.drivers import config_driver  # noqa: E402
from mom6_tpu_torch.drivers.config_driver import \
    build_model_from_params  # noqa: E402
from mom6_tpu_torch.drivers.experiments import polar_cap_bump  # noqa: E402
from mom6_tpu_torch.eos import get_eos  # noqa: E402
from mom6_tpu_torch.framework.config import ParamFile  # noqa: E402
from mom6_tpu_torch.framework import stencil  # noqa: E402
from mom6_tpu_torch.framework.containers import tensor_fields  # noqa: E402
from mom6_tpu_torch.grid import mosaic, tripolar  # noqa: E402
from mom6_tpu_torch.io.netcdf import read_nc  # noqa: E402
from mom6_tpu_torch.physics.lateral.hor_visc import \
    horizontal_viscosity  # noqa: E402
from mom6_tpu_torch.physics.lateral.thickness_diffuse import (  # noqa: E402
    GMParams, thickness_diffuse)
from mom6_tpu_torch.tracers.advect import advect_tracers  # noqa: E402
from mom6_tpu_torch.tracers.hor_diff import tracer_hordiff  # noqa: E402

torch.set_num_threads(1)

NX, NY_REG, NY_CAP, NK = 32, 16, 8, 5
NY = NY_REG + NY_CAP
OVERRIDES = (f"NIGLOBAL = {NX}\nNJGLOBAL = {NY}\nNK = {NK}\n"
             "USE_KPP = False\nTRACER_ADVECT_SUB = 3\n")
# the same model with KPP on (as the file commits it) on z* layers that
# resolve a boundary layer
KPP_DZ = (20.0, 80.0, 300.0, 1100.0, 2500.0)
KPP_OVERRIDES = (OVERRIDES.replace("USE_KPP = False\n", "")
                 + "ALE_RESOLUTION = " + ", ".join(map(str, KPP_DZ)) + "\n")
GLOBAL_2DEG = os.path.join(REPO, "configs", "global_2deg")
TOL_OP = 1e-5
TOL_SLICE = 1e-4
T_REF, S_REF = 8.0, 35.0       # of configs/global_2deg/MOM_input
H_WET = 1e-3                   # [m] a layer thinner than this is vanished


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want, where=None):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    if where is not None:
        d = d * where
    return float(d.max() / max(np.abs(want).max(), 1e-300))


def _assert_same_tensors(mine, loaded):
    """Every tensor field bitwise equal, every other field equal."""
    for name, t in tensor_fields(loaded).items():
        got = getattr(mine, name)
        assert got is not None and got.dtype == t.dtype, name
        assert torch.equal(got, t), name
    for f in dataclasses.fields(loaded):
        a, b = getattr(mine, f.name), getattr(loaded, f.name)
        if not torch.is_tensor(b):
            assert a == b, f.name


def _assert_same_model(ms, ms_ref):
    """The port's ModelSetup against the reference's, carried across."""
    loaded = interop.load_all(*(interop.export(o) for o in (
        ms_ref.grid, ms_ref.vgrid, ms_ref.state, ms_ref.params,
        ms_ref.forcing)), device="cpu")
    for a, b in zip((ms.grid, ms.vgrid, ms.state, ms.forcing.mech,
                     ms.forcing.buoy),
                    loaded[:3] + (loaded[4].mech, loaded[4].buoy)):
        _assert_same_tensors(a, b)
    assert ms.params == loaded[3]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory with the small mosaic (written by the reference's
    generator) and global_2deg's MOM_input."""
    d = tmp_path_factory.mktemp("small_global")
    ref_tripolar.write_mosaic(str(d), nx=NX, ny_reg=NY_REG, ny_cap=NY_CAP)
    shutil.copy(os.path.join(GLOBAL_2DEG, "MOM_input"), d / "MOM_input")
    return str(d)


@pytest.fixture(scope="module")
def small(run_dir):
    """(reference ModelSetup, port ModelSetup) of the small global model,
    each built by its own package."""
    path = os.path.join(run_dir, "MOM_input")
    ms_ref = ref_build(RefParamFile([path], text=OVERRIDES))
    ms = build_model_from_params(ParamFile([path], text=OVERRIDES),
                                 device="cpu")
    return ms_ref, ms


def flowing_inputs(st, G, seed=0):
    """T, S, u and v (float64 numpy) on the small model's state: large-scale
    T and S anomalies and 0.3 m/s velocities decaying with depth, plus
    small noise, masked like the grid."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = st.h.shape
    yy, xx = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx),
                         indexing="ij")
    decay = np.exp(-np.arange(nz) / 3.0)[:, None, None]
    m = np.asarray(G.mask2dT, np.float64)[None]
    T = np.asarray(st.T, np.float64) + (
        decay * (np.sin(np.pi * yy) * np.cos(2 * np.pi * xx))[None]
        + 0.01 * rng.standard_normal(st.h.shape)) * m
    S = np.asarray(st.S, np.float64) + (
        0.5 * decay * (np.cos(np.pi * yy) * np.sin(2 * np.pi * xx))[None]
        + 0.01 * rng.standard_normal(st.h.shape)) * m
    u = 0.3 * np.cos(np.pi * yy)[None] * decay \
        * np.asarray(G.mask2dCu, np.float64)[None]
    v = 0.3 * np.sin(2 * np.pi * xx)[None] * decay \
        * np.asarray(G.mask2dCv, np.float64)[None]
    return dict(T=T, S=S, u=u, v=v)


def mixed_top(T, mask):
    """T (numpy) with a weakly stratified top 400 m on the KPP_DZ layers:
    a mixed layer for KPP to find."""
    T = np.array(T, np.float64)
    wet = np.asarray(mask) > 0.5
    T[1] = np.where(wet, T[0] - 0.02, T[1])
    T[2] = np.where(wet, T[0] - 0.1, T[2])
    return T


def kpp_states(ms_ref, ms, flowing_pair):
    """The flowing states on the KPP_DZ layers, clipped to the
    bathymetry, with mixed_top's T and the models' zero kv_shear:
    (reference, port)."""
    from mom6_tpu.core.state import init_state_resting as ref_init
    from mom6_tpu_torch.core.state import init_state_resting
    st_ref, st = flowing_pair
    T = mixed_top(st.T.double().numpy(), ms.grid.mask2dT.numpy())
    h_ref = ref_init(ms_ref.grid, ms_ref.vgrid, np.array(KPP_DZ)).h
    h = init_state_resting(ms.grid, ms.vgrid, np.array(KPP_DZ)).h
    return (st_ref.replace(h=h_ref, T=jnp.asarray(T, jnp.float32),
                           kv_shear=ms_ref.state.kv_shear),
            st.replace(h=h, T=torch.tensor(T, dtype=torch.float32),
                       kv_shear=ms.state.kv_shear))


@pytest.fixture(scope="module")
def flowing(small):
    """The small model from a flowing state in both packages: (reference
    state, port state) as float32."""
    ms_ref, ms = small
    x = flowing_inputs(ms_ref.state, ms_ref.grid)
    st_ref = ms_ref.state.replace(**{k: jnp.asarray(a, jnp.float32)
                                     for k, a in x.items()})
    st = ms.state.replace(**{k: torch.tensor(a, dtype=torch.float32)
                             for k, a in x.items()})
    return st_ref, st


# --- grid generator, files, mosaic grid --------------------------------------

@pytest.mark.parametrize("args", [
    dict(nx=NX, ny_reg=NY_REG, ny_cap=NY_CAP),
    dict(nx=24, ny_reg=10, ny_cap=6, lat_s=30.0, lat_join=65.0, lon_bp=100.0),
    dict(nx=15, ny_reg=6, ny_cap=4, lat_s=-60.0, lat_join=60.0, lon_bp=80.0),
], ids=["global", "cap", "odd_nx"])
def test_supergrid_and_topography_equal_reference(args):
    want = ref_tripolar.make_tripolar_supergrid(**args)
    got = tripolar.make_tripolar_supergrid(**args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lon, lat = want["x"][1::2, 1::2], want["y"][1::2, 1::2]
    np.testing.assert_array_equal(
        tripolar.make_earth_topography(lon, lat, 4000.0),
        ref_tripolar.make_earth_topography(lon, lat, 4000.0))


def test_write_mosaic_and_read_back(run_dir, tmp_path):
    """The port writes the pair the reference's generator writes, and
    reads both back as they were."""
    sg, depth = tripolar.write_mosaic(str(tmp_path), nx=NX, ny_reg=NY_REG,
                                      ny_cap=NY_CAP)
    for fname in ("ocean_hgrid.nc", "ocean_topog.nc"):
        mine = read_nc(os.path.join(str(tmp_path), fname))
        theirs = read_nc(os.path.join(run_dir, fname))
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    back = mosaic.read_supergrid(os.path.join(str(tmp_path),
                                              "ocean_hgrid.nc"))
    for k in ("x", "y", "dx", "dy", "area"):
        np.testing.assert_array_equal(back[k], sg[k])
    assert 0.5 < (depth > 0).mean() < 0.8


def test_read_supergrid_of_committed_global_2deg():
    path = os.path.join(GLOBAL_2DEG, "ocean_hgrid.nc")
    want = ref_mosaic.read_supergrid(path)
    got = mosaic.read_supergrid(path)
    assert got["x"].shape == (201, 361)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fold", [True, False])
def test_mosaic_grid_equals_reference(fold):
    sg = ref_tripolar.make_tripolar_supergrid(NX, NY_REG, NY_CAP)
    depth = ref_tripolar.make_earth_topography(
        sg["x"][1::2, 1::2], sg["y"][1::2, 1::2], 4000.0)
    kw = dict(min_depth=0.5, cyclic_x=True, fold_north=fold)
    want = interop.load_grid(interop.export(
        ref_mosaic.build_grid_from_supergrid(sg, depth, **kw)), device="cpu")
    got = mosaic.build_grid_from_supergrid(sg, depth, device="cpu", **kw)
    _assert_same_tensors(got, want)
    if fold:
        # the fold line's faces connect each column to its image
        assert torch.equal(got.mask2dCv[-1], got.mask2dCv[-1].flip(0))
    else:
        assert not got.mask2dCv[-1].any()


def test_mosaic_grid_rejects_inconsistent_shapes():
    sg = tripolar.make_tripolar_supergrid(8, 4, 2)
    with pytest.raises(ValueError, match="depth shape"):
        mosaic.build_grid_from_supergrid(sg, np.ones((5, 8)), device="cpu")


# --- parameter file ------------------------------------------------------------

def test_param_file_matches_reference():
    """Typed reads, comments, the last assignment and #override, text
    after files."""
    text = ("A = 1 ! comment\nB = 2.5d-1\nC = True\nD = 'x y'\n"
            "#override E = 3\nE = 4\nA = 7\nL = 1.0, 2.0,3\n")
    path = os.path.join(GLOBAL_2DEG, "MOM_input")
    for cls in (RefParamFile, ParamFile):
        pf = cls([path], text=text)
        assert pf.get("A", int) == 7
        assert pf.get("B", float) == 0.25
        assert pf.get("C", bool) is True
        assert pf.get("D", str) == "x y"
        assert pf.get("E", int) == 3
        assert pf.get_list("L") == [1.0, 2.0, 3.0]
        assert pf.get("NIGLOBAL", int) == 180
        assert pf.get("MISSING", float, default=2.0) == 2.0
        with pytest.raises(KeyError):
            pf.get("MISSING2", float)
        with pytest.raises(ValueError, match="read twice"):
            pf.get("A", str)
        assert "DAYMAX" in pf.unused_params()


# --- build_model_from_params ----------------------------------------------------

def test_build_small_global_equals_reference(small):
    ms_ref, ms = small
    G = ms.grid
    assert G.fold_north and G.cyclic_x and (G.nx, G.ny) == (NX, NY)
    assert 0.5 < float(G.mask2dT.mean()) < 0.8
    assert ms.params.gm == GMParams(khth=1000.0) and ms.params.khtr == 500.0
    _assert_same_model(ms, ms_ref)


def test_build_global_2deg_equals_reference():
    """configs/global_2deg with USE_KPP = False, field by field (build
    only): grid, vertical grid, initial T and S on the clipped resting
    state, the global wind, the SST restoring, every parameter."""
    path = os.path.join(GLOBAL_2DEG, "MOM_input")
    ms_ref = ref_build(RefParamFile([path], text="USE_KPP = False"))
    ms = build_model_from_params(ParamFile([path], text="USE_KPP = False"),
                                 device="cpu")
    assert (ms.grid.nx, ms.grid.ny, ms.vgrid.nz) == (180, 100, 20)
    assert ms.params.dyn.bt.nstep == ms_ref.params.dyn.bt.nstep > 1
    _assert_same_model(ms, ms_ref)
    # the profiles are what the file asks for
    wet = ms.grid.mask2dT > 0.5
    assert float(ms.forcing.buoy.t_restore.max()) <= 27.0
    assert float(ms.forcing.buoy.t_restore.min()) >= -1.0
    assert float(ms.forcing.mech.taux[wet].abs().max()) <= 0.14 + 1e-6
    assert float(ms.state.T[0].max()) == pytest.approx(8.0 + 12.0 * 0.475)


def test_build_global_2deg_as_committed_equals_reference():
    """configs/global_2deg as committed (KPP on): the KPP switch and the
    boundary-layer viscosity kv_shear, allocated zero (nz+1, ny, nx),
    field by field as the reference builds them."""
    path = os.path.join(GLOBAL_2DEG, "MOM_input")
    ms_ref = ref_build(RefParamFile([path]))
    ms = build_model_from_params(ParamFile([path]), device="cpu")
    assert ms.params.diabatic.boundary_layer_scheme == "KPP"
    assert not ms.params.diabatic.use_shear_mixing
    assert tuple(ms.state.kv_shear.shape) == (21, 100, 180)
    assert not ms.state.kv_shear.any()
    _assert_same_model(ms, ms_ref)


def test_missing_mosaic_is_generated_in_memory(run_dir, small, tmp_path,
                                               monkeypatch):
    """Where the run directory holds no grid files, the pair comes from
    the generator and equals the one read from files; a size that
    config_driver has no generator arguments for raises."""
    shutil.copy(os.path.join(run_dir, "MOM_input"), tmp_path / "MOM_input")
    path = str(tmp_path / "MOM_input")
    with pytest.raises(FileNotFoundError):
        build_model_from_params(ParamFile([path], text=OVERRIDES),
                                device="cpu")
    monkeypatch.setitem(config_driver._GENERATED, (NX, NY),
                        dict(nx=NX, ny_reg=NY_REG, ny_cap=NY_CAP))
    ms = build_model_from_params(ParamFile([path], text=OVERRIDES),
                                 device="cpu")
    _assert_same_tensors(ms.grid, small[1].grid)
    assert sorted(os.listdir(tmp_path)) == ["MOM_input"]
    assert config_driver._GENERATED[(720, 400)] == dict(
        nx=720, ny_reg=336, ny_cap=64)


# the ids "epbl", "jackson", "varmix", "grid", "wind" and "ale" keep their
# names; ePBL, the bulk mixed layer, the spherical grid, every WIND_CONFIG,
# HYCOM1, neutral diffusion, the internal tides, ADAPTIVE, JHL, VarMix,
# the ice shelf, the linear buoyancy forcing, the boundary-layer lateral
# diffusion, double diffusion, convection, the Zanna-Bolton closure, the
# porous barriers, the interface filter, the Stanley correction, the
# harmonic SAL, SKEB, the tidal forcing, every remapping scheme, every
# coordinate, SPLIT_RK2B and BT_WIDE_HALO (on ranks,
# tests/test_torch_mesh.py) are ported, so they hold BT_WIDE_HALO (with
# other values, AUTO, and beside a new scheme or HYBGEN) off a mesh, as
# builds the reference's (no exception), and a topography still to port
@pytest.mark.parametrize("text,exc,match", [
    ("BT_WIDE_HALO = -1", None, None),
    ("BT_WIDE_HALO = 4", None, None),
    ("REMAPPING_SCHEME = PPM_H6\nBT_WIDE_HALO = 2", None, None),
    ("REMAPPING_SCHEME = P3M_H4\nBT_WIDE_HALO = 8", None, None),
    ("TOPO_CONFIG = spoon", NotImplementedError, "TOPO_CONFIG"),
    ("REGRIDDING_COORDINATE_MODE = HYBGEN\nBT_WIDE_HALO = 6", None, None),
    ("NO_SUCH_KEY = 1", ValueError, "NO_SUCH_KEY"),
], ids=["epbl", "jackson", "varmix", "grid", "wind", "ale", "unknown"])
def test_build_rejects_what_is_not_ported(run_dir, text, exc, match):
    """What the port lacks raises naming itself; a ported option (no
    exception) builds the reference's model, BT_WIDE_HALO's width read."""
    path = os.path.join(run_dir, "MOM_input")
    over = OVERRIDES.replace("USE_KPP = False\n", "") + text + "\n"
    if exc is None:
        ms = build_model_from_params(ParamFile([path], text=over),
                                     device="cpu")
        _assert_same_model(ms, ref_build(RefParamFile([path], text=over)))
        width = int(text.split("BT_WIDE_HALO = ")[1])
        assert ms.params.dyn.bt.wide_halo == width
        return
    with pytest.raises(exc, match=match):
        build_model_from_params(ParamFile([path], text=over), device="cpu")


def test_build_defaults_to_the_card(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pf = ParamFile([os.path.join(run_dir, "MOM_input")], text=OVERRIDES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model_from_params(pf)


# --- operators on the fold grid with land -------------------------------------

def _fields(ms_ref, seed):
    """Thicknesses with vanished layers over the topography, T, S and
    velocities on the small model's grid."""
    rng = np.random.default_rng(seed)
    h = np.asarray(ms_ref.state.h, np.float64)
    wet = h > 1.0
    h = np.where(wet, h * (1.0 + 0.2 * rng.uniform(-1, 1, h.shape)), h)
    shape = h.shape
    zc = np.cumsum(h, 0) - 0.5 * h
    T = 2.0 + 18.0 * np.exp(-zc / 1000.0) + rng.standard_normal(shape)
    S = 34.0 + 1.5 * rng.uniform(0, 1, shape)
    mu = np.asarray(ms_ref.grid.mask2dCu)[None]
    mv = np.asarray(ms_ref.grid.mask2dCv)[None]
    return {k: a.astype(np.float32) for k, a in dict(
        h=h, T=T, S=S, u=0.3 * rng.standard_normal(shape) * mu,
        v=0.3 * rng.standard_normal(shape) * mv).items()}


def test_isopycnal_slopes_parity(small):
    ms_ref, ms = small
    x = _fields(ms_ref, 1)
    want = ref_slopes(*(jnp.asarray(x[k]) for k in "hTS"), ms_ref.grid,
                      ms_ref.vgrid, ref_get_eos("WRIGHT"))
    got = isopycnal_slopes(*(_t(x[k]) for k in "hTS"), ms.grid, ms.vgrid,
                           get_eos("WRIGHT"))
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_OP
    assert float(got[1][:, -1].abs().max()) > 0.0     # across the fold


@pytest.mark.parametrize("mode", ["neutral", "layered", "khth_2d"])
def test_thickness_diffuse_parity(small, mode):
    """GM with the neutral slopes of T, S and the Wright EOS (what
    step_mom runs under z*), with the coordinate's interface slopes, and
    with a 2-D coefficient."""
    ms_ref, ms = small
    x = _fields(ms_ref, 2)
    dt = 3600.0
    kw_r, kw_t = {}, {}
    if mode != "layered":
        kw_r = dict(T=jnp.asarray(x["T"]), S=jnp.asarray(x["S"]),
                    eos=ref_get_eos("WRIGHT"))
        kw_t = dict(T=_t(x["T"]), S=_t(x["S"]), eos=get_eos("WRIGHT"))
    if mode == "khth_2d":
        k2 = (800.0 + 400.0 * np.random.default_rng(3).uniform(
            0, 1, (NY, NX))).astype(np.float32)
        kw_r["khth_2d"], kw_t["khth_2d"] = jnp.asarray(k2), _t(k2)
    want = ref_thickness_diffuse(jnp.asarray(x["h"]), ms_ref.grid,
                                 ms_ref.vgrid, dt, RefGMParams(khth=1000.0),
                                 **kw_r)
    got = thickness_diffuse(_t(x["h"]), ms.grid, ms.vgrid, dt,
                            GMParams(khth=1000.0), **kw_t)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_OP
    h_new, uhd, vhd = got
    assert float(vhd[:, -1].abs().max()) > 0.0        # across the fold
    # the bolus transport of a column sums to zero up to its limiter
    area = ms.grid.areaT.double() * ms.grid.mask2dT.double()
    v0 = float((_t(x["h"]).double() * area).sum())
    assert abs(float((h_new.double() * area).sum()) - v0) <= 1e-6 * v0


@pytest.mark.parametrize("n_sub,khtr", [(1, 500.0), (3, "map")])
def test_tracer_hordiff_parity(small, n_sub, khtr):
    ms_ref, ms = small
    x = _fields(ms_ref, 4)
    tr = np.stack([x["T"], x["S"]])
    if khtr == "map":
        khtr = (300.0 + 400.0 * np.random.default_rng(5).uniform(
            0, 1, (NY, NX))).astype(np.float32)
        k_r, k_t = jnp.asarray(khtr), _t(khtr)
    else:
        k_r = k_t = khtr
    dt = 86400.0
    want = ref_hordiff(jnp.asarray(tr), jnp.asarray(x["h"]), k_r, dt,
                       ms_ref.grid, n_sub=n_sub)
    got = tracer_hordiff(_t(tr), _t(x["h"]), k_t, dt, ms.grid, n_sub=n_sub)
    assert _rel(got - _t(tr), np.asarray(want, np.float64) - tr) <= 1e-3
    assert _rel(got, want) <= TOL_OP
    # flux form: the tracer content is conserved, across the fold too
    vol = (_t(x["h"]) * ms.grid.areaT * ms.grid.mask2dT).double()
    for i in range(2):
        c0 = float((_t(tr[i]).double() * vol).sum())
        assert abs(float((got[i].double() * vol).sum()) - c0) <= 1e-6 * c0


@pytest.mark.parametrize("op", ["coriolis_adv", "pressure_force_fv",
                                "horizontal_viscosity", "advect_tracers",
                                "ale_regrid_remap"])
def test_operator_parity_on_the_fold_grid(small, flowing, op):
    """The operators of the thermo cycle on a grid with a fold, land, a
    cyclic x axis and metrics that differ in x and y."""
    ms_ref, ms = small
    x = _fields(ms_ref, 6)
    J = {k: jnp.asarray(a) for k, a in x.items()}
    P = {k: _t(a) for k, a in x.items()}
    Gr, GVr, Gt, GVt = ms_ref.grid, ms_ref.vgrid, ms.grid, ms.vgrid
    rng = np.random.default_rng(7)
    # transports of up to a fifth of the smaller neighbour's volume
    vol = _t(x["h"] * np.asarray(Gr.areaT)[None])
    uh = (0.2 * rng.uniform(-1, 1, vol.shape)
          * torch.minimum(vol, stencil.ip1(vol)).numpy()
          * np.asarray(Gr.mask2dCu)[None]).astype(np.float32)
    vh = (0.2 * rng.uniform(-1, 1, vol.shape)
          * torch.minimum(vol, stencil.jp1(vol, "h")).numpy()
          * np.asarray(Gr.mask2dCv)[None]).astype(np.float32)
    wet = None
    if op == "coriolis_adv":
        want = ref_coradv(J["u"], J["v"], J["h"], jnp.asarray(uh / 3600.0),
                          jnp.asarray(vh / 3600.0), Gr, GVr)
        got = coriolis_adv(P["u"], P["v"], P["h"], _t(uh / 3600.0),
                           _t(vh / 3600.0), Gt, GVt)
    elif op == "pressure_force_fv":
        want = ref_pf_fv(J["h"], J["T"], J["S"], Gr, GVr,
                         ref_get_eos("WRIGHT"), plm_ts=True)
        got = pressure_force_fv(P["h"], P["T"], P["S"], Gt, GVt,
                                get_eos("WRIGHT"), plm_ts=True)
    elif op == "horizontal_viscosity":
        want = ref_hor_visc(J["u"], J["v"], J["h"], Gr,
                            ms_ref.params.hor_visc)
        got = horizontal_viscosity(P["u"], P["v"], P["h"], Gt,
                                   ms.params.hor_visc)
    elif op == "advect_tracers":
        tr = np.stack([x["T"], x["S"]])
        want = ref_advect(jnp.asarray(tr), J["h"], jnp.asarray(uh),
                          jnp.asarray(vh), Gr, n_sub=3)
        got = advect_tracers(_t(tr), P["h"], _t(uh), _t(vh), Gt, n_sub=3)
        wet = (np.asarray(want[1]) > H_WET)[None]
        want, got = want[:1], got[:1]
    else:
        st_ref, st = flowing
        st_ref = st_ref.replace(h=J["h"])
        st = st.replace(h=P["h"])
        w_st, _ = ref_ale(st_ref, Gr, GVr, ms_ref.params.ale)
        g_st, _ = ale_regrid_remap(st, Gt, GVt, ms.params.ale)
        wet = np.asarray(w_st.h) > H_WET
        for k in ("h", "u", "v"):
            assert _rel(getattr(g_st, k), getattr(w_st, k)) <= TOL_OP, k
        want = (w_st.T, w_st.S)
        got = (g_st.T, g_st.S)
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or not torch.is_tensor(g):
            continue
        assert _rel(g, w, wet) <= TOL_OP, (op, i)


# --- the slice -------------------------------------------------------------------

def test_step_mom_one_cycle_f32(small, flowing):
    """One thermo cycle (2 baroclinic steps, GM, 3 advection sub-sweeps,
    KHTR, restoring, z* remap) of the small global model.  T and S are
    compared as anomalies from T_REF and S_REF where the layer holds
    water; the test also checks that leaving any field as it was would
    miss 1e-4 by at least 10x, that land columns of T stay as they were to
    the bit, and that the volume is conserved."""
    ms_ref, ms = small
    st_ref, st = flowing
    with jax.disable_jit():
        after = ref_step_mom(st_ref, ms_ref.forcing, ms_ref.grid,
                             ms_ref.vgrid, ms_ref.params)
    with torch.inference_mode():
        got = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params)
    wet = np.asarray(after.h) > H_WET
    for k, rest, where in (("h", 0.0, None), ("u", 0.0, None),
                           ("v", 0.0, None), ("T", T_REF, wet),
                           ("S", S_REF, wet)):
        want = np.asarray(getattr(after, k), np.float64) - rest
        err = _rel(getattr(got, k).double() - rest, want, where)
        assert err <= TOL_SLICE, (k, err)
        unchanged = _rel(getattr(st, k).double() - rest, want, where)
        assert unchanged >= 10 * TOL_SLICE, (k, unchanged)
    assert not got.uhtr.any() and not got.vhtr.any()
    land = ms.grid.mask2dT[None] < 0.5
    assert torch.equal(got.T * land, st.T * land)
    area = (ms.grid.areaT * ms.grid.mask2dT).double()
    v0 = float((st.h.double() * area).sum())
    assert abs(float((got.h.double() * area).sum()) - v0) <= 1e-6 * v0
    assert -3.0 < float((got.T * ~land).min()) \
        and float((got.T * ~land).max()) < 35.0


def test_step_mom_one_cycle_with_kpp_f32(run_dir, flowing):
    """The cycle with KPP on, as configs/global_2deg commits it, on z*
    layers of 20 to 2500 m (the small model's 800 m layers would hold the
    whole boundary layer): the boundary-layer diffusivity in the column
    solve and the viscosity kv_shear it leaves for the next cycle, against
    the reference run op by op, within 1e-4."""
    path = os.path.join(run_dir, "MOM_input")
    ms_ref = ref_build(RefParamFile([path], text=KPP_OVERRIDES))
    ms = build_model_from_params(ParamFile([path], text=KPP_OVERRIDES),
                                 device="cpu")
    assert ms.params.diabatic.boundary_layer_scheme == "KPP"
    st_ref, st = kpp_states(ms_ref, ms, flowing)
    with jax.disable_jit():
        after = ref_step_mom(st_ref, ms_ref.forcing, ms_ref.grid,
                             ms_ref.vgrid, ms_ref.params)
    p_off = ms.params.replace(diabatic=dataclasses.replace(
        ms.params.diabatic, boundary_layer_scheme="NONE"))
    with torch.inference_mode():
        got = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params)
        no_kpp = step_mom(st, ms.forcing, ms.grid, ms.vgrid, p_off)
    wet = np.asarray(after.h) > H_WET
    for k, rest, where in (("h", 0.0, None), ("u", 0.0, None),
                           ("v", 0.0, None), ("T", T_REF, wet),
                           ("S", S_REF, wet), ("kv_shear", 0.0, None)):
        want = np.asarray(getattr(after, k), np.float64) - rest
        err = _rel(getattr(got, k).double() - rest, want, where)
        assert err <= TOL_SLICE, (k, err)
    # KPP mixes the surface layers: the cycle without it misses by 10x
    assert _rel(no_kpp.T.double() - T_REF, np.asarray(after.T) - T_REF,
                wet) >= 10 * TOL_SLICE
    kv = got.kv_shear
    assert float(kv[1][ms.grid.mask2dT > 0.5].max()) > 0.0
    assert not kv[0].any() and not kv[-1].any()


# the ids keep their names; neutral diffusion, the passivity, the cap, the
# boundary-layer form of the tracer diffusion, the interface filter, the
# porous barriers, the Zanna-Bolton closure, SPPT, SKEB, the harmonic SAL,
# the HYBGEN coordinate, the RK2b scheme and the wide-halo subcycle (on
# ranks, tests/test_torch_mesh.py) are ported, so they hold the wide halo
# (AUTO and fixed) off a mesh, where it is off (the case that held HYBGEN
# holds the wide halo alone: HYBGEN's densities are set at build time,
# test_build_rejects_what_is_not_ported's "ale")
@pytest.mark.parametrize("change,match", [
    pytest.param(lambda p: p.replace(dyn=p.dyn.replace(
        bt=p.dyn.bt.replace(wide_halo=-1))), "wide-halo",
        id="khtr_passivity_coeff-1.0"),
    pytest.param(lambda p: p.replace(dyn=p.dyn.replace(
        bt=p.dyn.bt.replace(wide_halo=4))), "wide-halo",
        id="khtr_max-100.0"),
    pytest.param(lambda p: p.replace(dyn=p.dyn.replace(
        bt=p.dyn.bt.replace(wide_halo=2))), "wide-halo",
        id="neutral_diffusion-True")])
def test_step_mom_unported_tracer_diffusion_raises(small, change, match):
    """A cycle of the small tripolar model with the wide halo set equals
    the cycle without it to the bit (``match`` names the subcycle the
    case holds)."""
    from torch_widehalo import assert_step_ignores_wide_halo
    _, ms = small
    p = change(ms.params)
    assert match == "wide-halo" and p.dyn.bt.wide_halo != 0
    assert_step_ignores_wide_halo(
        lambda q: step_mom(ms.state, ms.forcing, ms.grid, ms.vgrid, q), p,
        p.dyn.bt.wide_halo, ("h", "u", "v", "T", "S"))


# --- the fold, held to the physics ---------------------------------------------

def test_fold_exactness_and_conservation():
    """The twin of the reference's tests/test_global_tripolar.py::
    test_fold_exactness_and_conservation on a 48x22 cap, 40 steps.
    Without rotation a mirror-symmetric state evolves mirror-symmetric
    to the bit (operations on mirrored operands round alike, so any
    asymmetry is a fault of the fold's wiring), the fold line's v row stays
    antisymmetric, volume is conserved across the fold, and the bump does
    cross it."""
    G, GV, s, params, eta0 = polar_cap_bump(48, 12, 10, device="cpu")
    assert G.mask2dT[-1].sum() > 0.8 * G.nx
    area = (G.areaT * G.mask2dT).double()
    m0 = float((s.h.double() * area).sum())
    with torch.inference_mode():
        for _ in range(40):
            s = step_dynamics_split_rk2(s, MechForcing(), G, GV, params)
    assert bool(torch.isfinite(s.h).all())
    m1 = float((s.h.double() * area).sum())
    assert abs(m1 - m0) / m0 < 1e-6
    eta1 = ((s.h.double().sum(0) - G.bathyT.double()) * G.mask2dT).numpy()
    assert np.abs(eta1 - eta1[:, ::-1]).max() == 0.0
    v = s.v.double().numpy()[0, -1, :]
    assert np.abs(v + v[::-1]).max() < 1e-8
    assert eta1.max() < 0.8 * eta0.max()
