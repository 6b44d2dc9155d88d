"""The port on a mesh of ranks (parallel/mesh.py), against one rank.

The twins of the reference's tests/test_sharding.py,
tests/test_bt_widehalo.py and the mesh half of
tests/test_ensemble_spherical.py, through the port on gloo ranks on the
CPU.  One group of four ranks serves the whole file (tests/
torch_mesh_ranks.py: a free port chosen at run time, one torch thread a
rank); the meshes are 1x1 on rank 0, 1x2 and 2x1 on ranks 0-1 and 2x2
on all four, and every model is built whole from a seed and cut into
tiles (tests/torch_mesh_tasks.py).

* Layout invariance, to the bit in float32 and float64, with one rank
  and with the port off any mesh: the double gyre's step
  (::test_layout_invariance, 16x16x2, dt 1200), the 64x64x8 thermo gyre
  with KPP, shear mixing, GM, MEKE, neutral diffusion and KHTR through
  step_mom (::test_full_physics_step_layout_invariance, which the
  reference holds to ~1e-5 only), its ocean.stats on the device and the
  host path (::test_stats_bitwise_across_meshes), and a thermo cycle of
  the 32x24x5 tripolar model of test_torch_global.py across the fold.
  The reference's own gates compare GSPMD programs; here each tile runs
  the same operations on the same numbers as the whole field.
* The CUDA PPM passes' tile launches (halos, the kernel's HALO form and
  the fold across ranks), with the plain versions standing in for the
  kernels here (tests/test_torch_cuda.py and chip_smoke.py hold the
  kernels to them on the card), to the bit against the whole field.
* The eight wide-halo tests on the 2x2 mesh (the reference's 2x4 mesh
  on 64x64 has 32x16 shards; 2x2 gives 32x32 tiles): the walled basin,
  the reentrant channel, the linear transports and the tripolar fold
  against the dense path to the bit, with fewer exchanges (the reference
  holds its wide halo to 3e-6: it zeroes the rims at walls and lets the
  fold's mirrored rows evolve on their own; here the rims take the
  ring's cells and the top rank row marches its fold partner's tile),
  and a thermo cycle of the tripolar model with AUTO; the
  undersized halo refused naming ``wide_halo``; AUTO's width equal to
  the reference's; AUTO against dense; the W/R envelope.
* The ensemble over ranks (4 members each on one rank, 2 members each on
  a 1x2 and a 2x1 mesh) and one EAKF analysis over ranks, to the bit
  with one process.
* Every step_mom option on ranks (SAL_HARMONICS with the tides,
  HOMOGENIZE_FORCINGS, ICE_SHELF, the SSA solve, SPPT, SKEB across the
  fold, the open boundaries of kelvin, dome and tidal_bay), the restart
  between layouts and a run split on ranks, the diag_table's written
  variables and the truncation dossier, each on the 2x2 mesh to the
  bit with one rank, in f32 and f64; the quarter turn refused on a
  tile; the builder on a mesh and run_segment's stats on a mesh.

Inputs are made with numpy from seeds; the ensemble members differ by
their winds, as in the reference.  Time: see CHANGES.md.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_mesh_ranks import Ranks  # noqa: E402

torch.set_num_threads(1)

LAYOUTS = ((1, 1), (1, 2), (2, 1), (2, 2))
TRIPOLAR = "NIGLOBAL = 32\nNJGLOBAL = 24\nNK = 5\nUSE_KPP = False\n" \
    "TRACER_ADVECT_SUB = 3\n"
ITIDES = "INT_TIDE_DISSIPATION = True\nUTIDE = 0.15\n" \
    "INTERNAL_TIDES = True\nINTERNAL_TIDE_MODES = 2\n"


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


@pytest.fixture(scope="module")
def tripolar_dir(tmp_path_factory):
    """A run directory with the small tripolar mosaic (the port's
    generator) and configs/global_2deg's MOM_input."""
    from mom6_tpu_torch.grid import tripolar
    d = tmp_path_factory.mktemp("mesh_tripolar")
    tripolar.write_mosaic(str(d), nx=32, ny_reg=16, ny_cap=8)
    shutil.copy(os.path.join(REPO, "configs", "global_2deg", "MOM_input"),
                d / "MOM_input")
    return str(d)


def _bitwise(out, what, layouts=LAYOUTS):
    """Every layout's arrays equal to the bit to the port's own run off a
    mesh (and so to each other)."""
    want = out.pop("plain")
    assert set(out) == set(layouts)
    for layout, got in out.items():
        assert set(got) == set(want)
        for k, a in got.items():
            assert a.shape == want[k].shape, (what, layout, k)
            assert np.array_equal(a, want[k]), (
                what, layout, k, float(np.max(np.abs(a - want[k]))))


# --- the decomposition ---------------------------------------------------------

def test_import_loads_neither_jax_nor_the_reference():
    code = ("import sys, mom6_tpu_torch, mom6_tpu_torch.parallel.mesh, "
            "mom6_tpu_torch.parallel.ensemble, mom6_tpu_torch.core.bt_widehalo"
            "\nbad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mom6_tpu' or "
            "m.startswith('mom6_tpu.')]\nprint(bad)\nsys.exit(1 if bad "
            "else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_factor2d_and_auto_width_equal_reference():
    """_factor2d and auto_wide_halo equal the reference's on the shapes
    tested (the reference's reads only the mesh's shape)."""
    from mom6_tpu.core.barotropic import BTParams as RefBT
    from mom6_tpu.core.barotropic import auto_wide_halo as ref_auto
    from mom6_tpu.parallel.mesh import _factor2d as ref_factor
    from mom6_tpu_torch.core.barotropic import BTParams, auto_wide_halo
    from mom6_tpu_torch.parallel.mesh import _factor2d
    for n in range(1, 33):
        assert _factor2d(n) == ref_factor(n), n
    for shape in ((1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 4)):
        for grid in ((64, 64), (256, 512), (8, 8), (400, 720), (24, 32)):
            for r in (1, 2, 3):
                ref = types.SimpleNamespace(
                    shape={"y": shape[0], "x": shape[1]})
                got = auto_wide_halo(BTParams(
                    nstep=24, nfilter=8, wide_halo=-1,
                    halo_per_substep=r), grid, shape)
                want = ref_auto(RefBT(nstep=24, nfilter=8, wide_halo=-1,
                                      mesh=ref, halo_per_substep=r), grid)
                assert got == want, (shape, grid, r)
    assert auto_wide_halo(BTParams(nstep=24, nfilter=8, wide_halo=-1),
                          (64, 64)) == 0


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_layout_invariance(ranks, dt):
    """The double gyre's step on 1, 2 (1x2, 2x1) and 4 ranks."""
    _bitwise(ranks.run("torch_mesh_tasks:double_gyre_step", dt)[0],
             "double_gyre")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_full_physics_step_layout_invariance(ranks, dt):
    """step_mom of the 64x64x8 full-physics thermo gyre."""
    _bitwise(ranks.run("torch_mesh_tasks:full_physics_step", dt)[0],
             "full_physics")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_stats_bitwise_across_meshes(ranks, dt):
    """mass, KE, APE, energy, max_CFL, salt and heat of the full-physics
    state, on the device path (fixed_point_sum's limbs all-reduced) and
    on the host path (reproducing_sum's limbs all-reduced)."""
    out = ranks.run("torch_mesh_tasks:stats", dt)[0]
    want = out.pop("plain")
    for layout, got in out.items():
        for path in ("dev", "host"):
            for k in ("mass", "KE", "APE", "energy", "max_CFL", "salt",
                      "heat"):
                assert got[path][k] == want[path][k], (layout, path, k)
    assert want["dev"]["max_CFL"] > 0.0 and want["host"]["APE"] > 0.0


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_tripolar_step_layout_invariance(ranks, tripolar_dir, dt):
    """A thermo cycle of the 32x24x5 tripolar model from a flowing state:
    the fold crosses the ranks on 1x2 and 2x2."""
    _bitwise(ranks.run("torch_mesh_tasks:tripolar_step", dt, tripolar_dir,
                       TRIPOLAR)[0], "tripolar")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_tripolar_internal_tides_layout_invariance(ranks, tripolar_dir, dt):
    """The same cycle with the low-mode internal tides: their southward
    flux crosses the rank rows, and only the bottom rank row holds the
    tripolar grid's southern wall."""
    out = ranks.run("torch_mesh_tasks:tripolar_step", dt, tripolar_dir,
                    TRIPOLAR + ITIDES, ("En_itide",))[0]
    plain = out["plain"]["En_itide"]
    assert np.abs(plain[..., 11:13, :]).max() > 0.0
    _bitwise(out, "internal tides")


@pytest.mark.parametrize("fold,monotonic,simple_2nd", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, False, True)], ids=["wrap", "fold", "fold-cw84", "fold-simple"])
def test_ppm_tile_launches(ranks, fold, monotonic, simple_2nd):
    """The PPM passes' tile launches (x and y, edges, flux and its Newton
    form) on every layout against the whole field, float64."""
    _bitwise(ranks.run("torch_mesh_tasks:ppm_tiles", "f64", fold,
                       monotonic, simple_2nd)[0], "ppm")


def test_quarter_turn_refused_on_ranks(ranks):
    """The quarter turn of framework/array_transform.py turns whole
    fields: on a tile it raises, naming itself."""
    for msg in ranks.run("torch_mesh_tasks:quarter_turn_refused"):
        assert msg is not None and "quarter turn" in msg


def test_build_on_a_mesh(ranks, tripolar_dir):
    """make_mesh() lays the four ranks out 2x2 (row-major), and
    build_model_from_params(mesh=...) gives each rank the tile of the
    whole build (BT_WIDE_HALO = -1 read)."""
    out = ranks.run("torch_mesh_tasks:build_on_mesh", tripolar_dir,
                    TRIPOLAR + "BT_WIDE_HALO = -1\n")
    for rank, r in enumerate(out):
        py, px = divmod(rank, 2)
        assert r == dict(same=True, shape=(5, 12, 16), width=-1,
                         layout=(2, 2), tile=(py, px),
                         bounds=(12 * py, 12 * py + 12, 16 * px,
                                 16 * px + 16))


def test_run_segment_stats_on_ranks(ranks, tmp_path):
    """run_segment on the 2x2 mesh writes one rank's ocean.stats lines."""
    out = ranks.run("torch_mesh_tasks:run_segment_stats", str(tmp_path))[0]
    assert out["ranks"] == out["one"] and len(out["one"].splitlines()) >= 2


# --- BT_WIDE_HALO (the reference's tests/test_bt_widehalo.py) -------------------

def _widehalo(ranks, case, wide_halo, R=2):
    return ranks.run("torch_mesh_tasks:widehalo", case, wide_halo, R)[0]


def _assert_wide_equals_dense(out):
    """The wide halo and the mesh's dense path equal one rank off a mesh
    to the bit, with fewer exchanges."""
    one = out["dense1"]
    for name in ("dense", "wide"):
        for k, a in out[name].items():
            assert np.array_equal(a, one[k]), (name, k)
    assert out["wide_exchanges"] < out["dense_exchanges"]
    assert np.abs(one["eta_out"]).max() > 0.0


def test_widehalo_matches_dense_walled_basin(ranks):
    """Walled basin, beta plane, BT_cont and drag; also against the
    reference's dense btstep (float32, 1e-4 of max-abs, the port's
    btstep parity)."""
    import jax.numpy as jnp
    from mom6_tpu.core.barotropic import BTParams as RefBT
    from mom6_tpu.core.barotropic import btstep as ref_btstep
    from mom6_tpu.core.continuity_ppm import set_bt_cont as ref_bt_cont
    from mom6_tpu.grid.grid import build_cartesian_grid as ref_grid
    from mom6_tpu.grid.vertical import build_layered_vgrid as ref_vgrid
    import torch_mesh_tasks as tasks
    out = _widehalo(ranks, "walled", 8)
    _assert_wide_equals_dense(out)
    G = ref_grid(ny=64, nx=64, len_lon_km=1000.0, len_lat_km=1000.0,
                 max_depth=1000.0, f0=6e-5, beta=2e-11)
    GV = ref_vgrid(3)
    Gt, GVt, _, _ = tasks.bt_grid("walled", torch.float32)
    s = {k: jnp.asarray(v.numpy())
         for k, v in tasks.bt_inputs(Gt, GVt, 3, 1000.0,
                                     torch.float32).items()}
    ref = ref_btstep(
        s["u"], s["v"], s["eta"], s["accel_u"], s["accel_v"], s["h"],
        jnp.zeros_like(s["u"]), jnp.zeros_like(s["v"]), s["visc_rem_u"],
        s["visc_rem_v"], s["pbce"], 0.5 * s["eta"], 900.0, G, GV,
        RefBT(nstep=24, nfilter=8, bebt=0.2, use_bt_cont=True,
              lin_drag=1e-4, cdrag=0.003),
        bt_cont=ref_bt_cont(s["h"], 900.0, G, GV))
    for k, a in out["wide"].items():
        want = np.asarray(getattr(ref, k))
        err = np.max(np.abs(a - want)) / (np.max(np.abs(want)) + 1e-30)
        assert err < 1e-4, (k, err)


def test_widehalo_matches_dense_reentrant_channel(ranks):
    """Reentrant-x channel: the x rim rides the periodic exchange."""
    _assert_wide_equals_dense(_widehalo(ranks, "channel", 8))


def test_widehalo_matches_dense_linear_transports(ranks):
    """Linear transports (no BT_cont) and a wind stress."""
    _assert_wide_equals_dense(_widehalo(ranks, "linear", 8))


def test_widehalo_matches_dense_tripolar_fold(ranks):
    """The tripolar cap with two continents at the fold: the fold rim
    (the mirrored partner rows, the BT_cont curves' E/W swap) crosses
    both tile boundaries of the top rank row and the bipolar seam."""
    _assert_wide_equals_dense(_widehalo(ranks, "fold", 8))


def test_widehalo_tripolar_cycle(ranks, tripolar_dir):
    """A thermo cycle of the 32x24x5 tripolar model with BT_WIDE_HALO AUTO
    (width 6 on 12x16 tiles) equals the dense path on the 2x2 mesh to the
    bit: the top rank row marches its fold partner's tile beside its own,
    so the fold line reads the partner's current row at every shift (the
    model's fold line is not single-valued, ROADMAP queue 3)."""
    out = ranks.run("torch_mesh_tasks:widehalo_cycle", tripolar_dir,
                    TRIPOLAR + "BT_WIDE_HALO = -1\n")[0]
    for k, a in out["wide"].items():
        assert np.array_equal(a, out["dense"][k]), k
    assert out["wide_exchanges"] < out["dense_exchanges"]


def test_widehalo_rejects_undersized_halo(ranks):
    out = _widehalo(ranks, "undersized", 2)
    assert out["wide"][0] == "ValueError" and "wide_halo" in out["wide"][1]
    out = _widehalo(ranks, "undersized", 40)
    assert out["wide"][0] == "ValueError" and "shard" in out["wide"][1]


def test_auto_wide_halo_selection(ranks):
    """AUTO (-1): off without a mesh and on one rank, a positive even
    width aiming at ~8 substeps an exchange on a real mesh, capped by the
    tile (the reference's own cases, on its 2x4 layout)."""
    run = lambda *a: ranks.run("torch_mesh_tasks:auto_width", *a)[0]  # noqa
    assert run(None, (64, 64)) == 0
    assert run((1, 1), (64, 64)) == 0
    assert run((2, 4), (64, 64)) == 8
    assert run((2, 4), (256, 512)) == 16
    assert run((2, 4), (8, 8)) == 0
    assert run((2, 4), (256, 512), 3) == 24
    assert run((2, 2), (64, 64)) == 16


def test_auto_matches_dense(ranks):
    """AUTO through btstep on the 2x2 mesh (width 16)."""
    _assert_wide_equals_dense(_widehalo(ranks, "auto", -1))


def test_w_r_boundary_envelope(ranks):
    """W = 2R is the smallest width (E = 2), an odd W above it leaves a
    rim cell unused, W < 2R raises, R = 3 consumes the rim faster."""
    _assert_wide_equals_dense(_widehalo(ranks, "envelope", 4, 2))
    _assert_wide_equals_dense(_widehalo(ranks, "envelope", 5, 2))
    for w in (3, 2):
        out = _widehalo(ranks, "envelope", w, 2)
        assert out["wide"][0] == "ValueError" and \
            "wide_halo" in out["wide"][1]
    _assert_wide_equals_dense(_widehalo(ranks, "envelope", 6, 3))


# --- the ensemble over ranks (the reference's test_ensemble_spherical.py) ------

def _members_equal(out):
    for key, ref in (("ranks", "one"), ("ranks_mean", "one_mean")):
        for k, a in out[key].items():
            assert np.array_equal(a, out[ref][k]), (key, k)


def test_ensemble_sharded_over_devices(ranks):
    """Four members, each on a rank of its own: one step of each and the
    members' mean, to the bit with the one-process ensemble_step."""
    out = ranks.run("torch_mesh_tasks:ensemble", "f32", 4, (1, 1))
    _members_equal(out[0])
    assert out[0]["ranks"]["h"].shape[0] == 4


@pytest.mark.parametrize("spatial", [(1, 2), (2, 1)])
def test_device_sharded_ensemble(ranks, spatial):
    """Two members, each on its own 1x2 (2x1) mesh of ranks."""
    out = ranks.run("torch_mesh_tasks:ensemble", "f32", 2, spatial)
    _members_equal(out[0])
    assert all(r["exchanges"] > 0 for r in out)


@pytest.mark.parametrize("ne,spatial,loc,infl", [
    (4, (1, 1), 4.0, 1.1), (2, (1, 2), 4.0, 1.0), (2, (2, 1), 0.0, 1.05)])
def test_eakf_analysis_on_ranks(ranks, ne, spatial, loc, infl):
    """One ODA analysis (T and S, localized or not, inflated or not) of
    the members over ranks equals the one-process analysis to the bit."""
    out = ranks.run("torch_mesh_tasks:eakf", "f64", ne, spatial, loc,
                    infl)[0]
    for k in ("dT", "dS"):
        assert np.array_equal(out["ranks"][k], out["one"][k]), k
        assert np.abs(out["one"][k]).max() > 1e-3, k


# --- every step_mom option and the host work on ranks -------------------------

OPT_LAYOUTS = ((2, 2),)
SMALL_BENCH = "NIGLOBAL = 16\nNJGLOBAL = 12\nNK = 4\n"
RESERVOIRS = "OBC_TRACER_RESERVOIR_LENGTH_SCALE_IN = 3000.0\n" \
    "OBC_TRACER_RESERVOIR_LENGTH_SCALE_OUT = 30000.0\n"
# option: (configs/<name>, or "sph" / "tripolar" for the run directories
# of the fixtures, the parameters on top, thermo cycles, state fields
# compared beside h, u, v, T, S)
OPTIONS = {
    "sal_harmonics_tides": ("sph", "TIDES = True\nSAL_HARMONICS = True\n",
                            1, ("time",)),
    "homogenize_forcings": ("benchmark",
                            SMALL_BENCH + "HOMOGENIZE_FORCINGS = True\n", 1,
                            ()),
    "ice_shelf": ("isomip", "", 1, ()),
    "sppt": ("benchmark", SMALL_BENCH + "DO_SPPT = True\n", 1,
             ("sppt_pattern", "rng_key")),
    "skeb_tripolar": ("tripolar", TRIPOLAR + "DO_SKEB = True\n", 2,
                      ("skeb_pattern", "rng_key")),
    "obc_kelvin": ("kelvin", "", 1, ()),
    "obc_dome": ("dome", RESERVOIRS, 1, ("obc_res_T", "obc_res_S")),
    "obc_tidal_bay": ("tidal_bay", "", 1, ("obc_res_T", "obc_res_S")),
}
# the restarts' model: the small benchmark with both stochastic patterns,
# so that the files carry the patterns and the threefry key
RESTART = ("benchmark", SMALL_BENCH + "DO_SPPT = True\nDO_SKEB = True\n")


@pytest.fixture(scope="module")
def sph_dir(tmp_path_factory):
    """A run directory whose MOM_input is the reference's spherical
    16x12x3 basin of its tides and SAL tests."""
    import torch_gates
    d = tmp_path_factory.mktemp("mesh_sph")
    (d / "MOM_input").write_text(torch_gates.TIDES_SPH)
    return str(d)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_on_ranks(ranks, tripolar_dir, sph_dir, option, dt):
    """Each option with whole-domain work, through step_mom on the 2x2
    mesh, to the bit with one rank (the patterns and the key
    of SPPT/SKEB, the open boundaries' tracer reservoirs and the
    tides' clock too)."""
    config, text, n, extra = OPTIONS[option]
    run_dir = {"sph": sph_dir, "tripolar": tripolar_dir}.get(config)
    out = ranks.run("torch_mesh_tasks:option_cycles", dt,
                    None if run_dir else config, text, n, extra, run_dir)[0]
    plain = out["plain"]
    for k in extra:
        assert plain[k] is not None, k
        if k.endswith("pattern"):
            assert np.abs(plain[k]).max() > 0.0, k
    _bitwise(out, option, OPT_LAYOUTS)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_ssa_solve_on_ranks(ranks, dt):
    """ssa_solve through the library API: the strain operators' shifts
    on the mesh and the CG's sums in the one-rank order."""
    out = ranks.run("torch_mesh_tasks:ssa", dt)[0]
    assert np.abs(out["plain"]["u"]).max() > 0.0
    _bitwise(out, "ssa", OPT_LAYOUTS)


def _fields_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        assert a.shape == want[k].shape, k
        assert np.array_equal(a, want[k]), (k, float(np.max(np.abs(
            a.astype(np.float64) - want[k].astype(np.float64)))))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_restart_ranks_to_one_rank(ranks, tmp_path, dt):
    """A restart written on the 2x2 mesh (whole, and with IO_LAYOUT 2,2)
    is the file one rank writes, variable by variable, and restores on
    one rank to the one-rank cycle's fields."""
    out = ranks.run("torch_mesh_tasks:restart_to_one", dt, str(tmp_path),
                    *RESTART)[0]
    assert out["same_files"]
    assert out["time"] == (1800.0, 3)
    assert {"sppt_pattern", "skeb_pattern", "rng_key"} <= set(out["names"])
    _fields_equal(out["restored"], out["want"])


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_restart_one_rank_to_ranks(ranks, tmp_path, dt):
    """A restart written on one rank (whole, and as IO_LAYOUT 2,2 tiles)
    restores on the 2x2 mesh, each rank its tile."""
    out = ranks.run("torch_mesh_tasks:restart_from_one", dt, str(tmp_path),
                    *RESTART)[0]
    _fields_equal(out["whole"], out["want"])
    _fields_equal(out["io"], out["want"])


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_split_run_on_ranks(ranks, tmp_path, dt):
    """Two cycles on the 2x2 mesh split by a restart equal two straight
    cycles on one rank."""
    out = ranks.run("torch_mesh_tasks:split_run", dt, str(tmp_path),
                    *RESTART)[0]
    _fields_equal(out["ranks"], out["one"])


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_diag_table_on_ranks(ranks, tripolar_dir, tmp_path, dt):
    """configs/global_2deg's diag_table after a cycle of the tripolar
    model: every variable the 2x2 mesh's rank 0 writes equals one rank's
    file."""
    table = os.path.join(REPO, "configs", "global_2deg", "diag_table")
    out = ranks.run("torch_mesh_tasks:diag_table", dt, tripolar_dir,
                    TRIPOLAR, table, str(tmp_path))[0]
    want = out.pop("plain")
    assert len(want["ocean_diags"]) > 20
    for layout, got in out.items():
        assert sorted(got) == sorted(want), layout
        for name in want:
            _fields_equal(got[name], want[name])


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_dossier_on_ranks(ranks, tripolar_dir, dt):
    """The truncation dossier of the flowing tripolar state: the 2x2
    mesh's rank 0's equals one rank's."""
    out = ranks.run("torch_mesh_tasks:dossier", dt, tripolar_dir,
                    TRIPOLAR)[0]
    want = out.pop("plain")
    assert want["cfl"] > 0.0
    for layout, got in out.items():
        assert got == want, layout
