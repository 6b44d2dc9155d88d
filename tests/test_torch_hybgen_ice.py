"""HYBGEN with its unmixing, the PPM_H6 and P3M_H4 remap schemes,
TS_CONFIG = from_Z (the z-level remap and the horizontal regridding) and
the SSA shelf dynamics with the ice-only driver, against the reference on
the CPU.

* Each ported function on seeded inputs (numpy, seed 19): the PPM_H6 and
  P3M_H4 reconstructions and their remaps (12 layers with vanished ones;
  PPM_H6 on 5, its H4 fallback; the reference's P3M_H4 given the port's
  repair of its cell mean, and the port's content kept),
  build_hybgen_grid, hybgen_unmix (targets a layer off its profile, so
  that the swaps act), ale_regrid_remap in
  the HYBGEN mode with each new scheme, init_tracer_from_z of a profile
  and of a field from 10 and from 21 levels, the SSA's strains, operator,
  Glen viscosity, solve (8 Picard iterations of 60 CG iterations) and
  the upwind transport.  float64 to 1e-10 of the reference's max-abs
  (the reference op by op in the file's JAX_ENABLE_X64=1 subprocess,
  tests/torch_x64.py), float32 to 1e-5 (the reference op by op in a
  subprocess without x64); the reconstructions and HYBGEN to the bit.
  Where a target layer is vanished (h <= 1 mm), the remap's value is the
  round-off of two cumulative integrals over 1e-10 m, clipped to the
  column's range: init_tracer_from_z is compared where the layer holds
  water (from 21 levels XLA's cumsum adds in a tree, the port's in
  order; from 10 to the bit everywhere).
* The SSA solve: each CG iteration's inner products sum in another order
  in the two packages (PyTorch's vectorised sum, XLA's).  Where the 480
  iterations converge (the driver's wedge, uniform in x) that leaves the
  velocities within 1e-5 (float32) and 1e-10 of the max speed.  On a
  shelf with a bay and noise the pinned corners (1e-6 of max nu H
  against 3e-11 elsewhere) leave the CG unconverged after 60 iterations
  a Picard step, and the last iterations carry the sums' round-off:
  TOL_SSA_BAY = 1e-4 of the max speed in both precisions.
* horiz_regrid's host numpy against the reference's to the bit.
* A small tripolar directory (configs/global_2deg's MOM_input on the
  32x24x5 mosaic, KPP off) with tests/torch_gates.py::hybgen_override(5):
  HYBGEN with HYCOM's minimum z profile, PPM_H6, TS_CONFIG = from_Z from
  a 36x18 climatology with 21 of WOA's levels and the model's land:
  the build in float32 and float64 equal to the reference's to the bit
  but for T and S, which are compared where the layer holds water (to
  1e-12 and 2e-6); CYCLES cycles in float64 from the reference's build
  against the reference op by op (1e-10 of max-abs; a P3M_H4 cycle
  too); the port's CLI (2 cycles in float32, one in float64) writing
  every file with mass kept, and its parameter doc against the reference
  CLI's.
  A free run from each package's own build is not compared: HYBGEN reads
  the densities of the vanished layers, whose T and S are the remap's
  round-off, and those differ with the order of the sums (ROADMAP
  queue 3).
* The ice-only driver on the reference test's 16x16 directory: ice.stats
  and ICE.res.nc against the reference's driver (jitted, float32):
  volume and area to 1e-6, the speeds and velocities to 1e-5.
* The reference's tests of these modules through the port
  (``torch_gates.HYBGEN_ICE``).
"""

import contextlib
import dataclasses
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu_torch import interop
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.io.netcdf import read_nc
from test_torch_configs import _doc
import torch_gates
import torch_x64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL32, TOL64 = 1e-5, 1e-10
TOL_REMAP32 = 2e-6
# the SSA solve on a shelf with a bay, and the ice-only driver's
# velocities: see the module's docstring
TOL_SSA_BAY = 1e-4
H_WET = 1e-3
# float32 remapped values are compared in cells thicker than this [m]
H_THICK32 = 10.0
NZ, NY, NX = 12, 6, 7
SSA_NY, SSA_NX = 16, 24
SEED = 19
SCHEMES = ("PPM_H6", "P3M_H4")
# the small tripolar model with HYBGEN, PPM_H6 and from_Z
FOLD_BASE = ("NIGLOBAL = 32\nNJGLOBAL = 24\nNK = 5\nUSE_KPP = False\n"
             "TRACER_ADVECT_SUB = 3\n")
FOLD_TEXT = FOLD_BASE + torch_gates.hybgen_override(5)
CLIM = dict(nlon=36, nlat=18, depths=torch_gates.WOA_DEPTHS[::5])
CYCLES = 2
CLI_CYCLES = 2
ICE_TEXT = ("NIGLOBAL = 16\nNJGLOBAL = 16\nLENLON = 80.0\nLENLAT = 80.0\n"
            "DT = 43200.0\nDAYMAX = 2.0\n")
STATE_FIELDS = ("h", "u", "v", "T", "S")


# --- the seeded inputs and the operators, in either package ----------------

def columns(seed=SEED, nz=NZ):
    """(T, S, h0, h1): stratified columns with noise on z* layers, three
    vanished layers on a third of the plane, a target grid with the same
    column sums (float64 numpy)."""
    rng = np.random.default_rng(seed)
    h0 = (2000.0 / nz) * (1.0 + 0.4 * rng.uniform(-1, 1, (nz, NY, NX)))
    h0[-3:, : NY // 3] = 1e-10
    w = 1.0 + 0.4 * rng.uniform(-1, 1, h0.shape)
    h1 = w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)
    zc = np.cumsum(h0, 0) - 0.5 * h0
    T = 2.0 + 18.0 * np.exp(-zc / 600.0) + 0.5 * rng.standard_normal(zc.shape)
    S = 34.5 + 0.8 * np.exp(-zc / 400.0) + 0.05 * rng.standard_normal(
        zc.shape)
    return T, S, h0, h1


def hybgen_inputs(nz=NZ):
    """Targets over the columns' potential density (2000 dbar, WRIGHT),
    a minimum z profile; the unmixing's columns: the targets' profile with
    layer 5 warmed by 0.8 degC and layer 8 cooled."""
    rng = np.random.default_rng(SEED + 1)
    dz0 = np.minimum(3.0 * 1.18 ** np.arange(nz), 450.0)
    T_mix = np.broadcast_to(np.linspace(22.0, 2.0, nz)[:, None, None],
                            (nz, NY, NX)).copy()
    T_mix += 0.05 * rng.standard_normal(T_mix.shape)
    T_mix[5] += 0.8
    T_mix[8] -= 0.5
    return dz0, T_mix


def ssa_inputs():
    """The SSA's wedge: thick in the south, thinning northward, an ice
    front 6 rows from the north and a bay of open water; nu H and
    velocities for the operators."""
    rng = np.random.default_rng(SEED + 2)
    y = (np.arange(SSA_NY) + 0.5) / SSA_NY
    h = np.broadcast_to((700.0 - 500.0 * y)[:, None],
                        (SSA_NY, SSA_NX)).copy()
    h[SSA_NY - 6:] = 0.0
    h[:4, SSA_NX - 5:] = 0.0
    h *= 1.0 + 0.05 * rng.uniform(-1, 1, h.shape)
    nu_h = 1e14 * (1.0 + rng.uniform(0, 1, h.shape))
    uv = 1e-6 * rng.standard_normal((2, SSA_NY, SSA_NX))
    return h, nu_h, uv


def ops(pkg, dtype):
    """The functions of the slice in package ``pkg`` ("ref" or "port") on
    the seeded inputs in ``dtype`` (numpy); returns {name: [arrays]}."""
    if pkg == "ref":
        from mom6_tpu.ale import regridding as RG, remapping as RR
        from mom6_tpu.ale.ale import ALEParams, ale_regrid_remap
        from mom6_tpu.core.state import OceanState
        from mom6_tpu.eos import get_eos
        from mom6_tpu.grid.grid import build_cartesian_grid
        from mom6_tpu.grid.vertical import build_layered_vgrid
        from mom6_tpu.grid.z_init import init_tracer_from_z
        from mom6_tpu.physics import ice_shelf_dynamics as SD
        xdt = jnp.float64 if dtype == np.float64 else jnp.float32

        def arr(a):
            return jnp.asarray(np.asarray(a, dtype))
        grid_kw = dict(dtype=xdt)
    else:
        from mom6_tpu_torch.ale import regridding as RG, remapping as RR
        from mom6_tpu_torch.ale.ale import ALEParams, ale_regrid_remap
        from mom6_tpu_torch.core.state import OceanState
        from mom6_tpu_torch.eos import get_eos
        from mom6_tpu_torch.grid.grid import build_cartesian_grid
        from mom6_tpu_torch.grid.vertical import build_layered_vgrid
        from mom6_tpu_torch.grid.z_init import init_tracer_from_z
        from mom6_tpu_torch.physics import ice_shelf_dynamics as SD
        xdt = torch.float64 if dtype == np.float64 else torch.float32

        def arr(a):
            return torch.tensor(np.asarray(a, dtype))
        grid_kw = dict(dtype=xdt, device="cpu")
    out = {}

    def keep(name, res):
        out[name] = [np.asarray(a.cpu() if torch.is_tensor(a) else a)
                     for a in res]
    T, S, h0, h1 = (arr(a) for a in columns())
    for sch in SCHEMES:
        keep("recon_" + sch, RR.reconstruct(T, h0, sch))
        keep("remap_" + sch, (RR.remap_columns_multi(
            (jnp if pkg == "ref" else torch).stack([T, S]), h0, h1, sch),))
    T5, S5, h05, h15 = (arr(a) for a in columns(SEED + 3, nz=5))
    keep("recon_h6_short", RR.reconstruct(T5, h05, "PPM_H6"))
    GV = build_layered_vgrid(NZ, **grid_kw)
    eos = get_eos("WRIGHT")
    targets, unmix_t = (np.asarray(t, dtype).tolist() for t in _targets())
    dz0, T_mix = hybgen_inputs()
    keep("hybgen", (RG.build_hybgen_grid(h0, T, S, GV, eos, targets,
                                         dz0.tolist(), qhybrlx=0.25),))
    keep("unmix", RG.hybgen_unmix(arr(T_mix), S, h0, GV, eos,
                                  tuple(unmix_t)))
    G = build_cartesian_grid(NX, NY, 700.0, 600.0, max_depth=2000.0,
                             **grid_kw)
    rng = np.random.default_rng(SEED + 4)
    uv = [arr(0.2 * rng.standard_normal(h0.shape) * np.asarray(m)[None])
          for m in ((G.mask2dCu, G.mask2dCv) if pkg == "ref" else
                    (G.mask2dCu.numpy(), G.mask2dCv.numpy()))]
    st = OceanState(h=h0, u=uv[0], v=uv[1], T=T, S=S)
    for sch in SCHEMES:
        kw = dict(mode="HYBGEN", rho_targets=tuple(targets),
                  dz_nominal=tuple(dz0.tolist()), scheme=sch,
                  eos_name="WRIGHT", hybgen_qrlx=0.25)
        s2, _ = ale_regrid_remap(st, G, GV, ALEParams(**kw))
        keep("ale_" + sch, tuple(getattr(s2, k) for k in STATE_FIELDS))
    for nzd in (10, 21):
        z_edges = np.concatenate([[0.0], np.cumsum(np.random.default_rng(
            SEED + nzd).uniform(20.0, 240.0, nzd))])
        prof = 20.0 - 0.006 * z_edges[:-1]
        field = prof[:, None, None] + np.random.default_rng(
            SEED + nzd + 1).standard_normal((nzd, NY, NX))
        keep(f"zinit_{nzd}", (init_tracer_from_z(z_edges, prof, h1, None),
                              init_tracer_from_z(z_edges, field, h1, None)))
    Gs = build_cartesian_grid(SSA_NX, SSA_NY, 240.0, 160.0,
                              max_depth=1000.0, **grid_kw)
    h_ice, nu_h, uvs = (arr(a) for a in ssa_inputs())
    p = SD.SSAParams()
    mask = arr((ssa_inputs()[0] > 1.0).astype(float))
    keep("ssa_strains", SD._strains(uvs[0], uvs[1], Gs))
    keep("ssa_apply", SD._apply_ssa(uvs[0], uvs[1], nu_h, Gs, mask,
                                    Gs.areaT, 1e3 * mask))
    keep("ssa_visc", (SD._glen_visc(uvs[0], uvs[1], h_ice, Gs, p),))
    keep("ssa_solve_bay", SD.ssa_solve(h_ice, Gs, p, mask_shelf=mask))
    wedge = arr(ssa_wedge())
    keep("ssa_solve", SD.ssa_solve(wedge, Gs, p))
    keep("ssa_advect", (SD.ice_shelf_advect_thickness(
        h_ice, 30.0 * uvs[0], 30.0 * uvs[1], 86400.0, Gs, mask),))
    return out


@contextlib.contextmanager
def reference_p3m_mean_kept():
    """The reference's P3M_H4 with the port's repair, for the reference's
    runs of the tests that hold the port to it: its cubic through the
    edges and slopes does not keep the cell mean, so c0 takes up the
    difference, or the cell takes the PPM parabola, as in the port's
    (mom6_tpu_torch/ale/remapping.py::_p3m; ROADMAP queue 3)."""
    from mom6_tpu.ale import remapping as RR
    plain = RR.reconstruct

    def reconstruct(u, h, scheme):
        c = plain(u, h, scheme)
        if scheme != RR.P3M_H4:
            return c
        e_l, a1, a2, a3, zero = c
        e_r = RR._ppm_limit(u, *RR._edge_values_h4(u, h))[1]
        u_m = jnp.concatenate([u[:1], u[:-1]], axis=0)
        u_p = jnp.concatenate([u[1:], u[-1:]], axis=0)
        d = u - (e_l + 0.5 * a1 + a2 / 3.0 + 0.25 * a3)
        lo = jnp.minimum(jnp.minimum(u_m, u), u_p)
        hi = jnp.maximum(jnp.maximum(u_m, u), u_p)
        ok = ((e_l + d >= lo) & (e_l + d <= hi) & (e_r + d >= lo)
              & (e_r + d <= hi))
        return (e_l + jnp.where(ok, d, zero),
                jnp.where(ok, a1, 6.0 * u - 4.0 * e_l - 2.0 * e_r),
                jnp.where(ok, a2, 3.0 * ((e_l + e_r) - 2.0 * u)),
                jnp.where(ok, a3, zero), zero)
    RR.reconstruct = reconstruct
    try:
        yield
    finally:
        RR.reconstruct = plain


def ssa_wedge():
    """The ice-only driver's wedge on the SSA grid: 700 m thinning
    northward, an ice front at 70% of the domain."""
    y = (np.arange(SSA_NY) + 0.5) / SSA_NY
    return np.broadcast_to(((700.0 - 500.0 * y) * (y < 0.7))[:, None],
                           (SSA_NY, SSA_NX)).copy()


def _targets():
    """(HYBGEN's targets over the columns' potential density, the
    unmixing's: the densities of its clean profile), float64, from the
    port's WRIGHT at 2000 dbar on the CPU, so both packages take the same
    numbers."""
    from mom6_tpu_torch.eos import get_eos
    eos = get_eos("WRIGHT")
    T, S = (torch.from_numpy(a) for a in columns()[:2])
    rho = (1035.0 + eos.density(T, S, torch.full_like(T, 2e7),
                                rho_ref=1035.0)).numpy()
    t = torch.linspace(22.0, 2.0, NZ, dtype=torch.float64)
    clean = (1035.0 + eos.density(t, torch.full_like(t, 34.8),
                                  torch.full_like(t, 2e7),
                                  rho_ref=1035.0)).numpy()
    return np.linspace(rho.min() - 0.2, rho.max() + 0.2, NZ), clean


def fold_dir(where, name="fold"):
    """The small tripolar directory: the mosaic (the reference's
    generator), configs/global_2deg's MOM_input, FOLD_TEXT as its
    MOM_override and the climatology clim_z.nc on the port's grid."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_global_grid
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    d = os.path.join(where, name)
    os.makedirs(d)
    make_global_grid.write_mosaic(d, nx=32, ny_reg=16, ny_cap=8)
    shutil.copy(os.path.join(REPO, "configs", "global_2deg", "MOM_input"), d)
    ms = build_model_from_params(ParamFile([os.path.join(d, "MOM_input")],
                                           text=FOLD_BASE), device="cpu")
    torch_gates.write_climatology(os.path.join(d, "clim_z.nc"), ms.grid,
                                  SEED, **CLIM)
    with open(os.path.join(d, "MOM_override"), "w") as f:
        f.write(FOLD_TEXT)
    return d


def _paths(d):
    return [os.path.join(d, "MOM_input"), os.path.join(d, "MOM_override")]


def reference_build(d, dtype):
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    ms = build_model_from_params(ParamFile(_paths(d)), dtype=dtype)
    return [interop.export(o) for o in (ms.grid, ms.vgrid, ms.state,
                                        ms.params, ms.forcing)]


def reference_cycles(d):
    """CYCLES float64 cycles of the small directory from the reference's
    build, op by op, then one P3M_H4 cycle from the build."""
    from mom6_tpu.core.mom import step_mom
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    ms = build_model_from_params(ParamFile(_paths(d)), dtype=jnp.float64)
    st = ms.state
    out = {"cycles": []}
    with jax.disable_jit():
        for _ in range(CYCLES):
            st = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params)
            out["cycles"].append({k: np.asarray(getattr(st, k))
                                  for k in STATE_FIELDS})
        p = ms.params._replace(ale=ms.params.ale._replace(scheme="P3M_H4"))
        with reference_p3m_mean_kept():
            st = step_mom(ms.state, ms.forcing, ms.grid, ms.vgrid, p)
        out["p3m"] = {k: np.asarray(getattr(st, k)) for k in STATE_FIELDS}
    return out


def reference_cli(work, d):
    """The reference's CLI on a copy of the small directory, one cycle in
    float64, op by op."""
    from mom6_tpu.drivers import solo
    c = os.path.join(work, "ref_cli")
    shutil.copytree(d, c)
    with open(os.path.join(c, "MOM_override"), "a") as f:
        f.write("DOUBLE_PRECISION = True\n")
    with jax.disable_jit():
        solo.main([c, "--days", repr(3600.0 / 86400.0)])
    return c


def reference_ice(work):
    """The reference's ice-only driver (jitted, float32) on ICE_TEXT."""
    from mom6_tpu.drivers import ice_solo
    d = os.path.join(work, "ref_ice")
    os.makedirs(d)
    with open(os.path.join(d, "MOM_input"), "w") as f:
        f.write(ICE_TEXT)
    ice_solo.main([d])
    return d


def reference_f64(work):
    d = fold_dir(work)
    with jax.disable_jit(), reference_p3m_mean_kept():
        out = {"ops": ops("ref", np.float64), "dir": d}
    out["build"] = reference_build(d, jnp.float64)
    out.update(reference_cycles(d))
    out["cli"] = reference_cli(work, d)
    return out


def reference_f32(work):
    d = fold_dir(work, "fold32")
    with jax.disable_jit(), reference_p3m_mean_kept():
        out = {"ops": ops("ref", np.float32),
               "build": reference_build(d, jnp.float32)}
    out["dir"] = d
    out["ice"] = reference_ice(work)
    return out


def _helper(call):
    return r'''
import os, pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
import jax.numpy as jnp
import test_torch_hybgen_ice as m
work = os.path.dirname(%(path)r)
out = ''' + call + r'''
with open(%(path)r, "wb") as fh:
    pickle.dump(out, fh)
'''


ref64_run, ref64 = torch_x64.fixtures(_helper("m.reference_f64(work)"),
                                      "hybgen64")
ref32_run, ref32 = torch_x64.fixtures(_helper("m.reference_f32(work)"),
                                      "hybgen32", x64=False, name="ref32")


def _rel(got, want, where=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    if where is not None:
        d = np.where(where, d, 0.0)
    return float(d.max() / max(np.abs(want).max(), 1e-300))


def _ref(dtype, request):
    return request.getfixturevalue("ref64" if dtype == np.float64
                                   else "ref32")


@pytest.fixture(scope="module")
def port32():
    with torch.inference_mode():
        return ops("port", np.float32)


@pytest.fixture(scope="module")
def port64():
    with torch.inference_mode():
        return ops("port", np.float64)


def _port(dtype, request):
    return request.getfixturevalue("port64" if dtype == np.float64
                                   else "port32")


DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["f32", "f64"])


# --- the operators -----------------------------------------------------------

@DTYPES
@pytest.mark.parametrize("name", ["recon_PPM_H6", "recon_P3M_H4",
                                  "recon_h6_short", "hybgen", "unmix"])
def test_bitwise_ops(dtype, name, request):
    """The reconstructions (PPM_H6's three, P3M_H4's five of which the
    last is 0), build_hybgen_grid and hybgen_unmix equal the reference's
    to the bit (the float32 HYBGEN grid to 1e-5)."""
    got = _port(dtype, request)[name]
    want = _ref(dtype, request)["ops"][name]
    # the reference's parabolas carry two more coefficients, both 0
    assert all(not w.any() for w in want[len(got):])
    for g, w in zip(got, want[:len(got)]):
        assert g.shape == w.shape, name
        if name == "hybgen" and dtype == np.float32:
            # WRIGHT's float32 density rounds otherwise in the two
            # packages (tests/test_torch_ale.py's RHO grid, 1e-5)
            assert _rel(g, w) <= TOL32
        else:
            assert np.array_equal(g, w), name
    if name == "unmix":
        T0 = hybgen_inputs()[1].astype(dtype)
        assert np.abs(got[0] - T0).max() > 0.01    # the swaps act
    if name == "recon_P3M_H4":
        assert not got[4].any()


@DTYPES
@pytest.mark.parametrize("scheme", SCHEMES)
def test_remap_and_ale(dtype, scheme, request):
    """The remap of T and S with each new scheme (the quartic instance for
    P3M_H4): 2e-6 (float32) and 1e-10 of max-abs; a HYBGEN regrid and
    remap of the whole state (T and S unmixed after it): 1e-10 of max-abs
    where the new layer or face holds water, float32 1e-5 where it is
    thicker than H_THICK32 (the grid parts by the density's rounding,
    and a remapped value is a difference of two cumulative integrals over
    the column, each with the float32 round-off of the whole column's,
    divided by the cell's thickness: ~6e-8 x 2000 m / h of max-abs)."""
    from mom6_tpu_torch.framework.stencil import ip1, jp1
    port, ref = _port(dtype, request), _ref(dtype, request)["ops"]
    tol = TOL_REMAP32 if dtype == np.float32 else TOL64
    assert _rel(port["remap_" + scheme][0], ref["remap_" + scheme][0]) <= tol
    got, want = port["ale_" + scheme], ref["ale_" + scheme]
    h = torch.from_numpy(want[0])
    thick = H_WET if dtype == np.float64 else H_THICK32
    where = {"h": None, "T": h > thick, "S": h > thick,
             "u": 0.5 * (h + ip1(h)) > thick, "v": 0.5 * (h + jp1(h)) > thick}
    for k, g, w in zip(STATE_FIELDS, got, want):
        m = None if where[k] is None else where[k].numpy()
        assert _rel(g, w, m) <= (TOL32 if dtype == np.float32 else TOL64), k


@pytest.mark.parametrize("same_grid", [False, True],
                         ids=["new_grid", "same_grid"])
def test_p3m_keeps_the_column_content(same_grid):
    """P3M_H4's remap keeps each column's T and S content (float64, 1e-14
    of the largest) and, onto its own grid, returns the cell means (1e-12
    where the layer holds water).  The reference's cubic, through the
    edges and slopes alone, moves the content by more than 1e-4 of it
    (float32): the port repairs it (ROADMAP queue 3)."""
    from mom6_tpu.ale import remapping as RR
    from mom6_tpu_torch.ale import remapping as TR
    T, S, h0, h1 = columns()
    f = np.stack([T, S])
    h = h0 if same_grid else h1
    got = TR.remap_columns_multi(*(torch.from_numpy(a) for a in (f, h0, h)),
                                 "P3M_H4").numpy()
    c0 = (f * h0).sum(1)
    assert np.abs((got * h).sum(1) - c0).max() <= 1e-14 * np.abs(c0).max()
    if same_grid:
        wet = np.broadcast_to(h0 > H_WET, f.shape)
        assert np.abs(got - f)[wet].max() <= 1e-12 * np.abs(f).max()
    want = np.asarray(RR.remap_columns_multi(
        *(jnp.asarray(a, jnp.float32) for a in (f, h0, h)), "P3M_H4"))
    assert np.abs((want.astype(np.float64) * h).sum(1) - c0).max() \
        > 1e-4 * np.abs(c0).max()


@DTYPES
@pytest.mark.parametrize("nzd", [10, 21])
def test_z_init(dtype, nzd, request):
    """init_tracer_from_z of a profile and a field onto 12 layers with
    vanished ones: to the bit from 10 levels; from 21 where the layer
    holds water (1e-12 of max-abs, float32 2e-6), the vanished layers
    inside the column's range."""
    got = _port(dtype, request)[f"zinit_{nzd}"]
    want = _ref(dtype, request)["ops"][f"zinit_{nzd}"]
    h1 = columns()[3]
    wet = np.broadcast_to(h1 > H_WET, got[0].shape)
    for g, w in zip(got, want):
        if nzd == 10:
            assert np.array_equal(g, w)
        tol = TOL_REMAP32 if dtype == np.float32 else 1e-12
        assert _rel(g, w, wet) <= tol
        assert np.isfinite(g).all()


@DTYPES
@pytest.mark.parametrize("name", ["ssa_strains", "ssa_apply", "ssa_visc",
                                  "ssa_advect", "ssa_solve",
                                  "ssa_solve_bay"])
def test_ssa(dtype, name, request):
    """The SSA's operators and the transport to 1e-5 and 1e-10 of
    max-abs; the solves' velocities against the max speed: the driver's
    wedge to the same, the shelf with a bay to TOL_SSA_BAY."""
    got = _port(dtype, request)[name]
    want = _ref(dtype, request)["ops"][name]
    tol = TOL64 if dtype == np.float64 else TOL32
    if name.startswith("ssa_solve"):
        if name == "ssa_solve_bay":
            tol = TOL_SSA_BAY
        speed = max(np.abs(w).max() for w in want)
        assert speed > 0.0
        for g, w in zip(got, want):
            assert float(np.abs(g - w).max()) <= tol * speed, name
        return
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol, name


def test_ssa_fold_refused():
    """The reference's fold refusal, kept."""
    from mom6_tpu_torch.grid.grid import build_cartesian_grid
    from mom6_tpu_torch.physics.ice_shelf_dynamics import (SSAParams,
                                                           ssa_solve)
    G = dataclasses.replace(build_cartesian_grid(
        8, 8, 100.0, 100.0, device="cpu"), fold_north=True)
    with pytest.raises(ValueError, match="fold"):
        ssa_solve(torch.full((8, 8), 200.0), G, SSAParams())


def test_horiz_regrid_host_equals_reference():
    """The port's own copy of the host regridding: every function's result
    equal to the reference's to the bit on a 1-degree-like source with
    missing land and deep levels onto a rotated target."""
    from mom6_tpu.grid import horiz_regrid as R
    from mom6_tpu_torch.grid import horiz_regrid as P
    rng = np.random.default_rng(SEED)
    lon = np.arange(0.0, 360.0, 15.0) + 7.5
    lat = np.linspace(-80.0, 80.0, 11)
    data = 10.0 + rng.standard_normal((3, 11, 24))
    data[:, 3:5, 4:9] = np.nan
    data[2, :, 12:] = -1e34
    dlon = np.mod(np.linspace(-300.0, 60.0, 20)[None, :]
                  + 3.0 * np.arange(9)[:, None], 360.0) - 300.0
    dlat = np.linspace(-70.0, 85.0, 9)[:, None] + 0.0 * dlon
    wet = rng.uniform(0, 1, dlon.shape) > 0.2
    for f, args, kw in (
            ("_interp_weights", (lon, dlon.ravel()), dict(periodic=360.0)),
            ("horiz_interp_bilinear", (lon, lat, data[0], dlon, dlat),
             dict(good=np.isfinite(data[0]))),
            ("fill_missing", (np.where(wet, 1.0, 0.0), wet & (dlat < 40),
                              np.ones_like(wet)), {}),
            ("horiz_interp_and_extrap_tracer",
             (lon, lat, data, wet, dlon, dlat),
             dict(missing_value=-1e34, cyclic_x=True))):
        a, b = getattr(R, f)(*args, **kw), getattr(P, f)(*args, **kw)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert np.array_equal(x, y, equal_nan=True), f


# --- the small tripolar directory -------------------------------------------

def _port_build(d, dtype):
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    return build_model_from_params(ParamFile(_paths(d)), dtype=dtype,
                                   device="cpu")


@DTYPES
def test_fold_build(dtype, request):
    """The small directory's build: grid, vertical grid, forcing,
    parameters and h, u, v equal to the reference's to the bit; T and S
    where the layer holds water (1e-12 and 2e-6 of max-abs; the vanished
    layers hold the remap's round-off, inside the data's range)."""
    ref = _ref(dtype, request)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    ms = _port_build(ref["dir"], tdt)
    G, GV, st, p, f = interop.load_all(*ref["build"], device="cpu",
                                       dtype=tdt)
    assert p.ale.mode == "HYBGEN" and p.ale.scheme == "PPM_H6"
    assert ms.params == p
    for a, b in ((ms.grid, G), (ms.vgrid, GV), (ms.forcing.mech, f.mech),
                 (ms.forcing.buoy, f.buoy)):
        for name, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), t), name
    for k in ("h", "u", "v"):
        assert torch.equal(getattr(ms.state, k), getattr(st, k)), k
    wet = (st.h > H_WET).numpy()
    tol = 1e-12 if dtype == np.float64 else TOL_REMAP32
    for k in ("T", "S"):
        assert _rel(getattr(ms.state, k).numpy(), getattr(st, k).numpy(),
                    wet) <= tol, k
    T = ms.state.T.numpy()
    assert np.isfinite(T).all() and -3.0 < T.min() and T.max() < 30.0


@pytest.fixture(scope="module")
def fold_cycles(ref64):
    """The port's cycles from the reference's build: CYCLES with PPM_H6,
    one with P3M_H4."""
    from mom6_tpu_torch.core.mom import step_mom
    ms = _port_build(ref64["dir"], torch.float64)
    st0 = interop.load_state(ref64["build"][2], device="cpu",
                             dtype=torch.float64)
    out, st = [], st0
    with torch.inference_mode():
        for _ in range(CYCLES):
            st = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params)
            out.append(st)
        p = ms.params.replace(ale=dataclasses.replace(ms.params.ale,
                                                      scheme="P3M_H4"))
        p3m = step_mom(st0, ms.forcing, ms.grid, ms.vgrid, p)
    return out, p3m


@pytest.mark.parametrize("cycle", list(range(CYCLES)) + ["p3m"])
def test_fold_cycles_f64(ref64, fold_cycles, cycle):
    """Each HYBGEN cycle of the small tripolar model from the reference's
    build against the reference op by op, and a P3M_H4 cycle: 1e-10 of
    max-abs (T and S where the layer holds water, u and v where the
    face does)."""
    from mom6_tpu_torch.framework.stencil import ip1, jp1
    states, p3m = fold_cycles
    got = p3m if cycle == "p3m" else states[cycle]
    want = ref64["p3m"] if cycle == "p3m" else ref64["cycles"][cycle]
    h = torch.from_numpy(want["h"])
    wet = {"h": None, "T": h > H_WET, "S": h > H_WET,
           "u": 0.5 * (h + ip1(h)) > H_WET,
           "v": 0.5 * (h + jp1(h, "h")) > H_WET}
    for k, where in wet.items():
        w = None if where is None else where.numpy()
        assert _rel(getattr(got, k).numpy(), want[k], w) <= TOL64, (k, cycle)
    assert float(got.h.min()) > 0.0


def test_fold_line_flux_moves_the_mass(ref64, fold_cycles):
    """The float64 cycles move the mass (~1e-10 of it in 3 cycles, in both
    packages) through the tripolar fold line, where the thickness flux is
    not single-valued: vh at a fold face and at its partner do not cancel
    (ROADMAP queue 3).  One continuity call from the second cycle's
    state: its mass change is the fold line's net inflow, 1e-14 of the
    mass aside (the round-off of IareaT x areaT), and that inflow is not
    0; a cycle with z* instead of HYBGEN from that state moves the mass as
    much (1e-4 of it)."""
    from mom6_tpu_torch.core.continuity_ppm import continuity_ppm
    from mom6_tpu_torch.core.mom import step_mom
    ms = _port_build(ref64["dir"], torch.float64)
    G, GV, p = ms.grid, ms.vgrid, ms.params
    st = fold_cycles[0][1]

    def mass(h):
        return float((h * G.areaT * G.mask2dT).sum())
    m0 = mass(st.h)
    with torch.inference_mode():
        h1, _, vh, _, _ = continuity_ppm(st.u, st.v, st.h, p.dyn.dt, G, GV)
        fold = -p.dyn.dt * float(vh[:, -1, :].sum())
        assert abs(mass(h1) - m0 - fold) <= 1e-14 * m0
        assert abs(fold) > 1e-12 * m0
        nz = st.h.shape[0]
        zstar = dataclasses.replace(p.ale, mode="ZSTAR", dz_nominal=tuple(
            [float(G.bathyT.max()) / nz] * nz))
        dm = [mass(step_mom(st, ms.forcing, G, GV, q).h) - m0
              for q in (p, p.replace(ale=zstar))]
    assert abs(dm[0]) > 1e-12 * m0
    assert abs(dm[0] - dm[1]) <= 1e-4 * abs(dm[1])


@pytest.fixture(scope="module")
def port_cli(ref64, tmp_path_factory):
    """The port's CLI on copies of the small directory: CLI_CYCLES cycles
    in float32 and one in float64 (the reference CLI's length)."""
    from mom6_tpu_torch.drivers import solo
    work = str(tmp_path_factory.mktemp("hybgen_cli"))
    out = {}
    for tag, extra, cycles in (("f32", "", CLI_CYCLES),
                               ("f64", "DOUBLE_PRECISION = True\n", 1)):
        d = os.path.join(work, tag)
        shutil.copytree(ref64["dir"], d)
        with open(os.path.join(d, "MOM_override"), "a") as f:
            f.write(extra)
        st = solo.main([d, "--days", repr(cycles * 3600.0 / 86400.0)],
                       device="cpu")
        out[tag] = (d, st)
    return out


def test_cli_runs_hybgen_from_z(port_cli):
    """Both CLI runs write every file, ocean.stats finite with the mass
    kept (1e-11 in float64, 1e-6 in float32), h > 0, T inside the
    climatology's range."""
    from mom6_tpu_torch.diagnostics.sum_output import read_stats
    for tag, (d, st) in port_cli.items():
        for f in ("MOM.res.nc", "ocean.stats", "ocean.cputime",
                  "MOM_parameter_doc.all", os.path.join("RESTART",
                                                        "ocean_solo.res")):
            assert os.path.exists(os.path.join(d, f)), (tag, f)
        # the tripolar fold line's flux moves 3.3e-12 of the mass in the
        # float64 cycle, in both packages
        # (test_fold_line_flux_moves_the_mass; ROADMAP queue 3)
        tol = 1e-11 if tag == "f64" else 1e-6
        for ln in read_stats(os.path.join(d, "ocean.stats")):
            assert all(np.isfinite(v) for v in ln.values())
            assert abs(ln["dM_net"]) <= tol * ln["Mass"]
        assert float(st.h.min()) > 0.0
        T = st.T.double().numpy()
        assert np.isfinite(T).all() and -3.0 < T.min() and T.max() < 30.0


def test_cli_parameter_doc_matches_reference(ref64, port_cli):
    """Every key of the reference CLI's doc with its value and module."""
    got, want = _doc(port_cli["f64"][0]), _doc(ref64["cli"])
    for k, (value, module) in want.items():
        assert got.get(k, (None, None))[1] == module, k
        if not re.match(r"^[-0-9.eE+]+$", value):
            assert got[k][0] == value, (k, got[k], value)
        else:
            assert float(got[k][0]) == float(value), (k, got[k], value)
    for k in ("REGRIDDING_COORDINATE_MODE", "HYBGEN_RELAX_PERIOD",
              "REMAPPING_SCHEME", "TEMP_SALT_Z_INIT_FILE",
              "Z_INIT_DATA_MISSING"):
        assert k in got, k


# --- the ice-only driver ------------------------------------------------------

def _ice_stats(d):
    rows = []
    with open(os.path.join(d, "ice.stats")) as f:
        for ln in f:
            m = re.match(r"\s*(\d+),\s*([0-9.]+) days: Vol (\S+)\s+Area (\S+)"
                         r"\s+max\|u\|\s+(\S+) m/yr", ln)
            if m:
                rows.append([float(x) for x in m.groups()])
    return np.array(rows)


def test_ice_solo_matches_reference(ref32, tmp_path):
    """The port's driver on the reference test's directory: ice.stats'
    lines (steps, days, volume and area to 1e-6, max speed to 1e-5) and
    ICE.res.nc's fields (h to 1e-5 of max-abs, u and v to 1e-5 of the
    max speed) against the reference's driver."""
    from mom6_tpu_torch.drivers import ice_solo
    d = str(tmp_path)
    with open(os.path.join(d, "MOM_input"), "w") as f:
        f.write(ICE_TEXT)
    ice_solo.main([d, "--device", "cpu"])
    got, want = _ice_stats(d), _ice_stats(ref32["ice"])
    assert got.shape == want.shape and len(got) == 4
    assert np.array_equal(got[:, :2], want[:, :2])
    assert np.allclose(got[:, 2:4], want[:, 2:4], rtol=1e-6, atol=0)
    assert np.allclose(got[:, 4], want[:, 4], rtol=TOL32)
    a = read_nc(os.path.join(d, "ICE.res.nc"))
    b = read_nc(os.path.join(ref32["ice"], "ICE.res.nc"))
    assert _rel(a["h_ice"], b["h_ice"]) <= TOL32
    speed = float(np.hypot(b["u_ice"], b["v_ice"]).max())
    for k in ("u_ice", "v_ice"):
        assert float(np.abs(a[k] - b[k]).max()) <= TOL32 * speed, k


def test_ice_solo_needs_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from mom6_tpu_torch.drivers import ice_solo
    with open(os.path.join(str(tmp_path), "MOM_input"), "w") as f:
        f.write(ICE_TEXT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ice_solo.main([str(tmp_path)])


# --- the reference's tests through the port -------------------------------

@pytest.mark.parametrize("name", torch_gates.HYBGEN_ICE)
def test_physics_gate(name):
    rec = torch_gates.run_gate(name, "cpu")
    assert np.isfinite(rec["measured"])
