"""Parity of the port's thermodynamic slice with the JAX reference: the
equation of state, the finite-volume pressure force, lateral friction,
tracer advection, the diffusivities, the diabatic column solve, and
thermo_gyre through core/mom.py::step_mom.

Inputs are made with numpy from a seed and handed to both packages;
float32 throughout (the float64 slice is in tests/test_torch_x64.py).
Single operators agree to 1e-5 of the field's max-abs (1e-6 for the
elementwise EOS): the same operations in the same order, rounded apart
only where the two frameworks' CPU kernels sum or divide differently.

The slice is compared after one thermo cycle to 1e-4 from a state with a
0.5 m/s flow and T/S structure (:func:`flowing_inputs`), T and S as
anomalies from the resting state.  From the
resting start, u and v after one cycle are ~5e-4 m/s and sit on the
float32 round-off floor of the pressure force's column integrals
(~2e-5 m/s): there the reference's own jitted and eager forms differ by
2.6e-3 (u) and 1.3e-2 (v) relative, so no port could be held to 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu.core.mom import step_mom as ref_step_mom
from mom6_tpu.core.pressure_force import _dpa_column as ref_dpa_column
from mom6_tpu.core.pressure_force import pressure_force_fv as ref_pf_fv
from mom6_tpu.drivers.experiments import thermo_gyre as ref_thermo_gyre
from mom6_tpu.eos import get_eos as ref_get_eos
from mom6_tpu.physics.lateral.hor_visc import HorViscParams as RefHVP
from mom6_tpu.physics.lateral.hor_visc import \
    horizontal_viscosity as ref_hor_visc
from mom6_tpu.physics.vertical.diabatic import \
    BuoyancyForcing as RefBuoyancy
from mom6_tpu.physics.vertical.diabatic import DiabaticParams as RefDP
from mom6_tpu.physics.vertical.diabatic import diabatic_ale as ref_diabatic
from mom6_tpu.physics.vertical.set_diffusivity import \
    DiffusivityParams as RefKdP
from mom6_tpu.physics.vertical.set_diffusivity import \
    set_diffusivity as ref_set_diffusivity
from mom6_tpu.tracers.advect import advect_tracers as ref_advect
from mom6_tpu.tracers.vert_diff import tracer_vertdiff as ref_vertdiff
from mom6_tpu_torch import interop
from mom6_tpu_torch.core.mom import step_mom
from mom6_tpu_torch.core.pressure_force import _dpa_column, pressure_force_fv
from mom6_tpu_torch.diagnostics.sum_output import compute_stats
from mom6_tpu_torch.drivers.experiments import double_gyre, thermo_gyre
from mom6_tpu_torch.drivers.solo import run_segment
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.grid.grid import build_cartesian_grid
from mom6_tpu_torch.grid.vertical import build_layered_vgrid
from mom6_tpu_torch.physics.vertical.opacity import OpacityParams
from mom6_tpu_torch.physics.lateral.meke import MEKEParams
from mom6_tpu_torch.physics.lateral.hor_visc import (HorViscParams,
                                                     horizontal_viscosity)
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams,
                                                      diabatic_ale)
from mom6_tpu_torch.physics.vertical.set_diffusivity import (
    DiffusivityParams, set_diffusivity)
from mom6_tpu_torch.tracers.advect import advect_tracers
from mom6_tpu_torch.tracers.vert_diff import tracer_vertdiff

torch.set_num_threads(1)

NX, NY, NZ = 16, 14, 6
TOL_OP = 1e-5
TOL_SLICE = 1e-4


def flowing_inputs(st, G, seed=0):
    """T, S, u and v (float64 numpy) for thermo_gyre's state ``st``: a
    large-scale T anomaly and 0.5 m/s gyre-like velocities decaying with
    depth, plus small noise, masked like the grid."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = st.h.shape
    yy, xx = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx),
                         indexing="ij")
    decay = np.exp(-np.arange(nz) / 4.0)[:, None, None]
    m = np.asarray(G.mask2dT, np.float64)[None]
    T = np.asarray(st.T, np.float64) + (
        np.exp(-np.arange(nz) / 3.0)[:, None, None]
        * (np.sin(np.pi * yy) * np.cos(2 * np.pi * xx))[None]
        + 0.01 * rng.standard_normal(st.h.shape)) * m
    S = np.asarray(st.S, np.float64) + (
        2.0 * np.exp(-np.arange(nz) / 3.0)[:, None, None]
        * (np.cos(np.pi * yy) * np.sin(2 * np.pi * xx))[None]
        + 0.1 * rng.standard_normal(st.h.shape)) * m
    u = 0.5 * np.cos(np.pi * yy)[None] * decay \
        * np.asarray(G.mask2dCu, np.float64)[None]
    v = 0.5 * np.sin(2 * np.pi * xx)[None] * decay \
        * np.asarray(G.mask2dCv, np.float64)[None]
    return dict(T=T, S=S, u=u, v=v)


def _rel(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def gyre():
    """thermo_gyre(16, 14, 6) with a flowing state, in both packages (the
    port's carried across), and the reference's state after one jitted
    thermo cycle."""
    G, GV, st, p, f = ref_thermo_gyre(NX, NY, NZ)
    st = st.replace(**{k: jnp.asarray(a, jnp.float32)
                       for k, a in flowing_inputs(st, G).items()})
    port = interop.load_all(*(interop.export(o)
                              for o in (G, GV, st, p, f)), device="cpu")
    after = jax.jit(lambda s: ref_step_mom(s, f, G, GV, p))(st)
    return (G, GV, st, p, f), port, after


def _profile(seed=1, shape=(NZ, NY, NX)):
    """Random thicknesses, T, S and velocities on thermo_gyre's grid."""
    rng = np.random.default_rng(seed)
    h = (3000.0 / NZ) * (1.0 + 0.3 * rng.uniform(-1, 1, shape))
    h[-1, :3] = 1e-3                        # a nearly vanished layer
    T = 4.0 + 16.0 * rng.uniform(0, 1, shape)
    S = 34.0 + 2.0 * rng.uniform(0, 1, shape)
    u = 0.3 * rng.standard_normal(shape)
    v = 0.3 * rng.standard_normal(shape)
    return {k: a.astype(np.float32) for k, a in
            dict(h=h, T=T, S=S, u=u, v=v).items()}


# --- equation of state ----------------------------------------------------

@pytest.mark.parametrize("name", ["WRIGHT", "LINEAR"])
def test_eos_parity(name):
    rng = np.random.default_rng(2)
    T = rng.uniform(-2, 30, 500).astype(np.float32)
    S = rng.uniform(30, 38, 500).astype(np.float32)
    p = rng.uniform(0, 6e7, 500).astype(np.float32)
    ref, eos = ref_get_eos(name), get_eos(name)
    args = [(jnp.asarray(a), _t(a)) for a in (T, S, p)]
    J = [a[0] for a in args]
    P = [a[1] for a in args]
    assert _rel(eos.density(*P), ref.density(*J)) <= 1e-6
    assert _rel(eos.density(*P, rho_ref=1035.0),
                ref.density(*J, rho_ref=1035.0)) <= 1e-6
    for g, w in zip(eos.density_derivs(*P), ref.density_derivs(*J)):
        assert _rel(g, w) <= 1e-6
    assert _rel(eos.specific_volume(*P), ref.specific_volume(*J)) <= 1e-6
    # the second derivatives, forward-mode derivatives of the first in
    # both packages (tests/test_torch_stoch_tides.py holds every EOS's)
    for g, w in zip(eos.density_second_derivs(*P),
                    ref.density_second_derivs(*J)):
        assert _rel(g, w) <= 1e-6


@pytest.mark.parametrize("name", ["WRIGHT", "LINEAR"])
def test_layer_density_integral_parity(name):
    """Wright's analytic int_density_dz and the linear EOS's Boole
    quadrature (with and without PLM slopes), through _dpa_column."""
    x = _profile(3)
    e_b = -np.cumsum(x["h"], axis=0)
    e_t = e_b + x["h"]
    dT = (0.5 * x["T"] - 5.0).astype(np.float32)
    for slopes in (False, True):
        kw = dict(dT=dT, dS=0.1 * dT) if slopes else {}
        want = ref_dpa_column(jnp.asarray(x["T"]), jnp.asarray(x["S"]),
                              jnp.asarray(e_t), jnp.asarray(e_b), 9.8,
                              1035.0, ref_get_eos(name),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        got = _dpa_column(_t(x["T"]), _t(x["S"]), _t(e_t), _t(e_b), 9.8,
                          1035.0, get_eos(name),
                          **{k: _t(v) for k, v in kw.items()})
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-6


# the ids keep their names; every EOS of the reference is ported
# (tests/test_torch_stoch_tides.py), so they hold NEMO, an EOS of MOM6
# that neither package has, and names neither knows: get_eos raises
# ValueError as the reference's does, and the builder's check raises
# NotImplementedError naming EQN_OF_STATE
@pytest.mark.parametrize("name", ["NEMO", "nemo", "NO_SUCH"],
                         ids=["ROQUET_RHO", "JACKETT06", "UNESCO"])
def test_unported_eos_raise(name):
    from mom6_tpu_torch.eos import check_ported
    with pytest.raises(ValueError, match=name):
        get_eos(name)
    with pytest.raises(ValueError):
        ref_get_eos(name)
    with pytest.raises(NotImplementedError, match="EQN_OF_STATE"):
        check_ported(name)


# --- operators --------------------------------------------------------------

@pytest.mark.parametrize("plm_ts", [False, True])
@pytest.mark.parametrize("state", ["rest", "perturbed"])
def test_pressure_force_fv_parity(gyre, plm_ts, state):
    """At rest (thermo_gyre's flat layers and level T/S, where the form
    telescopes: PFu = PFv = 0 exactly in both packages) and on a random
    profile with a nearly vanished layer."""
    (G, GV, _, _, _), (Gt, GVt, _, _, _), _ = gyre
    if state == "rest":
        st = ref_thermo_gyre(NX, NY, NZ)[2]
        h, T, S = (np.array(getattr(st, k)) for k in ("h", "T", "S"))
    else:
        x = _profile(4)
        h, T, S = x["h"], x["T"], x["S"]
    want = ref_pf_fv(jnp.asarray(h), jnp.asarray(T), jnp.asarray(S), G, GV,
                     ref_get_eos("WRIGHT"), plm_ts=plm_ts)
    got = pressure_force_fv(_t(h), _t(T), _t(S), Gt, GVt, get_eos("WRIGHT"),
                            plm_ts=plm_ts)
    for name, g, w in zip(got._fields, got, want):
        assert _rel(g, w) <= TOL_OP, name


def test_pressure_force_fv_unported_options_raise(gyre):
    """The tidal geopotential e_tidal and the Stanley variance varT on the
    random profile against the reference (tests/test_torch_stoch_tides.py
    holds them on more grids and EOS)."""
    (G, GV, _, _, _), (Gt, GVt, _, _, _), _ = gyre
    x = _profile(4)
    h, T, S = x["h"], x["T"], x["S"]
    e_tidal = (0.1 * np.sin(np.arange(NX))[None, :]
               * np.ones((NY, 1))).astype(np.float32)
    varT = (0.01 * x["T"]).astype(np.float32)
    want = ref_pf_fv(jnp.asarray(h), jnp.asarray(T), jnp.asarray(S), G, GV,
                     ref_get_eos("WRIGHT"), e_tidal=jnp.asarray(e_tidal),
                     varT=jnp.asarray(varT))
    got = pressure_force_fv(_t(h), _t(T), _t(S), Gt, GVt, get_eos("WRIGHT"),
                            e_tidal=_t(e_tidal), varT=_t(varT))
    for name, g, w in zip(got._fields, got, want):
        assert _rel(g, w) <= TOL_OP, name


@pytest.mark.parametrize("kw", [dict(smag_bi_const=0.06),
                                dict(smag_lap_const=0.15, kh=50.0),
                                dict(ah=1e10, bound_coef=False)])
def test_horizontal_viscosity_parity(gyre, kw):
    (G, _, _, _, _), (Gt, _, _, _, _), _ = gyre
    x = _profile(5)
    kw = dict(kw, dt=1200.0)
    want = ref_hor_visc(*(jnp.asarray(x[k]) for k in ("u", "v", "h")), G,
                        RefHVP(**kw))
    got = horizontal_viscosity(*(_t(x[k]) for k in ("u", "v", "h")), Gt,
                               HorViscParams(**kw))
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_OP


# the name and the ids kw0-kw2 stay; Leith, QG Leith and the anisotropic
# viscosity are ported, so each case holds its option against the
# reference
@pytest.mark.parametrize("kw", [dict(leith_lap_const=1.0),
                                dict(leith_lap_const=1.0, use_qg_leith=True),
                                dict(kh=50.0, kh_aniso=100.0,
                                     aniso_n=(0.6, 0.8))])
def test_horizontal_viscosity_unported_raise(gyre, kw):
    (G, _, _, _, _), (Gt, _, _, _, _), _ = gyre
    x = _profile(5)
    kw = dict(kw, dt=1200.0)
    want = ref_hor_visc(*(jnp.asarray(x[k]) for k in ("u", "v", "h")), G,
                        RefHVP(**kw))
    got = horizontal_viscosity(*(_t(x[k]) for k in ("u", "v", "h")), Gt,
                               HorViscParams(**kw))
    for g, w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 0.0
        assert _rel(g, w) <= TOL_OP


@pytest.mark.parametrize("scheme", ["PPM:H3", "PLM"])
def test_advect_tracers_parity(gyre, scheme):
    """Two sub-sweeps (y then x, then x then y) of T and S with random
    transports of up to ~half a cell's volume."""
    (G, _, _, _, _), (Gt, _, _, _, _), _ = gyre
    x = _profile(6)
    rng = np.random.default_rng(7)
    vol = x["h"] * np.asarray(G.areaT)[None]
    uhtr = (0.4 * rng.uniform(-1, 1, x["h"].shape) * vol
            * np.asarray(G.mask2dCu)[None]).astype(np.float32)
    vhtr = (0.4 * rng.uniform(-1, 1, x["h"].shape) * vol
            * np.asarray(G.mask2dCv)[None]).astype(np.float32)
    tr = np.stack([x["T"], x["S"]])
    want = ref_advect(jnp.asarray(tr), jnp.asarray(x["h"]),
                      jnp.asarray(uhtr), jnp.asarray(vhtr), G, n_sub=2,
                      scheme=scheme)
    got = advect_tracers(_t(tr), _t(x["h"]), _t(uhtr), _t(vhtr), Gt,
                         n_sub=2, scheme=scheme)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_OP


@pytest.mark.parametrize("bryan_lewis", [False, True])
def test_set_diffusivity_parity(gyre, bryan_lewis):
    (G, GV, _, _, _), (Gt, GVt, _, _, _), _ = gyre
    x = _profile(8)
    extra = np.full((NZ + 1, NY, NX), 2e-5, np.float32)
    kw = dict(bryan_lewis=bryan_lewis, kd=2e-5, kd_max=1e-3)
    want = ref_set_diffusivity(jnp.asarray(x["h"]), G, GV, RefKdP(**kw),
                               kd_extra=jnp.asarray(extra))
    got = set_diffusivity(_t(x["h"]), Gt, GVt, DiffusivityParams(**kw),
                          kd_extra=_t(extra))
    assert _rel(got, want) <= TOL_OP


def test_tracer_vertdiff_parity():
    x = _profile(9)
    rng = np.random.default_rng(10)
    kd = rng.uniform(1e-5, 1e-2, (NZ + 1, NY, NX)).astype(np.float32)
    tr = np.stack([x["T"], x["S"], x["u"]])
    flux = (1e-5 * rng.standard_normal((3, NY, NX))).astype(np.float32)
    want = ref_vertdiff(jnp.asarray(tr), jnp.asarray(x["h"]),
                        jnp.asarray(kd), 2400.0,
                        sfc_flux=jnp.asarray(flux))
    got = tracer_vertdiff(_t(tr), _t(x["h"]), _t(kd), 2400.0,
                          sfc_flux=_t(flux))
    assert _rel(got, want) <= TOL_OP


@pytest.mark.parametrize("with_flux", [False, True])
def test_tracer_vertdiff_equals_one_solve_per_tracer(with_flux):
    """The column solve takes the tracers as right-hand sides that share
    the coefficients (a, b, c of shape (nz, 1, ny, nx) against the
    transposed view of the (n_tr, nz, ny, nx) tracers): each tracer comes
    out to the bit as when it is diffused alone, laid out as it went in."""
    x = _profile(9)
    rng = np.random.default_rng(10)
    kd = _t(rng.uniform(1e-5, 1e-2, (NZ + 1, NY, NX)).astype(np.float32))
    tr = _t(np.stack([x["T"], x["S"], x["u"]]))
    flux = _t((1e-5 * rng.standard_normal((3, NY, NX))).astype(np.float32)) \
        if with_flux else None
    got = tracer_vertdiff(tr, _t(x["h"]), kd, 2400.0, sfc_flux=flux)
    assert got.shape == tr.shape and got.is_contiguous()
    for i in range(3):
        one = tracer_vertdiff(tr[i:i + 1], _t(x["h"]), kd, 2400.0,
                              sfc_flux=None if flux is None
                              else flux[i:i + 1])
        assert torch.equal(got[i], one[0])


def _buoyancy(seed=11):
    rng = np.random.default_rng(seed)
    f = lambda scale: (scale * rng.standard_normal((NY, NX))).astype(
        np.float32)
    return dict(heat_flux=f(100.0), salt_flux=f(1e-6), sw_flux=np.abs(
        f(200.0)), fw_flux=f(1e-7), t_restore=(15.0 + f(3.0)),
        s_restore=(35.0 + f(0.5)), restore_rate=1e-5)


def test_diabatic_ale_parity(gyre):
    """Heat, salt, shortwave and fresh-water fluxes, restoring, Bryan-Lewis
    diffusivities plus an extra Kd and a passive tracer."""
    (G, GV, _, _, _), (Gt, GVt, _, _, _), _ = gyre
    x = _profile(12)
    b = _buoyancy()
    dp = dict(diff=dict(bryan_lewis=True))
    extra = np.full((NZ + 1, NY, NX), 1e-4, np.float32)
    J = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in b.items()}
    want = ref_diabatic(jnp.asarray(x["T"]), jnp.asarray(x["S"]),
                        jnp.asarray(x["h"]), RefBuoyancy(**J), 2400.0, G,
                        GV, RefDP(diff=RefKdP(**dp["diff"])),
                        kd_extra=jnp.asarray(extra),
                        extra_tracers=jnp.asarray(x["u"])[None])
    P = {k: (_t(v) if isinstance(v, np.ndarray) else v)
         for k, v in b.items()}
    got = diabatic_ale(_t(x["T"]), _t(x["S"]), _t(x["h"]),
                       BuoyancyForcing(**P), 2400.0, Gt, GVt,
                       DiabaticParams(diff=DiffusivityParams(**dp["diff"])),
                       kd_extra=_t(extra), extra_tracers=_t(x["u"])[None])
    for g, w in zip(got, want[:4]):
        assert _rel(g, w) <= TOL_OP


# the name and the ids "kw0"-"kw4" are kept; convection and double
# diffusion are ported, so each case now holds them (beside the opacity
# under a shortwave flux, frazil or the brine plume) against the
# reference's diabatic_ale, on random columns with unstable and
# double-diffusive interfaces
@pytest.mark.parametrize("kw", [("opacity", "ddiff"), ("frazil", "convection"),
                                ("convection",), ("ddiff",),
                                ("do_brine_plume", "convection")],
                         ids=[f"kw{i}" for i in range(5)])
def test_diabatic_ale_unported_raise(gyre, kw):
    from mom6_tpu.physics.vertical import convection as ref_conv
    from mom6_tpu.physics.vertical.opacity import OpacityParams as RefOp
    from mom6_tpu_torch.physics.vertical import convection
    (G, GV, _, _, _), (Gt, GVt, _, _, _), _ = gyre
    ref = dict(opacity=RefOp(), ddiff=ref_conv.DDiffParams(),
               convection=ref_conv.ConvectionParams(), frazil=True,
               do_brine_plume=True)
    port = dict(opacity=OpacityParams(), ddiff=convection.DDiffParams(),
                convection=convection.ConvectionParams(), frazil=True,
                do_brine_plume=True)
    x = _profile(12)
    x["T"] = x["T"] - 2.0                   # some layers below freezing
    b = _buoyancy()
    b["salt_left_behind"] = np.abs(b["salt_flux"]) * 50.0
    mld = np.full((NY, NX), 300.0, np.float32)
    want = ref_diabatic(
        jnp.asarray(x["T"]), jnp.asarray(x["S"]), jnp.asarray(x["h"]),
        RefBuoyancy(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                       for k, v in b.items()}), 2400.0, G, GV,
        RefDP(**{k: ref[k] for k in kw}), eos=ref_get_eos("WRIGHT"),
        extra_tracers=jnp.asarray(x["u"])[None], mld=jnp.asarray(mld))
    got = diabatic_ale(
        _t(x["T"]), _t(x["S"]), _t(x["h"]),
        BuoyancyForcing(**{k: _t(v) if isinstance(v, np.ndarray) else v
                           for k, v in b.items()}), 2400.0, Gt, GVt,
        DiabaticParams(**{k: port[k] for k in kw}), eos=get_eos("WRIGHT"),
        extra_tracers=_t(x["u"])[None], mld=_t(mld))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g, w) <= TOL_OP


# --- the slice --------------------------------------------------------------

def test_thermo_gyre_construction_matches_reference():
    """The port builds the experiment itself; it equals the reference's
    build carried across with interop, to the bit."""
    ref = ref_thermo_gyre(NX, NY, NZ)
    mine = thermo_gyre(NX, NY, NZ, device="cpu")
    loaded = interop.load_all(*(interop.export(o) for o in ref),
                              device="cpu")
    for a, b in zip(mine[:3] + (mine[4].mech, mine[4].buoy),
                    loaded[:3] + (loaded[4].mech, loaded[4].buoy)):
        for name, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), t), name
    assert mine[3] == loaded[3]
    st = mine[2]
    assert float(st.S.min()) == float(st.S.max()) == 35.0


def test_step_mom_one_cycle_f32(gyre):
    """T and S are compared as anomalies from the resting 10 degC and 35
    psu, so that 1e-4 of their max-abs is finer than what one cycle does
    to them; the test also checks that leaving any field as it was would
    miss 1e-4 by at least 10x."""
    (_, _, st0, _, _), (Gt, GVt, stt, pt, ft), after = gyre
    with torch.inference_mode():
        got = step_mom(stt, ft, Gt, GVt, pt)
    for k, rest in (("h", 0.0), ("u", 0.0), ("v", 0.0), ("T", 10.0),
                    ("S", 35.0)):
        want = np.asarray(getattr(after, k), np.float64) - rest
        err = _rel(getattr(got, k).double() - rest, want)
        assert err <= TOL_SLICE, (k, err)
        unchanged = _rel(_t(getattr(st0, k)).double() - rest, want)
        assert unchanged >= 10 * TOL_SLICE, (k, unchanged)
    assert not got.uhtr.any() and not got.vhtr.any()


def test_run_segment_counts_thermo_cycles(tmp_path):
    G, GV, st, p, f = thermo_gyre(NX, NY, NZ, device="cpu")
    path = tmp_path / "ocean.stats"
    st2, _ = run_segment(st, G, GV, p, f, n_steps=2, stats_interval=1,
                         stats_path=str(path))
    lines = [ln for ln in path.read_text().splitlines()
             if ln.strip() and ln.lstrip()[0].isdigit()]
    # one line per thermo cycle, numbered in baroclinic steps
    assert [int(ln.split(",")[0]) for ln in lines] == [2, 4]
    s0, s1 = compute_stats(st, G, GV, p.dyn.dt), \
        compute_stats(st2, G, GV, p.dyn.dt)
    assert abs(s1["mass"] - s0["mass"]) <= 1e-6 * s0["mass"]
    assert abs(s1["salt"] - s0["salt"]) <= 1e-6 * s0["salt"]
    for k in ("h", "u", "v", "T", "S"):
        assert bool(torch.isfinite(getattr(st2, k)).all())


@pytest.mark.parametrize("part,field", [("forcing", "tr_fluxes"),
                                        ("forcing", "oda_inc"),
                                        ("buoy", "salt_left_behind"),
                                        ("state", "obc_res_T"),
                                        ("state", "du_av_inst")])
def test_interop_rejects_unported_fields(part, field):
    """A field the port does not carry raises when it is set; the
    buoyancy forcing's salt_left_behind is carried (it feeds the brine
    plume), and so are the open boundaries' tracer reservoirs
    obc_res_T/S and, since the coupler's BGC imports are ported, the
    forcing's tr_fluxes; since data assimilation and the RK2b scheme are
    ported, the forcing's oda_inc (an IncrementalUpdate) and the state's
    du_av_inst are carried too, and a forcing field the port lacks
    raises."""
    G, GV, st, p, f = ref_thermo_gyre(8, 6, 2)
    z = jnp.zeros((6, 8))
    if part == "forcing" and field == "oda_inc":
        from mom6_tpu.physics.oda_incupd import IncrementalUpdate
        d = interop.export(f._replace(oda_inc=IncrementalUpdate(
            dT=jnp.ones((2, 6, 8)), ramp_seconds=3600.0)))
        got = interop.load_forcing(d, device="cpu")
        assert torch.equal(got.oda_inc.dT, torch.ones(2, 6, 8))
        assert got.oda_inc.dS is None and got.oda_inc.ramp_seconds == 3600.0
        d["no_such_field"] = {"x": z}
        with pytest.raises(NotImplementedError, match="no_such_field"):
            interop.load_forcing(d, device="cpu")
    elif part == "forcing":
        d = interop.export(f._replace(**{field: {"x": z}}))
        got = interop.load_forcing(d, device="cpu")
        assert torch.equal(got.tr_fluxes["x"], torch.zeros(6, 8))
    elif part == "buoy":
        d = interop.export(f._replace(buoy=f.buoy._replace(**{field: z})))
        got = interop.load_forcing(d, device="cpu")
        assert torch.equal(getattr(got.buoy, field), torch.zeros(6, 8))
    elif field == "obc_res_T":
        d = interop.export(st.replace(**{field: jnp.ones((2, 6, 8))}))
        got = interop.load_state(d, device="cpu")
        assert torch.equal(getattr(got, field), torch.ones(2, 6, 8))
    else:
        d = interop.export(st.replace(**{field: jnp.ones((6, 8))}))
        got = interop.load_state(d, device="cpu")
        assert torch.equal(getattr(got, field), torch.ones(6, 8))


# the ids keep their names; VarMix, the boundary-layer diffusion,
# DIABATIC_FIRST, MEKE's backscatter, the porous barriers, the Zanna-Bolton
# closure, the interface filter, the tidal forcing, SKEB, SPPT, the
# harmonic SAL, the Stanley correction, the HYBGEN coordinate, the
# remapping schemes PPM_H6 and P3M_H4, the RK2b scheme and the wide-halo
# subcycle (on ranks, tests/test_torch_mesh.py) are ported, so they hold
# the wide halo (fixed and AUTO; two cases beside PPM_H6 and P3M_H4) off a
# mesh, where it is off as on the reference's single device; the case
# that held HYBGEN holds the wide halo alone (HYBGEN's densities are set
# at build time, tests/test_torch_hybgen_ice.py)
def _bt(**kw):
    return lambda p: p.replace(dyn=p.dyn.replace(bt=p.dyn.bt.replace(**kw)))


def _ale(**kw):
    return lambda p: p.replace(ale=dataclasses.replace(p.ale, **kw))


@pytest.mark.parametrize("change,match", [
    pytest.param(_bt(wide_halo=6), "wide-halo", id="varmix-1"),
    pytest.param(_bt(wide_halo=4), "wide-halo", id="meke-value1"),
    pytest.param(_bt(wide_halo=5), "wide-halo", id="khtr_bl-100.0"),
    pytest.param(lambda p: _bt(wide_halo=8)(_ale(scheme="PPM_H6")(p)),
                 "wide-halo", id="diabatic_first-True"),
    pytest.param(lambda p: _bt(wide_halo=3)(_ale(scheme="P3M_H4")(p)),
                 "wide-halo", id="interface_filter-1"),
    pytest.param(_bt(wide_halo=-1), "wide-halo", id="sppt-1"),
    pytest.param(_bt(wide_halo=2), "wide-halo", id="stanley_coeff-0.5")])
def test_step_mom_unported_options_raise(gyre, change, match):
    """A cycle with the wide halo set equals the cycle without it to the
    bit (``match`` names the subcycle the case holds)."""
    from torch_widehalo import assert_step_ignores_wide_halo
    _, (Gt, GVt, stt, pt, ft), _ = gyre
    p = change(pt)
    assert match == "wide-halo" and p.dyn.bt.wide_halo != 0
    assert_step_ignores_wide_halo(
        lambda q: step_mom(stt, ft, Gt, GVt, q), p, p.dyn.bt.wide_halo,
        ("h", "u", "v", "T", "S"))


# the id "diab1" keeps its name; JHL is ported, so it holds a shear scheme
# the port does not know
@pytest.mark.parametrize("diab", [dict(boundary_layer_scheme="NO_SUCH"),
                                  dict(use_shear_mixing=True,
                                       shear_scheme="NO_SUCH")])
def test_step_mom_unported_mixing_raises(gyre, diab):
    _, (Gt, GVt, stt, pt, ft), _ = gyre
    p = pt.replace(diabatic=dataclasses.replace(pt.diabatic, **diab))
    with pytest.raises(NotImplementedError):
        step_mom(stt, ft, Gt, GVt, p)


@pytest.mark.parametrize("build", [
    lambda **kw: build_cartesian_grid(8, 6, 100.0, 100.0, **kw),
    lambda **kw: build_layered_vgrid(3, **kw),
    lambda **kw: double_gyre(8, 6, 2, **kw),
    lambda **kw: thermo_gyre(8, 6, 2, **kw),
    lambda **kw: interop.load_grid(interop.export(
        ref_thermo_gyre(8, 6, 2)[0]), **kw),
], ids=["grid", "vgrid", "double_gyre", "thermo_gyre", "load_grid"])
def test_builders_default_to_the_card(monkeypatch, build):
    """Without device= the builders and loaders ask for CUDA, and without
    a card they raise instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    build(device="cpu")
