"""The sponge, the bottom boundary layer, the LF17 Langmuir number, the
layered bulk mixed layer, the TEOS10 EOS, HYCOM1 and the PQM remap of the
port against the JAX reference, function by function, on the CPU.

Inputs from a seed with numpy on tests/test_torch_kpp.py's basin (12
levels on 10x14 over a bowl, thin and vanished bottom layers):
apply_sponge (T, S, u and v), set_viscous_bbl and the piston velocities,
bbl_lotw_kd and set_diffusivity with BBL_EFFIC and the Bryan-Lewis floor;
ust_to_u10_coare3p5, stokes_sl_lf17, langmuir_number (LF17 and EFACTOR),
convective_langmuir_number, mstar_lt_enhancement and
langmuir_enhancement, and ePBL and KPP with ``la_fn``; bulkmixedlayer,
entrainment_diffusive and diabatic_layered (target densities spread over
the columns' densities); the Roquet/TEOS10 density, specific volume and
their derivatives; build_hycom1_grid; the PQM_IH4IH3 reconstruction and
its remap (five coefficients); and the builders phillips_2layer,
lock_exchange and seamount, to the bit.

The reference runs op by op (jax.disable_jit()); its float64 side in a
JAX_ENABLE_X64=1 subprocess (tests/torch_x64.py).  Tolerances relative
to each field's max-abs: float64 1e-10 (summation order and the last
bit of exp, log and erfc).  Float32 1e-5 for the operators (ulps of
single operations), 1e-4 where a march or an iteration compounds them
(the bulk mixed layer's march over 12 levels, the 20 COARE passes, the
layered sequence of two marches and a remap) and 2e-6 for the remap (as
tests/test_torch_ale.py).  The float32 bulk mixed layer and PQM compare
where their branches (the entrained fraction's clip, the quartic's
bounds test) take the same side in both packages: a float32 ulp can
flip one, and the float64 side holds the whole field.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu_torch import interop
from mom6_tpu_torch.ale import regridding as TG
from mom6_tpu_torch.ale import remapping as TR
from mom6_tpu_torch.core.state import OceanState
from mom6_tpu_torch.drivers import experiments as TE
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.grid.grid import build_cartesian_grid
from mom6_tpu_torch.grid.vertical import build_layered_vgrid
from mom6_tpu_torch.physics import waves as TW
from mom6_tpu_torch.physics.vertical import bulk_mixed_layer as TB
from mom6_tpu_torch.physics.vertical import diabatic as TD
from mom6_tpu_torch.physics.vertical import entrain_diffusive as TEN
from mom6_tpu_torch.physics.vertical import epbl as TEP
from mom6_tpu_torch.physics.vertical import kpp as TK
from mom6_tpu_torch.physics.vertical import set_diffusivity as TSD
from mom6_tpu_torch.physics.vertical import set_viscosity as TSV
from mom6_tpu_torch.physics.vertical import sponge as TS
from test_torch_kpp import GRID, NX, NY, NZ, _depth, column_inputs
import torch_x64

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-10}
# float32 where a march or an iteration compounds single-operation ulps
TOL_MARCH = {np.float32: 1e-4, np.float64: 1e-10}
TOL_REMAP = {np.float32: 2e-6, np.float64: 1e-10}
DT = 1800.0
GPRIME = 2e-3          # target densities over the columns' range
BUILDERS = {"phillips_2layer": dict(nx=12, ny=10),
            "lock_exchange": dict(nx=16, nz=4),
            "seamount": dict(nx=10, ny=8, nz=4)}
DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["f32", "f64"])


def inputs(dtype):
    """The basin's columns (test_torch_kpp.py's "cooling" case) and the
    other inputs, numpy in ``dtype``."""
    shape = (NZ, NY, NX)
    x = column_inputs("cooling", shape, seed=11, dtype=dtype)
    rng = np.random.default_rng(12)
    x.update(
        idamp=rng.uniform(0.0, 1e-4, shape[1:]),
        T_ref=x["T"] + rng.standard_normal(shape),
        S_ref=x["S"] + 0.1 * rng.standard_normal(shape),
        u_ref=0.1 * rng.standard_normal(shape),
        v_ref=0.1 * rng.standard_normal(shape),
        ustar=np.concatenate([[0.0, 1e-12], rng.uniform(1e-4, 0.03, 38)]),
        hbl=rng.uniform(0.5, 150.0, 40),
        u10=rng.uniform(0.0, 25.0, 40),
        bflux=rng.uniform(-2e-7, 2e-7, 40),
        absf=np.concatenate([[0.0], rng.uniform(1e-6, 1.4e-4, 39)]),
        kd_int=rng.uniform(0.0, 1e-3, (NZ + 1,) + shape[1:]),
        salt=rng.uniform(-1e-6, 1e-6, shape[1:]),
        T_eos=rng.uniform(-2.0, 30.0, shape),
        S_eos=rng.uniform(30.0, 38.0, shape),
        p_eos=rng.uniform(0.0, 4e7, shape),
        dz=rng.uniform(0.5, 1.5, NZ) * 2000.0 / NZ)
    x["h1"] = x["h"] * rng.uniform(0.5, 1.5, shape)
    x["h1"] *= x["h"].sum(0) / x["h1"].sum(0)
    x["dz"] *= 2000.0 / x["dz"].sum()
    return {k: None if v is None else np.asarray(v, dtype)
            for k, v in x.items()}


def reference(dtype):
    """The reference's outputs by name, op by op."""
    from mom6_tpu.ale import regridding as RG
    from mom6_tpu.ale import remapping as RR
    from mom6_tpu.drivers import experiments as RE
    from mom6_tpu.eos import get_eos as ref_get_eos
    from mom6_tpu.grid.grid import build_cartesian_grid as ref_grid
    from mom6_tpu.grid.vertical import build_layered_vgrid as ref_vgrid
    from mom6_tpu.core.state import OceanState as RefState
    from mom6_tpu.physics import waves as RW
    from mom6_tpu.physics.vertical import bulk_mixed_layer as RB
    from mom6_tpu.physics.vertical import diabatic as RD
    from mom6_tpu.physics.vertical import entrain_diffusive as REN
    from mom6_tpu.physics.vertical import epbl as REP
    from mom6_tpu.physics.vertical import kpp as RK
    from mom6_tpu.physics.vertical import set_diffusivity as RSD
    from mom6_tpu.physics.vertical import set_viscosity as RSV
    from mom6_tpu.physics.vertical import sponge as RS
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    G = ref_grid(NX, NY, 700.0, 500.0, depth=_depth(), dtype=jdt, **GRID)
    GV = ref_vgrid(NZ, gprime_int=GPRIME, dtype=jdt)
    x = {k: None if v is None else jnp.asarray(v)
         for k, v in inputs(dtype).items()}
    mu, mv = G.mask2dCu, G.mask2dCv
    u, v = x["u"] * mu, x["v"] * mv
    wright, teos = ref_get_eos("WRIGHT"), ref_get_eos("TEOS10")
    out = {}

    def keep(name, res):
        out[name] = [np.asarray(a) for a in res]

    with jax.disable_jit():
        st = RefState(h=x["h"], u=u, v=v, T=x["T"], S=x["S"])
        sp = RS.SpongeParams(idamp=x["idamp"], T_ref=x["T_ref"],
                             S_ref=x["S_ref"], u_ref=x["u_ref"],
                             v_ref=x["v_ref"], sponge_uv=True)
        s2 = RS.apply_sponge(st, DT, sp, G)
        keep("sponge", (s2.T, s2.S, s2.u, s2.v))
        vp = RSV.SetViscParams(cdrag=0.002, drag_bg_vel=0.05)
        bbl = RSV.set_viscous_bbl(u, v, x["h"], G, vp)
        keep("bbl", bbl + (bbl[0] / jnp.maximum(bbl[2], 1e-3),
                           bbl[1] / jnp.maximum(bbl[3], 1e-3)))
        dp = RSD.DiffusivityParams(bbl_effic=0.2, bryan_lewis=True,
                                   bl_depth=500.0)
        comp = {}
        kd = RSD.set_diffusivity(x["h"], G, GV, dp, kd_extra=x["kd_int"],
                                 T=x["T"], S=x["S"], eos=wright, u=u, v=v,
                                 components=comp)
        keep("set_diffusivity", (kd, comp["Kd_BBL"], comp["Kd_bkgnd"]))
        wp = RW.WaveParams()
        us = x["ustar"]
        keep("u10", (RW.ust_to_u10_coare3p5(us, wp),))
        keep("stokes", RW.stokes_sl_lf17(us, x["hbl"], wp))
        la = RW.langmuir_number(us, x["hbl"], wp)
        keep("langmuir", (
            la, RW.langmuir_number(us, x["hbl"], wp._replace(
                method="EFACTOR"), u10=x["u10"]),
            RW.make_la_fn(wp, us)(x["hbl"])))
        la_c = RW.convective_langmuir_number(la, x["bflux"], us, x["hbl"],
                                             x["absf"], wp)
        keep("enhancement", (la_c, RW.mstar_lt_enhancement(la_c, wp),
                             RW.langmuir_enhancement(la)))
        ustar = jnp.sqrt(jnp.sqrt(x["taux"] ** 2 + x["tauy"] ** 2) / GV.rho0)
        la_fn = RW.make_la_fn(wp, ustar)
        keep("epbl_la", REP.epbl_diffusivity(
            x["h"], x["T"], x["S"], G, GV, wright, x["taux"], x["tauy"],
            x["heat"], dt=DT, la_fn=la_fn, waves=wp))
        keep("kpp_la", RK.kpp_diffusivity(
            x["h"], u, v, x["T"], x["S"], G, GV, wright, x["taux"],
            x["tauy"], x["heat"], la_fn=la_fn))
        bml = RB.BulkMLParams()
        ustar_b = jnp.sqrt(jnp.sqrt(x["taux"] ** 2 + x["tauy"] ** 2)
                           / GV.rho0)
        buoy = 1e-8 * (x["heat"] / jnp.min(x["heat"]))
        keep("bulkml", RB.bulkmixedlayer(x["h"], u, v, x["T"], x["S"], G,
                                         GV, wright, DT, ustar_b, buoy, bml))
        keep("entrain", REN.entrainment_diffusive(
            x["h"], x["T"], x["S"], G, GV, x["kd_int"], DT))
        forcing = RD.BuoyancyForcing(heat_flux=x["heat"],
                                     salt_flux=x["salt"])
        keep("layered", RD.diabatic_layered(
            x["T"], x["S"], x["h"], u, v, forcing, x["taux"], x["tauy"], DT,
            G, GV, RD.DiabaticParams(
                boundary_layer_scheme="BULKML",
                diff=RSD.DiffusivityParams(kd=1e-4)), wright))
        T_e, S_e, p_e = x["T_eos"], x["S_eos"], x["p_eos"]
        keep("teos", (teos.density(T_e, S_e, p_e),
                      teos.density(T_e, S_e, p_e, rho_ref=1035.0),
                      teos.specific_volume(T_e, S_e, p_e))
             + tuple(teos.density_derivs(T_e, S_e, p_e))
             + tuple(__import__("mom6_tpu.eos.roquet_spv", fromlist=["x"])
                     .specific_volume_derivs(T_e, S_e, p_e)))
        rho_t = jnp.asarray(np.linspace(1035.5, 1037.6, NZ), jdt)
        keep("hycom1", (RG.build_hycom1_grid(x["h"], x["T"], x["S"], GV,
                                             teos, rho_t, x["dz"]),))
        keep("pqm", RR.reconstruct(x["T"], x["h"], RR.PQM_IH4IH3))
        keep("pqm_remap", (RR.remap_columns_multi(
            jnp.stack([x["T"], x["S"]]), x["h"], x["h1"], RR.PQM_IH4IH3),))
    out["builders"] = {name: [interop.export(o) for o in getattr(RE, name)(
        **kw, dtype=jdt)] for name, kw in BUILDERS.items()}
    return out


_HELPER = r'''
import pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import test_torch_column_physics as m
with open(%(path)r, "wb") as fh:
    pickle.dump(m.reference(np.float64), fh)
'''

ref64_run, ref64 = torch_x64.fixtures(_HELPER, "column64")


@pytest.fixture(scope="module")
def ref32():
    return reference(np.float32)


def _ref(dtype, request):
    if dtype is np.float32:
        return request.getfixturevalue("ref32")
    return request.getfixturevalue("ref64")


def _port(dtype):
    """The port's grid, vertical grid and inputs as tensors."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    G = build_cartesian_grid(NX, NY, 700.0, 500.0, depth=_depth(),
                             dtype=tdt, device="cpu", **GRID)
    GV = build_layered_vgrid(NZ, gprime_int=GPRIME, dtype=tdt, device="cpu")
    x = {k: None if v is None else torch.from_numpy(v)
         for k, v in inputs(dtype).items()}
    x["u"] = x["u"] * G.mask2dCu
    x["v"] = x["v"] * G.mask2dCv
    return G, GV, x


def _rel(got, want, where=None):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    if where is not None:
        d = np.where(where, d, 0.0)
    return float(d.max() / max(np.abs(want).max(), 1e-300))


def _check(got, want, tol, where=None):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (i, tuple(g.shape), w.shape)
        err = _rel(g, w, where)
        assert err <= tol, (i, err)


@DTYPES
def test_apply_sponge(dtype, request):
    G, GV, x = _port(dtype)
    st = OceanState(h=x["h"], u=x["u"], v=x["v"], T=x["T"], S=x["S"])
    sp = TS.SpongeParams(idamp=x["idamp"], T_ref=x["T_ref"],
                         S_ref=x["S_ref"], u_ref=x["u_ref"],
                         v_ref=x["v_ref"], sponge_uv=True)
    s2 = TS.apply_sponge(st, DT, sp, G)
    _check((s2.T, s2.S, s2.u, s2.v), _ref(dtype, request)["sponge"],
           TOL[dtype])


@DTYPES
def test_set_viscous_bbl_and_piston(dtype, request):
    G, GV, x = _port(dtype)
    vp = TSV.SetViscParams(cdrag=0.002, drag_bg_vel=0.05)
    got = TSV.set_viscous_bbl(x["u"], x["v"], x["h"], G, vp) \
        + TSV.bbl_piston(x["u"], x["v"], x["h"], G, vp)
    _check(got, _ref(dtype, request)["bbl"], TOL[dtype])


@DTYPES
def test_set_diffusivity_with_bbl_mixing(dtype, request):
    """The law-of-the-wall BBL mixing (a march up the interfaces) with
    the Bryan-Lewis floor and an extra diffusivity, and its
    components."""
    G, GV, x = _port(dtype)
    dp = TSD.DiffusivityParams(bbl_effic=0.2, bryan_lewis=True,
                               bl_depth=500.0)
    comp = {}
    kd = TSD.set_diffusivity(x["h"], G, GV, dp, kd_extra=x["kd_int"],
                             T=x["T"], S=x["S"], eos=get_eos("WRIGHT"),
                             u=x["u"], v=x["v"], components=comp)
    want = _ref(dtype, request)["set_diffusivity"]
    _check((kd, comp["Kd_BBL"], comp["Kd_bkgnd"]), want, TOL_MARCH[dtype])
    assert float(comp["Kd_BBL"].max()) > 0.0


@DTYPES
def test_lf17_langmuir_functions(dtype, request):
    """The COARE 3.5 wind (20 passes), the surface-layer Stokes drift,
    La by LF17 and EFACTOR (and through make_la_fn), the convective La
    and both enhancements, on u* down to 0 and depths from 0.5 m."""
    _, _, x = _port(dtype)
    ref = _ref(dtype, request)
    wp = TW.WaveParams()
    us = x["ustar"]
    _check((TW.ust_to_u10_coare3p5(us, wp),), ref["u10"], TOL_MARCH[dtype])
    _check(TW.stokes_sl_lf17(us, x["hbl"], wp), ref["stokes"],
           TOL_MARCH[dtype])
    la = TW.langmuir_number(us, x["hbl"], wp)
    ef = TW.WaveParams(method="EFACTOR")
    _check((la, TW.langmuir_number(us, x["hbl"], ef, u10=x["u10"]),
            TW.make_la_fn(wp, us)(x["hbl"])), ref["langmuir"],
           TOL_MARCH[dtype])
    la_c = TW.convective_langmuir_number(la, x["bflux"], us, x["hbl"],
                                         x["absf"], wp)
    _check((la_c, TW.mstar_lt_enhancement(la_c, wp),
            TW.langmuir_enhancement(la)), ref["enhancement"],
           TOL_MARCH[dtype])


def _la_fn(x, GV):
    ustar = torch.sqrt(torch.sqrt(x["taux"] ** 2 + x["tauy"] ** 2)
                       / GV.rho0)
    return TW.make_la_fn(TW.WaveParams(), ustar)


@DTYPES
def test_epbl_with_langmuir(dtype, request):
    G, GV, x = _port(dtype)
    got = TEP.epbl_diffusivity(x["h"], x["T"], x["S"], G, GV,
                               get_eos("WRIGHT"), x["taux"], x["tauy"],
                               x["heat"], dt=DT, la_fn=_la_fn(x, GV),
                               waves=TW.WaveParams())
    _check(got, _ref(dtype, request)["epbl_la"], TOL_MARCH[dtype])


@DTYPES
def test_kpp_with_langmuir(dtype, request):
    G, GV, x = _port(dtype)
    got = TK.kpp_diffusivity(x["h"], x["u"], x["v"], x["T"], x["S"], G, GV,
                             get_eos("WRIGHT"), x["taux"], x["tauy"],
                             x["heat"], la_fn=_la_fn(x, GV))
    _check(got, _ref(dtype, request)["kpp_la"], TOL_MARCH[dtype])


@DTYPES
def test_bulkmixedlayer(dtype, request):
    """h, T, S and the mixed-layer depth of one step under wind and a
    buoyancy loss of either sign; float32 where the entrained fractions
    agree (see the module's doc)."""
    G, GV, x = _port(dtype)
    ustar = torch.sqrt(torch.sqrt(x["taux"] ** 2 + x["tauy"] ** 2)
                       / GV.rho0)
    buoy = 1e-8 * (x["heat"] / torch.min(x["heat"]))
    got = TB.bulkmixedlayer(x["h"], x["u"], x["v"], x["T"], x["S"], G, GV,
                            get_eos("WRIGHT"), DT, ustar, buoy,
                            TB.BulkMLParams())
    want = _ref(dtype, request)["bulkml"]
    where = None
    if dtype is np.float32:
        where = np.abs(got[3].double().numpy() - want[3]) \
            <= 1e-4 * np.abs(want[3]).max()
        assert where.mean() > 0.95
    _check(got[:3], want[:3], TOL_MARCH[dtype], where)
    _check(got[3:], want[3:], TOL_MARCH[dtype], where)
    # each column keeps its mass
    assert _rel(got[0].sum(0), x["h"].sum(0).numpy()) <= TOL[dtype]


@DTYPES
def test_entrainment_diffusive(dtype, request):
    G, GV, x = _port(dtype)
    got = TEN.entrainment_diffusive(x["h"], x["T"], x["S"], G, GV,
                                    x["kd_int"], DT)
    _check(got, _ref(dtype, request)["entrain"], TOL[dtype])


@DTYPES
def test_diabatic_layered(dtype, request):
    """The layered sequence: surface fluxes, the bulk mixed layer, the
    entrainment and the remap of u and v (float32 where the mixed layers
    agree)."""
    G, GV, x = _port(dtype)
    forcing = TD.BuoyancyForcing(heat_flux=x["heat"], salt_flux=x["salt"])
    p = TD.DiabaticParams(boundary_layer_scheme="BULKML",
                          diff=TSD.DiffusivityParams(kd=1e-4))
    got = TD.diabatic_layered(x["T"], x["S"], x["h"], x["u"], x["v"],
                              forcing, x["taux"], x["tauy"], DT, G, GV, p,
                              get_eos("WRIGHT"))
    want = _ref(dtype, request)["layered"]
    where = None
    if dtype is np.float32:
        where = np.abs(got[5].double().numpy() - want[5]) \
            <= 1e-4 * np.abs(want[5]).max()
        assert where.mean() > 0.95
    _check(got, want, TOL_MARCH[dtype], where)


# Float32 TEOS10 and HYCOM1 are held to the float32 conditioning of each
# output, element by element, not to a fraction of its max-abs.  The
# Roquet polynomials sum ~55 monomials that cancel: u * sum|terms| is
# 1.19e-5 of max|drho_dS| on these inputs, above TOL[f32], so one
# rounding of the largest terms decides a max-abs check, and which side
# it falls on depends on ulp-level choices of the host's pow (XLA's
# float32 pow is the C library's powf, torch.pow is not: they part on 9%
# of sqrt(zs) here).  The bound: K = sum of |c_i| |monomial_i| (times
# the chain rule's factors), evaluated in float64; a float32 evaluation
# of N terms of m products each parts from the exact value by at most
# (N + m) u K, and by ~sqrt(N + m) u K when its roundings are
# independent (Higham 2002, section 2.8): with N + m ~ 63, COND_F32 = 8.
# Measured on an AVX-512 host: the port within 2.31 u K of the exact
# value (the port in float64 on the same float32 inputs, which the f64
# case holds to the reference), within 1.15 u K of the reference's
# float32.  Each package carries its own COND_F32 u K, so the two are
# held to twice it.
U32 = 2.0 ** -24
COND_F32 = 8.0


def _abs_poly(mod, zs, zt, zp, ds=0, dt_=0):
    """sum |c| |zs^i zt^j zp^k| over the terms of ``mod._poly``."""
    total = 0.0
    for i, j, k, c in mod._TERMS:
        if (ds and i < ds) or (dt_ and j < dt_):
            continue
        coef = abs(c)
        for n in range(ds):
            coef *= (i - n)
        for n in range(dt_):
            coef *= (j - n)
        total = total + coef * zs.abs() ** (i - ds) * zt.abs() ** (j - dt_) \
            * zp.abs() ** k
    return total


def _teos_conditioning(T, S, p):
    """float64 (K, exact) of TEOS10's density, its anomaly, specific
    volume, drho/dT, drho/dS, dv/dT and dv/dS at float32 inputs."""
    from mom6_tpu_torch.eos import roquet_spv as SP
    T, S, p = T.double(), S.double(), p.double()
    zs, zt, zp = SP._zs(S), T * SP._I_TS, p * SP._PA2KB
    v = SP.specific_volume(T, S, p)
    dvT, dvS = SP.specific_volume_derivs(T, S, p)
    Kv = _abs_poly(SP, zs, zt, zp) + sum(
        abs(c) * zp.abs() ** (n + 1) for n, c in enumerate(SP._V_PROF))
    KvT = _abs_poly(SP, zs, zt, zp, dt_=1) * SP._I_TS
    KvS = _abs_poly(SP, zs, zt, zp, ds=1) * (0.5 * SP._R1_S0 / zs)
    rho = 1.0 / v
    Krho = rho * Kv / v.abs()
    # drho = -dv / v^2: dv's own K over v^2, and v^2's relative error
    KrT = KvT / v ** 2 + (dvT / v ** 2).abs() * 2.0 * Kv / v.abs()
    KrS = KvS / v ** 2 + (dvS / v ** 2).abs() * 2.0 * Kv / v.abs()
    K = (Krho, Krho, Kv, KrT, KrS, KvT, KvS)
    exact = (rho, rho - 1035.0, v, -dvT / v ** 2, -dvS / v ** 2, dvT, dvS)
    return [k.numpy() for k in K], [e.numpy() for e in exact]


def _check_conditioned(got, want, exact, bound):
    """|got - exact| <= bound and |got - want| <= 2 bound, elementwise."""
    for i, (g, w, e, b) in enumerate(zip(got, want, exact, bound)):
        g = g.double().numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        own = float((np.abs(g - e) / b).max())
        pair = float((np.abs(g - np.asarray(w, np.float64)) / b).max())
        assert own <= 1.0 and pair <= 2.0, (i, own, pair)


@DTYPES
def test_roquet_teos10_eos(dtype, request):
    """Density (and its anomaly), specific volume and both derivatives
    over T in (-2, 30), S in (30, 38) and p up to 4e7 Pa; float32 within
    COND_F32 u K of the exact value and 2 COND_F32 u K of the
    reference's float32, element by element."""
    from mom6_tpu_torch.eos import roquet_spv
    _, _, x = _port(dtype)
    eos = get_eos("TEOS10")
    T, S, p = x["T_eos"], x["S_eos"], x["p_eos"]
    got = (eos.density(T, S, p), eos.density(T, S, p, rho_ref=1035.0),
           eos.specific_volume(T, S, p)) + eos.density_derivs(T, S, p) \
        + roquet_spv.specific_volume_derivs(T, S, p)
    want = _ref(dtype, request)["teos"]
    assert get_eos("ROQUET_SPV").density is eos.density
    if dtype is np.float32:
        K, exact = _teos_conditioning(T, S, p)
        _check_conditioned(got, want, exact, [COND_F32 * U32 * k for k in K])
        return
    _check(got[:1] + got[2:], want[:1] + want[2:], TOL[dtype])
    # the anomaly 1/v - 1035 carries the full density's rounding: its
    # error relative to the density's scale
    err = float(np.abs(got[1].double().numpy() - want[1]).max()
                / np.abs(want[0]).max())
    assert err <= TOL[dtype], err


def _hycom1_bound(h, T, S, GV, rho_t, dz):
    """float64 (bound, exact) of build_hycom1_grid's float32 thicknesses.

    The interfaces are where the running maximum of the centres'
    densities crosses the mean targets, linear between centres: a float32
    density error e moves interface k, in a segment j of depth seg_j and
    density step drho_j that it crosses within e, by at most
    seg_j min(1, e / drho_j); e = 2 (COND_F32 u K_rho + u rho) for the
    segment's two ends plus u |target| for the target's mean.  The depth
    arithmetic (cumsum, the sum over segments, the fraction) adds
    3 nz u col, a thickness (a difference of two interfaces, then the
    renormalisation by col / sum) (nz + 3) u h.  The nominal floor and
    the clamps are 1-Lipschitz."""
    nz = h.shape[0]
    h64, T64, S64 = h.double(), T.double(), S.double()
    GV64 = build_layered_vgrid(NZ, gprime_int=GPRIME, dtype=torch.float64,
                               device="cpu")
    eos = get_eos("TEOS10")
    exact = TG.build_hycom1_grid(h64, T64, S64, GV64, eos, rho_t,
                                 dz).numpy()
    p = torch.full_like(T64, 2e7)
    rho = (GV64.rho0 + eos.density(T64, S64, p, rho_ref=GV64.rho0)).numpy()
    K = _teos_conditioning(T, S, p.float())[0][0]
    e_rho = COND_F32 * U32 * K + U32 * np.abs(rho)
    hn = h64.numpy()
    z_c = np.cumsum(hn, axis=0) - 0.5 * hn
    z_lo = np.concatenate([np.zeros_like(z_c[:1]), z_c[:-1]])
    r_hi = np.maximum.accumulate(rho, axis=0)
    r_lo = np.concatenate([r_hi[:1], r_hi[:-1]])
    e_seg = e_rho + np.concatenate([e_rho[:1], e_rho[:-1]])
    seg, drho = z_c - z_lo, r_hi - r_lo
    tgt = 0.5 * (np.asarray(rho_t[:-1]) + np.asarray(rho_t[1:]))
    col = hn.sum(0)
    dz_int = []
    for t in tgt:
        e = e_seg + U32 * abs(t)
        near = (t >= r_lo - e) & (t <= r_hi + e)
        frac = np.minimum(1.0, e / np.maximum(drho, 1e-300))
        dz_int.append((seg * np.where(near, frac, 0.0)).sum(0)
                      + 3 * nz * U32 * col)
    dz_int = np.stack([np.zeros_like(col)] + dz_int + [nz * U32 * col])
    bound = dz_int[1:] + dz_int[:-1] + (nz + 3) * U32 * np.abs(exact)
    return bound, exact


@DTYPES
def test_build_hycom1_grid(dtype, request):
    """float32 within its conditioning (_hycom1_bound) of the exact
    grid and twice it of the reference's float32, layer by layer."""
    G, GV, x = _port(dtype)
    rho_t = np.linspace(1035.5, 1037.6, NZ).astype(dtype).tolist()
    got = TG.build_hycom1_grid(x["h"], x["T"], x["S"], GV, get_eos("TEOS10"),
                               rho_t, x["dz"].tolist())
    want = _ref(dtype, request)["hycom1"]
    if dtype is np.float32:
        bound, exact = _hycom1_bound(x["h"], x["T"], x["S"], GV, rho_t,
                                     x["dz"].tolist())
        _check_conditioned((got,), want, (exact,), (bound,))
    else:
        _check((got,), want, TOL[dtype])
    assert _rel(got.sum(0), x["h"].sum(0).numpy()) <= TOL[dtype]


@DTYPES
def test_pqm_reconstruction_and_remap(dtype, request):
    """PQM_IH4IH3's five coefficients (quartic or PPM fallback by cell)
    and the remap of T and S with them (the plain version on the CPU;
    float32 coefficients where the bounds test agrees)."""
    _, _, x = _port(dtype)
    got = TR.reconstruct(x["T"], x["h"], TR.PQM_IH4IH3)
    ref = _ref(dtype, request)
    where = None
    if dtype is np.float32:
        # the quartic's fourth coefficient is 0 where it fell back to PPM
        where = (got[4].numpy() == 0.0) == (ref["pqm"][4] == 0.0)
        assert where.mean() > 0.95
    _check(got, ref["pqm"], TOL[dtype], where)
    out = TR.remap_columns_multi(torch.stack([x["T"], x["S"]]), x["h"],
                                 x["h1"], TR.PQM_IH4IH3)
    _check((out,), ref["pqm_remap"], TOL_REMAP[dtype])


@pytest.mark.parametrize("name", list(BUILDERS))
@DTYPES
def test_experiment_builders(name, dtype, request):
    """phillips_2layer, lock_exchange (periodic in y) and seamount build
    what the reference's builders do, to the bit."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    if dtype is np.float32:
        from mom6_tpu.drivers import experiments as RE
        want = [interop.export(o) for o in getattr(RE, name)(
            **BUILDERS[name], dtype=jnp.float32)]
    else:
        want = _ref(dtype, request)["builders"][name]
    G, GV, st, p, f = interop.load_all(*want, device="cpu", dtype=tdt)
    got = getattr(TE, name)(**BUILDERS[name], dtype=tdt, device="cpu")
    for a, b in zip(got[:3], (G, GV, st)):
        for k, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, k), t), k
    assert got[3] == p
    assert got[0].reentrant_y == (name == "lock_exchange")
