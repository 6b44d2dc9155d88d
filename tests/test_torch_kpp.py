"""Column twins of the port's boundary-layer and shear mixing against the
JAX reference: physics/vertical/kpp.py (kpp_diffusivity with its bulk
Richardson profile, every nonlocal shape, a constant Cv and Cv(N), under
surface heating, cooling, a flux of either sign and none;
apply_nonlocal_transport with heat, salt and fresh-water fluxes) and
physics/vertical/shear_mixing.py (richardson_number, shear_mixing_kd for
LMD94 and PP81).

Inputs are made with numpy from a seed: a mixed layer over a
thermocline, sheared currents, thin and vanished layers at the bottom of
some columns.  float32 runs here on a 14x10 basin with land (a bowl) and
12 layers; the float64 twins run in tests/test_torch_golden.py on the grid
of configs/benchmark, in the JAX_ENABLE_X64=1 subprocess (x64 is a
process-wide flag) that runs that configuration, which has compiled the
reference's operations at those shapes already.

Tolerances, relative to each field's max-abs: float32 1e-5, float64
1e-10.  The convective velocity scale's cube root is torch.pow(x, 1/3)
in the port and jnp.cbrt in the reference: a few ulps apart, which the
float64 gate cannot see.  The boundary-layer depth is a search whose
branch (rib_mono - r_lo < eps) can flip on one ulp and move a column's
hbl by a segment; the float32 cases count such columns and require none
at this seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mom6_tpu.eos import get_eos as ref_get_eos
from mom6_tpu.grid.grid import build_cartesian_grid as ref_grid
from mom6_tpu.grid.vertical import build_layered_vgrid as ref_vgrid
from mom6_tpu.physics.vertical import kpp as ref_kpp
from mom6_tpu.physics.vertical import shear_mixing as ref_shear
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.grid.grid import build_cartesian_grid
from mom6_tpu_torch.grid.vertical import build_layered_vgrid
from mom6_tpu_torch.physics.vertical import kpp, shear_mixing

torch.set_num_threads(1)

NZ, NY, NX = 12, 10, 14
TOL32, TOL64 = 1e-5, 1e-10
# (surface heat flux, nonlocal shape, Cv): every shape under cooling,
# where the nonlocal transport acts
KPP_CASES = [("heating", "PARABOLIC", 0.0), ("cooling", "PARABOLIC", 0.0),
             ("cooling", "CUBIC", 0.0), ("cooling", "LINEAR", 0.0),
             ("cooling", "CUBIC_LMD", 0.0), ("mixed", "PARABOLIC", 0.0),
             ("mixed", "CUBIC", 1.6), ("none", "PARABOLIC", 0.0)]
KPP_IDS = [f"{a}-{b}-cv{c}" for a, b, c in KPP_CASES]
SHEAR_SCHEMES = ["LMD94", "PP81"]


def _depth():
    x = (np.arange(NX) + 0.5) / NX - 0.5
    y = (np.arange(NY) + 0.5) / NY - 0.5
    return 2000.0 * (1.0 - 0.9 * ((2 * x[None]) ** 2 + (2 * y[:, None]) ** 2))


GRID = dict(max_depth=2000.0, min_depth=10.0, f0=1e-4, beta=2e-11)


def ref_grids(dtype=np.float32):
    """The reference's (G, GV) of the basin in ``dtype``."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    return (ref_grid(NX, NY, 700.0, 500.0, depth=_depth(), dtype=jdt, **GRID),
            ref_vgrid(NZ, dtype=jdt))


def port_grids(dtype=np.float32):
    """The port's (G, GV) of the same basin (the builders agree to the bit,
    tests/test_torch_grid.py)."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return (build_cartesian_grid(NX, NY, 700.0, 500.0, depth=_depth(),
                                 dtype=tdt, device="cpu", **GRID),
            build_layered_vgrid(NZ, dtype=tdt, device="cpu"))


def column_inputs(case, shape, seed=0, dtype=np.float32):
    """h, T, S, u, v ``shape`` (nz, ny, nx), taux, tauy and the heat flux
    (ny, nx) [W m-2, + down; None for the case "none"] as numpy arrays."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    h = rng.uniform(4.0, 40.0, shape) * np.linspace(1.0, 6.0, nz)[:, None,
                                                                 None]
    h[-1, :3, :4] = 1e-3                       # thin
    h[-2:, -2:, -3:] = 1e-10                   # vanished
    z = np.cumsum(h, 0) - 0.5 * h
    hml = rng.uniform(10.0, 120.0, shape[1:])
    below = np.clip((z - hml) / 400.0, 0.0, 1.0)
    T = 20.0 - 14.0 * below + 0.02 * rng.standard_normal(shape)
    S = 35.0 + 0.4 * below + 0.01 * rng.standard_normal(shape)
    decay = np.exp(-z / 60.0)
    u = 0.3 * decay * np.cos(np.linspace(0, 3, nx))[None, None] \
        + 0.02 * rng.standard_normal(shape)
    v = 0.2 * decay * np.sin(np.linspace(0, 2, ny))[None, :, None] \
        + 0.02 * rng.standard_normal(shape)
    heat = {"heating": 150.0 * rng.uniform(0.5, 1.5, shape[1:]),
            "cooling": -300.0 * rng.uniform(0.5, 1.5, shape[1:]),
            "mixed": rng.uniform(-300.0, 200.0, shape[1:]),
            "none": None}[case]
    out = dict(h=h, T=T, S=S, u=u, v=v,
               taux=rng.uniform(-0.2, 0.2, shape[1:]),
               tauy=rng.uniform(-0.1, 0.1, shape[1:]), heat=heat)
    return {k: None if a is None else a.astype(dtype) for k, a in out.items()}


def nonlocal_fluxes(shape, dtype):
    """A temperature flux [degC m s-1], a salt flux [ppt m s-1] and a
    fresh-water flux [m s-1] of either sign, each (ny, nx)."""
    rng = np.random.default_rng(7)
    return {k: (s * rng.uniform(-1.0, 1.0, shape[1:])).astype(dtype)
            for k, s in (("t", 5e-5), ("s", 1e-6), ("fw", 3e-7))}


def _shape(G, GV):
    return (GV.nz, G.ny, G.nx)


def reference_columns(G, GV, dtype):
    """Every reference output of this file on the grid (G, GV), by name:
    ("kpp", case) -> (kd, hbl, nonlocal, rib, z_c); ("shear", scheme) ->
    (Ri, Kd); "nonlocal" -> (T, S) after the nonlocal transport of the
    cooling case's fluxes."""
    eos = ref_get_eos("WRIGHT")
    shape = _shape(G, GV)
    out = {}
    for case, nlt, cv in KPP_CASES:
        x = {k: None if a is None else jnp.asarray(a)
             for k, a in column_inputs(case, shape, dtype=dtype).items()}
        out["kpp", (case, nlt, cv)] = ref_kpp.kpp_diffusivity(
            x["h"], x["u"], x["v"], x["T"], x["S"], G, GV, eos, x["taux"],
            x["tauy"], x["heat"], ref_kpp.KPPParams(nlt_shape=nlt, cv=cv),
            return_rib=True)
    x = {k: jnp.asarray(a) for k, a in
         column_inputs("cooling", shape, dtype=dtype).items()}
    f = {k: jnp.asarray(a) for k, a in nonlocal_fluxes(shape, dtype).items()}
    nlt = out["kpp", ("cooling", "PARABOLIC", 0.0)][2]
    out["nonlocal"] = (
        ref_kpp.apply_nonlocal_transport(x["T"], x["h"], nlt, f["t"],
                                         3600.0),
        ref_kpp.apply_nonlocal_transport(x["S"], x["h"], nlt,
                                         f["s"] - x["S"][0] * f["fw"],
                                         3600.0))
    x = {k: jnp.asarray(a) for k, a in column_inputs(
        "none", shape, seed=1, dtype=dtype).items() if a is not None}
    args = (x["h"], x["u"], x["v"], x["T"], x["S"])
    for scheme in SHEAR_SCHEMES:
        out["shear", scheme] = (
            ref_shear.richardson_number(*args, GV, eos),
            ref_shear.shear_mixing_kd(*args, G, GV, eos,
                                      ref_shear.ShearMixingParams(
                                          scheme=scheme)))
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def port_columns(G, GV, dtype):
    """The port's outputs of :func:`reference_columns`."""
    eos = get_eos("WRIGHT")
    shape = _shape(G, GV)
    out = {}
    for case, nlt, cv in KPP_CASES:
        x = {k: _t(a) for k, a in column_inputs(case, shape,
                                                dtype=dtype).items()}
        out["kpp", (case, nlt, cv)] = kpp.kpp_diffusivity(
            x["h"], x["u"], x["v"], x["T"], x["S"], G, GV, eos, x["taux"],
            x["tauy"], x["heat"], kpp.KPPParams(nlt_shape=nlt, cv=cv),
            return_rib=True)
    x = {k: _t(a) for k, a in column_inputs("cooling", shape,
                                            dtype=dtype).items()}
    f = {k: _t(a) for k, a in nonlocal_fluxes(shape, dtype).items()}
    nlt = out["kpp", ("cooling", "PARABOLIC", 0.0)][2]
    out["nonlocal"] = (
        kpp.apply_nonlocal_transport(x["T"], x["h"], nlt, f["t"], 3600.0),
        kpp.apply_nonlocal_transport(x["S"], x["h"], nlt,
                                     f["s"] - x["S"][0] * f["fw"], 3600.0))
    x = {k: _t(a) for k, a in column_inputs("none", shape, seed=1,
                                            dtype=dtype).items()}
    args = (x["h"], x["u"], x["v"], x["T"], x["S"])
    for scheme in SHEAR_SCHEMES:
        out["shear", scheme] = (
            shear_mixing.richardson_number(*args, GV, eos),
            shear_mixing.shear_mixing_kd(
                *args, G, GV, eos,
                shear_mixing.ShearMixingParams(scheme=scheme)))
    return out


@pytest.fixture(scope="module")
def basin32():
    """(reference, port) outputs on the float32 basin."""
    return (reference_columns(*ref_grids(), np.float32),
            port_columns(*port_grids(), np.float32))


def _rel(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def check_columns(got, want, tol):
    """Each output of :func:`port_columns` within ``tol`` of the
    reference's; returns the number of wet columns whose boundary-layer
    depth moved by more than ``tol`` of its max (a flip of the depth
    search), summed over the KPP cases."""
    flips = 0
    assert sorted(got, key=str) == sorted(want, key=str)
    for key, w in want.items():
        g = got[key]
        assert len(g) == len(w), key
        for i, (gi, wi) in enumerate(zip(g, w)):
            assert gi.shape == wi.shape, (key, i)
            assert _rel(gi, wi) <= tol, (key, i, _rel(gi, wi))
        if key[0] == "kpp":
            err = np.abs(g[1].double().numpy() - w[1])
            flips += int((err > tol * np.abs(w[1]).max()).sum())
    return flips


def test_column_parity_f32(basin32):
    """KPP (kd, hbl, nonlocal shape, Rib, z_c) for every case, the
    nonlocal transport, Ri and the shear Kd, each within 1e-5; no column's
    boundary-layer depth flips at this seed."""
    want, got = basin32
    assert check_columns(got, want, TOL32) == 0


@pytest.mark.parametrize("case,nlt,cv", KPP_CASES, ids=KPP_IDS)
def test_kpp_profiles(basin32, case, nlt, cv):
    kd, hbl, nlt_shape = basin32[1]["kpp", (case, nlt, cv)][:3]
    G, _ = port_grids()
    wet = G.mask2dT > 0.5
    # the boundary layer is deeper than min_hbl somewhere and mixes
    assert float(hbl[wet].max()) > 2.0 and float(kd.max()) > 0.0
    assert not kd[0].any() and not kd[-1].any()
    assert float(hbl.min()) >= 0.0 and not hbl[~wet].any()
    # the nonlocal shape acts only where the surface flux destabilises
    if case in ("heating", "none"):
        assert not nlt_shape.any()
    else:
        assert float(nlt_shape.max()) > 0.0
        assert float(nlt_shape.max()) <= (6.33 if nlt == "CUBIC_LMD" else 1.0)


def test_nonlocal_transport_conserves(basin32):
    """The heat, salt and fresh-water fluxes move T and S but not the
    column contents."""
    G, GV = port_grids()
    x = {k: _t(a) for k, a in column_inputs(
        "cooling", (NZ, NY, NX)).items()}
    T, S = basin32[1]["nonlocal"]
    for new, old in ((T, x["T"]), (S, x["S"])):
        assert float((new - old).abs().max()) > 0.0
        change = ((new - old).double() * x["h"].double()).sum(0)
        scale = float((old.double() * x["h"].double()).sum(0).abs().max())
        assert float(change.abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("scheme", SHEAR_SCHEMES)
def test_shear_mixing_ranges(basin32, scheme):
    ri, kd = basin32[1]["shear", scheme]
    assert ri.shape == (NZ - 1, NY, NX) and kd.shape == (NZ + 1, NY, NX)
    # Ri spans the unstable, the mixing and the stable range
    assert float(ri.min()) < 0.0 < 0.7 < float(ri.max())
    assert float(kd.max()) == pytest.approx(5e-3)
    assert not kd[0].any() and not kd[-1].any()


def test_unported_kpp_options_raise():
    """Every wave method of the Langmuir number is ported (LF17 in
    tests/test_torch_column_physics.py, DHH85 and SURFBANDS in
    tests/test_torch_coupled.py), and double diffusion is too
    (tests/test_torch_options.py), and SPPT (tests/test_torch_stoch_tides.py),
    and SPLIT_RK2B (tests/test_torch_oda_rk2b.py), and BT_WIDE_HALO (on
    ranks, tests/test_torch_mesh.py), so this holds BT_WIDE_HALO beside
    KPP off a mesh: the build reads the width and is the build without it
    otherwise, and a cycle equals the cycle without it to the bit; and
    the JHL scheme is not a CVMix shear scheme."""
    from mom6_tpu_torch.core.mom import step_mom
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    from torch_gates import CONV_BASE
    from torch_widehalo import (assert_build_reads_wide_halo,
                                assert_step_ignores_wide_halo)
    G, GV = port_grids()
    x = {k: _t(a) for k, a in column_inputs("none", (NZ, NY, NX)).items()}
    text = CONV_BASE + "USE_KPP = True\nBT_WIDE_HALO = 4\n"
    ms = assert_build_reads_wide_halo(
        lambda t: build_model_from_params(ParamFile(text=t), device="cpu"),
        text)
    assert_step_ignores_wide_halo(
        lambda p: step_mom(ms.state, ms.forcing, ms.grid, ms.vgrid, p),
        ms.params, 4, ("h", "u", "v", "T", "S", "kv_shear"))
    with pytest.raises(ValueError, match="JHL"):
        shear_mixing.shear_mixing_kd(
            x["h"], x["u"], x["v"], x["T"], x["S"], G, GV,
            get_eos("WRIGHT"), shear_mixing.ShearMixingParams(scheme="JHL"))
