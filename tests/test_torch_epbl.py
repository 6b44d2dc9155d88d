"""Column twins of the port's ePBL against the JAX reference
(physics/vertical/epbl.py: find_mstar for the RH18, FIXED and OM4
schemes with the cap and the convective reduction; epbl_diffusivity
under cooling, heating, a flux of either sign and none, the inputs of
tests/test_torch_kpp.py on its basin with thin and vanished bottom
layers), and ePBL through core/mom.py::step_mom (two cycles of the
convective column of tests/test_analytic_parity.py with 20 levels for
its 100, built from the parameter text, kv_shear the ePBL diffusivity;
chip_smoke.py runs the 100 levels, card against CPU).

Tolerances, relative to each field's max-abs: float32 1e-5, float64
1e-10.  The reference runs op by op (jax.disable_jit()); the float64
runs in a JAX_ENABLE_X64=1 subprocess.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu_torch import interop
from mom6_tpu_torch.core.mom import step_mom
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.physics.vertical import epbl
from test_torch_kpp import column_inputs, port_grids, ref_grids
from torch_gates import CONV_BASE
import torch_x64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {np.float32: 1e-5, np.float64: 1e-10}
FLUXES = ["cooling", "heating", "mixed", "none"]
# EPBLParams fields of each scheme case
SCHEMES = {"RH18": {},
           "RH18-conv-cap": dict(mstar_conv_adj=0.5, mstar_cap=1.0,
                                 kd_max=0.05),
           "FIXED": dict(mstar_scheme="FIXED"),
           "OM4": dict(mstar_scheme="OM4", min_mix_len=0.5)}
EPBL_CASES = [(fl, "RH18") for fl in FLUXES] + [
    ("cooling", s) for s in SCHEMES if s != "RH18"]
N_CYCLES = 2


def mstar_inputs(dtype):
    """bflux of both signs, u* down to 0, depths and |f| down to 0
    (numpy).  u* = 0 and f = 0 do not meet in one column: there OM4's
    u*^2 f is 1e-40, a float32 subnormal, which XLA's CPU flushes to zero
    and torch keeps."""
    rng = np.random.default_rng(5)
    n = 64
    x = dict(bflux=rng.uniform(-2e-7, 2e-7, n),
             ustar=np.concatenate([[0.0, 1e-12], rng.uniform(0, 0.03, n - 2)]),
             bld=rng.uniform(1.0, 300.0, n),
             absf=np.concatenate([rng.uniform(1e-6, 1.4e-4, 2), [0.0],
                                  rng.uniform(1e-6, 1.4e-4, n - 3)]))
    return {k: v.astype(dtype) for k, v in x.items()}


def _conv_text():
    return CONV_BASE.replace("NK = 100", "NK = 20") \
        + "ENERGETICS_SFC_PBL = True\n"


def reference(dtype):
    """The reference's find_mstar and epbl_diffusivity outputs by case,
    and, in float64, the convective column's model and its cycles."""
    from mom6_tpu.eos import get_eos as ref_get_eos
    from mom6_tpu.physics.vertical import epbl as ref_epbl
    G, GV = ref_grids(dtype)
    shape = (GV.nz, G.ny, G.nx)
    eos = ref_get_eos("WRIGHT")
    out = {}
    with jax.disable_jit():
        m = {k: jnp.asarray(v) for k, v in mstar_inputs(dtype).items()}
        for name, kw in SCHEMES.items():
            out["mstar", name] = np.asarray(ref_epbl.find_mstar(
                m["bflux"], m["ustar"], m["bld"], m["absf"],
                ref_epbl.EPBLParams(**kw)))
        for flux, scheme in EPBL_CASES:
            x = {k: None if a is None else jnp.asarray(a)
                 for k, a in column_inputs(flux, shape, seed=2,
                                           dtype=dtype).items()}
            kd, mld = ref_epbl.epbl_diffusivity(
                x["h"], x["T"], x["S"], G, GV, eos, x["taux"], x["tauy"],
                x["heat"], ref_epbl.EPBLParams(**SCHEMES[scheme]),
                dt=1800.0)
            out["epbl", flux, scheme] = (np.asarray(kd), np.asarray(mld))
    return out


def conv_column_ref(dtype):
    """The convective ePBL column with 20 levels (built by the
    reference's driver) and the state after each of N_CYCLES cycles, op
    by op."""
    from mom6_tpu.core.mom import step_mom as ref_step_mom
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "MOM_input")
        with open(p, "w") as f:
            f.write(_conv_text())
        ms = build_model_from_params(ParamFile([p]), dtype=dtype)
    G, GV, st, p, f = ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing
    out = {"built": [interop.export(o) for o in (G, GV, st, p, f)],
           "cycles": []}
    with jax.disable_jit():
        for _ in range(N_CYCLES):
            st = ref_step_mom(st, f, G, GV, p)
            out["cycles"].append(interop.export(st))
    return out


_HELPER = r'''
import pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import test_torch_epbl as m
out = {"columns": m.reference(np.float64),
       "conv": m.conv_column_ref(np.float64)}
with open(%(path)r, "wb") as fh:
    pickle.dump(out, fh)
'''


ref64_run, ref64 = torch_x64.fixtures(_HELPER, "epbl64")


@pytest.fixture(scope="module")
def ref32():
    return reference(np.float32)


def _ref(dtype, request):
    """The reference's outputs in ``dtype`` (float64: waits for the
    subprocess)."""
    if dtype is np.float32:
        return request.getfixturevalue("ref32")
    return request.getfixturevalue("ref64")["columns"]


def _rel(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-300))


DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["f32", "f64"])


@pytest.mark.parametrize("scheme", list(SCHEMES))
@DTYPES
def test_find_mstar(scheme, dtype, request):
    m = {k: torch.from_numpy(v) for k, v in mstar_inputs(dtype).items()}
    got = epbl.find_mstar(m["bflux"], m["ustar"], m["bld"], m["absf"],
                          epbl.EPBLParams(**SCHEMES[scheme]))
    want = _ref(dtype, request)["mstar", scheme]
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


@pytest.mark.parametrize("flux,scheme", EPBL_CASES,
                         ids=[f"{a}-{b}" for a, b in EPBL_CASES])
@DTYPES
def test_epbl_diffusivity(flux, scheme, dtype, request):
    G, GV = port_grids(dtype)
    shape = (GV.nz, G.ny, G.nx)
    x = {k: None if a is None else torch.from_numpy(a)
         for k, a in column_inputs(flux, shape, seed=2, dtype=dtype).items()}
    kd, mld = epbl.epbl_diffusivity(
        x["h"], x["T"], x["S"], G, GV, get_eos("WRIGHT"), x["taux"],
        x["tauy"], x["heat"], epbl.EPBLParams(**SCHEMES[scheme]), dt=1800.0)
    kd_r, mld_r = _ref(dtype, request)["epbl", flux, scheme]
    assert tuple(kd.shape) == kd_r.shape == (GV.nz + 1, G.ny, G.nx)
    assert _rel(kd, kd_r) <= TOL[dtype], ("kd", _rel(kd, kd_r))
    assert _rel(mld, mld_r) <= TOL[dtype], ("mld", _rel(mld, mld_r))
    wet = G.mask2dT > 0.5
    assert float(mld[wet].min()) >= 1.0 and not kd[0].any()
    assert float(kd.max()) > 0.0


def test_epbl_raises_for_langmuir():
    """Every wave method of the Langmuir number is ported (LF17 and
    EFACTOR in tests/test_torch_column_physics.py, DHH85 and SURFBANDS in
    tests/test_torch_coupled.py), and CVMix convection and double
    diffusion are too (tests/test_torch_options.py), and so are SPPT and
    SKEB (tests/test_torch_stoch_tides.py), and SPLIT_RK2B
    (tests/test_torch_oda_rk2b.py), and BT_WIDE_HALO (on ranks,
    tests/test_torch_mesh.py), so this holds BT_WIDE_HALO beside ePBL,
    fixed and AUTO, off a mesh: the build reads the width and is the
    build without it otherwise, and a cycle equals the cycle without it
    to the bit."""
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    from torch_widehalo import (assert_build_reads_wide_halo,
                                assert_step_ignores_wide_halo)
    text = CONV_BASE + "ENERGETICS_SFC_PBL = True\nUSE_LA_LI2016 = True\n"
    for value in (-1, 4):
        ms = assert_build_reads_wide_halo(
            lambda t: build_model_from_params(ParamFile(text=t),
                                              device="cpu"),
            text + f"BT_WIDE_HALO = {value}\n")
        assert_step_ignores_wide_halo(
            lambda p: step_mom(ms.state, ms.forcing, ms.grid, ms.vgrid, p),
            ms.params, value, ("h", "u", "v", "T", "S", "kv_shear"))


def test_epbl_cycles_f64(ref64):
    """Two cycles of the cooled 100-level column: the ePBL diffusivity
    feeds the diabatic solve and is the next cycle's kv_shear."""
    ref = ref64["conv"]
    G, GV, st, p, f = interop.load_all(*ref["built"], dtype=torch.float64,
                                       device="cpu")
    assert p.diabatic.boundary_layer_scheme == "EPBL"
    assert st.kv_shear is not None
    with torch.inference_mode():
        for want in ref["cycles"]:
            st = step_mom(st, f, G, GV, p)
            for k in ("h", "u", "v", "T", "S", "kv_shear"):
                err = _rel(getattr(st, k), want[k])
                assert err <= TOL[np.float64], (k, err)
    assert float(st.kv_shear[1:-1].max()) > 0.0
