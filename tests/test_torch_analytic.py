"""The configurations of the reference's physics gates through the port,
and the gates themselves.

* The builds: configs/external_gwave, soliton and tracer_batch and the
  parameter texts of tests/test_analytic_parity.py (THICKNESS_CONFIG =
  gwave, internal_wave, sloshing and soliton with its u, TS_CONFIG =
  front, BUOY_CONFIG = const, ENERGETICS_SFC_PBL, SPLIT = False, the
  spherical and Mercator grids, the 24 tracers of tracer_batch), each
  equal to the reference's build to the bit in float32.
* The unsplit steppers (core/dynamics_unsplit.py, RK3 and RK2, through
  step_mom) over 3 steps of a 48x24 soliton from its built state:
  float32 within 1e-5 of the reference's op-by-op run, float64 within
  1e-10 (the reference in a JAX_ENABLE_X64=1 subprocess), relative to
  each field's max-abs.
* The gates of tests/test_analytic_parity.py and tests/test_pf_pierced.py
  run through the port at their own size and length with their own
  asserts (tests/torch_gates.py).  Those whose CPU run takes longer than
  ~10 s on one worker are marked slow (CPU seconds in CHANGES.md);
  chip_smoke.py runs all twelve on the card.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax

from mom6_tpu_torch import interop
from mom6_tpu_torch.core.mom import step_mom
from mom6_tpu_torch.drivers.config_driver import build_model_from_params
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.containers import tensor_fields
import torch_gates
import torch_x64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {np.float32: 1e-5, np.float64: 1e-10}
N_STEPS = 3
SMALL_SOLITON = "NIGLOBAL = 48\nNJGLOBAL = 24\n"
# name -> (config directory or None, parameter text or None)
BUILDS = {
    "external_gwave": ("external_gwave", None),
    "soliton": ("soliton", None),
    "tracer_batch": ("tracer_batch", None),
    "internal_wave": (None, torch_gates.INTERNAL_WAVE),
    "sloshing": (None, torch_gates.INTERNAL_WAVE.replace(
        "internal_wave", "sloshing").replace("IC_INTERFACE = 1\n", "")
        .replace("IC_WAVELENGTH_FRAC = 0.5\n", "")),
    "lock_exchange_front": (None, torch_gates.LOCK_EXCHANGE),
    "convection_const_epbl": (None, torch_gates.CONV_BASE
                              + "ENERGETICS_SFC_PBL = True\n"),
    "convection_kpp": (None, torch_gates.CONV_BASE + "USE_KPP = True\n"),
    "tracer_batch_mercator": ("tracer_batch", "GRID_CONFIG = mercator\n"),
}
# gates that fit tier-1 on the CPU; the rest are marked slow
FAST_GATES = ("external_gwave_phase_speed", "internal_wave_speed",
              "soliton_boyd_speed", "pierced_face_rest_pf_small",
              "pierced_face_force_continuous_in_sliver",
              "phillips_jet_balanced", "scm_kpp_mixes_under_wind",
              "neverworld_topography_and_stability",
              "hurricane_wind_structure")


def _paramfile(pf_cls, case, tmp):
    cfg, text = BUILDS[case] if case in BUILDS else case
    if cfg is not None:
        path = os.path.join(REPO, "configs", cfg, "MOM_input")
        return pf_cls([path], text=text) if text else pf_cls([path])
    p = os.path.join(tmp, "MOM_input")
    with open(p, "w") as f:
        f.write(text)
    return pf_cls([p])


def ref_build(case, dtype):
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_builder
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    with tempfile.TemporaryDirectory() as d:
        return ref_builder(_paramfile(RefParamFile, case, d), dtype=dtype)


def port_build(case, dtype):
    with tempfile.TemporaryDirectory() as d:
        return build_model_from_params(_paramfile(ParamFile, case, d),
                                       dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_equals_reference(case):
    ref = ref_build(case, np.float32)
    ms = port_build(case, torch.float32)
    for part in ("grid", "vgrid", "state"):
        r, t = getattr(ref, part), getattr(ms, part)
        for name, v in tensor_fields(t).items():
            assert torch.equal(v, torch.from_numpy(
                np.array(getattr(r, name)))), (part, name)
    for part, names in (("mech", ("taux", "tauy")),
                        ("buoy", ("heat_flux", "t_restore"))):
        for name in names:
            r = getattr(getattr(ref.forcing, part), name)
            t = getattr(getattr(ms.forcing, part), name)
            assert (r is None) == (t is None), (part, name)
            if t is not None:
                assert torch.equal(t, torch.from_numpy(np.array(r))), name
    loaded = interop.load_params(interop.export(ref.params))
    assert ms.params == loaded.replace(tfc=ms.params.tfc)
    if ref.state.tr is None:
        assert ms.state.tr is None and ms.params.tfc is None
    else:
        assert ms.params.tfc.registry.names == ref.params.tfc.registry.names
        assert list(ms.state.tr) == list(ref.state.tr)
        for name, v in ms.state.tr.items():
            assert torch.equal(v, torch.from_numpy(
                np.array(ref.state.tr[name]))), name


def test_tracer_batch_names():
    """tracer_batch's 24 registered tracers and their clock, in the
    reference's order."""
    ms = port_build("tracer_batch", torch.float32)
    names = ms.params.tfc.registry.names
    assert len(names) == 24
    assert names[:1] == ["age"] and names[-4:] == ["dye020", "pseudo_salt",
                                                   "cfc11", "cfc12"]
    assert sorted(set(ms.state.tr) - set(names)) == ["_cfc_clock"]


# the id "phillips" keeps its name; THICKNESS_CONFIG = phillips is ported,
# so it holds the next THICKNESS_CONFIG still to port
@pytest.mark.parametrize("text,match", [
    ("USE_REGIONAL_DYES = True\nNUM_DYE_TRACERS = 2\n"
     "DYE_SOURCE_MINLON = 1.0,2.0,3.0\n", "DYE_SOURCE_MINLON"),
    ("THICKNESS_CONFIG = benchmark\n", "THICKNESS_CONFIG"),
    ("TS_CONFIG = benchmark\n", "TS_CONFIG"),
    ("GRID_CONFIG = spherical\nUSE_GENERIC_TRACER = True\n",
     "USE_GENERIC_TRACER"),
], ids=["dye-lengths", "phillips", "ts-benchmark", "generic-tracer"])
def test_build_rejects(text, match):
    """Lists of the wrong length raise ValueError, as in the reference;
    what stays unported raises naming itself."""
    cfg = os.path.join(REPO, "configs", "tracer_batch", "MOM_input")
    exc = ValueError if match.startswith("DYE") else NotImplementedError
    with pytest.raises(exc, match=match):
        build_model_from_params(ParamFile([cfg], text=text), device="cpu")


def unsplit_ref(dtype):
    """The small soliton's build and its state after each of N_STEPS
    steps of each scheme, op by op."""
    from mom6_tpu.core.mom import step_mom as ref_step_mom
    out = {}
    for scheme in ("RK3", "RK2"):
        ms = ref_build(("soliton", SMALL_SOLITON
                        + f"UNSPLIT_SCHEME = {scheme}\n"), dtype)
        st = ms.state
        rec = {"built": [interop.export(o) for o in (
            ms.grid, ms.vgrid, st, ms.params, ms.forcing)], "steps": []}
        with jax.disable_jit():
            for _ in range(N_STEPS):
                st = ref_step_mom(st, ms.forcing, ms.grid, ms.vgrid,
                                  ms.params)
                rec["steps"].append({k: np.asarray(getattr(st, k))
                                     for k in ("h", "u", "v")})
        out[scheme] = rec
    return out


_HELPER = r'''
import pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import test_torch_analytic as m
with open(%(path)r, "wb") as fh:
    pickle.dump(m.unsplit_ref(np.float64), fh)
'''


ref64_run, ref64 = torch_x64.fixtures(_HELPER, "unsplit64")


@pytest.fixture(scope="module")
def ref32():
    return unsplit_ref(np.float32)


@pytest.mark.parametrize("scheme", ["RK3", "RK2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_unsplit_steps(scheme, dtype, request):
    rec = request.getfixturevalue("ref32" if dtype is np.float32
                                  else "ref64")[scheme]
    tdt = torch.float32 if dtype is np.float32 else torch.float64
    G, GV, st, p, f = interop.load_all(*rec["built"], dtype=tdt,
                                       device="cpu")
    assert p.unsplit is not None and p.unsplit_scheme == scheme
    with torch.inference_mode():
        for n, want in enumerate(rec["steps"]):
            st = step_mom(st, f, G, GV, p)
            for k, w in want.items():
                got = getattr(st, k).double().numpy()
                err = np.abs(got - w).max() / np.abs(w).max()
                assert err <= TOL[dtype], (n, k, err)


@pytest.mark.parametrize("name", [
    n if n in FAST_GATES else pytest.param(n, marks=pytest.mark.slow)
    for n in torch_gates.GATES])
def test_physics_gate(name):
    rec = torch_gates.run_gate(name, "cpu")
    assert np.isfinite(rec["measured"])


def test_spherical_grid_defaults_to_the_card(monkeypatch):
    """Without device= the spherical builder asks for CUDA and raises
    without a card; with device="cpu" it equals the reference's grid."""
    from mom6_tpu.grid.grid import build_spherical_grid as ref_spherical
    from mom6_tpu_torch.grid.grid import build_spherical_grid
    args = (12, 10, 0.0, -25.0, 40.0, 55.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_spherical_grid(*args)
    for iso in (False, True):
        G = build_spherical_grid(*args, isotropic=iso, device="cpu")
        R = ref_spherical(*args, isotropic=iso)
        for name, v in tensor_fields(G).items():
            assert torch.equal(v, torch.from_numpy(
                np.array(getattr(R, name)))), (iso, name)
