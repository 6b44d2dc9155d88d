"""The open boundaries and the BT_cont transports of the port against the
reference, on the CPU.

* Operators at a small size (3 layers, 10x12 with f and a sloping bottom)
  on inputs made from a seed with numpy: build_obc on every segment form
  of the six run directories with open boundaries (E/W/N/S edges, partial
  extents, multi-scheme lists, SPECIFIED faces with per-layer profiles,
  tracer data), apply_obc for each scheme (FLATHER, ORLANSKI, OBLIQUE,
  GRADIENT, SPECIFIED, FLATHER+ORLANSKI) with the previous step's
  velocities and with exterior data merged in (merge_obc_data),
  update_tracer_reservoirs, set_bt_cont with find_uhbt/find_vhbt over a
  range of velocities, btstep with open boundaries and with BT_cont; and
  one split step (a thermo cycle of one baroclinic step) of
  configs/tc3 and configs/dome from their builds.  The reference runs op
  by op (jax.disable_jit()); float32 within 1e-5 of each field's max-abs
  for an operator, 1e-4 for btstep and a step; float64 within 1e-10, the
  reference in a JAX_ENABLE_X64=1 subprocess (tests/torch_x64.py).
* The builds of kelvin, shelfwave, supercritical, tidal_bay, dome and tc3
  equal the reference's to the bit in float32 and float64, the forcing
  providers' open-boundary data too.
* The port's CLI against the reference's CLI in float64 (op by op) on
  kelvin (an analytic series), tidal_bay (file data and tracer
  reservoirs) and tc3 (BT_cont and four segments): ocean.stats to 1e-12
  (mass, heat, salt) and 1e-9 (KE, APE), the restart fields to 1e-10 of
  max-abs.  The reference's restart lacks the reservoirs (its registry
  does not register them), so a split tidal_bay run on the reference
  restarts them from the initial T and S; the port carries them: a split
  run equals a straight one to the bit, and restarting the reservoirs
  from the initial state (what the reference's restart amounts to)
  changes the run.
* The reference's physics gates of the open boundaries through the port
  (tests/torch_gates.py); dome_plume_turns_west is slow (card only).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu_torch import interop
from mom6_tpu_torch.core import barotropic as tbt
from mom6_tpu_torch.core import continuity_ppm as tcp
from mom6_tpu_torch.core import open_boundary as tob
from mom6_tpu_torch.core.mom import step_mom
from mom6_tpu_torch.diagnostics.sum_output import read_stats
from mom6_tpu_torch.drivers import solo
from mom6_tpu_torch.drivers.config_driver import build_model_from_params
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.framework.restart import restart_differences
from mom6_tpu_torch.io.netcdf import read_nc
import torch_gates
import torch_x64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ, NY, NX = 3, 10, 12
DT = 600.0
OBC_DIRS = ("kelvin", "shelfwave", "supercritical", "tidal_bay", "dome",
            "tc3")
TOL_OP = {np.float32: 1e-5, np.float64: 1e-10}
TOL_STEP = {np.float32: 1e-4, np.float64: 1e-10}
# the segment forms of the six run directories (and the reservoirs,
# nudging and tracer profiles they imply), as OBCSegment keywords
SEGMENTS = {
    "flather_we": [dict(edge="W", eta_ext=0.1, vel_ext=0.05),
                   dict(edge="E", scheme="FLATHER+ORLANSKI")],
    "four_edges": [dict(edge="N", scheme="FLATHER+ORLANSKI"),
                   dict(edge="S", scheme="FLATHER+ORLANSKI"),
                   dict(edge="E", scheme="FLATHER+ORLANSKI"),
                   dict(edge="W", scheme="FLATHER+ORLANSKI")],
    "gradient": [dict(edge="W"), dict(edge="E", scheme="FLATHER+GRADIENT")],
    "partial_specified": [dict(edge="N", lo=7, hi=10, scheme="SPECIFIED",
                               vel_profile="v", T_profile="t",
                               S_profile="s")],
    "tracers": [dict(edge="W", lo=2, hi=8, T_ext=12.0, S_ext=34.0,
                     nudge_timescale=900.0), dict(edge="S", eta_ext=-0.05)],
}
# apply_obc's schemes, each on all four edges (SPECIFIED on N and W)
SCHEMES = ("FLATHER", "ORLANSKI", "OBLIQUE", "GRADIENT", "SPECIFIED",
           "FLATHER+ORLANSKI")


def _inputs():
    """The small model's depth and random fields (numpy float64)."""
    rng = np.random.default_rng(2024)
    depth = 400.0 + 200.0 * (np.arange(NY)[:, None] / NY) \
        * np.ones((1, NX))
    h = depth[None] / NZ * (1.0 + 0.2 * rng.standard_normal((NZ, NY, NX)))
    h = h * depth.sum() / h.sum()          # keep the mean column depth

    def r(scale, shape=(NZ, NY, NX)):
        return scale * rng.standard_normal(shape)
    return dict(
        depth=depth, h=h, u=r(0.2), v=r(0.2), u_old=r(0.2), v_old=r(0.2),
        T=10.0 + r(2.0), S=35.0 + r(0.5), res_T=10.0 + r(2.0),
        res_S=35.0 + r(0.5), eta_ext=r(0.1, (NY, NX)),
        uvel=r(0.05, (NY, NX)), prof_v=-0.1 - 0.05 * np.arange(NZ),
        prof_t=np.array([12.0, 8.0, 4.0]), prof_s=np.full(NZ, 35.5),
        bc_u=r(1e-6), bc_v=r(1e-6), uh=r(2e6), vh=r(2e6),
        rem=np.clip(1.0 - np.abs(r(0.05)), 0.0, 1.0),
        pbce=9.8 * np.abs(1.0 + r(0.1)), eta_pf=r(0.2, (NY, NX)),
        taux=r(0.05, (NY, NX)), ubt=np.linspace(-3.0, 3.0, 25))


def _segments(seg_cls, form, x):
    """OBCSegments of a SEGMENTS entry, the profile names replaced."""
    prof = {"v": x["prof_v"], "t": x["prof_t"], "s": x["prof_s"]}
    out = []
    for kw in SEGMENTS[form]:
        kw = {k: prof[v] if k.endswith("_profile") else v
              for k, v in kw.items()}
        out.append(seg_cls(**kw))
    return out


def _scheme_segments(seg_cls, scheme, x):
    if scheme == "SPECIFIED":
        return [seg_cls(edge="N", scheme="SPECIFIED",
                        vel_profile=x["prof_v"]),
                seg_cls(edge="W", lo=3, hi=9, scheme="SPECIFIED",
                        vel_profile=-x["prof_v"], T_profile=x["prof_t"])]
    return [seg_cls(edge=e, scheme=scheme, eta_ext=0.02, vel_ext=0.01)
            for e in "NSEW"]


def ref_ops(dtype):
    """Every operator of the reference on the small model's inputs, op by
    op, as numpy (with the exported grid, vertical grid and the inputs)."""
    from mom6_tpu.core import barotropic as rbt
    from mom6_tpu.core import continuity_ppm as rcp
    from mom6_tpu.core import open_boundary as rob
    from mom6_tpu.core.state import OceanState
    from mom6_tpu.grid.grid import build_cartesian_grid
    from mom6_tpu.grid.vertical import build_layered_vgrid
    x = _inputs()
    G = build_cartesian_grid(NX, NY, 600.0, 500.0, depth=x["depth"],
                             max_depth=600.0, f0=1e-4, beta=2e-11,
                             dtype=dtype)
    GV = build_layered_vgrid(NZ, gprime_int=0.01, dtype=dtype)
    A = lambda a: jnp.asarray(a, dtype)          # noqa: E731
    mu, mv = np.asarray(G.mask2dCu), np.asarray(G.mask2dCv)
    st = OceanState(h=A(x["h"]), u=A(x["u"] * mu), v=A(x["v"] * mv),
                    T=A(x["T"]), S=A(x["S"]), obc_res_T=A(x["res_T"]),
                    obc_res_S=A(x["res_S"]))
    fields = ("h", "u", "v", "T", "S", "obc_res_T", "obc_res_S")

    def out_of(s):
        return {k: np.asarray(getattr(s, k)) for k in fields
                if getattr(s, k) is not None}
    res = {"grid": interop.export(G), "vgrid": interop.export(GV),
           "builds": {}, "apply": {}, "reservoirs": {}}
    with jax.disable_jit():
        for form in SEGMENTS:
            res["builds"][form] = interop.export(rob.build_obc(
                _segments(rob.OBCSegment, form, x), NY, NX, dtype,
                res_len_in=3000.0, res_len_out=30000.0, nz=NZ))
        for sch in SCHEMES:
            obc = rob.build_obc(_scheme_segments(rob.OBCSegment, sch, x),
                                NY, NX, dtype, nz=NZ)
            res["apply"][sch] = out_of(rob.apply_obc(
                st, obc, G, GV, DT, u_old=A(x["u_old"] * mu),
                v_old=A(x["v_old"] * mv)))
        for form in ("flather_we", "four_edges", "tracers"):
            obc = rob.build_obc(_segments(rob.OBCSegment, form, x), NY, NX,
                                dtype, res_len_in=3000.0,
                                res_len_out=30000.0, nz=NZ)
            res["reservoirs"][form] = out_of(
                rob.update_tracer_reservoirs(st, obc, G, DT))
        obc = rob.build_obc(_segments(rob.OBCSegment, "flather_we", x), NY,
                            NX, dtype, nz=NZ)
        data = rob.OBCData(eta_ext=A(x["eta_ext"]), uvel_ext=A(x["uvel"]))
        merged = rob.merge_obc_data(obc, data)
        res["merged"] = interop.export(merged)
        res["apply_merged"] = out_of(rob.apply_obc(st, merged, G, GV, DT))
        btc = rcp.set_bt_cont(st.h, DT, G, GV)
        res["bt_cont"] = interop.export(btc)
        ubt = A(x["ubt"])[:, None, None]
        res["uhbt"] = np.asarray(rcp.find_uhbt(ubt, btc))
        res["vhbt"] = np.asarray(rcp.find_vhbt(ubt, btc))
        args = (st.u, st.v, A(x["eta_pf"]), A(x["bc_u"] * mu),
                A(x["bc_v"] * mv), st.h, A(x["uh"] * mu), A(x["vh"] * mv),
                A(x["rem"]), A(x["rem"]), A(x["pbce"]), A(x["eta_pf"]), DT,
                G, GV)
        four = rob.build_obc(_segments(rob.OBCSegment, "four_edges", x),
                             NY, NX, dtype, nz=NZ)
        spec = rob.build_obc(_scheme_segments(rob.OBCSegment, "SPECIFIED",
                                              x), NY, NX, dtype, nz=NZ)
        res["btstep"] = {}
        for case, kw in (("obc", dict(obc=four)), ("spec", dict(obc=spec)),
                         ("bt_cont", dict(bt_cont=btc)),
                         ("both", dict(bt_cont=btc, obc=four))):
            bt = rbt.BTParams(nstep=12, nfilter=3,
                              use_bt_cont="bt_cont" in kw)
            out = rbt.btstep(*args, bt, taux=A(x["taux"] * mu),
                             x_first=case != "both", **kw)
            res["btstep"][case] = [np.asarray(a) for a in out]
    res["steps"] = {name: ref_step(name, dtype) for name in ("tc3", "dome")}
    return res


def _reference_build(name, dtype, override=""):
    from mom6_tpu.drivers.config_driver import \
        build_model_from_params as ref_build_model
    from mom6_tpu.framework.config import ParamFile as RefParamFile
    path = os.path.join(REPO, "configs", name, "MOM_input")
    return ref_build_model(RefParamFile([path], text=override or None),
                           dtype=dtype)


def ref_step(name, dtype):
    """The build of configs/<name> with one baroclinic step per thermo
    cycle, and its state after one cycle, op by op."""
    from mom6_tpu.core.mom import step_mom as ref_step_mom
    ms = _reference_build(name, dtype)
    p = ms.params._replace(n_dyn_per_thermo=1)
    with jax.disable_jit():
        s = ref_step_mom(ms.state, ms.forcing, ms.grid, ms.vgrid, p)
    return {"built": [interop.export(o) for o in (
        ms.grid, ms.vgrid, ms.state, p, ms.forcing)],
        "after": {k: np.asarray(getattr(s, k)) for k in ("h", "u", "v",
                                                         "T", "S")
                  if getattr(s, k) is not None}}


def ref_builds(dtype):
    """The six builds, exported, with the provider's forcing at 0 and
    at 1 h 20 min."""
    out = {}
    for name in OBC_DIRS:
        ms = _reference_build(name, dtype)
        rec = [interop.export(o) for o in (ms.grid, ms.vgrid, ms.state,
                                           ms.params, ms.forcing)]
        prov = None
        if ms.forcing_provider is not None:
            prov = [interop.export(ms.forcing_provider(t))
                    for t in (0.0, 4800.0)]
        out[name] = (rec, prov)
    return out


# --- the CLI against the reference's CLI ----------------------------------

CLI_CYCLES = {"kelvin": 6, "tidal_bay": 4, "tc3": 4}


def cli_dir(name, where, override="", f64=True):
    """A copy of configs/<name> (with its data files) whose MOM_override
    asks for an ocean.stats line per thermo cycle, float64 with ``f64``,
    and ``override``; returns (the directory, the cycle's seconds)."""
    d = os.path.join(where, name)
    shutil.copytree(os.path.join(REPO, "configs", name), d)
    pf = ParamFile([os.path.join(d, "MOM_input")])
    dt = pf.get("DT", float)
    cycle = pf.get("DT_THERM", float, default=dt)
    with open(os.path.join(d, "MOM_override"), "w") as f:
        f.write(f"DOUBLE_PRECISION = {f64}\nENERGYSAVEDAYS = "
                f"{cycle / 86400.0!r}\n{override}")
    return d, cycle


def reference_cli(work):
    """kelvin, tidal_bay and tc3 through the reference's CLI in float64,
    op by op; returns {name: run directory}."""
    from mom6_tpu.drivers import solo as ref_solo
    out = {}
    for name, n in CLI_CYCLES.items():
        d, cycle = cli_dir(name, os.path.join(work, "ref"))
        with jax.disable_jit():
            ref_solo.main([d, "--days", repr(n * cycle / 86400.0)])
        out[name] = d
    return out


_HELPER = r'''
import os, pickle, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import test_torch_obc as m
work = os.path.dirname(%(path)r)
out = {"ops": m.ref_ops(np.float64), "builds": m.ref_builds(np.float64),
       "cli": m.reference_cli(work)}
with open(%(path)r, "wb") as fh:
    pickle.dump(out, fh)
'''

ref64_run, ref64 = torch_x64.fixtures(_HELPER, "obc64")


@pytest.fixture(scope="module")
def ref32():
    return ref_ops(np.float32)


def _ref(request, dtype):
    if dtype is np.float32:
        return request.getfixturevalue("ref32")
    return request.getfixturevalue("ref64")["ops"]


def _tdt(dtype):
    return torch.float32 if dtype is np.float32 else torch.float64


def _port_setup(ref, dtype):
    """The grid, vertical grid, state and inputs of ref_ops in the port."""
    tdt = _tdt(dtype)
    G = interop.load_grid(ref["grid"], device="cpu", dtype=tdt)
    GV = interop.load_vgrid(ref["vgrid"], device="cpu", dtype=tdt)
    x = _inputs()

    def t(a):
        return torch.tensor(np.asarray(a, dtype), dtype=tdt)
    mu, mv = G.mask2dCu.numpy(), G.mask2dCv.numpy()
    from mom6_tpu_torch.core.state import OceanState
    st = OceanState(h=t(x["h"]), u=t(x["u"] * mu), v=t(x["v"] * mv),
                    T=t(x["T"]), S=t(x["S"]), obc_res_T=t(x["res_T"]),
                    obc_res_S=t(x["res_S"]))
    return G, GV, st, x, t, mu, mv


def _err(got, want):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _check_state(s, want, tol):
    for k, w in want.items():
        err = _err(getattr(s, k), w)
        assert err <= tol, (k, err)


DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64],
                                 ids=["f32", "f64"])


@DTYPES
@pytest.mark.parametrize("form", list(SEGMENTS))
def test_build_obc_equals_reference(form, dtype, request):
    """The dense masks and data to the bit."""
    ref = _ref(request, dtype)
    x = _inputs()
    got = tob.build_obc(_segments(tob.OBCSegment, form, x), NY, NX,
                        _tdt(dtype), res_len_in=3000.0, res_len_out=30000.0,
                        nz=NZ, device="cpu")
    assert got == interop.load_obc(ref["builds"][form], device="cpu",
                                   dtype=_tdt(dtype))


def test_interop_refuses_another_rx_max(request):
    """The port fixes the radiation schemes' CFL cap at RX_MAX: a
    reference OBCParams that carries another cap is refused."""
    d = request.getfixturevalue("ref32")["builds"]["flather_we"]
    assert d["rx_max"] == tob.RX_MAX
    interop.load_obc(d, device="cpu")
    with pytest.raises(NotImplementedError, match="rx_max"):
        interop.load_obc(dict(d, rx_max=0.5), device="cpu")


@DTYPES
@pytest.mark.parametrize("scheme", SCHEMES)
def test_apply_obc(scheme, dtype, request):
    ref = _ref(request, dtype)
    G, GV, st, x, t, mu, mv = _port_setup(ref, dtype)
    obc = tob.build_obc(_scheme_segments(tob.OBCSegment, scheme, x), NY,
                        NX, _tdt(dtype), nz=NZ, device="cpu")
    out = tob.apply_obc(st, obc, G, GV, DT, u_old=t(x["u_old"] * mu),
                        v_old=t(x["v_old"] * mv))
    _check_state(out, ref["apply"][scheme], TOL_OP[dtype])


@DTYPES
@pytest.mark.parametrize("form", ["flather_we", "four_edges", "tracers"])
def test_update_tracer_reservoirs(form, dtype, request):
    ref = _ref(request, dtype)
    G, GV, st, x, t, mu, mv = _port_setup(ref, dtype)
    obc = tob.build_obc(_segments(tob.OBCSegment, form, x), NY, NX,
                        _tdt(dtype), res_len_in=3000.0, res_len_out=30000.0,
                        nz=NZ, device="cpu")
    out = tob.update_tracer_reservoirs(st, obc, G, DT)
    _check_state(out, ref["reservoirs"][form], TOL_OP[dtype])


@DTYPES
def test_merge_obc_data(dtype, request):
    ref = _ref(request, dtype)
    G, GV, st, x, t, mu, mv = _port_setup(ref, dtype)
    obc = tob.build_obc(_segments(tob.OBCSegment, "flather_we", x), NY, NX,
                        _tdt(dtype), nz=NZ, device="cpu")
    merged = tob.merge_obc_data(obc, tob.OBCData(eta_ext=t(x["eta_ext"]),
                                                 uvel_ext=t(x["uvel"])))
    assert merged == interop.load_obc(ref["merged"], device="cpu",
                                      dtype=_tdt(dtype))
    assert tob.merge_obc_data(obc, None) is obc
    _check_state(tob.apply_obc(st, merged, G, GV, DT), ref["apply_merged"],
                 TOL_OP[dtype])


@DTYPES
def test_set_bt_cont_and_find_hbt(dtype, request):
    ref = _ref(request, dtype)
    G, GV, st, x, t, mu, mv = _port_setup(ref, dtype)
    btc = tcp.set_bt_cont(st.h, DT, G, GV)
    want = interop.load_bt_cont(ref["bt_cont"], device="cpu",
                                dtype=_tdt(dtype))
    for k, w in want._asdict().items():
        assert _err(getattr(btc, k), w) <= TOL_OP[dtype], k
    ubt = t(x["ubt"])[:, None, None]
    assert _err(tcp.find_uhbt(ubt, btc), ref["uhbt"]) <= TOL_OP[dtype]
    assert _err(tcp.find_vhbt(ubt, btc), ref["vhbt"]) <= TOL_OP[dtype]


@DTYPES
@pytest.mark.parametrize("case", ["obc", "spec", "bt_cont", "both"])
def test_btstep_with_obc_and_bt_cont(case, dtype, request):
    ref = _ref(request, dtype)
    G, GV, st, x, t, mu, mv = _port_setup(ref, dtype)
    kw = {}
    if case in ("bt_cont", "both"):
        kw["bt_cont"] = tcp.set_bt_cont(st.h, DT, G, GV)
    if case != "bt_cont":
        kw["obc"] = tob.build_obc(
            _segments(tob.OBCSegment, "four_edges", x) if case != "spec"
            else _scheme_segments(tob.OBCSegment, "SPECIFIED", x),
            NY, NX, _tdt(dtype), nz=NZ, device="cpu")
    bt = tbt.BTParams(nstep=12, nfilter=3, use_bt_cont="bt_cont" in kw)
    out = tbt.btstep(st.u, st.v, t(x["eta_pf"]), t(x["bc_u"] * mu),
                     t(x["bc_v"] * mv), st.h, t(x["uh"] * mu),
                     t(x["vh"] * mv), t(x["rem"]), t(x["rem"]),
                     t(x["pbce"]), t(x["eta_pf"]), DT, G, GV, bt,
                     taux=t(x["taux"] * mu), x_first=case != "both", **kw)
    for name, got, want in zip(tbt.BTOut._fields, out,
                               ref["btstep"][case]):
        assert _err(got, want) <= TOL_STEP[dtype], (name, _err(got, want))


@DTYPES
@pytest.mark.parametrize("name", ["tc3", "dome"])
def test_one_split_step(name, dtype, request):
    """One baroclinic step (BT_cont and four Flather-Orlanski segments in
    tc3; the SPECIFIED inflow, z* and the EOS in dome) from the build."""
    rec = _ref(request, dtype)["steps"][name]
    G, GV, st, p, f = interop.load_all(*rec["built"], device="cpu",
                                       dtype=_tdt(dtype))
    assert p.obc is not None and p.n_dyn_per_thermo == 1
    assert p.dyn.bt.use_bt_cont == (name == "tc3")
    with torch.inference_mode():
        out = step_mom(st, f, G, GV, p)
    _check_state(out, rec["after"], TOL_STEP[dtype])


# --- the builds ------------------------------------------------------------

def _port_build(name, dtype):
    path = os.path.join(REPO, "configs", name, "MOM_input")
    return build_model_from_params(ParamFile([path]), dtype=dtype,
                                   device="cpu")


def _assert_same_build(ms, rec, prov, tdt):
    G, GV, st, p, f = interop.load_all(*rec, device="cpu", dtype=tdt)
    for a, b in ((ms.grid, G), (ms.vgrid, GV), (ms.state, st),
                 (ms.forcing.mech, f.mech), (ms.forcing.buoy, f.buoy)):
        for name, v in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), v), name
        for name in tensor_fields(a):
            assert getattr(b, name) is not None, name
    assert ms.params == p
    assert (ms.forcing_provider is None) == (prov is None)
    for t, want in zip((0.0, 4800.0), prov or ()):
        got = ms.forcing_provider(t).obc_data
        want = interop.load_forcing(want, device="cpu", dtype=tdt).obc_data
        assert (got is None) == (want is None)
        if got is not None:
            assert tensor_fields(got).keys() == tensor_fields(want).keys()
            for name, v in tensor_fields(want).items():
                assert torch.equal(getattr(got, name), v), (t, name)


@pytest.mark.parametrize("name", OBC_DIRS)
def test_build_equals_reference_f32(name):
    ref = _reference_build(name, jnp.float32)
    rec = [interop.export(o) for o in (ref.grid, ref.vgrid, ref.state,
                                       ref.params, ref.forcing)]
    prov = None if ref.forcing_provider is None else [
        interop.export(ref.forcing_provider(t)) for t in (0.0, 4800.0)]
    ms = _port_build(name, torch.float32)
    _assert_same_build(ms, rec, prov, torch.float32)
    assert ms.params.obc is not None
    assert ms.params.dyn.bt.use_bt_cont == (name == "tc3")


@pytest.mark.parametrize("name", OBC_DIRS)
def test_build_equals_reference_f64(name, ref64):
    rec, prov = ref64["builds"][name]
    _assert_same_build(_port_build(name, torch.float64), rec, prov,
                       torch.float64)


def test_unknown_scheme_token_raises():
    """The reference warns and drops an OBC scheme token it does not
    know; the port raises naming it."""
    text = "OBC_SEGMENT_002 = \"I=N,J=0:N,FLATHER,ORLANSKI_TAN\"\n"
    path = os.path.join(REPO, "configs", "kelvin", "MOM_input")
    with pytest.raises(NotImplementedError, match="ORLANSKI_TAN"):
        build_model_from_params(ParamFile([path], text=text), device="cpu")


# --- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("port_obc_cli"))
    out = {}
    for name, n in CLI_CYCLES.items():
        d, cycle = cli_dir(name, work)
        solo.main([d, "--days", repr(n * cycle / 86400.0)], device="cpu")
        out[name] = d
    return out


@pytest.mark.parametrize("name", list(CLI_CYCLES))
def test_cli_matches_reference(name, ref64, port_cli):
    got = read_stats(os.path.join(port_cli[name], "ocean.stats"))
    want = read_stats(os.path.join(ref64["cli"][name], "ocean.stats"))
    assert len(got) == len(want) == CLI_CYCLES[name]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        for k in ("Mass", "Salt", "Heat"):
            if k in w:
                assert abs(g[k] - w[k]) <= 1e-12 * abs(w[k]), (k, g, w)
        for k in ("KE", "APE", "En"):
            assert abs(g[k] - w[k]) <= 1e-9 * abs(w[k]), (k, g, w)
    a = read_nc(os.path.join(port_cli[name], "MOM.res.nc"))
    b = read_nc(os.path.join(ref64["cli"][name], "MOM.res.nc"))
    # the reference's registry has no reservoirs (ROADMAP queue 3)
    extra = {"obc_res_T", "obc_res_S"} if name == "tidal_bay" else set()
    assert set(a) - set(b) == extra and set(b) <= set(a)
    for k, e in restart_differences_common(a, b).items():
        assert e <= 1e-10, (k, e)


def restart_differences_common(a, b, h_wet=1e-3):
    """restart_differences on the fields both restart dictionaries
    hold."""
    import tempfile
    from mom6_tpu_torch.io.netcdf import NCWriter
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, src in enumerate((a, b)):
            p = os.path.join(d, f"{i}.nc")
            w = NCWriter(p)
            for k in set(a) & set(b):
                w.write_static(k, np.asarray(src[k]))
            w.close()
            paths.append(p)
        return restart_differences(*paths, h_wet)


# --- the reservoirs across a restart -----------------------------------------

FRONT = "TS_CONFIG = front\nT_RANGE = 4.0\nFRONT_WIDTH_FRAC = 0.3\n"


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_tidal_bay_split_run_equals_straight_run(dtype, tmp_path):
    """tidal_bay with a front in x: 2 + 2 thermo cycles through the CLI
    equal 4 straight ones to the bit, the reservoirs included (an
    ocean.stats line a cycle, so that both runs take the segment data
    at the same times)."""
    runs = {}
    for sub in ("straight", "first", "second"):
        runs[sub], cycle = cli_dir("tidal_bay", str(tmp_path / sub), FRONT,
                                   f64=dtype == "f64")
    two, four = repr(2 * cycle / 86400.0), repr(4 * cycle / 86400.0)
    solo.main([runs["straight"], "--days", four], device="cpu")
    solo.main([runs["first"], "--days", two], device="cpu")
    shutil.copy(os.path.join(runs["first"], "RESTART", "ocean_solo.res"),
                runs["second"])
    solo.main([runs["second"], "--days", two, "--restart-in",
               os.path.join(runs["first"], "MOM.res.nc")], device="cpu")
    a = read_nc(os.path.join(runs["straight"], "MOM.res.nc"))
    b = read_nc(os.path.join(runs["second"], "MOM.res.nc"))
    assert "obc_res_T" in a and sorted(a) == sorted(b)
    for k in a:
        if k != "__step__":
            assert np.array_equal(a[k], b[k]), k
    assert a["h"].dtype.itemsize == (8 if dtype == "f64" else 4)


def test_reservoirs_restarted_from_the_initial_state_differ():
    """What the reference's restart amounts to: the second segment with
    the reservoirs of the initial state (its builder's copy of T and S)
    parts from the straight run; with the carried reservoirs it does not.
    The reservoirs by then differ from the initial state at the strip."""
    ms = build_model_from_params(ParamFile(
        [os.path.join(REPO, "configs", "tidal_bay", "MOM_input")],
        text=FRONT), dtype=torch.float64, device="cpu")
    cycle = ms.params.dyn.dt * ms.params.n_dyn_per_thermo

    def cycles(s, k0, n):
        with torch.inference_mode():
            for k in range(k0, k0 + n):
                s = step_mom(s, ms.forcing_provider((k + 0.5) * cycle),
                             ms.grid, ms.vgrid, ms.params)
        return s
    s0 = ms.state
    s2 = cycles(s0, 0, 2)
    straight = cycles(s2, 2, 2)
    lost = cycles(s2.replace(obc_res_T=s0.obc_res_T,
                             obc_res_S=s0.obc_res_S), 2, 2)
    strip = (slice(None), slice(None), 0)
    assert float((s2.obc_res_T - s0.obc_res_T)[strip].abs().max()) > 1e-6
    assert float((lost.T - straight.T)[strip].abs().max()) > 1e-6
    assert torch.equal(cycles(s2, 2, 2).T, straight.T)


# --- the physics gates ----------------------------------------------------------

OBC_GATES = ("supercritical_steps_stably", "kelvin_wave_trapped_at_coast",
             "shelfwave_trapped_on_shelf", "dome_inflow_enters_and_descends",
             "dome_plume_turns_west", "tidal_bay_file_forcing",
             "tc3_circle_obcs_radiation", "flather_radiates_waves_out",
             "orlanski_radiates_waves_out")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow)
    if n == "dome_plume_turns_west" else n for n in OBC_GATES])
def test_obc_physics_gate(name):
    rec = torch_gates.run_gate(name, "cpu")
    assert np.isfinite(rec["measured"])
