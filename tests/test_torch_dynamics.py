"""Parity of the port's adiabatic dynamics with the JAX reference, on CPU:
the Montgomery pressure force, Coriolis/advection, the implicit vertical
viscosity, the barotropic solver, one split-RK2 step and a 6-step
run_segment of the double gyre carried across with interop.py.

Tolerances (float32): the two packages perform the same operations, but
sum over k in different orders, evaluate pow/exp in different libraries
and may contract products differently on the CPU, so results differ by
f32 ulps that the step amplifies mildly.  Single operators are held to
1e-5 of each field's max-abs; the barotropic solver (38 substeps of
accumulation) and one full step to 1e-4; the stats of 6 steps to 1e-4
relative (mass to 1e-9, as it only sees the rounding of h).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mom6_tpu.core import barotropic as rbt
from mom6_tpu.core import coriolis_adv as rca
from mom6_tpu.core import pressure_force as rpf
from mom6_tpu.core.dynamics_split_rk2 import _visc_setup as ref_visc_setup
from mom6_tpu.core.dynamics_split_rk2 import step_dynamics_split_rk2 as rstep
from mom6_tpu.drivers.experiments import double_gyre as ref_double_gyre
from mom6_tpu.drivers.solo import run_segment as ref_run_segment
from mom6_tpu.grid.grid import build_cartesian_grid
from mom6_tpu.grid.vertical import build_layered_vgrid
from mom6_tpu.physics.vertical import vert_friction as rvf
from mom6_tpu_torch import interop
from mom6_tpu_torch.core import barotropic as tbt
from mom6_tpu_torch.core import coriolis_adv as tca
from mom6_tpu_torch.core import pressure_force as tpf
from mom6_tpu_torch.core.dynamics_split_rk2 import (_visc_setup,
                                                    step_dynamics_split_rk2)
from mom6_tpu_torch.drivers.solo import DynStepper, make_stepper, run_segment
from mom6_tpu_torch.physics.vertical import vert_friction as tvf

torch.set_num_threads(1)

NZ, NY, NX = 3, 16, 20
T = torch.from_numpy
J = jnp.asarray


def _close(refs, gots, tol=1e-5):
    for x, y in zip(refs, gots):
        x = np.asarray(x, np.float64)
        y = y.double().numpy() if torch.is_tensor(y) else np.asarray(y)
        scale = np.abs(x).max() + 1e-30
        err = np.abs(x - y).max() / scale
        assert err <= tol, f"max rel diff {err:.2e}"


@pytest.fixture(scope="module")
def basin():
    """A walled beta-plane basin with land and a shelf, and random
    thicknesses, velocities and transports from a seed."""
    depth = np.full((NY, NX), 2000.0)
    depth[:, :2] = 0.0
    depth[NY // 2:, NX // 2] = 300.0
    G_ref = build_cartesian_grid(NX, NY, 1000.0, 800.0, depth=depth,
                                 f0=1e-4, beta=2e-11)
    GV_ref = build_layered_vgrid(NZ, gprime_int=0.02)
    G = interop.load_grid(interop.export(G_ref), device="cpu")
    GV = interop.load_vgrid(interop.export(GV_ref), device="cpu")
    rng = np.random.default_rng(11)
    m = np.asarray(G_ref.mask2dT)
    h = np.clip(depth[None] / NZ + 20.0 * rng.standard_normal((NZ, NY, NX)),
                1e-3, None) * m[None] + 1e-10 * (1 - m[None])
    f32 = lambda a: np.asarray(a, np.float32)
    x = dict(h=f32(h),
             u=f32(0.2 * rng.standard_normal((NZ, NY, NX))
                   * np.asarray(G_ref.mask2dCu)),
             v=f32(0.2 * rng.standard_normal((NZ, NY, NX))
                   * np.asarray(G_ref.mask2dCv)),
             uh=f32(1e5 * rng.standard_normal((NZ, NY, NX))),
             vh=f32(1e5 * rng.standard_normal((NZ, NY, NX))),
             taux=f32(0.1 * rng.standard_normal((NY, NX))),
             f2=f32(1e-8 * rng.uniform(0.5, 1.5, (NY, NX))))
    return G_ref, GV_ref, G, GV, x


def test_find_eta_and_pressure_force_parity(basin):
    G_ref, GV_ref, G, GV, x = basin
    _close([rpf.find_eta(J(x["h"]), G_ref)], [tpf.find_eta(T(x["h"]), G)])
    e_tidal = (0.01 * x["taux"]).astype(np.float32)
    for et in (None, e_tidal):
        ref = rpf.pressure_force_montgomery(
            J(x["h"]), G_ref, GV_ref, None if et is None else J(et))
        got = tpf.pressure_force_montgomery(
            T(x["h"]), G, GV, None if et is None else T(et))
        _close(ref, got)


def test_coriolis_adv_parity(basin):
    G_ref, GV_ref, G, GV, x = basin
    ref = rca.coriolis_adv(J(x["u"]), J(x["v"]), J(x["h"]), J(x["uh"]),
                           J(x["vh"]), G_ref, GV_ref)
    got = tca.coriolis_adv(T(x["u"]), T(x["v"]), T(x["h"]), T(x["uh"]),
                           T(x["vh"]), G, GV)
    _close(ref, got)
    _close([rca.kinetic_energy(J(x["u"]), J(x["v"]), G_ref)],
           [tca.kinetic_energy(T(x["u"]), T(x["v"]), G)])


def test_coriolis_other_schemes_not_ported(basin):
    G_ref, GV_ref, G, GV, x = basin
    a = T(x["u"])
    with pytest.raises(NotImplementedError):
        tca.coriolis_adv(a, a, a, a, a, G, GV, scheme="ARAKAWA_HSU90")


@pytest.mark.parametrize("cdrag", [0.0, 2e-3])
def test_vertvisc_parity(basin, cdrag):
    G_ref, GV_ref, G, GV, x = basin
    h_u = x["h"] * np.asarray(G_ref.mask2dCu)[None]
    u_bot = x["u"][-1]
    kw = dict(bottom_drag=1e-4, cdrag=cdrag)
    c_ref = rvf.vertvisc_coef(J(h_u), 1e-4, u_bot=J(u_bot), **kw)
    c = tvf.vertvisc_coef(T(h_u), 1e-4, u_bot=T(u_bot), **kw)
    _close(c_ref, c)
    # compared on wet faces, as the step uses them: a land face's column
    # has only floor thicknesses, coupled ~3000x more strongly than its
    # mass, and amplifies f32 ulps ~1e4-fold (the model masks it)
    mu = np.asarray(G_ref.mask2dCu)
    _close([rvf.vertvisc(J(x["u"]), J(h_u), c_ref, 1200.0,
                         tau=J(x["taux"])) * mu],
           [tvf.vertvisc(T(x["u"]), T(h_u), c, 1200.0, tau=T(x["taux"]))
            * G.mask2dCu])
    _close([rvf.vertvisc_remnant(J(h_u), c_ref, 1200.0) * mu],
           [tvf.vertvisc_remnant(T(h_u), c, 1200.0) * G.mask2dCu])
    # the caller's velocity is left as it was
    u = T(x["u"].copy())
    tvf.vertvisc(u, T(h_u), c, 1200.0, tau=T(x["taux"]))
    assert torch.equal(u, T(x["u"]))


@pytest.mark.parametrize("alpha", [0.0, 50.0])
def test_gl90_coupling_parity(basin, alpha):
    G_ref, GV_ref, G, GV, x = basin
    kw = dict(kappa_gl90=0.0 if alpha else 100.0, alpha_gl90=alpha)
    _close([rvf.gl90_coupling(J(x["h"]), J(x["f2"]), GV_ref.g_prime, **kw)],
           [tvf.gl90_coupling(T(x["h"]), T(x["f2"]), GV.g_prime, **kw)])


def test_limit_velocity_parity(basin):
    G_ref, GV_ref, G, GV, x = basin
    big = (x["u"] * 3e3).astype(np.float32)
    ref = rvf.limit_velocity(J(big), J(big), 1200.0, G_ref)
    got = tvf.limit_velocity(T(big), T(big), 1200.0, G)
    _close(ref[:2], got[:2])
    assert int(ref[2]) == int(got[2]) > 0


@pytest.mark.parametrize("gl90", [{}, dict(kappa_gl90=500.0),
                                  dict(alpha_gl90=100.0)])
def test_visc_setup_parity(basin, gl90):
    G_ref, GV_ref, G, GV, x = basin
    p_ref = ref_double_gyre(nx=8, ny=8, nz=NZ)[3]._replace(cdrag=2e-3,
                                                           **gl90)
    p = interop.load_params(interop.export(p_ref))
    ref = ref_visc_setup(J(x["h"]), J(x["u"]), J(x["v"]), G_ref, GV_ref,
                         p_ref, None)
    got = _visc_setup(T(x["h"]), T(x["u"]), T(x["v"]), G, GV, p)
    _close(ref[:2] + tuple(ref[2]) + tuple(ref[3]) + ref[4:],
           got[:2] + tuple(got[2]) + tuple(got[3]) + got[4:])


@pytest.mark.parametrize("x_first", [True, False])
@pytest.mark.parametrize("nsteps", [(7, 1, 0.0), (28, 3, 0.0),
                                    (7, 1, 1e-3)])
def test_btstep_parity(basin, x_first, nsteps):
    """The dense subcycle, odd and even substep totals, both orders,
    with and without the implicit barotropic drag."""
    G_ref, GV_ref, G, GV, x = basin
    nstep, nfilter, drag = nsteps
    kw = dict(nstep=nstep, nfilter=nfilter, bebt=0.2, lin_drag=drag,
              cdrag=drag)
    bt_ref = rbt.BTParams(**kw)
    bt = tbt.BTParams(**kw)
    rng = np.random.default_rng(3)
    f32 = lambda a: np.asarray(a, np.float32)
    extra = dict(eta=f32(0.1 * rng.standard_normal((NY, NX))),
                 au=f32(1e-6 * rng.standard_normal((NZ, NY, NX))),
                 av=f32(1e-6 * rng.standard_normal((NZ, NY, NX))),
                 rem=f32(rng.uniform(0.5, 1.0, (NZ, NY, NX))))
    pf_ref = rpf.pressure_force_montgomery(J(x["h"]), G_ref, GV_ref)
    pf = tpf.pressure_force_montgomery(T(x["h"]), G, GV)

    def args(C, pf_):
        return (C(x["u"]), C(x["v"]), C(extra["eta"]), C(extra["au"]),
                C(extra["av"]), C(x["h"]), C(x["uh"]), C(x["vh"]),
                C(extra["rem"]), C(extra["rem"]), pf_.pbce, pf_.eta_PF,
                1200.0)

    ref = jax.jit(lambda: rbt.btstep(*args(J, pf_ref), G_ref, GV_ref,
                                     bt_ref, taux=J(x["taux"]),
                                     tauy=J(x["taux"]), x_first=x_first))()
    got = tbt.btstep(*args(T, pf), G, GV, bt, taux=T(x["taux"]),
                     tauy=T(x["taux"]), x_first=x_first)
    _close(ref, got, tol=1e-4)


@pytest.mark.parametrize("flag", ["dynamic_psurf", "sal_scalar",
                                  "wide_halo"])
def test_btstep_unported_options_raise(basin, flag):
    G_ref, GV_ref, G, GV, x = basin
    bt = tbt.BTParams(nstep=4, nfilter=1)
    bt = bt.replace(**{flag: {"sal_scalar": 0.1, "wide_halo": -1}
                       .get(flag, True)})
    z3, z2 = torch.zeros(NZ, NY, NX), torch.zeros(NY, NX)
    with pytest.raises(NotImplementedError):
        tbt.btstep(z3, z3, z2, z3, z3, z3 + 1, z3, z3, z3, z3, z3, z2,
                   1200.0, G, GV, bt)


def test_set_dtbt_and_weights_parity(basin):
    G_ref, GV_ref, G, GV, x = basin
    assert tbt.set_dtbt(G, GV, 2000.0, 1200.0) == \
        rbt.set_dtbt(G_ref, GV_ref, 2000.0, 1200.0)
    for n, nf, xf in ((7, 1, True), (28, 3, False)):
        ref = rbt._weights(n, nf, jnp.float32, xf)
        got = tbt._weights(n, nf, xf)
        np.testing.assert_array_equal(np.asarray(ref[0]),
                                      got[0].astype(np.float32))
        np.testing.assert_array_equal(np.asarray(ref[1]),
                                      got[1].astype(np.float32))
        np.testing.assert_array_equal(np.asarray(ref[2]), got[2])


# -- the slice: double gyre ---------------------------------------------------

@pytest.fixture(scope="module")
def gyre():
    """double_gyre(24, 22, 2) in both packages (the port's carried across
    with interop.py), its first step in the reference, and the reference's
    6-step run_segment stats."""
    ref = ref_double_gyre(nx=24, ny=22, nz=2)
    port = interop.load_all(*(interop.export(o) for o in ref), device="cpu")
    G, GV, st, p, f = ref
    step1 = jax.jit(lambda s: rstep(s, f, G, GV, p))(st)
    return ref, port, step1


def test_one_step_parity(gyre):
    ref, (G, GV, st, p, f), step1 = gyre
    with torch.inference_mode():
        got = step_dynamics_split_rk2(st, f, G, GV, p)
    for k in ("h", "u", "v", "uh", "vh", "uhtr", "vhtr"):
        _close([getattr(step1, k)], [getattr(got, k)], tol=1e-4)
    # the input state was not modified
    assert torch.equal(st.h, T(np.array(ref[2].h)))
    assert torch.equal(st.u, torch.zeros_like(st.u))


def test_run_segment_stats_parity(gyre, tmp_path):
    ref, (G, GV, st, p, f), _ = gyre
    rG, rGV, rst, rp, rf = ref
    _, _ = ref_run_segment(rst, rG, rGV, rp, rf, n_steps=6,
                           stats_interval=3,
                           stats_path=str(tmp_path / "ref.stats"))
    state, elapsed = run_segment(st, G, GV, p, f, n_steps=6,
                                 stats_interval=3,
                                 stats_path=str(tmp_path / "port.stats"))
    assert elapsed > 0.0 and bool(torch.isfinite(state.h).all())

    def parse(path):
        rows = []
        for line in open(path).read().splitlines()[1:]:
            parts = line.replace(",", " ").replace("(", " ") \
                .replace(")", " ").split()
            rows.append({parts[i]: float(parts[i + 1])
                         for i in range(len(parts) - 1)
                         if parts[i] in ("En", "KE", "APE", "Mass")})
        return rows

    rows_ref, rows = parse(tmp_path / "ref.stats"), parse(tmp_path /
                                                          "port.stats")
    assert len(rows) == len(rows_ref) == 2
    for a, b in zip(rows_ref, rows):
        assert abs(a["Mass"] - b["Mass"]) <= 1e-9 * a["Mass"]
        for k in ("En", "KE", "APE"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(a[k]), (k, a[k], b[k])


def test_stepper_is_a_module_with_the_configuration_as_buffers(gyre):
    _, (G, GV, st, p, f), _ = gyre
    stepper = make_stepper(G, GV, p, f, steps_per_call=2)
    assert isinstance(stepper, DynStepper)
    names = dict(stepper.named_buffers())
    assert "G_IareaT" in names and "GV_g_prime" in names \
        and "forces_taux" in names
    s64 = stepper.to(torch.float64)
    G64, GV64, f64 = s64.configuration()
    assert G64.IareaT.dtype == torch.float64 and G64.nx == G.nx
    with torch.inference_mode():
        out = s64(st.to(dtype=torch.float64))
    assert out.h.dtype == torch.float64
    assert bool(torch.isfinite(out.u).all())


def test_rk2b_not_ported(gyre):
    _, (G, GV, st, p, f), _ = gyre
    with pytest.raises(NotImplementedError):
        step_dynamics_split_rk2(st, f, G, GV, p.replace(scheme="RK2B"))
