"""The physics gates of tests/test_analytic_parity.py,
tests/test_pf_pierced.py and tests/test_user_configs.py (those of the
configurations the port runs that pass on the reference: not
test_seamount_resting_state_stays_slow nor
test_neverworld_acc_is_eastward, which fail there), the open
boundaries' gates of tests/test_obc.py, tests/test_obc_file_reservoir.py
and tests/test_tc_ladder.py::TestTC3, and those of the sponge, the BBL,
the Langmuir number, the bulk mixed layer and HYCOM1
(tests/test_tc_ladder.py::TestTC4, test_wired_subsystems.py,
test_coupler_waves.py, test_bulk_ml.py, test_regrid_hybrid.py), and
those of neutral diffusion, the ADAPTIVE coordinate, the internal tides,
the tidal mixing, the tidal wave drag and the spherical gyre
(test_neutral_diffusion.py, test_regrid_hybrid.py::test_adaptive_*,
test_internal_tides.py, test_tidal_mixing.py,
test_bt_cont.py::test_wave_drag_map_damps_barotropic,
test_ensemble_spherical.py::test_spherical_gyre_runs), and those of the
ice shelf, tc1, tc2 and the non-Boussinesq mode (test_shelf_coupling.py,
test_tc_ladder.py::TestTC1 and TestTC2, test_nonbouss_mode.py), run
through the PyTorch port.

Each gate builds its case through the port (the configuration's
MOM_input, the test's parameter text, or the port's builders), runs it
at the test's own size and length, and makes the test's own asserts with
its tolerances.  It returns a record of what it measured against the
analytic value, and raises AssertionError on a miss.  This module
imports no jax, so chip_smoke.py runs the gates on the card
(``device="cuda"``) and tests/test_torch_analytic.py on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from mom6_tpu_torch.ale.ale import ADAPTIVE, LAYER, ALEParams, \
    ale_regrid_remap
from mom6_tpu_torch.ale.regridding import (AdaptParams, build_adaptive_grid,
                                           build_hycom1_grid, build_rho_grid)
from mom6_tpu_torch.core.barotropic import BTParams, set_dtbt
from mom6_tpu_torch.core.dynamics_split_rk2 import (DynParams, MechForcing,
                                                    step_dynamics_split_rk2)
from mom6_tpu_torch.core.mom import Forcing, MOMParams, step_mom
from mom6_tpu_torch.core.open_boundary import (OBCSegment, apply_obc,
                                               build_obc)
from mom6_tpu_torch.core.pressure_force import (find_eta_nonbouss,
                                                 pressure_force_fv, spv_avg)
from mom6_tpu_torch.core.state import OceanState, init_state_resting
from mom6_tpu_torch.drivers.config_driver import build_model_from_params
from mom6_tpu_torch.drivers.experiments import thermo_gyre
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.grid.grid import (build_cartesian_grid,
                                      build_spherical_grid)
from mom6_tpu_torch.grid.vertical import build_layered_vgrid
from mom6_tpu_torch.physics.lateral.internal_tides import (
    InternalTidesParams, init_int_tide_energy, step_internal_tides)
from mom6_tpu_torch.physics.lateral.wave_drag import wave_drag_piston
from mom6_tpu_torch.physics.shelf_coupling import (ShelfCoupling,
                                                   apply_shelf_coupling,
                                                   shelf_melt_fluxes,
                                                   trim_columns_for_p_surf)
from mom6_tpu_torch.physics.vertical.bulk_mixed_layer import (BulkMLParams,
                                                              bulkmixedlayer)
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams)
from mom6_tpu_torch.physics.vertical.epbl import EPBLParams, epbl_diffusivity
from mom6_tpu_torch.physics.vertical.set_diffusivity import (
    DiffusivityParams, bbl_lotw_kd, set_diffusivity)
from mom6_tpu_torch.physics.vertical.tidal_mixing import (
    TidalMixingParams, _deposit_fractions, _layer_n2, int_tide_input_tke,
    tidal_mixing_kd)
from mom6_tpu_torch.tracers.neutral_diffusion import (
    neutral_diffusion, neutral_diffusion_surfaces)
from mom6_tpu_torch.tracers.vert_diff import tracer_vertdiff
from mom6_tpu_torch.physics.waves import WaveParams, make_la_fn

__all__ = ["GATES", "BATCHED", "CARD_ONLY", "run_gate"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INTERNAL_WAVE = """
NIGLOBAL = 64
NJGLOBAL = 4
NK = 2
LENLON = 100.0
LENLAT = 8.0
MAXIMUM_DEPTH = 500.0
TOPO_CONFIG = flat
REENTRANT_X = True
F_0 = 0.0
DT = 150.0
ENABLE_THERMODYNAMICS = False
GINT = 9.8e-3
THICKNESS_CONFIG = internal_wave
IC_AMPLITUDE = 2.0
IC_INTERFACE = 1
IC_WAVELENGTH_FRAC = 0.5
"""

LOCK_EXCHANGE = """
NIGLOBAL = 192
NJGLOBAL = 4
NK = 20
LENLON = 48.0
LENLAT = 1.0
MAXIMUM_DEPTH = 20.0
TOPO_CONFIG = flat
F_0 = 0.0
DT = 30.0
DT_THERM = 60.0
ENABLE_THERMODYNAMICS = True
EQN_OF_STATE = WRIGHT
USE_REGRIDDING = True
REGRIDDING_COORDINATE_MODE = Z*
TS_CONFIG = front
T_REF = 10.0
T_RANGE = 4.0
FRONT_WIDTH_FRAC = 0.01
KV = 1.0e-5
KH = 0.1
"""

CONV_BASE = """
NIGLOBAL = 2
NJGLOBAL = 2
NK = 100
LENLON = 10.0
LENLAT = 10.0
MAXIMUM_DEPTH = 200.0
TOPO_CONFIG = flat
F_0 = 1.0e-5
DT = 600.0
DT_THERM = 1200.0
ENABLE_THERMODYNAMICS = True
EQN_OF_STATE = WRIGHT
USE_REGRIDDING = True
REGRIDDING_COORDINATE_MODE = Z*
T_REF = 15.0
T_RANGE = 8.0
BUOY_CONFIG = const
SENSIBLE_HEAT_FLUX = -200.0
KV = 1.0e-5
KD = 0.0
"""


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


def build(device, name=None, text=None, dtype=torch.float32):
    """The model of configs/<name>/MOM_input or of the parameter text."""
    if text is None:
        pf = ParamFile([os.path.join(REPO, "configs", name, "MOM_input")])
        return build_model_from_params(pf, dtype=dtype, device=device)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "MOM_input")
        with open(p, "w") as f:
            f.write(text)
        return build_model_from_params(ParamFile([p]), dtype=dtype,
                                       device=device)


def _stepper(ms):
    def step(s):
        with torch.inference_mode():
            return step_mom(s, ms.forcing, ms.grid, ms.vgrid, ms.params)
    return step


def _dyn_stepper(forcing, G, GV, p):
    def step(s):
        with torch.inference_mode():
            return step_dynamics_split_rk2(s, forcing, G, GV, p)
    return step


def _fit_omega(series, t, om_lo, om_hi, n=4001):
    """Least-squares single-frequency fit (the reference test's)."""
    best = None
    for om in np.linspace(om_lo, om_hi, n):
        b = np.vstack([np.cos(om * t), np.sin(om * t)]).T
        coef, *_ = np.linalg.lstsq(b, series, rcond=None)
        ssr = float(((series - b @ coef) ** 2).sum())
        if best is None or ssr < best[0]:
            best = (ssr, om)
    return best[1]


def external_gwave(device):
    """c = sqrt(g H) to < 1%."""
    ms = build(device, "external_gwave")
    step = _stepper(ms)
    s = ms.state
    dt = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    H, L = 1000.0, 400e3
    k = 2 * np.pi / (0.5 * L)
    c_th = np.sqrt(9.8 * H)
    amps = []
    n = 48
    for _ in range(n):
        eta = _np(s.h.sum(0) - ms.grid.bathyT)
        amps.append(np.fft.rfft(eta[2])[2].real)   # zonal mode 2
        s = step(s)
    t = np.arange(n) * dt
    om = _fit_omega(np.asarray(amps), t, 0.8 * c_th * k, 1.2 * c_th * k)
    c = om / k
    assert abs(c / c_th - 1.0) < 0.01, (c, c_th)
    return dict(quantity="phase speed [m/s]", measured=c, analytic=c_th,
                error=c / c_th - 1.0, gate="|c/c_th - 1| < 0.01")


def internal_wave(device):
    """c_i = sqrt(g' h1 h2 / (h1 + h2)) to < 1%."""
    ms = build(device, text=INTERNAL_WAVE)
    step = _stepper(ms)
    s = ms.state
    dt = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    h1 = h2 = 250.0
    ci = np.sqrt(9.8e-3 * h1 * h2 / (h1 + h2))
    k = 2 * np.pi / 50e3
    amps = []
    n = 260
    for _ in range(n):
        amps.append(np.fft.rfft(_np(s.h[0, 1, :]))[2].real)
        s = step(s)
    t = np.arange(n) * dt
    om = _fit_omega(np.asarray(amps), t, 0.7 * ci * k, 1.3 * ci * k)
    assert abs(om / k / ci - 1.0) < 0.01, (om / k, ci)
    return dict(quantity="phase speed [m/s]", measured=om / k, analytic=ci,
                error=om / k / ci - 1.0, gate="|c/c_i - 1| < 0.01")


def soliton(device):
    """Boyd's westward speed (1/3 + 0.395 B^2) c0 to < 10%, the envelope
    kept above 0.6 of its start (the unsplit RK3 stepper)."""
    ms = build(device, "soliton")
    G = ms.grid
    step = _stepper(ms)
    s = ms.state
    dt = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    H = 0.8
    c0 = np.sqrt(9.8 * H)
    B = 0.395
    c_th = (1.0 / 3.0 + 0.395 * B * B) * c0
    L_eq = np.sqrt(c0 / 2.3e-11)
    lat = G.geoLatT.cpu().numpy()
    y_nd = lat[:, 0] * 1e3 / L_eq
    w = (3 + 6 * y_nd ** 2) / 4 * np.exp(-0.5 * y_nd ** 2)
    w /= (w ** 2).sum()
    nx = G.nx
    lon = G.geoLonT.cpu().numpy()
    dx_m = float(lon[0, 1] - lon[0, 0]) * 1e3

    def env_peak(s):
        eta = _np(s.h.sum(0) - G.bathyT)
        phi = (eta * w[:, None]).sum(0)
        i = int(np.argmax(phi))
        ym, y0, yp = phi[(i - 1) % nx], phi[i], phi[(i + 1) % nx]
        d2 = ym - 2 * y0 + yp
        sub = 0.5 * (ym - yp) / (d2 if abs(d2) > 1e-30 else 1e-30)
        return i + sub, float(phi.max())

    per_day = int(86400 / dt)
    obs = [env_peak(s)]
    n_days = 16
    for _ in range(n_days):
        for _ in range(per_day):
            s = step(s)
        obs.append(env_peak(s))
    pos = np.array([o[0] for o in obs])
    dpos = np.diff(pos)
    dpos = np.where(dpos > nx / 2, dpos - nx,
                    np.where(dpos < -nx / 2, dpos + nx, dpos))
    cum = np.concatenate([[0.0], np.cumsum(dpos)])
    t = np.arange(2, n_days + 1) * 86400.0
    A = np.vstack([t, np.ones_like(t)]).T
    slope = np.linalg.lstsq(A, cum[2:] * dx_m, rcond=None)[0][0]
    c_meas = -slope
    assert c_meas > 0.0, "soliton must move west"
    assert abs(c_meas / c_th - 1.0) < 0.10, (c_meas, c_th)
    amps = np.array([o[1] for o in obs])
    assert amps[-1] > 0.6 * amps[0]
    return dict(quantity="westward speed [m/s]", measured=c_meas,
                analytic=c_th, error=c_meas / c_th - 1.0,
                gate="|c/c_th - 1| < 0.10, amplitude > 0.6 of its start",
                amplitude_kept=amps[-1] / amps[0])


def geostrophic_adjustment(device):
    """The adjusted jet against the exact linear inversion: peak within
    4%, profile rms within 1.5% of peak, KE/dPE within 5% of the
    oracle's ratio, half-domain circulation geostrophic to 3%."""
    NX, NY = 192, 4
    LX, LY = 6000.0, 125.0
    H, F0, g = 100.0, 1.0e-4, 9.8
    G = build_cartesian_grid(NX, NY, LX, LY, max_depth=H, f0=F0,
                             cyclic_x=True, reentrant_y=True, device=device)
    GV = build_layered_vgrid(1, device=device)
    dx = LX * 1e3 / NX
    x = (np.arange(NX) + 0.5) * dx
    eta0 = 0.05
    eta_i = eta0 * (np.tanh((x - LX * 1e3 / 4) / dx)
                    - np.tanh((x - 3 * LX * 1e3 / 4) / dx) - 1.0)
    eta_i -= eta_i.mean()
    LR = np.sqrt(g * H) / F0
    kf = 2 * np.pi * np.fft.fftfreq(NX, d=dx)
    eta_f = np.real(np.fft.ifft(np.fft.fft(eta_i)
                                / (1 + LR ** 2 * kf ** 2)))
    V_th = (g / F0) * (np.roll(eta_f, -1) - eta_f) / dx

    state = init_state_resting(G, GV, [H])
    state = state.replace(h=torch.tensor(
        _np(state.h) + eta_i[None, None, :], dtype=torch.float32,
        device=device))
    dt = 900.0
    params = DynParams(dt=dt, bt=BTParams(nstep=10, nfilter=1), kv=0.0)
    step = _dyn_stepper(MechForcing(), G, GV, params)
    s = state
    per = int(2 * np.pi / F0 / dt)
    for _ in range(int(2 * 86400 / dt)):
        s = step(s)
    vm = np.zeros(NX)
    em = np.zeros(NX)
    cnt = 0
    for _ in range(8 * per):
        s = step(s)
        vm += _np(s.v[0, 1, :])
        em += _np((s.h.sum(0) - G.bathyT)[1, :])
        cnt += 1
    vm /= cnt
    em /= cnt
    Vm = 0.5 * (vm + np.roll(vm, -1))
    assert abs(Vm.max() / V_th.max() - 1.0) < 0.04, (Vm.max(), V_th.max())
    assert abs(Vm.min() / V_th.min() - 1.0) < 0.04
    rms = np.sqrt(np.mean((Vm - V_th) ** 2)) / V_th.max()
    assert rms < 0.015, rms
    KE_m = 0.5 * H * (Vm ** 2).sum() * dx
    PE_i = 0.5 * g * (eta_i ** 2).sum() * dx
    PE_f = 0.5 * g * ((em - em.mean()) ** 2).sum() * dx
    KE_th = 0.5 * H * (V_th ** 2).sum() * dx
    PE_f_th = 0.5 * g * (eta_f ** 2).sum() * dx
    ratio = (KE_m / (PE_i - PE_f)) / (KE_th / (PE_i - PE_f_th))
    assert abs(ratio - 1.0) < 0.05, ratio
    circ = vm[:NX // 2].sum() * dx
    dh = em[NX // 2 - 4:NX // 2].mean() - em[:4].mean()
    assert abs(circ / ((g / F0) * dh) - 1.0) < 0.03
    return dict(quantity="peak jet transport [m2/s]", measured=Vm.max(),
                analytic=V_th.max(), error=Vm.max() / V_th.max() - 1.0,
                gate="peak < 4%, rms < 1.5%, KE/dPE < 5%, circulation < 3%",
                rms=rms, energy_ratio=ratio,
                circulation=circ / ((g / F0) * dh))


def lock_exchange(device):
    """Both noses at [0.70, 1.00] of Benjamin's 0.5 sqrt(g' H), their
    speeds within 15% of each other."""
    ms = build(device, text=LOCK_EXCHANGE)
    G = ms.grid
    step = _stepper(ms)
    s = ms.state
    dtc = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    eos = get_eos("WRIGHT")
    T0 = s.T.detach().cpu().numpy()
    Tl, Tr = T0[:, 1, 2].mean(), T0[:, 1, -3].mean()

    def rho(T):
        f = lambda x: torch.tensor(x, dtype=torch.float32)
        return float(eos.density(f(np.float32(T)), f(35.0), f(2e5)))
    rho_l, rho_r = rho(Tl), rho(Tr)
    drho = abs(rho_l - rho_r)
    H = 20.0
    gp = 9.8 * drho / (0.5 * (rho_l + rho_r))
    c_b = 0.5 * np.sqrt(gp * H)
    x_km = G.geoLonT.cpu().numpy()[1]
    Tmid = 0.5 * (Tl + Tr)

    def fronts(s):
        Ta = _np(s.T[:, 1, :])
        Tb, Ts = Ta[-1], Ta[0]
        i = np.where(Tb < Tmid)[0].max()       # dense bottom nose (+x)
        fb = x_km[i] + (Tmid - Tb[i]) / (Tb[i + 1] - Tb[i]) \
            * (x_km[i + 1] - x_km[i]) if i + 1 < len(Tb) else x_km[i]
        j = np.where(Ts > Tmid)[0].min()       # light surface nose (-x)
        fs = x_km[j] - (Tmid - Ts[j]) / (Ts[j - 1] - Ts[j]) \
            * (x_km[j] - x_km[j - 1]) if j >= 1 else x_km[j]
        return fb, fs

    per_hr = int(3600 / dtc)
    obs = [fronts(s)]
    n_hr = 6
    for _ in range(n_hr):
        for _ in range(per_hr):
            s = step(s)
        obs.append(fronts(s))
    obs = np.array(obs)
    t = np.arange(n_hr + 1) * 3600.0
    A = np.vstack([t[1:], np.ones_like(t[1:])]).T
    sb = np.linalg.lstsq(A, obs[1:, 0] * 1e3, rcond=None)[0][0]
    ss = np.linalg.lstsq(A, obs[1:, 1] * 1e3, rcond=None)[0][0]
    rb, rs = sb / c_b, -ss / c_b
    mean_r = 0.5 * (rb + rs)
    assert 0.70 < mean_r < 1.00, (rb, rs, c_b)
    assert abs(rb - rs) / mean_r < 0.15, (rb, rs)
    return dict(quantity="mean nose speed [m/s]", measured=mean_r * c_b,
                analytic=c_b, error=mean_r - 1.0,
                gate="ratio in (0.70, 1.00), noses within 15%",
                ratio=mean_r, ratio_bottom=rb, ratio_surface=rs)


def convective_deepening(device, scheme_line, ndays=6):
    """(day, mld, encroachment depth) rows of a cooled column."""
    ms = build(device, text=CONV_BASE + scheme_line + "\n")
    GV = ms.vgrid
    step = _stepper(ms)
    s = ms.state
    dtc = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    T0 = _np(s.T[:, 1, 1])
    h0 = _np(s.h[:, 1, 1])
    zc = np.cumsum(h0) - 0.5 * h0
    gam = -(np.polyfit(zc[10:90], T0[10:90], 1)[0])    # dT/dz [K/m]
    ft = 200.0 / (float(GV.rho0) * ms.params.diabatic.cp)
    per_day = int(86400 / dtc)
    rows = []
    for day in range(1, ndays + 1):
        for _ in range(per_day):
            s = step(s)
        T = _np(s.T[:, 1, 1])
        h = _np(s.h[:, 1, 1])
        zc = np.cumsum(h) - 0.5 * h
        idx = np.where(T < T[0] - 0.05)[0]     # base of the mixed layer
        mld = zc[idx.min()] if len(idx) else np.nan
        rows.append((day, mld, np.sqrt(2 * ft * day * 86400.0 / gam)))
    return np.asarray(rows)


def _check_convection(rows):
    """Depth over the encroachment law in [1.0, 1.35] from day 2 on, and
    the t^(1/2) exponent in [0.4, 0.6]."""
    ratio = rows[:, 1] / rows[:, 2]
    assert np.isfinite(rows[:, 1]).all(), rows
    assert (ratio[1:] > 1.0).all(), rows
    assert (ratio[1:] < 1.35).all(), rows
    pfit = np.polyfit(np.log(rows[1:, 0]), np.log(rows[1:, 1]), 1)[0]
    assert 0.4 < pfit < 0.6, pfit
    return dict(quantity="mixed-layer depth on day 6 [m]",
                measured=rows[-1, 1], analytic=rows[-1, 2],
                error=ratio[-1] - 1.0,
                gate="depth/encroachment in (1.0, 1.35) from day 2, "
                     "exponent in (0.4, 0.6)",
                ratios=[round(float(r), 4) for r in ratio], exponent=pfit)


def kpp_convective_deepening(device):
    return _check_convection(convective_deepening(device, "USE_KPP = True"))


def epbl_convective_deepening(device):
    return _check_convection(convective_deepening(
        device, "ENERGETICS_SFC_PBL = True"))


def stommel_gyre(device):
    """The interior v within 10% of the exact Stommel profile; the
    western boundary current northward, peaked within 3 delta_S and
    more than 3x the interior."""
    nx = ny = 50
    L = 4000e3
    H = 1000.0
    beta = 2e-11
    f0 = 5e-5
    tau0 = 0.1
    dx = L / nx
    delta_s = 4.0 * dx
    r = beta * delta_s
    piston = r * H

    G = build_cartesian_grid(ny=ny, nx=nx, len_lon_km=L / 1e3,
                             len_lat_km=L / 1e3, max_depth=H,
                             f0=f0, beta=beta, device=device)
    GV = build_layered_vgrid(1, device=device)
    rho0 = GV.rho0
    state = init_state_resting(G, GV, [H])
    y_u = (np.arange(ny) + 0.5) * dx
    taux = -tau0 * np.cos(np.pi * y_u / L)
    forcing = MechForcing(taux=torch.tensor(
        np.broadcast_to(taux[:, None], (ny, nx)).astype(np.float32),
        device=device) * G.mask2dCu)
    dt = 1800.0
    nstep, _ = set_dtbt(G, GV, H, dt)
    params = DynParams(dt=dt, bt=BTParams(nstep=nstep,
                                          nfilter=max(1, nstep // 8)),
                       kv=0.0, bottom_drag=piston)
    step = _dyn_stepper(forcing, G, GV, params)
    s = state
    n_spin, n_avg = 1200, 70
    v_sum = None
    for i in range(n_spin + n_avg):
        s = step(s)
        if i >= n_spin:
            v_sum = s.v if v_sum is None else v_sum + s.v
    v = _np(v_sum)[0] / n_avg
    assert np.isfinite(v).all()

    k2 = (np.pi / L) ** 2
    W = -tau0 * np.pi / (rho0 * H * L)
    lam = np.roots([r, beta, -r * k2])
    phi_p = -W / (r * k2)
    A = np.array([[1.0, 1.0],
                  [np.exp(lam[0] * L), np.exp(lam[1] * L)]])
    c1, c2 = np.linalg.solve(A, [-phi_p, -phi_p])
    x_v = (np.arange(nx) + 0.5) * dx
    dphi = (c1 * lam[0] * np.exp(lam[0] * x_v)
            + c2 * lam[1] * np.exp(lam[1] * x_v))
    y_v = (np.arange(ny) + 1.0) * dx
    v_exact = dphi[None, :] * np.sin(np.pi * y_v / L)[:, None]

    i0 = int(np.ceil(5 * delta_s / dx))
    sl = np.s_[ny // 4: 3 * ny // 4, i0: nx - 3]
    scale = np.abs(v_exact[sl]).max()
    err = np.abs(v[sl] - v_exact[sl]) / scale
    assert err.max() < 0.10, err.max()
    mid = ny // 2
    wbc = v[mid, : i0]
    assert wbc.max() > 0.0
    assert np.argmax(wbc) <= int(3 * delta_s / dx)
    assert wbc.max() > 3.0 * np.abs(v_exact[sl]).max()
    return dict(quantity="interior v [m/s], largest error over max",
                measured=float(err.max()), analytic=0.0,
                error=float(err.max()),
                gate="interior < 10%; WBC north, within 3 delta_S, > 3x",
                wbc_over_interior=wbc.max() / scale)


def ekman_spiral(device):
    """The exact finite-depth Ekman profile within 3% of the surface
    speed, the transport -tau/(rho0 f) to 1%, zonal transport ~ 0."""
    ny = nx = 8
    f0, tau0, kv = 1e-4, 0.1, 1e-2
    nz, dz = 30, 2.0
    D = nz * dz
    G = build_cartesian_grid(ny=ny, nx=nx, len_lon_km=100.0,
                             len_lat_km=100.0, max_depth=D,
                             f0=f0, beta=0.0,
                             cyclic_x=True, reentrant_y=True, device=device)
    GV = build_layered_vgrid(nz, device=device)
    rho0 = GV.rho0
    state = init_state_resting(G, GV, [dz] * nz)
    forcing = MechForcing(taux=torch.full((ny, nx), tau0,
                                          dtype=torch.float32,
                                          device=device))
    dt = 900.0
    nstep, _ = set_dtbt(G, GV, D, dt)
    p = DynParams(dt=dt, bt=BTParams(nstep=nstep,
                                     nfilter=max(1, nstep // 8)),
                  kv=kv, bottom_drag=0.0)
    step = _dyn_stepper(forcing, G, GV, p)
    s = state
    n_spin, n_avg = 960, 140
    usum = vsum = None
    for i in range(n_spin + n_avg):
        s = step(s)
        if i >= n_spin:
            usum = s.u if usum is None else usum + s.u
            vsum = s.v if vsum is None else vsum + s.v
    u = _np(usum)[:, 4, 4] / n_avg
    v = _np(vsum)[:, 4, 4] / n_avg

    z = (np.arange(nz) + 0.5) * dz
    m = np.sqrt(1j * f0 / kv)
    U = (tau0 / (rho0 * kv * m)) * np.cosh(m * (D - z)) / np.sinh(m * D)
    scale = np.abs(U[0])
    prof = np.max(np.hypot(u - U.real, v - U.imag)) / scale
    assert prof < 0.03
    np.testing.assert_allclose((v * dz).sum(), -tau0 / (rho0 * f0),
                               rtol=0.01)
    assert abs((u * dz).sum()) < 0.02 * abs(tau0 / (rho0 * f0))
    return dict(quantity="meridional Ekman transport [m2/s]",
                measured=(v * dz).sum(), analytic=-tau0 / (rho0 * f0),
                error=(v * dz).sum() / (-tau0 / (rho0 * f0)) - 1.0,
                gate="profile < 3% of surface speed, transport < 1%",
                profile_error=prof)


def phillips_instability(device):
    """The fitted growth rate within 15% of the two-layer Phillips
    rate."""
    f0, gprime, Hl, U0 = 1e-4, 0.02, 500.0, 0.05
    kd = np.sqrt(2 * f0 ** 2 / (gprime * Hl))
    k = kd * np.sqrt(np.sqrt(2.0) - 1.0)
    lam = 2 * np.pi / k
    nx, ny = 64, 40
    Lx = 2 * lam
    dx = Lx / nx
    Ly = ny * dx
    G = build_cartesian_grid(ny=ny, nx=nx, len_lon_km=Lx / 1e3,
                             len_lat_km=Ly / 1e3, max_depth=2 * Hl,
                             f0=f0, beta=0.0, cyclic_x=True, device=device)
    GV = build_layered_vgrid(2, gprime_int=gprime, device=device)
    l = np.pi / Ly
    K2 = k * k + l * l
    sigma = k * U0 * np.sqrt((kd ** 2 - K2) / (kd ** 2 + K2))

    yc = (np.arange(ny) + 0.5) * dx - Ly / 2
    xc = (np.arange(nx) + 0.5) * dx
    X, Y = np.meshgrid(xc, yc)
    eta_int = (-f0 * 2 * U0 / gprime * yc[:, None]
               + 0.05 * np.cos(k * X) * np.sin(np.pi * (Y + Ly / 2) / Ly))
    h = np.stack([Hl + eta_int, Hl - eta_int]).astype(np.float32)
    u = np.zeros((2, ny, nx), np.float32)
    u[0], u[1] = U0, -U0
    st0 = init_state_resting(G, GV, [Hl, Hl])
    t = lambda a: torch.tensor(a, device=device)
    state = st0.replace(h=t(h) * G.mask2dT + st0.h * (1 - G.mask2dT),
                        u=t(u) * G.mask2dCu)
    dt = 900.0
    nstep, _ = set_dtbt(G, GV, 2 * Hl, dt)
    p = DynParams(dt=dt, bt=BTParams(nstep=nstep,
                                     nfilter=max(1, nstep // 8)), kv=0.0)
    step = _dyn_stepper(MechForcing(), G, GV, p)
    s = state
    days, rms = [], []
    for i in range(int(45 * 86400 / dt)):
        s = step(s)
        if i % 48 == 0:
            days.append((i + 1) * dt / 86400)
            rms.append(float(torch.sqrt(torch.mean(s.v ** 2))))
    days, rms = np.array(days), np.array(rms)
    assert np.isfinite(rms).all()
    sel = (days > 12) & (days < 40) & (rms < 0.3 * U0)
    assert sel.sum() > 10
    fit = np.polyfit(days[sel] * 86400, np.log(rms[sel]), 1)
    ratio = fit[0] / sigma
    assert abs(ratio - 1.0) < 0.15, ratio
    return dict(quantity="growth rate [1/s]", measured=fit[0],
                analytic=sigma, error=ratio - 1.0,
                gate="|sigma/sigma_th - 1| < 0.15")


PIERCED = (32, 4, 6)      # NZ, NY, NX of tests/test_pf_pierced.py


def _pierced_setup(device, sliver=1e-10):
    NZ, NY, NX = PIERCED
    depth = np.full((NY, NX), 4000.0)
    depth[:, :3] = 2716.0
    G = build_cartesian_grid(NX, NY, 300.0, 200.0, depth=depth, f0=1e-4,
                             device=device)
    GV = build_layered_vgrid(NZ, device=device)
    zint = np.linspace(0.0, 4000.0, NZ + 1)
    h = np.zeros((NZ, NY, NX))
    for j in range(NY):
        for i in range(NX):
            d = depth[j, i]
            h[:, j, i] = np.maximum(
                np.minimum(zint[1:], d) - np.minimum(zint[:-1], d), sliver)
    zc = np.cumsum(h, axis=0) - 0.5 * h
    T = 8.0 + 12.0 * np.exp(-zc / 1000.0)
    S = np.full_like(T, 35.0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return G, GV, t(h), t(T), t(S)


def pierced_face_rest_pf_small(device):
    """At rest over a 1300 m step: the pierced faces' force < 2e-5 m/s2,
    the interior faces' < 1e-6."""
    G, GV, h, T, S = _pierced_setup(device)
    PFu = _np(pressure_force_fv(h, T, S, G, GV, get_eos("WRIGHT")).PFu)
    pierced = np.abs(PFu[:, 1, 2]).max()
    interior = max(np.abs(PFu[:, 1, 0]).max(), np.abs(PFu[:, 1, 3]).max())
    assert pierced < 2e-5, pierced
    assert np.abs(PFu[:, 1, 0]).max() < 1e-6
    assert np.abs(PFu[:, 1, 3]).max() < 1e-6
    return dict(quantity="rest PF at the pierced face [m/s2]",
                measured=pierced, analytic=0.0, error=pierced,
                gate="pierced < 2e-5, interior < 1e-6", interior=interior)


def pierced_face_force_continuous_in_sliver(device):
    """A 1 cm sliver against an Angstrom one moves the face force by
    < 5e-5 m/s2."""
    G, GV, h0, T, S = _pierced_setup(device, sliver=1e-10)
    _, _, h1, T1, S1 = _pierced_setup(device, sliver=1e-2)
    eos = get_eos("WRIGHT")
    pf0 = _np(pressure_force_fv(h0, T, S, G, GV, eos).PFu)
    pf1 = _np(pressure_force_fv(h1, T1, S1, G, GV, eos).PFu)
    jump = np.abs(pf1[:, 1, 2] - pf0[:, 1, 2]).max()
    assert jump < 5e-5
    return dict(quantity="face force change, 1 cm vs 1e-10 m [m/s2]",
                measured=jump, analytic=0.0, error=jump, gate="< 5e-5")


def _cycles(ms, n, provider=False):
    """``n`` thermo cycles of a built configuration, the forcing from its
    provider at the start of each cycle where ``provider``."""
    step = _stepper(ms)
    dt_cycle = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    s = ms.state
    for k in range(n):
        if provider:
            with torch.inference_mode():
                s = step_mom(s, ms.forcing_provider(k * dt_cycle), ms.grid,
                             ms.vgrid, ms.params)
        else:
            s = step(s)
    return s


def phillips_jet_balanced(device):
    """configs/phillips_channel: the initial jet is geostrophic, so after
    4 cycles max|u| stays of the order of the jet's
    (tests/test_user_configs.py::test_phillips_jet_is_balanced)."""
    ms = build(device, "phillips_channel")
    u0 = float(ms.state.u.abs().max())
    u1 = float(_cycles(ms, 4).u.abs().max())
    assert u0 > 0.01
    assert u1 < 3.0 * u0 + 0.1, (u0, u1)
    return dict(quantity="max|u| after 4 cycles [m/s]", measured=u1,
                analytic=u0, error=u1 / u0 - 1.0,
                gate="u0 > 0.01, u1 < 3 u0 + 0.1")


def scm_kpp_mixes_under_wind(device):
    """configs/scm_kpp: 12 cycles of wind stress deepen KPP's boundary
    layer and weaken the top 6 layers' stratification
    (test_user_configs.py::test_scm_kpp_mixes_under_wind)."""
    ms = build(device, "scm_kpp")
    s = _cycles(ms, 12)
    dT0 = float(ms.state.T[0, 1, 1] - ms.state.T[5, 1, 1])
    dT1 = float(s.T[0, 1, 1] - s.T[5, 1, 1])
    assert dT1 < dT0, (dT0, dT1)
    return dict(quantity="T(layer 0) - T(layer 5) after 12 cycles [degC]",
                measured=dT1, analytic=dT0, error=dT1 - dT0,
                gate="below the initial difference")


def neverworld_topography_and_stability(device):
    """configs/neverworld: land continents, the Drake-passage row open all
    round, and 6 stable cycles under the westerlies
    (test_user_configs.py::test_neverworld_topography_and_stability)."""
    ms = build(device, "neverworld")
    s = _cycles(ms, 6)
    mask = _np(ms.grid.mask2dT)
    ny = mask.shape[0]
    assert mask.mean() < 0.95
    assert mask[int(0.09 * ny)].min() > 0.5
    umax = float(s.u.abs().max())
    assert umax > 1e-4
    h, u = _np(s.h), _np(s.u)
    h_u = 0.5 * (h + np.roll(h, -1, axis=2))
    uw = (h_u * np.abs(u)).sum() / h_u.sum()
    assert uw < 0.5, uw
    return dict(quantity="thickness-weighted mean |u| after 6 cycles "
                "[m/s]", measured=uw, analytic=0.0, error=uw,
                gate="ocean fraction < 0.95, channel row open, max|u| > "
                "1e-4, weighted |u| < 0.5", ocean_fraction=mask.mean(),
                max_u=umax)


def hurricane_wind_structure(device):
    """configs/hurricane's stress at t=0: hurricane force, the uniform
    translation-only stress in the far field, cyclonic around the ring of
    maximum wind (test_user_configs.py::test_hurricane_wind_structure)."""
    ms = build(device, "hurricane")
    taux, tauy = _np(ms.forcing.mech.taux), _np(ms.forcing.mech.tauy)
    mag = np.sqrt(taux ** 2 + tauy ** 2)
    assert 1.0 < mag.max() < 20.0
    x = _np(ms.grid.geoLonT) * 1e3
    y = _np(ms.grid.geoLatT) * 1e3
    r = np.sqrt((x - 1.35e6) ** 2 + (y - 3.75e5) ** 2)
    tau_amb = 1.2 * 1.2e-3 * (0.5 * 5.0) ** 2
    far = mag[r > 13 * 50.0e3]
    np.testing.assert_allclose(far, tau_amb, rtol=1e-5)
    ring_n = (np.abs(r - 50.0e3) < 30e3) & (y - 3.75e5 > 30e3)
    ring_s = (np.abs(r - 50.0e3) < 30e3) & (y - 3.75e5 < -30e3)
    assert taux[ring_n].mean() < 0.0
    assert taux[ring_s].mean() > 0.0
    err = float(np.abs(far / tau_amb - 1.0).max())
    return dict(quantity="far-field stress [Pa]", measured=float(far.mean()),
                analytic=tau_amb, error=err,
                gate="1 < max|tau| < 20, far field within 1e-5, cyclonic",
                max_stress=float(mag.max()))


def hurricane_cold_wake(device):
    """configs/hurricane: after a day (72 cycles, the provider's stress
    each cycle) the SST wake is cold and biased to the right of the
    westward track (test_user_configs.py::
    test_hurricane_cold_wake_right_of_track)."""
    ms = build(device, "hurricane")
    s = _cycles(ms, 72, provider=True)
    sst0 = float(ms.state.T[0].double().mean())
    sst = _np(s.T)[0]
    y = _np(ms.grid.geoLatT)[:, 0] * 1e3
    yc = 3.75e5
    north = sst[(y > yc + 25e3) & (y < yc + 200e3)].mean()
    south = sst[(y < yc - 25e3) & (y > yc - 200e3)].mean()
    assert north < sst0 - 0.05, (north, sst0)
    assert north < south, (north, south)
    return dict(quantity="SST north of the track after a day [degC]",
                measured=north, analytic=sst0, error=north - sst0,
                gate="north < SST0 - 0.05 and north < south", south=south)


def _provider_cycles(ms, n, collect=None, offset=0.0):
    """``n`` thermo cycles with the provider's forcing at the start of
    each cycle plus ``offset`` cycles; ``collect(state, forcing)`` of each
    new state, in a list."""
    dt_cycle = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    s, out = ms.state, []
    for k in range(n):
        f = ms.forcing_provider((k + offset) * dt_cycle)
        with torch.inference_mode():
            s = step_mom(s, f, ms.grid, ms.vgrid, ms.params)
        if collect is not None:
            out.append(collect(s, f))
    return s, out


def supercritical_steps_stably(device):
    """configs/supercritical: 4 cycles with a 0.5 m/s inflow through the
    west boundary stay finite and bounded
    (test_user_configs.py::test_config_steps_stably[supercritical]; the
    open boundaries exchange volume, so no mass check)."""
    ms = build(device, "supercritical")
    s = _cycles(ms, 4)
    for f in ("h", "u", "v"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    umax = float(s.u.abs().max())
    assert umax < 5.0, umax
    return dict(quantity="max|u| after 4 cycles [m/s]", measured=umax,
                analytic=0.5, error=umax - 0.5, gate="finite, max|u| < 5")


def kelvin_wave_trapped_at_coast(device):
    """configs/kelvin: the SSH response of the mode-0 Kelvin wave decays
    offshore at f/c (within 40%) and propagates with the coast on its
    right (test_user_configs.py::test_kelvin_wave_trapped_at_coast)."""
    period = 44714.0
    n = int(round(period / 300.0)) + 30          # one period + spin-in
    ms = build(device, "kelvin")
    G = ms.grid
    _, etas = _provider_cycles(ms, n, lambda s, f: _np(s.h.sum(0)))
    eta_t = np.stack(etas[30:]) - _np(G.bathyT)[None]
    icol = 6
    amp = np.abs(eta_t[:, :, icol]).max(axis=0)
    mask = _np(G.mask2dT)
    wet = mask[:, icol] > 0.5
    f0, c = 1.0e-4, np.sqrt(9.8 * 100.0)
    y = _np(G.geoLatT)[:, icol] * 1e3
    rows = np.where(wet & (amp > 1e-3 * amp.max()))[0][:16]
    slope = np.polyfit(y[rows], np.log(amp[rows]), 1)[0]
    assert abs(-slope / (f0 / c) - 1.0) <= 0.4, (slope, -f0 / c)
    j0 = int(np.where((mask[:, 8] > 0.5) & (mask[:, 24] > 0.5))[0][0])
    a, b = eta_t[:, j0, 8], eta_t[:, j0, 24]
    xc = [np.corrcoef(a[:-L if L else None], b[L:])[0, 1]
          for L in range(0, 40)]
    lag = int(np.argmax(xc))
    assert lag > 0, lag
    return dict(quantity="offshore decay rate of the SSH amplitude [1/m]",
                measured=-slope, analytic=f0 / c,
                error=-slope / (f0 / c) - 1.0,
                gate="within 40% of f/c, downstream lag > 0", lag=lag)


def shelfwave_trapped_on_shelf(device):
    """configs/shelfwave: after half a day the depth-mean response near
    the coast is over 3 times that offshore
    (test_user_configs.py::test_shelfwave_response_trapped_on_shelf)."""
    ms = build(device, "shelfwave")
    s, _ = _provider_cycles(ms, 144)
    u, v = _np(s.u), _np(s.v)
    speed = np.sqrt(u.mean(0) ** 2 + v.mean(0) ** 2)
    ny = speed.shape[0]
    near, far = speed[: ny // 4].mean(), speed[-ny // 4:].mean()
    assert np.isfinite(speed).all()
    assert near > 3.0 * far, (near, far)
    return dict(quantity="near-shore over offshore speed", measured=near
                / far, analytic=3.0, error=near / far - 3.0,
                gate="> 3", near=near, far=far)


def dome_inflow_enters_and_descends(device):
    """configs/dome: the SPECIFIED inflow is southward and densest-
    fastest, enters the domain (thickness-weighted v < -0.01 m/s at its
    faces after 16 cycles) and cold water reaches the embayment's bottom
    (test_user_configs.py::test_dome_inflow_enters_and_descends)."""
    ms = build(device, "dome")
    G, obc = ms.grid, ms.params.obc
    assert obc is not None and obc.mask_v_spec is not None
    vspec = _np(obc.vvel_spec)
    msk = _np(obc.mask_v_spec) > 0.5
    prof = vspec[:, msk]
    assert prof.min() < -0.1
    assert abs(prof[-1]).max() > abs(prof[0]).max()
    s = _cycles(ms, 16)
    v, h = _np(s.v), _np(s.h)
    jf = np.where(msk.any(axis=1))[0][0]
    cols = np.where(msk[jf])[0]
    h_v = 0.5 * (h[:, jf, cols] + h[:, min(jf + 1, G.ny - 1), cols])
    vw = (v[:, jf, cols] * h_v).sum() / max(h_v.sum(), 1e-30)
    assert vw < -0.01, vw
    t_bot = _np(s.T)[-1, G.ny - 1, 40:44].mean()
    assert t_bot < 20.0 - 0.5, t_bot
    return dict(quantity="thickness-weighted v at the inflow faces [m/s]",
                measured=vw, analytic=float(prof.mean()),
                error=vw - float(prof.mean()),
                gate="vw < -0.01, bottom T in the bay < 19.5", t_bot=t_bot)


def dome_plume_turns_west(device):
    """configs/dome for 2 days (288 cycles): the dense plume has turned
    west on the slope, bottom water west of the embayment cooled by more
    than 0.2 degC (test_user_configs.py::test_dome_plume_turns_west)."""
    ms = build(device, "dome")
    G = ms.grid
    s = _cycles(ms, 288)
    dT_all = _np(s.T) - _np(ms.state.T)
    lon = _np(G.geoLonT)[0]
    slope_rows = slice(int(0.55 * G.ny), int(0.72 * G.ny))
    west_cols = (lon > 500.0) & (lon < 950.0)
    dT = dT_all[-1, slope_rows][:, west_cols]
    assert dT.min() < -0.2, dT.min()
    return dict(quantity="bottom cooling west of the bay [degC]",
                measured=float(dT.min()), analytic=-0.2,
                error=float(dT.min()) + 0.2, gate="< -0.2")


def tidal_bay_file_forcing(device):
    """configs/tidal_bay: the west boundary's SSH from obc_forcing.nc
    pumps the bay, whose mid-point surface follows with an amplitude
    ratio in [0.8, 1.05] and a lag under 1 radian over 1.5 M2 periods
    (test_obc_file_reservoir.py::test_tidal_bay_file_forcing)."""
    ms = build(device, "tidal_bay")
    G = ms.grid
    assert ms.params.obc is not None and ms.forcing_provider is not None
    dtc = ms.params.dyn.dt * ms.params.n_dyn_per_thermo
    m2 = 12.4206012 * 3600.0
    n = int(1.5 * m2 / dtc)
    bathy = G.bathyT

    def collect(s, f):
        return (float(s.h.sum(0)[12, 24] - bathy[12, 24]),
                float(f.obc_data.eta_ext[12, 0]))
    s, rec = _provider_cycles(ms, n, collect, offset=0.5)
    eta_mid = np.asarray([r[0] for r in rec])
    eta_f = np.asarray([r[1] for r in rec])
    half = n // 3
    amp_i = 0.5 * (eta_mid[half:].max() - eta_mid[half:].min())
    amp_f = 0.5 * (eta_f[half:].max() - eta_f[half:].min())
    assert bool(torch.isfinite(s.h).all())
    assert 0.8 < amp_i / amp_f < 1.05, (amp_i, amp_f)
    c = np.correlate(eta_mid[half:] - eta_mid[half:].mean(),
                     eta_f[half:] - eta_f[half:].mean(), "full")
    lag = (np.argmax(c) - (len(eta_f[half:]) - 1)) * dtc
    phase = 2 * np.pi * lag / m2
    assert 0.0 <= phase < 1.0, lag
    return dict(quantity="interior over forcing SSH amplitude",
                measured=amp_i / amp_f, analytic=1.0,
                error=amp_i / amp_f - 1.0,
                gate="ratio in [0.8, 1.05], lag in [0, 1) rad",
                lag_rad=phase)


def tc3_circle_obcs_radiation(device):
    """configs/tc3: after 30 cycles the open run holds under half the
    energy of a closed-wall twin, the twin conserves volume to 1e-5 and
    the open run changes it by at most twice the disk's volume
    (test_tc_ladder.py::TestTC3::test_circle_obcs_radiation)."""
    ms = build(device, "tc3")
    assert ms.params.obc is not None
    G = ms.grid
    h0 = _np(ms.state.h[0])
    assert h0.max() - h0.min() > 1.0

    def vol(s):
        return float((s.h.double() * G.areaT.double()).sum())

    def energy(s):
        ke = float(((s.u ** 2 + s.v ** 2) * s.h * G.areaT[None]).sum())
        eta = s.h.sum(0) - G.bathyT
        eta = eta - eta.mean()
        return ke + float(9.8 * (eta ** 2 * G.areaT).sum())

    s_open = _cycles(ms, 30)
    closed = ms._replace(params=ms.params.replace(obc=None))
    s_closed = _cycles(closed, 30)
    assert bool(torch.isfinite(s_open.u).all())
    e_open, e_closed = energy(s_open), energy(s_closed)
    assert e_closed > 0.0
    assert e_open < 0.5 * e_closed, (e_open, e_closed)
    v0 = vol(ms.state)
    dv_closed = abs(vol(s_closed) - v0) / v0
    assert dv_closed < 1e-5, dv_closed
    disk_vol = float(((h0 - h0.min()) * _np(G.areaT)).sum())
    dv_open = abs(vol(s_open) - v0)
    assert dv_open <= 2.0 * disk_vol + 1e-6 * v0, (dv_open, disk_vol)
    return dict(quantity="energy, open over closed", measured=e_open
                / e_closed, analytic=0.5, error=e_open / e_closed - 0.5,
                gate="< 0.5; closed volume to 1e-5, open within twice "
                "the disk", dv_closed=dv_closed)


def _wave(device):
    """tests/test_obc.py::setup_wave: an eta bump mid-channel of a 32x8
    reentrant-y channel, 100 m deep, at rest, f = 0."""
    nx, ny = 32, 8
    G = build_cartesian_grid(nx, ny, 320.0, 80.0, max_depth=100.0, f0=0.0,
                             reentrant_y=True, device=device)
    GV = build_layered_vgrid(1, device=device)
    state = init_state_resting(G, GV, [100.0])
    x = np.arange(nx)
    bump = 0.5 * np.exp(-((x - nx / 2.0) ** 2) / 8.0)
    state = state.replace(h=torch.tensor(
        state.h.cpu().numpy() + bump[None, None, :], dtype=torch.float32,
        device=G.bathyT.device))
    nstep, _ = set_dtbt(G, GV, 100.0, 100.0)
    p = DynParams(dt=100.0, bt=BTParams(nstep=nstep, nfilter=2), kv=0.0)
    return G, GV, state, p


def _wave_energy(s, G, GV):
    h, u = _np(s.h), _np(s.u)
    eta = h.sum(0) - _np(G.bathyT)
    area = _np(G.areaT)
    return 0.5 * GV.rho0 * GV.g_earth * (eta ** 2 * area).sum() \
        + 0.5 * GV.rho0 * (h * u * u * area).sum()


def _radiation(device, segments, with_old):
    """Energy of the bump after 108 steps (3 h) open and closed."""
    G, GV, state, p = _wave(device)
    obc = build_obc(segments, G.ny, G.nx, device=device)
    step = _dyn_stepper(MechForcing(), G, GV, p)
    s_open = s_closed = state
    for _ in range(108):
        kw = dict(u_old=s_open.u, v_old=s_open.v) if with_old else {}
        with torch.inference_mode():
            s_open = apply_obc(step(s_open), obc, G, GV, p.dt, **kw)
        s_closed = step(s_closed)
    assert bool(torch.isfinite(s_open.h).all())
    return (_wave_energy(state, G, GV), _wave_energy(s_open, G, GV),
            _wave_energy(s_closed, G, GV))


def flather_radiates_waves_out(device):
    """Flather on both ends of the channel lets the bump's waves leave:
    the open domain keeps < 0.3 of the energy and < 0.5 of the closed
    one's (test_obc.py::test_flather_radiates_waves_out)."""
    e0, e_open, e_closed = _radiation(
        device, [OBCSegment(edge="E"), OBCSegment(edge="W")], False)
    assert e_open < 0.3 * e0, e_open / e0
    assert e_open < 0.5 * e_closed, (e_open, e_closed)
    return dict(quantity="energy kept, open over initial",
                measured=e_open / e0, analytic=0.3,
                error=e_open / e0 - 0.3,
                gate="< 0.3 of the initial, < 0.5 of the closed",
                closed=e_closed / e0)


def orlanski_radiates_waves_out(device):
    """Oblique radiation at the east end and Orlanski at the west, with
    the previous step's velocities: the open domain keeps less energy
    than the closed one (test_obc.py::test_orlanski_radiates_waves_out)."""
    e0, e_open, e_closed = _radiation(
        device, [OBCSegment(edge="E", scheme="OBLIQUE"),
                 OBCSegment(edge="W", scheme="ORLANSKI")], True)
    assert e_open < e_closed, (e_open, e_closed)
    return dict(quantity="energy kept, open over closed",
                measured=e_open / e_closed, analytic=1.0,
                error=e_open / e_closed - 1.0, gate="< 1")


# --- the sponge, the BBL, the Langmuir number, the bulk mixed layer and
# HYCOM1 ------------------------------------------------------------------

WIRED_BASE = """
NIGLOBAL = 12
NJGLOBAL = 12
NK = 4
DT = 900.0
DT_THERM = 900.0
TOPO_CONFIG = "bowl"
WIND_CONFIG = "gyres"
"""


def _volume(ms, s):
    return float((s.h.double() * ms.grid.areaT.double()).sum())


def dense_water_steps_stably(device):
    """configs/dense_water (the sponge bands over the slope): 4 cycles
    finite, mass conserved to 1e-5 and max|u| < 5
    (test_user_configs.py::test_config_steps_stably[dense_water])."""
    ms = build(device, "dense_water")
    assert ms.params.sponge is not None
    s = _cycles(ms, 4)
    for f in ("h", "u", "v"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    m0, m1 = _volume(ms, ms.state), _volume(ms, s)
    np.testing.assert_allclose(m1, m0, rtol=1e-5)
    umax = float(s.u.abs().max())
    assert umax < 5.0, umax
    return dict(quantity="relative mass change after 4 cycles",
                measured=abs(m1 / m0 - 1.0), analytic=0.0,
                error=abs(m1 / m0 - 1.0), gate="< 1e-5, max|u| < 5",
                max_u=umax)


def tc4_sponge_ale(device):
    """configs/tc4: the sponge, the linear EOS, z* and the BBL drag
    built from the file; 3 cycles finite with the volume kept to 1e-5
    (test_tc_ladder.py::TestTC4::test_sponge_ale)."""
    ms = build(device, "tc4")
    p = ms.params
    assert p.sponge is not None and p.bbl_visc is not None
    assert p.eos_name == "LINEAR" and p.ale.mode == "ZSTAR"
    s = _cycles(ms, 3)
    assert bool(torch.isfinite(s.T).all())
    v0, v1 = _volume(ms, ms.state), _volume(ms, s)
    err = abs(v1 - v0) / v0
    assert err < 1e-5, err
    return dict(quantity="relative volume change after 3 cycles",
                measured=err, analytic=0.0, error=err, gate="< 1e-5")


def adjustment_front_stays_balanced(device):
    """configs/adjustment (periodic in y): after 24 cycles an
    along-front jet above 1e-3 m/s and over half the cross-front flow,
    the front's surface T spread above 0.3 of the initial
    (test_user_configs.py::test_adjustment_front_stays_balanced)."""
    ms = build(device, "adjustment")
    assert ms.grid.reentrant_y
    s = _cycles(ms, 24)
    v_amp = float(s.v.abs().max())
    u_amp = float(s.u.abs().max())
    assert v_amp > 1e-3, v_amp
    assert v_amp > 0.5 * u_amp, (v_amp, u_amp)
    t0 = float(_np(ms.state.T[0]).std())
    t1 = float(_np(s.T[0]).std())
    assert t1 > 0.3 * t0, (t0, t1)
    return dict(quantity="max|v| after 24 cycles [m/s]", measured=v_amp,
                analytic=0.5 * u_amp, error=v_amp - 0.5 * u_amp,
                gate="max|v| > 1e-3 and > 0.5 max|u|, T spread > 0.3 of "
                "the initial", t_spread=t1 / t0)


def epbl_lf17_deepens_mld(device):
    """The LF17 Langmuir number deepens ePBL's boundary layer under wind
    by more than 5% and raises its largest diffusivity
    (test_coupler_waves.py::test_epbl_lf17_deepens_mld)."""
    G, GV, state, _, _ = thermo_gyre(8, 8, 10, dt=1800.0, device=device)
    eos = get_eos("LINEAR")
    h10 = torch.full_like(state.h, 10.0)
    z_c = torch.cumsum(h10, dim=0) - 0.5 * h10
    state = state.replace(h=h10, T=20.0 - 0.001 * z_c)
    taux = torch.full_like(G.mask2dT, 0.15)
    tauy = torch.zeros_like(G.mask2dT)
    hf = torch.zeros_like(G.mask2dT)
    ustar = torch.sqrt(taux / GV.rho0)
    la_fn = make_la_fn(WaveParams(method="LF17"), ustar)
    ep = EPBLParams(tke_decay=1.0)
    with torch.inference_mode():
        kd0, mld0 = epbl_diffusivity(state.h, state.T, state.S, G, GV, eos,
                                     taux, tauy, hf, p=ep)
        kd1, mld1 = epbl_diffusivity(state.h, state.T, state.S, G, GV, eos,
                                     taux, tauy, hf, p=ep, la_fn=la_fn)
    m0, m1 = float(mld0.double().mean()), float(mld1.double().mean())
    assert m1 > 1.05 * m0, (m0, m1)
    assert float(kd1.max()) > float(kd0.max())
    assert bool(torch.isfinite(mld1).all())
    return dict(quantity="mean boundary-layer depth with LF17 [m]",
                measured=m1, analytic=1.05 * m0, error=m1 / m0 - 1.0,
                gate="> 1.05 x without, max kd larger")


def _bulk_setup(device):
    """tests/test_bulk_ml.py's column: 10 layers of 100 m over 4x4, T
    from 18 degC down by 10 degC per 1000 m, the linear EOS."""
    G = build_cartesian_grid(4, 4, 40.0, 40.0, max_depth=1000.0,
                             device=device)
    GV = build_layered_vgrid(10, device=device)
    h = torch.full((10, 4, 4), 100.0, device=device)
    z = torch.cumsum(h, dim=0) - 0.5 * h
    T = 18.0 - 10.0 * z / 1000.0
    S = torch.full_like(T, 35.0)
    return G, GV, h, T, S, torch.zeros_like(h), torch.zeros_like(h)


def bulkml_wind_deepens(device):
    """A stronger wind deepens the bulk mixed layer (Kraus-Turner
    m* u*^3), at least the top layer
    (test_bulk_ml.py::test_bulkml_wind_deepens)."""
    G, GV, h, T, S, u, v = _bulk_setup(device)
    eos = get_eos("LINEAR")
    b = torch.zeros((4, 4), device=h.device)
    hmls = []
    with torch.inference_mode():
        for us in (0.005, 0.01, 0.02):
            ustar = torch.full((4, 4), us, device=h.device)
            _, _, _, hml = bulkmixedlayer(h, u, v, T, S, G, GV, eos, 3600.0,
                                          ustar, b, BulkMLParams())
            hmls.append(float(hml[1, 1]))
    assert hmls[0] < hmls[1] < hmls[2], hmls
    assert hmls[0] >= 100.0 - 1.0
    return dict(quantity="mixed-layer depth at u* = 0.02 m/s [m]",
                measured=hmls[2], analytic=hmls[1], error=hmls[2] - hmls[1],
                gate="increasing with u*, >= the top layer", hmls=hmls)


def diabatic_layered_end_to_end(device):
    """The layered sequence through step_mom (BULKML) for 3 cycles under
    wind and cooling: finite, h > 0, the column heat falls
    (test_bulk_ml.py::test_diabatic_layered_end_to_end)."""
    G, GV, h, T, S, u, v = _bulk_setup(device)
    st = OceanState(h=h, u=u, v=v, T=T, S=S, uh=torch.zeros_like(h),
                    vh=torch.zeros_like(h), uhtr=torch.zeros_like(h),
                    vhtr=torch.zeros_like(h))
    params = MOMParams(
        dyn=DynParams(dt=900.0, bt=BTParams(nstep=16, nfilter=2)),
        thermo_enabled=True, eos_name="LINEAR",
        diabatic=DiabaticParams(boundary_layer_scheme="BULKML"),
        ale=ALEParams(mode=LAYER), n_dyn_per_thermo=2)
    taux = torch.full((4, 4), 0.1, device=h.device) * G.mask2dCu
    forcing = Forcing(mech=MechForcing(taux=taux,
                                       tauy=torch.zeros_like(taux)),
                      buoy=BuoyancyForcing(heat_flux=torch.full_like(
                          taux, -200.0)))
    out = st
    with torch.inference_mode():
        for _ in range(3):
            out = step_mom(out, forcing, G, GV, params)
    assert bool(torch.isfinite(out.h).all() and torch.isfinite(out.T).all())
    assert bool((out.h > 0).all())
    q0 = float((st.h * st.T).double().sum())
    q1 = float((out.h * out.T).double().sum())
    assert q1 < q0, (q0, q1)
    return dict(quantity="column heat content after 3 cooled cycles "
                "[degC m]", measured=q1, analytic=q0, error=q1 - q0,
                gate="finite, h > 0, heat below the initial")


def hycom_interior_follows_isopycnals(device):
    """Where the isopycnal interfaces lie deeper than the nominal z grid,
    HYCOM1 puts them where the RHO coordinate does, within 1 m
    (test_regrid_hybrid.py::test_hycom_interior_follows_isopycnals)."""
    nz, depth = 12, 1200.0
    G = build_cartesian_grid(5, 5, 50.0, 50.0, max_depth=depth,
                             device=device)
    GV = build_layered_vgrid(nz, device=device)
    h = torch.full((nz, 5, 5), depth / nz, device=device)
    z = torch.cumsum(h, dim=0) - 0.5 * h
    T = torch.where(z < 600.0, 18.0, 18.0 - 16.0 * (z - 600.0) / depth)
    S = torch.full_like(T, 35.0)
    eos = get_eos("LINEAR")
    dz = np.concatenate([np.full(nz - 1, 10.0), [depth - 10.0 * (nz - 1)]])
    rho_t = GV.Rlay.cpu().numpy().tolist()
    with torch.inference_mode():
        h_hyc = build_hycom1_grid(h, T, S, GV, eos, rho_t, dz)
        h_rho = build_rho_grid(h, T, S, GV, eos, rho_t)
    z_hyc = _np(torch.cumsum(h_hyc, dim=0))[:, 2, 2]
    z_rho = _np(torch.cumsum(h_rho, dim=0))[:, 2, 2]
    deeper = z_rho[:-1] > np.cumsum(dz)[:-1] + 1.0
    assert deeper.any()
    err = float(np.abs(z_hyc[:-1][deeper] - z_rho[:-1][deeper]).max())
    assert err <= 1.0, err
    return dict(quantity="HYCOM1 - RHO interface depth where deeper "
                "than nominal [m]", measured=err, analytic=0.0, error=err,
                gate="<= 1 m", n_deeper=int(deeper.sum()))


def hycom_via_config_driver(device):
    """REGRIDDING_COORDINATE_MODE = HYCOM1 from a parameter file builds
    and steps: h finite and positive
    (test_regrid_hybrid.py::test_hycom_via_config_driver)."""
    ms = build(device, text="""
NIGLOBAL = 8
NJGLOBAL = 8
NK = 6
LENLON = 500.0
LENLAT = 500.0
MAXIMUM_DEPTH = 1000.0
DT = 900.0
ENABLE_THERMODYNAMICS = True
USE_REGRIDDING = True
REGRIDDING_COORDINATE_MODE = HYCOM1
""")
    assert ms.params.ale.mode == "HYCOM1"
    out = _stepper(ms)(ms.state)
    assert bool(torch.isfinite(out.h).all())
    hmin = float(out.h.min())
    assert hmin > 0.0, hmin
    return dict(quantity="min h after one cycle [m]", measured=hmin,
                analytic=0.0, error=0.0, gate="finite, > 0")


def sponge_relaxes_to_reference(device):
    """A fast sponge (SPONGE_IDAMP = 1e-2 /s) under 500 W/m2 of surface
    heating: after 4 cycles the southern band's surface warming is under
    half the interior's
    (test_wired_subsystems.py::test_sponge_relaxes_to_reference)."""
    ms = build(device, text=WIRED_BASE
               + 'SPONGE = True\nSPONGE_IDAMP = 1e-2\nWIND_CONFIG = "zero"'
               '\nBUOY_CONFIG = "const"\nSENSIBLE_HEAT_FLUX = 500.0\n')
    assert ms.params.sponge is not None
    s = _cycles(ms, 4)
    dT = np.abs(_np(s.T[0] - ms.state.T[0]))
    mask = _np(ms.grid.mask2dT) > 0.5
    edge = dT[0][mask[0]].mean()
    interior = dT[6][mask[6]].mean()
    assert edge < 0.5 * interior, (edge, interior)
    return dict(quantity="surface warming in the sponge band / interior",
                measured=edge / interior, analytic=0.5,
                error=edge / interior - 0.5, gate="< 0.5")


def bbl_drag_diffusivity(device):
    """BOTTOMDRAGLAW with BBL_EFFIC = 0.2 under a 0.3 m/s flow: the
    near-bottom law-of-the-wall diffusivity above 1e-5 m2/s and no
    larger near the top; a cycle of the full step stays finite
    (test_wired_subsystems.py::test_bbl_drag_diffusivity)."""
    ms = build(device, text=WIRED_BASE
               + "BOTTOMDRAGLAW = True\nBBL_EFFIC = 0.2\n")
    st = ms.state.replace(u=torch.full_like(ms.state.u, 0.3)
                          * ms.grid.mask2dCu)
    with torch.inference_mode():
        kd = bbl_lotw_kd(st.h, st.u, st.v, st.T, st.S, ms.grid, ms.vgrid,
                         get_eos("WRIGHT"), ms.params.diabatic.diff)
    kd = _np(kd)
    mask = _np(ms.grid.mask2dT) > 0.5
    near_bottom = float(kd[-2][mask].max())
    assert near_bottom > 1e-5, near_bottom
    assert kd[1][mask].max() <= near_bottom + 1e-12
    out = _stepper(ms)(ms.state)
    assert bool(torch.isfinite(out.T).all())
    return dict(quantity="near-bottom BBL diffusivity [m2/s]",
                measured=near_bottom, analytic=1e-5,
                error=near_bottom - 1e-5, gate="> 1e-5, above the top's")


# --- neutral diffusion (tests/test_neutral_diffusion.py) ---------------------

def _ndiff_setup(device, nz=8, nx=16):
    G = build_cartesian_grid(nx, nx, 400.0, 400.0, max_depth=2000.0,
                             cyclic_x=True, reentrant_y=True, device=device)
    GV = build_layered_vgrid(nz, device=device)
    h = torch.full((nz, nx, nx), 2000.0 / nz, device=device)
    return G, GV, get_eos("LINEAR"), h


def _t(a, device):
    return torch.tensor(np.array(a, np.float32), device=device)


def ndiff_conserves_and_decays_variance(device):
    """The Redi step and its implicit K S^2 solve keep each tracer's
    content to 1e-5 and lower its variance
    (test_conservation_and_variance_decay)."""
    G, GV, eos, h = _ndiff_setup(device)
    rng = np.random.default_rng(0)
    nz = h.shape[0]
    zc = np.cumsum(np.full(nz, 250.0)) - 125.0
    T = _t(np.broadcast_to((15.0 - 0.004 * zc)[:, None, None], h.shape),
           device)
    S = torch.full_like(h, 35.0)
    tr = _t(rng.standard_normal((2,) + tuple(h.shape)), device)
    with torch.inference_mode():
        tr2, kd = neutral_diffusion(tr, h, T, S, G, GV, eos, 500.0, 3600.0)
        tr3 = tracer_vertdiff(tr2, h, kd, 3600.0)
    area, hh = _np(G.areaT), _np(h)
    m0 = (_np(tr) * hh[None] * area).sum(axis=(1, 2, 3))
    m1 = (_np(tr3) * hh[None] * area).sum(axis=(1, 2, 3))
    err = float(np.max(np.abs(m1 - m0) / np.abs(m0)))
    np.testing.assert_allclose(m1, m0, rtol=1e-5)
    v0, v3 = float(np.var(_np(tr))), float(np.var(_np(tr3)))
    assert v3 < v0, (v3, v0)
    return dict(quantity="content change, relative", measured=err,
                analytic=0.0, error=err, gate="<= 1e-5, variance falls")


def ndiff_density_aligned_tracer_neutral(device):
    """A tracer linear in the (linear-EOS) density under tilted
    isopycnals feels no rotated flux in the interior (1e-6 of the
    horizontal diffusion's change) and under half of it at the ends
    (test_neutrality_density_aligned_tracer)."""
    G, GV, eos, h = _ndiff_setup(device)
    nz, _, nx = h.shape
    zc = (np.cumsum(np.full(nz, 250.0)) - 125.0)[:, None, None]
    x = np.arange(nx)[None, None, :]
    T0 = 15.0 - 0.004 * zc + 0.3 * np.sin(2 * np.pi * x / nx)
    T = _t(np.broadcast_to(T0, h.shape), device)
    S = torch.full_like(h, 35.0)
    tr = (2.0 * T + 1.0)[None]
    with torch.inference_mode():
        tr2, _ = neutral_diffusion(tr, h, T, S, G, GV, eos, 1000.0, 3600.0)
        tr_h, _ = neutral_diffusion(tr, h, T, torch.full_like(S, 35.0), G,
                                    GV, eos, 1000.0, 3600.0, slope_max=0.0)
    dN = np.abs(_np(tr2 - tr))[0]
    dH = np.abs(_np(tr_h - tr))[0]
    ratio = float(dN[2:-2].max() / max(dH.max(), 1e-30))
    assert dN[2:-2].max() <= 1e-6 * max(dH.max(), 1e-30), ratio
    assert dN.max() < 0.5 * dH.max()
    return dict(quantity="interior rotated change over horizontal",
                measured=ratio, analytic=0.0, error=ratio, gate="<= 1e-6")


def ndiff_uniform_tracer_unchanged(device):
    """A uniform tracer stays uniform to 1e-5
    (test_uniform_tracer_unchanged)."""
    G, GV, eos, h = _ndiff_setup(device)
    zc = np.cumsum(np.full(8, 250.0)) - 125.0
    T = _t(np.broadcast_to((15.0 - 0.004 * zc)[:, None, None], h.shape),
           device)
    S = torch.full_like(h, 35.0)
    tr = torch.full((1,) + tuple(h.shape), 7.0, device=device)
    with torch.inference_mode():
        tr2, _ = neutral_diffusion(tr, h, T, S, G, GV, eos, 500.0, 3600.0)
    err = float(np.abs(_np(tr2) - 7.0).max() / 7.0)
    np.testing.assert_allclose(_np(tr2), 7.0, rtol=1e-5)
    return dict(quantity="change of a uniform tracer, relative",
                measured=err, analytic=0.0, error=err, gate="<= 1e-5")


def ndiff_boundary_tapering(device):
    """With a 350 m boundary layer the top interfaces' kd_redi vanishes
    (1e-3 of the untapered), the deep ones keep over half, and the
    content holds to 1e-5 (test_boundary_tapering_suppresses_cross_terms)."""
    nz, ny, nx = 8, 6, 6
    G = build_cartesian_grid(nx, ny, 60.0, 60.0, max_depth=800.0,
                             device=device)
    GV = build_layered_vgrid(nz, device=device)
    h = torch.full((nz, ny, nx), 100.0, device=device)
    z = torch.cumsum(h, dim=0) - 0.5 * h
    x = torch.arange(nx, dtype=torch.float32, device=device)[None, None, :]
    T = 15.0 - 8.0 * z / 800.0 + 0.5 * x / nx
    S = torch.full_like(T, 35.0)
    tr = torch.stack([T])
    eos = get_eos("LINEAR")
    bld = torch.full((ny, nx), 350.0, device=device)
    with torch.inference_mode():
        out_t, kd_t = neutral_diffusion(tr, h, T, S, G, GV, eos, 500.0,
                                        900.0, bld=bld)
        _, kd_0 = neutral_diffusion(tr, h, T, S, G, GV, eos, 500.0, 900.0)
    top = float(kd_t[1:3].max()) / (float(kd_0[1:3].max()) + 1e-30)
    assert top < 1e-3, top
    assert float(kd_t[6].max()) > 0.5 * float(kd_0[6].max())
    area, hh = _np(G.areaT), _np(h)
    q_t = float((_np(out_t[0]) * hh * area).sum())
    q_in = float((_np(T) * hh * area).sum())
    assert abs(q_t - q_in) / abs(q_in) < 1e-5
    return dict(quantity="tapered kd_redi over untapered (top)",
                measured=top, analytic=0.0, error=top, gate="< 1e-3")


def ndiff_surfaces_no_flux_for_density_tracer(device):
    """Matched neutral surfaces: a density tracer is (nearly) unchanged
    where a curved tracer mixes 50x more, and both keep their content
    (test_neutral_surfaces_no_flux_for_density_tracer)."""
    ny, nx, nz = 4, 8, 8
    G = build_cartesian_grid(nx, ny, 400.0, 200.0, max_depth=1000.0,
                             device=device)
    GV = build_layered_vgrid(nz, device=device)
    eos = get_eos("LINEAR")
    h = torch.full((nz, ny, nx), 1000.0 / nz, device=device)
    x = torch.arange(nx, dtype=torch.float32, device=device)[None, None, :]
    k = torch.arange(nz, dtype=torch.float32, device=device)[:, None, None]
    T = (20.0 - 1.5 * k - 0.8 * x) * torch.ones((nz, ny, nx), device=device)
    S = torch.full_like(T, 35.0)
    x2 = (x - nx / 2.0) ** 2
    tr = torch.stack([2.0 * T + 1.0, torch.broadcast_to(x2, T.shape)])
    with torch.inference_mode():
        tr_new = neutral_diffusion_surfaces(tr, h, T, S, G, GV, eos, 1000.0,
                                            3600.0)
    vol = _np(h) * _np(G.areaT)
    for i in range(2):
        np.testing.assert_allclose((_np(tr_new[i]) * vol).sum(),
                                   (_np(tr[i]) * vol).sum(), rtol=5e-6)
    d = np.abs(_np(tr_new) - _np(tr))
    ch_rho = float(d[0][2:-2, :, 2:-2].max())
    ch_x = float(d[1][2:-2, :, 2:-2].max())
    assert ch_x > 50.0 * max(ch_rho, 1e-12), (ch_rho, ch_x)
    assert float(d[0].max()) < 0.01
    return dict(quantity="curved-tracer change over density-tracer change",
                measured=ch_x / max(ch_rho, 1e-12), analytic=50.0,
                error=ch_x / max(ch_rho, 1e-12) - 50.0, gate="> 50")


# --- the ADAPTIVE coordinate (test_regrid_hybrid.py::test_adaptive_*) -------

ADAPT_NZ, ADAPT_DEPTH = 12, 1200.0


def _adapt_setup(device):
    G = build_cartesian_grid(5, 5, 50.0, 50.0, max_depth=ADAPT_DEPTH,
                             device=device)
    GV = build_layered_vgrid(ADAPT_NZ, device=device)
    h = torch.full((ADAPT_NZ, 5, 5), ADAPT_DEPTH / ADAPT_NZ, device=device)
    z = torch.cumsum(h, dim=0) - 0.5 * h
    T = 18.0 - 12.0 * z / ADAPT_DEPTH
    return G, GV, h, T, torch.full_like(T, 35.0), get_eos("LINEAR")


def adaptive_conserves_and_smooths(device):
    """ADAPTIVE keeps the column sums; a pycnocline at 600 m thins layer
    5 or 6 below uniform (test_adaptive_conserves_and_smooths)."""
    G, GV, h, T, S, eos = _adapt_setup(device)
    z = torch.cumsum(h, dim=0) - 0.5 * h
    T2 = 18.0 - 10.0 / (1.0 + torch.exp(-(z - 600.0) / 60.0))
    with torch.inference_mode():
        h_new = build_adaptive_grid(h, T2, S, G, GV, eos,
                                    AdaptParams(time_ratio=0.5))
    col0, col1 = _np(h).sum(axis=0), _np(h_new).sum(axis=0)
    assert np.allclose(col0, col1, rtol=1e-5)
    assert np.all(_np(h_new) > 0)
    hcol = _np(h_new)[:, 2, 2]
    thin = float(min(hcol[5], hcol[6]))
    assert thin < ADAPT_DEPTH / ADAPT_NZ, hcol
    return dict(quantity="thinnest pycnocline layer [m]", measured=thin,
                analytic=ADAPT_DEPTH / ADAPT_NZ,
                error=thin - ADAPT_DEPTH / ADAPT_NZ, gate="< uniform")


def adaptive_uniform_diffusion_is_identity(device):
    """Without zooming and buoyancy attraction the background smoothing
    of equispaced interfaces moves none by 1% of a layer
    (test_adaptive_uniform_diffusion_is_identity)."""
    G, GV, h, T, S, eos = _adapt_setup(device)
    p = AdaptParams(time_ratio=0.5, zoom_coeff=0.0, buoy_coeff=0.0)
    with torch.inference_mode():
        h_new = build_adaptive_grid(h, T, S, G, GV, eos, p)
    dev = float(np.abs(_np(h_new) - ADAPT_DEPTH / ADAPT_NZ).max())
    assert dev < 1e-2 * ADAPT_DEPTH / ADAPT_NZ, dev
    return dict(quantity="largest thickness change [m]", measured=dev,
                analytic=0.0, error=dev, gate="< 1% of a layer")


def adaptive_zoom_refines_surface(device):
    """Pure zooming thins the top layer below uniform and below the
    bottom one (test_adaptive_zoom_refines_surface)."""
    G, GV, h, T, S, eos = _adapt_setup(device)
    p = AdaptParams(time_ratio=0.3, zoom_coeff=1.0, buoy_coeff=0.0,
                    zoom_depth=200.0)
    with torch.inference_mode():
        h_new = _np(build_adaptive_grid(h, T, S, G, GV, eos, p))
    assert h_new[0, 2, 2] < ADAPT_DEPTH / ADAPT_NZ
    assert h_new[0, 2, 2] < h_new[ADAPT_NZ - 1, 2, 2]
    assert np.all(h_new > 0)
    return dict(quantity="top layer [m]", measured=float(h_new[0, 2, 2]),
                analytic=ADAPT_DEPTH / ADAPT_NZ,
                error=float(h_new[0, 2, 2]) - ADAPT_DEPTH / ADAPT_NZ,
                gate="< uniform, < bottom layer")


def adaptive_via_ale_driver(device):
    """ADAPTIVE through ale_regrid_remap keeps each column's heat to
    1e-4 (test_adaptive_via_ale_driver)."""
    G, GV, h, T, S, eos = _adapt_setup(device)
    st = OceanState(h=h, u=torch.zeros_like(h), v=torch.zeros_like(h),
                    T=T, S=S)
    with torch.inference_mode():
        st2, _ = ale_regrid_remap(st, G, GV, ALEParams(mode=ADAPTIVE,
                                                       eos_name="LINEAR"))
    q0 = (_np(st.h) * _np(st.T)).sum(axis=0)
    q1 = (_np(st2.h) * _np(st2.T)).sum(axis=0)
    err = float(np.abs(q1 - q0).max() / np.abs(q0).max())
    assert np.allclose(q0, q1, rtol=1e-4), err
    return dict(quantity="column heat change, relative", measured=err,
                analytic=0.0, error=err, gate="<= 1e-4")


# --- the internal tides (tests/test_internal_tides.py) ----------------------

IT_NX, IT_NY = 32, 24


def _itide_setup(device, open_edges=True):
    G = build_cartesian_grid(IT_NX, IT_NY, 320.0, 240.0, max_depth=2000.0,
                             cyclic_x=open_edges, reentrant_y=open_edges,
                             device=device)
    return G, build_layered_vgrid(4, device=device)


def _itide_run(En, src, cn, G, GV, dt, p, n):
    loss = None
    with torch.inference_mode():
        for _ in range(n):
            En, loss = step_internal_tides(En, src, cn, G, GV, dt, p)
    return En, loss


def _energy(En, G):
    return float((_np(En) * _np(G.areaT)[None]).sum())


def itide_free_propagation_conserves(device):
    """30 steps of free propagation on a doubly periodic grid keep the
    energy to 1e-5 with no loss (test_free_propagation_conserves_energy)."""
    G, GV = _itide_setup(device)
    p = InternalTidesParams(decay_rate=0.0, drag_coef=0.0)
    En = init_int_tide_energy(p, IT_NY, IT_NX, device=device)
    En[:, IT_NY // 2, IT_NX // 2] = 100.0
    cn = torch.full((IT_NY, IT_NX), 2.0, device=device)
    zero = torch.zeros((IT_NY, IT_NX), device=device)
    e0 = _energy(En, G)
    En, loss = _itide_run(En, zero, cn, G, GV, 600.0, p, 30)
    err = abs(_energy(En, G) - e0) / e0
    assert err < 1e-5, err
    assert float(loss.max()) == 0.0
    return dict(quantity="energy change, relative", measured=err,
                analytic=0.0, error=err, gate="< 1e-5, no loss")


def itide_beam_moves_at_group_speed(device):
    """The first bin's beam moves east at cg cos(pi/8) within two cells
    after 20 steps (test_beam_moves_at_group_speed)."""
    G, GV = _itide_setup(device)
    p = InternalTidesParams(n_angle=8, decay_rate=0.0, drag_coef=0.0)
    En = init_int_tide_energy(p, IT_NY, IT_NX, device=device)
    En[0, IT_NY // 2, 5] = 100.0
    cn = torch.full((IT_NY, IT_NX), 2.0, device=device)
    zero = torch.zeros((IT_NY, IT_NX), device=device)
    dt, n = 600.0, 20
    En, _ = _itide_run(En, zero, cn, G, GV, dt, p, n)
    x = np.arange(IT_NX) * 10e3
    e = _np(En[0]).sum(axis=0)
    xc = float((x * e).sum() / e.sum())
    expect = 5 * 10e3 + 2.0 * np.cos(np.pi / 8.0) * dt * n
    assert abs(xc - expect) < 2 * 10e3, (xc, expect)
    return dict(quantity="beam centre [m]", measured=xc, analytic=expect,
                error=xc - expect, gate="within 2 cells")


def itide_forcing_decay_balance(device):
    """Steady forcing against a decay of 1e-4 s-1 reaches E = input /
    decay and a loss equal to the input, each within 5%
    (test_forcing_and_decay_balance)."""
    G, GV = _itide_setup(device)
    p = InternalTidesParams(decay_rate=1e-4, drag_coef=0.0, q_local=0.0)
    En = init_int_tide_energy(p, IT_NY, IT_NX, device=device)
    cn = torch.full((IT_NY, IT_NX), 1.0, device=device)
    inp = torch.full((IT_NY, IT_NX), 0.01, device=device)
    En, loss = _itide_run(En, inp, cn, G, GV, 600.0, p, 400)
    e_tot = float(_np(En).sum(axis=0)[IT_NY // 2, IT_NX // 2])
    err = abs(e_tot - 100.0) / 100.0
    assert err < 0.05, e_tot
    lo = float(_np(loss)[IT_NY // 2, IT_NX // 2])
    assert abs(lo - 0.01) / 0.01 < 0.05, lo
    return dict(quantity="equilibrium energy [J m-2]", measured=e_tot,
                analytic=100.0, error=e_tot - 100.0, gate="within 5%")


def itide_refraction_conserves(device):
    """A northward gradient of the mode speed turns the rays out of their
    bin and keeps the energy to 1e-4
    (test_refraction_turns_rays_and_conserves)."""
    G, GV = _itide_setup(device)
    p = InternalTidesParams(n_angle=8, decay_rate=0.0, drag_coef=0.0)
    En = init_int_tide_energy(p, IT_NY, IT_NX, device=device)
    En[2] = 1.0
    cn = _t(1.0 + 1.0 * np.arange(IT_NY)[:, None] / IT_NY
            * np.ones((IT_NY, IT_NX)), device)
    zero = torch.zeros((IT_NY, IT_NX), device=device)
    e0 = _energy(En, G)
    En, _ = _itide_run(En, zero, cn, G, GV, 600.0, p, 20)
    err = abs(_energy(En, G) - e0) / e0
    assert err < 1e-4, err
    spread = _np(En).sum(axis=(1, 2))
    assert (spread > 1e-6 * spread.max()).sum() >= 2
    return dict(quantity="energy change, relative", measured=err,
                analytic=0.0, error=err, gate="< 1e-4, bins >= 2")


def itide_land_mask_blocks(device):
    """In a walled basin 50 steps stay finite and non-negative
    (test_land_mask_blocks)."""
    G, GV = _itide_setup(device, open_edges=False)
    p = InternalTidesParams(decay_rate=0.0, drag_coef=0.0)
    En = init_int_tide_energy(p, IT_NY, IT_NX, device=device)
    En[:, IT_NY // 2, IT_NX // 2] = 10.0
    cn = torch.full((IT_NY, IT_NX), 2.0, device=device)
    zero = torch.zeros((IT_NY, IT_NX), device=device)
    En, _ = _itide_run(En, zero, cn, G, GV, 600.0, p, 50)
    e = _np(En)
    assert np.isfinite(e).all()
    assert float(e.min()) >= 0.0
    return dict(quantity="least energy [J m-2]", measured=float(e.min()),
                analytic=0.0, error=float(e.min()), gate=">= 0, finite")


def itide_multi_freq_mode(device):
    """Two frequencies and two modes: K1 (sub-inertial at f = 1e-4) stays
    in its source cell while M2 spreads, mode 2 spreads no further than
    mode 1, and the (n_angle, ny, nx) form still steps
    (test_multi_freq_mode_propagation)."""
    ny = nx = 16
    G = build_cartesian_grid(nx, ny, 600.0, 600.0, max_depth=3000.0,
                             f0=1e-4, beta=0.0, device=device)
    GV = build_layered_vgrid(2, device=device)
    p = InternalTidesParams(n_angle=8, freqs=(1.4052e-4, 7.2921e-5),
                            freq_frac=(1.0, 1.0), n_mode=2, q_local=0.0,
                            decay_rate=0.0, drag_coef=0.0)
    En = init_int_tide_energy(p, ny, nx, device=device)
    assert tuple(En.shape) == (2, 2, 8, ny, nx)
    src = torch.zeros((ny, nx), device=device)
    src[8, 8] = 1.0
    cn = torch.full((ny, nx), 2.0, device=device)
    En, _ = _itide_run(En, src, cn, G, GV, 1800.0, p, 6)
    e = _np(En)
    m2_spread = int((e[0, 0].sum(axis=0) > 0).sum())
    k1_spread = int((e[1, 0].sum(axis=0) > 0).sum())
    assert m2_spread > k1_spread == 1, (m2_spread, k1_spread)

    def radius(fld):
        tot = fld.sum(axis=0)
        jj, ii = np.nonzero(tot > 1e-12 * tot.max())
        return max(np.abs(jj - 8).max(), np.abs(ii - 8).max())
    assert radius(e[0, 0]) >= radius(e[0, 1])
    En3 = torch.zeros((8, ny, nx), device=device)
    En3[:, 8, 8] = 1.0
    En3b, _ = _itide_run(En3, src, cn, G, GV, 1800.0,
                         InternalTidesParams(n_angle=8), 1)
    assert En3b.shape == En3.shape
    return dict(quantity="cells reached by M2 mode 1", measured=m2_spread,
                analytic=1, error=m2_spread - 1, gate="> K1's 1")


# --- the tidal mixing (tests/test_tidal_mixing.py) --------------------------

TM_NZ = 16


def _tidal_setup(device):
    G = build_cartesian_grid(4, 4, 40.0, 40.0, max_depth=2000.0,
                             device=device)
    GV = build_layered_vgrid(TM_NZ, device=device)
    h = torch.full((TM_NZ, 4, 4), 2000.0 / TM_NZ, device=device)
    z = torch.cumsum(h, dim=0) - 0.5 * h
    T = 20.0 - 15.0 * z / 2000.0
    return G, GV, h, T, torch.full_like(T, 35.0), get_eos("LINEAR")


def tidal_deposit_fraction_sums_to_one(device):
    """Both profiles deposit the whole bottom flux over the column, to
    1e-4, and nothing negative (test_deposit_fraction_sums_to_one)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    worst = 0.0
    with torch.inference_mode():
        n2 = _layer_n2(h, T, S, G, GV, eos)
        nb = torch.sqrt(torch.clamp(n2[-1], min=0.0))
        for profile in ("STLAURENT_02", "POLZIN_09"):
            p = TidalMixingParams(profile=profile, utide=0.1)
            frac = _np(_deposit_fractions(h, n2, nb, p, p.h2, p.utide))
            tot = frac.sum(axis=0)
            assert np.allclose(tot, 1.0, atol=1e-4), (profile, tot)
            assert np.all(frac >= -1e-6), profile
            worst = max(worst, float(np.abs(tot - 1.0).max()))
    return dict(quantity="column sum of the fractions - 1",
                measured=worst, analytic=0.0, error=worst, gate="<= 1e-4")


def tidal_stlaurent_decays_upward(device):
    """The exponential profile deposits more in each deeper layer
    (test_stlaurent_decays_upward)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    p = TidalMixingParams(utide=0.1)
    with torch.inference_mode():
        n2 = _layer_n2(h, T, S, G, GV, eos)
        frac = _np(_deposit_fractions(h, n2, torch.sqrt(n2[-1]), p, p.h2,
                                      p.utide))
    step = float(np.diff(frac[:, 0, 0]).min())
    assert step > 0.0, frac[:, 0, 0]
    return dict(quantity="least increase downward", measured=step,
                analytic=0.0, error=step, gate="> 0")


def tidal_tke_input_formula(device):
    """E = 0.5 kappa_h2_factor rho0 kappa h2 U^2 N_b to 1e-5, and the cap
    holds (test_tke_input_formula)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    p = TidalMixingParams(utide=0.05, h2=150.0, tke_itide_max=1e9)
    with torch.inference_mode():
        tke, nb = int_tide_input_tke(h, T, S, G, GV, eos, p)
        tke2, _ = int_tide_input_tke(
            h, T, S, G, GV, eos,
            dataclasses.replace(p, tke_itide_max=1e-6))
    expect = (0.5 * p.kappa_h2_factor * GV.rho0 * p.kappa_itides
              * 150.0 * 0.05 ** 2 * _np(nb))
    err = float(np.abs(_np(tke) - expect).max() / np.abs(expect).max())
    assert np.allclose(_np(tke), expect, rtol=1e-5), err
    assert np.all(_np(tke2) <= 1e-6 + 1e-12)
    return dict(quantity="conversion against the formula, relative",
                measured=err, analytic=0.0, error=err, gate="<= 1e-5")


def tidal_kd_energy_conservation(device):
    """Uncapped, the diffusivity spends mu gamma E / rho0 within 25% (the
    end halves dropped) (test_kd_energy_conservation)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    p = TidalMixingParams(utide=0.1, kd_max=1e9)
    with torch.inference_mode():
        n2 = _layer_n2(h, T, S, G, GV, eos)
        tke, _ = int_tide_input_tke(h, T, S, G, GV, eos, p)
        kd = tidal_mixing_kd(h, T, S, G, GV, eos, p)
    kd_lay = 0.5 * (_np(kd)[:-1] + _np(kd)[1:])
    power = (2.0 * kd_lay * (_np(n2) + 7.2921e-5 ** 2) * _np(h)).sum(axis=0)
    expect = p.mu_itides * p.gamma_itides * _np(tke) / GV.rho0
    err = float(np.abs(power / expect - 1.0).max())
    assert np.allclose(power, expect, rtol=0.25), err
    return dict(quantity="power spent over supplied - 1", measured=err,
                analytic=0.0, error=err,
                gate="np.allclose, rtol 0.25 and atol 1e-8")


def tidal_kd_cap_and_mask(device):
    """KD_MAX_ITIDES caps the diffusivity, none is negative, the ends are
    0 (test_kd_cap_and_mask)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    p = TidalMixingParams(utide=0.5, kd_max=1e-4)
    with torch.inference_mode():
        kd = _np(tidal_mixing_kd(h, T, S, G, GV, eos, p))
    assert kd.max() <= 1e-4 + 1e-10
    assert kd.min() >= 0.0
    assert np.all(kd[0] == 0.0) and np.all(kd[-1] == 0.0)
    return dict(quantity="largest Kd [m2 s-1]", measured=float(kd.max()),
                analytic=1e-4, error=float(kd.max()) - 1e-4,
                gate="<= 1e-4, ends 0")


def tidal_polzin_reaches_higher(device):
    """Polzin's algebraic tail puts more of the energy into the top half
    than the exponential (test_polzin_reaches_higher)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    with torch.inference_mode():
        n2 = _layer_n2(h, T, S, G, GV, eos)
        nb = torch.sqrt(torch.clamp(n2[-1], min=0.0))
        f_exp = _np(_deposit_fractions(h, n2, nb,
                                       TidalMixingParams(utide=0.1),
                                       100.0, 0.1))
        f_pol = _np(_deposit_fractions(
            h, n2, nb, TidalMixingParams(profile="POLZIN_09", utide=0.1),
            100.0, 0.1))
    top_exp = float(f_exp[:TM_NZ // 2, 0, 0].sum())
    top_pol = float(f_pol[:TM_NZ // 2, 0, 0].sum())
    assert top_pol > top_exp, (top_pol, top_exp)
    return dict(quantity="Polzin's top-half share", measured=top_pol,
                analytic=top_exp, error=top_pol - top_exp,
                gate="> the exponential's")


def tidal_set_diffusivity_integration(device):
    """DiffusivityParams.tidal adds to set_diffusivity's Kd
    (test_set_diffusivity_integration)."""
    G, GV, h, T, S, eos = _tidal_setup(device)
    with torch.inference_mode():
        kd = set_diffusivity(h, G, GV, DiffusivityParams(
            kd=1e-5, tidal=TidalMixingParams(utide=0.1)), T=T, S=S, eos=eos)
        kd0 = set_diffusivity(h, G, GV, DiffusivityParams(kd=1e-5), T=T,
                              S=S, eos=eos)
    add = float((kd - kd0).max())
    assert add > 1e-7, add
    return dict(quantity="largest tidal addition [m2 s-1]", measured=add,
                analytic=1e-7, error=add - 1e-7, gate="> 1e-7")


# --- the tidal wave drag (test_bt_cont.py) and the spherical gyre
# (test_ensemble_spherical.py) ------------------------------------------------

def wave_drag_map_damps_barotropic(device):
    """A piston-velocity map in BTParams.lin_drag damps a free gravity
    wave: after 40 steps less energy than without it
    (test_wave_drag_map_damps_barotropic).  In float64: the drag takes
    1.6e-4 of the energy, and float32's rounding of the 333 m layers moves
    the energy of either run by 0.7-2.5e-4 (the reference's and the
    port's float32 runs against the port's float64 one), so in float32
    the sign of the difference is the rounding's."""
    nx, ny, nz = 16, 12, 3
    f64 = torch.float64
    G = build_cartesian_grid(nx, ny, 160.0, 120.0, max_depth=1000.0,
                             dtype=f64, device=device)
    GV = build_layered_vgrid(nz, dtype=f64, device=device)
    state = init_state_resting(G, GV, [1000.0 / nz] * nz, dtype=f64)
    bump = 1.0 * np.exp(-((np.arange(nx) - nx / 2.0) ** 2) / 8.0)
    state = state.replace(h=state.h + torch.tensor(
        bump[None, None, :] / nz, dtype=f64, device=device))
    z = torch.cumsum(state.h, dim=0) - 0.5 * state.h
    T = 12.0 - 6.0 * z / 1000.0
    S = torch.full_like(T, 35.0)
    with torch.inference_mode():
        piston = wave_drag_piston(state.h, T, S, G, GV, get_eos("LINEAR"),
                                  gamma=50.0)
    assert float(piston.min()) >= 0.0 and float(piston.max()) > 0.0
    dt = 300.0
    nstep, _ = set_dtbt(G, GV, 1000.0, dt)
    area = _np(G.areaT)

    def energy(s):
        h, u, v = _np(s.h), _np(s.u), _np(s.v)
        eta = h.sum(axis=0) - _np(G.bathyT)
        return float(0.5 * (h * (u ** 2 + v ** 2) * area).sum()
                     + 0.5 * GV.g_earth * (eta ** 2 * area).sum())

    outs = []
    for lin in (0.0, piston):
        params = DynParams(dt=dt, bt=BTParams(nstep=nstep, nfilter=2,
                                              lin_drag=lin), kv=0.0)
        step = _dyn_stepper(MechForcing(), G, GV, params)
        s = state
        for _ in range(40):
            s = step(s)
        outs.append(energy(s))
    assert outs[1] < outs[0], outs
    return dict(quantity="energy with the drag over without",
                measured=outs[1] / outs[0], analytic=1.0,
                error=outs[1] / outs[0] - 1.0, gate="< 1")


def spherical_gyre_runs(device):
    """24 steps of a two-layer gyre on a 16x16 spherical sector under a
    zonal wind: u finite, between 1e-6 and 1 m/s
    (test_spherical_gyre_runs)."""
    G = build_spherical_grid(16, 16, -60.0, 15.0, 40.0, 30.0,
                             max_depth=2000.0, device=device)
    GV = build_layered_vgrid(2, device=device)
    state = init_state_resting(G, GV, [500.0, 1500.0])
    dt = 900.0
    nstep, _ = set_dtbt(G, GV, 2000.0, dt)
    params = DynParams(dt=dt, bt=BTParams(nstep=nstep, nfilter=2), kv=1e-4)
    lat = _np(G.geoLatT)
    taux = _t(-0.1 * np.cos(np.pi * (lat - 15) / 30.0), device) \
        * G.mask2dCu
    step = _dyn_stepper(MechForcing(taux=taux), G, GV, params)
    s = state
    for _ in range(24):
        s = step(s)
    u = _np(s.u)
    umax = float(np.abs(u).max())
    assert np.isfinite(u).all()
    assert 1e-6 < umax < 1.0, umax
    return dict(quantity="largest |u| [m/s]", measured=umax, analytic=0.5,
                error=umax - 0.5, gate="in (1e-6, 1)")


# --- the ice shelf, tc1, tc2 and the non-Boussinesq mode -------------------

def _shelf(device, ny=4, nx=6, draft=500.0, rho_w=1028.0):
    mass = np.zeros((ny, nx))
    mass[:, : nx // 2] = rho_w * draft
    return ShelfCoupling(mass_shelf=_t(mass, device),
                         frac_shelf_h=_t((mass > 0).astype(float), device))


def shelf_melt_increases_with_ocean_temperature(device):
    """Water 2 degC above the in-situ freezing point melts over 10x faster
    than water at it, 1-500 m a year, cooling the ocean; no melt in the
    open (test_shelf_coupling.py::test_melt_increases_with_ocean_
    temperature)."""
    sh = _shelf(device)
    S = _t(np.full((4, 6), 34.5), device)
    p = sh.melt
    t_freeze = p.lambda1 * 34.5 + p.lambda2 + p.lambda3 * (9.81 * 1028.0
                                                           * 500.0)
    melt_cold, _, _, _ = shelf_melt_fluxes(
        _t(np.full((4, 6), t_freeze), device), S, sh, 9.81)
    melt_warm, heat_warm, _, _ = shelf_melt_fluxes(
        _t(np.full((4, 6), t_freeze + 2.0), device), S, sh, 9.81)
    m_c = float(melt_cold[0, 0])
    m_w = float(melt_warm[0, 0])
    assert m_w > 10.0 * max(m_c, 1e-12), (m_w, m_c)
    m_per_yr = m_w * 86400.0 * 365.0
    assert 1.0 < m_per_yr < 500.0, m_per_yr
    assert float(heat_warm[0, 0]) < 0.0
    assert float(melt_warm[0, -1]) == 0.0
    ratio = m_w / max(m_c, 1e-12)
    return dict(quantity="melt at 2 degC of thermal driving over the melt "
                "at freezing", measured=ratio, analytic=10.0,
                error=ratio - 10.0, gate="> 10, the melt in (1, 500) m/yr",
                melt_m_per_yr=m_per_yr)


def shelf_pressure_and_stress_interception(device):
    """p_surf gains frac g mass; the wind stress is zeroed at faces under
    the shelf and kept at open ones (test_shelf_coupling.py::
    test_shelf_pressure_and_stress_interception)."""
    sh = _shelf(device)
    ny, nx = 4, 6

    class _St:
        T = S = u = v = None

    class _GV:
        g_earth = 9.81
        rho0 = 1028.0

    one = _t(np.ones((ny, nx)), device)
    f0 = Forcing(mech=MechForcing(taux=one, tauy=one,
                                  p_surf=torch.zeros_like(one)))
    f1, _ = apply_shelf_coupling(_St(), f0, None, _GV(), sh)
    p_expect = 9.81 * 1028.0 * 500.0
    np.testing.assert_allclose(float(f1.mech.p_surf[0, 0]), p_expect,
                               rtol=1e-6)
    assert float(f1.mech.p_surf[0, -1]) == 0.0
    assert float(f1.mech.taux[0, 0]) == 0.0
    assert float(f1.mech.taux[0, 3]) == 1.0
    got = float(f1.mech.p_surf[0, 0])
    return dict(quantity="shelf pressure [Pa]", measured=got,
                analytic=p_expect, error=got - p_expect, gate="rtol 1e-6")


def shelf_trim_removes_displaced_mass(device):
    """The trim takes p_surf/g of mass off each column's top, the
    straddled layer cut in proportion (test_shelf_coupling.py::
    test_trim_removes_exactly_the_displaced_mass)."""
    nz, ny, nx = 8, 3, 4
    h = _t(np.full((nz, ny, nx), 100.0), device)
    rho = _t(np.full((nz, ny, nx), 1000.0), device)
    p_surf = _t(np.broadcast_to(np.array([0.0, 150.0, 350.0, 750.0])
                                * 1000.0 * 9.81, (ny, nx)), device)
    h_new, _, _ = trim_columns_for_p_surf(h, None, None, rho, p_surf, 9.81)
    col = _np(h_new.sum(0))
    np.testing.assert_allclose(col[0], [800.0, 650.0, 450.0, 50.0],
                               rtol=1e-6)
    np.testing.assert_allclose(_np(h_new)[:2, 0, 1], [1e-10, 50.0],
                               atol=1e-6)
    err = float(np.abs(col[0] - [800.0, 650.0, 450.0, 50.0]).max())
    return dict(quantity="column left after the trim [m]",
                measured=float(col[0, 3]), analytic=50.0, error=err,
                gate="rtol 1e-6")


def isomip_cavity_melts_and_freshens(device):
    """configs/isomip: the cavity columns at the hydrostatic draft, and 4
    cycles melt ice: the top layer under the shelf freshens by over 1e-4
    and cools, the open ocean's changes by under 1e-4
    (test_shelf_coupling.py::test_isomip_cavity_melts_and_freshens)."""
    ms = build(device, "isomip")
    assert ms.params.shelf is not None
    col = _np(ms.state.h.sum(0))
    assert col[:, 0].mean() < 300.0, col[:, 0].mean()
    assert abs(col[:, -1].mean() - 900.0) < 1.0
    s = _cycles(ms, 4)
    assert bool(torch.isfinite(s.h).all()) and bool(torch.isfinite(s.T).all())
    dS = _np(s.S[0] - ms.state.S[0])
    dT = _np(s.T[0] - ms.state.T[0])
    dS_shelf, dS_open = float(dS[:, :8].mean()), float(dS[:, 24:].mean())
    assert dS_shelf < -1e-4, dS_shelf
    assert abs(dS_open) < 1e-4, dS_open
    assert float(dT[:, :8].mean()) < 0.0
    return dict(quantity="top-layer S change under the shelf [ppt]",
                measured=dS_shelf, analytic=-1e-4, error=dS_shelf + 1e-4,
                gate="< -1e-4 (open ocean within 1e-4)", dS_open=dS_open)


def tc1_benchmark_layered(device):
    """configs/tc1 (the layered benchmark: BULKML, GM, the ideal age,
    restoring): 4 cycles finite, the volume kept to 1e-4, the wind spins
    the basin up, the benchmark topography deeper in the south
    (test_tc_ladder.py::TestTC1::test_benchmark_layered)."""
    ms = build(device, "tc1")
    p = ms.params
    assert p.diabatic.boundary_layer_scheme == "BULKML"
    assert p.gm is not None and p.tfc is not None
    assert ms.forcing.buoy.restore_rate > 0.0
    s = _cycles(ms, 4)
    assert bool(torch.isfinite(s.T).all()) and bool(torch.isfinite(s.u).all())
    v0, v1 = _volume(ms, ms.state), _volume(ms, s)
    err = abs(v1 - v0) / v0
    assert err < 1e-4, err
    umax = float(s.u.abs().max())
    assert umax > 1e-6, umax
    bat = _np(ms.grid.bathyT)
    assert bat[1].mean() > bat[-2].mean()
    return dict(quantity="relative volume change after 4 cycles",
                measured=err, analytic=0.0, error=err,
                gate="< 1e-4, max|u| > 1e-6", max_u=umax)


def tc2_ale_full_physics(device):
    """configs/tc2 (z*, ePBL, MEKE, geothermal heating, neutral
    diffusion, JHL, frazil, PPM_IH4): 3 cycles finite, the volume kept
    to 1e-4, the halfpipe deepest mid-channel
    (test_tc_ladder.py::TestTC2::test_ale_full_physics)."""
    ms = build(device, "tc2")
    p = ms.params
    assert p.ale.mode == "ZSTAR" and p.meke is not None
    assert p.diabatic.boundary_layer_scheme == "EPBL"
    assert p.diabatic.geothermal is not None and p.neutral_diffusion
    s = _cycles(ms, 3)
    assert bool(torch.isfinite(s.T).all())
    v0, v1 = _volume(ms, ms.state), _volume(ms, s)
    err = abs(v1 - v0) / v0
    assert err < 1e-4, err
    bat = _np(ms.grid.bathyT)
    assert bat[4].mean() > bat[0].mean() and bat[4].mean() > bat[-1].mean()
    return dict(quantity="relative volume change after 3 cycles",
                measured=err, analytic=0.0, error=err, gate="< 1e-4")


def _steric_basin(device, boussinesq):
    nx, ny, nz, depth = 12, 10, 6, 2000.0
    G = build_cartesian_grid(nx, ny, 240.0, 200.0, max_depth=depth,
                             device=device)
    GV = build_layered_vgrid(nz, boussinesq=boussinesq, device=device)
    state = init_state_resting(G, GV, [depth / nz] * nz)
    z = torch.cumsum(state.h, dim=0) - 0.5 * state.h
    T = 14.0 - 8.0 * z / depth
    state = state.replace(T=T, S=torch.full_like(T, 35.0))
    dt = 1800.0
    nstep, _ = set_dtbt(G, GV, depth, dt)
    params = MOMParams(
        dyn=DynParams(dt=dt, bt=BTParams(nstep=nstep, nfilter=2), kv=1e-4),
        thermo_enabled=True, eos_name="WRIGHT",
        diabatic=DiabaticParams(boundary_layer_scheme="NONE", cp=3992.0),
        ale=ALEParams(mode="ZSTAR", dz_nominal=tuple([depth / nz] * nz)),
        n_dyn_per_thermo=1)
    return G, GV, state, params


def _steric_contrast(device, boussinesq):
    """24 cycles of uniform surface warming (500 W m-2) of a closed
    resting basin: the column measure (mass without, volume with the
    Boussinesq approximation) kept to 2e-6, the heat taken in within 2%;
    without it the geometric SSH rises by the EOS's specific-volume
    integral within 10%, with it by under 2e-4 m
    (test_nonbouss_mode.py::test_steric_contrast)."""
    G, GV, state, params = _steric_basin(device, boussinesq)
    eos = get_eos(params.eos_name)
    q = 500.0
    forcing = Forcing(buoy=BuoyancyForcing(
        heat_flux=torch.full_like(G.mask2dT, q)))
    area = _np(G.areaT * G.mask2dT)

    def totals(s):
        h64 = _np(s.h)
        col = (h64 * area[None]).sum()
        if boussinesq:
            eta_g = _np(s.h.sum(0) - G.bathyT)
        else:
            eta_g = _np(find_eta_nonbouss(s.h, s.T, s.S, G, GV, eos))
        ssh = (eta_g * area).sum() / area.sum()
        return col, ssh, (_np(s.T) * h64 * area[None]).sum()

    col0, ssh0, heat0 = totals(state)
    n_cyc = 24
    s = state
    with torch.inference_mode():
        for _ in range(n_cyc):
            s = step_mom(s, forcing, G, GV, params)
    col1, ssh1, heat1 = totals(s)
    assert abs(col1 - col0) / col0 < 2e-6, (col0, col1)
    heat_in = q * area.sum() * n_cyc * params.dyn.dt
    heat_gain = GV.rho0 * 3992.0 * (heat1 - heat0)
    assert abs(heat_gain / heat_in - 1.0) <= 0.02, (heat_gain, heat_in)
    got = ssh1 - ssh0
    if boussinesq:
        assert abs(got) < 2e-4, got
        return dict(quantity="SSH rise [m]", measured=got, analytic=0.0,
                    error=got, gate="|.| < 2e-4")
    with torch.inference_mode():
        dz0 = GV.rho0 * _np(state.h * spv_avg(state.h, state.T, state.S,
                                              GV, eos))
        dz1 = GV.rho0 * _np(state.h * spv_avg(state.h, s.T, s.S, GV, eos))
    want = ((dz1 - dz0).sum(axis=0) * area).sum() / area.sum()
    assert got > 1e-4, got
    assert abs(got - want) <= 0.1 * abs(want), (got, want)
    return dict(quantity="steric SSH rise [m]", measured=got, analytic=want,
                error=got - want, gate="rel 0.1, > 1e-4")


def steric_contrast_nonbouss(device):
    return _steric_contrast(device, False)


def steric_contrast_bouss(device):
    return _steric_contrast(device, True)


def nonbouss_basin_config_runs(device):
    """configs/nonbouss_basin: 12 cycles finite with h >= 0, the geometric
    SSH finite and apart from the column-mass measure by 1e-3 to 50 m
    (test_nonbouss_mode.py::test_nonbouss_basin_config_runs)."""
    ms = build(device, "nonbouss_basin")
    assert not ms.vgrid.boussinesq
    s = _cycles(ms, 12)
    for name in ("h", "u", "v", "T", "S"):
        assert bool(torch.isfinite(getattr(s, name)).all()), name
    assert float(s.h.min()) >= 0.0
    eos = get_eos(ms.params.eos_name)
    with torch.inference_mode():
        eta_g = _np(find_eta_nonbouss(s.h, s.T, s.S, ms.grid, ms.vgrid,
                                      eos))
    wet = _np(ms.grid.mask2dT) > 0.5
    assert np.isfinite(eta_g[wet]).all()
    d = np.abs(eta_g - _np(s.h.sum(0) - ms.grid.bathyT))[wet]
    assert 1e-3 < d.max() < 50.0, d.max()
    return dict(quantity="largest |steric - mass SSH| [m]",
                measured=float(d.max()), analytic=0.0,
                error=float(d.max()), gate="in (1e-3, 50)")


# name -> gate, in the order of the reference's test files
GATES = {
    "external_gwave_phase_speed": external_gwave,
    "internal_wave_speed": internal_wave,
    "soliton_boyd_speed": soliton,
    "geostrophic_adjustment_jet": geostrophic_adjustment,
    "lock_exchange_benjamin_front": lock_exchange,
    "kpp_convective_deepening": kpp_convective_deepening,
    "epbl_convective_deepening": epbl_convective_deepening,
    "stommel_gyre_sverdrup_balance": stommel_gyre,
    "ekman_spiral_finite_depth": ekman_spiral,
    "phillips_baroclinic_instability_growth": phillips_instability,
    "pierced_face_rest_pf_small": pierced_face_rest_pf_small,
    "pierced_face_force_continuous_in_sliver":
        pierced_face_force_continuous_in_sliver,
    # tests/test_user_configs.py on the configurations this port runs
    "phillips_jet_balanced": phillips_jet_balanced,
    "scm_kpp_mixes_under_wind": scm_kpp_mixes_under_wind,
    "neverworld_topography_and_stability":
        neverworld_topography_and_stability,
    "hurricane_wind_structure": hurricane_wind_structure,
    "hurricane_cold_wake": hurricane_cold_wake,
    "supercritical_steps_stably": supercritical_steps_stably,
    "kelvin_wave_trapped_at_coast": kelvin_wave_trapped_at_coast,
    "shelfwave_trapped_on_shelf": shelfwave_trapped_on_shelf,
    "dome_inflow_enters_and_descends": dome_inflow_enters_and_descends,
    "dome_plume_turns_west": dome_plume_turns_west,
    # tests/test_obc_file_reservoir.py, test_tc_ladder.py, test_obc.py
    "tidal_bay_file_forcing": tidal_bay_file_forcing,
    "tc3_circle_obcs_radiation": tc3_circle_obcs_radiation,
    "flather_radiates_waves_out": flather_radiates_waves_out,
    "orlanski_radiates_waves_out": orlanski_radiates_waves_out,
    # test_user_configs.py, test_tc_ladder.py::TestTC4,
    # test_coupler_waves.py, test_bulk_ml.py, test_regrid_hybrid.py and
    # test_wired_subsystems.py on the sponge, the BBL, LF17, the bulk
    # mixed layer and HYCOM1
    "dense_water_steps_stably": dense_water_steps_stably,
    "tc4_sponge_ale": tc4_sponge_ale,
    "adjustment_front_stays_balanced": adjustment_front_stays_balanced,
    "epbl_lf17_deepens_mld": epbl_lf17_deepens_mld,
    "diabatic_layered_end_to_end": diabatic_layered_end_to_end,
    "bulkml_wind_deepens": bulkml_wind_deepens,
    "hycom_interior_follows_isopycnals": hycom_interior_follows_isopycnals,
    "hycom_via_config_driver": hycom_via_config_driver,
    "sponge_relaxes_to_reference": sponge_relaxes_to_reference,
    "bbl_drag_diffusivity": bbl_drag_diffusivity,
    # test_neutral_diffusion.py, test_regrid_hybrid.py::test_adaptive_*,
    # test_internal_tides.py, test_tidal_mixing.py, test_bt_cont.py and
    # test_ensemble_spherical.py on spherical_gyre's and tides_channel's
    # modules
    "ndiff_conserves_and_decays_variance":
        ndiff_conserves_and_decays_variance,
    "ndiff_density_aligned_tracer_neutral":
        ndiff_density_aligned_tracer_neutral,
    "ndiff_uniform_tracer_unchanged": ndiff_uniform_tracer_unchanged,
    "ndiff_boundary_tapering": ndiff_boundary_tapering,
    "ndiff_surfaces_no_flux_for_density_tracer":
        ndiff_surfaces_no_flux_for_density_tracer,
    "adaptive_conserves_and_smooths": adaptive_conserves_and_smooths,
    "adaptive_uniform_diffusion_is_identity":
        adaptive_uniform_diffusion_is_identity,
    "adaptive_zoom_refines_surface": adaptive_zoom_refines_surface,
    "adaptive_via_ale_driver": adaptive_via_ale_driver,
    "itide_free_propagation_conserves": itide_free_propagation_conserves,
    "itide_beam_moves_at_group_speed": itide_beam_moves_at_group_speed,
    "itide_forcing_decay_balance": itide_forcing_decay_balance,
    "itide_refraction_conserves": itide_refraction_conserves,
    "itide_land_mask_blocks": itide_land_mask_blocks,
    "itide_multi_freq_mode": itide_multi_freq_mode,
    "tidal_deposit_fraction_sums_to_one":
        tidal_deposit_fraction_sums_to_one,
    "tidal_stlaurent_decays_upward": tidal_stlaurent_decays_upward,
    "tidal_tke_input_formula": tidal_tke_input_formula,
    "tidal_kd_energy_conservation": tidal_kd_energy_conservation,
    "tidal_kd_cap_and_mask": tidal_kd_cap_and_mask,
    "tidal_polzin_reaches_higher": tidal_polzin_reaches_higher,
    "tidal_set_diffusivity_integration": tidal_set_diffusivity_integration,
    "wave_drag_map_damps_barotropic": wave_drag_map_damps_barotropic,
    "spherical_gyre_runs": spherical_gyre_runs,
    # test_shelf_coupling.py, test_tc_ladder.py::TestTC1 and TestTC2 and
    # test_nonbouss_mode.py on isomip's, tc1's, tc2's and nonbouss_basin's
    # modules
    "shelf_melt_increases_with_ocean_temperature":
        shelf_melt_increases_with_ocean_temperature,
    "shelf_pressure_and_stress_interception":
        shelf_pressure_and_stress_interception,
    "shelf_trim_removes_displaced_mass": shelf_trim_removes_displaced_mass,
    "isomip_cavity_melts_and_freshens": isomip_cavity_melts_and_freshens,
    "tc1_benchmark_layered": tc1_benchmark_layered,
    "tc2_ale_full_physics": tc2_ale_full_physics,
    "steric_contrast_nonbouss": steric_contrast_nonbouss,
    "steric_contrast_bouss": steric_contrast_bouss,
    "nonbouss_basin_config_runs": nonbouss_basin_config_runs,
}

# the gate the reference marks slow: the card runs it, the CPU tests not
CARD_ONLY = ("nonbouss_basin_config_runs",)


# the gates of spherical_gyre's and tides_channel's modules: each a second
# or less, so chip_smoke.py runs several in one process
BATCHED = tuple(list(GATES)[list(GATES).index(
    "ndiff_conserves_and_decays_variance"):])


def run_gate(name, device):
    """The gate's record with the seconds it took; raises on a miss."""
    t0 = time.time()
    rec = GATES[name](device)
    rec["seconds"] = time.time() - t0
    return rec
