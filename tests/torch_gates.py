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
test_tc_ladder.py::TestTC1 and TestTC2, test_nonbouss_mode.py), and
those of the coupled caps and what they reach (test_coupled_cap.py,
test_nuopc_cap.py, test_coupler_waves.py, test_bgc.py,
test_barotropic_parity.py::test_dynamic_psurf_damps_under_rigid_ice and
test_aux_physics.py's brine plume and opacity), and those of HYBGEN,
the z-level initialisation, the horizontal regridding and the SSA with
the ice-only driver (test_regrid_hybrid.py::test_hybgen_*,
test_ale.py::TestZInit, test_horiz_regrid.py, test_ssa.py), run through
the PyTorch port.

Each gate builds its case through the port (the configuration's
MOM_input, the test's parameter text, or the port's builders), runs it
at the test's own size and length, and makes the test's own asserts with
its tolerances.  It returns a record of what it measured against the
analytic value, and raises AssertionError on a miss.  This module
imports no jax, so chip_smoke.py runs the gates on the card
(``device="cuda"``) and tests/test_torch_analytic.py on the CPU.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
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

__all__ = ["GATES", "BATCHED", "CARD_ONLY", "COUPLED", "OPTIONS",
           "LATERAL", "STOCH_TIDES", "HYBGEN_ICE", "run_gate"]

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


# --- the coupled caps and what they reach: test_coupled_cap.py,
# test_nuopc_cap.py, test_coupler_waves.py, test_bgc.py,
# test_barotropic_parity.py::test_dynamic_psurf_damps_under_rigid_ice and
# test_aux_physics.py's brine plume and opacity ---------------------------

CAP_BASE = """
NIGLOBAL = 12
NJGLOBAL = 10
NK = 4
LENLON = 500.0
LENLAT = 400.0
MAXIMUM_DEPTH = 1000.0
F_0 = 1.0e-4
DT = 900.0
DT_THERM = 1800.0
ENABLE_THERMODYNAMICS = True
T_REF = 12.0
T_RANGE = 4.0
USE_REGRIDDING = True
REGRIDDING_COORDINATE_MODE = Z*
"""

# the step's shared options as chip_smoke.py's [options] phase sets them
# on configs/global_half_deg and tests/test_torch_options.py on a small
# configs/benchmark: the barotropic drags, GL90, KHTR's passivity and cap,
# the boundary-layer diffusion, CVMix convection and double diffusion
OPTIONS_OVERRIDE = """BT_LIN_DRAG = 1.0e-4
BT_CDRAG = 0.003
USE_GL90_IN_SSW = True
KD_GL90 = 1000.0
HBBL_GL90 = 10.0
KHTR_PASSIVITY_COEFF = 1.0
KHTR_MAX = 900.0
USE_HORIZONTAL_BOUNDARY_DIFFUSION = True
USE_CVMIX_CONVECTION = True
DOUBLE_DIFFUSION = True
"""


def _cap_dir(text):
    """A temporary run directory holding ``text`` as its MOM_input."""
    d = tempfile.mkdtemp(prefix="cap_")
    atexit.register(shutil.rmtree, d, True)
    with open(os.path.join(d, "MOM_input"), "w") as f:
        f.write(text)
    return d


def _cap_model(device, text=CAP_BASE):
    from mom6_tpu_torch.drivers.coupled_cap import ocean_model_init
    return ocean_model_init(_cap_dir(text), device=device)


def _nuopc(device, text=CAP_BASE + "FRAZIL = True\n"):
    from mom6_tpu_torch.drivers.nuopc import NUOPCCap
    cap = NUOPCCap(_cap_dir(text), device=device)
    cap.advertise()
    cap.realize(stop_days=1.0, restart_interval_sec=3600,
                calendar="NOLEAP", start_date=(2000, 3, 1))
    return cap


def _nuopc_imports(cap, **over):
    """tests/test_nuopc_cap.py::_imports: the full flux set, float32."""
    G = cap.model.grid
    one = torch.ones((G.ny, G.nx), dtype=torch.float32,
                     device=G.mask2dT.device)
    base = {
        "Foxx_taux": 0.05 * one, "Foxx_tauy": 0.0 * one,
        "Foxx_sen": -15.0 * one, "Foxx_evap": -2e-5 * one,
        "Foxx_lwnet": -60.0 * one,
        "Foxx_swnet_vdr": 60.0 * one, "Foxx_swnet_vdf": 40.0 * one,
        "Foxx_swnet_idr": 50.0 * one, "Foxx_swnet_idf": 30.0 * one,
        "Faxa_rain": 3e-5 * one, "Faxa_snow": 1e-6 * one,
        "Foxx_rofl": 1e-6 * one, "Foxx_rofi": 1e-7 * one,
        "Fioi_salt": 1e-7 * one, "Fioi_meltw": 1e-6 * one,
        "Fioi_melth": -5.0 * one,
        "Foxx_hrain": 0.5 * one, "Foxx_hsnow": -0.1 * one,
        "Foxx_hevap": -0.4 * one, "Foxx_hcond": 0.1 * one,
        "Foxx_hrofl": 0.2 * one, "Foxx_hrofi": -0.05 * one,
        "Sa_pslv": 101325.0 * one, "Si_ifrac": 0.0 * one,
        "So_duu10n": 49.0 * one,
    }
    base.update(over)
    return base


def cap_iob_conversion_signs(device):
    """Sensible, longwave and evaporation all cool (-200 W m-2), the
    shortwave stays apart, evaporation salts the surface
    (test_coupled_cap.py::test_iob_conversion_signs)."""
    from mom6_tpu_torch.drivers.coupled_cap import (IceOceanBoundary,
                                                    convert_iob_to_forcing)
    model = _cap_model(device)
    one = torch.ones_like(model.grid.mask2dT)
    iob = IceOceanBoundary(t_flux=100.0 * one, lw_flux=50.0 * one,
                           q_flux=2e-5 * one, sw_flux=200.0 * one)
    f = convert_iob_to_forcing(iob, 35.0 * one, model.vgrid)
    q = _np(f.buoy.heat_flux)
    np.testing.assert_allclose(q, -200.0, rtol=1e-5)
    np.testing.assert_allclose(_np(f.buoy.sw_flux), 200.0)
    np.testing.assert_allclose(_np(f.buoy.salt_flux),
                               35.0 * 2e-5 / model.vgrid.rho0, rtol=1e-5)
    return dict(quantity="net heat [W m-2]", measured=float(q.mean()),
                analytic=-200.0, error=float(q.mean()) + 200.0,
                gate="rtol 1e-5")


def cap_slab_atmosphere_coupled_loop(device):
    """A cold slab atmosphere coupled both ways for 6 intervals: the sea
    surface cools, the slab warms (test_coupled_cap.py::
    test_slab_atmosphere_coupled_loop)."""
    from mom6_tpu_torch.drivers.coupled_cap import (export_state_nuopc,
                                                    import_state_nuopc,
                                                    update_ocean_model)
    model = _cap_model(device)
    mask = _np(model.grid.mask2dT)
    t_atm, c_slab, c_x = 5.0, 2e7, 20.0
    sst0 = None
    for _ in range(6):
        sst = _np(export_state_nuopc(model)["sea_surface_temperature"])
        if sst0 is None:
            sst0 = sst.copy()
        sens = c_x * (sst - t_atm)
        iob = import_state_nuopc({"mean_sensi_heat_flx": torch.tensor(
            sens, dtype=torch.float32, device=model.grid.mask2dT.device)})
        update_ocean_model(model, iob)
        t_atm = t_atm + float((sens * mask).sum() / max(mask.sum(), 1)) \
            * model.coupling_dt / c_slab
    sst1 = _np(export_state_nuopc(model)["sea_surface_temperature"])
    wet = mask > 0.5
    assert sst1[wet].mean() < sst0[wet].mean()
    assert t_atm > 5.0
    assert np.isfinite(sst1).all()
    return dict(quantity="mean SST change [degC]",
                measured=float(sst1[wet].mean() - sst0[wet].mean()),
                analytic=0.0, error=float(t_atm - 5.0),
                gate="SST falls, the slab warms")


def cap_lifecycle_restart(device):
    """Two intervals under a wind stress, then ocean_model_end writes a
    restart with h and T at the model's time; an unknown NUOPC name
    raises (test_coupled_cap.py::test_lifecycle_restart and
    test_nuopc_unknown_field_raises)."""
    from mom6_tpu_torch.drivers.coupled_cap import (IceOceanBoundary,
                                                    import_state_nuopc,
                                                    ocean_model_end,
                                                    update_ocean_model)
    from mom6_tpu_torch.io.netcdf import read_nc
    model = _cap_model(device)
    iob = IceOceanBoundary(u_flux=0.1 * torch.ones_like(model.grid.mask2dT)
                           * model.grid.mask2dCu)
    update_ocean_model(model, iob, n_cycles=2)
    with tempfile.TemporaryDirectory() as d:
        rp = os.path.join(d, "ocean.res.nc")
        ocean_model_end(model, restart_path=rp)
        data = read_nc(rp)
    assert "h" in data and "T" in data
    t = float(data["__time_seconds__"][0])
    assert t == model.time_seconds
    try:
        import_state_nuopc({"mean_made_up_flux": model.grid.mask2dT})
    except KeyError:
        pass
    else:
        raise AssertionError("an unknown NUOPC name did not raise")
    return dict(quantity="restart time [s]", measured=t,
                analytic=2 * model.coupling_dt, error=0.0,
                gate="equal; unknown name raises")


def cap_components_step_concurrently(device):
    """Every component's work is queued before any result is awaited,
    and the results equal sequential stepping
    (test_coupled_cap.py::test_concurrent_component_stepping)."""
    from mom6_tpu_torch.drivers.coupled_cap import \
        update_components_concurrent
    x = torch.ones((64, 64), device=device)
    y = torch.ones((32, 32), device=device)

    def ocean_work():
        return torch.tanh(x) @ x.T

    def ice_work():
        return torch.sin(y) * 2.0
    got = update_components_concurrent(ocean_work, [ice_work])
    err = max(float((got[0] - ocean_work()).abs().max()),
              float((got[1] - ice_work()).abs().max()))
    assert err <= 1e-6 * 64, err
    return dict(quantity="max |concurrent - sequential|", measured=err,
                analytic=0.0, error=err, gate="<= 6.4e-5")


def nuopc_advertise_and_advance(device):
    """The advertised menus, one interval under the full import set:
    every export finite, the slope's sign that of the SSH gradient, the
    clock one interval on (test_nuopc_cap.py::test_advertise_menu and
    test_advance_full_import_set)."""
    from mom6_tpu_torch.drivers.nuopc import FLDS_FR_OCN, FLDS_TO_OCN
    cap = _nuopc(device)
    imports, exports = cap.advertise()
    assert set(imports) == set(FLDS_TO_OCN) and exports == FLDS_FR_OCN
    exp = cap.advance(_nuopc_imports(cap))
    assert set(exp) == set(FLDS_FR_OCN)
    for name, arr in exp.items():
        assert bool(torch.isfinite(arr).all()), name
    from mom6_tpu_torch.diagnostics.diagnostics import extract_surface_state
    ssh = _np(extract_surface_state(cap.model.state, cap.model.grid,
                                    cap.model.vgrid).ssh)
    dhdx = _np(exp["So_dhdx"])
    interior = np.s_[2:-2, 2:-2]
    grad = np.gradient(ssh, axis=-1)[interior]
    big = np.abs(grad) > np.abs(grad).max() * 0.3
    agree = 1.0
    if big.any():
        agree = float((np.sign(dhdx[interior][big])
                       == np.sign(grad[big])).mean())
        assert agree > 0.9, agree
    elapsed = cap.clock.current.total_seconds() \
        - cap.clock.start.total_seconds()
    assert elapsed == cap.model.coupling_dt
    return dict(quantity="slope sign agreement", measured=agree,
                analytic=1.0, error=agree - 1.0, gate="> 0.9")


def nuopc_sign_folding_net_heat(device):
    """The mediator's positive-down fluxes fold onto the exchange's FMS
    signs: the net heat is the hand sum, the four bands sum to 180 W
    m-2, p_surf and u10 pass (test_nuopc_cap.py::
    test_sign_folding_net_heat)."""
    from mom6_tpu_torch.drivers.coupled_cap import convert_iob_to_forcing
    cap = _nuopc(device)
    iob = cap.ingest_import_state(_nuopc_imports(cap))
    sss = 35.0 * torch.ones_like(cap.model.grid.mask2dT)
    f = convert_iob_to_forcing(iob, sss, cap.model.vgrid)
    expect = (-15.0 - 60.0 - 50.0 - 3.34e5 * 1.1e-6 - 5.0 + 0.25)
    q = _np(f.buoy.heat_flux)
    np.testing.assert_allclose(q, expect, rtol=1e-4)
    np.testing.assert_allclose(_np(f.buoy.sw_flux), 180.0, rtol=1e-5)
    np.testing.assert_allclose(_np(f.mech.p_surf), 101325.0)
    np.testing.assert_allclose(_np(f.mech.u10), 7.0, rtol=1e-5)
    return dict(quantity="net heat [W m-2]", measured=float(q.mean()),
                analytic=expect, error=float(q.mean()) - expect,
                gate="rtol 1e-4")


def nuopc_fioo_q_freezing_and_melting(device):
    """A warm ocean exports its negative melt potential as Fioo_q; an
    ocean at -2 degC under 2000 W m-2 of cooling forms frazil within 8
    intervals and exports it positive, its SST held above -3.5
    (test_nuopc_cap.py::test_fioo_q_freezing_and_melting)."""
    cap = _nuopc(device)
    exp = cap.advance(_nuopc_imports(cap))
    q_warm = _np(exp["Fioo_q"])
    mask = _np(cap.model.grid.mask2dT) > 0.5
    assert (q_warm[mask] <= 0.0).all() and (q_warm[mask] < 0.0).any()
    st = cap.model.state
    cap.model.state = st.replace(T=torch.full_like(st.T, -2.0))
    one = torch.ones_like(exp["So_t"])
    freeze = _nuopc_imports(cap, Foxx_sen=-2000.0 * one,
                            Foxx_swnet_vdr=0.0 * one,
                            Foxx_swnet_vdf=0.0 * one,
                            Foxx_swnet_idr=0.0 * one,
                            Foxx_swnet_idf=0.0 * one)
    for _ in range(8):
        exp = cap.advance(freeze)
        if (_np(exp["Fioo_q"])[mask] > 0.0).any():
            break
    q = _np(exp["Fioo_q"])
    assert (q[mask] > 0.0).any()
    sst = _np(exp["So_t"])
    assert sst[mask].min() > -3.5
    return dict(quantity="largest Fioo_q under freezing [W m-2]",
                measured=float(q[mask].max()), analytic=0.0,
                error=float(q[mask].max()), gate="> 0; warm <= 0")


def nuopc_restart_alarm_dated_file(device):
    """The hourly restart alarm writes mom.r.2000-03-01-SSSSS.nc
    (test_nuopc_cap.py::test_restart_alarm_writes_dated_file)."""
    cap = _nuopc(device)
    hours = int(3600 / cap.model.coupling_dt)
    for _ in range(hours + 1):
        cap.advance(_nuopc_imports(cap))
    files = os.listdir(cap.restart_dir)
    ok = [f for f in files
          if f.startswith("mom.r.2000-03-01-") and f.endswith(".nc")]
    assert ok, files
    try:
        cap.ingest_import_state({"Foxx_bogus": cap.model.grid.mask2dT})
    except KeyError:
        pass
    else:
        raise AssertionError("an unadvertised import did not raise")
    return dict(quantity="dated restart files", measured=float(len(ok)),
                analytic=1.0, error=float(len(ok) - 1),
                gate=">= 1; unadvertised import raises")


def nuopc_lamult_inversion_roundtrip(device):
    """la_from_efactor inverts the ePBL enhancement exactly
    (test_nuopc_cap.py::test_lamult_inversion_roundtrip)."""
    from mom6_tpu_torch.physics.waves import (la_from_efactor,
                                              mstar_lt_enhancement)
    p = WaveParams()
    lamult = torch.tensor([1.1, 1.5, 2.0, 3.0], device=device)
    back = _np(mstar_lt_enhancement(la_from_efactor(lamult, p), p))
    np.testing.assert_allclose(back, _np(lamult), rtol=1e-5)
    err = float(np.abs(back / _np(lamult) - 1.0).max())
    return dict(quantity="max relative round-trip error", measured=err,
                analytic=0.0, error=err, gate="rtol 1e-5")


def nuopc_pstokes_drive_surfbands(device):
    """The coupler's (nb, ny, nx) Stokes maps reach the SURFBANDS closure:
    stronger waves give a smaller Langmuir number
    (test_nuopc_cap.py::test_pstokes_bands_drive_surfbands)."""
    from mom6_tpu_torch.physics.waves import langmuir_number
    ny, nx, nz, nb = 4, 5, 6, 3
    h = torch.full((nz, ny, nx), 10.0, device=device)
    p = WaveParams(method="SURFBANDS", band_wavenumbers=(0.04, 0.11, 0.3305))
    ustar = torch.full((ny, nx), 0.01, device=device)
    hbl = torch.full((ny, nx), 40.0, device=device)
    weak = 0.02 * torch.ones((nb, ny, nx), device=device)
    strong = 0.12 * torch.ones((nb, ny, nx), device=device)
    la_w = langmuir_number(ustar, hbl, p, h=h, stk_x=weak,
                           stk_y=torch.zeros_like(weak))
    la_s = langmuir_number(ustar, hbl, p, h=h, stk_x=strong,
                           stk_y=torch.zeros_like(strong))
    assert bool((la_s < la_w).all()) and bool(torch.isfinite(la_w).all())
    return dict(quantity="La under strong / weak waves",
                measured=float((la_s / la_w).max()), analytic=1.0,
                error=float((la_s / la_w).max()) - 1.0, gate="< 1")


def nuopc_wave_imports_reach_step(device):
    """Sw_lamult flows through MechForcing into the step; the run stays
    finite (test_nuopc_cap.py::test_wave_imports_reach_step)."""
    cap = _nuopc(device)
    one = torch.ones_like(cap.model.grid.mask2dT)
    exp = cap.advance(_nuopc_imports(cap, Sw_lamult=1.8 * one))
    assert bool(torch.isfinite(exp["So_t"]).all())
    return dict(quantity="finite So_t", measured=1.0, analytic=1.0,
                error=0.0, gate="finite")


def ocean_model_coupling_api(device):
    """OceanModel on a 12x12x4 thermo gyre: 3 intervals spin up a
    surface current, a fourth continues the clock
    (test_coupler_waves.py::test_ocean_model_coupling_api)."""
    from mom6_tpu_torch.drivers.ocean_model import OceanModel
    G, GV, state, params, forcing = thermo_gyre(12, 12, 4, dt=1800.0,
                                                device=device)
    om = OceanModel(G, GV, state, params)
    sfc = om.update_ocean_model(taux=forcing.mech.taux,
                                heat_flux=forcing.buoy.heat_flux,
                                n_cycles=3)
    assert om.time_seconds == 3 * om.coupling_dt
    assert bool(torch.isfinite(sfc.sst).all())
    speed = float(sfc.speed.max())
    assert speed > 0.0
    om.update_ocean_model(taux=forcing.mech.taux, n_cycles=1)
    assert om.time_seconds == 4 * om.coupling_dt
    return dict(quantity="largest surface speed [m s-1]", measured=speed,
                analytic=0.0, error=speed, gate="> 0")


def waves_stokes_and_langmuir(device):
    """The EFACTOR sea: 1.6% of U10 at the surface decaying with depth,
    La between 0.2 and 0.5 at u* 0.012 and U10 10, KPP's enhancement
    1.5-5 there and ~1 at La 3 (test_coupler_waves.py::
    test_stokes_and_langmuir)."""
    from mom6_tpu_torch.physics.waves import (langmuir_enhancement,
                                              langmuir_number,
                                              stokes_drift_profile)
    z = torch.tensor([0.0, 5.0, 20.0, 80.0], device=device)
    us = _np(stokes_drift_profile(10.0, z))
    assert abs(us[0] - 0.16) < 0.02 and np.all(np.diff(us) < 0)
    la = float(langmuir_number(torch.tensor(0.012, device=device),
                               u10=torch.tensor(10.0, device=device),
                               p=WaveParams(method="EFACTOR")))
    assert 0.2 < la < 0.5
    f = float(langmuir_enhancement(torch.tensor(la, device=device)))
    assert 1.5 < f < 5.0
    f0 = float(langmuir_enhancement(torch.tensor(3.0, device=device)))
    assert 1.0 <= f0 < 1.1
    return dict(quantity="EFACTOR La", measured=la, analytic=0.35,
                error=la - 0.35, gate="in (0.2, 0.5)")


def waves_dhh85_profile(device):
    """The DHH85 spectrum's drift: 0.05-0.3 m s-1 at the surface under a
    10 m s-1 wind, decaying, below 20% of it at 30 m
    (test_coupler_waves.py::test_dhh85_profile)."""
    from mom6_tpu_torch.physics.waves import dhh85_stokes_profile
    p = WaveParams(method="DHH85", wave_wind=10.0)
    z = torch.tensor([0.1, 1.0, 5.0, 10.0, 30.0], device=device)
    us = _np(dhh85_stokes_profile(z, p))
    assert 0.05 < us[0] < 0.3, us[0]
    assert np.all(np.diff(us) < 0) and us[-1] < 0.2 * us[0]
    return dict(quantity="surface Stokes drift [m s-1]",
                measured=float(us[0]), analytic=0.15,
                error=float(us[0]) - 0.15, gate="in (0.05, 0.3)")


def waves_surfband_analytic(device):
    """SURFBANDS' layer means equal the analytic integral of exp(2kz)
    over each layer (test_coupler_waves.py::
    test_surfband_layer_average_analytic)."""
    from mom6_tpu_torch.physics.waves import surfband_stokes_profile
    k, us0, H = 0.02, 0.1, 12.0
    h = torch.full((5, 1, 1), H, device=device)
    prof = _np(surfband_stokes_profile(h, (us0,), (k,)))[:, 0, 0]
    tops = np.arange(5) * H
    exact = us0 * (np.exp(-2 * k * tops) - np.exp(-2 * k * (tops + H))) \
        / (2 * k * H)
    np.testing.assert_allclose(prof, exact, rtol=1e-5)
    err = float(np.abs(prof / exact - 1.0).max())
    return dict(quantity="max relative error of the layer means",
                measured=err, analytic=0.0, error=err, gate="rtol 1e-5")


def waves_sl_average_partial_cell(device):
    """The surface-layer mean weights a partial layer by its part and
    divides by the column below the column's depth
    (test_coupler_waves.py::test_sl_average_partial_cell)."""
    from mom6_tpu_torch.physics.waves import sl_average_profile
    h = torch.tensor([10.0, 10.0, 10.0], device=device)[:, None, None]
    prof = torch.tensor([1.0, 0.5, 0.0], device=device)[:, None, None]
    avg = _np(sl_average_profile(prof, h,
                                 torch.tensor([[15.0]], device=device)))
    np.testing.assert_allclose(avg, (10 * 1.0 + 5 * 0.5) / 15.0, rtol=1e-6)
    avg2 = _np(sl_average_profile(prof, h,
                                  torch.tensor([[100.0]], device=device)))
    np.testing.assert_allclose(avg2, (10 + 5) / 30.0, rtol=1e-6)
    return dict(quantity="mean over 15 m", measured=float(avg.item()),
                analytic=12.5 / 15.0, error=float(avg.item()) - 12.5 / 15.0,
                gate="rtol 1e-6")


def waves_misalignment_increases_la(device):
    """Aligned waves and shear leave La as it is; crosswise waves raise
    it more than threefold (test_coupler_waves.py::
    test_misalignment_increases_la)."""
    from mom6_tpu_torch.physics.waves import langmuir_number
    nz = 4
    h = torch.full((nz, 2, 2), 10.0, device=device)
    shear_u = torch.zeros((nz, 2, 2), device=device)
    shear_u[0] = 0.2
    v0 = torch.zeros((nz, 2, 2), device=device)
    ust = torch.full((2, 2), 0.01, device=device)
    hbl = torch.full((2, 2), 40.0, device=device)
    base = WaveParams(method="SURFBANDS", band_stokes_x=(0.1,),
                      band_stokes_y=(0.0,), band_wavenumbers=(0.05,))
    la_al = langmuir_number(ust, hbl, dataclasses.replace(
        base, misalignment=True), h=h, u=shear_u, v=v0)
    la_plain = langmuir_number(ust, hbl, base, h=h, u=shear_u, v=v0)
    np.testing.assert_allclose(_np(la_al), _np(la_plain), rtol=1e-5)
    cross = dataclasses.replace(base, misalignment=True,
                                band_stokes_x=(0.0,), band_stokes_y=(0.1,))
    la_cross = langmuir_number(ust, hbl, cross, h=h, u=shear_u, v=v0)
    ratio = float((la_cross / la_plain).min())
    assert ratio > 3.0, ratio
    return dict(quantity="La crosswise / aligned", measured=ratio,
                analytic=3.0, error=ratio - 3.0, gate="> 3")


def _bgc_setup(device, nz=8, sw=200.0):
    """tests/test_bgc.py::_setup: 4x4 columns of nz layers over 400 m."""
    from mom6_tpu_torch.tracers.bgc import NPZD
    G = build_cartesian_grid(4, 4, 100.0, 100.0, max_depth=400.0,
                             device=device)
    GV = build_layered_vgrid(nz, device=device)
    h = torch.full((nz, 4, 4), 400.0 / nz, device=device)
    pkg = NPZD()
    fields = pkg.init_fields(h.shape, torch.float32, h.device)
    f = Forcing(buoy=BuoyancyForcing(sw_flux=torch.full(
        (4, 4), sw, device=device)))
    return G, GV, h, pkg, fields, f


def _total_n(fields, h):
    return float(sum((_np(fields[k]) * _np(h)).sum()
                     for k in ("no3", "phy", "zoo", "det")))


def bgc_nitrogen_conserved(device):
    """50 hourly NPZD steps conserve total nitrogen to 1e-5 and keep the
    pools non-negative (test_bgc.py::test_nitrogen_exactly_conserved)."""
    G, GV, h, pkg, fields, f = _bgc_setup(device)
    n0 = _total_n(fields, h)
    with torch.inference_mode():
        for _ in range(50):
            fields = pkg.column_physics(fields, h, 3600.0, G, GV,
                                        T=torch.full_like(h, 12.0),
                                        forcing=f)
    err = abs(_total_n(fields, h) - n0) / n0
    assert err < 1e-5, err
    for k in ("no3", "phy", "zoo", "det"):
        a = _np(fields[k])
        assert (a >= 0.0).all() and np.isfinite(a).all(), k
    return dict(quantity="relative change of total N", measured=err,
                analytic=0.0, error=err, gate="< 1e-5")


def bgc_bloom_needs_light(device):
    """200 hours lit: the surface blooms past 5x and draws nitrate down,
    deeper growth is weaker; in the dark phytoplankton only decays
    (test_bgc.py::test_bloom_requires_light_and_draws_down_nutrient)."""
    G, GV, h, pkg, fields, f = _bgc_setup(device, sw=250.0)
    _, _, _, _, dark, f_dark = _bgc_setup(device, sw=0.0)
    T = torch.full_like(h, 15.0)
    with torch.inference_mode():
        for _ in range(200):
            fields = pkg.column_physics(fields, h, 3600.0, G, GV, T=T,
                                        forcing=f)
            dark = pkg.column_physics(dark, h, 3600.0, G, GV, T=T,
                                      forcing=f_dark)
    bloom = float(fields["phy"][0, 1, 1])
    assert bloom > 5 * pkg.phy_0
    assert float(fields["no3"][0, 1, 1]) < pkg.no3_0
    assert float(dark["phy"][0, 1, 1]) <= pkg.phy_0
    assert float(fields["phy"][-1, 1, 1]) < bloom
    return dict(quantity="surface phytoplankton / initial",
                measured=bloom / pkg.phy_0, analytic=5.0,
                error=bloom / pkg.phy_0 - 5.0, gate="> 5")


def bgc_detritus_sinks(device):
    """Detritus at the surface sinks conservatively, the source layer
    decaying as (1 - dt w / h)^n (test_bgc.py::
    test_detritus_sinks_conservatively)."""
    from mom6_tpu_torch.tracers.bgc import NPZD
    G, GV, h, pkg, fields, f = _bgc_setup(device, sw=0.0)
    det = torch.zeros_like(h)
    det[0] = 1.0
    z = torch.zeros_like(h)
    fields = {**fields, "no3": z, "phy": z, "zoo": z, "det": det}
    pkg_nr = NPZD(remin0=0.0)
    n0 = _total_n(fields, h)
    with torch.inference_mode():
        for _ in range(100):
            fields = pkg_nr.column_physics(fields, h, 3600.0, G, GV,
                                           forcing=f)
    assert abs(_total_n(fields, h) - n0) / n0 < 1e-5
    d = _np(fields["det"])
    want = (1.0 - 3600.0 * pkg_nr.w_sink / 50.0) ** 100
    np.testing.assert_allclose(d[0, 1, 1], want, rtol=1e-3)
    assert d[1:, 1, 1].sum() > 0.5
    return dict(quantity="surface detritus left", measured=float(d[0, 1, 1]),
                analytic=want, error=float(d[0, 1, 1]) - want,
                gate="rtol 1e-3")


def bgc_nitrogen_deposition(device):
    """The coupler's ndep adds ndep dt n per unit area, to 1e-3
    (test_bgc.py::test_nitrogen_deposition_from_coupler)."""
    G, GV, h, pkg, fields, _ = _bgc_setup(device, sw=0.0)
    ndep = 1e-5
    f = Forcing(buoy=BuoyancyForcing(),
                tr_fluxes={"ndep": torch.full((4, 4), ndep, device=device)})
    n0 = _total_n(fields, h)
    with torch.inference_mode():
        for _ in range(20):
            fields = pkg.column_physics(fields, h, 3600.0, G, GV, forcing=f)
    gained = _total_n(fields, h) - n0
    want = ndep * 3600.0 * 20 * 16
    np.testing.assert_allclose(gained, want, rtol=1e-3)
    return dict(quantity="nitrogen gained [mmol m-2 x cells]",
                measured=gained, analytic=want, error=gained - want,
                gate="rtol 1e-3")


def bgc_config_and_cap(device):
    """USE_generic_tracer builds the NPZD registry; Faxa_ndep imported
    through the NUOPC cap raises the nitrate, every pool finite and
    non-negative after 4 intervals (test_bgc.py::
    test_config_and_cap_integration)."""
    text = CAP_BASE.replace("NIGLOBAL = 12\nNJGLOBAL = 10",
                            "NIGLOBAL = 10\nNJGLOBAL = 8") \
        + "USE_generic_tracer = True\n"
    from mom6_tpu_torch.drivers.nuopc import NUOPCCap
    cap = NUOPCCap(_cap_dir(text), device=device)
    cap.advertise()
    cap.realize(stop_days=1.0)
    assert {"no3", "phy", "zoo", "det"} <= set(cap.model.state.tr)
    no3_0 = float(cap.model.state.tr["no3"].double().sum())
    one = torch.ones_like(cap.model.grid.mask2dT)
    imports = {"Foxx_swnet_vdr": 200.0 * one, "Faxa_ndep": 1e-4 * one}
    for _ in range(4):
        cap.advance(imports)
    st = cap.model.state
    for k in ("no3", "phy", "zoo", "det"):
        a = _np(st.tr[k])
        assert np.isfinite(a).all() and (a >= -1e-6).all(), k
    no3 = float(st.tr["no3"].double().sum())
    assert no3 > no3_0
    return dict(quantity="nitrate sum after / before", measured=no3 / no3_0,
                analytic=1.0, error=no3 / no3_0 - 1.0, gate="> 1")


def dynamic_psurf_damps_under_rigid_ice(device):
    """The viscous pressure under rigid ice damps the external mode:
    a zero rigidity map equals the ice-free run to the bit, the filtered
    kinetic energy falls with the rigidity, under 10% of the ice-free
    at 1e11 m3 s-1, finite (test_barotropic_parity.py::
    test_dynamic_psurf_damps_under_rigid_ice)."""
    from mom6_tpu_torch.core.barotropic import btstep
    ny, nx, depth = 16, 16, 1000.0
    G = build_cartesian_grid(nx, ny, 100.0, 100.0, max_depth=depth,
                             f0=0.0, beta=0.0, device=device)
    GV = build_layered_vgrid(2, device=device)
    h = torch.full((2, ny, nx), depth / 2, device=device)
    x = np.arange(nx) - nx / 2.0
    y = np.arange(ny)[:, None] - ny / 2.0
    eta0 = torch.tensor(0.5 * np.exp(-(x ** 2 + y ** 2) / 8.0),
                        dtype=torch.float32, device=device)
    z3 = torch.zeros_like(h)
    args = dict(u_in=z3, v_in=z3, eta_in=eta0, bc_accel_u=z3,
                bc_accel_v=z3, h=h, uh_in=z3, vh_in=z3,
                visc_rem_u=torch.ones_like(h), visc_rem_v=torch.ones_like(h),
                pbce=torch.full_like(h, GV.g_earth),
                eta_PF=torch.zeros_like(eta0), dt=1800.0, G=G, GV=GV,
                params=BTParams(nstep=150, nfilter=30, bebt=0.2,
                                dynamic_psurf=True))
    with torch.inference_mode():
        out = {k: btstep(rigidity_ice=r, **args) for k, r in (
            ("free", None), ("zero", torch.zeros_like(eta0)),
            ("soft", torch.full_like(eta0, 1.0e9)),
            ("ice", torch.full_like(eta0, 1.0e11)))}
    assert torch.equal(out["zero"].eta_out, out["free"].eta_out)
    assert bool(torch.isfinite(out["ice"].eta_out).all())
    ke = {k: float((o.ubt_av.double() ** 2 + o.vbt_av.double() ** 2).sum())
          for k, o in out.items()}
    assert ke["ice"] < ke["soft"] < ke["free"]
    assert ke["ice"] < 0.1 * ke["free"]
    return dict(quantity="filtered KE under rigid ice / ice-free",
                measured=ke["ice"] / ke["free"], analytic=0.0,
                error=ke["ice"] / ke["free"], gate="< 0.1, monotone")


def _brine_run(device, do_plume):
    """tests/test_aux_physics.py::TestBrinePlume._run: 10 layers of 50 m,
    2e-4 ppt m s-1 of brine, a 200 m mixed layer, one 1800 s step."""
    from mom6_tpu_torch.physics.vertical.diabatic import diabatic_ale
    nz, ny, nx = 10, 4, 4
    G = build_cartesian_grid(nx, ny, 100.0, 100.0, max_depth=500.0,
                             device=device)
    GV = build_layered_vgrid(nz, device=device)
    h = torch.full((nz, ny, nx), 50.0, device=device)
    T = torch.full((nz, ny, nx), -1.0, device=device)
    S = torch.full((nz, ny, nx), 34.0, device=device)
    brine = torch.full((ny, nx), 2e-4, device=device)
    f = BuoyancyForcing(salt_flux=brine, salt_left_behind=brine)
    p = DiabaticParams(do_brine_plume=do_plume, brine_plume_n=5)
    mld = torch.full((ny, nx), 200.0, device=device)
    with torch.inference_mode():
        _, S2, _, _, _ = diabatic_ale(T, S, h, f, 1800.0, G, GV, p, mld=mld)
    return _np(h), _np(S), _np(S2), 1800.0


def brine_plume_conserves_and_redistributes(device):
    """With and without the plume the column gains brine dt of salt; the
    plume takes it from the top layer to the lower mixed layer
    (test_aux_physics.py::TestBrinePlume::
    test_salt_conserved_and_redistributed)."""
    h, S0, S_top, dt = _brine_run(device, False)
    _, _, S_plume, _ = _brine_run(device, True)
    tot0 = (S0 * h).sum(axis=0)
    d_top = (S_top * h).sum(axis=0) - tot0
    d_plume = (S_plume * h).sum(axis=0) - tot0
    np.testing.assert_allclose(d_top, 2e-4 * dt, rtol=5e-3)
    np.testing.assert_allclose(d_plume, d_top, rtol=5e-3)
    assert S_plume[0, 2, 2] < S_top[0, 2, 2]
    assert S_plume[3, 2, 2] > S_top[3, 2, 2]
    got = float(d_plume[2, 2])
    return dict(quantity="column salt gain [ppt m]", measured=got,
                analytic=2e-4 * dt, error=got - 2e-4 * dt, gate="rtol 5e-3")


def brine_plume_profile_increases_in_ml(device):
    """The z^5 profile: the gain grows with depth through the mixed
    layer and almost none reaches below it (test_aux_physics.py::
    TestBrinePlume::test_profile_increases_with_depth_in_ml)."""
    _, S0, S_plume, _ = _brine_run(device, True)
    dS = (S_plume - S0)[:, 2, 2]
    assert dS[3] > dS[2] > dS[1]
    assert dS[3] > 30 * abs(dS[7])
    return dict(quantity="gain at 175 m / gain at 375 m",
                measured=float(dS[3] / max(abs(dS[7]), 1e-30)),
                analytic=30.0, error=float(dS[3] / max(abs(dS[7]), 1e-30))
                - 30.0, gate="> 30, increasing")


def opacity_sw_absorption_profile(device):
    """The two-band absorption heats every layer, less with depth, and
    the column takes the whole incident flux
    (test_aux_physics.py::TestOpacityGeothermal::
    test_sw_absorption_profile)."""
    from mom6_tpu_torch.physics.vertical.opacity import sw_heating
    GV = build_layered_vgrid(4, device=device)
    h = torch.full((6, 8, 8), 10.0, device=device)
    sw = torch.full((8, 8), 200.0, device=device)
    dT = _np(sw_heating(h, sw, GV))
    assert (dT >= 0).all()
    assert dT[0, 0, 0] > dT[1, 0, 0] > dT[2, 0, 0]
    total = (dT * 10.0).sum(0) * GV.rho0 * 3991.87
    np.testing.assert_allclose(total, 200.0, rtol=1e-3)
    return dict(quantity="absorbed [W m-2]", measured=float(total.mean()),
                analytic=200.0, error=float(total.mean()) - 200.0,
                gate="rtol 1e-3")


# --- the step's shared options (test_barotropic_parity.py,
# test_mom_thermo.py, test_rotation.py, test_bbl_lbd.py,
# test_wired_subsystems.py, test_aux_physics.py::TestConvection) ---------

def gl90_redistributes_momentum(device):
    """GL90's interface viscosity mixes a sheared column toward its mean,
    conserving it, and vanishes where f = 0
    (test_barotropic_parity.py::test_gl90_redistributes_momentum)."""
    from mom6_tpu_torch.physics.vertical.vert_friction import (
        gl90_coupling, vertvisc, vertvisc_coef)
    nz, ny, nx = 4, 4, 4
    h = torch.full((nz, ny, nx), 100.0, device=device)
    u = torch.tensor([0.4, 0.2, -0.1, -0.3], device=device)[:, None, None] \
        .expand(nz, ny, nx).contiguous()
    f2 = torch.full((ny, nx), 1e-4 ** 2, device=device)
    gp = torch.tensor([9.8, 0.01, 0.01, 0.01], device=device)
    a_gl = gl90_coupling(h, f2, gp, kappa_gl90=1000.0, hbbl_gl90=5.0)
    assert float(a_gl.max()) > 0.0
    with torch.inference_mode():
        u1 = vertvisc(u, h, vertvisc_coef(h, 0.0, a_gl90=a_gl), 3600.0)
    sh0 = float(((u[1:] - u[:-1]) ** 2).sum())
    sh1 = float(((u1[1:] - u1[:-1]) ** 2).sum())
    assert sh1 < sh0
    np.testing.assert_allclose(float(u1.mean()), float(u.mean()), rtol=1e-5)
    a0 = gl90_coupling(h, torch.zeros_like(f2), gp, kappa_gl90=1000.0)
    assert float(a0.abs().max()) == 0.0
    return dict(quantity="squared shear after an hour / before",
                measured=sh1 / sh0, analytic=1.0, error=sh1 / sh0 - 1.0,
                gate="< 1, mean kept to rtol 1e-5, 0 without rotation")


def diabatic_first_ordering(device):
    """DIABATIC_FIRST: both orderings of 6 cycles of a 12x12x6 KPP gyre
    are finite, conserve mass to 1e-5 and land within 0.2 degC of each
    other, not equal (test_mom_thermo.py::test_diabatic_first_ordering)."""
    outs = {}
    for first in (False, True):
        G, GV, state, params, forcing = thermo_gyre(
            12, 12, 6, dt=1800.0, n_dyn_per_thermo=2, device=device)
        params = params.replace(diabatic_first=first,
                                diabatic=dataclasses.replace(
                                    params.diabatic,
                                    boundary_layer_scheme="KPP"))
        s = state
        with torch.inference_mode():
            for _ in range(6):
                s = step_mom(s, forcing, G, GV, params)
        assert bool(torch.isfinite(s.h).all() and torch.isfinite(s.T).all())
        a = _np(G.areaT).astype(np.float64)
        m0 = (_np(state.h).astype(np.float64) * a).sum()
        m1 = (_np(s.h).astype(np.float64) * a).sum()
        np.testing.assert_allclose(m1, m0, rtol=1e-5)
        outs[first] = _np(s.T).astype(np.float64)
    np.testing.assert_allclose(outs[True], outs[False], atol=0.2)
    assert not np.array_equal(outs[True], outs[False])
    d = float(np.abs(outs[True] - outs[False]).max())
    return dict(quantity="max |T first - T after| [degC]", measured=d,
                analytic=0.0, error=d, gate="atol 0.2, not equal")


def _island_grid(device, dtype=torch.float32):
    """test_rotation.py's 20x14 basin with an island."""
    nx, ny = 20, 14
    depth = np.full((ny, nx), 2000.0)
    depth[4:7, 5:8] = 0.0
    return build_cartesian_grid(nx, ny, 1000.0, 700.0, depth=depth,
                                max_depth=2000.0, f0=1e-4, beta=0.0,
                                dtype=dtype, device=device)


def rotation_roundtrip_identities(device):
    """A quarter turn and back is the identity for scalars and C-grid
    vector pairs (test_rotation.py::test_roundtrip_identities)."""
    from mom6_tpu_torch.framework.array_transform import (
        rotate_scalar, rotate_uv, unrotate_scalar, unrotate_uv)
    rng = np.random.default_rng(0)
    a, u, v = (torch.tensor(rng.standard_normal((3, 6, 8)), device=device)
               for _ in range(3))
    assert torch.equal(unrotate_scalar(rotate_scalar(a)), a)
    ub, vb = unrotate_uv(*rotate_uv(u, v))
    assert torch.equal(ub, u) and torch.equal(vb, v)
    return dict(quantity="round trip error", measured=0.0, analytic=0.0,
                error=0.0, gate="exact")


def step_rotational_invariance(device):
    """One split step of a basin with an island and an irregular wind in
    the original and the quarter-turned frame agree once turned back: h
    to 2e-4 m, u and v to 1e-6 m s-1
    (test_rotation.py::test_step_rotational_invariance)."""
    from mom6_tpu_torch.drivers.experiments import double_gyre
    from mom6_tpu_torch.framework.array_transform import (
        rotate_grid, rotate_state, rotate_uv, unrotate_scalar, unrotate_uv)
    _, GV, state, params, _ = double_gyre(nx=20, ny=14, nz=2, dt=900.0,
                                          device=device)
    G = _island_grid(device)
    ny, nx = 14, 20
    rng = np.random.default_rng(1)
    h = 1000.0 + 5.0 * rng.standard_normal((2, ny, nx))
    m = G.mask2dT[None]
    state = state.replace(h=torch.tensor(h, dtype=torch.float32,
                                         device=device) * m
                          + (1 - m) * 1e-10)
    taux = torch.tensor(0.1 * rng.standard_normal((ny, nx)),
                        dtype=torch.float32, device=device) * G.mask2dCu
    tauy = torch.tensor(0.05 * rng.standard_normal((ny, nx)),
                        dtype=torch.float32, device=device) * G.mask2dCv
    with torch.inference_mode():
        out = step_dynamics_split_rk2(state, MechForcing(taux=taux,
                                                         tauy=tauy),
                                      G, GV, params)
        tx_r, ty_r = rotate_uv(taux, tauy)
        out_r = step_dynamics_split_rk2(
            rotate_state(state), MechForcing(taux=tx_r, tauy=ty_r),
            rotate_grid(G), GV, params.replace(x_first=False))
    h_back = unrotate_scalar(out_r.h)
    u_back, v_back = unrotate_uv(out_r.u, out_r.v)
    eh = float((h_back - out.h).abs().max())
    eu = float((u_back - out.u).abs().max())
    ev = float((v_back - out.v).abs().max())
    assert eh <= 2e-4 and eu <= 1e-6 and ev <= 1e-6, (eh, eu, ev)
    return dict(quantity="max |u back - u| [m s-1]", measured=eu,
                analytic=0.0, error=eu, gate="h 2e-4, u and v 1e-6",
                h_err=eh, v_err=ev)


def rotate_and_homogenize_forcing(device):
    """rotate_forcing turns the wind as a vector pair and the heat flux
    as a scalar; homogenize_forcing makes the heat flux its wet-area mean
    on every wet cell (test_rotation.py::
    test_rotate_and_homogenize_forcing)."""
    from mom6_tpu_torch.core.forcing_util import (homogenize_forcing,
                                                  rotate_forcing)
    from mom6_tpu_torch.framework.array_transform import (rotate_scalar,
                                                          rotate_uv)
    G = _island_grid(device)
    ny, nx = 14, 20
    rng = np.random.default_rng(0)
    taux, tauy, q = (torch.tensor(rng.normal(size=(ny, nx)),
                                  dtype=torch.float32, device=device)
                     for _ in range(3))
    f = Forcing(mech=MechForcing(taux=taux, tauy=tauy),
                buoy=BuoyancyForcing(heat_flux=q))
    fr = rotate_forcing(f)
    assert torch.equal(fr.mech.taux, rotate_uv(taux, tauy)[0])
    assert torch.equal(fr.buoy.heat_flux, rotate_scalar(q))
    hq = _np(homogenize_forcing(f, G).buoy.heat_flux)
    wet = _np(G.mask2dT) > 0
    assert np.ptp(hq[wet]) == 0.0
    w = _np(G.areaT) * _np(G.mask2dT)
    expect = float((_np(q).astype(np.float64) * w).sum() / w.sum())
    np.testing.assert_allclose(hq[wet][0], expect, rtol=1e-6)
    return dict(quantity="homogenized heat flux [W m-2]",
                measured=float(hq[wet][0]), analytic=expect,
                error=float(hq[wet][0]) - expect, gate="rtol 1e-6, uniform")


def _lbd_setup(device):
    """test_bbl_lbd.py's 10x6 grid with 8 layers of 50 m."""
    G = build_cartesian_grid(10, 6, 100.0, 60.0, max_depth=400.0, f0=1e-4,
                             device=device)
    return G, torch.full((8, 6, 10), 50.0, device=device)


def lbd_conserves_and_mixes_only_bl(device):
    """The boundary-layer diffusion of a tracer with a zonal gradient
    conserves it, smooths the boundary layer and leaves the deep layers
    as they were (test_bbl_lbd.py::test_lbd_conserves_and_mixes_only_bl)."""
    from mom6_tpu_torch.tracers.hor_bnd_diffusion import hor_bnd_diffusion
    G, h = _lbd_setup(device)
    bld = torch.full((6, 10), 150.0, device=device)
    x = torch.arange(10, dtype=torch.float32, device=device)[None, None, :]
    tr = (10.0 + x / 10).expand(8, 6, 10).contiguous()
    out = hor_bnd_diffusion(tr[None], h, bld, 500.0, 3600.0, G)
    q0 = float((tr * h * G.areaT).sum())
    q1 = float((out[0] * h * G.areaT).sum())
    assert abs(q1 - q0) / abs(q0) < 1e-6
    d0, d1 = _np(tr)[:, 3, :], _np(out[0])[:, 3, :]
    grad0 = np.abs(np.diff(d0[0])).mean()
    grad1 = np.abs(np.diff(d1[0])).mean()
    assert grad1 < grad0
    np.testing.assert_allclose(d1[5], d0[5], atol=1e-7)
    return dict(quantity="top layer's mean gradient after / before",
                measured=grad1 / grad0, analytic=1.0,
                error=grad1 / grad0 - 1.0,
                gate="< 1, conserved to 1e-6, deep layers kept")


def lbd_zero_kh_identity(device):
    """With a zero diffusivity the boundary-layer diffusion changes
    nothing (test_bbl_lbd.py::test_lbd_zero_kh_identity)."""
    from mom6_tpu_torch.tracers.hor_bnd_diffusion import hor_bnd_diffusion
    G, h = _lbd_setup(device)
    bld = torch.full((6, 10), 100.0, device=device)
    tr = torch.full((1, 8, 6, 10), 3.0, device=device)
    out = hor_bnd_diffusion(tr, h, bld, 0.0, 3600.0, G)
    err = float((out - tr).abs().max())
    np.testing.assert_allclose(_np(out), _np(tr))
    return dict(quantity="max change", measured=err, analytic=0.0,
                error=err, gate="allclose")


def regularize_layers_smooths_and_conserves(device):
    """A column whose first interface lies 120 m below its neighbours' is
    relaxed toward them, conserving volume, heat and salt, h > 0
    (test_bbl_lbd.py::test_regularize_layers_smooths_and_conserves)."""
    from mom6_tpu_torch.framework.arith import vcumsum
    from mom6_tpu_torch.physics.vertical.regularize_layers import \
        regularize_layers
    G, h0 = _lbd_setup(device)
    h = _np(h0).copy()
    h[0, 3, 5] += 120.0
    h[1, 3, 5] = np.maximum(h[1, 3, 5] - 120.0, 1.0)
    h = torch.tensor(h, device=device)
    z = vcumsum(h) - 0.5 * h
    T = 15.0 - 10.0 * z / 400.0
    S = torch.full_like(T, 35.0)
    h1, T1, S1 = regularize_layers(h, T, S, G)
    z0 = float(vcumsum(h)[0, 3, 5])
    z1 = float(vcumsum(h1)[0, 3, 5])
    assert z1 < z0
    np.testing.assert_allclose(_np(h1.sum(0)), _np(h.sum(0)), rtol=1e-6)
    q0, q1 = float((h * T).sum()), float((h1 * T1).sum())
    assert abs(q1 - q0) / abs(q0) < 1e-5
    assert bool((h1 > 0).all())
    return dict(quantity="first interface of the jagged column [m]",
                measured=z1, analytic=z0, error=z1 - z0,
                gate="< before, conserved")


def diapyc_energy_req_positive_and_scales(device):
    """The energy a diffusivity profile needs is positive and doubles
    with it (test_bbl_lbd.py::test_diapyc_energy_req_positive_and_scales)."""
    from mom6_tpu_torch.framework.arith import vcumsum
    from mom6_tpu_torch.physics.vertical.regularize_layers import \
        diapyc_energy_req
    G, h = _lbd_setup(device)
    GV = build_layered_vgrid(8, device=device)
    z = vcumsum(h) - 0.5 * h
    T = 15.0 - 10.0 * z / 400.0
    S = torch.full_like(T, 35.0)
    eos = get_eos("LINEAR")
    kd = torch.full((9, 6, 10), 1e-4, device=device)
    e1 = _np(diapyc_energy_req(h, T, S, kd, G, GV, eos))
    e2 = _np(diapyc_energy_req(h, T, S, 2 * kd, G, GV, eos))
    assert (e1 > 0).all()
    np.testing.assert_allclose(e2, 2 * e1, rtol=1e-5)
    r = float((e2 / e1).mean())
    return dict(quantity="energy with 2 Kd / with Kd", measured=r,
                analytic=2.0, error=r - 2.0, gate="rtol 1e-5, > 0")


def double_diffusion_wired(device):
    """DOUBLE_DIFFUSION on the 12x12x4 gyre: on warm salty water over cold
    fresh water the salt fingers give kd_S > kd_T, and two steps that use
    them stay finite (test_wired_subsystems.py::
    test_double_diffusion_wired)."""
    from mom6_tpu_torch.physics.vertical.convection import \
        double_diffusion_kd
    ms = build(device, text=WIRED_BASE + "DOUBLE_DIFFUSION = True\n"
               "WIND_CONFIG = \"zero\"\n")
    assert ms.params.diabatic.ddiff is not None
    shape = ms.state.T.shape
    tprof = torch.linspace(20.0, 5.0, shape[0], device=device)
    sprof = torch.linspace(37.0, 34.0, shape[0], device=device)
    st = ms.state.replace(T=tprof[:, None, None].expand(shape).contiguous(),
                          S=sprof[:, None, None].expand(shape).contiguous())
    ms = ms._replace(state=st)
    kd_t, kd_s = double_diffusion_kd(st.h, st.T, st.S, ms.grid, ms.vgrid,
                                     get_eos("WRIGHT"),
                                     ms.params.diabatic.ddiff)
    assert float(kd_s[1:-1].max()) > 0.0
    assert float(kd_s.max()) > float(kd_t.max())
    out = _cycles(ms, 2)
    assert bool(torch.isfinite(out.S).all())
    return dict(quantity="max kd_S [m2 s-1]", measured=float(kd_s.max()),
                analytic=float(kd_t.max()),
                error=float(kd_s.max() - kd_t.max()), gate="kd_S > kd_T")


def _unstable_profile(device):
    """TestConvection's 8x8 columns of 4 layers of 500 m, cold over
    warm."""
    G = build_cartesian_grid(8, 8, 100.0, 100.0, max_depth=2000.0,
                             device=device)
    h = torch.full((4, 8, 8), 500.0, device=device)
    T = torch.tensor([4.0, 6.0, 10.0, 12.0], device=device)[:, None, None] \
        .expand(4, 8, 8).contiguous()
    S = torch.full((4, 8, 8), 35.0, device=device)
    return G, build_layered_vgrid(4, device=device), get_eos("WRIGHT"), \
        h, T, S


def convective_kd_targets_unstable(device):
    """Every interior interface of an unstable column gets KD_CONV
    (test_aux_physics.py::TestConvection::
    test_convective_kd_targets_unstable)."""
    from mom6_tpu_torch.physics.vertical.convection import convective_kd
    G, GV, eos, h, T, S = _unstable_profile(device)
    kd = convective_kd(h, T, S, G, GV, eos)
    got = float(kd[1:4].min())
    assert got > 0.5
    return dict(quantity="min interior kd [m2 s-1]", measured=got,
                analytic=1.0, error=got - 1.0, gate="> 0.5")


def full_convection_stabilizes(device):
    """Full convection mixes the unstable column to its mean, 8 degC,
    within 0.1 and conserves its heat
    (test_aux_physics.py::TestConvection::test_full_convection_stabilizes)."""
    from mom6_tpu_torch.physics.vertical.convection import full_convection
    G, GV, eos, h, T, S = _unstable_profile(device)
    T2, _ = full_convection(h, T, S, GV, eos)
    t = _np(T2)[:, 0, 0]
    assert np.all(np.abs(t - 8.0) < 0.1)
    np.testing.assert_allclose((_np(T2) * _np(h)).sum(0),
                               (_np(T) * _np(h)).sum(0), rtol=1e-5)
    err = float(np.abs(t - 8.0).max())
    return dict(quantity="max |T - 8| [degC]", measured=err, analytic=0.0,
                error=err, gate="< 0.1, heat kept to 1e-5")


def double_diffusion_regimes(device):
    """Warm salty water over cold fresh water: salt fingers, kd_S >= kd_T
    > 0 (test_aux_physics.py::TestConvection::
    test_double_diffusion_regimes)."""
    from mom6_tpu_torch.physics.vertical.convection import \
        double_diffusion_kd
    G = build_cartesian_grid(8, 8, 100.0, 100.0, max_depth=2000.0,
                             device=device)
    GV = build_layered_vgrid(4, device=device)
    h = torch.full((3, 8, 8), 100.0, device=device)
    T = torch.tensor([20.0, 15.0, 10.0], device=device)[:, None, None] \
        .expand(3, 8, 8).contiguous()
    S = torch.tensor([36.5, 35.5, 34.5], device=device)[:, None, None] \
        .expand(3, 8, 8).contiguous()
    kd_t, kd_s = double_diffusion_kd(h, T, S, G, GV, get_eos("WRIGHT"))
    ks, kt = float(kd_s[1:3].max()), float(kd_t[1:3].max())
    assert ks > 0.0 and ks >= kt
    return dict(quantity="max kd_S [m2 s-1]", measured=ks, analytic=kt,
                error=ks - kt, gate="> 0, >= kd_T")

# --- the lateral options (test_wired_subsystems.py::TestDynamicsExtras,
# test_aux_physics.py, test_hor_visc.py, test_lateral_physics.py,
# test_barotropic_parity.py) -------------------------------------------------

# the lateral options of chip_smoke.py's [lateral] phase: MEKE with its
# backscatter and friction source, QG Leith, the flow-aligned anisotropic
# viscosity, ZB2020, the interface filter (a time scale of a year: its
# coefficient is L^2 / tau, ~100 m2 s-1 at half a degree; the default
# hour flattens the interfaces of a z* model within a cycle and spins the
# flow up to m/s, in the reference as in the port), the porous barriers
# and the blended Arakawa-Lamb Coriolis scheme
LATERAL_OVERRIDE = """USE_MEKE = True
MEKE_VISCOSITY_COEFF_KU = 0.1
MEKE_FRCOEFF = 1.0
LEITH_KH = True
USE_QG_LEITH_VISC = True
ANISOTROPIC_VISCOSITY = True
KH_ANISO = 2000.0
ANISOTROPIC_MODE = 2
USE_ZB2020 = True
APPLY_INTERFACE_FILTER = True
INTERFACE_FILTER_TIME_SCALE = 31536000.0
POROUS_BARRIER = True
CORIOLIS_SCHEME = ARAKAWA_LAMB_BLEND
"""


def porous_barrier_blocks_deep_flow(device):
    """The porous barriers change the deepest layer's transports of 2
    cycles of the 12x12x4 bowl
    (test_wired_subsystems.py::TestDynamicsExtras::
    test_porous_barrier_blocks_deep_flow)."""
    ms = build(device, text=WIRED_BASE + "POROUS_BARRIER = True\n")
    assert ms.params.porous is not None
    out_p = _cycles(ms, 2)
    out_o = _cycles(build(device, text=WIRED_BASE), 2)
    a, b = _np(out_p.uh[-1]), _np(out_o.uh[-1])
    assert not np.allclose(a, b)
    d = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return dict(quantity="max |uh deepest, porous - open| / max |open|",
                measured=d, analytic=0.0, error=d, gate="not allclose")


def zanna_bolton_changes_momentum(device):
    """ZB2020 (ZB_SCALING 1) changes u of one cycle of the 12x12x4 bowl
    seeded with eddies by more than 1e-4 of max |u|, finite
    (test_wired_subsystems.py::TestDynamicsExtras::
    test_zanna_bolton_changes_momentum; the draws as the test makes
    them)."""
    rng = np.random.default_rng(3)

    def seeded(ms):
        G = ms.grid
        u = torch.tensor(0.3 * rng.standard_normal(tuple(ms.state.u.shape)),
                         dtype=torch.float32, device=device) * G.mask2dCu
        rng2 = np.random.default_rng(4)
        v = torch.tensor(0.3 * rng2.standard_normal(tuple(ms.state.v.shape)),
                         dtype=torch.float32, device=device) * G.mask2dCv
        return ms._replace(state=ms.state.replace(u=u, v=v))
    ms = seeded(build(device, text=WIRED_BASE
                      + "USE_ZB2020 = True\nZB_SCALING = 1.0\n"))
    assert ms.params.zb is not None
    out_z = _cycles(ms, 1)
    out_o = _cycles(seeded(build(device, text=WIRED_BASE)), 1)
    rel = float(np.abs(_np(out_z.u - out_o.u)).max()
                / max(np.abs(_np(out_o.u)).max(), 1e-12))
    assert rel > 1e-4
    assert bool(torch.isfinite(out_z.u).all())
    return dict(quantity="max |u ZB - u| / max |u|", measured=rel,
                analytic=0.0, error=rel, gate="> 1e-4, finite")


def interface_filter_conserves_and_smooths(device):
    """The interface filter (30 min) conserves the volume of 2 cycles of
    the 12x12x4 bowl with a checkerboard on its top interface to 1e-5
    and damps the checkerboard more than the run without it
    (test_wired_subsystems.py::TestDynamicsExtras::
    test_interface_filter_conserves_and_smooths)."""
    ms = build(device, text=WIRED_BASE + "APPLY_INTERFACE_FILTER = True\n"
               "INTERFACE_FILTER_TIME_SCALE = 1800.0\n")
    assert ms.params.interface_filter is not None
    noise = 20.0 * (-1.0) ** np.add.outer(np.arange(12), np.arange(12))
    h = _np(ms.state.h).astype(np.float32)
    h[0] += noise
    h[1] -= noise
    h = torch.tensor(np.maximum(h, 1e-3), device=device)
    out = _cycles(ms._replace(state=ms.state.replace(h=h)), 2)
    area = ms.grid.areaT.double()
    v0 = float((h.double() * area).sum())
    v1 = float((out.h.double() * area).sum())
    assert abs(v1 - v0) / v0 < 1e-5
    ms_o = build(device, text=WIRED_BASE)
    out_o = _cycles(ms_o._replace(state=ms_o.state.replace(h=h)), 2)

    def cb_amp(hh):
        e = _np(hh[0])[4:-4, 4:-4]
        return float(np.abs(np.diff(e, axis=-1)).mean())
    a, b = cb_amp(out.h), cb_amp(out_o.h)
    assert a < b
    return dict(quantity="checkerboard amplitude, filtered / unfiltered",
                measured=a / b, analytic=1.0, error=a / b - 1.0,
                gate="< 1, volume to 1e-5")


def _lateral_grid(device, km, nz=4, f0=0.0):
    """A 16x16 doubly periodic grid of ``km`` km, 1000 m deep at 100 km and
    2000 m otherwise (tests/test_hor_visc.py's, test_aux_physics.py's and
    test_lateral_physics.py's setup)."""
    G = build_cartesian_grid(16, 16, km, km,
                             max_depth=1000.0 if km == 100.0 else 2000.0,
                             cyclic_x=True, reentrant_y=True, f0=f0,
                             dtype=torch.float32, device=device)
    return G, build_layered_vgrid(nz, device=device)


def interface_filter_smooths_interfaces(device):
    """One filter step of 600 s lowers the variance of a bumped layer and
    keeps every column's thickness to 1e-3 m
    (test_aux_physics.py::TestInterfaceFilter::test_smooths_and_conserves)."""
    from mom6_tpu_torch.physics.lateral.interface_filter import (
        InterfaceFilterParams, interface_filter)
    G, GV = _lateral_grid(device, 400.0)
    h = np.full((4, 16, 16), 500.0)
    bump = 100.0 * np.exp(-((np.arange(16) - 8) ** 2)[None, :] / 6.0
                          - ((np.arange(16) - 8) ** 2)[:, None] / 6.0)
    h[1] -= bump
    h[2] += bump
    h = torch.tensor(h, dtype=torch.float32, device=device)
    with torch.inference_mode():
        h2, _, _ = interface_filter(h, G, GV, 600.0,
                                    InterfaceFilterParams(time_scale=3600.0))
    v0 = float(torch.var(h[1], unbiased=False))
    v1 = float(torch.var(h2[1], unbiased=False))
    assert v1 < v0
    col = float((h2 - h).sum(0).abs().max())
    assert col < 1e-3
    return dict(quantity="variance of layer 1 after / before",
                measured=v1 / v0, analytic=1.0, error=v1 / v0 - 1.0,
                gate="< 1, columns to 1e-3 m")


def porous_fractions(device):
    """A sill between 1000 and 1500 m on the u faces of column 8: the
    layers above it open, the one across it partly, the one below it
    closed, the v faces open
    (test_aux_physics.py::TestPorous::test_fractions)."""
    from mom6_tpu_torch.core.porous_barriers import (PorousBarrier,
                                                     porous_face_areas)
    G, _ = _lateral_grid(device, 400.0)
    deep = torch.full((16, 16), 1e6, device=device)
    dmin, dmax = deep.clone(), deep.clone()
    dmin[:, 8] = 1000.0
    dmax[:, 8] = 1500.0
    pb = PorousBarrier(d_min_u=dmin, d_max_u=dmax, d_min_v=deep,
                       d_max_v=deep)
    h = torch.full((4, 16, 16), 500.0, device=device)
    por_u, por_v = porous_face_areas(h, G, pb)
    p = _np(por_u)[:, 4, 8]
    assert p[0] > 0.99 and p[1] > 0.99
    assert 0.1 < p[2] < 0.9
    assert p[3] < 0.01
    assert np.allclose(_np(por_v)[:, :, 4], 1.0)
    return dict(quantity="open fraction of the layer across the sill",
                measured=float(p[2]), analytic=0.5,
                error=float(p[2]) - 0.5, gate="in (0.1, 0.9)")


def _rand_uvh(G, device, seed, nz=2):
    """tests/test_hor_visc.py's rand_state."""
    rng = np.random.default_rng(seed)
    shape = (nz, G.ny, G.nx)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    u = t(0.1 * rng.standard_normal(shape))
    v = t(0.1 * rng.standard_normal(shape))
    h = t(100.0 + 5 * rng.standard_normal(shape))
    return u, v, h


def leith_dissipates_and_scales(device):
    """Leith's viscosity does negative work, and doubling the flow
    multiplies the friction by 3.9 to 16 (cubic where unbounded)
    (test_hor_visc.py::
    test_leith_dissipates_and_scales_with_vorticity_gradient)."""
    from mom6_tpu_torch.physics.lateral.hor_visc import (
        HorViscParams, horizontal_viscosity)
    G, _ = _lateral_grid(device, 100.0)
    u, v, h = _rand_uvh(G, device, 7)
    p = HorViscParams(leith_lap_const=1.0, dt=1000.0)
    with torch.inference_mode():
        du, dv = horizontal_viscosity(u, v, h, G, p)
        du2, _ = horizontal_viscosity(2 * u, 2 * v, h, G, p)
    h_u = 0.5 * (h + torch.roll(h, -1, -1))
    h_v = 0.5 * (h + torch.roll(h, -1, -2))
    work = float(_np(u * du * h_u).sum() + _np(v * dv * h_v).sum())
    assert work < 0.0
    r = float(du2.abs().max()) / max(float(du.abs().max()), 1e-30)
    assert 3.9 <= r < 16.0
    return dict(quantity="friction ratio when the flow doubles",
                measured=r, analytic=8.0, error=r - 8.0,
                gate="in [3.9, 16), work < 0")


def anisotropic_viscosity_prefers_direction(device):
    """KH_ANISO along x damps a tension flow and is blind to a shear flow
    (|work| < 5% of the tension's)
    (test_hor_visc.py::test_anisotropic_viscosity_prefers_direction)."""
    from mom6_tpu_torch.physics.lateral.hor_visc import (
        HorViscParams, horizontal_viscosity)
    ny = nx = 16
    G = build_cartesian_grid(nx=nx, ny=ny, len_lon_km=400.0,
                             len_lat_km=400.0, max_depth=1000.0,
                             cyclic_x=True, reentrant_y=True, device=device)
    h = torch.full((1, ny, nx), 1000.0, device=device)
    x = torch.arange(nx, dtype=torch.float32, device=device)
    y = torch.arange(ny, dtype=torch.float32, device=device)[:, None]
    u_t = torch.sin(2 * np.pi * x / nx).expand(1, ny, nx) * G.mask2dCu
    u_s = torch.sin(2 * np.pi * y / ny).expand(1, ny, nx) * G.mask2dCu
    z = torch.zeros_like(u_t)
    p = HorViscParams(kh=0.0, kh_aniso=300.0, aniso_mode=0,
                      aniso_n=(1.0, 0.0), dt=0.0)

    def dissipation(u, v):
        with torch.inference_mode():
            du, dv = horizontal_viscosity(u, v, h, G, p)
        return float((u * du).sum() + (v * dv).sum())
    d_t, d_s = dissipation(u_t, z), dissipation(u_s, z)
    assert d_t < 0.0
    assert abs(d_s) < 0.05 * abs(d_t)
    return dict(quantity="|shear work| / |tension work|",
                measured=abs(d_s) / abs(d_t), analytic=0.0,
                error=abs(d_s) / abs(d_t), gate="< 0.05, tension work < 0")


def qg_leith_bounded_by_relative_gradient(device):
    """QG Leith's coefficient never passes Leith's
    (test_hor_visc.py::test_qg_leith_bounded_by_relative_gradient)."""
    from mom6_tpu_torch.physics.lateral.hor_visc import (
        HorViscParams, _coefficients, _strains)
    rng = np.random.default_rng(9)
    G = build_cartesian_grid(nx=16, ny=16, len_lon_km=400.0,
                             len_lat_km=400.0, max_depth=1000.0, f0=1e-4,
                             beta=2e-11, device=device)
    u = torch.tensor(rng.normal(0, 0.1, (1, 16, 16)), dtype=torch.float32,
                     device=device)
    v = torch.tensor(rng.normal(0, 0.1, (1, 16, 16)), dtype=torch.float32,
                     device=device)
    sh_xx, sh_xy = _strains(u, v, G)
    kh_l, _ = _coefficients(u, v, sh_xx, sh_xy, G,
                            HorViscParams(leith_lap_const=1.0))
    kh_qg, _ = _coefficients(u, v, sh_xx, sh_xy, G,
                             HorViscParams(leith_lap_const=1.0,
                                           use_qg_leith=True))
    excess = float((kh_qg - kh_l).max())
    assert excess <= 1e-6
    return dict(quantity="max (Kh QG - Kh Leith) [m2 s-1]", measured=excess,
                analytic=0.0, error=excess, gate="<= 1e-6")


def zb_rest_state_zero(device):
    """ZB2020 of a flow at rest is exactly 0
    (test_lateral_physics.py::TestZannaBolton::test_rest_state_zero)."""
    from mom6_tpu_torch.physics.lateral.zanna_bolton import \
        zanna_bolton_accel
    G, _ = _lateral_grid(device, 400.0, f0=1e-4)
    z = torch.zeros((2, 16, 16), device=device)
    h = torch.full((2, 16, 16), 500.0, device=device)
    du, _ = zanna_bolton_accel(z, z, h, G)
    m = float(du.abs().max())
    assert m == 0.0
    return dict(quantity="max |du| at rest", measured=m, analytic=0.0,
                error=m, gate="exactly 0")


def zb_momentum_conserved_and_quadratic(device):
    """ZB2020 is quadratic in the flow (rtol 1e-4) and conserves momentum
    on a flat periodic grid (1e-4 of the sum of |du|)
    (test_lateral_physics.py::TestZannaBolton::
    test_momentum_conserved_and_quadratic)."""
    from mom6_tpu_torch.physics.lateral.zanna_bolton import \
        zanna_bolton_accel
    G, _ = _lateral_grid(device, 400.0, f0=1e-4)
    rng = np.random.default_rng(0)
    u = torch.tensor(0.1 * rng.standard_normal((2, 16, 16)),
                     dtype=torch.float32, device=device)
    v = torch.tensor(0.1 * rng.standard_normal((2, 16, 16)),
                     dtype=torch.float32, device=device)
    h = torch.full((2, 16, 16), 500.0, device=device)
    du1, _ = zanna_bolton_accel(u, v, h, G)
    du2, _ = zanna_bolton_accel(2.0 * u, 2.0 * v, h, G)
    np.testing.assert_allclose(_np(du2), 4.0 * _np(du1), rtol=1e-4,
                               atol=1e-12)
    tot = abs(float(_np(du1).sum()))
    scale = float(np.abs(_np(du1)).sum()) + 1e-30
    assert tot < 1e-4 * scale
    return dict(quantity="|sum du| / sum |du|", measured=tot / scale,
                analytic=0.0, error=tot / scale, gate="< 1e-4, quadratic")


def meke_backscatter_injects_energy(device):
    """A backscatter viscosity above KH makes the friction's work on a
    random flow larger than without it
    (test_lateral_physics.py::test_meke_backscatter_injects_energy)."""
    from mom6_tpu_torch.physics.lateral.hor_visc import (
        HorViscParams, horizontal_viscosity)
    rng = np.random.default_rng(5)
    G = build_cartesian_grid(nx=16, ny=16, len_lon_km=800.0,
                             len_lat_km=800.0, max_depth=1000.0,
                             device=device)
    h = torch.full((2, 16, 16), 500.0, device=device)
    u = torch.tensor(rng.normal(0, 0.1, (2, 16, 16)), dtype=torch.float32,
                     device=device) * G.mask2dCu
    v = torch.tensor(rng.normal(0, 0.1, (2, 16, 16)), dtype=torch.float32,
                     device=device) * G.mask2dCv
    p = HorViscParams(kh=100.0, dt=600.0)
    ku = torch.full((16, 16), 500.0, device=device)
    with torch.inference_mode():
        du0, dv0 = horizontal_viscosity(u, v, h, G, p)
        du1, dv1 = horizontal_viscosity(u, v, h, G, p, ku_backscatter=ku)
    w0 = float((u * du0).sum() + (v * dv0).sum())
    w1 = float((u * du1).sum() + (v * dv1).sum())
    assert w0 < 0.0 and w1 > w0
    return dict(quantity="friction work with / without backscatter",
                measured=w1 / w0, analytic=1.0, error=w1 / w0 - 1.0,
                gate="w1 > w0, w0 < 0")


def arakawa_lamb_schemes(device):
    """The five Coriolis schemes on a random flow over uniform thickness:
    finite, the blend equal to AL81, AH90 and AL81 correlated with the
    Sadourny energy scheme above 0.99 in the interior, and the energy
    schemes' PV flux doing no work (1e-5 of its scale)
    (test_barotropic_parity.py::test_arakawa_lamb_schemes)."""
    from mom6_tpu_torch.core.coriolis_adv import coriolis_adv
    rng = np.random.default_rng(7)
    ny = nx = 12
    G = build_cartesian_grid(nx=nx, ny=ny, len_lon_km=1000.0,
                             len_lat_km=1000.0, max_depth=1000.0, f0=1e-4,
                             beta=0.0, device=device)
    GV = build_layered_vgrid(1, device=device)
    h = torch.full((1, ny, nx), 1000.0, device=device)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    u = t(rng.normal(0, 0.1, (1, ny, nx))) * G.mask2dCu
    v = t(rng.normal(0, 0.1, (1, ny, nx))) * G.mask2dCv
    uh = u * 1000.0 * G.dyCu
    vh = v * 1000.0 * G.dxCv
    outs = {}
    for sch in ("SADOURNY75_ENERGY", "ARAKAWA_HSU90", "ARAKAWA_LAMB81",
                "ARAKAWA_LAMB_BLEND", "SADOURNY75_ENSTRO"):
        cau, _ = coriolis_adv(u, v, h, uh, vh, G, GV, scheme=sch)
        assert bool(torch.isfinite(cau).all()), sch
        outs[sch] = _np(cau)
    np.testing.assert_allclose(outs["ARAKAWA_LAMB_BLEND"],
                               outs["ARAKAWA_LAMB81"], atol=1e-10)
    ref = outs["SADOURNY75_ENERGY"][0, 2:-2, 2:-2].ravel()
    ccs = []
    for sch in ("ARAKAWA_HSU90", "ARAKAWA_LAMB81"):
        cc = np.corrcoef(ref, outs[sch][0, 2:-2, 2:-2].ravel())[0, 1]
        assert cc > 0.99, (sch, cc)
        ccs.append(cc)
    z = torch.zeros_like(u)
    for sch in ("SADOURNY75_ENERGY", "ARAKAWA_LAMB81"):
        cau, cav = coriolis_adv(z, z, h, uh, vh, G, GV, scheme=sch)
        work = float((uh * cau * G.dxCu).sum() + (vh * cav * G.dyCv).sum())
        scale = float((uh * cau * G.dxCu).abs().sum()
                      + (vh * cav * G.dyCv).abs().sum())
        assert abs(work) < 1e-5 * scale, (sch, work, scale)
    return dict(quantity="least correlation with SADOURNY75_ENERGY",
                measured=min(ccs), analytic=1.0, error=min(ccs) - 1.0,
                gate="> 0.99, blend = AL81, no PV work")



# --- tides and the SAL, the Stanley correction with the equations of state,
# SPPT and SKEB (tests/test_wired_subsystems.py::TestTidesSAL,
# ::test_stanley_pgf_changes_solution and TestStochastics,
# test_aux_physics.py::TestTides, test_sal_harmonics.py,
# test_eos_extras.py::TestWrightFull, TestSecondDerivs and
# TestTemperatureConvert, test_ale.py::TestRoquet, TestUNESCO and
# TestStochEOS, test_diag_offline_stoch.py::TestStochastic) ----------------

# the options of chip_smoke.py's [stoch] phase on configs/global_half_deg
STOCH_OVERRIDE = """EQN_OF_STATE = WRIGHT_FULL
USE_STANLEY_PGF = True
SAL_SCALAR_VALUE = 0.094
SAL_HARMONICS = True
DO_SPPT = True
DO_SKEB = True
"""

# TestTidesSAL.SPH: a spherical 16x12x3 basin
TIDES_SPH = """
NIGLOBAL = 16
NJGLOBAL = 12
NK = 3
DT = 900.0
GRID_CONFIG = "spherical"
SOUTHLAT = -30.0
LENLAT = 60.0
LENLON = 90.0
WIND_CONFIG = "zero"
"""


def _ke(s):
    return float((s.u.double() ** 2).sum() + (s.v.double() ** 2).sum())


def equilibrium_tide_drives_flow(device):
    """TIDES on the spherical basin: after 3 steps the time is 3 dt, the
    tide has moved the water and u is finite
    (test_wired_subsystems.py::TestTidesSAL::
    test_equilibrium_tide_drives_flow)."""
    ms = build(device, text=TIDES_SPH + "TIDES = True\n")
    out = _cycles(ms, 3)
    assert float(out.time) == 3 * 900.0
    ke = _ke(out)
    assert ke > 0.0 and bool(torch.isfinite(out.u).all())
    return dict(quantity="sum u^2 + v^2 after 3 steps [m2 s-2]",
                measured=ke, analytic=0.0, error=ke,
                gate="> 0, time = 3 dt, u finite")


def scalar_sal_weakens_surface_gravity(device):
    """SAL_SCALAR_VALUE = 0.3 reaches the barotropic parameters and 2
    steps stay finite (::test_scalar_sal_weakens_surface_gravity)."""
    ms = build(device, text=TIDES_SPH + "TIDES = True\n"
               "SAL_SCALAR_VALUE = 0.3\n")
    assert abs(ms.params.dyn.bt.sal_scalar - 0.3) <= 0.3e-6
    out = _cycles(ms, 2)
    assert bool(torch.isfinite(out.h).all())
    return dict(quantity="BTParams.sal_scalar", measured=ms.params.dyn.bt
                .sal_scalar, analytic=0.3,
                error=ms.params.dyn.bt.sal_scalar - 0.3,
                gate="0.3 (rel 1e-6), h finite")


def harmonic_sal_runs(device):
    """SAL_HARMONICS builds the transform and a step stays finite
    (::test_harmonic_sal_runs)."""
    ms = build(device, text=TIDES_SPH + "TIDES = True\n"
               "SAL_HARMONICS = True\n")
    assert ms.params.sal_harmonics is not None
    out = _cycles(ms, 1)
    m = float(out.u.abs().max())
    assert bool(torch.isfinite(out.u).all())
    return dict(quantity="max |u| after a step [m/s]", measured=m,
                analytic=0.0, error=m, gate="finite")


def stanley_pgf_changes_solution(device):
    """The Stanley correction (STANLEY_COEFF = 20 under NS heating) changes
    u after 3 cycles (test_wired_subsystems.py::
    test_stanley_pgf_changes_solution)."""
    heat = 'BUOY_CONFIG = "NS_heating"\n'
    out_s = _cycles(build(device, text=WIRED_BASE + "USE_STANLEY_PGF = True\n"
                          "STANLEY_COEFF = 20.0\n" + heat), 3)
    out_o = _cycles(build(device, text=WIRED_BASE + heat), 3)
    d = float((out_s.u - out_o.u).abs().max())
    assert not np.allclose(_np(out_s.u), _np(out_o.u))
    return dict(quantity="max |u_stanley - u| [m/s]", measured=d,
                analytic=0.0, error=d, gate="not allclose")


def sppt_pattern_evolves_and_perturbs(device):
    """From a pattern of 0.5 SPPT's pattern moves in 2 cycles and T parts
    from the run without SPPT (TestStochastics::
    test_sppt_pattern_evolves_and_perturbs)."""
    heat = 'BUOY_CONFIG = "NS_heating"\nHEATING_MAGNITUDE = 200.0\n'
    ms = build(device, text=WIRED_BASE + "DO_SPPT = True\n" + heat)
    ms = ms._replace(state=ms.state.replace(sppt_pattern=torch.full(
        (12, 12), 0.5, device=device)))
    out = _cycles(ms, 2)
    moved = float((out.sppt_pattern - 0.5).abs().max())
    assert not np.allclose(_np(out.sppt_pattern), 0.5 * np.ones((12, 12)))
    out_o = _cycles(build(device, text=WIRED_BASE + heat), 2)
    assert not np.allclose(_np(out.T), _np(out_o.T))
    return dict(quantity="max |pattern - 0.5| after 2 cycles",
                measured=moved, analytic=0.0, error=moved,
                gate="pattern moved, T perturbed")


def skeb_is_nondivergent_kick(device):
    """SKEB_SCALE = 10 with a standard normal pattern puts energy into a
    resting, unforced basin in one cycle, finite
    (TestStochastics::test_skeb_is_nondivergent_kick)."""
    ms = build(device, text=WIRED_BASE + "DO_SKEB = True\nSKEB_SCALE = 10.0\n"
               'WIND_CONFIG = "zero"\n')
    pat = np.random.default_rng(0).standard_normal((12, 12))
    ms = ms._replace(state=ms.state.replace(skeb_pattern=torch.tensor(
        pat, dtype=torch.float32, device=device)))
    out = _cycles(ms, 1)
    ke = _ke(out)
    assert ke > 0.0 and bool(torch.isfinite(out.u).all())
    return dict(quantity="sum u^2 + v^2 after a cycle [m2 s-2]",
                measured=ke, analytic=0.0, error=ke, gate="> 0, finite")


def equilibrium_tide_oscillates(device):
    """M2's equilibrium tide at 30 N changes sign half a period later
    (atol 1e-6) with 0.05 < |e| < 0.2 m; the scalar SAL of 1 m is 0.094
    (test_aux_physics.py::TestTides::test_equilibrium_tide_oscillates)."""
    from mom6_tpu_torch.physics.lateral.tidal_forcing import (
        CONSTITUENTS, TidalForcingParams, equilibrium_tide, scalar_sal)
    lat = torch.tensor(np.deg2rad(30.0), dtype=torch.float32, device=device)
    lon = torch.zeros((), dtype=torch.float32, device=device)
    p = TidalForcingParams(names=("M2",))
    e0 = float(equilibrium_tide(0.0, lat, lon, p))
    half_t = np.pi / CONSTITUENTS["M2"].freq
    e1 = float(equilibrium_tide(half_t, lat, lon, p))
    assert abs(e1 + e0) <= 1e-6 and 0.05 < abs(e0) < 0.2
    sal = float(scalar_sal(torch.ones((), device=device)))
    assert abs(sal - 0.094) <= 0.094e-6
    return dict(quantity="e(T/2) + e(0) [m]", measured=e1 + e0, analytic=0.0,
                error=e1 + e0, gate="|.| <= 1e-6, 0.05 < |e(0)| < 0.2")


def _sal_sphere(device):
    """test_sal_harmonics.py's near-global 96x48 grid, cyclic in x."""
    return build_spherical_grid(96, 48, 0.0, -85.0, 360.0, 170.0,
                                cyclic_x=True, device=device)


def _ylm(G, n, m, part="cos"):
    from mom6_tpu_torch.physics.lateral.self_attr_load import _legendre_norm
    lat = _np(G.geoLatT)[:, 0] * np.pi / 180.0
    lon = _np(G.geoLonT)[0, :] * np.pi / 180.0
    P = _legendre_norm(n, np.sin(lat))[n, m]
    tr = np.cos(m * lon) if part == "cos" else np.sin(m * lon)
    return P[:, None] * tr[None, :]


def sal_eigenfunction_scaling(device):
    """Y_nm maps to beta_n Y_nm, beta_n = 3/(2n+1) rhoW/rhoE, within 2e-3
    of its scale, for (2, 0), (3, 2), (5, 5), (8, 3)
    (test_sal_harmonics.py::test_eigenfunction_scaling)."""
    from mom6_tpu_torch.physics.lateral.self_attr_load import (
        build_sal_harmonics, calc_sal_harmonic)
    G = _sal_sphere(device)
    sal = build_sal_harmonics(G, nmax=10)
    worst = 0.0
    for n, m in ((2, 0), (3, 2), (5, 5), (8, 3)):
        eta = torch.tensor(_ylm(G, n, m), dtype=torch.float32, device=device)
        out = _np(calc_sal_harmonic(eta, sal))
        want = 3.0 / (2.0 * n + 1.0) * 1035.0 / 5517.0 * _np(eta)
        err = np.abs(out - want).max() / np.abs(want).max()
        assert err < 2e-3, (n, m, err)
        worst = max(worst, err)
    return dict(quantity="max |SAL(Y_nm) - beta_n Y_nm| / scale",
                measured=worst, analytic=0.0, error=worst, gate="< 2e-3")


def sal_degrees_0_and_1_excluded(device):
    """Degrees 0 and 1 give no SAL (1e-3 of the input)
    (test_sal_harmonics.py::test_degrees_0_and_1_excluded)."""
    from mom6_tpu_torch.physics.lateral.self_attr_load import (
        build_sal_harmonics, calc_sal_harmonic)
    G = _sal_sphere(device)
    sal = build_sal_harmonics(G, nmax=6)
    worst = 0.0
    for n, m in ((0, 0), (1, 0), (1, 1)):
        eta = torch.tensor(_ylm(G, n, m), dtype=torch.float32, device=device)
        r = np.abs(_np(calc_sal_harmonic(eta, sal))).max() \
            / (np.abs(_np(eta)).max() + 1e-30)
        assert r < 1e-3, (n, m, r)
        worst = max(worst, r)
    return dict(quantity="max |SAL| / max |eta| for n <= 1", measured=worst,
                analytic=0.0, error=worst, gate="< 1e-3")


def sal_love_factors_scale_linearly(device):
    """A Love factor of 0.7 at degree 3 scales Y_31's SAL by 0.7 (atol
    0.02) (test_sal_harmonics.py::test_love_factors_scale_linearly)."""
    from mom6_tpu_torch.physics.lateral.self_attr_load import (
        build_sal_harmonics, calc_sal_harmonic)
    G = _sal_sphere(device)
    love = np.ones(7)
    love[3] = 0.7
    eta = torch.tensor(_ylm(G, 3, 1), dtype=torch.float32, device=device)
    o1 = _np(calc_sal_harmonic(eta, build_sal_harmonics(G, nmax=6)))
    o2 = _np(calc_sal_harmonic(eta, build_sal_harmonics(
        G, nmax=6, love_factors=love)))
    big = np.abs(o1) > 0.1 * np.abs(o1).max()
    ratio = o2[big] / o1[big]
    assert np.allclose(ratio, 0.7, atol=0.02)
    err = float(np.abs(ratio - 0.7).max())
    return dict(quantity="SAL ratio with the factor 0.7", measured=0.7 + err,
                analytic=0.7, error=err, gate="atol 0.02")


def sal_is_small_and_smooth(device):
    """The SAL of a random eta is below 15% of it and finite
    (test_sal_harmonics.py::test_sal_is_small_and_smooth)."""
    from mom6_tpu_torch.physics.lateral.self_attr_load import (
        build_sal_harmonics, calc_sal_harmonic)
    G = _sal_sphere(device)
    sal = build_sal_harmonics(G, nmax=12)
    eta = torch.tensor(np.random.RandomState(0).randn(48, 96),
                       dtype=torch.float32, device=device)
    out = _np(calc_sal_harmonic(eta, sal))
    r = np.abs(out).max() / np.abs(_np(eta)).max()
    assert r < 0.15 and np.isfinite(out).all()
    return dict(quantity="max |SAL| / max |eta|", measured=r, analytic=0.0,
                error=r, gate="< 0.15, finite")


def _scalar(x, device, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype, device=device)


def wright_full_fit(device):
    """WRIGHT_FULL differs from WRIGHT (= WRIGHT_RED) by 1e-4 to 0.1 kg
    m-3 at (10, 35, 2e7), its surface density lies in (1026, 1028), and
    its derivatives equal autodiff's within 1e-6
    (test_eos_extras.py::TestWrightFull)."""
    w, f, r = (get_eos(n) for n in ("WRIGHT", "WRIGHT_FULL", "WRIGHT_RED"))
    T, S, p = (_scalar(x, device) for x in (10.0, 35.0, 2e7))
    rw, rf, rr = (float(e.density(T, S, p)) for e in (w, f, r))
    assert rw == rr and 1e-4 < abs(rf - rw) < 0.1
    rho = float(f.density(T, S, _scalar(0.0, device)))
    assert 1026.0 < rho < 1028.0
    T, S, p = (_scalar(x, device) for x in (8.0, 34.0, 1e7))
    dT, dS = f.density_derivs(T, S, p)
    gT = torch.func.grad(lambda t: f.density(t, S, p))(T)
    gS = torch.func.grad(lambda s: f.density(T, s, p))(S)
    err = max(float(abs(dT - gT)), float(abs(dS - gS)))
    assert err < 1e-6
    return dict(quantity="|WRIGHT_FULL - WRIGHT| at (10, 35, 2e7) [kg m-3]",
                measured=abs(rf - rw), analytic=0.0, error=err,
                gate="in (1e-4, 0.1); surface in (1026, 1028); derivs 1e-6")


def eos_second_derivs_match_fd(device):
    """Each EOS's second derivatives against centred differences (eps
    1e-3) of its first, in float64 at (12, 34.5, 5e6): TT 1e-4, SS and ST
    1e-3 relative; LINEAR's are 0
    (test_eos_extras.py::TestSecondDerivs)."""
    f64 = torch.float64
    worst = 0.0
    for name in ("WRIGHT", "WRIGHT_FULL", "UNESCO", "ROQUET_RHO",
                 "JACKETT06", "TEOS10"):
        e = get_eos(name)
        T, S, p = (_scalar(x, device, f64) for x in (12.0, 34.5, 5e6))
        d2_SS, d2_ST, d2_TT, _, _ = e.density_second_derivs(T, S, p)
        eps = 1e-3
        fd_TT = (e.density_derivs(T + eps, S, p)[0]
                 - e.density_derivs(T - eps, S, p)[0]) / (2 * eps)
        fd_SS = (e.density_derivs(T, S + eps, p)[1]
                 - e.density_derivs(T, S - eps, p)[1]) / (2 * eps)
        fd_ST = (e.density_derivs(T, S + eps, p)[0]
                 - e.density_derivs(T, S - eps, p)[0]) / (2 * eps)
        for got, fd, rtol, floor in ((d2_TT, fd_TT, 1e-4, 1e-5),
                                     (d2_SS, fd_SS, 1e-3, 1e-6),
                                     (d2_ST, fd_ST, 1e-3, 1e-6)):
            scale = max(abs(float(fd)), floor)
            err = float(abs(got - fd)) / scale
            assert err < rtol, (name, err)
            worst = max(worst, err / rtol)
    lin = get_eos("LINEAR").density_second_derivs(
        _scalar(10.0, device), _scalar(35.0, device), _scalar(0.0, device))
    assert all(float(abs(v)) < 1e-12 for v in lin)
    return dict(quantity="largest error / its tolerance", measured=worst,
                analytic=0.0, error=worst, gate="< 1; LINEAR's 0")


def temperature_convert(device):
    """Potential -> conservative -> potential within 5e-5 degC; CT(10, 35)
    within 0.05 of 10 and CT(28.7856, 34.7118) 28.81 +- 0.02 (GSW's check
    row); SR(35) = 35.16504 and back
    (test_eos_extras.py::TestTemperatureConvert)."""
    from mom6_tpu_torch.eos.temperature_convert import (
        constemp_to_potemp, potemp_to_constemp, sp_from_sr, sr_from_sp)
    pt = torch.tensor([-1.5, 0.0, 10.0, 25.0, 32.0], device=device)
    sa = torch.tensor([34.0, 35.0, 35.0, 36.5, 30.0], device=device)
    back = constemp_to_potemp(potemp_to_constemp(pt, sa), sa)
    err = float((back - pt).abs().max())
    assert err <= 5e-5
    ct10 = float(potemp_to_constemp(_scalar(10.0, device),
                                    _scalar(35.0, device)))
    assert abs(ct10 - 10.0) < 0.05
    ct = float(potemp_to_constemp(_scalar(28.7856, device),
                                  _scalar(34.7118, device)))
    assert abs(ct - 28.81) <= 0.02
    s = float(sr_from_sp(_scalar(35.0, device)))
    assert abs(s - 35.16504) <= 1e-4
    assert abs(float(sp_from_sr(_scalar(s, device))) - 35.0) <= 1e-5
    return dict(quantity="round trip pt -> ct -> pt [degC]", measured=err,
                analytic=0.0, error=err, gate="<= 5e-5; GSW rows")


def roquet_rho_checks(device):
    """ROQUET_RHO: rho(10, 30, 1e7) = 1027.45140 +- 0.01 (the paper's
    check), the surface density sane, the derivatives equal centred
    differences (rtol 1e-6) with dT < 0 < dS, and within 0.5 kg m-3 of
    WRIGHT over the oceanographic range (test_ale.py::TestRoquet)."""
    f64 = torch.float64
    eos, w = get_eos("ROQUET_RHO"), get_eos("WRIGHT")

    def rho(e, T, S, p):
        return float(e.density(*(_scalar(x, device, f64) for x in (T, S, p))))
    r = rho(eos, 10.0, 30.0, 1.0e7)
    assert abs(r - 1027.45140) < 0.01
    assert 1026.0 < rho(eos, 10.0, 35.16504, 0.0) < 1028.5
    T, S, p = 8.0, 35.0, 2e7
    dT, dS = (float(d) for d in eos.density_derivs(
        *(_scalar(x, device, f64) for x in (T, S, p))))
    eps = 1e-5
    fd_T = (rho(eos, T + eps, S, p) - rho(eos, T - eps, S, p)) / (2 * eps)
    fd_S = (rho(eos, T, S + eps, p) - rho(eos, T, S - eps, p)) / (2 * eps)
    np.testing.assert_allclose(dT, fd_T, rtol=1e-6)
    np.testing.assert_allclose(dS, fd_S, rtol=1e-6)
    assert dT < 0 < dS
    for T, S, p in ((2.0, 34.7, 3e7), (15.0, 35.5, 0.0), (25.0, 36.0, 1e6)):
        assert abs(rho(w, T, S, p) - rho(eos, T, S, p)) < 0.5
    return dict(quantity="rho(10, 30, 1e7) [kg m-3]", measured=r,
                analytic=1027.45140, error=r - 1027.45140,
                gate="+- 0.01; derivs rtol 1e-6; WRIGHT within 0.5")


def unesco_checks(device):
    """UNESCO: Jackett & McDougall's check rho(3, 35.5, 3e7) = 1041.83267
    and the surface check rho(5, 0, 0) = 999.96675, each +- 0.01, and
    within 0.5 kg m-3 of WRIGHT (test_ale.py::TestUNESCO)."""
    f64 = torch.float64
    u, w = get_eos("UNESCO"), get_eos("WRIGHT")

    def rho(e, T, S, p):
        return float(e.density(*(_scalar(x, device, f64) for x in (T, S, p))))
    r = rho(u, 3.0, 35.5, 3.0e7)
    assert abs(r - 1041.83267) < 0.01
    assert abs(rho(u, 5.0, 0.0, 0.0) - 999.96675) < 0.01
    for T, S, p in ((2.0, 34.7, 3e7), (15.0, 35.5, 0.0)):
        assert abs(rho(u, T, S, p) - rho(w, T, S, p)) < 0.5
    return dict(quantity="rho(3, 35.5, 3e7) [kg m-3]", measured=r,
                analytic=1041.83267, error=r - 1041.83267,
                gate="+- 0.01; surface check; WRIGHT within 0.5")


def stanley_correction_sign_and_scale(device):
    """The subgrid variance of a sine in T is positive, its correction
    finite and under 0.1 kg m-3, and zero variance gives zero
    (test_ale.py::TestStochEOS::test_stanley_correction_sign_and_scale)."""
    from mom6_tpu_torch.eos.stoch_eos import (sgs_t_variance,
                                              stanley_density_correction)
    G = build_cartesian_grid(8, 8, 100.0, 100.0, max_depth=1000.0,
                             cyclic_x=True, reentrant_y=True, device=device)
    x = np.arange(8)
    T = torch.tensor(np.broadcast_to(
        10.0 + np.sin(2 * np.pi * x / 8)[None, None, :], (2, 8, 8)).copy(),
        dtype=torch.float32, device=device)
    s2 = sgs_t_variance(T, G)
    assert float(s2.max()) > 0.0
    eos = get_eos("WRIGHT")

    def full(v):
        return torch.full((2, 8, 8), v, device=device)
    c = _np(stanley_density_correction(full(10.0), full(35.0), full(0.0),
                                       eos, s2))
    assert np.isfinite(c).all() and np.abs(c).max() < 0.1
    z = _np(stanley_density_correction(full(10.0), full(35.0), full(0.0),
                                       eos, full(0.0)))
    assert np.abs(z).max() == 0.0
    m = float(np.abs(c).max())
    return dict(quantity="max |correction| [kg m-3]", measured=m,
                analytic=0.0, error=m, gate="finite, < 0.1, 0 at 0")


def ar1_pattern_statistics(device):
    """60 AR(1) steps of a 32x32 pattern: its std over the last 20 in
    (0.2, 0.9), and one more step correlated above 0.8
    (test_diag_offline_stoch.py::TestStochastic::
    test_ar1_pattern_statistics)."""
    from mom6_tpu_torch.framework.random import PRNGKey
    from mom6_tpu_torch.physics.stochastic import SPPTParams, ar1_pattern
    p = SPPTParams(amplitude=0.5, tau=3600.0, smooth_passes=2)
    key = PRNGKey(0, device=device)
    pat = torch.zeros((32, 32), device=device)
    stds = []
    for _ in range(60):
        pat, key = ar1_pattern(pat, key, 600.0, p)
        stds.append(float(torch.std(pat, correction=0)))
    mean = float(np.mean(stds[-20:]))
    assert 0.2 < mean < 0.9
    pat2, _ = ar1_pattern(pat, key, 600.0, p)
    corr = np.corrcoef(_np(pat).ravel(), _np(pat2).ravel())[0, 1]
    assert corr > 0.8
    return dict(quantity="equilibrium std of the pattern", measured=mean,
                analytic=0.5, error=mean - 0.5,
                gate="in (0.2, 0.9), lag-1 correlation > 0.8")


def sppt_perturbs_tendency(device):
    """A pattern of 0.5 scales a tendency by 1.5, one of 5 by 1 + the
    clip 0.8 (TestStochastic::test_sppt_perturbs_tendency)."""
    from mom6_tpu_torch.physics.stochastic import SPPTParams, apply_sppt
    tend = torch.ones((4, 8, 8), device=device)
    out = _np(apply_sppt(tend, torch.full((8, 8), 0.5, device=device),
                         SPPTParams()))
    np.testing.assert_allclose(out, 1.5)
    out2 = _np(apply_sppt(tend, torch.full((8, 8), 5.0, device=device),
                          SPPTParams(clip=0.8)))
    np.testing.assert_allclose(out2, 1.8)
    return dict(quantity="tendency x (1 + 0.5)", measured=float(out.max()),
                analytic=1.5, error=float(out.max()) - 1.5,
                gate="1.5; clipped 1.8")


def skeb_divergence_free(device):
    """The backscatter's increment of a random pattern has no divergence
    (1e-5 of its size) (TestStochastic::test_skeb_divergence_free)."""
    from mom6_tpu_torch.physics.stochastic import apply_skeb
    pat = torch.tensor(np.random.default_rng(1).standard_normal((16, 16)),
                       dtype=torch.float32, device=device)
    z = torch.zeros((2, 16, 16), device=device)
    u, v = apply_skeb(z, z, pat, 1.0)
    du, dv = _np(u)[0], _np(v)[0]
    div = (du - np.roll(du, 1, -1)) + (dv - np.roll(dv, 1, -2))
    r = np.abs(div).max() / max(np.abs(du).max(), 1e-9)
    assert r < 1e-5
    return dict(quantity="max |div| / max |du|", measured=r, analytic=0.0,
                error=r, gate="< 1e-5")


# name -> gate, in the order of the reference's test files

# --- HYBGEN with its unmixing, PPM_H6 and P3M_H4, TS_CONFIG = from_Z (its
# z-level remap and the horizontal regridding), and the SSA shelf
# dynamics with the ice-only driver (tests/test_regrid_hybrid.py::
# test_hybgen_*, test_ale.py::TestZInit, test_horiz_regrid.py,
# test_ssa.py) -------------------------------------------------------------

# World Ocean Atlas 2018's 102 standard depths [m]: every 5 m to 100, 25 m
# to 500, 50 m to 2000, 100 m to 5500
WOA_DEPTHS = np.concatenate([np.arange(0.0, 100.1, 5.0),
                             np.arange(125.0, 500.1, 25.0),
                             np.arange(550.0, 2000.1, 50.0),
                             np.arange(2100.0, 5500.1, 100.0)])
# WOA's missing value (_FillValue)
WOA_MISSING = 9.96921e36
# HYCOM's minimum layer thicknesses of its global runs (blkdat.input's
# dp00 = 3 m, dp00f = 1.18, dp00x = 450 m): the HYBGEN minimum z profile
HYBGEN_DP00 = (3.0, 1.18, 450.0)


def woa_z_edges(depths=WOA_DEPTHS):
    """The level interfaces of data at ``depths``: 0, the midpoints, and
    the last depth plus half the last spacing."""
    d = np.asarray(depths, np.float64)
    return np.concatenate([[0.0], 0.5 * (d[:-1] + d[1:]),
                           [d[-1] + 0.5 * (d[-1] - d[-2])]])


def _clim_profile(z, lat):
    """The climatology's smooth T [degC] and S [psu] at depth ``z`` [m]
    and latitude ``lat`` [degrees]: warm and salty subtropical surface
    waters over a cold, fresher abyss."""
    c2 = np.cos(np.deg2rad(lat)) ** 2
    t_sfc, t_deep = -1.0 + 28.0 * c2, 0.5 + 1.5 * c2
    s_sfc = 34.3 + 1.5 * np.exp(-((np.abs(lat) - 25.0) / 15.0) ** 2)
    return (t_deep + (t_sfc - t_deep) * np.exp(-z / 700.0),
            34.7 + (s_sfc - 34.7) * np.exp(-z / 400.0))


def hybgen_override(nk, eos_name="WRIGHT"):
    """The MOM_override of a HYBGEN run initialised from a z-level
    climatology: ``nk`` potential-density targets referenced to 2000 dbar
    from the climatology's lightest water (27 degC) to its densest, closer
    together where it is dense; HYCOM's minimum z profile
    (HYBGEN_DP00); the PPM_H6 remap; TS_CONFIG = from_Z reading
    clim_z.nc (:func:`write_climatology`) with WOA's missing value."""
    eos = get_eos(eos_name)
    t = torch.tensor([27.0, 0.5], dtype=torch.float64)
    s = torch.tensor([35.0, 34.7], dtype=torch.float64)
    rho = (1035.0 + eos.density(t, s, torch.full_like(t, 2e7),
                                rho_ref=1035.0)).numpy()
    frac = ((np.arange(nk) + 0.5) / nk) ** 0.6
    targets = rho[0] + (rho[1] - rho[0]) * frac
    dp0, fac, cap = HYBGEN_DP00
    dz = np.minimum(dp0 * fac ** np.arange(nk), cap)
    return ("REGRIDDING_COORDINATE_MODE = HYBGEN\n"
            "ALE_RHO_TARGETS = " + ", ".join(f"{r:.4f}" for r in targets)
            + "\nALE_RESOLUTION = " + ", ".join(f"{d:.4f}" for d in dz)
            + "\nREMAPPING_SCHEME = PPM_H6\nTS_CONFIG = from_Z\n"
            "TEMP_SALT_Z_INIT_FILE = clim_z.nc\n"
            f"Z_INIT_DATA_MISSING = {WOA_MISSING!r}\n")


# chip_smoke.py's [hybgen] phase on configs/global_half_deg (32 layers)
HYBGEN_OVERRIDE = hybgen_override(32)


def write_climatology(path, G, seed, nlon=360, nlat=180, depths=WOA_DEPTHS,
                      noise=True, land="nearest"):
    """A z-level climatology of T and S on its own nlon x nlat grid of
    cell centres (World Ocean Atlas 2018's 1-degree layout with its 102
    depths by default) as a NetCDF file with lon, lat, z_edges, ptemp and
    salt (float32), the smooth :func:`_clim_profile` plus (``noise``)
    noise from ``seed``.  Its land is the model's: each cell centre takes
    the land mask and the depth of the model's nearest T point (on the
    sphere), or with ``land="deepest"`` the depth of the deepest model T
    point inside its cell (the nearest's where none is), and a level is
    missing (WOA_MISSING) on land and below that depth.  Returns the
    missing share."""
    from scipy.spatial import cKDTree
    from mom6_tpu_torch.io.netcdf import NCWriter
    rng = np.random.default_rng(seed)
    lon = (np.arange(nlon) + 0.5) * (360.0 / nlon)
    lat = -90.0 + (np.arange(nlat) + 0.5) * (180.0 / nlat)

    def xyz(lo, la):
        lo, la = np.deg2rad(lo), np.deg2rad(la)
        return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                         np.sin(la)], axis=-1).reshape(-1, 3)
    LON, LAT = np.meshgrid(lon, lat)
    _, near = cKDTree(xyz(_np(G.geoLonT), _np(G.geoLatT))).query(
        xyz(LON, LAT))
    model = (_np(G.bathyT) * _np(G.mask2dT)).ravel()
    depth = model[near].reshape(LON.shape)
    if land == "deepest":
        ic = np.floor(np.mod(_np(G.geoLonT).ravel(), 360.0)
                      / (360.0 / nlon)).astype(int) % nlon
        jc = np.clip(np.floor((_np(G.geoLatT).ravel() + 90.0)
                              / (180.0 / nlat)).astype(int), 0, nlat - 1)
        deep = np.full(LON.shape, -1.0)
        np.maximum.at(deep, (jc, ic), model)
        depth = np.where(deep >= 0.0, deep, depth)
    z = np.asarray(depths, np.float64)[:, None, None]
    T, S = _clim_profile(z, LAT[None])
    if noise:
        decay = np.exp(-z / 1000.0)
        T = T + 0.1 * decay * rng.standard_normal(T.shape)
        S = S + 0.02 * decay * rng.standard_normal(S.shape)
    missing = z >= depth[None]
    T = np.where(missing, WOA_MISSING, T).astype(np.float32)
    S = np.where(missing, WOA_MISSING, S).astype(np.float32)
    w = NCWriter(path)
    w.write_static("lon", lon)
    w.write_static("lat", lat)
    w.write_static("z_edges", woa_z_edges(depths))
    w.write_static("ptemp", T)
    w.write_static("salt", S)
    w.close()
    return float(missing.mean())


def hybgen_relaxes_toward_isopycnal(device):
    """HYBGEN moves the interfaces qhybrlx = 0.5 of the way toward the RHO
    coordinate's (2 m at the middle interface) and, iterated 20 times,
    keeps the column sums (rtol 1e-5) and the interfaces in order (1e-3 m)
    (test_regrid_hybrid.py::test_hybgen_relaxes_toward_isopycnal)."""
    from mom6_tpu_torch.ale.regridding import build_hybgen_grid
    G, GV, h, T, S, eos = _adapt_setup(device)
    rho_t = GV.Rlay.cpu().numpy().tolist()
    dz0 = np.full(ADAPT_NZ, 1.0)
    with torch.inference_mode():
        z_rho = _np(torch.cumsum(build_rho_grid(h, T, S, GV, eos, rho_t),
                                 dim=0))
        h1 = build_hybgen_grid(h, T, S, GV, eos, rho_t, dz0, qhybrlx=0.5)
        hk = h
        for _ in range(20):
            hk = build_hybgen_grid(hk, T, S, GV, eos, rho_t, dz0,
                                   qhybrlx=0.5)
    z0 = _np(torch.cumsum(h, dim=0))
    z1 = _np(torch.cumsum(h1, dim=0))
    mid = ADAPT_NZ // 2
    expect = z0[mid] + 0.5 * (z_rho[mid] - z0[mid])
    err = float(np.abs(z1[mid] - expect).max())
    assert err <= 2.0, err
    zk = _np(torch.cumsum(hk, dim=0))
    assert np.allclose(zk[-1], z0[-1], rtol=1e-5)
    assert np.all(np.diff(zk, axis=0) > -1e-3)
    return dict(quantity="middle interface - half-way depth [m]",
                measured=err, analytic=0.0, error=err,
                gate="<= 2 m; 20 calls keep the sums and the order")


def hybgen_min_dz_profile_binds(device):
    """With a minimum profile of the full depth's z layers every top layer
    keeps at least its 100 m (less 1 m)
    (test_regrid_hybrid.py::test_hybgen_min_dz_profile_binds)."""
    from mom6_tpu_torch.ale.regridding import build_hybgen_grid
    G, GV, h, T, S, eos = _adapt_setup(device)
    rho_t = GV.Rlay.cpu().numpy().tolist()
    dz0 = np.full(ADAPT_NZ, ADAPT_DEPTH / ADAPT_NZ)
    with torch.inference_mode():
        h1 = build_hybgen_grid(h, T, S, GV, eos, rho_t, dz0, qhybrlx=1.0)
    top = float(h1[0].min())
    assert top >= ADAPT_DEPTH / ADAPT_NZ - 1.0, top
    return dict(quantity="thinnest top layer [m]", measured=top,
                analytic=ADAPT_DEPTH / ADAPT_NZ,
                error=top - ADAPT_DEPTH / ADAPT_NZ, gate=">= dz0 - 1 m")


def hybgen_unmix_restores_targets_conservatively(device):
    """Unmixing a layer 0.8 degC too warm keeps the column's heat (rtol
    1e-6) and salt (1e-7) and moves its density toward its target
    (test_regrid_hybrid.py::
    test_hybgen_unmix_restores_targets_conservatively)."""
    from mom6_tpu_torch.ale.regridding import hybgen_unmix
    nz, p_ref = 6, 2e7
    GV = build_layered_vgrid(nz, device=device)
    eos = get_eos("LINEAR")
    h = torch.full((nz, 1, 1), 200.0, device=device)
    T_clean = torch.tensor(np.linspace(18.0, 4.0, nz), dtype=torch.float32,
                           device=device)[:, None, None]
    S = torch.full_like(T_clean, 35.0)
    rho_t = GV.rho0 + eos.density(T_clean[:, 0, 0], S[:, 0, 0],
                                  torch.full((nz,), p_ref, device=device),
                                  rho_ref=GV.rho0)
    T_pert = T_clean.clone()
    T_pert[3] += 0.8
    with torch.inference_mode():
        T1, S1 = hybgen_unmix(T_pert, S, h, GV, eos, rho_t, k_fixed=2)
    heat0, heat1 = float((T_pert * h).sum()), float((T1 * h).sum())
    salt0, salt1 = float((S * h).sum()), float((S1 * h).sum())
    assert abs(heat1 - heat0) <= 1e-6 * abs(heat0)
    assert abs(salt1 - salt0) <= 1e-7 * abs(salt0)

    def rho(t):
        return float(GV.rho0 + eos.density(
            torch.tensor(t), torch.tensor(35.0), torch.tensor(p_ref),
            rho_ref=GV.rho0))
    d0 = abs(rho(float(T_pert[3, 0, 0])) - float(rho_t[3]))
    d1 = abs(rho(float(T1[3, 0, 0])) - float(rho_t[3]))
    assert d1 < d0, (d0, d1)
    return dict(quantity="layer 3's density off its target [kg m-3]",
                measured=d1, analytic=0.0, error=d1,
                gate=f"< {d0:.4g} before; heat, salt kept")


def z_init_profile_onto_layers(device):
    """A linear profile on ten 100 m levels onto five 200 m layers gives
    the layers' means (rtol 1e-4) (test_ale.py::TestZInit::
    test_profile_onto_layers)."""
    from mom6_tpu_torch.grid.z_init import init_tracer_from_z
    z_edges = np.arange(11) * 100.0
    T_data = 20.0 - 0.01 * (z_edges[:-1] + 50.0)
    h = torch.full((5, 4, 4), 200.0, device=device)
    with torch.inference_mode():
        T = _np(init_tracer_from_z(z_edges, T_data, h,
                                   torch.full((4, 4), 1000.0,
                                              device=device)))
    want = 20.0 - 0.01 * (np.arange(5) * 200.0 + 100.0)
    err = float(np.abs(T[:, 2, 2] / want - 1.0).max())
    assert err <= 1e-4, err
    return dict(quantity="relative error of the layer means",
                measured=err, analytic=0.0, error=err, gate="<= 1e-4")


def z_init_shallow_column_truncation(device):
    """A 300 m column takes only the top 300 m of the data: T in
    (16.9, 20] (test_ale.py::TestZInit::test_shallow_column_truncation)."""
    from mom6_tpu_torch.grid.z_init import init_tracer_from_z
    z_edges = np.arange(11) * 100.0
    T_data = 20.0 - 0.01 * (z_edges[:-1] + 50.0)
    h = torch.full((5, 2, 2), 60.0, device=device)
    with torch.inference_mode():
        T = _np(init_tracer_from_z(z_edges, T_data, h,
                                   torch.full((2, 2), 300.0,
                                              device=device)))
    assert T.min() > 16.9 and T.max() <= 20.0
    return dict(quantity="min T [degC]", measured=float(T.min()),
                analytic=17.0, error=float(T.min()) - 17.0,
                gate="(16.9, 20]")


def bilinear_exact_for_linear_field(device):
    """Bilinear interpolation of 2 lon + 3 lat reproduces it (rtol 1e-12)
    (test_horiz_regrid.py::TestBilinear::test_exact_for_linear_field)."""
    from mom6_tpu_torch.grid.horiz_regrid import horiz_interp_bilinear
    lon = np.linspace(0.0, 90.0, 10)
    lat = np.linspace(-30.0, 30.0, 8)
    LON, LAT = np.meshgrid(lon, lat)
    DLON, DLAT = np.meshgrid(np.linspace(5.0, 85.0, 13),
                             np.linspace(-25.0, 25.0, 11))
    out, ok = horiz_interp_bilinear(lon, lat, 2.0 * LON + 3.0 * LAT, DLON,
                                    DLAT, periodic_lon=0.0)
    want = 2.0 * DLON + 3.0 * DLAT
    err = float(np.abs(out / want - 1.0).max())
    assert ok.all() and err <= 1e-12, err
    return dict(quantity="relative error", measured=err, analytic=0.0,
                error=err, gate="<= 1e-12")


def bilinear_periodic_longitude_seam(device):
    """A zonal cosine on 10-degree centres interpolates across 360 -> 0
    within 5e-3 (TestBilinear::test_periodic_longitude_seam)."""
    from mom6_tpu_torch.grid.horiz_regrid import horiz_interp_bilinear
    lon = np.arange(0.0, 360.0, 10.0)
    lat = np.linspace(-10.0, 10.0, 5)
    LON, _ = np.meshgrid(lon, lat)
    DLON = np.full((3, 4), 355.0) + np.arange(4) * 2.5
    out, ok = horiz_interp_bilinear(lon, lat, np.cos(np.deg2rad(LON)), DLON,
                                    np.zeros((3, 4)), periodic_lon=360.0)
    err = float(np.abs(out - np.cos(np.deg2rad(DLON))).max())
    assert ok.all() and err <= 5e-3, err
    return dict(quantity="max error", measured=err, analytic=0.0, error=err,
                gate="<= 5e-3")


def bilinear_masked_source_downweights(device):
    """A masked source point (poisoned with 999) gets no weight: 5 next to
    it and away from it (TestBilinear::test_masked_source_downweights)."""
    from mom6_tpu_torch.grid.horiz_regrid import horiz_interp_bilinear
    src = np.full((8, 10), 5.0)
    good = np.ones((8, 10), bool)
    good[4, 5] = False
    src[4, 5] = 999.0
    DLON, DLAT = np.meshgrid(np.array([5.2, 2.0]), np.array([4.3]))
    out, _ = horiz_interp_bilinear(np.arange(10.0), np.arange(8.0), src,
                                   DLON, DLAT, good=good, periodic_lon=0.0)
    err = float(np.abs(out / 5.0 - 1.0).max())
    assert err <= 1e-12, err
    return dict(quantity="relative error", measured=err, analytic=0.0,
                error=err, gate="<= 1e-12")


def fill_observed_pinned_holes_harmonic(device):
    """A linear field with a 4x4 hole: the observed cells stay to the bit
    and the fill recovers the (harmonic) field within 1e-2
    (TestFillMissing::test_observed_cells_pinned_and_holes_harmonic)."""
    from mom6_tpu_torch.grid.horiz_regrid import fill_missing
    Y, X = np.mgrid[0:12, 0:14].astype(float)
    truth = 1.0 + 0.5 * X + 0.25 * Y
    good = np.ones((12, 14), bool)
    good[4:8, 5:9] = False
    out = fill_missing(np.where(good, truth, 0.0), good,
                       np.ones((12, 14), bool), acrit=1e-10)
    assert np.array_equal(out[good], truth[good])
    err = float(np.abs(out[~good] - truth[~good]).max())
    assert err <= 1e-2, err
    return dict(quantity="max error in the hole", measured=err,
                analytic=0.0, error=err, gate="<= 1e-2, observed exact")


def fill_prev_level_seeds_deep_holes(device):
    """A level with no data takes the level above (within 1e-12)
    (TestFillMissing::test_prev_level_seeds_deep_holes)."""
    from mom6_tpu_torch.grid.horiz_regrid import fill_missing
    out = fill_missing(np.zeros((6, 6)), np.zeros((6, 6), bool),
                       np.ones((6, 6), bool), prev=np.full((6, 6), 3.7))
    err = float(np.abs(out - 3.7).max())
    assert err <= 1e-12, err
    return dict(quantity="max |out - 3.7|", measured=err, analytic=0.0,
                error=err, gate="<= 1e-12")


def fill_isolated_basin_gets_global_mean(device):
    """A wet cell walled off from every datum takes the mean of the data
    (TestFillMissing::test_isolated_basin_gets_global_mean)."""
    from mom6_tpu_torch.grid.horiz_regrid import fill_missing
    wet = np.zeros((8, 8), bool)
    wet[1:4, 1:4] = True
    wet[6, 6] = True
    good = np.zeros((8, 8), bool)
    good[1:4, 1:4] = True
    out = fill_missing(np.where(good, 2.0, 0.0), good, wet)
    err = abs(float(out[6, 6]) - 2.0)
    assert err <= 2e-6, err
    return dict(quantity="isolated cell - 2", measured=err, analytic=0.0,
                error=err, gate="pytest.approx(2.0)")


def extrap_levels_continue_downward(device):
    """An unobserved deep level continues the level above (1e-10), the
    top level interpolates its linear field (rtol 1e-6)
    (TestFillMissing::test_full_pipeline_levels_continue_downward)."""
    from mom6_tpu_torch.grid.horiz_regrid import \
        horiz_interp_and_extrap_tracer
    lon, lat = np.linspace(0, 100, 20), np.linspace(0, 80, 16)
    LON, _ = np.meshgrid(lon, lat)
    lvl0 = 15.0 + 0.01 * LON
    data = np.stack([lvl0, np.full_like(lvl0, np.nan)])
    DLON, DLAT = np.meshgrid(np.linspace(10, 90, 9), np.linspace(10, 70, 7))
    out = horiz_interp_and_extrap_tracer(lon, lat, data,
                                         np.ones(DLON.shape, bool), DLON,
                                         DLAT, periodic_lon=0.0)
    err = float(np.abs(out[0] / (15.0 + 0.01 * DLON) - 1.0).max())
    err1 = float(np.abs(out[1] - out[0]).max())
    assert err <= 1e-6 and err1 <= 1e-10, (err, err1)
    return dict(quantity="top level relative error", measured=err,
                analytic=0.0, error=err, gate="<= 1e-6; deep level "
                f"{err1:.1e} off the top (<= 1e-10)")


def config_from_z_with_off_grid_climatology(device):
    """TS_CONFIG = from_Z with a 6x5 climatology on its own grid with a NaN
    hole: every wet cell finite, T in [3.9, 16.1], S in [33.9, 35.1], warm
    and fresh on top (TestFromZOffGrid::
    test_config_from_z_with_off_grid_climatology)."""
    from mom6_tpu_torch.io.netcdf import NCWriter
    lon, lat = np.linspace(0.0, 500.0, 6), np.linspace(0.0, 400.0, 5)
    LON, LAT = np.meshgrid(lon, lat)
    T = np.stack([14.0 + 0.004 * LON, 8.0 + 0.002 * LAT,
                  np.full_like(LON, 4.0)])
    S = np.stack([np.full_like(LON, 34.0), np.full_like(LON, 34.6),
                  np.full_like(LON, 35.0)])
    T[:, 2, 3] = np.nan
    S[:, 2, 3] = np.nan
    d = tempfile.mkdtemp(prefix="from_z_")
    atexit.register(shutil.rmtree, d, True)
    w = NCWriter(os.path.join(d, "clim.nc"))
    w.write_static("lon", lon)
    w.write_static("lat", lat)
    w.write_static("z_edges", np.array([0.0, 200.0, 600.0, 1000.0]))
    w.write_static("ptemp", T)
    w.write_static("salt", S)
    w.close()
    ms = build(device, text=f"""
NIGLOBAL = 12
NJGLOBAL = 10
NK = 4
LENLON = 500.0
LENLAT = 400.0
MAXIMUM_DEPTH = 1000.0
DT = 900.0
ENABLE_THERMODYNAMICS = True
TS_CONFIG = from_Z
TEMP_SALT_Z_INIT_FILE = clim.nc
INPUTDIR = {d}
""")
    wet = _np(ms.grid.mask2dT) > 0.5
    Tm, Sm = _np(ms.state.T)[:, wet], _np(ms.state.S)[:, wet]
    assert np.isfinite(Tm).all() and np.isfinite(Sm).all()
    assert Tm.min() >= 3.9 and Tm.max() <= 16.1
    assert Sm.min() >= 33.9 and Sm.max() <= 35.1
    assert Tm[0].mean() > Tm[-1].mean() and Sm[0].mean() < Sm[-1].mean()
    return dict(quantity="wet T range [degC]", measured=float(Tm.max()),
                analytic=16.0, error=float(Tm.max()) - 16.0,
                gate="T in [3.9, 16.1], S in [33.9, 35.1], stratified",
                t_min=float(Tm.min()))


SSA_NX, SSA_NY = 24, 16


def _ssa_grid(device, dtype=torch.float32):
    """test_ssa.py's grid: 24x16 cells of 10 km, reentrant in y."""
    return build_cartesian_grid(SSA_NX, SSA_NY, 240.0, 160.0,
                                max_depth=1000.0, reentrant_y=True,
                                dtype=dtype, device=device)


def _slab(device, H):
    """A slab of thickness H with an ice front 5 cells from the east."""
    h = torch.full((SSA_NY, SSA_NX), H, device=device)
    h[:, SSA_NX - 5:] = 0.0
    return h


def ssa_operator_symmetric(device):
    """The SSA operator is symmetric (1e-5 relative) and positive
    semi-definite (test_ssa.py::test_operator_symmetric)."""
    from mom6_tpu_torch.physics.ice_shelf_dynamics import _apply_ssa
    G = _ssa_grid(device)
    rng = np.random.RandomState(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    nu_h = t(1e14 * (1.0 + rng.rand(SSA_NY, SSA_NX)))
    ones = torch.ones((SSA_NY, SSA_NX), device=device)
    zero = torch.zeros_like(ones)

    def A(x):
        return torch.stack(_apply_ssa(x[0], x[1], nu_h, G, ones, G.areaT,
                                      zero))
    x = t(rng.randn(2, SSA_NY, SSA_NX) * 1e-6)
    y = t(rng.randn(2, SSA_NY, SSA_NX) * 1e-6)
    with torch.inference_mode():
        xay, yax = float((x * A(y)).sum()), float((y * A(x)).sum())
        xax = float((x * A(x)).sum())
    asym = abs(xay - yax) / (abs(xay) + abs(yax) + 1e-30)
    assert asym < 1e-5 and xax >= 0.0, (asym, xax)
    return dict(quantity="|<x,Ay> - <y,Ax>| / (|.| + |.|)", measured=asym,
                analytic=0.0, error=asym, gate="< 1e-5, <x,Ax> >= 0")


def ssa_van_der_veen_spreading(device):
    """A freely spreading slab of 300 m: the interior strain rate within
    25% of A (rho_i g' H / 4)^3 and v under a fifth of max |u|
    (test_ssa.py::test_van_der_veen_spreading)."""
    from mom6_tpu_torch.physics.ice_shelf_dynamics import (SSAParams,
                                                           ssa_solve)
    G = _ssa_grid(device)
    p = SSAParams(n_picard=12, n_cg=100)
    h = _slab(device, 300.0)
    with torch.inference_mode():
        u, v = ssa_solve(h, G, p, mask_shelf=(h > 1.0).float())
    ux = np.diff(_np(u), axis=1) / 10e3
    ux_mid = float(ux[SSA_NY // 2, 4:SSA_NX - 10].mean())
    gprime = p.rho_ice * p.g * (1.0 - p.rho_ice / p.rho_water)
    want = p.glen_a * (gprime * 300.0 / 4.0) ** 3
    err = abs(ux_mid - want) / want
    assert err < 0.25, (ux_mid, want)
    assert np.abs(_np(v)).max() < 0.2 * np.abs(_np(u)).max()
    return dict(quantity="du/dx in the interior [s-1]", measured=ux_mid,
                analytic=want, error=err, gate="< 25%, |v| < |u|/5")


def ssa_thicker_flows_faster(device):
    """400 m of ice flows more than 4 times as fast as 200 m in the
    interior (test_ssa.py::test_thicker_flows_faster)."""
    from mom6_tpu_torch.physics.ice_shelf_dynamics import (SSAParams,
                                                           ssa_solve)
    G = _ssa_grid(device)
    p = SSAParams(n_picard=6, n_cg=60)
    us = []
    for H in (200.0, 400.0):
        with torch.inference_mode():
            u, _ = ssa_solve(_slab(device, H), G, p)
        us.append(float(u[:, 2:SSA_NX - 8].abs().max()))
    assert us[1] > 4.0 * us[0], us
    return dict(quantity="max |u| ratio 400 m / 200 m",
                measured=us[1] / us[0], analytic=8.0,
                error=us[1] / us[0] - 8.0, gate="> 4")


def ssa_advect_conserves_and_bounds(device):
    """Five 30-day upwind steps of a half-covered domain at 100 m/yr: h >=
    0, the mass kept to 1e-5 and the front advanced
    (test_ssa.py::test_advect_conserves_and_bounds)."""
    from mom6_tpu_torch.physics.ice_shelf_dynamics import \
        ice_shelf_advect_thickness
    G = _ssa_grid(device)
    h = torch.full((SSA_NY, SSA_NX), 300.0, device=device)
    h[:, SSA_NX // 2:] = 0.0
    u = torch.full_like(h, 100.0 / 3.15e7)
    v = torch.zeros_like(u)
    h1 = h
    with torch.inference_mode():
        for _ in range(5):
            h1 = ice_shelf_advect_thickness(h1, u, v, 86400.0 * 30, G,
                                            (h1 > 1.0).float())
    m0 = float((h * G.areaT).sum())
    m1 = float((h1 * G.areaT).sum())
    err = abs(m1 - m0) / m0
    assert float(h1.min()) >= 0.0 and err < 1e-5, err
    assert float(h1[SSA_NY // 2, SSA_NX // 2]) > 0.0
    return dict(quantity="relative mass change", measured=err, analytic=0.0,
                error=err, gate="< 1e-5, h >= 0, the front advanced")


def ice_solo_driver(device):
    """The ice-only driver on 16x16 cells for 2 days writes ice.stats and
    ICE.res.nc, h finite and the wedge flowing
    (test_ssa.py::test_ice_solo_driver)."""
    from mom6_tpu_torch.drivers import ice_solo
    from mom6_tpu_torch.io.netcdf import read_nc
    d = tempfile.mkdtemp(prefix="ice_solo_")
    atexit.register(shutil.rmtree, d, True)
    with open(os.path.join(d, "MOM_input"), "w") as f:
        f.write("NIGLOBAL = 16\nNJGLOBAL = 16\nLENLON = 80.0\n"
                "LENLAT = 80.0\nDT = 43200.0\nDAYMAX = 2.0\n")
    ice_solo.main([d], device=device)
    assert os.path.exists(os.path.join(d, "ice.stats"))
    res = read_nc(os.path.join(d, "ICE.res.nc"))
    assert np.isfinite(res["h_ice"]).all()
    sp = float(np.hypot(res["u_ice"], res["v_ice"]).max())
    assert sp > 0.0
    return dict(quantity="max speed [m/s]", measured=sp, analytic=0.0,
                error=sp, gate="> 0, files written, h finite")


def ssa_fold_grid_rejected(device):
    """ssa_solve on a tripolar grid raises ValueError naming the fold
    (test_ssa.py::test_fold_grid_rejected)."""
    from mom6_tpu_torch.physics.ice_shelf_dynamics import (SSAParams,
                                                           ssa_solve)
    G = build_cartesian_grid(8, 8, 100.0, 100.0, max_depth=1000.0,
                             device=device)
    G = dataclasses.replace(G, fold_north=True)
    try:
        ssa_solve(torch.full((8, 8), 200.0, device=device), G, SSAParams())
    except ValueError as e:
        assert "fold" in str(e)
        return dict(quantity="raises ValueError('...fold...')", measured=1.0,
                    analytic=1.0, error=0.0, gate="raises")
    raise AssertionError("ssa_solve accepted a fold grid")


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
    # test_coupled_cap.py, test_nuopc_cap.py, test_coupler_waves.py,
    # test_bgc.py, test_barotropic_parity.py and test_aux_physics.py on
    # the coupled caps and what they reach
    "cap_iob_conversion_signs": cap_iob_conversion_signs,
    "cap_slab_atmosphere_coupled_loop": cap_slab_atmosphere_coupled_loop,
    "cap_lifecycle_restart": cap_lifecycle_restart,
    "cap_components_step_concurrently": cap_components_step_concurrently,
    "nuopc_advertise_and_advance": nuopc_advertise_and_advance,
    "nuopc_sign_folding_net_heat": nuopc_sign_folding_net_heat,
    "nuopc_fioo_q_freezing_and_melting": nuopc_fioo_q_freezing_and_melting,
    "nuopc_restart_alarm_dated_file": nuopc_restart_alarm_dated_file,
    "nuopc_lamult_inversion_roundtrip": nuopc_lamult_inversion_roundtrip,
    "nuopc_pstokes_drive_surfbands": nuopc_pstokes_drive_surfbands,
    "nuopc_wave_imports_reach_step": nuopc_wave_imports_reach_step,
    "ocean_model_coupling_api": ocean_model_coupling_api,
    "waves_stokes_and_langmuir": waves_stokes_and_langmuir,
    "waves_dhh85_profile": waves_dhh85_profile,
    "waves_surfband_analytic": waves_surfband_analytic,
    "waves_sl_average_partial_cell": waves_sl_average_partial_cell,
    "waves_misalignment_increases_la": waves_misalignment_increases_la,
    "bgc_nitrogen_conserved": bgc_nitrogen_conserved,
    "bgc_bloom_needs_light": bgc_bloom_needs_light,
    "bgc_detritus_sinks": bgc_detritus_sinks,
    "bgc_nitrogen_deposition": bgc_nitrogen_deposition,
    "bgc_config_and_cap": bgc_config_and_cap,
    "dynamic_psurf_damps_under_rigid_ice":
        dynamic_psurf_damps_under_rigid_ice,
    "brine_plume_conserves_and_redistributes":
        brine_plume_conserves_and_redistributes,
    "brine_plume_profile_increases_in_ml":
        brine_plume_profile_increases_in_ml,
    "opacity_sw_absorption_profile": opacity_sw_absorption_profile,
    # test_barotropic_parity.py, test_mom_thermo.py, test_rotation.py,
    # test_bbl_lbd.py, test_wired_subsystems.py and test_aux_physics.py on
    # the step's shared options
    "gl90_redistributes_momentum": gl90_redistributes_momentum,
    "diabatic_first_ordering": diabatic_first_ordering,
    "rotate_and_homogenize_forcing": rotate_and_homogenize_forcing,
    "rotation_roundtrip_identities": rotation_roundtrip_identities,
    "step_rotational_invariance": step_rotational_invariance,
    "lbd_conserves_and_mixes_only_bl": lbd_conserves_and_mixes_only_bl,
    "lbd_zero_kh_identity": lbd_zero_kh_identity,
    "regularize_layers_smooths_and_conserves":
        regularize_layers_smooths_and_conserves,
    "diapyc_energy_req_positive_and_scales":
        diapyc_energy_req_positive_and_scales,
    "double_diffusion_wired": double_diffusion_wired,
    "convective_kd_targets_unstable": convective_kd_targets_unstable,
    "full_convection_stabilizes": full_convection_stabilizes,
    "double_diffusion_regimes": double_diffusion_regimes,
    # test_wired_subsystems.py, test_aux_physics.py, test_hor_visc.py,
    # test_lateral_physics.py and test_barotropic_parity.py on the lateral
    # options
    "porous_barrier_blocks_deep_flow": porous_barrier_blocks_deep_flow,
    "zanna_bolton_changes_momentum": zanna_bolton_changes_momentum,
    "interface_filter_conserves_and_smooths":
        interface_filter_conserves_and_smooths,
    "interface_filter_smooths_interfaces":
        interface_filter_smooths_interfaces,
    "porous_fractions": porous_fractions,
    "leith_dissipates_and_scales": leith_dissipates_and_scales,
    "anisotropic_viscosity_prefers_direction":
        anisotropic_viscosity_prefers_direction,
    "qg_leith_bounded_by_relative_gradient":
        qg_leith_bounded_by_relative_gradient,
    "zb_rest_state_zero": zb_rest_state_zero,
    "zb_momentum_conserved_and_quadratic":
        zb_momentum_conserved_and_quadratic,
    "meke_backscatter_injects_energy": meke_backscatter_injects_energy,
    "arakawa_lamb_schemes": arakawa_lamb_schemes,
    "equilibrium_tide_drives_flow": equilibrium_tide_drives_flow,
    "scalar_sal_weakens_surface_gravity": scalar_sal_weakens_surface_gravity,
    "harmonic_sal_runs": harmonic_sal_runs,
    "stanley_pgf_changes_solution": stanley_pgf_changes_solution,
    "sppt_pattern_evolves_and_perturbs": sppt_pattern_evolves_and_perturbs,
    "skeb_is_nondivergent_kick": skeb_is_nondivergent_kick,
    "equilibrium_tide_oscillates": equilibrium_tide_oscillates,
    "sal_eigenfunction_scaling": sal_eigenfunction_scaling,
    "sal_degrees_0_and_1_excluded": sal_degrees_0_and_1_excluded,
    "sal_love_factors_scale_linearly": sal_love_factors_scale_linearly,
    "sal_is_small_and_smooth": sal_is_small_and_smooth,
    "wright_full_fit": wright_full_fit,
    "eos_second_derivs_match_fd": eos_second_derivs_match_fd,
    "temperature_convert": temperature_convert,
    "roquet_rho_checks": roquet_rho_checks,
    "unesco_checks": unesco_checks,
    "stanley_correction_sign_and_scale": stanley_correction_sign_and_scale,
    "ar1_pattern_statistics": ar1_pattern_statistics,
    "sppt_perturbs_tendency": sppt_perturbs_tendency,
    "skeb_divergence_free": skeb_divergence_free,
    "hybgen_relaxes_toward_isopycnal": hybgen_relaxes_toward_isopycnal,
    "hybgen_min_dz_profile_binds": hybgen_min_dz_profile_binds,
    "hybgen_unmix_restores_targets_conservatively":
        hybgen_unmix_restores_targets_conservatively,
    "z_init_profile_onto_layers": z_init_profile_onto_layers,
    "z_init_shallow_column_truncation": z_init_shallow_column_truncation,
    "bilinear_exact_for_linear_field": bilinear_exact_for_linear_field,
    "bilinear_periodic_longitude_seam": bilinear_periodic_longitude_seam,
    "bilinear_masked_source_downweights": bilinear_masked_source_downweights,
    "fill_observed_pinned_holes_harmonic":
        fill_observed_pinned_holes_harmonic,
    "fill_prev_level_seeds_deep_holes": fill_prev_level_seeds_deep_holes,
    "fill_isolated_basin_gets_global_mean":
        fill_isolated_basin_gets_global_mean,
    "extrap_levels_continue_downward": extrap_levels_continue_downward,
    "config_from_z_with_off_grid_climatology":
        config_from_z_with_off_grid_climatology,
    "ssa_operator_symmetric": ssa_operator_symmetric,
    "ssa_van_der_veen_spreading": ssa_van_der_veen_spreading,
    "ssa_thicker_flows_faster": ssa_thicker_flows_faster,
    "ssa_advect_conserves_and_bounds": ssa_advect_conserves_and_bounds,
    "ice_solo_driver": ice_solo_driver,
    "ssa_fold_grid_rejected": ssa_fold_grid_rejected,
}

# the gates of the coupled caps and what they reach (the run of
# tests/test_torch_coupled.py)
COUPLED = tuple(list(GATES)[list(GATES).index("cap_iob_conversion_signs"):
                            list(GATES).index("gl90_redistributes_momentum")])

# the gates of the step's shared options (the run of
# tests/test_torch_options.py)
OPTIONS = tuple(list(GATES)[list(GATES).index(
    "gl90_redistributes_momentum"):list(GATES).index(
    "porous_barrier_blocks_deep_flow")])

# the gates of the lateral options (the run of tests/test_torch_lateral.py)
LATERAL = tuple(list(GATES)[list(GATES).index(
    "porous_barrier_blocks_deep_flow"):list(GATES).index(
    "equilibrium_tide_drives_flow")])

# the gates of the tides and the SAL, the Stanley correction and the
# equations of state, SPPT and SKEB (the run of
# tests/test_torch_stoch_tides.py)
STOCH_TIDES = tuple(list(GATES)[list(GATES).index(
    "equilibrium_tide_drives_flow"):list(GATES).index(
    "hybgen_relaxes_toward_isopycnal")])

# the gates of HYBGEN, z_init, the horizontal regridding and the SSA with
# the ice-only driver (the run of tests/test_torch_hybgen_ice.py)
HYBGEN_ICE = tuple(list(GATES)[list(GATES).index(
    "hybgen_relaxes_toward_isopycnal"):])

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
