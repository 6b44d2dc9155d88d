"""The physics gates of tests/test_analytic_parity.py,
tests/test_pf_pierced.py and tests/test_user_configs.py (those of the
configurations the port runs that pass on the reference: not
test_seamount_resting_state_stays_slow nor
test_neverworld_acc_is_eastward, which fail there), and the open
boundaries' gates of tests/test_obc.py, tests/test_obc_file_reservoir.py
and tests/test_tc_ladder.py::TestTC3, run through the PyTorch port.

Each gate builds its case through the port (the configuration's
MOM_input, the test's parameter text, or the port's builders), runs it
at the test's own size and length, and makes the test's own asserts with
its tolerances.  It returns a record of what it measured against the
analytic value, and raises AssertionError on a miss.  This module
imports no jax, so chip_smoke.py runs the gates on the card
(``device="cuda"``) and tests/test_torch_analytic.py on the CPU.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from mom6_tpu_torch.core.barotropic import BTParams, set_dtbt
from mom6_tpu_torch.core.dynamics_split_rk2 import (DynParams, MechForcing,
                                                    step_dynamics_split_rk2)
from mom6_tpu_torch.core.mom import step_mom
from mom6_tpu_torch.core.open_boundary import (OBCSegment, apply_obc,
                                               build_obc)
from mom6_tpu_torch.core.pressure_force import pressure_force_fv
from mom6_tpu_torch.core.state import init_state_resting
from mom6_tpu_torch.drivers.config_driver import build_model_from_params
from mom6_tpu_torch.eos import get_eos
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.grid.grid import build_cartesian_grid
from mom6_tpu_torch.grid.vertical import build_layered_vgrid

__all__ = ["GATES", "run_gate"]

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
}


def run_gate(name, device):
    """The gate's record with the seconds it took; raises on a miss."""
    t0 = time.time()
    rec = GATES[name](device)
    rec["seconds"] = time.time() - t0
    return rec
