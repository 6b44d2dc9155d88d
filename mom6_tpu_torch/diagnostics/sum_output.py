"""Global energy and mass statements, the ocean.stats analogue
(twin of mom6_tpu/diagnostics/sum_output.py: compute_stats,
compute_stats_jit as compute_stats_device, format_stats_line,
StatsWriter, tracer_stocks, BudgetAudit).

``compute_stats`` copies the fields to the host and sums them in float64
with order-invariant reproducing sums (the float64 runs' path);
``compute_stats_device`` sums on the state's device with
framework/repro_sum.py::fixed_point_sum, order-invariant too, and copies
only the scalars (the float32 runs' path).

On a mesh (parallel/mesh.py) both take the rank's tiles: the exact sums
all-reduce their integer limbs, the bounds and ``max_CFL`` are
all-reduce MAXima, and the host path's area-mean interfaces (a plain
float64 sum, as the reference's) are summed over the assembled global
fields, so that every number is the one-rank number to the bit.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from mom6_tpu_torch.framework.arith import vcumsum
from mom6_tpu_torch.framework.stencil import ip1, jp1
from mom6_tpu_torch.framework import stencil
from mom6_tpu_torch.framework.repro_sum import (fixed_point_sum, global_max,
                                                reproducing_sum)

__all__ = ["compute_stats", "compute_stats_device", "format_stats_line",
           "StatsWriter", "read_stats", "tracer_stocks", "BudgetAudit"]

_CP_DEFAULT = 3991.87          # MOM6 C_P default [J kg-1 K-1]


def _np(t, dtype=None):
    a = t.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def compute_stats(state, G, GV, dt: float,
                  cp: float = _CP_DEFAULT) -> Dict[str, float]:
    """mass [kg], KE and APE [J], energy, max_CFL (and salt, heat when
    the state carries T and S)."""
    f64 = np.float64
    h = _np(state.h, f64)
    u = _np(state.u, f64)
    v = _np(state.v, f64)
    area = _np(G.areaT, f64) * _np(G.mask2dT, f64)
    depth = _np(G.bathyT, f64)

    mass = reproducing_sum(h * area[None], scale=GV.rho0)

    h_t = state.h.detach().to(torch.float64)
    h_u = _np(0.5 * (h_t + ip1(h_t)))
    h_v = _np(0.5 * (h_t + jp1(h_t)))
    mu = _np(G.mask2dCu, f64)
    mv = _np(G.mask2dCv, f64)
    ke_terms = 0.5 * GV.rho0 * area[None] * (
        (h_u * u * u * mu[None]) + (h_v * v * v * mv[None]))
    ke = reproducing_sum(ke_terms)

    # APE of the layered stack about the area-mean interface heights
    gp = _np(GV.g_prime, f64)
    csum_below = np.cumsum(h[::-1], axis=0)[::-1]
    e = csum_below - depth[None]
    e_area, area_all = _whole(e * area[None]), _whole(area)
    wet = area_all.sum()
    e_rest = e_area.sum(axis=(1, 2), keepdims=True) / max(wet, 1e-30)
    ape_terms = 0.5 * GV.rho0 * gp[:, None, None] * (e - e_rest) ** 2 \
        * area[None]
    ape = reproducing_sum(ape_terms * _np(G.mask2dT)[None])

    idx = _np(G.IdxT, f64)
    idy = _np(G.IdyT, f64)
    cfl = global_max(np.array(
        [np.max(np.abs(u) * dt * idx[None]),
         np.max(np.abs(v) * dt * idy[None])]))

    out = {"mass": mass, "KE": ke, "APE": ape, "energy": ke + ape,
           "max_CFL": cfl}
    if getattr(state, "T", None) is not None:
        T = _np(state.T, f64)
        S = _np(state.S, f64)
        out["salt"] = reproducing_sum(S * h * area[None],
                                      scale=GV.rho0 * 1e-3)
        out["heat"] = reproducing_sum(T * h * area[None],
                                      scale=GV.rho0 * cp)
    return out


def _whole(a):
    """The global field of a tile on the active mesh (``a`` itself off a
    mesh), as float64 numpy."""
    mesh = stencil._MESH
    if mesh is None:
        return a
    return mesh.assemble(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def compute_stats_device(state, G, GV, dt: float,
                         cp: float = _CP_DEFAULT) -> Dict[str, float]:
    """The numbers of :func:`compute_stats` summed on the state's device
    with :func:`fixed_point_sum` in the state's dtype (the reference's
    compute_stats_jit, sum_output.py:76-143): every global sum is an
    exact fixed-point reduction below a bound taken from the grid, and
    the per-layer means of the APE are one batched reduction over
    (ny, nx).  Only the scalars leave the device."""
    h, u, v = state.h, state.u, state.v
    area = G.areaT * G.mask2dT
    max_area = global_max(G.areaT)
    max_depth = global_max(G.bathyT)
    h_bound = 4.0 * max(max_depth, 1.0)
    u_bound = 20.0                          # CFL-truncated long before this

    mass = GV.rho0 * fixed_point_sum(h * area[None],
                                     max_mag=h_bound * max_area)
    h_u = 0.5 * (h + ip1(h))
    h_v = 0.5 * (h + jp1(h))
    ke_terms = 0.5 * GV.rho0 * area[None] * (
        h_u * u * u * G.mask2dCu[None] + h_v * v * v * G.mask2dCv[None])
    ke = fixed_point_sum(
        ke_terms, max_mag=GV.rho0 * max_area * h_bound * u_bound ** 2)

    gp = GV.g_prime.to(h.dtype)
    # sum_{m >= k} h_m per layer k, added from the bottom up in order
    e = vcumsum(h.flip(0)).flip(0) - G.bathyT[None]
    wet = fixed_point_sum(area, max_mag=max_area)
    e_bound = 2.0 * h_bound
    e_rest = fixed_point_sum(e * area[None], max_mag=e_bound * max_area,
                             dims=(1, 2)) / torch.clamp(wet, min=1e-30)
    dev = (e - e_rest[:, None, None]) * G.mask2dT[None]
    gp_max = float(GV.g_prime.max())            # (nz,): on every rank
    ape_terms = 0.5 * GV.rho0 * gp[:, None, None] * dev * dev * area[None]
    ape = fixed_point_sum(
        ape_terms,
        max_mag=0.5 * GV.rho0 * gp_max * e_bound ** 2 * max_area)

    cfl = torch.maximum(torch.amax(torch.abs(u) * dt * G.IdxT[None]),
                        torch.amax(torch.abs(v) * dt * G.IdyT[None]))
    if stencil._MESH is not None:
        cfl = stencil._MESH.all_max(cfl)
    out = {"mass": mass, "KE": ke, "APE": ape, "energy": ke + ape,
           "max_CFL": cfl}
    if state.T is not None:
        ts_bound = 64.0          # |T| [degC], S [ppt] stay far below this
        out["salt"] = GV.rho0 * 1e-3 * fixed_point_sum(
            state.S * h * area[None],
            max_mag=ts_bound * h_bound * max_area)
        out["heat"] = GV.rho0 * cp * fixed_point_sum(
            state.T * h * area[None],
            max_mag=ts_bound * h_bound * max_area)
    names = list(out)
    vals = torch.stack([out[k] for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def tracer_stocks(tr: Dict[str, "object"], h, G,
                  names=None) -> Dict[str, float]:
    """Global stock of each registered passive tracer, sum(c h area)
    [conc m3] (the Tracer_stocks report of MOM_sum_output.F90), summed
    on the host in float64; the packages' clocks ("_" names) are
    skipped."""
    area = _np(G.areaT, np.float64) * _np(G.mask2dT, np.float64)
    h64 = _np(h, np.float64)
    out: Dict[str, float] = {}
    for name in (names if names is not None else tr):
        if name.startswith("_"):
            continue
        c = _np(tr[name], np.float64)
        out[name] = float(reproducing_sum(c * h64 * area[None]))
    return out


def _area(G):
    return _np(G.areaT, np.float64) * _np(G.mask2dT, np.float64)


class BudgetAudit:
    """Accumulated net surface inputs of mass, salt and heat and the
    drift of the totals against them, the net-input half of write_energy
    (MOM_sum_output.F90:321-1100), summed on the host in float64.

    ``accumulate(forcing, state, G, GV, interval)`` integrates the
    forcing that drove the last ``interval`` seconds (restoring fluxes
    against the current top-layer T/S: exact for fixed fluxes,
    segment-endpoint approximate for restoring); ``drift(stats)``
    returns (change since start) - (net input): zero to rounding for a
    conservative model.  Fresh water is a virtual salt flux here: it
    moves salt, not mass.  The reference's frazil term is left out: the
    CLI's state carries no ``frazil`` (the builder leaves it None, as the
    reference's does)."""

    def __init__(self, stats0: Dict[str, float], cp: float = _CP_DEFAULT):
        self.m0 = stats0.get("mass")
        self.s0 = stats0.get("salt")
        self.h0 = stats0.get("heat")
        self.cp = cp
        self.mass_in = 0.0
        self.salt_in = 0.0
        self.heat_in = 0.0

    def accumulate(self, forcing, state, G, GV, interval: float) -> None:
        buoy = getattr(forcing, "buoy", None)
        if buoy is None:
            return
        area = _area(G)

        def tot(field):
            return reproducing_sum(_np(field, np.float64) * area)

        q = 0.0
        if buoy.heat_flux is not None:
            q += tot(buoy.heat_flux)
        if buoy.sw_flux is not None:
            q += tot(buoy.sw_flux)
        sf = 0.0
        if buoy.salt_flux is not None:
            sf += tot(buoy.salt_flux)
        if buoy.salt_left_behind is not None:
            sf += tot(buoy.salt_left_behind)
        self.heat_in += q * interval
        self.salt_in += GV.rho0 * 1e-3 * sf * interval
        if buoy.fw_flux is not None:
            vsf = -_np(state.S[0], np.float64) * _np(buoy.fw_flux,
                                                     np.float64)
            self.salt_in += GV.rho0 * 1e-3 * reproducing_sum(
                vsf * area) * interval
        if buoy.t_restore is not None:
            rt = buoy.restore_rate * (_np(buoy.t_restore, np.float64)
                                      - _np(state.T[0], np.float64))
            self.heat_in += GV.rho0 * self.cp * reproducing_sum(
                rt * area) * interval
        if buoy.s_restore is not None:
            rs = buoy.restore_rate * (_np(buoy.s_restore, np.float64)
                                      - _np(state.S[0], np.float64))
            self.salt_in += GV.rho0 * 1e-3 * reproducing_sum(
                rs * area) * interval

    def drift(self, s: Dict[str, float]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.m0 is not None and "mass" in s:
            out["mass_drift"] = (s["mass"] - self.m0) - self.mass_in
        if self.s0 is not None and "salt" in s:
            out["salt_drift"] = (s["salt"] - self.s0) - self.salt_in
        if self.h0 is not None and "heat" in s:
            out["heat_drift"] = (s["heat"] - self.h0) - self.heat_in
        return out


def format_stats_line(step: int, time_days: float,
                      s: Dict[str, float]) -> str:
    line = (f"{step:8d}, {time_days:12.3f} days: En {s['energy']: .12e} "
            f"(KE {s['KE']: .6e}, APE {s['APE']: .6e}), "
            f"Mass {s['mass']: .12e}, maxCFL {s['max_CFL']:.5f}")
    if "salt" in s:
        line += f", Salt {s['salt']: .12e}"
    if "heat" in s:
        line += f", Heat {s['heat']: .12e}"
    for k, tag in (("mass_drift", "dM_net"), ("salt_drift", "dS_net"),
                   ("heat_drift", "dH_net")):
        if k in s:
            line += f", {tag} {s[k]: .3e}"
    extras = [k for k in s
              if k not in ("energy", "KE", "APE", "mass", "max_CFL",
                           "salt", "heat", "mass_drift", "salt_drift",
                           "heat_drift")]
    if extras:
        line += ", Tr: " + " ".join(f"{k}={s[k]: .8e}" for k in extras)
    return line


class StatsWriter:
    """Appends ocean.stats-style lines to a file (ENERGYFILE analogue)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "w") as f:
            f.write("# step, time, energy, KE, APE, mass, max_CFL\n")

    def write(self, step: int, time_days: float, s: Dict[str, float]) -> None:
        with open(self.path, "a") as f:
            f.write(format_stats_line(step, time_days, s) + "\n")


_STATS_TAGS = ("En", "KE", "APE", "Mass", "Salt", "Heat", "dM_net",
               "dS_net", "dH_net")


def read_stats(path: str) -> List[Dict[str, float]]:
    """The lines of an ocean.stats file as {"step": n, column: value}
    (the columns of :func:`format_stats_line` that the line holds)."""
    num = r"([-+]?\d\.\d+e[-+]\d+)"
    out = []
    with open(path) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            rec = {"step": int(ln.split(",")[0])}
            for tag in _STATS_TAGS:
                m = re.search(rf"\b{tag}\s+{num}", ln)
                if m:
                    rec[tag] = float(m.group(1))
            out.append(rec)
    return out
