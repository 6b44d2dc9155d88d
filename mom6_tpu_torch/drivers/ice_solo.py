"""The standalone ice-shelf driver (twin of mom6_tpu/drivers/ice_solo.py;
MOM6's ice_solo_driver/ice_shelf_driver.F90).

Advances the SSA ice-shelf dynamics and the thickness transport with no
ocean beneath: the configuration that spins up a shelf's geometry and
tests the ice dynamics alone.  Reads ``RUNDIR/MOM_input`` (NIGLOBAL,
NJGLOBAL, LENLON, LENLAT, DT, DAYMAX and the ICE_* keys below, with the
reference's defaults), integrates in float32 and writes ``ice.stats``
(volume, area and max speed, ten lines a run) and ``ICE.res.nc`` (h_ice,
u_ice, v_ice) through the port's ``io/``.

The initial shelf is the driver's wedge: ICE_THICKNESS_SOUTH at the
southern edge thinning linearly northward to ICE_THICKNESS_NORTH, ice
on the southern ICE_SHELF_FRAC of the domain.

Run:  python -m mom6_tpu_torch.drivers.ice_solo RUNDIR [--days D]
      [--device cpu|cuda]
(on the card unless ``--device cpu``; without a card it raises).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.device import resolve_device
from mom6_tpu_torch.grid.grid import Grid, build_cartesian_grid
from mom6_tpu_torch.io.netcdf import NCWriter
from mom6_tpu_torch.physics.ice_shelf_dynamics import (
    SSAParams, ice_shelf_advect_thickness, ssa_solve)

__all__ = ["IceSetup", "build", "step", "main"]

_SEC_PER_YEAR = 3.15576e7


class IceSetup(NamedTuple):
    grid: Grid
    params: SSAParams
    h_ice: torch.Tensor       # (ny, nx) [m]
    mask_shelf: torch.Tensor  # 1 where the ice is dynamic
    dt: float                 # [s]
    smb: float                # surface mass balance [m s-1]
    days: float               # DAYMAX


def build(pf: ParamFile, device="cuda") -> IceSetup:
    """The grid, the parameters and the wedge from a parameter file, in
    float32 on ``device``."""
    device = resolve_device(device)
    m = "ice_solo"
    nx = pf.get("NIGLOBAL", int, module=m)
    ny = pf.get("NJGLOBAL", int, module=m)
    lenlon = pf.get("LENLON", float, default=100.0, units="km", module=m)
    lenlat = pf.get("LENLAT", float, default=100.0, units="km", module=m)
    dt = pf.get("DT", float, default=86400.0, units="s", module=m)
    days = pf.get("DAYMAX", float, default=10.0, units="days", module=m)
    G = build_cartesian_grid(nx, ny, lenlon, lenlat, max_depth=1000.0,
                             device=device)
    p = SSAParams(
        glen_a=pf.get("ICE_A_GLEN", float, default=2.261e-25, module=m,
                      desc="Glen's-law rate factor [Pa-3 s-1]"),
        glen_n=pf.get("ICE_N_GLEN", float, default=3.0, module=m),
        rho_ice=pf.get("ICE_DENSITY", float, default=918.0,
                       units="kg m-3", module=m))
    h0 = pf.get("ICE_THICKNESS_SOUTH", float, default=800.0, units="m",
                module=m)
    h1 = pf.get("ICE_THICKNESS_NORTH", float, default=200.0, units="m",
                module=m)
    yfr = (np.arange(ny) + 0.5) / ny
    h_ice = torch.tensor(np.broadcast_to((h0 + (h1 - h0) * yfr)[:, None],
                                         (ny, nx)),
                         dtype=torch.float32, device=device)
    shelf_frac = pf.get("ICE_SHELF_FRAC", float, default=0.8, module=m,
                        desc="Fraction of the domain covered by shelf")
    mask = torch.tensor((yfr < shelf_frac)[:, None] * np.ones((ny, nx)),
                        dtype=torch.float32, device=device)
    smb = pf.get("ICE_SMB", float, default=0.0, units="m s-1", module=m,
                 desc="Surface mass balance applied each step")
    return IceSetup(G, p, h_ice * mask, mask, dt, smb, days)


def step(setup: IceSetup, h_ice, u, v):
    """One step: the SSA velocities from the last ones, the upwind
    transport, the surface mass balance.  Returns (h_ice, u, v)."""
    G, mask, dt = setup.grid, setup.mask_shelf, setup.dt
    u, v = ssa_solve(h_ice, G, setup.params, mask_shelf=mask, u0=u, v0=v)
    h_new = ice_shelf_advect_thickness(h_ice, u, v, dt, G, mask)
    h_new = torch.clamp(h_new + dt * setup.smb, min=0.0) * mask
    return h_new, u, v


def stats_line(n: int, dt: float, h_ice, u, v, area: np.ndarray) -> str:
    """The ice.stats line of step ``n``: volume and area summed on the
    host in float64, the max speed in m/yr."""
    hv = h_ice.cpu().numpy().astype(np.float64)
    vol = float((hv * area).sum())
    a = float((area * (hv > 1.0)).sum())
    sp = float(np.max(np.hypot(u.cpu().numpy(), v.cpu().numpy()))) \
        * _SEC_PER_YEAR
    return (f"{n:8d}, {n * dt / 86400.0:10.3f} days: "
            f"Vol {vol:.6e}  Area {a:.6e}  max|u| {sp:9.2f} m/yr")


def main(argv=None, *, device=None):
    """Run the driver on a run directory; returns the final thickness.
    ``device`` (for in-process callers) overrides ``--device``."""
    import argparse

    ap = argparse.ArgumentParser(prog="mom6_tpu_torch.drivers.ice_solo")
    ap.add_argument("rundir")
    ap.add_argument("--days", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    pf = ParamFile([os.path.join(args.rundir, "MOM_input")])
    setup = build(pf, device if device is not None else args.device)
    days = args.days if args.days is not None else setup.days
    dt = setup.dt
    h_ice = setup.h_ice
    u = torch.zeros_like(h_ice)
    v = torch.zeros_like(h_ice)
    n_steps = max(1, int(round(days * 86400.0 / dt)))
    every = max(1, n_steps // 10)
    area = setup.grid.areaT.cpu().numpy().astype(np.float64)
    t0 = time.time()
    with torch.inference_mode(), \
            open(os.path.join(args.rundir, "ice.stats"), "w") as f:
        f.write("# step, days, volume [m3], area [m2], max|u| [m yr-1]\n")
        for n in range(1, n_steps + 1):
            h_ice, u, v = step(setup, h_ice, u, v)
            if n % every == 0 or n == n_steps:
                line = stats_line(n, dt, h_ice, u, v, area)
                print(line)
                f.write(line + "\n")
    w = NCWriter(os.path.join(args.rundir, "ICE.res.nc"))
    w.write_static("h_ice", h_ice.cpu().numpy())
    w.write_static("u_ice", u.cpu().numpy())
    w.write_static("v_ice", v.cpu().numpy())
    w.close()
    print(f"ice run complete: {days} days in {time.time() - t0:.1f}s")
    return h_ice


if __name__ == "__main__":
    main()
