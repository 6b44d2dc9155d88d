"""What spins the ``[hybgen]`` flow up from the from_Z build at rest: the
port's step_mom from the state that TS_CONFIG = from_Z builds with
tests/torch_gates.py's hybgen_override, for CYCLES thermo cycles, from
three climatologies on World Ocean Atlas 2018's 1-degree layout
(torch_gates.write_climatology, seed 11): its land at the depth of the
model's nearest T point, the same without its noise, and its land at
the depth of the deepest model T point of each 1-degree cell (as
chip_smoke.py's ``[hybgen]`` writes it); the first and the last also
with z* on uniform layers.  Prints the largest |u| after each cycle and
where it lies, and for that face: the model's depth either side, the
deepest depth at which the bilinear interpolation found data in each of
the two columns (below it the fill continues the level above downward
and holds it), and T either side in that layer.

    python3 tools/torch_hybgen_spinup.py            # the card: 720x400x32
    python3 tools/torch_hybgen_spinup.py --small    # the CPU: 180x100x20

The card runs configs/global_half_deg (float32); ``--small`` runs
configs/global_2deg on the CPU (float32).  Prints one ``[spinup]`` line
per run, then the card's name and power limit.
"""

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

CYCLES = 3
SEED = 11


def deepest_data(d, G):
    """(ny, nx): the deepest WOA depth at which the bilinear interpolation
    of the climatology ``d``/clim_z.nc finds data at each T point (-1
    where it finds none)."""
    import torch_gates
    from mom6_tpu_torch.grid.horiz_regrid import horiz_interp_bilinear
    from mom6_tpu_torch.io.netcdf import read_nc
    raw = read_nc(os.path.join(d, "clim_z.nc"))
    lon, lat = G.geoLonT.cpu().numpy(), G.geoLatT.cpu().numpy()
    out = np.full(lon.shape, -1.0)
    for k, z in enumerate(torch_gates.WOA_DEPTHS):
        lvl = np.asarray(raw["ptemp"][k], np.float64)
        good = ~np.isclose(lvl, torch_gates.WOA_MISSING)
        _, ok = horiz_interp_bilinear(raw["lon"], raw["lat"],
                                      np.where(good, lvl, 0.0), lon, lat,
                                      good=good)
        out = np.where(ok, z, out)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import torch_gates
    from mom6_tpu_torch.core.mom import step_mom
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    from mom6_tpu_torch.framework.stencil import ip1
    if args.small:
        name, nk, dev = "global_2deg", 20, "cpu"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no card (use --small for the CPU)")
        name, nk, dev = "global_half_deg", 32, torch.device("cuda", 0)
    work = os.path.join(tempfile.mkdtemp(), name)
    shutil.copytree(os.path.join(REPO, "configs", name), work)
    files = [os.path.join(work, "MOM_input")]
    G0 = build_model_from_params(ParamFile(files), device=dev).grid
    text = torch_gates.hybgen_override(nk)
    runs = [("nearest land", dict(), "HYBGEN"),
            ("nearest land", dict(), "z*"),
            ("nearest land, no noise", dict(noise=False), "HYBGEN"),
            ("deepest land", dict(land="deepest"), "HYBGEN"),
            ("deepest land", dict(land="deepest"), "z*")]
    built = {}
    for clim, kw, coord in runs:
        if clim not in built:
            t = time.time()
            torch_gates.write_climatology(os.path.join(work, "clim_z.nc"),
                                          G0, SEED, **kw)
            ms = build_model_from_params(ParamFile(files, text=text),
                                         device=dev)
            built = {clim: (ms, deepest_data(work, ms.grid))}
            print(f"[spinup] {name}, climatology with {clim}: built in "
                  f"{time.time() - t:.1f} s", flush=True)
        ms, zdata = built[clim]
        G, p = ms.grid, ms.params
        if coord == "z*":
            p = p.replace(ale=dataclasses.replace(
                p.ale, mode="ZSTAR", dz_nominal=tuple(
                    [float(G.bathyT.max()) / nk] * nk)))
        st, top = ms.state, []
        t = time.time()
        with torch.inference_mode():
            for _ in range(CYCLES):
                st = step_mom(st, ms.forcing, G, ms.vgrid, p)
                u = st.u.abs()
                k, j, i = (int(x) for x in torch.unravel_index(
                    torch.argmax(u), u.shape))
                e = (i + 1) % G.nx
                hu = 0.5 * (st.h + ip1(st.h))
                top.append(
                    f"{float(u[k, j, i]):.3f} (k {k}, j {j}, i {i}, "
                    f"{float(G.geoLatT[j, i]):.1f}N "
                    f"{float(G.geoLonT[j, i]):.1f}E, face "
                    f"{float(hu[k, j, i]):.3g} m; depth "
                    f"{float(G.bathyT[j, i]):.0f} | "
                    f"{float(G.bathyT[j, e]):.0f} m, data to "
                    f"{zdata[j, i]:.0f} | {zdata[j, e]:.0f} m, T at the "
                    f"build {float(ms.state.T[k, j, i]):.2f} | "
                    f"{float(ms.state.T[k, j, e]):.2f} degC)")
        print(f"[spinup] {clim}, {coord}: max |u| [m/s] after each of "
              f"{CYCLES} cycles: {'; '.join(top)}; {time.time() - t:.1f} s",
              flush=True)
    shutil.rmtree(os.path.dirname(work))
    if not args.small:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"[card] {smi.stdout.strip()}", flush=True)


if __name__ == "__main__":
    main()
