"""Truncation-point dossiers (twin of mom6_tpu/diagnostics/point_accel.py,
the role of MOM_PointAccel.F90): where the advective CFL number is worst,
and the column state there, so that a blow-up can be diagnosed.

The reference copies u, v, h and T whole to the host.  Here the CFL
numbers are formed in float64 on the fields' device with the
reference's operations (|u| dt / dx, each a single rounding), the worst
point is found there (``torch.argmax`` returns the first of equal
maxima in the flattened (k, j, i) order, as numpy's ``argmax`` does),
and only that point's columns come to the host: the same dossier, to the
bit, from a card or the CPU.  On a mesh of ranks (parallel/mesh.py) the
fields it reads are gathered to the mesh's rank 0, which forms the
dossier of the global fields; the other ranks get None.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mom6_tpu_torch.framework.stencil import is_root, off_mesh, to_root

__all__ = ["worst_cfl_dossier", "format_dossier"]


def _column(a, j: int, i: int) -> list:
    return a[:, j, i].double().cpu().tolist()


def worst_cfl_dossier(state, G, dt: float) -> Optional[Dict]:
    """The worst advective-CFL velocity point and its column state (None
    on a mesh's other ranks than 0)."""
    fields = {k: to_root(a) for k, a in (
        ("u", state.u), ("v", state.v), ("h", state.h), ("T", state.T),
        ("IdxCu", G.IdxCu), ("IdyCv", G.IdyCv), ("bathyT", G.bathyT))
        if a is not None}
    if not is_root():
        return None
    with off_mesh():
        return _dossier(fields, dt)


def _dossier(f, dt: float) -> Dict:
    """The dossier of the whole fields ``f``."""
    cfl_u = f["u"].double().abs() * dt * f["IdxCu"].double()
    cfl_v = f["v"].double().abs() * dt * f["IdyCv"].double()
    if float(cfl_u.max()) >= float(cfl_v.max()):
        comp, cfl = "u", cfl_u
    else:
        comp, cfl = "v", cfl_v
    vel = f[comp]
    k, j, i = (int(x) for x in np.unravel_index(int(torch.argmax(cfl)),
                                                tuple(cfl.shape)))
    out = {
        "component": comp, "k": k, "j": j, "i": i,
        "cfl": float(cfl[k, j, i]), "vel": float(vel[k, j, i].double()),
        "depth": float(f["bathyT"][j, i]),
        "h_column": _column(f["h"], j, i),
        "u_column": _column(f["u"], j, i),
        "v_column": _column(f["v"], j, i),
    }
    if "T" in f:
        out["T_column"] = _column(f["T"], j, i)
    return out


def format_dossier(d: Dict) -> str:
    lines = [f"worst CFL: {d['cfl']:.4f} ({d['component']} = "
             f"{d['vel']:.3f} m/s) at (k={d['k']}, j={d['j']}, i={d['i']}), "
             f"depth {d['depth']:.0f} m",
             "  h: " + " ".join(f"{x:9.2f}" for x in d["h_column"]),
             "  u: " + " ".join(f"{x:9.4f}" for x in d["u_column"]),
             "  v: " + " ".join(f"{x:9.4f}" for x in d["v_column"])]
    if "T_column" in d:
        lines.append("  T: " + " ".join(f"{x:9.3f}" for x in d["T_column"]))
    return "\n".join(lines)
