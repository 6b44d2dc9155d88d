"""Truncation-point dossiers (twin of mom6_tpu/diagnostics/point_accel.py,
the role of MOM_PointAccel.F90): where the advective CFL number is worst,
and the column state there, so that a blow-up can be diagnosed.

The reference copies u, v, h and T whole to the host.  Here the CFL
numbers are formed in float64 on the fields' device with the
reference's operations (|u| dt / dx, each a single rounding), the worst
point is found there (``torch.argmax`` returns the first of equal
maxima in the flattened (k, j, i) order, as numpy's ``argmax`` does),
and only that point's columns come to the host: the same dossier, to the
bit, from a card or the CPU.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mom6_tpu_torch.framework.stencil import refuse_on_ranks

__all__ = ["worst_cfl_dossier", "format_dossier"]


def _column(a, j: int, i: int) -> list:
    return a[:, j, i].double().cpu().tolist()


def worst_cfl_dossier(state, G, dt: float) -> Dict:
    """The worst advective-CFL velocity point and its column state."""
    refuse_on_ranks("the truncation dossier (point_accel)")
    cfl_u = state.u.double().abs() * dt * G.IdxCu.double()
    cfl_v = state.v.double().abs() * dt * G.IdyCv.double()
    if float(cfl_u.max()) >= float(cfl_v.max()):
        comp, cfl, vel = "u", cfl_u, state.u
    else:
        comp, cfl, vel = "v", cfl_v, state.v
    k, j, i = (int(x) for x in np.unravel_index(int(torch.argmax(cfl)),
                                                tuple(cfl.shape)))
    out = {
        "component": comp, "k": k, "j": j, "i": i,
        "cfl": float(cfl[k, j, i]), "vel": float(vel[k, j, i].double()),
        "depth": float(G.bathyT[j, i]),
        "h_column": _column(state.h, j, i),
        "u_column": _column(state.u, j, i),
        "v_column": _column(state.v, j, i),
    }
    if state.T is not None:
        out["T_column"] = _column(state.T, j, i)
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
