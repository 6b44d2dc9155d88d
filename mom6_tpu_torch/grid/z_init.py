"""Tracers from z-space data (twin of mom6_tpu/grid/z_init.py:
init_tracer_from_z).

Data on fixed z levels (a climatology) map conservatively onto the
model's layers with the remap kernel (MOM_temp_salt_initialize_from_Z's
Z_INIT_ALE_REMAPPING path): the data's levels, clipped to each column
and rescaled to its sum, are the source grid of a PLM remap onto the
layers.  The source has the data's levels, the target the model's.
"""

from __future__ import annotations

import numpy as np
import torch

from mom6_tpu_torch.ale.remapping import PLM, remap_column
from mom6_tpu_torch.framework.arith import vsum

__all__ = ["init_tracer_from_z"]


def init_tracer_from_z(z_edges, data, h, bathy):
    """Remap a profile (nzd,) or a field (nzd, ny, nx) given on the level
    interfaces ``z_edges`` (nzd+1,), positive down from 0, onto the
    layers ``h`` (nz, ny, nx); ``bathy`` is not read (the columns' sums
    clip the data).  Levels below a column's bottom are dropped, floored
    at 1e-10 m and the rest rescaled so the two grids share the column
    sum, as the remap needs."""
    z_edges = np.asarray(z_edges, np.float64)
    ny, nx = h.shape[1:]
    if torch.is_tensor(data):
        data3 = data.to(dtype=h.dtype, device=h.device)
    elif np.ndim(data) == 1:
        data3 = torch.tensor(np.broadcast_to(
            np.asarray(data)[:, None, None], (len(data), ny, nx)),
            dtype=h.dtype, device=h.device)
    else:
        data3 = torch.tensor(np.asarray(data), dtype=h.dtype,
                             device=h.device)
    col = vsum(h)
    ze = torch.tensor(z_edges, dtype=h.dtype, device=h.device)[:, None, None]
    ze_clip = torch.minimum(ze, col[None])
    h_src = torch.clamp(ze_clip[1:] - ze_clip[:-1], min=1e-10)
    h_src = h_src * (col / torch.clamp(vsum(h_src), min=1e-30))[None]
    return remap_column(data3, h_src, h, PLM)
