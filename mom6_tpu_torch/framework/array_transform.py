"""Quarter-turn rotation of the model domain
(twin of mom6_tpu/framework/array_transform.py: MOM_array_transform.F90's
rotate_array and rotate_vector, the ROTATE_INDEX test of rotational
invariance).

One counter-clockwise quarter turn, (x, y) -> (-y, x):

* an h-point field: A'[i, ny-1-j] = A[j, i], (ny, nx) -> (nx, ny);
* u (the east face of (j, i)) becomes the north face of the rotated
  cell: v'[i, ny-1-j] = u[j, i];
* v (the north face of (j, i)) becomes minus the east face of the cell
  at i' = ny-2-j: u'[i, ny-2-j] = -v[j, i] (the one-index shift is the
  price of the non-symmetric staggering);
* q (the north-east corner of (j, i)) maps to the north-east corner of
  cell (i, ny-2-j).

The rotation turns whole fields: off a mesh of ranks only (on a mesh,
gather the tiles first, parallel/mesh.py::gather).
"""

from __future__ import annotations

import torch

from mom6_tpu_torch.core.state import OceanState
from mom6_tpu_torch.framework.arith import rdiv
from mom6_tpu_torch.framework.stencil import refuse_on_ranks

__all__ = ["rotate_scalar", "rotate_uv", "unrotate_scalar", "unrotate_uv",
           "rotate_state", "rotate_grid"]


def rotate_scalar(a):
    """One counter-clockwise quarter turn of an (..., ny, nx) h-point
    field, contiguous (the card's kernels take contiguous fields)."""
    refuse_on_ranks("array_transform's quarter turn")
    return torch.flip(torch.swapaxes(a, -1, -2), dims=(-1,)).contiguous()


def unrotate_scalar(a):
    refuse_on_ranks("array_transform's quarter turn")
    return torch.swapaxes(torch.flip(a, dims=(-1,)), -1, -2).contiguous()


def rotate_uv(u, v):
    """The C-grid vector pair turned: (u', v')."""
    v_new = rotate_scalar(u)
    u_new = -torch.roll(rotate_scalar(v), -1, dims=-1)
    return u_new, v_new


def unrotate_uv(u, v):
    u_old = unrotate_scalar(v)
    v_old = -unrotate_scalar(torch.roll(u, 1, dims=-1))
    return u_old, v_old


def rotate_state(state: OceanState) -> OceanState:
    """h, u, v, T, S, the transports and E_meke turned, as the
    reference's (the other fields as they are)."""
    def rs(a):
        return None if a is None else rotate_scalar(a)

    def ruv(a, b):
        return (None, None) if a is None else rotate_uv(a, b)
    u, v = rotate_uv(state.u, state.v)
    uh, vh = ruv(state.uh, state.vh)
    uhtr, vhtr = ruv(state.uhtr, state.vhtr)
    return state.replace(h=rotate_scalar(state.h), u=u, v=v, T=rs(state.T),
                         S=rs(state.S), uh=uh, vh=vh, uhtr=uhtr, vhtr=vhtr,
                         E_meke=rs(state.E_meke))


def rotate_grid(G):
    """The grid turned: the x and y metrics swap at the mapped points."""
    def rs(a):
        return None if a is None else rotate_scalar(a)
    m_u, m_v = rotate_uv(G.mask2dCu, G.mask2dCv)
    dxCu = torch.abs(torch.roll(rs(G.dyCv), -1, -1))
    dyCu = torch.abs(torch.roll(rs(G.dxCv), -1, -1))
    dxCv, dyCv = rs(G.dyCu), rs(G.dxCu)

    def rq(a):
        # a corner (j, i) lands on the north-east corner of (i, ny-2-j)
        return None if a is None else torch.roll(rs(a), -1, -1)
    return G.replace(
        nx=G.ny, ny=G.nx, cyclic_x=G.reentrant_y, reentrant_y=G.cyclic_x,
        dxT=rs(G.dyT), dyT=rs(G.dxT), areaT=rs(G.areaT),
        IareaT=rs(G.IareaT), IdxT=rs(G.IdyT), IdyT=rs(G.IdxT),
        dxCu=dxCu, dyCu=dyCu, IdxCu=rdiv(1.0, dxCu), IdyCu=rdiv(1.0, dyCu),
        dxCv=dxCv, dyCv=dyCv, IdxCv=rdiv(1.0, dxCv), IdyCv=rdiv(1.0, dyCv),
        dxBu=rq(G.dyBu), dyBu=rq(G.dxBu), areaBu=rq(G.areaBu),
        IareaBu=rq(G.IareaBu), mask2dT=rs(G.mask2dT),
        mask2dCu=torch.abs(m_u), mask2dCv=m_v, mask2dBu=rq(G.mask2dBu),
        CoriolisBu=rq(G.CoriolisBu), bathyT=rs(G.bathyT),
        geoLonT=rs(G.geoLonT), geoLatT=rs(G.geoLatT),
        geoLonBu=rq(G.geoLonBu), geoLatBu=rq(G.geoLatBu))
