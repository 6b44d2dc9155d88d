"""Branchless C-grid stencil operators (twin of mom6_tpu/framework/stencil.py).

Grid convention: arrays have shape ``(..., ny, nx)``; axis -1 is x (i),
axis -2 is y (j).  h-points are cell centres, u-points the EAST face,
v-points the NORTH face and q-points the NORTHEAST corner of cell (j, i).
Every shift is a circular ``torch.roll``; solid walls are enforced by the
face masks, and the tripolar northern fold by the ghost rows of
:func:`fold_ghost`.

While a mesh of parallel/mesh.py is active (``with mesh:``) the arrays
are that rank's tiles of the global fields and every shift along a
split axis takes the neighbour rank's edge row or column through one
exchange, so that each tile sees what the global roll gives it; the
fold's ghost row comes from the partner rank, and :func:`fold_ghost`
gives None on a tile that does not hold the global top row
(:func:`holds_top_row`).

Work that reads a whole field goes through the helpers below, which are
the identity off a mesh: :func:`whole` assembles a tile's global field
on every rank (in rank order, so that a reduction of it takes the
one-rank order), :func:`tile` cuts this rank's tile from a global field,
:func:`to_root`/:func:`from_root` move a field to the mesh's rank 0 and
back, and :func:`off_mesh` sets the mesh aside while every rank works on
global fields of its own.
"""

from __future__ import annotations

import torch

__all__ = ["ip1", "im1", "jp1", "jm1", "jm1_s0", "jp1_sn", "fold_ghost",
           "fold_kinds", "holds_top_row", "holds_bottom_row",
           "refuse_on_ranks", "whole", "tile", "global_plane", "whole_sum",
           "whole_max", "is_tile", "share_from_root", "is_root", "to_root",
           "from_root", "off_mesh"]

_X = -1  # i axis
_Y = -2  # j axis

# the active tile mesh (parallel/mesh.py::Mesh), set by ``with mesh:``
_MESH = None


def holds_top_row() -> bool:
    """Whether the arrays hold the global top row (always, off a mesh)."""
    return _MESH is None or _MESH.top


def holds_bottom_row() -> bool:
    """Whether the arrays hold the global row 0 (always, off a mesh)."""
    return _MESH is None or _MESH.bottom


def refuse_on_ranks(feature: str) -> None:
    """Raise NotImplementedError naming ``feature`` while a mesh is
    active: the quarter turn of framework/array_transform.py, which
    turns whole fields, refuses a tile."""
    if _MESH is not None:
        raise NotImplementedError(
            f"{feature} is not decomposed over ranks: run it on one rank")


def whole(a):
    """The global field of the tile ``a`` (..., ty, tx) on every rank of
    the active mesh, its tiles placed in rank order; ``a`` off a mesh."""
    return a if _MESH is None else _MESH.assemble(a)


def tile(a):
    """This rank's tile of the global field ``a`` (..., ny, nx) that every
    rank holds; ``a`` off a mesh."""
    if _MESH is None:
        return a
    j0, j1, i0, i1 = _MESH.tile_bounds()
    return a[..., j0:j1, i0:i1].contiguous()


def global_plane(a):
    """The (ny, nx) of the global plane of the tile ``a``: ``a``'s own
    off a mesh."""
    if _MESH is None:
        return tuple(a.shape[-2:])
    return _MESH.ny, _MESH.nx


def whole_sum(a):
    """torch.sum of the global field of the tile ``a``, in the order one
    rank sums it (the whole field assembled on every rank)."""
    return torch.sum(whole(a))


def whole_max(a):
    """torch.amax of the global field of the tile ``a`` (exact in any
    order: the ranks' maxima all-reduced)."""
    m = torch.amax(a)
    return m if _MESH is None else _MESH.all_max(m)


def is_tile(a) -> bool:
    """Whether ``a`` is a tile field of the active mesh: (..., ty, tx)."""
    return (_MESH is not None and a.dim() >= 2
            and tuple(a.shape[-2:]) == (_MESH.ty, _MESH.tx))


def share_from_root(obj):
    """The picklable ``obj`` of the mesh's rank 0 on every rank (``obj``
    is not read elsewhere); ``obj`` off a mesh."""
    return obj if _MESH is None else _MESH.broadcast_object(obj)


def is_root() -> bool:
    """Whether this rank writes what the model writes: the mesh's rank 0,
    or any process off a mesh."""
    return _MESH is None or _MESH.rank == 0


def to_root(a):
    """The global field of the tile ``a`` on the mesh's rank 0 and None on
    the other ranks (every rank must call it); ``a`` off a mesh."""
    return a if _MESH is None else _MESH.gather_root(a)


def from_root(a, like):
    """This rank's tile of the global field ``a`` that the mesh's rank 0
    holds (``a`` is not read elsewhere), shaped and typed as the tile
    ``like``; ``a`` off a mesh."""
    return a if _MESH is None else _MESH.tile_from_root(a, like)


class off_mesh:
    """``with off_mesh():`` sets the active mesh aside, for work on whole
    fields that every rank holds (the shifts then roll the field)."""

    def __enter__(self):
        global _MESH
        self._saved, _MESH = _MESH, None
        return self

    def __exit__(self, *exc):
        global _MESH
        _MESH = self._saved
        return False


def ip1(a):
    """Value at (j, i+1)."""
    if _MESH is not None:
        return _MESH.roll_x(a, -1)
    return torch.roll(a, -1, dims=_X)


def im1(a):
    """Value at (j, i-1)."""
    if _MESH is not None:
        return _MESH.roll_x(a, 1)
    return torch.roll(a, 1, dims=_X)


def jm1(a):
    """Value at (j-1, i)."""
    if _MESH is not None:
        return _MESH.roll_y(a, 1)
    return torch.roll(a, 1, dims=_Y)


def jp1(a, fold=None):
    """Value at (j+1, i).  ``fold`` is None for periodic or walled axes,
    or a staggering kind (see :func:`fold_ghost`) for a tripolar
    northern fold, whose top-row neighbour is the fold's ghost row."""
    if _MESH is not None:
        return _MESH.roll_y(a, -1, fold)
    r = torch.roll(a, -1, dims=_Y)
    if fold is None:
        return r
    r[..., -1, :] = fold_ghost_global(a, fold)    # r is a fresh tensor
    return r


def fold_ghost(a, kind):
    """The northern-fold ghost row of ``a`` (see
    :func:`fold_ghost_global`); on a mesh, from the partner rank, and
    None on a tile that does not hold the top row."""
    if _MESH is not None:
        return _MESH.fold_ghost(a, kind)
    return fold_ghost_global(a, kind)


def fold_ghost_global(a, kind):
    """The northern-fold ghost row of the whole-width ``a``: the top edge
    is identified with itself under i -> nx-1-i, vectors change sign.

      "h"  ghost[i] =  a[ny-1, nx-1-i]    "u"  ghost[i] = -a[ny-1, nx-2-i]
      "us" ghost[i] =  a[ny-1, nx-2-i]    "v"  ghost[i] = -a[ny-2, nx-1-i]
      "vs" ghost[i] =  a[ny-2, nx-1-i]    "q"  ghost[i] =  a[ny-2, nx-2-i]
      "qv" ghost[i] = -a[ny-2, nx-2-i]    "dh" ghost[i] = -a[ny-1, nx-1-i]
    """
    m = torch.flip(a, dims=(-1,))
    if kind == "h":
        return m[..., -1, :]
    if kind == "u":
        return -torch.roll(m[..., -1, :], -1, dims=-1)
    if kind == "us":
        return torch.roll(m[..., -1, :], -1, dims=-1)
    if kind == "v":
        return -m[..., -2, :]
    if kind == "vs":
        return m[..., -2, :]
    if kind == "q":
        return torch.roll(m[..., -2, :], -1, dims=-1)
    if kind == "qv":
        return -torch.roll(m[..., -2, :], -1, dims=-1)
    if kind == "dh":
        return -m[..., -1, :]
    raise ValueError(f"unknown fold kind {kind!r}")


def jp1_sn(a_s, a_n, fold=None):
    """jp1 of a SOUTH/NORTH edge pair: under the fold the pair swaps.
    Returns (jp1(a_s), jp1(a_n))."""
    if _MESH is not None:
        if fold is None:
            return _MESH.roll_y(a_s, -1), _MESH.roll_y(a_n, -1)
        return (_MESH.roll_y(a_s, -1, "h", ghost_src=a_n),
                _MESH.roll_y(a_n, -1, "h", ghost_src=a_s))
    rs = torch.roll(a_s, -1, dims=_Y)
    rn = torch.roll(a_n, -1, dims=_Y)
    if fold is None:
        return rs, rn
    rs[..., -1, :] = fold_ghost_global(a_n, "h")
    rn[..., -1, :] = fold_ghost_global(a_s, "h")
    return rs, rn


def jm1_s0(a, fold=None):
    """jm1 of a y-face flux with a solid southern wall: with a fold the
    wrapped row read at j=0 is zeroed."""
    r = jm1(a)
    if not fold or not holds_bottom_row():
        return r
    r[..., 0, :] = 0.0
    return r


def fold_kinds(G):
    """("h", "u", "v", "q", "us", "vs") when ``G.fold_north``, else all
    None."""
    if getattr(G, "fold_north", False):
        return "h", "u", "v", "q", "us", "vs"
    return None, None, None, None, None, None
