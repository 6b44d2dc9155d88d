"""Row-and-column decomposition of the (y, x) plane on torch.distributed
(twin of mom6_tpu/parallel/mesh.py, the role of MOM_domains.F90).

The reference shards the plane over a ``jax.sharding.Mesh`` and lets
GSPMD turn every roll-by-one into a collective permute.  Here each rank
of a process group holds one (y, x) tile of every field, and the halos
are exchanged explicitly: a :class:`Mesh` is one rank's view of a
(Py, Px) layout of the group's ranks, row-major, and while it is active
(``with mesh:``) every shift of framework/stencil.py takes the
neighbour rank's edge row or column through one exchange (point-to-point
``isend``/``irecv``), the analogue of the reference's permute per roll.
An axis that is not split keeps its local roll.  The global topology
stays a ring in both axes, walls made by the masks, as on one device;
the tripolar fold takes the mirrored rows of the partner rank
(py = Py-1, px' = Px-1-px).  Tiles are whole: ny % Py == 0 and
nx % Px == 0, so that every fold partner is a whole tile.

Under gloo, whose point-to-point calls take CPU tensors, the halos of
CUDA tensors are staged through pinned host buffers; under NCCL device
tensors are sent as they are.  Several gloo ranks may share one card;
each rank makes its device the current CUDA device, as the kernels'
``framework/kernels.py::stream_of`` requires.

The reference's ``state_sharding`` and ``constrain_state`` only instruct
XLA's partitioner where to place arrays; eager PyTorch has no compiler
to instruct, and a tile is placed once by :func:`shard_over`, so they
have no counterpart here.  Nor has its ``bind_mesh``: the wide-halo
barotropic subcycle reads the active mesh, as every shift does.

Besides the shifts, a mesh holds the exchanges of a halo of any width
(:meth:`Mesh.pad_y`, :meth:`Mesh.pad_x`, used by the CUDA PPM passes
and the wide-halo barotropic subcycle), the all-reduces of the exact
sums and of the global extrema, the fixed-order moves of whole fields
(:meth:`Mesh.assemble` on every rank, :meth:`Mesh.gather_root` to rank
0, :meth:`Mesh.tile_from_root` back; framework/stencil.py's ``whole``,
``to_root`` and ``from_root``), and counts of its exchanges and of the
bytes it sent (``exchanges``, ``bytes_sent``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mom6_tpu_torch.framework import stencil
from mom6_tpu_torch.framework.containers import tree_map
from mom6_tpu_torch.framework.device import DEFAULT_DEVICE, resolve_device

__all__ = ["Mesh", "make_mesh", "shard_over", "gather", "init_from_env", "shard_model", "check_decomposable",
           "REFUSED_ON_RANKS"]

# message tags inside one exchange (gloo matches a receive by its tag)
_T_X, _T_Y, _T_FOLD, _T_FOLDC = 1, 2, 3, 4


def _factor2d(n: int) -> Tuple[int, int]:
    """Split n devices into the most square (ny, nx) layout (auto-LAYOUT
    analogue of MOM_domains_init)."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def init_from_env() -> None:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless
    one is running: NCCL with a card, gloo without."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method="env://")


class Mesh:
    """One rank's view of a (Py, Px) layout of a process group's ranks
    (row-major: group rank r is the tile (r // Px, r % Px)).

    ``device`` is where this rank's tiles live.  The global plane
    (``ny``, ``nx``) is fixed by the first :func:`shard_over`; a tile
    keeps it with its offsets (``j0``, ``i0``) and its sizes (``ty``,
    ``tx``), for code that needs a global index."""

    def __init__(self, shape: Tuple[int, int], group=None,
                 device="cpu"):
        self.group = group
        if group is None:
            self.ranks = list(range(dist.get_world_size()))
        else:
            self.ranks = list(dist.get_process_group_ranks(group))
        Py, Px = (int(s) for s in shape)
        if Py * Px != len(self.ranks):
            raise ValueError(f"a {Py}x{Px} mesh needs {Py * Px} ranks, the "
                             f"group has {len(self.ranks)}")
        self.shape = (Py, Px)
        self.rank = self.ranks.index(dist.get_rank())
        self.py, self.px = divmod(self.rank, Px)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.ny = self.nx = None
        self.exchanges = 0
        self.bytes_sent = 0
        self._pinned = {}
        self._prev = []

    # ---- layout ---------------------------------------------------------

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def set_plane(self, ny: int, nx: int) -> None:
        """Fix the global plane; refuse tiles that are not whole."""
        Py, Px = self.shape
        if self.ny is not None and (ny, nx) != (self.ny, self.nx):
            raise ValueError(f"the mesh holds a {self.ny}x{self.nx} plane, "
                             f"not {ny}x{nx}")
        if ny % Py or nx % Px:
            raise ValueError(f"a {ny}x{nx} plane does not split into whole "
                             f"tiles on a {Py}x{Px} mesh")
        if ny // Py < 2 or nx // Px < 2:
            raise ValueError(f"a {ny}x{nx} plane on a {Py}x{Px} mesh gives "
                             "tiles under 2 cells on a side")
        self.ny, self.nx = int(ny), int(nx)

    @property
    def ty(self) -> int:
        return self.ny // self.shape[0]

    @property
    def tx(self) -> int:
        return self.nx // self.shape[1]

    @property
    def j0(self) -> int:
        return self.py * self.ty

    @property
    def i0(self) -> int:
        return self.px * self.tx

    def tile_bounds(self):
        """(j0, j1, i0, i1): this rank's rows j0..j1-1, columns i0..i1-1."""
        return self.j0, self.j0 + self.ty, self.i0, self.i0 + self.tx

    def at(self, py: int, px: int) -> int:
        """The group rank of the tile (py, px), both periodic."""
        Py, Px = self.shape
        return (py % Py) * Px + (px % Px)

    def neighbours(self):
        """Group ranks of the (south, north, west, east) tiles, on the
        periodic ring of each axis."""
        return (self.at(self.py - 1, self.px), self.at(self.py + 1, self.px),
                self.at(self.py, self.px - 1), self.at(self.py, self.px + 1))

    def fold_partner(self) -> int:
        """The group rank of the tile that mirrors this x-tile across the
        fold (the top rank row's px' = Px-1-px)."""
        return self.at(self.shape[0] - 1, self.shape[1] - 1 - self.px)

    @property
    def top(self) -> bool:
        """Whether this tile holds the global top row."""
        return self.py == self.shape[0] - 1

    @property
    def bottom(self) -> bool:
        return self.py == 0

    # ---- activation -----------------------------------------------------

    def __enter__(self):
        self._prev.append(stencil._MESH)
        stencil._MESH = self
        return self

    def __exit__(self, *exc):
        stencil._MESH = self._prev.pop()
        return False

    # ---- point-to-point -------------------------------------------------

    def _buffer(self, slot, shape, dtype):
        """The pinned host buffer of a message slot for gloo, one per
        (slot, shape, dtype); every copy in or out of it is blocking, so
        the next exchange may reuse it."""
        key = (slot, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def exchange(self, sends, recvs, like):
        """One exchange: ``sends`` [(group rank, tensor, tag)], ``recvs``
        [(group rank, shape, tag)]; returns the received tensors, in the
        order of ``recvs``, on ``like``'s device.  A message to this rank
        itself is handed over without a copy; an exchange with no other
        rank is not counted."""
        if any(peer != self.rank for peer, _, _ in sends) or any(
                peer != self.rank for peer, _, _ in recvs):
            self.exchanges += 1
        own = {tag: t for peer, t, tag in sends if peer == self.rank}
        out = [None] * len(recvs)
        reqs, bufs, keep = [], [], []
        for n, (peer, shape, tag) in enumerate(recvs):
            if peer == self.rank:
                out[n] = own[tag]
                continue
            if self.staged:
                buf = self._buffer(("r", n), shape, like.dtype)
            else:
                buf = torch.empty(shape, dtype=like.dtype,
                                  device=like.device)
            reqs.append(dist.irecv(buf, src=self.ranks[peer],
                                   group=self.group, tag=tag))
            bufs.append((n, buf))
        for m, (peer, t, tag) in enumerate(sends):
            if peer == self.rank:
                continue
            if self.staged:
                t = self._buffer(("s", m), t.shape, t.dtype).copy_(t)
            else:
                t = t.contiguous()
            keep.append(t)
            self.bytes_sent += t.numel() * t.element_size()
            reqs.append(dist.isend(t, dst=self.ranks[peer],
                                   group=self.group, tag=tag))
        for r in reqs:
            r.wait()
        for n, buf in bufs:
            out[n] = buf.to(like.device) if self.staged else buf
        return out

    # ---- shifts of the stencils ----------------------------------------

    def _check(self, a):
        if a.shape[-2:] != (self.ty, self.tx):
            raise ValueError(f"a shift on the mesh takes a (..., {self.ty}, "
                             f"{self.tx}) tile, not {tuple(a.shape)}")

    def roll_x(self, a, k: int):
        """torch.roll(a, k, -1) of the global field, k = +-1."""
        if self.shape[1] == 1:
            return torch.roll(a, k, dims=-1)
        self._check(a)
        _, _, west, east = self.neighbours()
        if k == -1:
            got, = self.exchange([(west, a[..., :, :1], _T_X)],
                                 [(east, a.shape[:-1] + (1,), _T_X)], a)
            return torch.cat([a[..., :, 1:], got], dim=-1)
        got, = self.exchange([(east, a[..., :, -1:], _T_X)],
                             [(west, a.shape[:-1] + (1,), _T_X)], a)
        return torch.cat([got, a[..., :, :-1]], dim=-1)

    def _fold_msgs(self, src, kind, w=1):
        """The messages of ``w`` fold ghost rows: the top ``w + 1`` rows of
        ``src`` to the partner, and for the kinds staggered by one column
        also their last column to the tile (Py-1, Px-2-px)."""
        Px = self.shape[1]
        rows = src[..., -(w + 1):, :]
        partner = self.fold_partner()
        sends = [(partner, rows, _T_FOLD)]
        recvs = [(partner, rows.shape, _T_FOLD)]
        if kind in ("u", "us", "q", "qv"):
            other = self.at(self.shape[0] - 1, Px - 2 - self.px)
            sends.append((other, rows[..., :, -1:], _T_FOLDC))
            recvs.append((other, rows.shape[:-1] + (1,), _T_FOLDC))
        return sends, recvs

    @staticmethod
    def _ghost(got, kind):
        """The fold ghost row from the partner's top rows (and the column
        west of them): the tile form of stencil.fold_ghost."""
        rows = got[0]
        if kind in ("u", "us", "q", "qv"):
            b = torch.cat([got[1], rows[..., :, :-1]], dim=-1)
        else:
            b = rows
        r = 1 if kind in ("h", "dh", "u", "us") else 0
        g = torch.flip(b[..., r, :], dims=(-1,))
        if kind in ("u", "v", "qv", "dh"):
            g = -g
        return g

    def fold_ghost(self, a, kind):
        """The fold ghost row of the tile ``a`` on the top rank row; None
        (and no message) elsewhere."""
        if not self.top:
            return None
        self._check(a)
        sends, recvs = self._fold_msgs(a, kind)
        return self._ghost(self.exchange(sends, recvs, a), kind)

    def roll_y(self, a, k: int, fold=None, ghost_src=None):
        """torch.roll(a, k, -2) of the global field, k = +-1; with
        ``fold`` (k = -1 only) the top row takes the fold ghost of
        ``ghost_src`` (``a`` by default) of that kind."""
        Py = self.shape[0]
        if k == 1 and fold is not None:
            raise ValueError("the fold is a boundary of the plus side")
        if Py == 1 and (fold is None or self.shape[1] == 1):
            r = torch.roll(a, k, dims=-2)
            if fold is not None:
                r[..., -1, :] = stencil.fold_ghost_global(
                    a if ghost_src is None else ghost_src, fold)
            return r
        self._check(a)
        south, north, _, _ = self.neighbours()
        sends, recvs = [], []
        ring = Py > 1
        if k == -1:
            edge_to, edge_from = south, north
            edge = a[..., :1, :]
            # with the fold the top row reads the partner, not the ring
            if ring and not (fold is not None and self.bottom):
                sends.append((edge_to, edge, _T_Y))
            if ring and not (fold is not None and self.top):
                recvs.append((edge_from, edge.shape, _T_Y))
        else:
            edge = a[..., -1:, :]
            sends.append((north, edge, _T_Y))
            recvs.append((south, edge.shape, _T_Y))
        nring = len(recvs)
        if fold is not None and self.top:
            fs, fr = self._fold_msgs(a if ghost_src is None else ghost_src,
                                     fold)
            sends += fs
            recvs += fr
        got = self.exchange(sends, recvs, a)
        if k == 1:
            return torch.cat([got[0], a[..., :-1, :]], dim=-2)
        if fold is not None and self.top:
            last = self._ghost(got[nring:], fold).unsqueeze(-2)
        else:
            last = got[0]
        return torch.cat([a[..., 1:, :], last], dim=-2)

    # ---- halos of a given width ----------------------------------------

    def pad_x(self, a, w: int):
        """``a`` with ``w`` columns of the west and east tiles on each
        side (the global field's periodic neighbours)."""
        if self.shape[1] == 1:
            return torch.cat([a[..., :, -w:], a, a[..., :, :w]], dim=-1)
        self._check(a)
        if w > self.tx:
            raise ValueError(f"a halo of {w} is wider than a tile")
        _, _, west, east = self.neighbours()
        lo, hi = self.exchange(
            [(east, a[..., :, -w:], _T_X), (west, a[..., :, :w], _T_FOLD)],
            [(west, a.shape[:-1] + (w,), _T_X),
             (east, a.shape[:-1] + (w,), _T_FOLD)], a)
        return torch.cat([lo, a, hi], dim=-1)

    def pad_y(self, a, w: int, fold=None, ghost_src=None, south=True):
        """``a`` with ``w`` rows of the south and north tiles on each
        side (``south=False``: the north side only).  With ``fold`` (a
        kind of stencil.fold_ghost, ``w`` <= 2) the top rank row's rows
        above the top are the fold's ghost rows of ``ghost_src`` (``a``
        by default): row k above the top is the image of row ny-k (the
        fold line's own kinds h, dh, u and us) or ny-1-k (v, vs, q and
        qv), as the fold_ghost of each row."""
        if w > self.ty:
            raise ValueError(f"a halo of {w} is wider than a tile")
        if fold is not None and w > 2:
            raise ValueError("the fold's ghost rows are at most two")
        s_rank, n_rank, _, _ = self.neighbours()
        sends, recvs = [], []
        fold_top = fold is not None and self.top
        if south:
            sends.append((n_rank, a[..., -w:, :], _T_X))
            recvs.append((s_rank, a.shape[:-2] + (w, a.shape[-1]), _T_X))
        if not (fold is not None and self.bottom):
            sends.append((s_rank, a[..., :w, :], _T_Y))
        if not fold_top:
            recvs.append((n_rank, a.shape[:-2] + (w, a.shape[-1]), _T_Y))
        nring = len(recvs)
        if fold_top:
            fs, fr = self._fold_msgs(a if ghost_src is None else ghost_src,
                                     fold, w)
            sends += fs
            recvs += fr
        got = self.exchange(sends, recvs, a)
        parts = [got[0]] if south else []
        parts.append(a)
        if fold_top:
            parts.append(torch.stack(
                [self._ghost(self._shift_block(got[nring:], k), fold)
                 for k in range(w)], dim=-2))
        else:
            parts.append(got[nring - 1])
        return torch.cat(parts, dim=-2)

    def top_row_image(self, a):
        """On the bottom rank row (of a mesh of two rank rows or more):
        the fold image of the global top row of ``a`` over this tile's
        columns (its "h" ghost row), sent by the top rank row.  None on
        the other ranks."""
        Py, Px = self.shape
        partner = self.at(Py - 1, Px - 1 - self.px)
        sends, recvs = [], []
        if self.top:
            sends.append((self.at(0, Px - 1 - self.px), a[..., -1:, :],
                          _T_FOLD))
        if self.bottom:
            recvs.append((partner, a.shape[:-2] + (1, a.shape[-1]),
                          _T_FOLD))
        if not sends and not recvs:
            return None
        got = self.exchange(sends, recvs, a)
        if not self.bottom:
            return None
        return torch.flip(got[0][..., 0, :], dims=(-1,))

    @staticmethod
    def _shift_block(got, k):
        """The partner block as :meth:`_ghost` reads it for the ghost row
        ``k + 1`` above the top: the two rows ending ``k`` rows down."""
        n = got[0].shape[-2]
        sl = slice(n - 2 - k, n - k)
        return [g[..., sl, :] for g in got]

    # ---- reductions -----------------------------------------------------

    def _comm(self, t):
        """A copy of ``t`` where the backend takes it: the host for gloo,
        the mesh's device for NCCL."""
        if self.backend == "gloo":
            return t.to("cpu", copy=True).contiguous()
        return t.to(self.device, copy=True).contiguous()

    def _reduce(self, t, op):
        if self.size == 1 and self.backend != "nccl":
            return t
        x = self._comm(t)
        dist.all_reduce(x, op=op, group=self.group)
        return x.to(t.device)

    def all_sum(self, t):
        """The all-reduce SUM of an integer tensor (exact)."""
        if t.is_floating_point():
            raise TypeError("all_sum adds integers only: a float sum would "
                            "depend on the rank count")
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t):
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_min(self, t):
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t):
        """[the tensor of each group rank], in rank order, on ``t``'s
        device."""
        if self.size == 1:
            return [t]
        x = self._comm(t)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return [o.to(t.device) for o in out]

    def _place(self, parts):
        """The global field of the tiles ``parts``, in rank order."""
        Px = self.shape[1]
        rows = [torch.cat(parts[r * Px:(r + 1) * Px], dim=-1)
                for r in range(self.shape[0])]
        return torch.cat(rows, dim=-2)

    def assemble(self, t):
        """The global field of the tile ``t`` (..., ty, tx) on every rank
        of the mesh."""
        return self._place(self.all_gather(t))

    def gather_root(self, t):
        """The global field of the tile ``t`` (..., ty, tx) on the mesh's
        rank 0, its tiles placed in rank order, and None on the other
        ranks (every rank must call it)."""
        if self.size == 1 and self.backend != "nccl":
            return t
        x = self._comm(t)
        parts = ([torch.empty_like(x) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(x, gather_list=parts, dst=self.ranks[0],
                    group=self.group)
        if self.rank != 0:
            return None
        return self._place(parts).to(t.device)

    def tile_from_root(self, a, like):
        """This rank's tile of the global field ``a`` (..., ny, nx) that
        the mesh's rank 0 holds (``a`` is not read on the other ranks),
        with the shape, dtype and device of the tile ``like``."""
        if self.size == 1 and self.backend != "nccl":
            return a.to(device=like.device, dtype=like.dtype).reshape(
                like.shape)
        x = torch.empty(like.shape, dtype=like.dtype,
                        device="cpu" if self.backend == "gloo"
                        else self.device)
        parts = None
        if self.rank == 0:
            a = a.to(device=x.device, dtype=like.dtype).reshape(
                like.shape[:-2] + (self.ny, self.nx))
            parts = [a[..., py * self.ty:(py + 1) * self.ty,
                       px * self.tx:(px + 1) * self.tx].contiguous()
                     for py in range(self.shape[0])
                     for px in range(self.shape[1])]
        dist.scatter(x, scatter_list=parts, src=self.ranks[0],
                     group=self.group)
        return x.to(like.device)

    def broadcast_object(self, obj):
        """The picklable ``obj`` of the mesh's rank 0 on every rank."""
        if self.size == 1:
            return obj
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]

    def broadcast_from(self, t, owner: int):
        """The tensor ``t`` of the group rank ``owner`` on every rank."""
        if self.size == 1:
            return t
        x = self._comm(t)
        dist.broadcast(x, src=self.ranks[owner], group=self.group)
        return x.to(t.device)


def make_mesh(shape: Optional[Tuple[int, int]] = None, group=None,
              device=DEFAULT_DEVICE) -> Mesh:
    """This rank's :class:`Mesh` of ``group`` (the default group; started
    from torchrun's environment when none is running, the counterpart of
    ``jax.devices()``), laid out as ``shape`` or the most square layout of
    the group's size.  ``device``: the card (one per local rank, the
    default) or ``"cpu"``; ``"cuda:0"`` puts every rank on one card."""
    init_from_env()
    n = dist.get_world_size(group)
    if shape is None:
        shape = _factor2d(n)
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(shape, group=group, device=dev)


def _tile_of(mesh: Mesh, x):
    j0, j1, i0, i1 = mesh.tile_bounds()
    return x[..., j0:j1, i0:i1].contiguous().to(mesh.device)


def _plane_of(tree):
    """The (ny, nx) of a model tree: its grid's, or the trailing shape of
    its first tensor of two or more dimensions."""
    found = []

    def look(x):
        if not found and x.dim() >= 2:
            found.append(tuple(x.shape[-2:]))
        return x
    for leaf in (tree if isinstance(tree, tuple) else (tree,)):
        if hasattr(leaf, "mask2dT") and getattr(leaf, "mask2dT") is not None:
            return tuple(leaf.mask2dT.shape)
    tree_map(look, tree)
    if not found:
        raise ValueError("shard_over: no field of two dimensions")
    return found[0]


def shard_over(mesh: Mesh, tree):
    """This rank's tile of every (..., ny, nx) tensor of ``tree`` (a
    grid, a state, a forcing, the parameters, or a tuple of them), moved
    to the rank's device; any other tensor is moved as it is.  A grid's
    ``nx``/``ny`` become the tile's.  Fixes the mesh's global plane
    (ny, nx) on first use."""
    ny, nx = _plane_of(tree)
    mesh.set_plane(ny, nx)

    def cut(x):
        if x.dim() >= 2 and tuple(x.shape[-2:]) == (ny, nx):
            return _tile_of(mesh, x)
        return x.to(mesh.device)
    out = tree_map(cut, tree)
    return _retile_grids(out, mesh)


def _retile_grids(tree, mesh):
    from mom6_tpu_torch.grid.grid import Grid
    if isinstance(tree, Grid):
        return tree.replace(ny=mesh.ty, nx=mesh.tx)
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_retile_grids(t, mesh) for t in tree)
    return tree


def gather(mesh: Mesh, tree):
    """The inverse of :func:`shard_over`: every tile field of ``tree``
    assembled into its global field on rank 0 of the mesh (None on the
    other ranks; every rank must call it)."""
    def put(x):
        if x.dim() >= 2 and tuple(x.shape[-2:]) == (mesh.ty, mesh.tx):
            return mesh.gather_root(x)
        return x
    out = tree_map(put, tree)
    if mesh.rank != 0:
        return None
    from mom6_tpu_torch.grid.grid import Grid
    if isinstance(out, Grid):
        out = out.replace(ny=mesh.ny, nx=mesh.nx)
    return out


# the options whose whole-domain work is not decomposed over ranks: (the
# model parameters' field, the option), refused by shard_model.  None is
# left: the whole-domain sums, transforms and draws of SAL_HARMONICS,
# HOMOGENIZE_FORCINGS, ICE_SHELF's SSA and SPPT/SKEB assemble the fields
# they read (framework/stencil.py::whole), and the open boundaries'
# masks and data are dense fields cut with the rest.
REFUSED_ON_RANKS = ()


def check_decomposable(params) -> None:
    """Raise NotImplementedError naming the first option of the model
    parameters (MOMParams or DynParams) that :data:`REFUSED_ON_RANKS`
    lists."""
    for field, option in REFUSED_ON_RANKS:
        v = getattr(params, field, None)
        if v is not None and v is not False and not (
                isinstance(v, (int, float)) and v == 0):
            raise NotImplementedError(
                f"{option} is not decomposed over ranks: run it on one rank")


def shard_model(mesh: Mesh, G, GV, state, params, forcing):
    """This rank's share of a model built whole: the options refused on
    ranks checked (:func:`check_decomposable`) and every field cut to the
    tile on the mesh's device (:func:`shard_over`).  Returns (G, GV,
    state, params, forcing)."""
    check_decomposable(params)
    return shard_over(mesh, (G, GV, state, params, forcing))
