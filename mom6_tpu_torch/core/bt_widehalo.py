"""Wide-halo (march-inward) barotropic subcycle on a mesh of ranks
(twin of mom6_tpu/core/bt_widehalo.py; the reference's BT_HALO_SIZE /
BTHALO, MOM_barotropic.F90:2506-2518,5450).

On the dense path every shift of the substep body is one exchange with
the neighbour ranks (parallel/mesh.py), a dozen or so a substep.  Here,
as in the reference, every 2-D field the body reads is padded with a
``W``-cell rim filled from the neighbour ranks, and each rank marches
``E = W // halo_per_substep`` substeps (rounded down to an even count)
with local rolls only: what the rim's outer edge gets wrong moves inward
``halo_per_substep`` cells a substep (the body's dependency radius is 2)
and never reaches the tile between exchanges.  The evolving fields
(ubt, vbt, eta, uhbt, vhbt) are exchanged again every E substeps, the
static ones once; each exchange stacks its fields into one message per
neighbour.  A rim is filled in two phases: x (full-height columns), then
y (full-width rows, so that the corners come along).

Divergences from the reference, which zeroes the rims at walls and fills
the top rank row's rim with the fold partner's rows, mirrored, that then
evolve on their own; it holds its wide halo to the dense path at 3e-6.
Here the x and y rims always take the neighbours' cells on the periodic
ring, as the dense path's rolls read them, so that the march is the
dense path's arithmetic cell by cell.  Across the tripolar fold the
dense path reads at every shift the fold ghost of the top row's current
values, and the model's fold line is not single-valued (ROADMAP queue
3), so mirrored rows that evolve on their own part from it.  So the top
rank row receives its fold partner's whole padded tile at every
exchange and marches it beside its own (a leading axis of two), each
shift of the fold line taking its ghost row from the other's top row
(stencil.fold_ghost_global on the padded width); a tile that is its own
partner takes it from itself.  The bottom rank row zeroes the row-0
reads of its south-wall shifts (``jm1_s0``).  The wide halo then equals
the dense path to the bit, the fold included
(tests/test_torch_mesh.py::test_widehalo_*); the fold's partner tile
doubles the body's work on the top rank row.
"""

from __future__ import annotations

import torch

from mom6_tpu_torch.core.continuity_ppm import find_uhbt, find_vhbt
from mom6_tpu_torch.framework.stencil import fold_ghost_global

__all__ = ["run_subcycle_widehalo"]

_T_W, _T_E, _T_S, _T_N, _T_F = 11, 12, 13, 14, 15


class _Rim:
    """The rim exchanges of padded (F, ty+2W, tx+2W) stacks on a mesh;
    ``fold``: the grid's tripolar fold."""

    def __init__(self, mesh, W: int, fold: bool):
        self.m = mesh
        self.W = W
        self.fold = fold
        # whether this tile marches its fold partner's tile beside its own
        self.paired = fold and mesh.top and mesh.fold_partner() != mesh.rank

    def xphase(self, zs):
        """The x rims from the west and east neighbours' core columns."""
        m, W = self.m, self.W
        if m.shape[1] == 1:
            lo, hi = zs[..., :, -2 * W:-W], zs[..., :, W:2 * W]
        else:
            _, _, west, east = m.neighbours()
            hi, lo = m.exchange(
                [(west, zs[..., :, W:2 * W], _T_W),
                 (east, zs[..., :, -2 * W:-W], _T_E)],
                [(east, zs[..., :, W:2 * W].shape, _T_W),
                 (west, zs[..., :, -2 * W:-W].shape, _T_E)], zs)
        zs = zs.clone()
        zs[..., :, -W:] = hi
        zs[..., :, :W] = lo
        return zs

    def yphase(self, zs):
        """The y rims (full width) from the south and north neighbours'
        core rows; with the fold the top rank row's rim above the top is
        never read (the fold line's shifts take the partner's row)."""
        m, W = self.m, self.W
        top_fold = self.fold and m.top
        if m.shape[0] == 1:
            lo = zs[..., -2 * W:-W, :]
            hi = None if top_fold else zs[..., W:2 * W, :]
        else:
            south, north, _, _ = m.neighbours()
            sends = [(north, zs[..., -2 * W:-W, :], _T_S)]
            recvs = [(south, zs[..., -2 * W:-W, :].shape, _T_S)]
            if not (self.fold and m.bottom):
                sends.append((south, zs[..., W:2 * W, :], _T_N))
            if not top_fold:
                recvs.append((north, zs[..., W:2 * W, :].shape, _T_N))
            got = m.exchange(sends, recvs, zs)
            lo = got[0]
            hi = None if top_fold else got[1]
        zs = zs.clone()
        zs[..., :W, :] = lo
        if hi is not None:
            zs[..., -W:, :] = hi
        return zs

    def exchange(self, zs):
        """Both rims; on a paired tile, the stack with the fold partner's
        padded stack beside it (a leading axis of two)."""
        zs = self.yphase(self.xphase(zs))
        if self.paired:
            partner = self.m.fold_partner()
            other, = self.m.exchange([(partner, zs, _T_F)],
                                     [(partner, zs.shape, _T_F)], zs)
            zs = torch.stack([zs, other])
        return zs


def _local_kit(W: int, ty: int, fold_top: bool, paired: bool,
               zero_row0: bool):
    """The substep's shifts on the padded tile: local rolls.  With
    ``fold_top`` (the top rank row of a folded grid) the fold line's
    north neighbour (the tile's top row) is the fold ghost of the
    partner's top row (the other half of a ``paired`` stack, or the tile
    itself); with ``zero_row0`` (the bottom rank row of a folded grid)
    the south-wall shifts read zero at the tile's row 0, as the dense
    path's jm1_s0."""
    top = W + ty - 1

    def ip1(a):
        return torch.roll(a, -1, dims=-1)

    def im1(a):
        return torch.roll(a, 1, dims=-1)

    def jm1(a):
        return torch.roll(a, 1, dims=-2)

    def jp1_fold(kind):
        def jp1(a):
            r = torch.roll(a, -1, dims=-2)
            if not fold_top:
                return r
            upto = a[..., :top + 1, :]
            if paired:
                r[0, ..., top, :] = fold_ghost_global(upto[1], kind)
                r[1, ..., top, :] = fold_ghost_global(upto[0], kind)
            else:
                r[..., top, :] = fold_ghost_global(upto, kind)
            return r
        return jp1

    def jm1_s0(a):
        r = jm1(a)
        if zero_row0:
            r[..., W, :] = 0.0
        return r
    return dict(ip1=ip1, im1=im1, jm1=jm1, jp1_h=jp1_fold("h"),
                jp1_u=jp1_fold("u"), jm1_s0=jm1_s0, jm1_q=jm1_s0)


def _pad(z, W):
    return torch.nn.functional.pad(z, (W, W, W, W))


def run_subcycle_widehalo(F, curves, consts, evolve0, wt_trans, wt_vel,
                          nstep: int, nfilter: int, first_u_leads: bool,
                          W: int, R: int, G, mesh, make_half_step,
                          acc_zero, acc_add):
    """The substeps of btstep in the wide-halo form on ``mesh``: ``F``
    the BTFields of the tile, ``curves`` {"uhbt0", "vhbt0"} and either
    {"Datu", "Datv"} or {"btc"} (the transports' pieces), ``evolve0``
    (ubt, vbt, eta, uhbt, vhbt) of the tile.  Returns the dense runner's
    carry (the filtered averages and the final ubt, vbt, eta), on the
    tile.  Counts its exchanges in ``run_subcycle_widehalo.exchanges``."""
    E = max(2, (W // R) // 2 * 2)       # even substeps per exchange
    if E * R > W:
        raise ValueError(f"wide_halo={W} too small for halo_per_substep="
                         f"{R}: need wide_halo >= {2 * R}")
    ty, tx = F.eta_PF.shape[-2:]
    if min(ty, tx) < W:
        raise ValueError(f"wide_halo={W} exceeds a {ty}x{tx} shard")
    fold = bool(getattr(G, "fold_north", False))
    if fold and F.obc_mask_u is not None:
        raise ValueError("wide-halo OBC + tripolar fold is unsupported")
    n0 = mesh.exchanges
    rim = _Rim(mesh, W, fold)

    # ---- static fields: padded, one stacked rim fill -----------------
    fields = dict(F._asdict())
    fields.update({k: v for k, v in curves.items() if k != "btc"})
    names = [n for n, v in fields.items() if v is not None]
    stack = rim.exchange(torch.stack([_pad(fields[n], W) for n in names]))
    padded = {n: stack[..., i, :, :] for i, n in enumerate(names)}
    btc = curves.get("btc")
    if btc is not None:
        bs = rim.exchange(torch.stack([_pad(t, W) for t in btc]))
        btc = type(btc)(*(bs[..., i, :, :] for i in range(len(btc))))
    Fp = type(F)(**{k: padded.get(k) for k in F._fields})
    uhbt0, vhbt0 = padded["uhbt0"], padded["vhbt0"]
    if btc is not None:
        def transports(ubt, vbt):
            return find_uhbt(ubt, btc) + uhbt0, find_vhbt(vbt, btc) + vhbt0
    else:
        Datu, Datv = padded["Datu"], padded["Datv"]

        def transports(ubt, vbt):
            return Datu * ubt + uhbt0, Datv * vbt + vhbt0
    half_step = make_half_step(
        Fp, consts, _local_kit(W, ty, fold and mesh.top, rim.paired,
                               fold and mesh.bottom), transports)

    def refresh(ev, marched):
        if rim.paired and marched:
            ev = tuple(z[0] for z in ev)        # the partner's comes anew
        s = rim.exchange(torch.stack(ev))
        return tuple(s[..., i, :, :] for i in range(len(ev)))

    ev = tuple(_pad(z, W) for z in evolve0)
    n_tot = nstep + nfilter
    acc = None
    k0 = 0
    while k0 < n_tot:
        n_sub = min(E, n_tot - k0)
        ev = refresh(ev, k0 > 0)
        if acc is None:
            acc = acc_zero(ev[0], ev[1], ev[2])
        ubt, vbt, eta, uhbt, vhbt = ev
        for k in range(n_sub):
            # the global alternation: E is even
            u_leads = first_u_leads if k % 2 == 0 else not first_u_leads
            o = half_step(ubt, vbt, eta, uhbt, vhbt, u_leads)
            acc = acc_add(acc, wt_trans[k0 + k], wt_vel[k0 + k], o)
            ubt, vbt, eta, uhbt, vhbt = o[:5]
        ev = (ubt, vbt, eta, uhbt, vhbt)
        k0 += n_sub
    mine = (0,) if rim.paired else ()
    core = mine + (Ellipsis, slice(W, W + ty), slice(W, W + tx))
    out = {k: v[core] for k, v in acc.items()}
    out["ubt"], out["vbt"], out["eta"] = (ev[0][core], ev[1][core],
                                          ev[2][core])
    run_subcycle_widehalo.exchanges += mesh.exchanges - n0
    return out


run_subcycle_widehalo.exchanges = 0
