"""The ensemble on one device (twin of the single-device half of
mom6_tpu/parallel/ensemble.py, the role of MOM_ensemble_manager.F90):
member states stacked along a new leading axis.

The reference vmaps the step over that axis.  Here ``ensemble_step`` runs
the step member by member on views of the stacked state and stacks the
results: ``torch.func.vmap`` has no batching rule for the port's CUDA
kernels, and folding the members into a kernel's batch would change
every kernel's shapes and its launch geometry.  A step of ne members
therefore makes ne times a member's launches.

The mesh half spreads the members over ranks: :func:`ensemble_mesh` lays
the group's ranks out as (member, y, x), the member axis outermost, each
member on its own (Py, Px) mesh of parallel/mesh.py (the reference's
concurrent-ensemble PE lists, MOM_ensemble_manager.F90
ensemble_pelist_setup); :func:`shard_ensemble` gives a rank its
member's tile, :func:`ensemble_step_sharded` steps it on that mesh, and
:func:`ensemble_mean_sharded` gathers the members' tiles over the ranks
that hold the same tile and adds them in member order, as
:func:`ensemble_mean` does on one device, so that every result is the
one-process result to the bit.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from mom6_tpu_torch.framework.arith import sdiv, vsum
from mom6_tpu_torch.framework.containers import tree_map

__all__ = ["stack_ensemble", "member", "ensemble_mean", "ensemble_step",
           "EnsembleMesh", "ensemble_mesh", "shard_ensemble",
           "ensemble_step_sharded", "ensemble_mean_sharded",
           "gather_ensemble"]


def stack_ensemble(states: Sequence):
    """The member states stacked along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def member(ens_state, i: int):
    """Member ``i`` of a stacked state (views of its tensors)."""
    return tree_map(lambda x: x[i], ens_state)


def ensemble_mean(ens_state):
    """The members' mean of every floating-point tensor, the members
    added in order; any other tensor (the threefry key) is member 0's."""
    def mean(x):
        if not x.is_floating_point():
            return x[0]
        return sdiv(vsum(x), x.shape[0])
    return tree_map(mean, ens_state)


def ensemble_step(step_fn: Callable) -> Callable:
    """``step_fn(state, *args) -> state`` over the member axis: each
    member, with member ``i`` of every argument (each with its own member
    axis, such as per-member increments), in turn."""
    def run(ens_state, *args):
        sizes = []
        tree_map(lambda x: sizes.append(x.shape[0]), ens_state)
        return stack_ensemble([
            step_fn(member(ens_state, i), *(member(a, i) for a in args))
            for i in range(sizes[0])])
    return run


class EnsembleMesh:
    """One rank's place in a (member, y, x) layout: ``member`` the member
    it steps, ``spatial`` the Mesh of that member's ranks, ``n_members``,
    and ``member_group`` the process group of the ranks that hold this
    rank's tile of every member (in member order)."""

    def __init__(self, n_members, spatial, member, member_group):
        self.n_members = n_members
        self.spatial = spatial
        self.member = member
        self.member_group = member_group

    def all_members(self, t):
        """The tile ``t`` of every member, stacked in member order (along
        a new leading axis) on every rank of the member group."""
        import torch.distributed as dist
        if self.n_members == 1:
            return t[None]
        x = self.spatial._comm(t)
        out = [torch.empty_like(x) for _ in range(self.n_members)]
        dist.all_gather(out, x, group=self.member_group)
        return torch.stack(out).to(t.device)


def ensemble_mesh(n_members: int, spatial_shape=(1, 1), group=None,
                  device=None) -> EnsembleMesh:
    """This rank's place in an (n_members, Py, Px) layout of ``group``'s
    ranks (the default group): member m on the ranks m*Py*Px ..
    (m+1)*Py*Px - 1, each member's tiles row-major.  Every rank of the
    group must call it (it makes the subgroups)."""
    import torch.distributed as dist
    from mom6_tpu_torch.framework.device import DEFAULT_DEVICE
    from mom6_tpu_torch.parallel.mesh import Mesh, init_from_env
    init_from_env()
    ranks = (list(range(dist.get_world_size())) if group is None
             else list(dist.get_process_group_ranks(group)))
    my, mx = spatial_shape
    per = my * mx
    need = n_members * per
    if len(ranks) != need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    me = ranks.index(dist.get_rank())
    m, t = divmod(me, per)
    spatial = [dist.new_group(ranks[k * per:(k + 1) * per])
               for k in range(n_members)]
    across = [dist.new_group([ranks[k * per + u] for k in range(n_members)])
              for u in range(per)]
    mesh = Mesh((my, mx), group=spatial[m],
                device=DEFAULT_DEVICE if device is None else device)
    return EnsembleMesh(n_members, mesh, m, across[t])


def shard_ensemble(ens_state, emesh: EnsembleMesh):
    """This rank's share of a stacked ensemble: its member (a member axis
    of one) on its tile of that member's mesh."""
    from mom6_tpu_torch.parallel.mesh import shard_over
    m = emesh.member
    return shard_over(emesh.spatial, tree_map(lambda x: x[m:m + 1],
                                               ens_state))


def ensemble_step_sharded(step_fn: Callable, emesh: EnsembleMesh):
    """``step_fn(state, *args) -> state`` over this rank's members on its
    member's mesh (the arguments each with their own member axis, as in
    :func:`ensemble_step`); the members on other ranks step at once."""
    run = ensemble_step(step_fn)

    def step(ens_local, *args):
        with emesh.spatial:
            return run(ens_local, *args)
    return step


def ensemble_mean_sharded(ens_local, emesh: EnsembleMesh):
    """The members' mean of this rank's tile, every member's tile
    gathered over the member group and added in member order (the
    :func:`ensemble_mean` of one process, to the bit)."""
    def mean(x):
        if not x.is_floating_point():
            return x[0]
        return sdiv(vsum(emesh.all_members(x[0])), emesh.n_members)
    return tree_map(mean, ens_local)


def gather_ensemble(ens_local, emesh: EnsembleMesh):
    """The stacked global ensemble on the group's first rank (None on the
    others): each member's tiles assembled, the members stacked in
    order.  Every rank must call it."""
    from mom6_tpu_torch.parallel.mesh import gather
    whole = gather(emesh.spatial, ens_local)
    if emesh.spatial.rank != 0:
        return None
    out = tree_map(lambda x: emesh.all_members(x[0]), whole)
    return out if emesh.member == 0 else None
