"""A group of gloo ranks on the CPU for the port's multi-rank tests.

``Ranks(4)`` spawns four processes that join one gloo process group over
``tcp://127.0.0.1`` on a free port chosen at run time (so that xdist
workers never collide), each with one torch thread, and build the
subgroups the tests lay their meshes on: every single rank, the pairs
(0, 1) and (2, 3), and all four.  ``run("module:function", *args)`` calls
``function(ctx, *args)`` on every rank at once and returns the ranks'
results in rank order; ``ctx`` holds the rank and the groups (see
:class:`Context`).  A rank that raises fails the call with its traceback,
and a call that outlasts its time limit stops the group.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import socket
import sys
import traceback

__all__ = ["Ranks", "Context"]

_TIMEOUT_S = int(os.environ.get("MOM6_TEST_TASK_S", "300"))
_COLLECTIVE_S = int(os.environ.get("MOM6_TEST_COLLECTIVE_S", "120"))



class Context:
    """What a task sees of its rank: ``rank``, ``world`` (4), and
    ``group(ranks)`` the process group of those ranks (None for all)."""

    def __init__(self, rank, world, groups):
        self.rank = rank
        self.world = world
        self._groups = groups

    def group(self, ranks):
        ranks = tuple(ranks)
        if len(ranks) == self.world:
            return None
        return self._groups[ranks]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, paths, q_in, q_out):
    sys.path[:0] = [p for p in paths if p not in sys.path]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=_COLLECTIVE_S))
    layouts = [tuple([r]) for r in range(world)]
    layouts += [tuple(range(a, a + 2)) for a in range(0, world, 2)]
    groups = {ranks: dist.new_group(list(ranks)) for ranks in layouts}
    ctx = Context(rank, world, groups)
    while True:
        task = q_in.get()
        if task is None:
            break
        name, args = task
        try:
            mod, fn = name.split(":")
            out = ("ok", getattr(importlib.import_module(mod), fn)(ctx,
                                                                   *args))
        except Exception:                   # reported to the caller
            out = ("error", traceback.format_exc())
        q_out.put(out)
    dist.destroy_process_group()


class Ranks:
    def __init__(self, world: int = 4):
        ctx = mp.get_context("spawn")
        port = _free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        paths = [here, os.path.dirname(here)]
        self.world = world
        self._qs = [(ctx.Queue(), ctx.Queue()) for _ in range(world)]
        self._procs = [ctx.Process(target=_worker,
                                   args=(r, world, port, paths, qi, qo),
                                   daemon=True)
                       for r, (qi, qo) in enumerate(self._qs)]
        for p in self._procs:
            p.start()

    def run(self, name: str, *args):
        """``name`` ("module:function") on every rank; the results in
        rank order."""
        for qi, _ in self._qs:
            qi.put((name, args))
        outs = []
        for r, (_, qo) in enumerate(self._qs):
            try:
                outs.append(qo.get(timeout=_TIMEOUT_S))
            except Exception:
                self.close(kill=True)
                raise RuntimeError(f"rank {r} gave no result for {name}")
        errs = [f"rank {r}:\n{o[1]}" for r, o in enumerate(outs)
                if o[0] == "error"]
        if errs:
            raise RuntimeError("\n".join(errs))
        return [o[1] for o in outs]

    def close(self, kill: bool = False):
        if not kill:
            for qi, _ in self._qs:
                qi.put(None)
        for p in self._procs:
            p.join(timeout=0 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join()
