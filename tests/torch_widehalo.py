"""Checks of BT_WIDE_HALO off a mesh, shared by the port's test files.

BT_WIDE_HALO sets the rim of the wide-halo barotropic subcycle, which
runs on a mesh of ranks (tests/test_torch_mesh.py holds it there against
the dense path).  Off a mesh the wide halo is off, as on the reference's
single device: a build that sets it reads the width and is otherwise the
build without it, and a step with it set is the step without it to the
bit.
"""

from __future__ import annotations

import re

import torch

from mom6_tpu_torch.framework.containers import tensor_fields

__all__ = ["without_wide_halo", "assert_build_reads_wide_halo",
           "assert_step_ignores_wide_halo", "with_width"]


def without_wide_halo(text: str) -> str:
    """``text`` without its BT_WIDE_HALO line."""
    return re.sub(r"BT_WIDE_HALO *= *-?\d+\n?", "", text)


def with_width(params, width: int):
    """Model parameters (MOMParams or DynParams) with the wide halo's
    width set."""
    if hasattr(params, "dyn"):
        return params.replace(dyn=params.dyn.replace(
            bt=params.dyn.bt.replace(wide_halo=width)))
    return params.replace(bt=params.bt.replace(wide_halo=width))


def assert_build_reads_wide_halo(build, text: str):
    """``build(text)`` (a ModelSetup) reads BT_WIDE_HALO's width and
    equals ``build`` of the text without it in every tensor and in every
    other parameter."""
    width = int(re.search(r"BT_WIDE_HALO *= *(-?\d+)", text).group(1))
    ms = build(text)
    base = build(without_wide_halo(text))
    bt = ms.params.dyn.bt if hasattr(ms.params, "dyn") else ms.params.bt
    assert bt.wide_halo == width
    want = with_width(base.params, width)
    if getattr(ms.params, "tfc", None) is not None:
        want = want.replace(tfc=ms.params.tfc)    # packages by identity
    assert ms.params == want
    for a, b in ((ms.grid, base.grid), (ms.vgrid, base.vgrid),
                 (ms.state, base.state)):
        for name, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), t), name
    return ms


def assert_step_ignores_wide_halo(step, params, width: int, fields):
    """``step(params)`` with the wide halo's width set equals it without,
    to the bit, in ``fields`` of the returned state."""
    with torch.inference_mode():
        want = step(with_width(params, 0))
        got = step(with_width(params, width))
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a, b), k
    return got
