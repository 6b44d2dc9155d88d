"""Sponge layers: restoring toward reference profiles in damping regions
(twin of mom6_tpu/physics/vertical/sponge.py: SpongeParams and
apply_sponge; MOM_ALE_sponge.F90).

Tracers (and optionally velocities) relax implicitly toward their
references with a spatially varying inverse damping time,

    X_new = (X + dt idamp X_ref) / (1 + dt idamp),

unconditionally stable.  The references live on the model's grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_tpu_torch.framework.arith import rdiv
from mom6_tpu_torch.framework.containers import (TensorDataclass,
                                                 fields_equal)
from mom6_tpu_torch.framework.stencil import ip1, jp1

__all__ = ["SpongeParams", "apply_sponge"]


@dataclasses.dataclass(frozen=True, eq=False)
class SpongeParams(TensorDataclass):
    """Two are equal when every field is, tensors to the bit."""
    idamp: Optional[torch.Tensor] = None    # (ny, nx) inverse damping [s-1]
    T_ref: Optional[torch.Tensor] = None    # (nz, ny, nx)
    S_ref: Optional[torch.Tensor] = None
    u_ref: Optional[torch.Tensor] = None
    v_ref: Optional[torch.Tensor] = None
    sponge_uv: bool = False

    def __eq__(self, other):
        if not isinstance(other, SpongeParams):
            return NotImplemented
        return fields_equal(self, other)


def apply_sponge(state, dt, p: SpongeParams, G):
    """Implicit relaxation of T and S (and u and v) toward the
    references."""
    w = dt * p.idamp * G.mask2dT                 # (ny, nx)
    denom = rdiv(1.0, 1.0 + w)

    def relax(x, ref):
        if x is None or ref is None:
            return x
        return (x + w[None] * ref) * denom[None]

    out = state
    if state.T is not None and p.T_ref is not None:
        out = out.replace(T=relax(state.T, p.T_ref))
    if state.S is not None and p.S_ref is not None:
        out = out.replace(S=relax(state.S, p.S_ref))
    if p.sponge_uv:
        wu = dt * 0.5 * (p.idamp + ip1(p.idamp)) * G.mask2dCu
        wv = dt * 0.5 * (p.idamp + jp1(p.idamp)) * G.mask2dCv
        if p.u_ref is not None:
            out = out.replace(u=(state.u + wu[None] * p.u_ref)
                              / (1 + wu[None]))
        if p.v_ref is not None:
            out = out.replace(v=(state.v + wv[None] * p.v_ref)
                              / (1 + wv[None]))
    return out
