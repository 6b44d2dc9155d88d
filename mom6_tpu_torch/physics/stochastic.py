"""Stochastic physics: SPPT and an SKEB-style backscatter (twin of
mom6_tpu/physics/stochastic.py; MOM_stochastics.F90:452).

The pattern is a first-order autoregressive field smoothed in space: red
in time, correlated in space, drawn from the port's threefry
(framework/random.py), which draws the reference's streams, so that a
run restarts from its key and patterns alone.

On a tripolar grid the two choices at the fold (ROADMAP §3):

* ``_smooth`` wraps in y as the reference's does (its top row reads row
  0, land on every tripolar grid the port builds): matched.  The pattern
  is noise of unit variance rescaled after smoothing; no budget depends
  on its top row.
* ``apply_skeb`` repaired.  The reference's increment from the pattern at
  q points, dv = psi - psi(i-1), is not antisymmetric on the fold line
  (v(ny-1, i) is -v(ny-1, nx-1-i) there), so the two copies of a fold face
  would carry different transports and the fold would leak volume.  The
  port takes the q row on the fold line as the mean of psi and its fold
  image (q(ny-1, i) is q(ny-1, nx-2-i)), so that psi is single-valued
  there and dv antisymmetric; the rows below are the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_tpu_torch.framework.random import normal, split
from mom6_tpu_torch.framework.stencil import (fold_ghost, global_plane, im1,
                                              ip1, jm1, jp1, off_mesh, tile)

__all__ = ["SPPTParams", "ar1_pattern", "apply_sppt", "apply_skeb"]


@dataclasses.dataclass(frozen=True)
class SPPTParams:
    amplitude: float = 0.5       # the pattern's standard deviation
    tau: float = 6.0 * 3600.0    # decorrelation time [s]
    smooth_passes: int = 4       # spatial smoothing (sets the length scale)
    clip: float = 0.8


def _smooth(x, n: int):
    for _ in range(n):
        x = 0.5 * x + 0.125 * ((ip1(x) + im1(x)) + (jp1(x) + jm1(x)))
    return x


def ar1_pattern(pattern, key, dt: float, p: SPPTParams):
    """The pattern advanced one step of ``dt`` [s]: (new pattern, new
    key).  The noise is drawn in the pattern's dtype on its device."""
    keys = split(key)
    key, sub = keys[0], keys[1]
    # the scalars in the run's dtype on the host, as the reference's
    # 0-dim arrays
    npd = np.float32 if pattern.dtype == torch.float32 else np.float64
    phi = np.exp(npd(-dt / p.tau))
    scale = np.sqrt(np.maximum(npd(1.0) - phi * phi, npd(0.0))) \
        * npd(p.amplitude)
    shape = tuple(pattern.shape[:-2]) + global_plane(pattern)
    with off_mesh():
        noise = _smooth(normal(sub, shape, pattern.dtype), p.smooth_passes)
        # renormalized to unit variance
        noise = noise / torch.clamp(torch.std(noise, correction=0),
                                    min=1e-12)
    return float(phi) * pattern + float(scale) * tile(noise), key


def apply_sppt(tendency, pattern, p: SPPTParams):
    """The (diabatic) tendency times (1 + the clipped pattern), the SPPT
    perturbation of Buizza et al."""
    r = torch.clamp(pattern, -p.clip, p.clip)
    return tendency * (1.0 + r)[None]


def apply_skeb(u, v, pattern, ke_scale: float, G=None):
    """The backscatter's rotational increment of (u, v) from the pattern
    as a streamfunction at q points: u += -dpsi/dy, v += dpsi/dx, exactly
    divergence-free on the C grid.  With ``G`` a tripolar grid, psi's
    fold row is made single-valued first (see the module's note)."""
    psi = pattern * ke_scale
    if G is not None and getattr(G, "fold_north", False):
        image = fold_ghost(psi, "us")
        if image is not None:
            psi = torch.cat([psi[:-1], (0.5 * (psi[-1] + image))[None]])
    du = -(psi - jm1(psi))
    dv = psi - im1(psi)
    return u + du[None], v + dv[None]
