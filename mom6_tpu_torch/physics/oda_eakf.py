"""The ensemble adjustment Kalman filter (twin of
mom6_tpu/physics/oda_eakf.py; Anderson 2001, the role of the ECDA path
of MOM_oda_driver.F90).  For each point observation with value yo and
error variance r, in turn:

  1. the observed element y_e of each member, mean ybar, variance s;
  2. s_a = s r / (s + r), ybar_a = s_a (ybar / s + yo / r);
  3. dy_e = (ybar_a - ybar) + (sqrt(s_a / s) - 1) (y_e - ybar);
  4. x_e += cov(x, y) / s * dy_e over every state element, optionally
     times the Gaspari-Cohn taper of the grid distance.

The reference's ``lax.scan`` over the observations is a loop here: the
observations' indices are host integers, so the loop queues its
operations on the ensemble's device without a synchronisation.  Sums
over the members add them in order (``vsum``), as XLA's reduction does,
the regression ``yp @ xp`` too (the reference's dot adds in the BLAS
library's order: in float64 the update parts from the reference's by
~1e-13 of it, in float32 by the conditioning of the sums); an ordered
sum keeps each element's update independent of how the state vector is
cut into tiles, so that the analysis on a mesh of ranks
(physics/oda_driver.py) is the one-process analysis to the bit.  The
observed element may come from elsewhere (``observed``: another rank's
tile) with its grid place (``obs_coords``).  Square roots
are ``framework/arith.py::csqrt``, ``x ** 2`` is ``x * x`` (JAX's
integer_pow) and a division by a number divides once (``sdiv``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mom6_tpu_torch.framework.arith import csqrt, rdiv, sdiv, vsum

__all__ = ["EAKFParams", "eakf_update", "gaspari_cohn"]


@dataclasses.dataclass(frozen=True)
class EAKFParams:
    inflation: float = 1.0        # multiplicative prior inflation
    loc_radius: float = 0.0       # localization half-radius [cells]; 0 = off
    s_min: float = 1e-12          # prior-variance floor


def gaspari_cohn(d, c: float):
    """Gaspari & Cohn (1999)'s compactly supported correlation of the
    distance ``d`` for the half-width ``c`` (support 2c)."""
    x = sdiv(torch.abs(d), max(c, 1e-30))
    f1 = (((-0.25 * x + 0.5) * x + 0.625) * x - 5.0 / 3.0) * (x * x) + 1.0
    f2 = ((((sdiv(x, 12.0) - 0.5) * x + 0.625) * x + 5.0 / 3.0) * x
          - 5.0) * x + 4.0 - rdiv(2.0, 3.0 * torch.clamp(x, min=1e-10))
    zero = torch.zeros_like(x)
    return torch.where(x <= 1.0, f1, torch.where(x <= 2.0, f2, zero))


def _member_mean(x):
    """The mean over the members (axis 0), added in order."""
    return sdiv(vsum(x, keepdim=True), x.shape[0])


def eakf_update(ens, obs_idx, obs_val, obs_var,
                p: EAKFParams = EAKFParams(),
                coords: Optional[torch.Tensor] = None,
                observed=None, obs_coords: Optional[torch.Tensor] = None):
    """The sequential EAKF over point observations.

    ens:      (ne, n) members of the flattened state;
    obs_idx:  (n_obs,) indices into the state vector (the H rows),
              integers on the host (numpy or a list) or a tensor;
    obs_val:  (n_obs,) observed values;
    obs_var:  (n_obs,) observation error variances;
    coords:   optional (n, 2) grid coordinates of the state elements for
              the Gaspari-Cohn localization (with p.loc_radius > 0);
    observed: optional ``observed(o, i, ens) -> (ne,)``, the members'
              observed element of observation ``o`` (default ens[:, i]);
    obs_coords: optional (n_obs, 2) coordinates of the observations
              (default coords[i]).

    Returns the updated (ne, n) ensemble."""
    ne = ens.shape[0]
    if p.inflation != 1.0:
        mean = _member_mean(ens)
        ens = mean + p.inflation * (ens - mean)
    use_loc = p.loc_radius > 0.0 and coords is not None
    idx = np.asarray(obs_idx.cpu() if torch.is_tensor(obs_idx)
                     else obs_idx).astype(np.int64)
    yo_all = torch.as_tensor(obs_val, dtype=ens.dtype).to(ens.device)
    r_all = torch.as_tensor(obs_var, dtype=ens.dtype).to(ens.device)
    for o, i in enumerate(idx.tolist()):
        yo, r = yo_all[o], r_all[o]
        y = ens[:, i] if observed is None else observed(o, i, ens)
        ybar = sdiv(vsum(y), ne)
        yp = y - ybar
        s = torch.clamp(sdiv(vsum(yp * yp), ne - 1), min=p.s_min)
        s_a = s * r / (s + r)
        ybar_a = s_a * (ybar / s + yo / r)
        shrink = csqrt(s_a / s)
        dy = (ybar_a - ybar) + (shrink - 1.0) * yp
        xp = ens - _member_mean(ens)
        gain = sdiv(vsum(yp[:, None] * xp), ne - 1) / s
        if use_loc:
            dc = coords - (coords[i] if obs_coords is None
                           else obs_coords[o])
            d = csqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1])
            gain = gain * gaspari_cohn(d, p.loc_radius)
        ens = ens + dy[:, None] * gain[None, :]
    return ens
