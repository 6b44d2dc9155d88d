"""Geothermal heating (twin of the geothermal part of
mom6_tpu/physics/vertical/opacity.py).

The geothermal flux warms the deepest layer thicker than ``h_min`` of
each column (geothermal_in_place, MOM_geothermal.F90).  The reference's
shortwave opacity profile (sw_heating) is not ported: DiabaticParams
with an opacity raises.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GeothermalParams", "geothermal_heating"]


@dataclasses.dataclass(frozen=True)
class GeothermalParams:
    heat_flux: float = 0.0886      # [W m-2]


def geothermal_heating(h, GV, p: GeothermalParams = GeothermalParams(),
                       cp: float = 3991.87, h_min: float = 1.0):
    """The temperature tendency [degC s-1] of each layer: the flux into
    the deepest layer with ``h > h_min``."""
    massive = (h > h_min).to(h.dtype)
    # does any layer below have mass: a reversed running maximum
    below = torch.flip(torch.cummax(torch.flip(massive, (0,)), dim=0)[0],
                       (0,))
    below_has_mass = torch.cat([below[1:], torch.zeros_like(h[:1])], dim=0)
    deepest = massive * (1.0 - below_has_mass)
    return deepest * p.heat_flux / (GV.rho0 * cp * torch.clamp(h, min=h_min))
