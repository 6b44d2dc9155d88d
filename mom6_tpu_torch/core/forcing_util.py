"""The forcing's rotation and homogenization
(twin of mom6_tpu/core/forcing_util.py: MOM_forcing_type.F90's
rotate_forcing :3875, rotate_mech_forcing :4017, homogenize_mech_forcing
:4076 and homogenize_forcing :4153).

``rotate_forcing`` turns the forcing onto a rotated domain (with
framework/array_transform.py's grid and state).  ``homogenize_forcing``
(HOMOGENIZE_FORCINGS) replaces each field by its area-weighted mean over
the wet points: the wind stresses on their own faces, the rest on the h
points.  The sums are exact (``math.fsum`` of the products and of the
weights on the host, each correctly rounded), so a mean is the same on
every device and in any order; the reference's ``jnp.sum`` rounds its
partial sums, by ~1e-7 of the terms in float32.  On a mesh of ranks
(parallel/mesh.py) each rank sums the assembled global products, the
same numbers as one rank's.
"""

from __future__ import annotations

import math

import torch

from mom6_tpu_torch.framework.array_transform import rotate_scalar, rotate_uv
from mom6_tpu_torch.framework.stencil import whole

__all__ = ["rotate_mech_forcing", "rotate_forcing",
           "homogenize_mech_forcing", "homogenize_forcing"]


def _rot2(a):
    return None if a is None else rotate_scalar(a)


def rotate_mech_forcing(mech):
    """The mechanical forcing turned: taux and tauy as a C-grid vector
    pair, p_surf and u10 as h-point fields."""
    taux, tauy = ((None, None) if mech.taux is None
                  else rotate_uv(mech.taux, mech.tauy))
    return mech.replace(taux=taux, tauy=tauy, p_surf=_rot2(mech.p_surf),
                        u10=_rot2(mech.u10))


def rotate_forcing(forcing):
    """The forcing turned, its mechanical and buoyancy parts (the open
    boundaries' data belong to one domain and are rebuilt, as in the
    reference)."""
    b = forcing.buoy
    buoy = b.replace(heat_flux=_rot2(b.heat_flux),
                     salt_flux=_rot2(b.salt_flux), sw_flux=_rot2(b.sw_flux),
                     fw_flux=_rot2(b.fw_flux), t_restore=_rot2(b.t_restore),
                     s_restore=_rot2(b.s_restore))
    return forcing.replace(mech=rotate_mech_forcing(forcing.mech), buoy=buoy)


def _mean(a, w):
    """sum(a w) / max(sum(w), 1e-30) in ``a``'s dtype, each sum exact."""
    def total(x):
        return math.fsum(whole(x).detach().double().cpu().numpy().ravel())
    num = torch.tensor(total(a * w), dtype=torch.float64)
    den = torch.tensor(max(total(w), 1e-30), dtype=torch.float64)
    return (num.to(a.dtype) / den.to(a.dtype)).to(a.device)


def _uniform(a, mask, w):
    """The mean of ``a`` on the wet points of ``mask``, 0 elsewhere."""
    return torch.where(mask > 0, _mean(a, w), torch.zeros_like(a))


def _homog_t(a, G):
    return None if a is None else _uniform(a, G.mask2dT,
                                           G.areaT * G.mask2dT)


def homogenize_mech_forcing(mech, G):
    """The wind stresses' means on their own faces, p_surf's and u10's
    on the h points."""
    taux = tauy = None
    if mech.taux is not None:
        taux = _uniform(mech.taux, G.mask2dCu,
                        G.dyCu * G.dxCu * G.mask2dCu)
        tauy = _uniform(mech.tauy, G.mask2dCv,
                        G.dxCv * G.dyCv * G.mask2dCv)
    return mech.replace(taux=taux, tauy=tauy, p_surf=_homog_t(mech.p_surf, G),
                        u10=_homog_t(mech.u10, G))


def homogenize_forcing(forcing, G):
    """Every mechanical and buoyancy field of the forcing homogenized."""
    b = forcing.buoy
    buoy = b.replace(heat_flux=_homog_t(b.heat_flux, G),
                     salt_flux=_homog_t(b.salt_flux, G),
                     sw_flux=_homog_t(b.sw_flux, G),
                     fw_flux=_homog_t(b.fw_flux, G),
                     t_restore=_homog_t(b.t_restore, G),
                     s_restore=_homog_t(b.s_restore, G))
    return forcing.replace(mech=homogenize_mech_forcing(forcing.mech, G),
                           buoy=buoy)
