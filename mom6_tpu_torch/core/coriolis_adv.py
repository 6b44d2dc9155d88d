"""Coriolis and kinetic-energy-gradient accelerations
(twin of mom6_tpu/core/coriolis_adv.py).

    du/dt +=  q * vh~ - d(KE)/dx,    dv/dt += -q * uh~ - d(KE)/dy

with q the potential vorticity at corners and uh~/vh~ thickness fluxes
averaged to the corner.  The schemes of CORIOLIS_SCHEME:

* ``SADOURNY75_ENERGY`` (default): energy conserving (Sadourny 1975);
* ``SADOURNY75_ENSTRO``: enstrophy conserving, q averaged first;
* ``ARAKAWA_HSU90``: the four corner-flux weights a, b, c, d;
* ``ARAKAWA_LAMB81``: the 24-point weights and the ep_u/ep_v
  pseudo-Coriolis terms;
* ``ARAKAWA_LAMB_BLEND``: AL81 blended toward AH90 and the Sadourny
  energy scheme, cell by cell, where the corner thicknesses vary
  strongly.

The three Arakawa schemes share one per-cell weight construction (AH90
is AL81 with AL_wt = 0, the Sadourny energy scheme Sad_wt = 1).  On a
tripolar grid the weights of the fold's ghost row swap their corner
roles (C with A, D with B).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mom6_tpu_torch.framework.arith import rdiv
from mom6_tpu_torch.framework.stencil import fold_ghost, im1, ip1, jm1, jp1

__all__ = ["coriolis_adv", "relative_vorticity", "kinetic_energy",
           "SADOURNY75_ENERGY", "SADOURNY75_ENSTRO", "ARAKAWA_HSU90",
           "ARAKAWA_LAMB81", "AL_BLEND"]

SADOURNY75_ENERGY = "SADOURNY75_ENERGY"
ARAKAWA_HSU90 = "ARAKAWA_HSU90"
SADOURNY75_ENSTRO = "SADOURNY75_ENSTRO"
ARAKAWA_LAMB81 = "ARAKAWA_LAMB81"
AL_BLEND = "ARAKAWA_LAMB_BLEND"

# The blend's limits (the reference's defaults; no configuration sets them):
# the largest amplification of the PV flux, and the weight at which the
# Sadourny energy scheme takes over linearly.
F_EFF_MAX_BLEND = 4.0
WT_LIN_BLEND = 0.125


def relative_vorticity(u, v, G):
    """Relative vorticity at q (NE corner) points: circulation / area."""
    ku = "u" if getattr(G, "fold_north", False) else None
    dvdx = ip1(v * G.dyCv) - v * G.dyCv
    dudy = jp1(u * G.dxCu, ku) - u * G.dxCu
    return (dvdx - dudy) * G.IareaBu * G.mask2dBu


def kinetic_energy(u, v, G):
    """KE per unit mass at h points (2-point means)."""
    u2 = 0.5 * (u * u + im1(u * u))
    v2 = 0.5 * (v * v + jm1(v * v))
    return 0.5 * (u2 + v2)


def _pv_at_q(u, v, h, G, GV):
    """Potential vorticity (f + zeta) / h_q with h_q the area-weighted
    4-point thickness mean.  Returns (q, h_q)."""
    rv = relative_vorticity(u, v, G)
    kh = "h" if getattr(G, "fold_north", False) else None
    area_h = G.areaT * G.mask2dT
    ha = h * area_h
    harea = ha + ip1(ha) + jp1(ha, kh) + ip1(jp1(ha, kh))
    area4 = (area_h + ip1(area_h) + jp1(area_h, kh)
             + ip1(jp1(area_h, kh)))
    h_q = harea / torch.clamp(area4, min=1e-30)
    return (G.CoriolisBu + rv) / torch.clamp(h_q, min=GV.h_subroundoff), h_q


def _abcd_weights(q, al_wt, sad_wt):
    """Per-cell corner-flux weights (A_w, B, C, D_w): at h cell (j, i)
    with the corner PVs qNE = q, qNW = im1(q), qSE = jm1(q), qSW =
    im1(jm1(q)),

      A_w = Sad/4 qNW + (1-Sad)[(2-AL) qNW + AL qSE + 2(qNE+qSW)]/24

    and cyclically for D_w, B and C; a(I,j) = ip1(A_w), d(I,j) =
    ip1(D_w).  ``al_wt``/``sad_wt`` are numbers or per-cell tensors."""
    c24 = 1.0 / 24.0
    qNE, qNW = q, im1(q)
    qSE, qSW = jm1(q), im1(jm1(q))
    one_m_sad = 1.0 - sad_wt

    def w(q_main, q_opp, q_pair1, q_pair2):
        return sad_wt * 0.25 * q_main + one_m_sad * c24 * (
            ((2.0 - al_wt) * q_main + al_wt * q_opp)
            + 2.0 * (q_pair1 + q_pair2))

    A_w = w(qNW, qSE, qNE, qSW)
    D_w = w(qSW, qNE, qNW, qSE)
    B = w(qNE, qSW, qNW, qSE)
    C = w(qSE, qNW, qNE, qSW)
    return A_w, B, C, D_w


def _ep_terms(q, al_wt):
    """The Arakawa & Lamb pseudo-Coriolis ep_u/ep_v at h points, scaled
    by the blend weight."""
    c24 = 1.0 / 24.0
    d1 = q - im1(jm1(q))        # qNE - qSW
    d2 = im1(q) - jm1(q)        # qNW - qSE
    return al_wt * c24 * (d1 + d2), al_wt * c24 * (-d1 + d2)


def _blend_weights(h_q, GV):
    """(AL_wt, Sad_wt) per cell from the ratio of the corner inverse
    thicknesses: AL81 where the corners are uniform, then AH90, then the
    Sadourny energy scheme where the amplification would pass
    F_eff_max."""
    ih = rdiv(1.0, torch.clamp(h_q, min=GV.h_subroundoff))
    corners = torch.stack([ih, im1(ih), jm1(ih), im1(jm1(ih))])
    min_ih = torch.amin(corners, dim=0)
    max_ih = torch.amax(corners, dim=0)
    rat_m1 = torch.where(max_ih < 1.0e15 * min_ih,
                         max_ih / torch.clamp(min_ih, min=1e-30) - 1.0,
                         torch.full_like(max_ih, 1.0e15))
    fe_m2 = F_EFF_MAX_BLEND - 2.0
    wl = WT_LIN_BLEND
    rat_lin = 1.5 * fe_m2 / wl
    one = torch.ones_like(rat_m1)
    al_wt = torch.clamp(torch.where(
        rat_m1 <= fe_m2, one,
        rdiv(3.0 * fe_m2, torch.clamp(rat_m1, min=1e-30)) - 2.0),
        0.0, 1.0)
    sad_wt = torch.where(
        rat_m1 <= 1.5 * fe_m2, torch.zeros_like(rat_m1),
        torch.where(rat_m1 <= rat_lin,
                    1.0 - rdiv(1.5 * fe_m2, torch.clamp(rat_m1, min=1e-30)),
                    torch.where(rat_m1 < 2.0 * rat_lin,
                                1.0 - (wl / rat_lin)
                                * (rat_m1 - 2.0 * rat_lin), one)))
    return al_wt, torch.clamp(sad_wt, 0.0, 1.0)


def coriolis_adv(u, v, h, uh, vh, G, GV, *,
                 scheme: str = SADOURNY75_ENERGY
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accelerations (CAu, CAv) from the PV flux and the KE gradient;
    ``uh``/``vh`` are volume transports [m3 s-1] from continuity.  An
    unknown ``scheme`` raises ValueError."""
    q, h_q = _pv_at_q(u, v, h, G, GV)
    fold = getattr(G, "fold_north", False)
    ku = "u" if fold else None
    if scheme == SADOURNY75_ENERGY:
        qvh_q = q * 0.5 * (vh + ip1(vh))
        cau = 0.5 * (qvh_q + jm1(qvh_q)) * G.IdxCu
        quh_q = q * 0.5 * (uh + jp1(uh, ku))
        cav = -0.5 * (quh_q + im1(quh_q)) * G.IdyCv
    elif scheme == SADOURNY75_ENSTRO:
        # q averaged first: CAu = q_u * vh_u
        q_u = 0.5 * (q + jm1(q))
        vh_u = 0.25 * ((vh + ip1(vh)) + (jm1(vh) + ip1(jm1(vh))))
        cau = q_u * vh_u * G.IdxCu
        q_v = 0.5 * (q + im1(q))
        juh = jp1(uh, ku)
        uh_v = 0.25 * ((uh + juh) + (im1(uh) + im1(juh)))
        cav = -q_v * uh_v * G.IdyCv
    elif scheme in (ARAKAWA_HSU90, ARAKAWA_LAMB81, AL_BLEND):
        if scheme == ARAKAWA_HSU90:
            al_wt, sad_wt = 0.0, 0.0
        elif scheme == ARAKAWA_LAMB81:
            al_wt, sad_wt = 1.0, 0.0
        else:
            al_wt, sad_wt = _blend_weights(h_q, GV)
        A_w, B, C, D_w = _abcd_weights(q, al_wt, sad_wt)
        a, d = ip1(A_w), ip1(D_w)
        # CAu(I,j) = a vh(i+1,J) + b vh(i,J) + c vh(i,J-1) + d vh(i+1,J-1)
        cau = ((a * ip1(vh) + C * jm1(vh))
               + (B * vh + d * ip1(jm1(vh)))) * G.IdxCu
        jC, jD = jp1(C), jp1(D_w)
        if fold:
            # across the fold the ghost cell is seen upside down: its SE
            # weight is the mirrored donor's NW one (C <-> A), SW <-> NE
            # (on a mesh, only the tiles of the top row hold the fold row)
            g_c, g_d = fold_ghost(A_w, "h"), fold_ghost(B, "h")
            if g_c is not None:
                jC[..., -1, :] = g_c
                jD[..., -1, :] = g_d
        juh = jp1(uh, ku)
        cav = -((A_w * im1(uh) + jC * juh)
                + (B * uh + jD * im1(juh))) * G.IdyCv
        if scheme != ARAKAWA_HSU90:
            ep_u, ep_v = _ep_terms(q, al_wt)
            kd = "dh" if fold else None
            cau = cau + (ep_u * im1(uh) - ip1(ep_u) * ip1(uh)) * G.IdxCu
            cav = cav + (ep_v * jm1(vh)
                         - jp1(ep_v, kd) * jp1(vh, "v" if fold else None)
                         ) * G.IdyCv
    else:
        raise ValueError(f"unknown Coriolis scheme {scheme}")

    ke = kinetic_energy(u, v, G)
    kh = "h" if fold else None
    cau = (cau - (ip1(ke) - ke) * G.IdxCu) * G.mask2dCu
    cav = (cav - (jp1(ke, kh) - ke) * G.IdyCv) * G.mask2dCv
    return cau, cav
