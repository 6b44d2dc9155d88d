"""The Jackson-Hallberg-Legg shear mixing
(twin of mom6_tpu/physics/vertical/kappa_shear.py).

kappa and the turbulent kinetic energy Q at the interior interfaces
solve the coupled steady column equations (Jackson, Hallberg & Legg
2008; MOM_kappa_shear.F90, the non-Newton path of find_kappa_tke):

  TKE:    d/dz[(kappa~ + kappa0) dQ/dz] + (kappa + kappa0) S^2
          - kappa N^2 - (Q - q0) sqrt(C_N^2 N^2 + C_S^2 S^2) = 0
  kappa:  d^2(kappa)/dz^2 + K_src - kappa / L_eff^2 = 0,
          K_src = 2 SHEARMIX_RATE sqrt(S^2)
                  (Ri_c S^2 - N^2) / (Ri_c S^2 + FRI_CURVATURE N^2)
                  where N^2 < Ri_c S^2,
          1/L_eff^2 = (N^2/LAMBDA^2 + f^2)/Q + (1/dist_top + 1/dist_bot)^2

with kappa = 0 at the surface and the bottom.  Each of ``n_outer``
passes runs ``n_inner`` sweeps of the pair (two tridiagonal solves, the
Thomas kernel on the card, on (nz-1, ny, nx)), then mixes u, v, T and S
implicitly over dt/n_outer with that kappa (one solve of the four
fields), so the mixing saturates as it consumes the shear.  The
reference's two nested fori_loops are Python loops here.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_tpu_torch.framework.arith import csqrt, rdiv, sdiv, vcumsum, vsum
from mom6_tpu_torch.framework.solvers import tridiag_solve
from mom6_tpu_torch.framework.stencil import im1, jm1
from mom6_tpu_torch.tracers.vert_diff import tracer_vertdiff

__all__ = ["KappaShearParams", "kappa_shear"]

_H_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class KappaShearParams:
    ri_crit: float = 0.25         # RINO_CRIT
    shearmix_rate: float = 0.089  # SHEARMIX_RATE
    fri_curvature: float = -0.97  # FRI_CURVATURE
    lam: float = 0.82             # LAMBDA
    c_n: float = 0.24             # TKE_N_DECAY_CONST
    c_s: float = 0.14             # TKE_SHEAR_DECAY_CONST
    kappa_0: float = 1e-7         # KD (background) [m2 s-1]
    tke_bg: float = 0.0           # TKE_BACKGROUND [m2 s-2]
    tke_min: float = 1e-9         # floor on Q [m2 s-2]
    kappa_max: float = 0.1        # [m2 s-1]
    n_outer: int = 3              # dt subdivisions
    n_inner: int = 3              # kappa/TKE sweeps


def _n2_s2(h, uc, vc, T, S, GV, eos):
    """N^2 (>= 0), S^2 and the depths of the interior interfaces."""
    z_int = vcumsum(h)[:-1]
    p_int = GV.rho0 * GV.g_earth * z_int
    t_i = 0.5 * (T[:-1] + T[1:])
    s_i = 0.5 * (S[:-1] + S[1:])
    a_t, a_s = eos.density_derivs(t_i, s_i, p_int)
    dz = torch.clamp(0.5 * (h[:-1] + h[1:]), min=_H_EPS)
    n2 = (GV.g_earth / GV.rho0) * (a_t * (T[1:] - T[:-1])
                                   + a_s * (S[1:] - S[:-1])) / dz
    du = (uc[:-1] - uc[1:]) / dz
    dv = (vc[:-1] - vc[1:]) / dz
    return torch.clamp(n2, min=0.0), du * du + dv * dv, z_int


def _solve_kappa_tke(h, n2, s2, z_int, f2, col, p: KappaShearParams,
                     kappa, q):
    """``n_inner`` sweeps of the coupled kappa/TKE equations on the
    interior interfaces (nz-1, ny, nx)."""
    dz_int = torch.clamp(0.5 * (h[:-1] + h[1:]), min=_H_EPS)
    idz = rdiv(1.0, torch.clamp(h[1:-1], min=_H_EPS))
    tke_decay = csqrt(p.c_n ** 2 * n2 + p.c_s ** 2 * s2)
    l_top = z_int
    l_bot = torch.clamp(col[None] - z_int, min=_H_EPS)
    i_l2_bdry = (rdiv(1.0, torch.clamp(l_top, min=_H_EPS))
                 + rdiv(1.0, l_bot)) ** 2
    ric = p.ri_crit
    k_src = torch.where(
        n2 < ric * s2,
        2.0 * p.shearmix_rate * csqrt(s2)
        * (ric * s2 - n2) / torch.clamp(ric * s2 + p.fri_curvature * n2,
                                        min=1e-30),
        0.0)
    zero = torch.zeros_like(idz[:1])
    sub_k = -torch.cat([zero, idz], dim=0)
    sup_k = -torch.cat([idz, zero], dim=0)
    for _ in range(p.n_inner):
        # the TKE equation, its buoyancy sink through K_Q = kappa/Q
        k_q = kappa / torch.clamp(q, min=p.tke_min)
        a_q = (0.5 * (kappa[:-1] + kappa[1:]) + p.kappa_0) * idz
        sub = -torch.cat([zero, a_q], dim=0)
        sup = -torch.cat([a_q, zero], dim=0)
        diag = dz_int * (tke_decay + n2 * k_q) - sub - sup
        rhs = dz_int * ((kappa + p.kappa_0) * s2 + p.tke_bg * tke_decay)
        q = torch.clamp(tridiag_solve(sub, diag, sup, rhs), min=p.tke_min)
        # the kappa equation: implicit decay and unit vertical spreading
        i_ld2 = (sdiv(n2, p.lam ** 2) + f2[None]) / q + i_l2_bdry
        diag_k = dz_int * i_ld2 - sub_k - sup_k
        kappa = torch.clamp(tridiag_solve(sub_k, diag_k, sup_k,
                                          dz_int * k_src),
                            0.0, p.kappa_max)
    return kappa, q


def kappa_shear(h, u, v, T, S, G, GV, eos,
                p: KappaShearParams = KappaShearParams(), dt: float = 3600.0):
    """Returns (kappa (nz+1, ny, nx) [m2 s-1], Q at the interfaces)."""
    uc = 0.5 * (u + im1(u))
    vc = 0.5 * (v + jm1(v))
    col = vsum(h)
    f_q = G.CoriolisBu
    f2 = 0.25 * ((f_q ** 2 + im1(jm1(f_q ** 2)))
                 + (im1(f_q ** 2) + jm1(f_q ** 2)))
    dt_sub = dt / p.n_outer
    kappa = torch.zeros_like(h[:-1])
    q = torch.full_like(h[:-1], p.tke_min)
    zeros = torch.zeros_like(h[:1])
    for _ in range(p.n_outer):
        n2, s2, z_int = _n2_s2(h, uc, vc, T, S, GV, eos)
        kappa, q = _solve_kappa_tke(h, n2, s2, z_int, f2, col, p, kappa, q)
        kd = torch.cat([zeros, kappa, zeros], dim=0)
        mixed = tracer_vertdiff(torch.stack([uc, vc, T, S]), h, kd, dt_sub)
        uc, vc, T, S = mixed[0], mixed[1], mixed[2], mixed[3]
    kappa_full = torch.cat([zeros, kappa, zeros], dim=0) * G.mask2dT[None]
    tke_full = torch.cat([zeros, q, zeros], dim=0) * G.mask2dT[None]
    return kappa_full, tke_full
