"""The ice shelf's thermodynamic boundary layer, the three-equation melt
(twin of mom6_tpu/physics/ice_shelf.py).

The Holland & Jenkins (1999) balance at the ice-ocean interface,

  T_b = lambda1 S_b + lambda2 + lambda3 p              (freezing line)
  c_w gamma_T (T_w - T_b) = (L + c_i (T_b - T_i)) m'   (heat)
  gamma_S (S_w - S_b) = S_b m'                         (salt),

with m' eliminated, is a quadratic in S_b solved in closed form
elementwise; the ice-heat term takes T_b at the freezing point of S_w.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_tpu_torch.framework.arith import csqrt, sdiv

__all__ = ["IceShelfParams", "three_equation_melt"]


@dataclasses.dataclass(frozen=True)
class IceShelfParams:
    gamma_t: float = 1e-4        # thermal exchange velocity [m s-1]
    gamma_s: float = 5.05e-7 / 1e-4 * 1e-4  # haline exchange velocity
    lambda1: float = -0.0573     # dTf/dS [degC (g/kg)-1]
    lambda2: float = 0.0832      # [degC]
    lambda3: float = -7.53e-8    # [degC Pa-1]
    latent: float = 3.34e5       # latent heat of fusion [J kg-1]
    c_w: float = 3974.0          # seawater heat capacity [J kg-1 K-1]
    c_i: float = 2009.0          # ice heat capacity
    t_ice: float = -15.0         # ice interior temperature [degC]
    rho_i: float = 918.0
    rho_w: float = 1028.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _div(t, d):
    """``t / d``, correctly rounded whether ``d`` is a tensor or a
    number."""
    return t / d if torch.is_tensor(d) else sdiv(t, d)


def three_equation_melt(T_w, S_w, p_base, p: IceShelfParams = IceShelfParams()):
    """(melt rate [m ice s-1], heat flux into the ocean [W m-2], salt flux
    [g kg-1 m s-1]) for the water under the shelf (T_w, S_w) at the
    interface pressure ``p_base`` [Pa].  ``p.gamma_t`` and ``p.gamma_s``
    may be tensors."""
    gt, gs = p.gamma_t, p.gamma_s
    tb_guess = p.lambda1 * S_w + p.lambda2 + p.lambda3 * p_base
    L_eff = p.latent + p.c_i * (tb_guess - p.t_ice)
    a = -p.c_w * gt * p.lambda1
    b = p.c_w * gt * (T_w - p.lambda2 - p.lambda3 * p_base) + gs * L_eff
    c = -gs * L_eff * S_w
    disc = csqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    s_b = _div(-b + disc, 2.0 * a)
    s_b = torch.where(s_b > 0, s_b, _div(-b - disc, 2.0 * a))
    s_b = torch.clamp(s_b, 1.0, 60.0)
    t_b = p.lambda1 * s_b + p.lambda2 + p.lambda3 * p_base
    m_prime = gs * (S_w - s_b) / torch.clamp(s_b, min=1.0)
    melt = sdiv(m_prime * p.rho_w, p.rho_i)
    heat_flux = -p.rho_w * p.c_w * gt * (T_w - t_b)
    salt_flux = -m_prime * s_b
    return melt, heat_flux, salt_flux
