"""Ice-shelf dynamics: the shallow-shelf approximation (twin of
mom6_tpu/physics/ice_shelf_dynamics.py: SSAParams, ssa_solve,
ice_shelf_advect_thickness).

Velocities live at the corners (q points); strain rates are evaluated at
the cell centres from corner means, and the stress divergence is the
exact adjoint of the strain operator weighted by nu H in each cell (the
virtual-work form), so the operator is symmetric positive semi-definite
and plain conjugate gradients converge.  ``ssa_solve`` is a fixed number
of Picard iterations on Glen's viscosity nu = 0.5 A^(-1/n) eps_e^((1-n)/n),
each around a fixed number of CG iterations: two plain loops on (ny, nx)
tensors with no host synchronisation, about 80 elementwise launches an
operator application on the card (480 applications with the defaults).
The driving stress of a floating shelf is the adjoint of the gradient
acting on 0.5 g' H^2, g' = rho_i g (1 - rho_i / rho_w); corners with no
ice next to them are pinned to 0.  A tripolar grid is refused.

On a mesh of ranks (parallel/mesh.py) the strain operators take their
neighbours through the mesh's shifts, and the CG's inner products and
the driving stress's norm sum the assembled global field as one rank
does (framework/stencil.py::whole_sum), so that N ranks equal one.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_tpu_torch.framework.arith import cpow, csqrt
from mom6_tpu_torch.framework.stencil import (im1, ip1, jm1, jp1, whole_max,
                                              whole_sum)

__all__ = ["SSAParams", "ssa_solve", "ice_shelf_advect_thickness"]


@dataclasses.dataclass(frozen=True)
class SSAParams:
    glen_a: float = 2.261e-25    # Glen flow-rate factor A [Pa-3 s-1]
    glen_n: float = 3.0
    rho_ice: float = 918.0
    rho_water: float = 1028.0
    g: float = 9.81
    eps_min: float = 1e-13       # strain-rate floor [s-1] (GLEN_EPS_MIN)
    n_picard: int = 8            # nonlinear viscosity iterations
    n_cg: int = 60               # CG iterations a Picard iteration
    basal_beta: float = 0.0      # linear basal drag [Pa s m-1] (grounded)


def _strains(u, v, G):
    """Cell-centred strain rates (du/dx, du/dy, dv/dx, dv/dy) from the
    corner velocities."""
    def ddx(q):
        e = 0.5 * (q + jm1(q))           # east edge mean at (j, i)
        return (e - im1(e)) * G.IdxT

    def ddy(q):
        n = 0.5 * (q + im1(q))           # north edge mean
        return (n - jm1(n)) * G.IdyT

    return ddx(u), ddy(u), ddx(v), ddy(v)


def _strains_adjoint(fx_ux, fy_uy, fx_vx, fy_vy, G, area):
    """The adjoint of :func:`_strains` under the area-weighted inner
    product: the corner forces (Fu, Fv) with <F, w> = sum over cells of
    area (fx_ux w_x + fy_uy w_y + ...)."""
    def ddx_t(f):
        g = f * G.IdxT * area
        e = g - ip1(g)
        return 0.5 * (e + jp1(e))

    def ddy_t(f):
        g = f * G.IdyT * area
        n = g - jp1(g)
        return 0.5 * (n + ip1(n))

    return ddx_t(fx_ux) + ddy_t(fy_uy), ddx_t(fx_vx) + ddy_t(fy_vy)


def _apply_ssa(u, v, nu_h, G, mask_q, area, beta_q):
    """A(u, v): the (negative) SSA stress divergence at the corners, with
    the cell-centred nu H ``nu_h`` [Pa s m] and the linear drag beta_q."""
    ux, uy, vx, vy = _strains(u, v, G)
    sxx = nu_h * (4.0 * ux + 2.0 * vy)
    syy = nu_h * (4.0 * vy + 2.0 * ux)
    sxy = nu_h * (uy + vx)
    fu, fv = _strains_adjoint(sxx, sxy, sxy, syy, G, area)
    fu = fu + beta_q * u * area
    fv = fv + beta_q * v * area
    return fu * mask_q, fv * mask_q


def _glen_visc(u, v, h, G, p: SSAParams):
    """The vertically integrated Glen viscosity nu H at the cell centres,
    H floored at 1 m."""
    ux, uy, vx, vy = _strains(u, v, G)
    s = uy + vx
    eps_e2 = (ux * ux + vy * vy + ux * vy + 0.25 * (s * s)
              + p.eps_min ** 2)
    n = p.glen_n
    nu = 0.5 * p.glen_a ** (-1.0 / n) * cpow(eps_e2, (1.0 - n) / (2.0 * n))
    return nu * torch.clamp(h, min=1.0)


def ssa_solve(h, G, p: SSAParams, mask_shelf=None, u0=None, v0=None,
              beta=None):
    """The SSA momentum balance of a floating shelf of thickness ``h``
    (ny, nx) [m]; ``mask_shelf`` is 1 where the ice is dynamic (default
    h > 1 m), ``beta`` an optional basal drag.  Returns the corner
    velocities (u, v) [m s-1].

    The system is divided by the norm of the driving stress so that the
    CG inner products stay in range in float32 (nu H reaches 1e17).
    ``ssa_solve.residuals`` keeps the last call's CG residuals, one a
    Picard iteration after its last CG iteration, relative to the
    driving stress (a tensor: no host synchronisation)."""
    if getattr(G, "fold_north", False):
        raise ValueError(
            "ice-shelf (SSA) dynamics are not fold-wired: a TRIPOLAR_N "
            "grid cannot host dynamic ice shelves at the northern fold; "
            "use a regional grid for the shelf domain")
    if mask_shelf is None:
        mask_shelf = (h > 1.0).to(h.dtype)
    m_any = torch.maximum(torch.maximum(mask_shelf, ip1(mask_shelf)),
                          torch.maximum(jp1(mask_shelf),
                                        ip1(jp1(mask_shelf))))
    mask_q = m_any * G.mask2dT * ip1(jp1(G.mask2dT))
    area = G.areaT
    gprime = p.rho_ice * p.g * (1.0 - p.rho_ice / p.rho_water)

    hm = h * mask_shelf
    pot = 0.5 * gprime * (hm * hm)
    zero = torch.zeros_like(pot)
    tdx, tdy = _strains_adjoint(pot, zero, zero, pot, G, area)
    tdx = tdx * mask_q
    tdy = tdy * mask_q

    beta_q = torch.zeros_like(h) if beta is None else beta
    u = torch.zeros_like(h) if u0 is None else u0
    v = torch.zeros_like(h) if v0 is None else v0

    # a strong diagonal on the corners with no ice next to them (where
    # the membrane operator is singular) and a tiny one everywhere, which
    # breaks the zero-strain checkerboard modes of the ice front's
    # corners
    m_all = mask_shelf * ip1(mask_shelf) * jp1(mask_shelf) \
        * ip1(jp1(mask_shelf))
    pin = (1.0 - torch.clamp(m_any, max=1.0)) + 0.0 * m_all
    bscale = csqrt(whole_sum(tdx * tdx + tdy * tdy)) + 1e-30
    b = torch.stack([tdx, tdy]) / bscale

    residuals = []
    for _ in range(p.n_picard):
        nu_h = _glen_visc(u, v, hm, G, p) * mask_shelf
        drag = beta_q + whole_max(nu_h) * (1e-6 * pin + 3e-11)

        def matvec(x):
            fu, fv = _apply_ssa(x[0], x[1], nu_h, G, mask_q, area, drag)
            return torch.stack([fu, fv])

        x = torch.stack([u, v]) / bscale
        r = b - matvec(x)
        pvec = r
        rs = whole_sum(r * r)
        for _ in range(p.n_cg):
            ap = matvec(pvec)
            alpha = rs / torch.clamp(whole_sum(pvec * ap), min=1e-30)
            x = x + alpha * pvec
            r = r - alpha * ap
            rs_new = whole_sum(r * r)
            pvec = r + (rs_new / torch.clamp(rs, min=1e-30)) * pvec
            rs = rs_new
        residuals.append(rs)
        x = x * bscale
        u, v = x[0] * mask_q, x[1] * mask_q
    ssa_solve.residuals = csqrt(torch.stack(residuals))
    return u, v


ssa_solve.residuals = None


def ice_shelf_advect_thickness(h, u, v, dt, G, mask_shelf):
    """h_t = -div(u h): first-order upwind transport of the shelf's
    thickness with the corner velocities averaged to the faces; the
    thickness is floored at 0."""
    u_f = 0.5 * (u + jm1(u))                       # u at east faces
    v_f = 0.5 * (v + im1(v))                       # v at north faces
    hm = h * mask_shelf
    fx = G.dyCu * (torch.clamp(u_f, min=0.0) * hm
                   + torch.clamp(u_f, max=0.0) * ip1(hm))
    fy = G.dxCv * (torch.clamp(v_f, min=0.0) * hm
                   + torch.clamp(v_f, max=0.0) * jp1(hm))
    div = G.IareaT * ((fx - im1(fx)) + (fy - jm1(fy)))
    return torch.clamp(h - dt * div, min=0.0)
