"""Low-mode internal tide propagation (twin of
mom6_tpu/physics/lateral/internal_tides.py).

The energy density En(freq, mode, angle, y, x) of each frequency and
vertical mode propagates at the group speed along a set of ray
directions, refracts as the mode speed varies, and loses energy to a
background decay and a quadratic saturation drag; the column loss feeds
the lowmode term of the tidal mixing.  All in flux form, upwind, over the
whole (n_freq, n_mode, n_angle, ny, nx) block at once:

* propagation with (cg cos th_a, cg sin th_a), cg = cn sqrt(max(0, 1 -
  f^2/w^2)) for the mode speed cn and the frequency w;
* refraction: periodic upwind transport along the angles at the turning
  rate dth/dt = sin th dc/dx - cos th dc/dy;
* forcing: (1 - q_local) of the conversion, isotropic over the angles;
* losses: a uniform decay rate plus a drag growing with sqrt(E).

On a tripolar grid the ghost row above the fold is the top row mirrored
in x with the angle rotated by pi.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_tpu_torch.framework.arith import csqrt, rdiv, sdiv, vsum
from mom6_tpu_torch.framework.stencil import (holds_top_row, im1, ip1, jm1,
                                              jm1_s0, jp1)

__all__ = ["InternalTidesParams", "init_int_tide_energy",
           "step_internal_tides"]


@dataclasses.dataclass(frozen=True)
class InternalTidesParams:
    n_angle: int = 8                 # angular bins (INTERNAL_TIDE_ANGLES)
    freqs: tuple = (1.4052e-4,)      # frequencies [s-1]
    freq_frac: tuple = (1.0,)        # their shares of the conversion
    n_mode: int = 1                  # vertical modes (INTERNAL_TIDE_MODES)
    q_local: float = 0.3333          # locally dissipated fraction
    decay_rate: float = 0.0          # background loss [s-1]
    drag_coef: float = 1e-4          # quadratic saturation drag
    cg_max: float = 4.0              # group-speed cap [m s-1]
    en_check: float = 1e-20          # negative-energy floor


def init_int_tide_energy(p: InternalTidesParams, ny: int, nx: int,
                         dtype=torch.float32, device=None):
    """Zero energy density [J m-2 a bin]: (n_freq, n_mode, n_angle, ny,
    nx), or (n_angle, ny, nx) for one frequency and one mode."""
    if len(p.freqs) == 1 and p.n_mode == 1:
        return torch.zeros((p.n_angle, ny, nx), dtype=dtype, device=device)
    return torch.zeros((len(p.freqs), p.n_mode, p.n_angle, ny, nx),
                       dtype=dtype, device=device)


def _direction_tables(na: int, dtype, device):
    """cos and sin of the bin centres (na, 1, 1), with the quadrants
    assembled from the first by sign flips when na % 4 == 0, so that
    reflections and the fold's rotation map entries to exact copies."""
    th = 2.0 * np.pi * (np.arange(na) + 0.5) / na
    if na % 4 == 0:
        q = na // 4
        cq, sq = np.cos(th[:q]), np.sin(th[:q])
        c = np.concatenate([cq, -cq[::-1], -cq, cq[::-1]])
        s = np.concatenate([sq, sq[::-1], -sq, -sq[::-1]])
    else:
        c, s = np.cos(th), np.sin(th)
    return tuple(torch.tensor(a, dtype=dtype, device=device)[:, None, None]
                 for a in (c, s))


def _sum_bins(a):
    """The sum over the leading (freq, mode, angle) axes, in order."""
    return vsum(a.reshape((-1,) + tuple(a.shape[-2:])))


def step_internal_tides(En, tke_input, cn, G, GV, dt,
                        p: InternalTidesParams):
    """Advance the energy density one step.

    ``En`` (n_angle, ny, nx) or (n_freq, n_mode, n_angle, ny, nx) [J m-2
    a bin]; ``tke_input`` (ny, nx) the conversion [W m-2]; ``cn`` (ny, nx)
    the first-mode speed (mode m at cn / m) or (n_mode, ny, nx) the modal
    speeds.  Returns (En_new, loss), the loss [W m-2] for the lowmode
    tidal mixing."""
    legacy = En.dim() == 3
    if legacy:
        En = En[None, None]
    nf, nm, na = En.shape[:3]
    dtype, device = En.dtype, En.device

    fold = getattr(G, "fold_north", False)
    if fold and na % 2:
        raise ValueError("TRIPOLAR_N internal tides need an even "
                         "number of angle bins")

    def jp1_f(a):
        if not fold:
            return jp1(a)
        r = jp1(a, "h")
        if a.shape[-3] > 1 and holds_top_row():
            # an angle axis: the ghost row's bins rotate by pi
            r[..., -1, :] = torch.roll(r[..., -1, :], a.shape[-3] // 2,
                                       dims=-2)
        return r

    cos_t, sin_t = _direction_tables(na, dtype, device)

    f2 = G.CoriolisBu * G.CoriolisBu
    # E/W corner pairs first, so that mirrored points round alike
    f2_h = 0.25 * ((f2 + im1(f2)) + (jm1(f2) + im1(jm1(f2))))
    freqs = torch.tensor(p.freqs[:nf], dtype=dtype,
                         device=device).reshape(nf, 1, 1, 1, 1)
    sub = torch.clamp(1.0 - f2_h[None, None, None] / (freqs * freqs),
                      min=0.0)
    inv_m = rdiv(1.0, torch.arange(1, nm + 1, dtype=dtype, device=device)
                 ).reshape(1, nm, 1, 1, 1)
    if cn.dim() == 3:
        cn_m = cn[None, :nm, None]
        grid_shape = tuple(cn.shape[1:])
    else:
        cn_m = cn[None, None, None] * inv_m
        grid_shape = tuple(cn.shape)
    cg = torch.clamp(cn_m * csqrt(sub), max=p.cg_max) * G.mask2dT
    cg = torch.broadcast_to(cg, (nf, nm, 1) + grid_shape)

    # the forcing: split over the frequencies by freq_frac, over the modes
    # as 1/m^2, isotropic over the angles
    ffrac = torch.tensor((p.freq_frac + (1.0,) * nf)[:nf], dtype=dtype,
                         device=device)
    ffrac = (ffrac / vsum(ffrac)).reshape(nf, 1, 1, 1, 1)
    mfrac = inv_m * inv_m
    mfrac = mfrac / vsum(mfrac.reshape(nm, 1, 1, 1))
    En = En + (dt * (1.0 - p.q_local) / na) * ffrac * mfrac \
        * tke_input[None, None, None]

    # refraction
    dcdx = (ip1(cg) - im1(cg)) * (0.5 * G.IdxT)
    dcdy = (jp1_f(cg) - jm1(cg)) * (0.5 * G.IdyT)
    rate = sin_t * dcdx - cos_t * dcdy
    En = _refract_axis(En, rate, dt, axis=-3)

    # propagation, upwind in each direction
    cg_u = 0.5 * (cg + ip1(cg)) * G.mask2dCu
    cg_v = 0.5 * (cg + jp1_f(cg)) * G.mask2dCv
    cgx = cos_t * cg_u
    cgy = sin_t * cg_v
    face_x = G.dyCu * G.mask2dCu
    flux = face_x * (torch.clamp(cgx, min=0.0) * En
                     + torch.clamp(cgx, max=0.0) * ip1(En))
    div = G.IareaT * (flux - im1(flux))
    face_y = G.dxCv * G.mask2dCv
    flux = face_y * (torch.clamp(cgy, min=0.0) * En
                     + torch.clamp(cgy, max=0.0) * jp1_f(En))
    # the southern edge of a tripolar grid is a wall
    div = div + G.IareaT * (flux - jm1_s0(flux, fold))
    En = torch.clamp(En - dt * div, min=0.0)

    # the losses
    e_tot = _sum_bins(En)
    rate_loss = p.decay_rate + p.drag_coef * csqrt(
        sdiv(torch.clamp(e_tot, min=0.0), GV.rho0))
    damp = rdiv(1.0, 1.0 + dt * rate_loss)
    En_new = En * damp
    loss = sdiv(_sum_bins(En - En_new), dt)
    En_new = En_new * G.mask2dT
    if legacy:
        En_new = En_new[0, 0]
    return En_new, loss * G.mask2dT


def _refract_axis(E, rate, dt, axis: int):
    """Periodic upwind transport along ``axis`` (the angles), the face
    velocity the mean of the two bins' turning rates."""
    na = E.shape[axis]
    dth = 2.0 * np.pi / na
    w = torch.clamp(sdiv(rate * dt, dth), -1.0, 1.0)
    w_face = 0.5 * (w + torch.roll(w, -1, dims=axis))
    flux = torch.clamp(w_face, min=0.0) * E \
        + torch.clamp(w_face, max=0.0) * torch.roll(E, -1, dims=axis)
    return E - (flux - torch.roll(flux, 1, dims=axis))
