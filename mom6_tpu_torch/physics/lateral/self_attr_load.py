"""The self-attraction and loading by spherical harmonics (twin of
mom6_tpu/physics/lateral/self_attr_load.py).

calc_SAL of MOM_self_attr_load.F90 with the Love scaling of
calc_love_scaling (:136): the degree-n coefficient of the SAL height is
the sea level's times beta_n = (3 / (2n+1)) (rhoW / rhoE) (1 + k'_n -
h'_n), degrees 0 and 1 excluded.  The transform is a real FFT along
each row (the zonal wavenumbers m), then per m an analysis by the
weighted pseudo-inverse of the associated-Legendre columns, the Love
scaling and the synthesis by the same columns (two ``einsum`` over the
rows), then the inverse FFT.  The Legendre build stays on the host in
numpy, as in the reference.

As in the reference, the transform assumes that each row of the grid is
a circle of latitude: each row's latitude is its first column's, and the
FFT runs along the row.  On a tripolar grid the rows of the northern cap
are not, and the port does the same there.  The result has the
reference's float32 precision whatever the run's dtype: its builder
makes the matrices in float32 and ``calc_sal_harmonic`` casts the free
surface to float32, and so does the port.  The reference then transforms
in float32; the port transforms those float32 values in float64 and
rounds the result to float32, so that the card's FFT and the CPU's,
which round differently in float32, give the same float32 result.  It
parts from the reference's by float32 round-off.

On a mesh of ranks (parallel/mesh.py) the matrices stay whole on every
rank, each rank transforms the assembled global free surface as one
rank does and keeps its tile of the result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mom6_tpu_torch.framework.containers import TensorDataclass, fields_equal
from mom6_tpu_torch.framework.stencil import tile, whole

__all__ = ["SALHarmonics", "build_sal_harmonics", "calc_sal_harmonic"]

_RHO_WATER = 1035.0     # density of sea water [kg m-3]
_RHO_EARTH = 5517.0     # mean density of the Earth [kg m-3]


@dataclasses.dataclass(frozen=True, eq=False)
class SALHarmonics(TensorDataclass):
    """Two are equal when every field is, tensors to the bit."""
    P: torch.Tensor       # (m, ny, n) Legendre synthesis columns
    pinv: torch.Tensor    # (m, n, ny) weighted analysis pseudo-inverse
    beta: torch.Tensor    # (m, n) Love and degree scaling (0 where padded)
    nmax: int

    def __eq__(self, other):
        if not isinstance(other, SALHarmonics):
            return NotImplemented
        return fields_equal(self, other)


def _legendre_norm(nmax: int, x: np.ndarray) -> np.ndarray:
    """The 4pi-normalized associated Legendre functions P[n, m, j] at
    x = sin(lat), by the stable column recursion (Holmes & Featherstone)."""
    nj = x.shape[0]
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    P = np.zeros((nmax + 1, nmax + 1, nj))
    P[0, 0] = 1.0
    for m in range(1, nmax + 1):
        P[m, m] = np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s * P[m - 1, m - 1]
    for m in range(0, nmax):
        P[m + 1, m] = np.sqrt(2.0 * m + 3.0) * x * P[m, m]
    for m in range(0, nmax + 1):
        for n in range(m + 2, nmax + 1):
            a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = np.sqrt(((2.0 * n + 1.0) * (n - 1.0 + m) * (n - 1.0 - m))
                        / ((2.0 * n - 3.0) * (n * n - m * m)))
            P[n, m] = a * x * P[n - 1, m] - b * P[n - 2, m]
    return P


def build_sal_harmonics(G, nmax: int = 12, *,
                        love_factors: Optional[np.ndarray] = None
                        ) -> SALHarmonics:
    """The transform's matrices for the grid ``G`` (host numpy, from the
    rows' latitudes in the grid's dtype), as float32 tensors on ``G``'s
    device.  ``love_factors``: an optional
    (nmax+1,) array of 1 + k'_n - h'_n (default 1, a rigid Earth).
    nmax is capped at nx // 2 and ny - 1, what the zonal FFT and the
    meridional fit resolve."""
    nmax = min(nmax, int(G.nx) // 2, int(G.ny) - 1)
    # in the grid's dtype, as the reference's numpy forms it
    lat = G.geoLatT[:, 0].cpu().numpy() * np.pi / 180.0
    x = np.sin(lat)
    w = np.maximum(np.cos(lat), 1e-6)            # area weights of the rows
    Pnm = _legendre_norm(nmax, x)

    love = np.ones(nmax + 1) if love_factors is None \
        else np.asarray(love_factors, np.float64)
    beta_n = (3.0 / (2.0 * np.arange(nmax + 1) + 1.0)) \
        * (_RHO_WATER / _RHO_EARTH) * love
    beta_n[0] = 0.0
    if nmax >= 1:
        beta_n[1] = 0.0

    M = nmax + 1
    P = np.zeros((M, lat.shape[0], M))
    pinv = np.zeros((M, M, lat.shape[0]))
    beta = np.zeros((M, M))
    for m in range(M):
        A = np.stack([Pnm[n, m] for n in range(m, M)], axis=1)
        WA = w[:, None] * A
        gram = A.T @ WA
        # regularized: high degrees are poorly resolved on coarse grids
        gram += 1e-10 * np.eye(gram.shape[0]) * max(np.trace(gram), 1.0)
        P[m, :, : M - m] = A
        pinv[m, : M - m, :] = np.linalg.solve(gram, WA.T)
        beta[m, : M - m] = beta_n[m:]
    dev = G.geoLatT.device

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    return SALHarmonics(P=f32(P), pinv=f32(pinv), beta=f32(beta), nmax=nmax)


def calc_sal_harmonic(eta, sal: SALHarmonics):
    """The SAL height (ny, nx) [m] of the free surface ``eta`` (ny, nx):
    the free surface rounded to float32 and the float32 matrices, as the
    reference's, the transform evaluated in float64 and its result
    rounded to float32, returned in ``eta``'s dtype.  On a mesh ``eta``
    is a tile, and so is the result."""
    dtype = eta.dtype
    eta = whole(eta)
    nx = eta.shape[-1]
    f64 = torch.float64
    F = torch.fft.rfft(eta.to(torch.float32).to(f64), dim=-1)
    M = sal.nmax + 1
    Fm = F[:, :M]
    re = Fm.real.T.contiguous()                          # (M, ny)
    im = Fm.imag.T.contiguous()
    pinv, beta, P = (a.to(f64) for a in (sal.pinv, sal.beta, sal.P))
    c_re = torch.einsum("mnj,mj->mn", pinv, re) * beta
    c_im = torch.einsum("mnj,mj->mn", pinv, im) * beta
    g_re = torch.einsum("mjn,mn->mj", P, c_re)          # (M, ny)
    g_im = torch.einsum("mjn,mn->mj", P, c_im)
    Ffull = torch.zeros_like(F)
    Ffull[:, :M] = torch.complex(g_re, g_im).T
    out = torch.fft.irfft(Ffull, n=nx, dim=-1)
    return tile(out.to(torch.float32).to(dtype))
