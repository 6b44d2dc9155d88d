"""Horizontal regridding of a climatology: interpolate, then extrapolate
(twin of mom6_tpu/grid/horiz_regrid.py: fill_missing, _interp_weights,
horiz_interp_bilinear, horiz_interp_and_extrap_tracer).

Data on their own rectilinear lon/lat grid with missing values (land,
ice shelves, unobserved deep levels) are interpolated bilinearly onto
the model grid, each missing source point weighted 0
(horiz_interp_and_extrap_tracer_record), then every wet model cell
without data is filled (fill_miss_2d): seeded from the filled level
above where there is one (and held there), else flood-filled from its
nearest neighbours with data, then relaxed toward the harmonic interior
with the observed cells held.

Host numpy in float64, like the reference: it runs once, when a model
is built, on data read from a file; its result is the input of the
vertical remap (grid/z_init.py), which runs on the model's device.  On
the host it is the reference's arithmetic to the bit.  Below the first
level every wet cell is seeded and held, so the relaxation stops after
one pass; ``fill_missing.passes`` counts the relaxation passes of all
calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["fill_missing", "horiz_interp_bilinear",
           "horiz_interp_and_extrap_tracer"]


def fill_missing(data: np.ndarray, good: np.ndarray, wet: np.ndarray,
                 prev: Optional[np.ndarray] = None,
                 num_pass: int = 10000, relc: float = 0.25,
                 acrit: float = 1e-4, cyclic_x: bool = False
                 ) -> np.ndarray:
    """Fill wet cells without data (fill_miss_2d role).

    ``data``: (ny, nx) field; ``good``: True where ``data`` is observed;
    ``wet``: True where the model needs a value; ``prev``: optional
    initial guess for the unobserved cells (the filled level above).
    Two stages, as the reference: (1) seed every wet non-good cell —
    from ``prev`` where available, else by iterative nearest-neighbor
    flood averaging; (2) ``num_pass`` Jacobi sweeps relaxing only the
    seeded cells (observed cells pinned) until the largest update is
    below ``acrit``."""
    data = np.array(data, np.float64, copy=True)
    good = np.asarray(good, bool) & np.asarray(wet, bool)
    fillable = np.asarray(wet, bool) & ~good
    if not fillable.any():
        return data
    filled = good.copy()
    data[~filled] = 0.0
    pinned = good.copy()
    if prev is not None:
        use = fillable & np.isfinite(prev)
        data[use] = np.asarray(prev)[use]
        filled |= use
        # downward-continued values are data for this level, not a
        # guess: pin them, as the level above was itself fully filled
        pinned |= use
    # -- stage 1: flood seed from nearest valid neighbors ------------------
    def nbr_sum(a):
        s = np.zeros_like(a)
        s[1:, :] += a[:-1, :]
        s[:-1, :] += a[1:, :]
        s[:, 1:] += a[:, :-1]
        s[:, :-1] += a[:, 1:]
        if cyclic_x:                    # reentrant zonal axis
            s[:, 0] += a[:, -1]
            s[:, -1] += a[:, 0]
        return s
    remaining = fillable & ~filled
    for _ in range(data.shape[0] + data.shape[1]):
        if not remaining.any():
            break
        w = nbr_sum(filled.astype(np.float64))
        v = nbr_sum(np.where(filled, data, 0.0))
        front = remaining & (w > 0)
        data[front] = v[front] / w[front]
        filled |= front
        remaining &= ~front
    if remaining.any():
        # isolated wet cells with no connected data anywhere: use the
        # mean of what exists (the reference's last-resort behavior)
        data[remaining] = data[good].mean() if good.any() else 0.0
    # -- stage 2: relax the seeded cells toward Laplace ---------------------
    relax = np.asarray(wet, bool) & ~pinned
    for _ in range(num_pass):
        fill_missing.passes += 1
        w = nbr_sum(np.where(wet, 1.0, 0.0))
        v = nbr_sum(np.where(wet, data, 0.0))
        avg = np.where(w > 0, v / np.maximum(w, 1.0), data)
        delta = relc * (avg - data)
        delta = np.where(relax, delta, 0.0)
        data = data + delta
        if np.abs(delta).max() < acrit:
            break
    return data


fill_missing.passes = 0


def _interp_weights(src: np.ndarray, dst: np.ndarray,
                    periodic: float = 0.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """1-D linear interpolation stencil: returns (i0, i1, frac) with
    dst ~ (1-frac)*src[i0] + frac*src[i1].  ``periodic`` > 0 treats the
    axis as cyclic with that period (longitude)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    if periodic > 0.0:
        # unwrap each target into [src[0], src[0]+period)
        d = np.mod(dst - src[0], periodic) + src[0]
        src_ext = np.concatenate([src, src[:1] + periodic])
        i0 = np.clip(np.searchsorted(src_ext, d, side="right") - 1,
                     0, n - 1)
        i1 = (i0 + 1) % n
        den = src_ext[i0 + 1] - src_ext[i0]
        frac = np.where(den > 0, (d - src_ext[i0]) / np.maximum(den, 1e-30),
                        0.0)
    else:
        d = np.clip(dst, src[0], src[-1])
        i0 = np.clip(np.searchsorted(src, d, side="right") - 1, 0, n - 2)
        i1 = i0 + 1
        den = src[i1] - src[i0]
        frac = np.where(den > 0, (d - src[i0]) / np.maximum(den, 1e-30),
                        0.0)
    return i0, i1, np.clip(frac, 0.0, 1.0)


def horiz_interp_bilinear(src_lon, src_lat, src, dst_lon, dst_lat,
                          good: Optional[np.ndarray] = None,
                          periodic_lon: float = 360.0,
                          min_weight: float = 0.5
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Mask-aware bilinear interpolation from a rectilinear source grid
    onto arbitrary (ny, nx) target coordinate arrays (the horiz_interp
    bilinear role).

    Missing source points get zero weight; the result divides by the
    accumulated valid weight and reports a target cell good where that
    weight exceeds ``min_weight``.  Returns (data, good) on the target."""
    src = np.asarray(src, np.float64)
    good = np.ones_like(src, bool) if good is None \
        else np.asarray(good, bool)
    dst_lon = np.asarray(dst_lon, np.float64)
    dst_lat = np.asarray(dst_lat, np.float64)
    i0, i1, fx = _interp_weights(np.asarray(src_lon), dst_lon.ravel(),
                                 periodic=periodic_lon)
    j0, j1, fy = _interp_weights(np.asarray(src_lat), dst_lat.ravel())
    vals = np.zeros(dst_lon.size)
    wts = np.zeros(dst_lon.size)
    for jj, wj in ((j0, 1.0 - fy), (j1, fy)):
        for ii, wi in ((i0, 1.0 - fx), (i1, fx)):
            w = wj * wi * good[jj, ii]
            vals += w * np.where(good[jj, ii], src[jj, ii], 0.0)
            wts += w
    out = np.where(wts > 0, vals / np.maximum(wts, 1e-30), np.nan)
    ok = wts > min_weight
    return (out.reshape(dst_lon.shape), ok.reshape(dst_lon.shape))


def horiz_interp_and_extrap_tracer(src_lon, src_lat, data, wet,
                                   dst_lon, dst_lat,
                                   missing_value: Optional[float] = None,
                                   periodic_lon: float = 360.0,
                                   num_pass: int = 10000,
                                   relc: float = 0.25,
                                   acrit: float = 1e-4,
                                   cyclic_x: bool = False) -> np.ndarray:
    """The full per-level pipeline (horiz_interp_and_extrap_tracer_record):
    for each of the (nzd, nys, nxs) data levels, bilinearly interpolate
    the observed points onto the model grid, then fill every wet model
    cell by seeded relaxation, carrying the level above as the deep
    initial guess.  Returns (nzd, ny, nx) with every wet cell valid."""
    data = np.asarray(data, np.float64)
    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]
    wet = np.asarray(wet, bool)
    out = np.zeros((data.shape[0],) + np.asarray(dst_lon).shape)
    prev = None
    for k in range(data.shape[0]):
        lvl = data[k]
        src_good = np.isfinite(lvl)
        if missing_value is not None:
            src_good &= ~np.isclose(lvl, missing_value)
        interp, ok = horiz_interp_bilinear(
            src_lon, src_lat, np.where(src_good, lvl, 0.0),
            dst_lon, dst_lat, good=src_good, periodic_lon=periodic_lon)
        interp = np.where(ok, interp, 0.0)
        out[k] = fill_missing(interp, ok, wet, prev=prev,
                              num_pass=num_pass, relc=relc, acrit=acrit,
                              cyclic_x=cyclic_x)
        prev = out[k]
    return out[0] if squeeze else out
