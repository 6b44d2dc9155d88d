"""Analytic idealized user cases
(twin of mom6_tpu/drivers/user_cases.py; and of
configs/seasonal_gyre/make_forcing.py::write_forcing).

Host numpy, evaluated in float64 on the grid's coordinates as the
reference does: the Kelvin, shelfwave, DOME and Neverworld topographies
at init; the open boundaries' analytic data of OBC_USER_CONFIG
(MOM_boundary_update.F90:203): the Kelvin and shelf waves as series the
forcing provider evaluates per segment, the DOME embayment's steady
per-layer inflow; and ``hurricane_wind_fn`` (Idealized_Hurricane.F90:
336-456, the Holland (1980) profile with the Zhang & Uhlhorn (2012)
inflow angle), a callable the forcing provider evaluates per segment.
"""

from __future__ import annotations

import numpy as np

from mom6_tpu_torch.core.open_boundary import segment_slices
from mom6_tpu_torch.io.netcdf import NCWriter

__all__ = ["kelvin_depth", "shelfwave_depth", "dome_depth",
           "neverworld_depth", "AnalyticSeries", "kelvin_obc_series",
           "shelfwave_obc_series", "dome_inflow", "dome_inflow_z",
           "hurricane_wind_fn", "write_seasonal_forcing"]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def kelvin_depth(nx, ny, lenlon, lenlat, max_depth, min_depth,
                 coast_offset1=100.0, coast_offset2=10.0,
                 coast_angle_deg=11.3):
    """A coastal channel with angled coasts near both zonal ends
    (Kelvin_initialize_topography, Kelvin_initialization.F90:155-199).
    Lengths in km."""
    x = ((np.arange(nx) + 0.5) / nx * lenlon)[None, :] * np.ones((ny, 1))
    y = ((np.arange(ny) + 0.5) / ny * lenlat)[:, None] * np.ones((1, nx))
    ang = np.deg2rad(coast_angle_deg)
    D = np.full((ny, nx), max_depth)
    south = (x > coast_offset1) & (
        np.arctan2(y + coast_offset2, x - coast_offset1) < ang)
    north = (x < lenlon - coast_offset1) & (
        np.arctan2(lenlat + coast_offset2 - y,
                   lenlon - coast_offset1 - x) < ang)
    D = np.where(south | north, 0.5 * min_depth, D)
    return np.clip(D, 0.5 * min_depth, max_depth)


def shelfwave_depth(nx, ny, lenlat, max_depth, min_depth, ly=50.0):
    """The exponential cross-shore shelf D = H0 exp(2 y / Ly)
    (shelfwave_initialize_topography, shelfwave_initialization.F90:
    118-137); y in km from the southern (coastal) wall."""
    h0 = max(min_depth, 10.0)
    y = ((np.arange(ny) + 0.5) / ny * lenlat)[:, None]
    D = h0 * np.exp(2.0 * y / max(ly, 1e-3)) * np.ones((1, nx))
    return np.minimum(D, max_depth)


def dome_depth(nx, ny, lenlon, lenlat, max_depth, min_depth,
               shelf_depth=600.0, shelf_edge_lat=600.0,
               inflow_lon=1000.0, inflow_width=100.0, slope=0.01):
    """DOME: a slope basin with a shelf embayment to the north through
    which the dense water enters (DOME_initialize_topography,
    DOME_initialization.F90:40-110).  Lengths in km; the slope in m of
    depth per m of latitude."""
    x = ((np.arange(nx) + 0.5) / nx * lenlon)[None, :] * np.ones((ny, 1))
    y = ((np.arange(ny) + 0.5) / ny * lenlat)[:, None] * np.ones((1, nx))
    basin = np.minimum(shelf_depth - slope * (y - shelf_edge_lat) * 1e3,
                       max_depth)
    in_bay = (x > inflow_lon) & (x < inflow_lon + inflow_width)
    D = np.where(y < shelf_edge_lat, basin,
                 np.where(in_bay, shelf_depth, 0.5 * min_depth))
    return np.clip(D, 0.5 * min_depth, max_depth)


def _spike(x, L):
    return 1.0 - np.sin(np.pi * np.minimum(np.abs(x / L), 0.5))


def _cosbell(x, L):
    return 0.5 * (1.0 + np.cos(np.pi * np.minimum(np.abs(x / L), 1.0)))


def neverworld_depth(nx, ny, max_depth, roughness_amp=0.05,
                     continent_amp=1.0):
    """The Neverworld basin: a reentrant channel to the south, idealized
    "South America" / "Africa" continents, a Drake-passage sill and
    Scotia-arc ridges, plus wavy roughness
    (Neverworld_initialize_topography,
    src/user/Neverworld_initialization.F90:63-82).  Coordinates are the
    domain fractions x, y in [0, 1]; returns depth >= 0 (0 = land)."""
    x = ((np.arange(nx) + 0.5) / nx)[None, :] * np.ones((ny, 1))
    y = ((np.arange(ny) + 0.5) / ny)[:, None] * np.ones((1, nx))
    D = (1.0 - 1.1 * _spike(y - 1.0, 0.12) - 1.1 * _spike(y, 0.12)
         - continent_amp * (
             (1.2 * _spike(x, 0.2) + 1.2 * _spike(x - 1.0, 0.2))
             * _spike(np.minimum(0.0, y - 0.3), 0.2)          # S. America
             + 1.2 * _spike(x - 0.5, 0.2)
             * _spike(np.minimum(0.0, y - 0.55), 0.2)         # Africa
             + 1.2 * (_spike(x, 0.12) + _spike(x - 1.0, 0.12))
             * _spike(np.maximum(0.0, y - 0.06), 0.12)        # Peninsula
             + 0.1 * (_cosbell(x, 0.1) + _cosbell(x - 1.0, 0.1))  # Drake
             + 0.5 * _cosbell(x - 0.16, 0.05)
             * _cosbell(y - 0.18, 0.13) ** 0.4                # Scotia E
             + 0.4 * _cosbell(x - 0.09, 0.08) ** 0.4
             * _cosbell(y - 0.26, 0.05)                       # Scotia N
             + 0.4 * _cosbell(x - 0.08, 0.08) ** 0.4
             * _cosbell(y - 0.1, 0.05))                       # Scotia S
         - roughness_amp * np.cos(14 * np.pi * x) * np.sin(14 * np.pi * y)
         - roughness_amp * np.cos(20 * np.pi * x) * np.cos(20 * np.pi * y))
    return np.maximum(D, 0.0) * max_depth


class AnalyticSeries:
    """A segment series whose records are computed: ``fn`` maps model
    time [s] to the along-segment values (read like a
    TimeSeriesField, with ``at_time`` in days)."""

    def __init__(self, fn):
        self._fn = fn

    def at_time(self, t_days):
        return self._fn(t_days * 86400.0)


def kelvin_obc_series(segments, G, g_earth, f0, ssh_amp=1.0,
                      wave_period=12.42 * 3600.0):
    """A mode-0 coastal Kelvin wave at the W and S segments
    (Kelvin_set_OBC_data, Kelvin_initialization.F90:265-345, coast angle
    0): SSH = a exp(-f y / c) cos(w t) and the normal velocity
    (c / D) a exp(-f y / c) sin(w t), c = sqrt(g D) the local external
    wave speed.  Returns the provider's (key, slice, series) entries."""
    bathy = _host(G.bathyT)
    latT = _host(G.geoLatT)
    lonT = _host(G.geoLonT)
    y0 = latT.min() - 0.5 * (latT[1, 0] - latT[0, 0]) \
        if G.ny > 1 else latT.min()
    omega = 2.0 * np.pi / wave_period
    out = []
    for seg in segments:
        if seg.edge not in ("W", "S"):
            continue
        fsl, csl = segment_slices(seg.edge, seg.lo, seg.hi, G.ny, G.nx)
        if seg.edge == "W":
            y_m = (latT[csl] - y0) * 1e3         # offshore distance [m]
        else:
            x0 = lonT.min() - 0.5 * (lonT[0, 1] - lonT[0, 0]) \
                if G.nx > 1 else lonT.min()
            y_m = (lonT[csl] - x0) * 1e3
        D = np.maximum(bathy[csl], 1.0)
        c = np.sqrt(g_earth * D)
        decay = ssh_amp * np.exp(-abs(f0) * y_m / c)

        def ssh_fn(t, decay=decay):
            return decay * np.cos(omega * t)

        def vel_fn(t, decay=decay, c=c, D=D):
            return decay * np.sin(omega * t) * c / D

        out.append(("SSH", csl, AnalyticSeries(ssh_fn)))
        out.append(("U" if seg.edge in ("E", "W") else "V", fsl,
                    AnalyticSeries(vel_fn)))
    return out


def shelfwave_obc_series(segments, G, f0, amp=0.1, lx=100.0, ly=50.0,
                         y_mode=1.0, lenlat=None):
    """A continental shelf wave entering at the W segments
    (shelfwave_set_OBC_data, shelfwave_initialization.F90:139-215):
    normal velocity amp e^{-alpha y} cos(l x - w t) (alpha sin(k y)
    + k cos(k y)) / k, alpha = 1/Ly, l = 2 pi/Lx, k = j pi/LENLAT, and
    the shelf-wave frequency w = 2 alpha f l / (k^2 + alpha^2 + l^2);
    km units."""
    latT = _host(G.geoLatT)
    if lenlat is None:
        lenlat = latT.max() - latT.min() + (latT[1, 0] - latT[0, 0])
    alpha = 1.0 / max(ly, 1e-6)
    ll = 2.0 * np.pi / max(lx, 1e-6)
    kk = y_mode * np.pi / max(lenlat, 1e-6)
    omega = 2.0 * alpha * f0 * ll / (kk * kk + alpha * alpha + ll * ll)
    y0 = latT.min() - 0.5 * (latT[1, 0] - latT[0, 0])
    out = []
    for seg in segments:
        if seg.edge != "W":
            continue
        fsl, _ = segment_slices(seg.edge, seg.lo, seg.hi, G.ny, G.nx)
        y_km = latT[fsl] - y0
        shape = np.exp(-alpha * y_km) * (
            alpha * np.sin(kk * y_km) + kk * np.cos(kk * y_km)) / kk

        def vel_fn(t, shape=shape):
            return amp * shape * np.cos(-omega * t)

        out.append(("U", fsl, AnalyticSeries(vel_fn)))
    return out


def dome_inflow(nz, x_face_km, g_earth, rho0, density_range=2.0,
                d_edge=300.0, ri_trans=1.0 / 3.0, f_inflow=1.0e-4,
                inflow_lon=1000.0):
    """The geostrophic constant-Richardson inflow of the DOME embayment
    (DOME_set_OBC_data, DOME_initialization.F90:420-460): layer k flows
    south at v_k = -sqrt(D g') log((2 + Ri (1 + 2 rc)) / (2 - Ri)),
    decaying east of the inflow edge over the deformation radius.
    Returns (v (nz, n_face) [m s-1, negative into the domain], the
    deformation radius [km])."""
    gp = g_earth / rho0 * density_range
    def_rad = np.sqrt(d_edge * gp) / abs(f_inflow)       # [m]
    rc = -1.0 + np.arange(nz) / max(nz - 1, 1)           # -1 light .. 0 dense
    v_k = -np.sqrt(d_edge * gp) * np.log(
        (2.0 + ri_trans * (1.0 + 2.0 * rc)) / (2.0 - ri_trans))
    xdist = np.maximum(np.asarray(x_face_km) - inflow_lon, 0.0) * 1e3
    prof = np.exp(-2.0 * xdist / def_rad)
    return v_k[:, None] * prof[None, :], def_rad / 1e3


def dome_inflow_z(nz, x_face_km, depth_face, max_depth, g_earth, rho0,
                  density_range=2.0, d_edge=300.0, ri_trans=1.0 / 3.0,
                  f_inflow=1.0e-4, inflow_lon=1000.0):
    """:func:`dome_inflow` in depth on the local z* column of each face,
    as the reference remaps segment data onto the local grid
    (update_OBC_segment_data): the inflow fills the bottom ``d_edge``
    metres, rc = -min(hb / d_edge, 1) of the height above the bottom hb.
    Returns (v (nz, n_face), rc (nz, n_face), the deformation radius
    [km])."""
    gp = g_earth / rho0 * density_range
    def_rad = np.sqrt(d_edge * gp) / abs(f_inflow)
    D = np.asarray(depth_face, np.float64)[None, :]
    cum = np.cumsum(np.full(nz, max_depth / nz))
    e = np.minimum(np.concatenate([[0.0], cum])[:, None], D)  # interfaces
    centers = 0.5 * (e[1:] + e[:-1])                          # (nz, nf)
    hb = np.maximum(D - centers, 0.0)
    rc = -np.minimum(hb / max(d_edge, 1e-3), 1.0)
    v_k = -np.sqrt(d_edge * gp) * np.log(
        (2.0 + ri_trans * (1.0 + 2.0 * rc)) / (2.0 - ri_trans))
    xdist = np.maximum(np.asarray(x_face_km) - inflow_lon, 0.0) * 1e3
    prof = np.exp(-2.0 * xdist / def_rad)
    return v_k * prof[None, :], rc, def_rad / 1e3


_HURR_DEFAULTS = dict(
    rho_a=1.2, p_ambient=101200.0, p_central=96800.0, rad_max=50.0e3,
    rad_edge=10.0, rad_ambient=12.0, vmax=65.0, trans_spd=5.0,
    trans_dir_deg=180.0, x0=0.0, y0=0.0,
    # Zhang & Uhlhorn (2012) inflow-angle fit
    a0_0=-14.33, a0_rnorm=-0.9, a0_speed=-0.09,
    a1_0=0.14, a1_rnorm=0.04, a1_speed=0.05,
    p1_0=85.31, p1_rnorm=6.88, p1_speed=-9.60,
    # Sullivan et al. (2010)-style piecewise drag
    cd_calm=1.2e-3, calm_speed=11.0, cd_windy=1.8e-3, windy_speed=20.0,
    cd_intercept=0.49, dcd_du10=0.065)


def _holland_u10(radius, absf, p):
    """10-m wind speed of the Holland (1980) gradient-wind profile with
    the rad_edge..rad_ambient linear taper (Idealized_Hurricane.F90:
    585-612, dimensionally-consistent form)."""
    dP = p["p_ambient"] - p["p_central"]
    B = p["vmax"] ** 2 * p["rho_a"] * np.e / dP
    rr = radius / p["rad_max"]
    rr_c = np.clip(rr, 1e-3, None)
    rmB_in = rr_c ** (-B)
    rmB_edge = p["rad_edge"] ** (-B)

    def core(rmB, rad):
        tmpA = rmB * B * dP
        tmpB = (0.5 * rad * absf) * p["rho_a"]
        return (tmpA * np.exp(-rmB)) / (
            tmpB + np.sqrt(tmpA * p["rho_a"] * np.exp(-rmB)
                           + tmpB * tmpB))

    u_in = core(rmB_in, radius)
    taper = np.clip((p["rad_ambient"] - rr)
                    / (p["rad_ambient"] - p["rad_edge"]), 0.0, 1.0)
    u_out = core(rmB_edge, p["rad_edge"] * p["rad_max"]) * taper
    u10 = np.where(rr <= p["rad_edge"], u_in, u_out)
    return np.where((rr > 1e-3) & (rr < p["rad_ambient"]), u10, 0.0)


def _hurricane_stress(xx, yy, absf, p):
    """Wind stress components at storm-relative positions (xx, yy) [m]
    (idealized_hurricane_wind_profile, Idealized_Hurricane.F90:461-660,
    modern expressions; no current-relative stress)."""
    radius = np.sqrt(xx * xx + yy * yy)
    u10 = _holland_u10(radius, absf, p)
    adir = np.arctan2(yy, xx)
    rr = radius / p["rad_max"]
    tdir = np.deg2rad(p["trans_dir_deg"])

    rstr = np.minimum(p["rad_edge"], rr)
    a0 = (p["a0_rnorm"] * rstr + p["a0_speed"] * p["vmax"]) + p["a0_0"]
    a1 = -a0 * ((p["a1_rnorm"] * rstr
                 + p["a1_speed"] * p["trans_spd"]) + p["a1_0"])
    p1 = np.deg2rad((p["p1_rnorm"] * rstr
                     + p["p1_speed"] * p["trans_spd"]) + p["p1_0"])
    alph = np.deg2rad(a0 - a1 * np.cos((tdir - adir) - p1))
    taper = np.clip((p["rad_ambient"] - rr)
                    / (p["rad_ambient"] - p["rad_edge"]), 0.0, 1.0)
    alph = np.where(rr > p["rad_edge"], alph * taper, alph)

    u_ts = p["trans_spd"] * 0.5 * np.cos(tdir)
    v_ts = p["trans_spd"] * 0.5 * np.sin(tdir)
    du = u10 * np.sin(adir - np.pi - alph) + u_ts
    dv = u10 * np.cos(adir - alph) + v_ts

    du10 = np.sqrt(du * du + dv * dv)
    cd = np.where(du10 < p["calm_speed"], p["cd_calm"],
                  np.where(du10 < p["windy_speed"],
                           (p["cd_intercept"]
                            + p["dcd_du10"] * du10) * 1e-3,
                           p["cd_windy"]))
    return p["rho_a"] * cd * du10 * du, p["rho_a"] * cd * du10 * dv


def hurricane_wind_fn(G, overrides=None):
    """Build t_seconds -> (taux, tauy) numpy fields on the C-grid faces
    for the translating idealized hurricane
    (idealized_hurricane_wind_forcing, Idealized_Hurricane.F90:336-456).
    Cartesian grids only (coordinates in km)."""
    p = dict(_HURR_DEFAULTS)
    if overrides:
        p.update(overrides)
    latT = _host(G.geoLatT)
    lonT = _host(G.geoLonT)
    lonQ = _host(G.geoLonBu)
    latQ = _host(G.geoLatBu)
    f_q = np.abs(_host(G.CoriolisBu))
    # u faces: (x_q, y_t); v faces: (x_t, y_q); f averaged to the faces
    x_u = lonQ[0:1, :] * 1e3 * np.ones((G.ny, 1))
    y_u = latT[:, 0:1] * 1e3 * np.ones((1, G.nx))
    x_v = lonT[0:1, :] * 1e3 * np.ones((G.ny, 1))
    y_v = latQ[:, 0:1] * 1e3 * np.ones((1, G.nx))
    f_u = 0.5 * (f_q + np.roll(f_q, 1, axis=0))
    f_v = 0.5 * (f_q + np.roll(f_q, 1, axis=1))
    mu = _host(G.mask2dCu)
    mv = _host(G.mask2dCv)
    tdir = np.deg2rad(p["trans_dir_deg"])

    def wind_at(t_seconds):
        xc = p["x0"] + t_seconds * p["trans_spd"] * np.cos(tdir)
        yc = p["y0"] + t_seconds * p["trans_spd"] * np.sin(tdir)
        tx, _ = _hurricane_stress(x_u - xc, y_u - yc, f_u, p)
        _, ty = _hurricane_stress(x_v - xc, y_v - yc, f_v, p)
        return tx * mu, ty * mv

    return wind_at


def write_seasonal_forcing(path, *, len_lon=2000.0, len_lat=2000.0,
                  n_lon=9, n_lat=8, tau0=0.1, q0=80.0):
    """forcing_monthly.nc of configs/seasonal_gyre (the twin of its
    make_forcing.py::write_forcing): 12 monthly records of wind stress
    and net heat flux on a coarse source grid in the model's km
    coordinates, at month centres [days]."""
    lon = np.linspace(-0.05 * len_lon, 1.05 * len_lon, n_lon)
    lat = np.linspace(-0.05 * len_lat, 1.05 * len_lat, n_lat)
    # record times at month centers [days]
    time = (np.arange(12) + 0.5) * (365.0 / 12.0)
    yfrac = (lat[:, None] - lat.min()) / (lat.max() - lat.min())
    taux = np.empty((12, n_lat, n_lon))
    heat = np.empty((12, n_lat, n_lon))
    for m in range(12):
        season = np.cos(2 * np.pi * (time[m] - 15.0) / 365.0)  # +1 winter
        taux[m] = -tau0 * (1.0 + 0.4 * season) * \
            np.cos(2 * np.pi * yfrac) * np.ones((1, n_lon))
        heat[m] = q0 * (np.cos(np.pi * yfrac) - 0.6 * season) * \
            np.ones((1, n_lon))
    w = NCWriter(path)
    w.define_var("time", [("time", 12)], units="days")[:] = time
    w.define_var("lon", [("lon", n_lon)], units="km")[:] = lon
    w.define_var("lat", [("lat", n_lat)], units="km")[:] = lat
    dims = [("time", 12), ("lat", n_lat), ("lon", n_lon)]
    w.define_var("STRESS_X", dims, units="Pa")[:] = taux
    w.define_var("STRESS_Y", dims, units="Pa")[:] = np.zeros_like(taux)
    w.define_var("heat", dims, units="W m-2")[:] = heat
    w.close()
    return path
