"""Diagnostics mediator (twin of mom6_tpu/framework/diag_mediator.py).

The core behaviour of MOM6's diag_mediator
(src/framework/MOM_diag_mediator.F90:45-66) and diag_remap
(MOM_diag_remap.F90:1-27):

* ``register_diag_field(module, name, ...)`` declares a diagnostic and
  returns the handle ``post_data`` takes;
* ``post_data(handle, array)`` accumulates under the field's time
  reduction: mean (default), none (snapshot), min, max, rms;
* fields on the ``z``, ``rho`` or ``sigma`` vertical coordinate are
  remapped conservatively from the native layers at post time through
  ale/remapping.py (PLM, in float32 on the mediator's device, as the
  reference does in float32); ``update_remap_grids`` rebuilds the
  target grids from the current state;
* ``downsample=N`` coarsens a field by area-weighted NxN block means;
* ``parse_diag_table`` reads the FMS diag_table format and
  ``from_diag_table`` builds a mediator whose ``flush_all`` writes one
  NetCDF file per diag_table file entry.

Host-side orchestration with numpy accumulators; posts happen between
segments at the diagnostic cadence.  On a mesh of ranks
(parallel/mesh.py) every rank posts its tiles, which are gathered to the
mesh's rank 0 in a fixed order; rank 0 alone accumulates, remaps and
writes, the global fields a one-rank run would (the mediator's
``areaT``, ``geolat`` and ``geolon`` are the global fields).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from mom6_tpu_torch.ale.regridding import build_rho_grid
from mom6_tpu_torch.ale.remapping import PLM, remap_column
from mom6_tpu_torch.framework.stencil import (is_root, is_tile, off_mesh,
                                              to_root)
from mom6_tpu_torch.io.netcdf import NCWriter

__all__ = ["DiagMediator", "parse_diag_table", "DiagTable"]

_REDUCTIONS = ("mean", "none", "min", "max", "rms")


@dataclass
class _Diag:
    module: str
    name: str
    units: str = ""
    longname: str = ""
    reduction: str = "mean"
    vertical_coord: str = "native"   # 'native' | 'z' | 'rho' | 'sigma'
    downsample: int = 1
    out_name: str = ""               # output variable name (diag_table)
    file: str = ""                   # diag_table file group ("" = default)
    stagger: str = "h"               # 'h' | 'u' | 'v' | 'q' grid location
    acc: Optional[np.ndarray] = None
    n_posts: int = 0


@dataclass
class DiagTable:
    """Parsed diag_table: file groups and requested fields."""
    title: str = ""
    base_date: Tuple[int, ...] = ()
    # file_name -> (output_freq, freq_units)
    files: Dict[str, Tuple[float, str]] = field(default_factory=dict)
    # (module, field) -> (out_name, file_name, reduction)
    fields: List[Tuple[str, str, str, str, str]] = field(
        default_factory=list)


def _host(a) -> np.ndarray:
    """A tensor or an array as a float64 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _to_root(a):
    """A tile gathered to the mesh's rank 0 (None elsewhere); anything
    else as it is."""
    return to_root(a) if isinstance(a, torch.Tensor) and is_tile(a) else a


def _parse_reduction(tok: str) -> str:
    t = tok.strip().strip('"').lower()
    if t in (".true.", "true", "average", "avg", "mean"):
        return "mean"
    if t in (".false.", "false", "none"):
        return "none"
    if t in _REDUCTIONS:
        return t
    raise ValueError(f"unknown diag_table reduction {tok!r}")


def parse_diag_table(path: str) -> DiagTable:
    """Parse the FMS diag_table format (framework/_Diagnostics.dox):
    line 1 title, line 2 base date (6 ints), then quoted file lines
    ("name", freq, "freq_units", format, "time_units", "time_name") and
    field lines ("module", "field", "out_name", "file", "time_sampling",
    "reduction", "regional", packing), # comments allowed."""
    dt = DiagTable()
    lines = []
    with open(path) as f:
        for raw in f:
            s = raw.split("#", 1)[0].strip()
            if s:
                lines.append(s)
    if not lines:
        return dt
    dt.title = lines[0].strip('"')
    if len(lines) > 1:
        try:
            dt.base_date = tuple(int(x) for x in lines[1].split())
        except ValueError:
            dt.base_date = ()
    for s in lines[2:]:
        toks = [t.strip() for t in s.split(",")]
        if len(toks) >= 8:     # field line
            mod, fld, out, fname = (t.strip('"') for t in toks[:4])
            red = _parse_reduction(toks[5])
            dt.fields.append((mod, fld, out, fname, red))
        elif len(toks) >= 3:   # file line
            fname = toks[0].strip('"')
            try:
                freq = float(toks[1])
            except ValueError:
                freq = 0.0
            dt.files[fname] = (freq, toks[2].strip('"'))
    return dt


class DiagMediator:
    def __init__(self, z_targets: Optional[np.ndarray] = None,
                 rho_targets: Optional[np.ndarray] = None,
                 nz_sigma: Optional[int] = None,
                 areaT: Optional[np.ndarray] = None, device="cpu"):
        self._device = torch.device(device)
        self._diags: Dict[int, _Diag] = {}
        self._by_name: Dict[str, int] = {}
        self._next = 1
        self._z_targets = z_targets    # (nz_diag,) z-layer thicknesses [m]
        self._rho_targets = rho_targets  # (nz_rho,) layer target densities
        self._nz_sigma = nz_sigma
        self._areaT = None if areaT is None else np.asarray(areaT,
                                                            np.float64)
        # cached target thicknesses per coordinate (update_remap_grids)
        self._h_target: Dict[str, np.ndarray] = {}
        # CF axis metadata (set_axes)
        self._geolat = self._geolon = None
        self._time_units = "days since 0001-01-01 00:00:00"
        self._calendar = "no_calendar"

    def set_axes(self, *, geolat=None, geolon=None,
                 time_units: Optional[str] = None,
                 calendar: Optional[str] = None) -> None:
        """Attach CF coordinate metadata (the reference's diag axes,
        MOM_diag_mediator set_axes_info): 2-D geographic coordinates of
        cell centers, and the time units/calendar strings written with
        every flushed file's Time variable."""
        if geolat is not None:
            self._geolat = np.asarray(geolat, np.float64)
        if geolon is not None:
            self._geolon = np.asarray(geolon, np.float64)
        if time_units:
            self._time_units = time_units
        if calendar:
            self._calendar = calendar

    @classmethod
    def from_diag_table(cls, path: str, **kw) -> "DiagMediator":
        dm = cls(**kw)
        dm.table = parse_diag_table(path)
        for mod, fld, out, fname, red in dm.table.fields:
            vc = "native"
            base = fld
            for suffix, coord in (("_z", "z"), ("_rho", "rho"),
                                  ("_sigma", "sigma")):
                if fld.endswith(suffix):
                    base, vc = fld[: -len(suffix)], coord
            dm.register_diag_field(mod, fld, reduction=red,
                                   vertical_coord=vc, out_name=out,
                                   file=fname)
        return dm

    def requested(self, module: str, name: str) -> Optional[int]:
        """Handle if (module, name) was requested (diag_table mode), else
        None — the register_diag_field>0 idiom of the reference."""
        return self._by_name.get(f"{module}.{name}")

    def register_diag_field(self, module: str, name: str, *, units: str = "",
                            longname: str = "", time_avg: bool = True,
                            reduction: Optional[str] = None,
                            vertical_coord: str = "native",
                            downsample: int = 1, out_name: str = "",
                            file: str = "", stagger: str = "") -> int:
        key = f"{module}.{name}"
        if key in self._by_name:
            raise ValueError(f"diagnostic {key} already registered")
        if reduction is None:
            reduction = "mean" if time_avg else "none"
        if reduction not in _REDUCTIONS:
            raise ValueError(f"unknown reduction {reduction!r}")
        hid = self._next
        self._next += 1
        if not stagger:
            # known staggered prognostics/diagnostics; everything else
            # defaults to cell centers
            base = name
            for sfx in ("_z", "_rho", "_sigma"):
                if base.endswith(sfx):
                    base = base[: -len(sfx)]
            stagger = {"u": "u", "uh": "u", "uhtr": "u", "taux": "u",
                       "v": "v", "vh": "v", "vhtr": "v", "tauy": "v",
                       "RV": "q", "PV": "q"}.get(base, "h")
        self._diags[hid] = _Diag(module, name, units, longname, reduction,
                                 vertical_coord, downsample,
                                 out_name or name, file, stagger=stagger)
        self._by_name[key] = hid
        return hid

    # -- remap-grid maintenance (diag_update_remap_grids role) -------------

    def update_remap_grids(self, h, T=None, S=None, GV=None, eos=None,
                           bathy=None) -> None:
        """Rebuild the diagnostic target grids from the current state.
        Call whenever h changes (the reference calls it per thermo cycle).
        On a mesh only its rank 0 keeps the grids."""
        h, T, S = _to_root(h), _to_root(T), _to_root(S)
        if not is_root():
            return
        with off_mesh():
            self._update_remap_grids(h, T, S, GV, eos)

    def _update_remap_grids(self, h, T, S, GV, eos) -> None:
        h = _host(h)
        col = h.sum(axis=0)
        if self._z_targets is not None:
            dz = np.asarray(self._z_targets, np.float64)
            z_int = np.minimum(np.cumsum(dz)[:, None, None], col[None])
            z_int = np.concatenate([np.zeros((1,) + col.shape), z_int],
                                   axis=0)
            h_t = np.maximum(z_int[1:] - z_int[:-1], 1e-10)
            h_t *= (col / np.maximum(h_t.sum(axis=0), 1e-30))[None]
            self._h_target["z"] = h_t
        if self._nz_sigma:
            frac = np.full(self._nz_sigma, 1.0 / self._nz_sigma)
            self._h_target["sigma"] = frac[:, None, None] * col[None]
        if self._rho_targets is not None and T is not None:
            h_t = build_rho_grid(self._f32(h), self._f32(T), self._f32(S),
                                 GV, eos, np.asarray(self._rho_targets))
            self._h_target["rho"] = h_t.cpu().numpy().astype(np.float64)
        self._h_native = h

    def post_data(self, handle: int, data, h=None, bathy=None) -> None:
        """Accumulate one sample.  3-D fields on a diagnostic vertical
        coordinate are remapped using the grids from the last
        ``update_remap_grids`` (or ``h`` if passed explicitly).  On a mesh
        every rank posts its tile and only the mesh's rank 0 keeps it."""
        data, h = _to_root(data), _to_root(h)
        if not is_root():
            return
        with off_mesh():
            self._post(handle, data, h)

    def _post(self, handle: int, data, h) -> None:
        d = self._diags[handle]
        arr = _host(data)
        if d.vertical_coord != "native":
            h_src = _host(h) if h is not None \
                else getattr(self, "_h_native", None)
            if h_src is None:
                raise ValueError("diag on a vertical coordinate needs "
                                 "update_remap_grids (or h=) first")
            h_tgt = self._h_target.get(d.vertical_coord)
            if h_tgt is None:
                # z can be built on the fly from z_targets for backward
                # compatibility with direct post_data(h=...) callers
                if d.vertical_coord == "z" and self._z_targets is not None:
                    self.update_remap_grids(h_src)
                    h_tgt = self._h_target["z"]
                else:
                    raise ValueError(
                        f"no target grid for {d.vertical_coord!r}; pass "
                        f"{d.vertical_coord}_targets to DiagMediator")
            arr = self._remap(arr, h_src, h_tgt)
        if d.downsample > 1:
            arr = self._coarsen(arr, d.downsample)
        if d.acc is None or d.reduction == "none":
            acc = arr ** 2 if d.reduction == "rms" else arr.copy()
            d.acc = acc
            d.n_posts = 1
        elif d.reduction == "mean":
            d.acc += arr
            d.n_posts += 1
        elif d.reduction == "rms":
            d.acc += arr ** 2
            d.n_posts += 1
        elif d.reduction == "min":
            d.acc = np.minimum(d.acc, arr)
        elif d.reduction == "max":
            d.acc = np.maximum(d.acc, arr)

    def _f32(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(device=self._device, dtype=torch.float32)
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=self._device)

    def _remap(self, arr, h, h_t):
        out = remap_column(self._f32(arr), self._f32(h), self._f32(h_t),
                           PLM)
        return out.cpu().numpy().astype(np.float64)

    def _coarsen(self, arr, n):
        """Area-weighted NxN block mean over the trailing two axes."""
        ny, nx = arr.shape[-2:]
        my, mx = ny // n, nx // n
        a = arr[..., : my * n, : mx * n]
        w = self._areaT[: my * n, : mx * n] if self._areaT is not None \
            else np.ones((my * n, mx * n))
        shp = a.shape[:-2] + (my, n, mx, n)
        num = (a * w).reshape(shp).sum(axis=(-3, -1))
        den = w.reshape((my, n, mx, n)).sum(axis=(-3, -1))
        return num / np.maximum(den, 1e-300)

    # -- output -------------------------------------------------------------

    def _finalize(self, d: _Diag):
        if d.reduction == "mean":
            return d.acc / d.n_posts
        if d.reduction == "rms":
            return np.sqrt(d.acc / d.n_posts)
        return d.acc

    def flush(self, path: str, *, time_seconds: float = 0.0,
              only_file: Optional[str] = None) -> List[str]:
        """Write accumulated diagnostics; returns the list written.

        With axes attached (set_axes), files carry CF coordinates: a
        Time variable (units + calendar), shared yh/xh horizontal dims
        with 2-D geolat/geolon, and per-size vertical dims — instead of
        anonymous per-variable dimensions."""
        w = NCWriter(path, global_attrs={"time_seconds": float(time_seconds)})
        written = []
        have_axes = self._geolat is not None and self._geolon is not None
        if have_axes:
            ny, nx = self._geolat.shape
            w.write_static("Time", np.array([time_seconds / 86400.0]),
                           dims=[("Time", 1)], units=self._time_units,
                           long_name="model time",
                           attrs={"calendar": self._calendar,
                                  "cartesian_axis": "T"})
            hdims = [("yh", ny), ("xh", nx)]
            w.write_static("geolat", self._geolat, dims=hdims,
                           units="degrees_north",
                           long_name="latitude of cell centers")
            w.write_static("geolon", self._geolon, dims=hdims,
                           units="degrees_east",
                           long_name="longitude of cell centers")
        for d in self._diags.values():
            if d.acc is None or (only_file is not None
                                 and d.file != only_file):
                continue
            data = self._finalize(d)
            dims = attrs = None
            if have_axes and data.shape[-2:] == self._geolat.shape:
                # dims are shared for all staggerings (non-symmetric
                # layout: same array sizes), but the geolat/geolon
                # coordinates describe CELL CENTERS — face/corner
                # fields must not claim them (the reference writes
                # those on geolon_u/geolat_v axes)
                ax = {"h": ("yh", "xh"), "u": ("yh", "xq"),
                      "v": ("yq", "xh"), "q": ("yq", "xq")}[d.stagger]
                dims = [(f"z{n}", n) for n in data.shape[:-2]] \
                    + [(ax[0], data.shape[-2]), (ax[1], data.shape[-1])]
                if d.stagger == "h":
                    attrs = {"coordinates": "geolat geolon"}
            w.write_static(f"{d.module}_{d.out_name}", data,
                           units=d.units, long_name=d.longname or d.name,
                           dims=dims, attrs=attrs)
            written.append(f"{d.module}.{d.name}")
            d.acc = None
            d.n_posts = 0
        w.close()
        return written

    def flush_all(self, outdir: str, *, time_seconds: float = 0.0
                  ) -> Dict[str, List[str]]:
        """diag_table mode: one NetCDF per diag_table file group (on a
        mesh, written by its rank 0)."""
        import os
        files = sorted({d.file for d in self._diags.values()
                        if d.acc is not None})
        out = {}
        for fname in files:
            path = os.path.join(outdir, (fname or "ocean_diags") + ".nc")
            out[fname or "ocean_diags"] = self.flush(
                path, time_seconds=time_seconds, only_file=fname)
        return out
