"""Restart (checkpoint and resume) registry
(twin of mom6_tpu/framework/restart.py).

The user-visible behaviour of MOM6's restart registry
(src/framework/MOM_restart.F90:27-33: register_restart_field,
save_restart, restore_state, query_initialized):

* fields are registered once at init with a name and a getter/setter
  pair on the state;
* ``save_restart`` writes every registered field and the run's time and
  step to one NetCDF file, written to a temporary name and renamed into
  place (a crash never leaves a half-written restart), or with
  ``io_layout=(jy, ix)`` to jy*ix tile files ``path.NNNN`` (FMS's
  IO_LAYOUT), each tagged with its origin;
* ``restore_state`` reads the file (or reassembles the tiles) and puts
  each field back on the template state's device in its dtype;
  ``query_initialized`` says which fields the file held.

Divergence from the reference (its registry, solo.py:217-231):
``register_state`` registers exactly the fields the state carries: h, u,
v, uh, vh, uhtr, vhtr; T and S; ``kv_shear``, ``E_meke`` and the open
boundaries' tracer reservoirs ``obc_res_T``/``obc_res_S`` where they are
allocated; and every tensor of ``state.tr``, the packages' 0-dim clocks
included (as ``tr_<name>``).  The reference registers ``kv_shear``
whenever KPP, ePBL or shear mixing is on, although the layered
coordinate does not allocate it (a layered restore then raises
KeyError), and registers neither ``E_meke``, the passive tracers nor the
reservoirs, so a split MEKE, tracer or reservoir run does not equal a
straight one (its reservoirs restart from the initial T and S).  Its
``restore_state`` also casts to float32 unless told otherwise, so its
float64 runs restart from float32 values; here the template's dtype
holds.  0-dim tensors are stored with shape (1,), since NetCDF-3 scalar
variables do not read back through ``var[:]``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mom6_tpu_torch.io.netcdf import NCWriter, read_nc

__all__ = ["RestartRegistry", "TRACER_PREFIX", "restart_differences"]

TRACER_PREFIX = "tr_"
_BASE = ("h", "u", "v", "uh", "vh", "uhtr", "vhtr")
_OPTIONAL = ("T", "S", "kv_shear", "E_meke", "obc_res_T", "obc_res_S")


@dataclasses.dataclass
class _Field:
    name: str
    getter: Callable[[Any], Any]
    setter: Callable[[Any, Any], Any]   # (state, value) -> new state
    units: str = ""
    longname: str = ""
    mandatory: bool = True


def _host(t) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.reshape(1) if a.ndim == 0 else a


class RestartRegistry:
    def __init__(self):
        self._fields: Dict[str, _Field] = {}
        self._locked = False
        self._restored: Optional[set] = None

    def register(self, name: str, getter, setter, *, units: str = "",
                 longname: str = "", mandatory: bool = True) -> None:
        if self._locked:
            raise RuntimeError("restart registry locked")
        if name in self._fields:
            raise ValueError(f"restart field {name} already registered")
        self._fields[name] = _Field(name, getter, setter, units, longname,
                                    mandatory)

    def register_state_attrs(self, names: List[str], **kw) -> None:
        """Register plain tensor attributes of the OceanState."""
        for n in names:
            self.register(
                n,
                getter=lambda s, n=n: getattr(s, n),
                setter=lambda s, v, n=n: s.replace(**{n: v}), **kw)

    def register_tracers(self, names: List[str], **kw) -> None:
        """Register entries of the state's tracer dict ``tr``."""
        def setter(s, v, n):
            tr = dict(s.tr)
            tr[n] = v
            return s.replace(tr=tr)

        for n in names:
            self.register(
                TRACER_PREFIX + n,
                getter=lambda s, n=n: s.tr[n],
                setter=lambda s, v, n=n: setter(s, v, n), **kw)

    def register_state(self, state) -> List[str]:
        """Register every field ``state`` carries (see the module's
        docstring); returns the registered names."""
        names = list(_BASE) + [n for n in _OPTIONAL
                               if getattr(state, n) is not None]
        self.register_state_attrs(names)
        if state.tr is not None:
            self.register_tracers(list(state.tr))
        return list(self._fields)

    def lock(self) -> None:
        self._locked = True

    @property
    def names(self) -> List[str]:
        return list(self._fields)

    def get(self, name: str, state):
        """The registered field ``name`` of ``state``."""
        return self._fields[name].getter(state)

    # -- save / restore -------------------------------------------------------

    def _arrays(self, state) -> Dict[str, np.ndarray]:
        out = {}
        for f in self._fields.values():
            val = f.getter(state)
            if val is not None:
                out[f.name] = _host(val)
        return out

    def save_restart(self, path: str, state, *, time_seconds: float = 0.0,
                     step: int = 0,
                     io_layout: "tuple[int, int] | None" = None) -> None:
        """Write the restart; ``io_layout=(jy, ix)`` splits every field's
        trailing (ny, nx) plane into jy*ix tiles written as files
        ``path.NNNN``, each tagged with its tile origin."""
        arrays = self._arrays(state)
        if io_layout is not None and tuple(io_layout) != (1, 1):
            self._save_distributed(path, arrays, time_seconds, step,
                                   io_layout)
            return
        tmp = path + ".tmp"
        w = NCWriter(tmp, global_attrs={
            "title": "mom6_tpu_torch restart",
            "time_seconds": float(time_seconds), "step": int(step)})
        for name, a in arrays.items():
            f = self._fields[name]
            w.write_static(name, a, units=f.units, long_name=f.longname)
        w.write_static("__time_seconds__", np.array([time_seconds]))
        w.write_static("__step__", np.array([step], dtype=np.int32))
        w.close()
        os.replace(tmp, path)

    @staticmethod
    def _save_distributed(path, arrays, time_seconds, step, io_layout):
        jy, ix = io_layout
        ny, nx = arrays["h"].shape[-2:]
        ys = [slice(r * ny // jy, (r + 1) * ny // jy) for r in range(jy)]
        xs = [slice(c * nx // ix, (c + 1) * nx // ix) for c in range(ix)]
        for r in range(jy):
            for c in range(ix):
                tile = path + f".{r * ix + c:04d}"
                tmp = tile + ".tmp"
                w = NCWriter(tmp, global_attrs={
                    "title": "mom6_tpu_torch restart tile",
                    "time_seconds": float(time_seconds),
                    "step": int(step),
                    "tile_j0": int(ys[r].start), "tile_i0": int(xs[c].start),
                    "global_ny": int(ny), "global_nx": int(nx),
                    "n_tiles": int(jy * ix)})
                for name, a in arrays.items():
                    # a field without the (ny, nx) plane (a clock) goes
                    # whole into every tile
                    whole = a.ndim < 2 or a.shape[-2:] != (ny, nx)
                    w.write_static(name, a if whole
                                   else a[..., ys[r], xs[c]])
                w.write_static("__time_seconds__",
                               np.array([time_seconds]))
                w.write_static("__step__", np.array([step], np.int32))
                w.close()
                os.replace(tmp, tile)

    def restore_state(self, path: str, state):
        """(state, time_seconds, step) with every registered field the
        file holds put on the template's device in its dtype; a missing
        mandatory field raises KeyError."""
        if not os.path.exists(path) and os.path.exists(path + ".0000"):
            data = self._read_distributed(path)
        else:
            data = read_nc(path)
        self._restored = set()
        for f in self._fields.values():
            if f.name in data:
                tmpl = f.getter(state)
                a = data[f.name]        # NetCDF-3 stores big-endian
                val = torch.as_tensor(a.astype(a.dtype.newbyteorder("=")))
                val = val.to(device=tmpl.device, dtype=tmpl.dtype)
                state = f.setter(state, val.reshape(tmpl.shape))
                self._restored.add(f.name)
            elif f.mandatory:
                raise KeyError(f"mandatory restart field {f.name} missing "
                               f"from {path}")
        time_s = float(data.get("__time_seconds__", np.zeros(1))[0])
        step = int(data.get("__step__", np.zeros(1, np.int32))[0])
        return state, time_s, step

    @staticmethod
    def _read_distributed(path):
        """Reassemble the ``path.NNNN`` tiles into global arrays."""
        from scipy.io import netcdf_file
        tiles = []
        n = 0
        while os.path.exists(path + f".{n:04d}"):
            tiles.append(path + f".{n:04d}")
            n += 1
        with netcdf_file(tiles[0], "r", mmap=False) as f0:
            ny, nx = int(f0.global_ny), int(f0.global_nx)
        data = {}
        whole = {}
        for t in tiles:
            with netcdf_file(t, "r", mmap=False) as f:
                j0, i0 = int(f.tile_j0), int(f.tile_i0)
                for name, var in f.variables.items():
                    a = np.array(var[:])
                    if name.startswith("__") or a.ndim < 2:
                        whole[name] = a
                        continue
                    if name not in data:
                        data[name] = np.zeros(a.shape[:-2] + (ny, nx),
                                              a.dtype)
                    sj = slice(j0, j0 + a.shape[-2])
                    si = slice(i0, i0 + a.shape[-1])
                    data[name][..., sj, si] = a
        data.update(whole)
        return data

    def query_initialized(self, name: str) -> bool:
        return self._restored is not None and name in self._restored


def restart_differences(path_a: str, path_b: str,
                        h_wet: float = 1e-3) -> Dict[str, float]:
    """Each field's largest difference between two restart files,
    relative to its max-abs in ``path_b``: T and S only where the layer
    of ``path_b`` is thicker than ``h_wet`` [m], u and v only on the faces
    whose mean thickness is (a vanished layer's values are free).  Raises
    ValueError if the files hold different fields."""
    from mom6_tpu_torch.io.netcdf import read_nc
    a, b = read_nc(path_a), read_nc(path_b)
    names = sorted(k for k in b if not k.startswith("__"))
    if sorted(k for k in a if not k.startswith("__")) != names:
        raise ValueError(f"restart fields {sorted(a)} against {sorted(b)}")
    h = np.asarray(b["h"], np.float64)
    wet = {"T": h > h_wet, "S": h > h_wet,
           "u": 0.5 * (h + np.roll(h, -1, -1)) > h_wet,
           "v": 0.5 * (h + np.roll(h, -1, -2)) > h_wet}
    out = {}
    for k in names:
        w = np.asarray(b[k], np.float64)
        d = np.abs(np.asarray(a[k], np.float64) - w)
        if k in wet:
            d = d * wet[k]
        out[k] = float(d.max() / max(np.abs(w).max(), 1e-300))
    return out
