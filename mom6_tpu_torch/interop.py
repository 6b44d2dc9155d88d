"""Carry a configuration across from the JAX reference to the port.

The reference's ``Grid``, ``VerticalGrid``, ``OceanState`` (T, S,
E_meke, kv_shear and the passive tracers ``tr`` with the packages'
0-dim clocks included), ``MechForcing`` or ``Forcing`` (with its
``BuoyancyForcing``) and ``DynParams`` or ``MOMParams`` (with the
``BTParams``, ``ALEParams``, ``HorViscParams``, ``GMParams``,
``MEKEParams``, ``MLRestratParams``, ``DiabaticParams``,
``DiffusivityParams``, ``UnsplitParams`` and ``OBCParams`` they nest,
and the tracer packages of its ``TracerFlowControl``), the open
boundaries' ``OBCData`` and the BT_cont curves ``BTCont`` are exported
with :func:`export`
into plain dictionaries of numpy arrays and Python scalars (``np.asarray``
on each array), and the ``load_*`` functions turn those into the port's
objects on a given device (the card unless the caller asks for the CPU)
and dtype; the port's ``TracerFlowControl`` is rebuilt from the
package list and each package's fields.  A field that is set but not
ported raises.  This module does not import jax: the export works on any
dataclass or NamedTuple.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_tpu_torch.ale.ale import ALEParams
from mom6_tpu_torch.core.barotropic import BTParams
from mom6_tpu_torch.core.continuity_ppm import BTCont
from mom6_tpu_torch.core.dynamics_split_rk2 import DynParams, MechForcing
from mom6_tpu_torch.core.dynamics_unsplit import UnsplitParams
from mom6_tpu_torch.core.mom import Forcing, MOMParams
from mom6_tpu_torch.core.open_boundary import RX_MAX, OBCData, OBCParams
from mom6_tpu_torch.core.state import OceanState
from mom6_tpu_torch.framework.device import DEFAULT_DEVICE, resolve_device
from mom6_tpu_torch.grid.grid import Grid
from mom6_tpu_torch.grid.vertical import VerticalGrid
from mom6_tpu_torch.physics.lateral.hor_visc import HorViscParams
from mom6_tpu_torch.physics.lateral.meke import MEKEParams
from mom6_tpu_torch.physics.lateral.mixed_layer_restrat import \
    MLRestratParams
from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams)
from mom6_tpu_torch.physics.vertical.set_diffusivity import DiffusivityParams
from mom6_tpu_torch.tracers import packages

__all__ = ["export", "load_grid", "load_vgrid", "load_state",
           "load_forcing", "load_params", "load_tfc", "load_obc",
           "load_obc_data", "load_bt_cont", "load_all"]

# reference fields with no counterpart in the port that may carry a
# value: each only tunes a subsystem that is not ported (the wide-halo
# subcycle, the dynamic surface pressure, the passivity floor and the
# neutral scheme of tracer diffusion, the other regrid modes, frazil, the
# brine plume, BBL mixing, anisotropic viscosity), which the port rejects
# where it is switched on
_DROPPED = {
    "BTParams": {"halo_per_substep", "const_dyn_psurf",
                 "ice_strength_length", "dmin_dyn_psurf"},
    "MOMParams": {"khtr_passivity_min", "ndiff_scheme"},
    "ALEParams": {"shelf_depth", "adapt_time_ratio", "adapt_zoom_depth",
                  "adapt_zoom_coeff", "adapt_buoy_coeff", "adapt_alpha",
                  "adapt_drho0", "adapt_do_min", "hybgen_qrlx"},
    "DiabaticParams": {"tfreeze_form", "brine_plume_n", "brine_plume_frac"},
    "DiffusivityParams": {"bbl_cdrag", "bbl_mixing_max_decay", "von_karm"},
    "HorViscParams": {"aniso_mode", "aniso_n"},
}
# reference fields whose value the port fixes as a constant: the
# reference's value must be that constant
_FIXED = {"OBCParams": {"rx_max": RX_MAX}}
_PARAMS = {c.__name__: c for c in (DynParams, BTParams, MOMParams,
                                   ALEParams, HorViscParams, GMParams,
                                   MEKEParams, MLRestratParams,
                                   DiabaticParams, DiffusivityParams,
                                   UnsplitParams)}
# the ported tracer packages (the NPZD generic tracer is not ported)
_PACKAGES = {c.__name__: c for c in (
    packages.IdealAge, packages.RegionalDye, packages.RegionalDyes,
    packages.BoundaryImpulse, packages.PseudoSalt, packages.CFCPackage)}


def export(obj):
    """A reference container as a dict of numpy arrays and scalars
    (nested containers become nested dicts; None stays None)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):                         # the state's tracers
        return {"__type__": "dict", **{k: export(v) for k, v in obj.items()}}
    if hasattr(obj, "packages") and hasattr(obj, "registry"):
        return {"__type__": "TracerFlowControl",      # tracer flow control
                "packages": [export(pkg) for pkg in obj.packages]}
    if hasattr(obj, "_asdict"):                       # NamedTuple
        items = obj._asdict().items()
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        return np.asarray(obj)
    out = {"__type__": type(obj).__name__}
    for k, v in items:
        out[k] = export(v)
    return out


def _fields_for(cls, d: dict) -> dict:
    """The entries of ``d`` that are fields of ``cls``; raise on any
    other entry that carries data the port would silently drop."""
    names = {f.name for f in dataclasses.fields(cls)}
    dropped = _DROPPED.get(d.get("__type__"), set())
    fixed = _FIXED.get(d.get("__type__"), {})
    out = {}
    for k, v in d.items():
        if k == "__type__":
            continue
        if k in fixed:
            if v != fixed[k]:
                raise NotImplementedError(
                    f"{d.get('__type__')}.{k} = {v}: the port fixes it "
                    f"at {fixed[k]}")
        elif k in names:
            out[k] = v
        elif v is not None and k not in dropped:
            raise NotImplementedError(
                f"{d.get('__type__')}.{k} is set but not ported")
    return out


def _tensors(cls, d: dict, device, dtype) -> dict:
    device = resolve_device(device)
    out = {}
    for k, v in _fields_for(cls, d).items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            out[k] = torch.tensor(np.array(v), dtype=dtype, device=device)
        elif isinstance(v, np.ndarray):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def load_grid(d: dict, device=DEFAULT_DEVICE, dtype=torch.float32) -> Grid:
    return Grid(**_tensors(Grid, d, device, dtype))


def load_vgrid(d: dict, device=DEFAULT_DEVICE,
               dtype=torch.float32) -> VerticalGrid:
    return VerticalGrid(**_tensors(VerticalGrid, d, device, dtype))


def load_state(d: dict, device=DEFAULT_DEVICE,
               dtype=torch.float32) -> OceanState:
    """The state; the passive tracers and the packages' 0-dim clocks of
    ``tr`` stay tensors."""
    kw = _tensors(OceanState, d, device, dtype)
    if kw.get("tr") is not None:
        dev = resolve_device(device)
        kw["tr"] = {k: torch.tensor(np.array(v), dtype=dtype, device=dev)
                    for k, v in kw["tr"].items() if k != "__type__"}
    return OceanState(**kw)


def load_tfc(d: dict) -> packages.TracerFlowControl:
    """The port's TracerFlowControl from an exported one: each package
    rebuilt from its fields (arrays become tuples)."""
    pkgs = []
    for pd in d["packages"]:
        name = pd["__type__"]
        if name not in _PACKAGES:
            raise NotImplementedError(f"tracer package {name} is not "
                                      "ported")
        kw = {}
        for k, v in _fields_for(_PACKAGES[name], pd).items():
            if isinstance(v, np.ndarray):
                v = v.item() if v.ndim == 0 else tuple(v.tolist())
            kw[k] = v
        pkgs.append(_PACKAGES[name](**kw))
    return packages.TracerFlowControl(pkgs)


def load_obc(d: dict, device=DEFAULT_DEVICE,
             dtype=torch.float32) -> OBCParams:
    return OBCParams(**_tensors(OBCParams, d, device, dtype))


def load_obc_data(d: dict, device=DEFAULT_DEVICE,
                  dtype=torch.float32) -> OBCData:
    return OBCData(**_tensors(OBCData, d, device, dtype))


def load_bt_cont(d: dict, device=DEFAULT_DEVICE,
                 dtype=torch.float32) -> BTCont:
    return BTCont(**{k: torch.tensor(np.array(v), dtype=dtype,
                                     device=resolve_device(device))
                     for k, v in d.items() if k != "__type__"})


def load_forcing(d: dict, device=DEFAULT_DEVICE, dtype=torch.float32):
    """A MechForcing, or a Forcing with its mechanical and buoyancy
    parts and the open boundaries' data, as the reference's container
    was."""
    if d.get("__type__") != "Forcing":
        return MechForcing(**_tensors(MechForcing, d, device, dtype))
    kw = _fields_for(Forcing, d)
    return Forcing(
        mech=MechForcing(**_tensors(MechForcing, kw["mech"], device, dtype)),
        buoy=BuoyancyForcing(**_tensors(BuoyancyForcing, kw["buoy"], device,
                                        dtype)),
        obc_data=None if kw.get("obc_data") is None
        else load_obc_data(kw["obc_data"], device, dtype))


def load_params(d: dict, device=DEFAULT_DEVICE, dtype=torch.float32):
    """DynParams or MOMParams (and the parameter containers they nest;
    an OBCParams' arrays as tensors on ``device`` in ``dtype``).  Arrays
    become tuples; an unported subsystem that is set stays a dict, and
    the port raises when it meets it."""
    cls = _PARAMS[d["__type__"]]
    kw = {}
    for k, v in _fields_for(cls, d).items():
        if isinstance(v, dict) and v.get("__type__") in _PARAMS:
            v = load_params(v, device, dtype)
        elif isinstance(v, dict) and v.get("__type__") == "OBCParams":
            v = load_obc(v, device, dtype)
        elif isinstance(v, dict) and v.get("__type__") == \
                "TracerFlowControl":
            v = load_tfc(v)
        elif isinstance(v, np.ndarray):
            v = v.item() if v.ndim == 0 else tuple(v.tolist())
        kw[k] = v
    return cls(**kw)


def load_all(G, GV, state, params, forces, device=DEFAULT_DEVICE,
             dtype=torch.float32):
    """(G, GV, state, params, forces) of the port from the exported
    reference dictionaries."""
    return (load_grid(G, device, dtype), load_vgrid(GV, device, dtype),
            load_state(state, device, dtype),
            load_params(params, device, dtype),
            load_forcing(forces, device, dtype))
