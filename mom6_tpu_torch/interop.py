"""Carry a configuration across from the JAX reference to the port.

The reference's ``Grid``, ``VerticalGrid`` (its ``boussinesq`` flag
included), ``OceanState`` (T, S, E_meke, kv_shear, En_itide, frazil, the
model time, the stochastic patterns and their threefry key, the RK2b
pair du_av_inst/dv_av_inst, and the passive tracers ``tr`` with the
packages' 0-dim clocks included), ``MechForcing`` (the coupler's wave
imports and ice rigidity included) or ``Forcing`` (with its
``BuoyancyForcing``, the coupler's ``tr_fluxes`` and the analysis
increments ``oda_inc``), the coupler's ``IceOceanBoundary`` and
``DynParams`` or ``MOMParams`` (with the
``TidalForcingParams``, ``SALHarmonics``, ``SPPTParams``,
``BTParams``, ``ALEParams``, ``HorViscParams``, ``GMParams``,
``MEKEParams``, ``MLRestratParams``, ``DiabaticParams``,
``DiffusivityParams``, ``BulkMLParams``, ``EntrainDiffusiveParams``,
``SetViscParams``, ``WaveParams``, ``SpongeParams``, ``UnsplitParams``,
``OBCParams``, ``TidalMixingParams``, ``InternalTidesParams``,
``VarMixParams``, ``GeothermalParams``, ``OpacityParams``,
``KappaShearParams``, ``ConvectionParams``, ``DDiffParams``,
``ZBParams``, ``InterfaceFilterParams``, ``PorousBarrier`` and the
ice shelf's ``ShelfCoupling`` with its ``IceShelfParams`` they nest, the
barotropic ``lin_drag`` map of the tidal wave drag,
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
from mom6_tpu_torch.core.porous_barriers import PorousBarrier
from mom6_tpu_torch.core.state import OceanState
from mom6_tpu_torch.framework.device import DEFAULT_DEVICE, resolve_device
from mom6_tpu_torch.grid.grid import Grid
from mom6_tpu_torch.grid.vertical import VerticalGrid
from mom6_tpu_torch.physics.lateral.hor_visc import HorViscParams
from mom6_tpu_torch.physics.ice_shelf import IceShelfParams
from mom6_tpu_torch.physics.oda_incupd import IncrementalUpdate
from mom6_tpu_torch.physics.lateral.internal_tides import InternalTidesParams
from mom6_tpu_torch.physics.lateral.lateral_mixing_coeffs import \
    VarMixParams
from mom6_tpu_torch.physics.lateral.interface_filter import \
    InterfaceFilterParams
from mom6_tpu_torch.physics.lateral.meke import MEKEParams
from mom6_tpu_torch.physics.lateral.zanna_bolton import ZBParams
from mom6_tpu_torch.physics.lateral.self_attr_load import SALHarmonics
from mom6_tpu_torch.physics.lateral.tidal_forcing import TidalForcingParams
from mom6_tpu_torch.physics.stochastic import SPPTParams
from mom6_tpu_torch.physics.lateral.mixed_layer_restrat import \
    MLRestratParams
from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
from mom6_tpu_torch.physics.vertical.bulk_mixed_layer import BulkMLParams
from mom6_tpu_torch.physics.vertical.convection import (ConvectionParams,
                                                        DDiffParams)
from mom6_tpu_torch.physics.vertical.diabatic import (BuoyancyForcing,
                                                      DiabaticParams)
from mom6_tpu_torch.physics.shelf_coupling import ShelfCoupling
from mom6_tpu_torch.physics.vertical.entrain_diffusive import \
    EntrainDiffusiveParams
from mom6_tpu_torch.physics.vertical.kappa_shear import KappaShearParams
from mom6_tpu_torch.physics.vertical.opacity import (GeothermalParams,
                                                     OpacityParams)
from mom6_tpu_torch.physics.vertical.set_diffusivity import DiffusivityParams
from mom6_tpu_torch.physics.vertical.set_viscosity import SetViscParams
from mom6_tpu_torch.physics.vertical.sponge import SpongeParams
from mom6_tpu_torch.physics.vertical.tidal_mixing import TidalMixingParams
from mom6_tpu_torch.physics.waves import WaveParams
from mom6_tpu_torch.tracers import packages
from mom6_tpu_torch.tracers.bgc import NPZD

__all__ = ["export", "load_grid", "load_vgrid", "load_state",
           "load_forcing", "load_params", "load_tfc", "load_obc",
           "load_obc_data", "load_bt_cont", "load_iob", "load_all"]

# reference fields with no counterpart in the port that may carry a
# value (none: the wide-halo subcycle's are the port's too)
_DROPPED = {}
# reference fields whose value the port fixes as a constant: the
# reference's value must be that constant
_FIXED = {"OBCParams": {"rx_max": RX_MAX}}
_PARAMS = {c.__name__: c for c in (DynParams, BTParams, MOMParams,
                                   ALEParams, HorViscParams, GMParams,
                                   MEKEParams, MLRestratParams,
                                   DiabaticParams, DiffusivityParams,
                                   UnsplitParams, BulkMLParams,
                                   EntrainDiffusiveParams, SetViscParams,
                                   WaveParams, TidalMixingParams,
                                   InternalTidesParams, VarMixParams,
                                   GeothermalParams, KappaShearParams,
                                   IceShelfParams, OpacityParams,
                                   ConvectionParams, DDiffParams,
                                   ZBParams, InterfaceFilterParams,
                                   TidalForcingParams, SPPTParams)}
# the tracer packages
_PACKAGES = {c.__name__: c for c in (
    packages.IdealAge, packages.RegionalDye, packages.RegionalDyes,
    packages.BoundaryImpulse, packages.PseudoSalt, packages.CFCPackage,
    NPZD)}


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
    dev = resolve_device(device)
    if d.get("time") is not None:
        kw["time"] = torch.tensor(float(d["time"]), dtype=dtype, device=dev)
    if d.get("rng_key") is not None:
        # the key's two unsigned 32-bit words
        kw["rng_key"] = torch.tensor(np.asarray(d["rng_key"], np.int64),
                                     device=dev)
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
    parts, the open boundaries' data, the coupler's tracer fluxes and the
    analysis increments, as the reference's container was."""
    if d.get("__type__") != "Forcing":
        return MechForcing(**_tensors(MechForcing, d, device, dtype))
    kw = _fields_for(Forcing, d)
    tr_fluxes = kw.get("tr_fluxes")
    if tr_fluxes is not None:
        dev = resolve_device(device)
        tr_fluxes = {k: torch.tensor(np.array(v), dtype=dtype, device=dev)
                     for k, v in tr_fluxes.items() if k != "__type__"}
    return Forcing(
        mech=MechForcing(**_tensors(MechForcing, kw["mech"], device, dtype)),
        buoy=BuoyancyForcing(**_tensors(BuoyancyForcing, kw["buoy"], device,
                                        dtype)),
        obc_data=None if kw.get("obc_data") is None
        else load_obc_data(kw["obc_data"], device, dtype),
        tr_fluxes=tr_fluxes,
        oda_inc=None if kw.get("oda_inc") is None
        else IncrementalUpdate(**_tensors(IncrementalUpdate, kw["oda_inc"],
                                          device, dtype)))


def load_iob(d: dict, device=DEFAULT_DEVICE, dtype=torch.float32):
    """The port's IceOceanBoundary from an exported one, or from a dict
    {field: numpy array} of its fields (one import series for both
    caps)."""
    from mom6_tpu_torch.drivers.coupled_cap import IceOceanBoundary
    return IceOceanBoundary(**_tensors(IceOceanBoundary, d, device, dtype))


def load_params(d: dict, device=DEFAULT_DEVICE, dtype=torch.float32):
    """DynParams or MOMParams (and the parameter containers they nest;
    an OBCParams' and a SpongeParams' arrays and a BTParams' lin_drag map
    as tensors on ``device`` in ``dtype``).  Arrays
    become tuples; an unported subsystem that is set stays a dict, and
    the port raises when it meets it."""
    cls = _PARAMS[d["__type__"]]
    kw = {}
    for k, v in _fields_for(cls, d).items():
        if isinstance(v, dict) and v.get("__type__") in _PARAMS:
            v = load_params(v, device, dtype)
        elif isinstance(v, dict) and v.get("__type__") == "OBCParams":
            v = load_obc(v, device, dtype)
        elif isinstance(v, dict) and v.get("__type__") == "SpongeParams":
            v = SpongeParams(**_tensors(SpongeParams, v, device, dtype))
        elif isinstance(v, dict) and v.get("__type__") == "SALHarmonics":
            # the transform's matrices stay float32, as the reference's
            v = SALHarmonics(**_tensors(SALHarmonics, v, device,
                                        torch.float32))
        elif isinstance(v, dict) and v.get("__type__") == "PorousBarrier":
            v = PorousBarrier(**_tensors(PorousBarrier, v, device, dtype))
        elif isinstance(v, dict) and v.get("__type__") == "ShelfCoupling":
            kw_s = _tensors(ShelfCoupling, v, device, dtype)
            kw_s["melt"] = load_params(kw_s["melt"], device, dtype)
            v = ShelfCoupling(**kw_s)
        elif isinstance(v, dict) and v.get("__type__") == \
                "TracerFlowControl":
            v = load_tfc(v)
        elif cls is BTParams and k == "lin_drag" and \
                isinstance(v, np.ndarray) and v.ndim == 2:
            v = torch.tensor(np.array(v), dtype=dtype,
                             device=resolve_device(device))
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
