"""Ocean-only driver (twin of mom6_tpu/drivers/solo.py: make_stepper,
make_mom_stepper, run_segment, main and the offline mode).

A stepper is an ``nn.Module`` whose buffers are the grid metrics, the
vertical grid and the forcing, so ``.to(device)`` moves the whole
configuration.  The reference's ``lax.scan`` over steps is a Python loop;
the device is synchronised only at the stats cadence.

The command line (MOM6's solo driver, MOM_driver.F90):

    python -m mom6_tpu_torch.drivers.solo RUNDIR [--days D]
        [--restart-in FILE] [--offline ARCHIVE] [--device cpu|cuda]

reads ``RUNDIR/MOM_input`` (and ``MOM_override``), runs on the card
unless ``--device cpu`` (without a card it raises), and writes
ocean.stats, ``MOM_parameter_doc.{all,short}``, ``ocean_diags.nc``,
``MOM.res.nc``, ``RESTART/ocean_solo.res``, ``time_stamp.out``,
``chksum_diag`` and ``ocean.cputime`` into RUNDIR.  A run directory
with a ``diag_table`` gets the fields it asks for, one NetCDF file per
file group of the table, each field served by diagnostics/catalog.py
at every stats segment (the KE budget from one extra split step and the
tendencies from one extra thermo cycle of the posted state); fields the
configuration cannot serve are listed with the reason in
``diag_rejected``, and an unknown name raises KeyError with the nearest
known names.

Divergences from the reference's ``main``: the restart registry holds
exactly the fields the state carries (framework/restart.py) and restores
them in the run's dtype; the driver's own parameters are read before the
model is built, so the model build's unknown-key check knows them and
``MOM_parameter_doc.all`` lists them too (the reference's lacks those
read after its model build wrote it, DAYMAX and ENERGYSAVEDAYS among
them); a run stopped by MAXCPU stamps its restart with the time it
reached (the reference stamps the planned end); a generated mosaic is
made in memory by build_model_from_params (no make_inputs.py);
``ocean_diags.nc`` carries the CF axes of ``_set_diag_axes``, which the
reference defines but does not call.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from mom6_tpu_torch.core.dynamics_split_rk2 import (DynParams, MechForcing,
                                                    step_dynamics_split_rk2)
from mom6_tpu_torch.core.mom import Forcing, MOMParams, step_mom
from mom6_tpu_torch.diagnostics.sum_output import (BudgetAudit, StatsWriter,
                                                   compute_stats,
                                                   compute_stats_device,
                                                   format_stats_line,
                                                   tracer_stocks)
from mom6_tpu_torch.framework import stencil
from mom6_tpu_torch.framework import time_manager as tm
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.framework.device import resolve_device

__all__ = ["DynStepper", "MOMStepper", "make_stepper", "make_mom_stepper",
           "make_ke_budget_fn", "make_tend_fn", "run_segment", "main",
           "driver_keys", "kernel_launches", "reset_kernel_launches"]


class _Stepper(nn.Module):
    """Registers the tensor fields of each named container as buffers."""

    def __init__(self, parts: dict):
        super().__init__()
        self._parts = parts
        for part, obj in parts.items():
            for name, t in tensor_fields(obj).items():
                self.register_buffer(f"{part}_{name}", t)

    def _rebuilt(self, part):
        obj = self._parts[part]
        return obj.replace(**{name: getattr(self, f"{part}_{name}")
                              for name in tensor_fields(obj)})


class DynStepper(_Stepper):
    """Advances an OceanState by ``steps_per_call`` split-RK2 steps."""

    def __init__(self, G, GV, params: DynParams, forces: MechForcing,
                 steps_per_call: int = 1):
        super().__init__({"G": G, "GV": GV, "forces": forces})
        self.params = params
        self.steps_per_call = steps_per_call

    def configuration(self):
        """(G, GV, forces) built from the module's current buffers."""
        return (self._rebuilt("G"), self._rebuilt("GV"),
                self._rebuilt("forces"))

    def forward(self, state):
        G, GV, forces = self.configuration()
        for _ in range(self.steps_per_call):
            state = step_dynamics_split_rk2(state, forces, G, GV,
                                            self.params)
        return state


class MOMStepper(_Stepper):
    """Advances an OceanState by ``cycles_per_call`` thermo cycles of
    core/mom.py::step_mom; the mechanical and the buoyancy forcing and
    the open boundaries' data are buffers."""

    def __init__(self, G, GV, params: MOMParams, forcing: Forcing,
                 cycles_per_call: int = 1):
        parts = {"G": G, "GV": GV, "mech": forcing.mech,
                 "buoy": forcing.buoy}
        if forcing.obc_data is not None:
            parts["obc_data"] = forcing.obc_data
        super().__init__(parts)
        self.params = params
        self.cycles_per_call = cycles_per_call

    def configuration(self):
        """(G, GV, forcing) built from the module's current buffers."""
        return (self._rebuilt("G"), self._rebuilt("GV"),
                Forcing(mech=self._rebuilt("mech"),
                        buoy=self._rebuilt("buoy"),
                        obc_data=self._rebuilt("obc_data")
                        if "obc_data" in self._parts else None))

    def forward(self, state):
        G, GV, forcing = self.configuration()
        for _ in range(self.cycles_per_call):
            state = step_mom(state, forcing, G, GV, self.params)
        return state


def make_stepper(G, GV, params: DynParams, forces: MechForcing,
                 steps_per_call: int = 1) -> DynStepper:
    """The stepper advancing the state ``steps_per_call`` steps a call."""
    return DynStepper(G, GV, params, forces, steps_per_call)


def make_mom_stepper(G, GV, params: MOMParams, forcing: Forcing,
                     cycles_per_call: int = 1) -> MOMStepper:
    """The stepper advancing the state ``cycles_per_call`` thermo cycles
    a call."""
    return MOMStepper(G, GV, params, forcing, cycles_per_call)


def run_segment(state, G, GV, params, forces, *, n_steps: int,
                stats_interval: int = 10, stats_path: Optional[str] = None,
                verbose: bool = False):
    """Run ``n_steps`` steps, writing stats every ``stats_interval``.

    With ``DynParams`` a step is one baroclinic step of the split-RK2
    dynamics (``forces`` a MechForcing); with ``MOMParams`` it is one
    thermo cycle of step_mom (``forces`` a Forcing), and the stats lines
    count baroclinic steps.  Returns (state, elapsed seconds)."""
    if isinstance(params, MOMParams):
        stepper = make_mom_stepper(G, GV, params, forces,
                                   cycles_per_call=stats_interval)
        dt, per_step = params.dyn.dt, params.n_dyn_per_thermo
    else:
        stepper = make_stepper(G, GV, params, forces,
                               steps_per_call=stats_interval)
        dt, per_step = params.dt, 1
    # on a mesh of ranks (parallel/mesh.py) only the first rank writes
    lead = stencil.is_root()
    writer = StatsWriter(stats_path) if stats_path and lead else None
    n_calls = n_steps // stats_interval
    t0 = time.time()
    with torch.inference_mode():
        for c in range(n_calls):
            state = stepper(state)
            step = (c + 1) * stats_interval * per_step
            if state.h.is_cuda:
                torch.cuda.synchronize(state.h.device)
            s = compute_stats(state, G, GV, dt)
            tdays = step * dt / 86400.0
            if writer:
                writer.write(step, tdays, s)
            if verbose and lead:
                print(format_stats_line(step, tdays, s))
    elapsed = time.time() - t0
    return state, elapsed


def make_ke_budget_fn(G, GV, params: MOMParams):
    """(state, forcing) -> the KE budget's terms of one split step from
    the state (diagnostics.py::ke_budget), for the diag_table."""
    from mom6_tpu_torch.core.mom import dyn_accel_diag
    from mom6_tpu_torch.diagnostics.diagnostics import ke_budget

    def f(state, forcing):
        s2, accel = dyn_accel_diag(state, forcing, G, GV, params)
        return ke_budget(state, s2, accel, G, params.dyn.dt)
    return f


def make_tend_fn(G, GV, params: MOMParams):
    """(state, forcing) -> the content tendencies of one thermo cycle
    from the state (step_mom's collect_tend), for the diag_table."""
    def f(state, forcing):
        return step_mom(state, forcing, G, GV, params, collect_tend=True)[1]
    return f


def _base_name(name: str) -> str:
    """A diag_table field's catalog name: without its _z, _rho or _sigma
    vertical-coordinate suffix."""
    for sfx in ("_z", "_rho", "_sigma"):
        if name.endswith(sfx):
            return name[: -len(sfx)]
    return name


def _table_setup(dm, state, params, forcing, G, GV, rundir):
    """Resolve every field of a diag_table mediator in the catalog (an
    unknown name raises KeyError with a hint), take each field's units,
    long name and staggering from it, and write the ones the
    configuration cannot serve with the reason to ``diag_rejected``.
    Returns (ke_budget_fn, tend_fn), each None when no field needs it."""
    from mom6_tpu_torch.diagnostics.catalog import (rejection_reason,
                                                    resolve)
    ke_budget_fn = make_ke_budget_fn(G, GV, params) if any(
        d.name.startswith("KE_") or d.name == "dKE_dt"
        for d in dm._diags.values()) else None
    tr_names = set(state.tr or ())
    bases = [(d, _base_name(d.name)) for d in dm._diags.values()]
    bases = [(d, b, resolve(b)) for d, b in bases if b not in tr_names]
    tend_fn = None
    if params.thermo_enabled \
            and params.diabatic.boundary_layer_scheme != "BULKML" \
            and any(e.needs in ("tend", "tend_frazil") for _, _, e in bases):
        tend_fn = make_tend_fn(G, GV, params)
    rejected = {}
    for d, base, entry in bases:
        d.units = d.units or entry.units
        d.longname = d.longname or entry.long_name
        if entry.stagger in ("u", "v", "q"):
            d.stagger = entry.stagger
        why = rejection_reason(base, state, params, forcing=forcing,
                               has_ke_budget=ke_budget_fn is not None,
                               has_tend=tend_fn is not None)
        if why:
            rejected[d.name] = why
    if rejected and stencil.is_root():
        print("diag_table fields rejected under this configuration:")
        with open(os.path.join(rundir, "diag_rejected"), "w") as fh:
            for nm, why in sorted(rejected.items()):
                print(f"  {nm}: {why}")
                fh.write(f"{nm}: {why}\n")
    return ke_budget_fn, tend_fn


def _post_table_diags(dm, state, G, GV, params, forcing, ke_budget_fn,
                      tend_fn=None):
    """Post every field of the diag_table the model can serve: a
    registered tracer by its name, anything else through the catalog,
    whose DiagContext computes each shared intermediate once.  The
    mediator's target grids (z, rho with T, S and the EOS, sigma) are
    rebuilt from the state first."""
    from mom6_tpu_torch.diagnostics.catalog import DiagContext, serve
    from mom6_tpu_torch.eos import get_eos
    eos = get_eos(params.eos_name) if params.thermo_enabled else None
    dm.update_remap_grids(state.h, T=state.T, S=state.S, GV=GV, eos=eos)
    ctx = DiagContext(state, G, GV, params, forcing=forcing, eos=eos,
                      ke_budget_fn=ke_budget_fn, tend_fn=tend_fn)
    for key, hid in list(dm._by_name.items()):
        base = _base_name(key.split(".", 1)[1])
        if state.tr is not None and base in state.tr:
            arr = state.tr[base]
        else:
            arr = serve(base, ctx)
        if arr is not None:
            dm.post_data(hid, arr)


def _kernel_counters() -> dict:
    """name -> (wrapper, the attribute that counts its kernel's launches)."""
    from mom6_tpu_torch.ale.remapping import remap_columns_multi
    from mom6_tpu_torch.core import continuity_ppm as cppm
    from mom6_tpu_torch.framework.solvers import tridiag_solve
    return {"tridiag": (tridiag_solve, "launches"),
            "ppm_edges_x": (cppm.zonal_edges, "launches"),
            "ppm_edges_y": (cppm.merid_edges, "launches"),
            "ppm_flux_x": (cppm.zonal_flux, "launches"),
            "ppm_flux_y": (cppm.merid_flux, "launches"),
            "ppm_edges_y_fold": (cppm.merid_edges, "fold_launches"),
            "ppm_flux_y_fold": (cppm.merid_flux, "fold_launches"),
            "ppm_edges_y_halo": (cppm.merid_edges, "halo_launches"),
            "remap": (remap_columns_multi, "launches"),
            "remap_npoly5": (remap_columns_multi, "quartic_launches")}


def kernel_launches() -> dict:
    """The launches of each hand-written kernel in this process since the
    last :func:`reset_kernel_launches`, as their wrappers count them (a
    CPU run launches none)."""
    return {k: getattr(w, attr) for k, (w, attr) in _kernel_counters().items()}


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    for w, attr in _kernel_counters().values():
        setattr(w, attr, 0)


def _set_diag_axes(dm, G, cal, start_time):
    """Attach CF axes to the diag mediator: the cells' geographic centres
    and the run's calendar and time-units strings."""
    y, mo, d, h, mi, s = tm.get_date(cal, start_time)
    units = (f"days since {y:04d}-{mo:02d}-{d:02d} "
             f"{h:02d}:{mi:02d}:{s:02d}")
    dm.set_axes(geolat=G.geoLatT.cpu().numpy(),
                geolon=G.geoLonT.cpu().numpy(), time_units=units,
                calendar=tm.calendar_name(cal).lower())


def _read_driver_params(pf, thermo: bool) -> dict:
    """The parameters the driver itself reads (MOM_driver.F90 and the
    reference's main), read before the model is built."""
    m = "MOM_driver"
    out = dict(
        dtype=torch.float64 if pf.get(
            "DOUBLE_PRECISION", bool, default=False, module="MOM",
            desc="Integrate in float64 (CPU verification mode)")
        else torch.float32,
        days=pf.get("DAYMAX", float, default=1.0, units="days", module=m),
        esd=pf.get("ENERGYSAVEDAYS", float, default=0.0, units="days",
                   module="MOM_sum_output",
                   desc="Interval between ocean.stats energy statements"),
        calendar=pf.get("CALENDAR", str, default="NO_CALENDAR", module=m,
                        desc="Calendar: NO_CALENDAR, THIRTY_DAY, JULIAN, "
                        "GREGORIAN or NOLEAP"),
        start_date=[int(v) for v in pf.get_list(
            "START_DATE", default=[1, 1, 1, 0, 0, 0], module=m,
            desc="Model start date: year,month,day,hour,minute,second")],
        archive=pf.get("OFFLINE_TRANSPORT_FILE", str, default="",
                       module="MOM", desc="If set, archive per-segment "
                       "transports for offline mode"),
        dtbt_reset=pf.get("DTBT_RESET_PERIOD", float, default=-1.0,
                          units="s", module="MOM",
                          desc="Period between dtbt recalculations; 0 every "
                          "segment, <0 never"),
        maxcpu=pf.get("MAXCPU", float, default=-1.0, units="wall s",
                      module="MOM", desc="Wall-clock budget; <0 no limit"),
        debug_nans=pf.get("DEBUG_CHECK_NANS", bool, default=False,
                          module="MOM", desc="Stop with a per-field report "
                          "if the state goes non-finite"),
        io_layout=tuple(int(v) for v in pf.get_list(
            "IO_LAYOUT", default=[1, 1], module="MOM")[:2]),
        ctrl=None)
    m = "MOM_controlled_forcing"
    if thermo and pf.get("CONTROLLED_FORCING", bool, default=False,
                         module=m, desc="P+I surface-flux feedback toward "
                         "climatology"):
        out["ctrl"] = dict(
            sst=pf.get("CTRL_SST_TARGET", float, default=10.0,
                       units="degC", module=m),
            sss=pf.get("CTRL_SSS_TARGET", float, default=35.0, units="ppt",
                       module=m),
            lam_heat=pf.get("CTRL_FORCE_HEAT_RATE", float, default=0.0,
                            units="W m-2 K-1", module=m),
            lam_prec=pf.get("CTRL_FORCE_PREC_RATE", float, default=0.0,
                            module=m),
            lam_int_period=pf.get("CTRL_FORCE_INTEGRAL_PERIOD", float,
                                  default=0.0, units="s", module=m))
    return out


def driver_keys() -> frozenset:
    """Every key the driver reads itself (the controller's included): a
    run directory's MOM_input may hold them beside the model's keys."""
    from mom6_tpu_torch.framework.config import ParamFile
    pf = ParamFile(text="CONTROLLED_FORCING = True")
    _read_driver_params(pf, thermo=True)
    return frozenset(pf.logged_keys())


def _dtbt_fn(params, G, GV):
    """state -> the largest stable barotropic substep [s]."""
    from mom6_tpu_torch.core.barotropic import dtbt_max_from_state
    from mom6_tpu_torch.core.pressure_force import (
        pressure_force_fv, pressure_force_montgomery)
    from mom6_tpu_torch.eos import get_eos

    def f(state):
        if params.thermo_enabled:
            out = pressure_force_fv(state.h, state.T, state.S, G, GV,
                                    get_eos(params.eos_name))
        else:
            out = pressure_force_montgomery(state.h, G, GV)
        return float(dtbt_max_from_state(state.h, out.pbce, G,
                                         params.dyn.bt.bebt))
    return f


def main(argv=None, *, device=None):
    """The command-line solo driver (program MOM6,
    config_src/drivers/solo_driver/MOM_driver.F90): reads MOM_input and
    MOM_override from a run directory, integrates, and writes ocean.stats,
    the parameter docs, the diagnostics and the restart.  ``device``
    (for in-process callers) overrides ``--device``.  Returns the final
    state (the tracers' stack in offline mode)."""
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.checksums import chksum_line
    from mom6_tpu_torch.framework.config import ParamFile
    from mom6_tpu_torch.framework.diag_mediator import DiagMediator
    from mom6_tpu_torch.framework.restart import RestartRegistry
    from mom6_tpu_torch.framework.timers import report as timer_report
    from mom6_tpu_torch.framework.timers import reset as timer_reset
    from mom6_tpu_torch.framework.timers import timer

    ap = argparse.ArgumentParser(prog="mom6_tpu_torch.drivers.solo")
    ap.add_argument("rundir", help="directory containing MOM_input")
    ap.add_argument("--days", type=float, default=None,
                    help="override DAYMAX")
    ap.add_argument("--restart-in", default=None)
    ap.add_argument("--offline", default=None, metavar="ARCHIVE",
                    help="offline tracer mode: advance tracers with the "
                    "transports stored in ARCHIVE by an online run with "
                    "OFFLINE_TRANSPORT_FILE, without the dynamics")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    rundir = args.rundir

    paths = [os.path.join(rundir, "MOM_input")]
    ov = os.path.join(rundir, "MOM_override")
    if os.path.exists(ov):
        paths.append(ov)
    pf = ParamFile(paths)
    drv = _read_driver_params(pf, pf.get(
        "ENABLE_THERMODYNAMICS", bool, default=True, module="MOM"))
    setup = build_model_from_params(pf, dtype=drv["dtype"], device=device,
                                    doc_dir=rundir)
    G, GV, state, params, forcing = (setup.grid, setup.vgrid, setup.state,
                                     setup.params, setup.forcing)
    days = drv["days"] if args.days is None else args.days
    dt_cycle = params.dyn.dt * params.n_dyn_per_thermo
    n_cycles = max(1, int(round(days * 86400.0 / dt_cycle)))
    # ENERGYSAVEDAYS sets the ocean.stats cadence
    # (MOM_sum_output.F90:223-233); else ~20 statements a run
    if drv["esd"] > 0.0:
        stats_every = min(n_cycles, max(1, int(round(
            drv["esd"] * 86400.0 / dt_cycle))))
    else:
        stats_every = max(1, n_cycles // 20)

    reg = RestartRegistry()
    reg.register_state(state)
    reg.lock()

    # calendar and the ocean_solo.res segment protocol
    # (MOM_driver.F90:225-300)
    cal = tm.calendar_from_name(drv["calendar"])
    start_time = tm.set_date(cal, *drv["start_date"][:6])
    seg_start = start_time
    solo_res = os.path.join(rundir, "ocean_solo.res")
    if os.path.exists(solo_res):
        cal, start_time, seg_start = tm.read_ocean_solo_res(solo_res)
    t0 = float(seg_start.total_seconds() - start_time.total_seconds())
    if args.restart_in:
        state, t0, _ = reg.restore_state(args.restart_in, state)

    if args.offline:
        return _run_offline(args.offline, rundir, setup, dt_cycle,
                            stats_every)

    # the interval transports and end thicknesses an offline run reads
    # back (MOM_offline_main.F90)
    arc_rec = {"h_start": [], "h_end": [], "uhtr": [], "vhtr": []} \
        if drv["archive"] else None

    provider = setup.forcing_provider
    ctrl = None
    if drv["ctrl"] is not None:
        from mom6_tpu_torch.diagnostics.diagnostics import \
            extract_surface_state
        from mom6_tpu_torch.framework.controlled_forcing import \
            ControlledForcing
        c = drv["ctrl"]
        tgt = forcing.buoy.t_restore
        sst_t = tgt.cpu().numpy().astype(np.float64) if tgt is not None \
            else np.full((G.ny, G.nx), c["sst"])
        ctrl = ControlledForcing(
            sst_t, sss_target=np.full((G.ny, G.nx), c["sss"]),
            lam_heat=c["lam_heat"], lam_prec=c["lam_prec"],
            lam_int_period=c["lam_int_period"])

    # dynamic barotropic substep (the DTBT_RESET_PERIOD role,
    # MOM_dynamics_split_RK2.F90:661-668): the parameters take the new
    # substep count
    dtbt_fn = None
    if params.unsplit is None and drv["dtbt_reset"] >= 0.0:
        dtbt_fn = _dtbt_fn(params, G, GV)
        dtbt_frac = abs(pf.get("DTBT", float, default=-0.98,
                               module="MOM_barotropic"))
    t_last_reset = t0

    writer = StatsWriter(os.path.join(rundir, "ocean.stats"))
    cp = params.diabatic.cp if params.thermo_enabled else 3991.87
    # float32 runs sum ocean.stats on the device, float64 runs on the
    # host; the audit's baseline comes from the same path as the lines
    if state.h.dtype == torch.float32:
        def stats_of(st):
            return compute_stats_device(st, G, GV, params.dyn.dt, cp=cp)
    else:
        def stats_of(st):
            return compute_stats(st, G, GV, params.dyn.dt, cp=cp)
    with torch.inference_mode():
        audit = BudgetAudit(stats_of(state), cp=cp)

    # a diag_table's fields through the catalog, else the default
    # diagnostics: time means of h, u, v (T, S) and SSH
    nz = state.h.shape[0]
    z_targets = np.asarray(params.ale.dz_nominal) if params.ale.dz_nominal \
        else np.full(nz, float(G.bathyT.max()) / nz)
    dt_path = os.path.join(rundir, "diag_table")
    use_table = os.path.exists(dt_path)
    if use_table:
        rho_targets = GV.Rlay.cpu().numpy().astype(np.float64) \
            if params.thermo_enabled and GV.Rlay is not None else None
        dm = DiagMediator.from_diag_table(
            dt_path, z_targets=z_targets, rho_targets=rho_targets,
            nz_sigma=nz, areaT=G.areaT.cpu().numpy(), device=device)
        ke_budget_fn, tend_fn = _table_setup(dm, state, params, forcing, G,
                                             GV, rundir)
    else:
        dm = DiagMediator(z_targets=z_targets, device=device)
        diag_fields = ["h", "u", "v"] + (["T", "S"] if params.thermo_enabled
                                         else [])
        diag_ids = {name: dm.register_diag_field("ocean_model", name,
                                                 time_avg=True)
                    for name in diag_fields}
        id_ssh = dm.register_diag_field("ocean_model", "SSH", units="m")
        bathy = G.bathyT.cpu().numpy()
    _set_diag_axes(dm, G, cal, start_time)

    timer_reset()
    start = time.time()
    n_done = 0
    f_base = forcing
    with torch.inference_mode():
        for c in range(n_cycles // stats_every):
            t_seg = time.perf_counter()
            if arc_rec is not None:
                pre = [state.h.cpu().numpy(), state.uhtr.cpu().numpy(),
                       state.vhtr.cpu().numpy()]
            with timer("ocean dynamics+thermo", sync=state.h):
                if provider is not None:
                    f_base = provider(t0 + (c + 0.5) * stats_every
                                      * dt_cycle)
                f_seg = f_base
                if ctrl is not None:
                    # the correction of this segment on its base forcing
                    f_seg = _controlled(f_base, ctrl, state, G, GV,
                                        stats_every * dt_cycle,
                                        extract_surface_state)
                for _ in range(stats_every):
                    state = step_mom(state, f_seg, G, GV, params)
            if drv["debug_nans"]:
                from mom6_tpu_torch.framework.sanitize import \
                    check_finite_state
                check_finite_state(
                    state, G, step=(c + 1) * stats_every,
                    fatal_path=os.path.join(rundir, "FATAL_NANS"))
            if arc_rec is not None:
                arc_rec["h_start"].append(pre[0])
                arc_rec["h_end"].append(state.h.cpu().numpy())
                arc_rec["uhtr"].append(state.uhtr.cpu().numpy() - pre[1])
                arc_rec["vhtr"].append(state.vhtr.cpu().numpy() - pre[2])
            step = (c + 1) * stats_every
            t_now = t0 + step * dt_cycle
            if dtbt_fn is not None and \
                    t_now - t_last_reset >= drv["dtbt_reset"]:
                t_last_reset = t_now
                dtbt_max = dtbt_fn(state)
                nstep_new = max(1, int(np.ceil(
                    params.dyn.dt / (dtbt_frac * dtbt_max))))
                bt = params.dyn.bt
                if nstep_new != bt.nstep:
                    print(f"set_dtbt: nstep {bt.nstep} -> {nstep_new} "
                          f"(dtbt_max {dtbt_max:.1f} s)")
                    bt = bt.replace(nstep=nstep_new,
                                    nfilter=max(1, nstep_new // 8))
                    params = params.replace(dyn=params.dyn.replace(bt=bt))
            tdays = t_now / 86400.0
            with timer("ocean.stats", sync=state.h):
                s = stats_of(state)
                # net inputs and the drift against them; the restoring
                # fluxes at the segment's end state
                audit.accumulate(f_seg, state, G, GV,
                                 stats_every * dt_cycle)
                s.update(audit.drift(s))
                if params.tfc is not None and state.tr is not None:
                    s.update(tracer_stocks(state.tr, state.h, G,
                                           names=params.tfc.registry.names))
                writer.write(step, tdays, s)
            print(format_stats_line(step, tdays, s))
            with timer("diag mediator", sync=state.h):
                if use_table:
                    # the forcing of the segment before the controller's
                    # correction, as the reference posts
                    _post_table_diags(dm, state, G, GV, params, f_base,
                                      ke_budget_fn, tend_fn)
                else:
                    for name in diag_fields:
                        dm.post_data(diag_ids[name], getattr(state, name))
                    dm.post_data(id_ssh,
                                 state.h.cpu().numpy().sum(0) - bathy)
            n_done = step
            seg_wall = time.perf_counter() - t_seg
            if drv["maxcpu"] > 0.0 and \
                    (time.time() - start) + 1.5 * seg_wall > drv["maxcpu"]:
                print(f"MAXCPU: projected to exceed {drv['maxcpu']:.0f} s "
                      f"wall budget; stopping after {n_done} of {n_cycles} "
                      "steps and writing the restart")
                break
    steps_run = n_done or n_cycles
    t_end_s = t0 + steps_run * dt_cycle
    if use_table:
        dm.flush_all(rundir, time_seconds=t_end_s)
    else:
        dm.flush(os.path.join(rundir, "ocean_diags.nc"),
                 time_seconds=t_end_s)
    elapsed = time.time() - start
    if arc_rec is not None and arc_rec["uhtr"]:
        from mom6_tpu_torch.io.netcdf import NCWriter
        w = NCWriter(os.path.join(rundir, drv["archive"]),
                     global_attrs={"interval_seconds":
                                   float(stats_every * dt_cycle)})
        for k, recs in arc_rec.items():
            w.write_static(k, np.stack(recs))
        w.close()
    reg.save_restart(os.path.join(rundir, "MOM.res.nc"), state,
                     time_seconds=t_end_s, step=steps_run,
                     io_layout=drv["io_layout"])
    # date-stamped segment bookkeeping (MOM_driver.F90:606-680), under
    # RESTART/: continuing means copying RESTART/ocean_solo.res into the
    # next segment's run directory
    t_end = start_time.add_seconds(t_end_s)
    res_dir = os.path.join(rundir, "RESTART")
    os.makedirs(res_dir, exist_ok=True)
    tm.write_ocean_solo_res(os.path.join(res_dir, "ocean_solo.res"), cal,
                            start_time, t_end)
    tm.write_time_stamp(rundir, cal, seg_start, t_end)
    if cal != tm.NO_CALENDAR and drv["io_layout"] == (1, 1):
        stamped = os.path.join(res_dir,
                               tm.date_stamp(cal, t_end) + ".MOM.res.nc")
        if not os.path.exists(stamped):
            os.link(os.path.join(rundir, "MOM.res.nc"), stamped)
    # the chksum_diag fingerprint of the final state
    with open(os.path.join(rundir, "chksum_diag"), "w") as f:
        for name in reg.names:
            f.write(chksum_line(name, reg.get(name, state)) + "\n")
    days_run = steps_run * dt_cycle / 86400.0
    sypd = (steps_run * dt_cycle / max(elapsed, 1e-9)) / 365.0
    cpu = resource.getrusage(resource.RUSAGE_SELF).ru_utime
    with open(os.path.join(rundir, "ocean.cputime"), "a") as f:
        f.write(f"{days_run:12.4f} days  wall {elapsed:10.2f} s  "
                f"cpu {cpu:10.2f} s  SYPD {sypd:8.2f}\n")
        f.write(timer_report(min_frac=0.001) + "\n")
        f.write("kernel launches: " + json.dumps(kernel_launches()) + "\n")
    print(f"run complete: {days_run} days in {elapsed:.1f}s "
          f"({sypd:.1f} SYPD)")
    unused = pf.unused_params()
    if unused:
        print("WARNING: unused parameters:", ", ".join(unused))
    return state


def _controlled(f_seg, ctrl, state, G, GV, interval, extract_surface_state):
    """The segment's forcing with the controller's heat and fresh-water
    corrections added (apply_ctrl_forcing)."""
    sfc = extract_surface_state(state, G, GV)
    h_adj, fw_adj = ctrl.update(sfc.sst.cpu().numpy(),
                                sfc.sss.cpu().numpy(), interval)
    b = f_seg.buoy
    like = state.h[0]

    def add(base, adj):
        adj = torch.tensor(adj, dtype=like.dtype, device=like.device)
        return adj if base is None else base + adj

    b = b.replace(heat_flux=add(b.heat_flux, h_adj))
    if fw_adj is not None:
        b = b.replace(fw_flux=add(b.fw_flux, fw_adj))
    return f_seg.replace(buoy=b)


def _run_offline(archive, rundir, setup, dt_cycle, stats_every):
    """Offline tracer transport from an archived online run (the
    step_offline path, MOM.F90:1983 -> MOM_offline_main.F90): advect the
    initial T and S and an ideal age with the stored interval
    transports, reporting the tracers' totals each interval, and write
    offline_tracers.nc."""
    from mom6_tpu_torch.io.netcdf import NCWriter, read_nc
    from mom6_tpu_torch.tracers.offline import OfflineFields, step_offline

    G, state = setup.grid, setup.state
    arc_path = archive if os.path.isabs(archive) \
        else os.path.join(rundir, archive)
    like = state.h

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=like.dtype,
                            device=like.device)
    arc = {k: v for k, v in read_nc(arc_path).items() if np.ndim(v)}
    n_rec = arc["uhtr"].shape[0]
    dt_rec = stats_every * dt_cycle
    names = ["T", "S", "ideal_age"]
    tr = torch.stack([state.T, state.S, torch.zeros_like(state.T)])
    h = t(arc["h_start"][0])
    area = G.areaT.cpu().numpy().astype(np.float64)
    print(f"offline: {n_rec} intervals of {dt_rec:.0f} s from {arc_path}")
    with torch.inference_mode():
        for r in range(n_rec):
            fields = OfflineFields(
                h_start=t(arc["h_start"][r]), h_end=t(arc["h_end"][r]),
                uhtr=t(arc["uhtr"][r]), vhtr=t(arc["vhtr"][r]))
            tr = tr.clone()
            tr[2] += dt_rec / (365.0 * 86400.0)        # age source [yr]
            tr, h = step_offline(tr, fields, dt_rec, G)
            h64 = h.cpu().numpy().astype(np.float64)
            tots = [float((tr[i].cpu().numpy().astype(np.float64) * h64
                           * area).sum()) for i in range(len(names))]
            print(f"  rec {r + 1:3d}: " + "  ".join(
                f"{n}*V {v:.6e}" for n, v in zip(names, tots)))
    w = NCWriter(os.path.join(rundir, "offline_tracers.nc"))
    for i, n in enumerate(names):
        w.write_static(n, tr[i].cpu().numpy())
    w.write_static("h", h.cpu().numpy())
    w.close()
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
