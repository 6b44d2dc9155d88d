"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels [--tree DIR]
    python3 chip_smoke.py --table
    python3 chip_smoke.py --gate NAME

With ``--kernels`` only phases 1-3 run and the kernels' times are printed
as one JSON line; ``--tree DIR`` takes the port from another checkout
(say the parent commit, unpacked with ``git archive``), so that two
versions of a kernel are timed by one script on one card.  ``--table``
runs phases 1 and 2, the Thomas checks at wave_speed's (nz-1) shapes and
the diag_table part of phase 12 only.  ``--gate NAME``
runs one physics gate of tests/torch_gates.py on the card and prints its
record and launch counts as one JSON line (phase 10 starts these).

Phases (each prints its own lines; any failure raises and exits non-zero),
run in the order 1-4, 6-8, the first half of 12, 13, then 5, 9, 11 and
the rest of 12 while the gates of phase 10 run in processes of their own
(nothing timed runs beside the gates):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels of mom6_tpu_torch/csrc with nvcc, one
   compiler per source, all started together; registers, spills and
   shared memory of the Thomas, the remap and the PPM edge kernels from
   ptxas (no spills allowed);
3. kernels: each kernel against its plain PyTorch version on the card, with
   the kernel's and the plain version's times and the card's bound for the
   same work: the Thomas solve and the PPM passes at the global path's
   (32, 400, 720), the thermo slice's (32, 280, 360), the double gyre's
   (8, 280, 360), at (75, 270, 360) and at the shapes of the open-boundary
   run directories (OBC_KERNEL_SHAPES); the Thomas solve as the vertical
   diffusion calls it (coefficients (32, 1, 400, 720) shared by the two
   right-hand sides of a transposed (2, 32, 400, 720) tensor, and
   (32, 1, 280, 360) by the three of T, S and the age, and the diabatic
   solve of T and S on tidal_bay (3, 1, 24, 48) and dome (14, 1, 32, 48));
   the ALE remap at
   (nf=2 and 1, 32, 400, 720), (nf=3, 2 and 1, 32, 280, 360), (nf=3 and
   2, 75, 270, 360) and dome's (nf=2 and 1, 14, 32, 48), from 32 to 40
   layers, with five fields, and onto the source grid itself (every interface ties); the y passes across the
   tripolar fold on the half-degree global grid at (32, 400, 720) and on a
   polar cap at (7, 33, 45).  Every kernel must equal its plain version
   to the bit; each kernel's own device time (torch.profiler) is
   reported beside its time from an idle device;
4. the fold, exactly: a bump on the north pole of a polar cap without
   rotation stays mirror-symmetric to the bit over 10 steps;
5. float64, on the card with the kernels against the CPU with the plain
   versions: the split-RK2 double gyre at 24x22x2 for 3 steps, thermo_gyre
   at 16x14x6 for 2 thermo cycles, one thermo cycle of a 32x24x5
   tripolar global model (configs/global_2deg's MOM_input on a generated
   mosaic, USE_KPP = False; KPP is in phases 8 and 9), 2 cycles of the
   cooled 100-level ePBL column of the convection gate, and 3 unsplit RK3
   steps of a 48x24 soliton; the kernel launches of one ePBL cycle;
6. the adiabatic path: the double gyre at 360x280x8 through
   drivers.solo.run_segment for 20 steps in float32, with the launch count
   of every kernel, the ms per baroclinic step and a phase breakdown;
7. the full-physics path, bench.py's headline case (thermo_gyre with GM
   and MEKE, KHTR, KPP, shear mixing and the ideal age): 360x280x32 at dt
   1200 s through run_segment for 10 thermo cycles (20 baroclinic steps),
   then the OM4 tile of bench.py, 360x270x75 at dt 900 s, for 3 cycles,
   both in float32: the launch count of every kernel, conservation of mass
   and salt, the heat budget, the age (finite, a trace in the top layer,
   positive below it, never older than the run) and KPP's boundary-layer
   depth, the ms per thermo cycle and SYPD, a profile of one cycle and (at
   360x280x32) a phase breakdown;
8. the global path: configs/global_half_deg/MOM_input as committed (KPP
   on) through drivers.config_driver.build_model_from_params (the 720x400
   mosaic generated in memory), one thermo cycle, then run_segment for 2
   more (18 baroclinic steps in all) at 720x400x32 in float32: finite
   fields, mass drift, wet temperatures in range, land columns untouched,
   KPP's viscosity kv_shear after the first cycle (finite, >= 0, zero at
   the surface and the bottom; how many columns it reaches), the
   boundary-layer depth finite and inside [min_hbl, column depth]; two
   cycles from a state where KPP mixes below the top layer (a mixed top
   under cooling: kv_shear there nonzero at full width; configs/
   global_2deg in float64, cycle by cycle, card against CPU); the launch
   count of every kernel with the fold launches apart, the ms per thermo
   cycle without and with stats, a profile of one cycle and a phase
   breakdown (KPP and shear mixing among the phases);
9. the golden configurations (configs/double_gyre, benchmark, rho_basin
   and global_2deg, the reference's golden tests) at their committed size
   and cycle count, each built by build_model_from_params in float64 on
   the card and on the CPU: each cycle run on the card from the CPU's
   state before it against the CPU's cycle (ocean.stats: mass, heat and
   salt to 1e-12 relative, KE and APE to 1e-9), and the two free runs
   to the same tolerances;
10. the physics gates: the twelve cases of tests/test_analytic_parity.py
   and tests/test_pf_pierced.py, ten of tests/test_user_configs.py
   (the Phillips jet balanced, scm_kpp mixing under wind, Neverworld's
   topography and stability, the hurricane's wind and its cold wake right
   of the track, supercritical stepping stably, the Kelvin wave trapped at
   the coast, the shelf wave trapped on the shelf, DOME's inflow entering
   and descending and its plume turning west after 2 days), the tidal bay
   pumped by its file data (tests/test_obc_file_reservoir.py), tc3's
   radiation against a closed twin (tests/test_tc_ladder.py) and Flather
   and Orlanski radiating waves out (tests/test_obc.py), through the port
   in float32 at their own size and
   length with their own asserts (tests/torch_gates.py), four at a time,
   each in its own process on the card (``--gate``); one line per case
   with what it measured, the analytic value and the seconds;
11. configs/tracer_batch (24 tracers) in float64 on the card and on the
   CPU: 4 cycles, each on the card from the CPU's state before it against
   the CPU's cycle (every tracer, h, T and S within 1e-10 of max-abs),
   the reference test's asserts on the dyes and the stocks;
12. the port's command line as users run it, ``python -m
   mom6_tpu_torch.drivers.solo DIR --days D`` in a subprocess on a fresh
   copy of each run directory under chip_smoke_out/solo: first
   configs/global_half_deg as committed for one day (12 thermo cycles,
   float32): one finite ocean.stats line with the mass drift under 1e-6
   relative and the salt and heat drift columns, every output file,
   MOM.res.nc with every registered field at full shape, the wall ms per
   cycle and SYPD of ocean.cputime, and the kernel launches the CLI
   counted, each equal to 12 global cycles' (the build launches none);
   its restart restored on the card gives its ocean.stats line
   again, and one stats call at 720x400x32 is timed on the card
   (compute_stats_device) and on the host (compute_stats).  Then, beside
   the gates: rho_basin and tracer_batch in float64, 2 + 2 cycles
   (--restart-in) equal to 4 straight ones to the bit, and tidal_bay
   (its tracer reservoirs carried; a stats line a cycle, so that both runs
   take the segment data at the same times); the nine run directories of
   the idealized user cases and the six with open boundaries (kelvin,
   shelfwave, supercritical, tidal_bay, dome, tc3) for 2 cycles in
   float64 on the card and on the CPU (--device cpu), ocean.stats to
   1e-12 (mass, heat, salt) and 1e-9 (KE, APE), the restart fields to
   1e-10 of max-abs; seasonal_gyre for half a day in float32
   through its forcing file, whose wind changes from segment to segment.
   The gates of tests/test_user_configs.py on those run directories are
   in phase 10.  The diag_table path, timed alone after the
   global_half_deg day: configs/global_half_deg with
   configs/global_2deg's diag_table for a day (12 cycles and one post of
   121 fields at 720x400x32, float32) and configs/global_2deg as
   committed for a day in float64 (24 cycles, one post), each through
   the CLI: ocean.cputime's wall ms per cycle, SYPD and ms per post, 120
   or more finite fields, the rejections, and the launches held exactly
   to the cycles' (``fold_cycle``) and the posts' (``table_post``,
   ``PER_TABLE_POST`` at 720x400x32); then one post in this process on
   the state the day ended with: its launches (PER_TABLE_POST) and the
   time of its parts.  Beside the gates the same global_2deg day runs on
   the CPU (``--device cpu``): the card's ocean_diags.nc, diag_rejected
   and ocean.stats against the CPU's, every field within 1e-10 of its
   max-abs (on layers and faces that hold water), the stats to the
   golden tolerances.  Phase 3 checks the Thomas kernel at wave_speed's
   (nz-1) shapes of both, (19, 100, 180) and (31, 400, 720), float32 and
   float64 bitwise against its plain version;
13. the open boundaries: each of the six run directories above as
   committed in float32 on the card in this process, 10 thermo cycles
   with the provider's segment data, their launches held exactly to
   ``obc_cycle`` (tc3's with set_bt_cont's extra x and y edge launch a
   step, dome's with the diabatic solve and the z* remaps), the wall ms
   per cycle and, from the profiler, the device's idle share of a cycle;
14. a JSON line of the kernels, then the result line.

Long output (the ptxas report, the profiler tables) goes to
chip_smoke_out/ beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# the checkout whose port is driven: this one, or --tree DIR
TREE = (os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
        if "--tree" in sys.argv else REPO)
sys.path.insert(0, TREE)
# tests/torch_gates.py: the physics gates through the port (no jax)
sys.path.insert(1, os.path.join(TREE, "tests"))

from mom6_tpu_torch.ale import remapping as remap  # noqa: E402
from mom6_tpu_torch.ale.ale import ale_regrid_remap  # noqa: E402
from mom6_tpu_torch.core import continuity_ppm as cppm  # noqa: E402
from mom6_tpu_torch.core.barotropic import btstep  # noqa: E402
from mom6_tpu_torch.core.continuity_ppm import continuity_ppm  # noqa: E402
from mom6_tpu_torch.core.coriolis_adv import coriolis_adv  # noqa: E402
from mom6_tpu_torch.core.dynamics_split_rk2 import (  # noqa: E402
    MechForcing, _visc_setup, step_dynamics_split_rk2)
from mom6_tpu_torch.core.mom import step_mom  # noqa: E402
from mom6_tpu_torch.core.pressure_force import (  # noqa: E402
    find_eta, pressure_force_fv, pressure_force_montgomery)
from mom6_tpu_torch.diagnostics.sum_output import compute_stats  # noqa: E402
from mom6_tpu_torch.drivers.config_driver import \
    build_model_from_params  # noqa: E402
from mom6_tpu_torch.drivers.experiments import (  # noqa: E402
    double_gyre, polar_cap_bump, thermo_gyre)
from mom6_tpu_torch.drivers.solo import (  # noqa: E402
    kernel_launches, make_mom_stepper, make_stepper, reset_kernel_launches,
    run_segment)
from mom6_tpu_torch.eos import get_eos  # noqa: E402
from mom6_tpu_torch.framework import kernels  # noqa: E402
from mom6_tpu_torch.framework import solvers  # noqa: E402
from mom6_tpu_torch.framework.config import ParamFile  # noqa: E402
from mom6_tpu_torch.framework.stencil import ip1, jp1  # noqa: E402
from mom6_tpu_torch.grid.tripolar import write_mosaic  # noqa: E402
from mom6_tpu_torch.physics.lateral.hor_visc import \
    horizontal_viscosity  # noqa: E402
from mom6_tpu_torch.physics.lateral.thickness_diffuse import \
    thickness_diffuse  # noqa: E402
from mom6_tpu_torch.physics.vertical.diabatic import diabatic_ale  # noqa: E402
from mom6_tpu_torch.physics.vertical.vert_friction import vertvisc  # noqa: E402
from mom6_tpu_torch.tracers.advect import advect_tracers  # noqa: E402
from mom6_tpu_torch.tracers.hor_diff import tracer_hordiff  # noqa: E402

OUT = os.path.join(REPO, "chip_smoke_out")
SLICE = dict(nx=360, ny=280, nz=8, len_lon_km=4500.0, len_lat_km=3500.0,
             dt=1200.0)
N_STEPS, STATS_INTERVAL = 20, 10
# bench.py's full-physics case (_full_physics_setup) at its headline size
# and at the OM4 tile of bench_om4_shape: (nx, ny, nz, dt, cycles, cycles
# between stats lines)
FULL_PHYSICS = {"full_physics": (360, 280, 32, 1200.0, 10, 5),
                "om4_tile": (360, 270, 75, 900.0, 3, 3)}
N_TRACER_CYCLES = 4
N_GATE_PROCS = 4            # physics gates run at once, a process each
GLOBAL_DIR = os.path.join(REPO, "configs", "global_half_deg")
GLOBAL_SHAPE = (32, 400, 720)
N_GLOBAL_CYCLES = 3
# the configurations of the reference's golden tests and their cycles
GOLDEN = {"double_gyre": 6, "benchmark": 4, "rho_basin": 4,
          "global_2deg": 3}
GOLDEN_TOL = {"mass": 1e-12, "heat": 1e-12, "salt": 1e-12, "KE": 1e-9,
              "APE": 1e-9}
# the small tripolar global model of the float64 check
SMALL_GLOBAL = ("NIGLOBAL = 32\nNJGLOBAL = 24\nNK = 5\nUSE_KPP = False\n"
                "TRACER_ADVECT_SUB = 3\n")
# kernel check shapes: the global path's and the thermo path's (both
# reported in the JSON line), the double gyre's, and a deep (OM4-like)
# column
KERNEL_SHAPES = (GLOBAL_SHAPE, (32, 280, 360), (8, 280, 360), (75, 270, 360))
# the (nz, ny, nx) of the open-boundary run directories: kelvin and
# shelfwave, supercritical, tidal_bay, dome, tc3 (one layer where nz = 1)
OBC_KERNEL_SHAPES = ((1, 32, 64), (1, 20, 60), (3, 24, 48), (14, 32, 48),
                     (10, 8, 10))
# (nf, nz0, ny, nx) of the remap: T and S, then u or v, on the global and
# the thermo path; T and S of a deep column
REMAP_SHAPES = ((2, 32, 400, 720), (1, 32, 400, 720), (2, 32, 280, 360),
                (1, 32, 280, 360), (2, 75, 270, 360), (3, 32, 280, 360),
                (3, 75, 270, 360), (2, 14, 32, 48), (1, 14, 32, 48))
# more forms of the remap, (nf, nz0, ny, nx) and how the target grid is
# made: more target layers than source layers, five fields (two passes of
# the kernel), and a target grid equal to the source grid
REMAP_FORMS = (((2, 32, 400, 720), dict(nz1=40)),
               ((5, 32, 280, 360), {}),
               ((2, 32, 400, 720), dict(ties=True)))
# the Thomas solve as tracers/vert_diff.py calls it: (n_tr, nz, ny, nx) of
# T and S on the global path, of T, S and the age on the full-physics path,
# of T and S on tidal_bay and dome
SHARED_TRIDIAG = ((2,) + GLOBAL_SHAPE, (3, 32, 280, 360), (2, 3, 24, 48),
                  (2, 14, 32, 48))
# the shape whose numbers a kernel's row of the JSON line carries: that
# of the path that launches it
ROW_SHAPE = {"ppm_edges_y": (32, 280, 360), "ppm_flux_y": (32, 280, 360)}
# ... and the path whose launch count it carries
ROW_PATH = {"ppm_edges_y": "full_physics", "ppm_flux_y": "full_physics"}
FOLD_CAP = dict(nx=45, ny_reg=20, ny_cap=13)       # an odd nx; (7, 33, 45)
# launches per baroclinic step of the double gyre and per thermo cycle of
# the full-physics case, the OM4 tile and tracer_batch (2 baroclinic
# steps, then 1 column solve of T, S and the passive tracers and 3 remaps:
# the cell fields, u, v)
PER_STEP = {"tridiag": 6, "ppm_edges_x": 3, "ppm_edges_y": 3,
            "ppm_flux_x": 9, "ppm_flux_y": 9, "ppm_edges_y_fold": 0,
            "ppm_flux_y_fold": 0, "remap": 0}
PER_CYCLE = {"tridiag": 13, "ppm_edges_x": 6, "ppm_edges_y": 6,
             "ppm_flux_x": 18, "ppm_flux_y": 18, "ppm_edges_y_fold": 0,
             "ppm_flux_y_fold": 0, "remap": 3}
# one baroclinic step of a tripolar configuration (its y passes cross the
# fold), and what a thermo cycle adds: the diabatic column solve and the
# remaps of the cell fields, u and v
PER_FOLD_STEP = {"tridiag": 6, "ppm_edges_x": 3, "ppm_edges_y": 0,
                 "ppm_flux_x": 9, "ppm_flux_y": 0, "ppm_edges_y_fold": 3,
                 "ppm_flux_y_fold": 9, "remap": 0}
PER_THERMO = {"tridiag": 1, "remap": 3}


def fold_cycle(n_dyn):
    """Launches of one thermo cycle of a tripolar configuration with
    ``n_dyn`` baroclinic steps."""
    return {k: n_dyn * c + PER_THERMO.get(k, 0)
            for k, c in PER_FOLD_STEP.items()}


# the _z fields of configs/global_2deg/diag_table, each remapped once a
# post by the diag mediator
TABLE_Z_FIELDS = 12


def table_post(n_dyn):
    """Launches of one post of configs/global_2deg/diag_table on a
    tripolar configuration: the KE budget's split step, the tendency
    capture's thermo cycle, wave_speed's 10 Thomas solves at (nz-1) and
    one remap per _z field."""
    c = fold_cycle(n_dyn)
    extra = {"tridiag": 10, "remap": TABLE_Z_FIELDS}
    return {k: c[k] + PER_FOLD_STEP[k] + extra.get(k, 0) for k in c}


def obc_cycle(n_dyn, bt_cont=False, thermo=None):
    """Launches of one thermo cycle of a configuration without the fold:
    ``n_dyn`` split steps, each with BT_cont one more x and y edge
    reconstruction (set_bt_cont); with ``thermo`` ("layer" or "zstar")
    the diabatic column solve and, in z*, the remaps of the cell fields,
    u and v."""
    per = dict(PER_STEP)
    if bt_cont:
        per["ppm_edges_x"] += 1
        per["ppm_edges_y"] += 1
    out = {k: n_dyn * c for k, c in per.items()}
    if thermo is not None:
        out["tridiag"] += PER_THERMO["tridiag"]
        if thermo == "zstar":
            out["remap"] += PER_THERMO["remap"]
    return out


# the run directories with open boundaries: (baroclinic steps a thermo
# cycle, BT_cont, thermodynamics) of their MOM_input
OBC_CONFIGS = {"kelvin": (1, False, None), "shelfwave": (1, False, None),
               "supercritical": (1, False, None),
               "tidal_bay": (2, False, "layer"), "dome": (2, False, "zstar"),
               "tc3": (1, True, None)}
# thermo cycles of each in float32 on the card, timed and counted
N_OBC_CYCLES = 10


# per thermo cycle of the global path (6 baroclinic steps)
PER_GLOBAL_CYCLE = fold_cycle(6)
# a post of the table at 720x400x32 (global_half_deg, 6 steps a cycle)
PER_TABLE_POST = table_post(6)
# wave_speed's Thomas solves at (nz-1, ny, nx): global_2deg's and
# global_half_deg's
WAVE_TRIDIAG = ((19, 100, 180), (31, 400, 720))
META = {
    "tridiag": ("mom6_tpu_torch/csrc/tridiag.cu",
                "mom6_tpu/framework/pallas_tridiag.py:35"),
    "ppm_edges_x": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                    "mom6_tpu/core/pallas_continuity.py:120"),
    "ppm_flux_x": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                   "mom6_tpu/core/pallas_continuity.py:120"),
    "ppm_edges_y": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                    "mom6_tpu/core/pallas_continuity.py:174"),
    "ppm_flux_y": ("mom6_tpu_torch/csrc/ppm_continuity.cu",
                   "mom6_tpu/core/pallas_continuity.py:174"),
    "remap": ("mom6_tpu_torch/csrc/remap.cu",
              "mom6_tpu/ale/remap_pallas.py:44"),
}
META["ppm_edges_y_fold"] = META["ppm_edges_y"]
META["ppm_flux_y_fold"] = META["ppm_flux_y"]
# kernel against plain version on the card: the same operations in the
# same order (nvcc --fmad=false), so every kernel must be bitwise equal to
# its plain version (0 ulps)
# the card's published peaks (H100 SXM data sheet, at a 700 W limit):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# times [ms] of the kernels by label, for the JSON line of --kernels
TIMES = {}
# float32 operations per element, counted from the kernels' sources:
# Thomas 7 forward + 2 backward; the PPM edges with the positive-definite
# limiter one slope of 25, 8 for the edges, 22 for the limiter; the PPM
# flux with dw*rem 44
FLOPS_PER_POINT = {"tridiag": 9, "ppm_edges": 55, "ppm_flux": 44}
# (name, monotonic, simple_2nd) of the three PPM limiters
LIMITERS = (("pos", False, False), ("cw84", True, False),
            ("simple2nd", False, True))


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=20, warm=3):
    """Median of per-call device times [ms] from CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_time_key(averages):
    """The profiler's attribute of a kernel's own device time (renamed from
    "cuda" to "device" in torch 2.4)."""
    return ("self_cuda_time_total"
            if len(averages) and not hasattr(averages[0],
                                             "self_device_time_total")
            else "self_device_time_total")


def device_ms(fn, name, n=10):
    """Device time [ms] per call of ``fn`` spent in the kernels whose name
    holds ``name``, from torch.profiler over ``n`` calls.
    :func:`median_ms` times one call from an idle device and so includes
    the host's enqueue, which is most of a short launch.  The tracer now
    and then records no kernel at all: the profile is then taken again,
    and after three empty ones the time is NaN, not measured (that the
    kernel ran and what it returned is checked elsewhere)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        key = _device_time_key(ka)
        mine = [e for e in ka if name in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA]
        if mine:
            return sum(getattr(e, key) for e in mine) / 1e3 / n
    log(f"[kernel] the profiler recorded no {name} in three profiles: its "
        f"device time is not measured")
    return float("nan")


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def max_ulps(a, b):
    """Largest distance in units of the last place between two float32
    tensors (0 when bitwise equal)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # map the sign-magnitude float order onto a monotonic integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def bound(nbytes, nflops):
    """(least time [ms] the card could take, what bounds it): bytes over
    the memory rate against float32 operations over the peak rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nflops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.time()
    so = kernels.build()
    kernels.library()
    secs = time.time() - t0
    with open(so + ".log") as f:
        report = f.read()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        f.write(report)
    entries = _ptxas_entries(report)
    regs = [e["registers"] for e in entries]
    spills = sum(e["spill_stores"] for e in entries)
    log(f"[build] {os.path.basename(so)} in {secs:.1f} s "
        f"(nvcc {kernels.BUILD_SECONDS or 0.0:.1f} s, {len(kernels.SOURCES)} "
        f"sources in parallel): {len(regs)} kernel instances, "
        f"{min(regs)}-{max(regs)} registers per thread, {spills} bytes of "
        f"spill stores")
    for family, note in (
            ("thomas_kernel", " (the per-column arrays are dynamic shared "
             "memory, sized at the launch)"),
            ("remap_kernel", " (the per-column sums are dynamic shared "
             "memory, sized at the launch)"),
            ("ppm_edges_kernel", " (the tiles' h, mask and slopes)")):
        mine = [e for e in entries if family in e["name"]]
        if not mine:
            raise AssertionError(f"ptxas reported no {family}")
        r = [e["registers"] for e in mine]
        spilled = sum(e["spill_stores"] + e["spill_loads"] for e in mine)
        log(f"[build] {family}: {len(mine)} instances, {min(r)}-{max(r)} "
            f"registers per thread, {max(e['stack'] for e in mine)} bytes "
            f"of stack, {spilled} bytes of spills, "
            f"{max(e['smem'] for e in mine)} bytes of static shared "
            f"memory{note}")
        if spilled:
            raise AssertionError(f"{family} spills {spilled} bytes")


def _ptxas_entries(report):
    """One dict per kernel instance of ``nvcc -Xptxas -v``'s report."""
    entries = []
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entries.append(dict(name=ln.split("'")[1], registers=0, stack=0,
                                spill_stores=0, spill_loads=0, smem=0))
        elif not entries:
            continue
        elif "bytes spill stores" in ln:
            n = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            entries[-1].update(stack=n[0], spill_stores=n[1],
                               spill_loads=n[2])
        elif "Used" in ln and "registers" in ln:
            entries[-1]["registers"] = int(ln.split("Used")[1].split()[0])
            if "bytes smem" in ln:
                entries[-1]["smem"] = int(
                    ln.split("bytes smem")[0].replace(",", " ").split()[-1])
    return entries


def _tridiag_inputs(shape, seed, dev):
    rng = np.random.default_rng(seed)
    a = -rng.uniform(0.0, 1.0, shape)
    c = -rng.uniform(0.0, 1.0, shape)
    a[0] = 0.0
    c[-1] = 0.0
    b = 1.0 + np.abs(a) + np.abs(c) + rng.uniform(0.0, 1.0, shape)
    d = rng.standard_normal(shape)
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (a, b, c, d)]


def _ppm_inputs(shape, seed, dev):
    """A double-gyre-like stack: resting layers plus 30 m noise with a few
    near-massless cells, the double gyre's masks and metrics."""
    nz, ny, nx = shape
    G, GV, _, params, _ = double_gyre(nx=nx, ny=ny, nz=nz,
                                      len_lon_km=4500.0, len_lat_km=3500.0,
                                      dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    h = 2000.0 / nz + 30.0 * rng.standard_normal(shape)
    h[-1, : ny // 4] = 1e-10
    h = np.maximum(h, 1e-10)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return dict(G=G, dt=params.dt, h=t(h), u=t(0.3 * rng.standard_normal(shape)),
                dw=t(0.05 * rng.standard_normal(shape[1:])),
                rem=t(rng.uniform(0.2, 1.0, shape)))


def _kernel_row(err, ms, d_ms, pms, nbytes, nflops, shape):
    """A kernel's row of the JSON line: ``ms`` from an idle device,
    ``d_ms`` the kernel's own device time."""
    b_ms, b_by = bound(nbytes, nflops)
    return dict(max_abs_err=err, ms=ms, device_ms=d_ms, plain_ms=pms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=list(shape))


def _keep(results, name, shape, row):
    """Keep ``row`` for the JSON line if ``shape`` is the one the kernel's
    path gives it."""
    if tuple(shape) == ROW_SHAPE.get(name, GLOBAL_SHAPE):
        results[name] = row


def _check_tridiag_ppm(shape, dev, results):
    n = math.prod(shape)
    a, b, c, d = _tridiag_inputs(shape, 1, dev)
    x_k = solvers.tridiag_solve(a, b, c, d)
    x_p = solvers.tridiag_solve_plain(a, b, c, d)
    torch.cuda.synchronize()
    err, ulps = rel_err(x_k, x_p), max_ulps(x_k, x_p)
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d))
    row = _kernel_row(float((x_k - x_p).abs().max()), ms, d_ms, pms,
                      4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n, shape)
    log(f"[kernel] tridiag {shape}: max rel err {err:.3e}, max ulps {ulps} "
        f"(must be 0); "
        f"kernel {ms:.4f} ms ({d_ms:.4f} ms on the device), plain {pms:.4f} "
        f"ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    if ulps != 0:
        raise AssertionError(f"tridiag {shape}: {ulps} ulps, err {err}")
    TIMES[f"tridiag {shape}"] = ms
    TIMES[f"tridiag {shape} device"] = d_ms
    _keep(results, "tridiag", shape, row)

    P = _ppm_inputs(shape, 2, dev)
    G, dt, h, u = P["G"], P["dt"], P["h"], P["u"]
    for dname, edges, flux, face, d_p, d_m in (
            ("x", cppm.zonal_edges, cppm.zonal_flux,
             G.dyCu * G.mask2dCu, dt * G.IdxT,
             dt * torch.roll(G.IdxT, -1, -1)),
            ("y", cppm.merid_edges, cppm.merid_flux,
             G.dxCv * G.mask2dCv, dt * G.IdyT,
             dt * torch.roll(G.IdyT, -1, -2))):
        direction = cppm._DIR_X if dname == "x" else cppm._DIR_Y
        e_row = _check_edges(
            f"ppm_edges_{dname}", shape,
            lambda mono, s2: edges(h, G.mask2dT, 1e-10, mono, s2),
            lambda mono, s2: cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono,
                                                  s2, direction), h)
        hl, hr = edges(h, G.mask2dT, 1e-10)
        f_row = _check_flux(
            f"ppm_flux_{dname}", shape,
            lambda **kw: flux(h, hl, hr, face, d_p, d_m, u, **kw),
            lambda dw, rem: cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, u,
                                                dw, rem, direction),
            P["dw"], P["rem"])
        _keep(results, f"ppm_edges_{dname}", shape, e_row)
        _keep(results, f"ppm_flux_{dname}", shape, f_row)


def _check_edges(label, shape, kernel, plain, h):
    """The edge kernel ``kernel(monotonic, simple_2nd)`` of ``h`` against
    its plain version ``plain(...)`` for each limiter: 0 ulps.  Times and
    the row with the positive-definite limiter; beside them, as a yardstick
    of what the card's memory gives this traffic, the device time of one
    PyTorch call that moves the same bytes (``torch.frexp``: reads one
    field, writes two of its size)."""
    n, plane = math.prod(shape), shape[1] * shape[2]
    errs = []
    for lim, mono, s2 in LIMITERS:
        hl_k, hr_k = kernel(mono, s2)
        hl_p, hr_p = plain(mono, s2)
        e = max(rel_err(hl_k, hl_p), rel_err(hr_k, hr_p))
        ul = max(max_ulps(hl_k, hl_p), max_ulps(hr_k, hr_p))
        log(f"[kernel] {label} {lim} {shape}: max rel err {e:.3e}, max ulps "
            f"{ul} (must be 0)")
        if ul != 0:
            raise AssertionError(f"{label} {lim} {shape}: {ul} ulps, err {e}")
        errs.append(float(max((hl_k - hl_p).abs().max(),
                              (hr_k - hr_p).abs().max())))
    ms = median_ms(lambda: kernel(False, False))
    d_ms = device_ms(lambda: kernel(False, False), "ppm_edges_kernel")
    pms = median_ms(lambda: plain(False, False))
    f_ms = device_ms(lambda: torch.frexp(h), "")
    row = _kernel_row(max(errs), ms, d_ms, pms, 4 * (3 * n + plane),
                      FLOPS_PER_POINT["ppm_edges"] * n, shape)
    log(f"[kernel] {label} {shape}: kernel {ms:.4f} ms ({d_ms:.4f} ms on "
        f"the device), plain {pms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); torch.frexp, the same bytes, {f_ms:.4f} ms "
        f"on the device")
    TIMES[f"{label} {shape}"] = ms
    TIMES[f"{label} {shape} device"] = d_ms
    TIMES[f"{label} {shape} frexp device"] = f_ms
    return row


def _check_flux(label, shape, kernel, plain, dw, rem):
    """The flux kernel ``kernel(**kw)`` at w = u and at u + dw*rem against
    its plain version ``plain(dw, rem)``: 0 ulps.  Times and the row at
    u + dw*rem."""
    n, plane = math.prod(shape), shape[1] * shape[2]
    errs = []
    for adj in (False, True):
        kw = dict(dw=dw, rem=rem) if adj else {}
        f_k = kernel(**kw)
        f_p = plain(kw.get("dw"), kw.get("rem"))
        e = max(rel_err(f_k[0], f_p[0]), rel_err(f_k[1], f_p[1]))
        ul = max(max_ulps(f_k[0], f_p[0]), max_ulps(f_k[1], f_p[1]))
        log(f"[kernel] {label} adjust={adj} {shape}: max rel err {e:.3e}, "
            f"max ulps {ul} (must be 0)")
        if ul != 0:
            raise AssertionError(f"{label} adjust={adj} {shape}: {ul} ulps, "
                                 f"err {e}")
        errs.append(float(max((f_k[0] - f_p[0]).abs().max(),
                              (f_k[1] - f_p[1]).abs().max())))
    ms = median_ms(lambda: kernel(dw=dw, rem=rem))
    d_ms = device_ms(lambda: kernel(dw=dw, rem=rem), "ppm_flux_kernel")
    pms = median_ms(lambda: plain(dw, rem))
    row = _kernel_row(max(errs), ms, d_ms, pms, 4 * (7 * n + 4 * plane),
                      FLOPS_PER_POINT["ppm_flux"] * n, shape)
    log(f"[kernel] {label} adjust=True {shape}: kernel {ms:.4f} ms "
        f"({d_ms:.4f} ms on the device), plain {pms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    TIMES[f"{label} {shape}"] = ms
    TIMES[f"{label} {shape} device"] = d_ms
    return row


def _check_tridiag_wave(shape, dev):
    """The Thomas kernel as wave_speed calls it, at (nz-1, ny, nx): the
    mode operator of random thicknesses (diagnostics/wave_speed.py::
    _mode_operator), float32 and float64, bitwise against its plain
    version; the float32 times."""
    from mom6_tpu_torch.diagnostics.wave_speed import _mode_operator
    n = math.prod(shape)
    rng = np.random.default_rng(11)
    nz1, ny, nx = shape
    h = np.maximum(4000.0 / (nz1 + 1) * rng.uniform(0.0, 2.0,
                                                     (nz1 + 1, ny, nx)), 0.0)
    h[:, : ny // 8] = 1e-10               # land columns, as on the grid
    d = rng.standard_normal(shape)
    for dtype in (torch.float64, torch.float32):
        a, b, c = _mode_operator(torch.tensor(h, dtype=dtype, device=dev))
        rhs = torch.tensor(d, dtype=dtype, device=dev)
        x_k = solvers.tridiag_solve(a, b, c, rhs)
        x_p = solvers.tridiag_solve_plain(a, b, c, rhs)
        torch.cuda.synchronize()
        if not torch.equal(x_k, x_p):
            raise AssertionError(f"tridiag (nz-1) {shape} {dtype}: max abs "
                                 f"diff {float((x_k - x_p).abs().max())}")
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, rhs))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, rhs),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, rhs))
    b_ms, b_by = bound(4 * 5 * n, FLOPS_PER_POINT["tridiag"] * n)
    log(f"[kernel] tridiag as wave_speed calls it, (nz-1) = {shape}: float64 "
        f"and float32 bitwise equal to the plain version; kernel {ms:.4f} "
        f"ms ({d_ms:.4f} ms on the device), plain {pms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); 10 solves a post")
    TIMES[f"tridiag wave {shape}"] = ms
    TIMES[f"tridiag wave {shape} device"] = d_ms


def _check_tridiag_shared(dev, shape):
    """The Thomas solve as tracers/vert_diff.py calls it: coefficients
    (nz, 1, ny, nx) shared by the n_tr right-hand sides of the transposed
    view of an (n_tr, nz, ny, nx) tensor ``shape``.  Its bound reads a, b,
    c once and reads and writes each right-hand side once: 3 + 2 n_tr
    passes."""
    n_tr, nz, ny, nx = shape
    n = nz * ny * nx
    a, b, c, _ = (t[:, None] for t in _tridiag_inputs((nz, ny, nx), 7, dev))
    rng = np.random.default_rng(8)
    d = torch.tensor(rng.standard_normal(shape),
                     dtype=torch.float32, device=dev).transpose(0, 1)
    x_p = solvers.tridiag_solve_plain(a, b, c, d)
    solvers.tridiag_solve(a, b, c, d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    x_k = solvers.tridiag_solve(a, b, c, d)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    x_bytes = x_k.numel() * x_k.element_size()
    err, ulps = rel_err(x_k, x_p), max_ulps(x_k, x_p)
    each = [solvers.tridiag_solve(a[:, 0], b[:, 0], c[:, 0],
                                  d[:, r].contiguous()) for r in range(n_tr)]
    same = all(torch.equal(x_k[:, r], e) for r, e in enumerate(each))
    ms = median_ms(lambda: solvers.tridiag_solve(a, b, c, d))
    d_ms = device_ms(lambda: solvers.tridiag_solve(a, b, c, d),
                     "thomas_kernel")
    pms = median_ms(lambda: solvers.tridiag_solve_plain(a, b, c, d), reps=5)
    b_ms, b_by = bound(4 * (3 + 2 * n_tr) * n, (3 + 5 * n_tr) * n)
    log(f"[kernel] tridiag, coefficients ({nz}, 1, {ny}, {nx}) shared by the "
        f"{n_tr} right-hand sides of a transposed {shape} tensor: "
        f"max rel err {err:.3e}, max ulps {ulps} (must be 0), equal to one "
        f"solve per right-hand side {same}; the call held {extra} bytes "
        f"beyond its inputs, {extra / x_bytes:.3f} of x's {x_bytes}; kernel "
        f"{ms:.4f} ms ({d_ms:.4f} ms on the device), plain {pms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if ulps != 0 or not same:
        raise AssertionError(f"shared tridiag: {ulps} ulps, per-rhs {same}")
    # (another checkout is timed, not held to this: the parent copies)
    if TREE == REPO and extra > x_bytes + 512:
        raise AssertionError("tridiag_solve allocated a scratch tensor or "
                             "copied an operand")
    TIMES[f"tridiag shared {shape}"] = ms
    TIMES[f"tridiag shared {shape} device"] = d_ms


def _check_fold(G, dt, h, dev, results):
    """The y edges and the y flux (plain and at v + dw*rem) across the
    tripolar fold of grid ``G``, through their wrappers, against the plain
    versions; same bytes and operations as the wrap rows."""
    shape = tuple(h.shape)
    rng = np.random.default_rng(4)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    v = t(0.3 * rng.standard_normal(shape)) * G.mask2dCv
    dw = t(0.05 * rng.standard_normal(shape[1:]))
    rem = t(rng.uniform(0.2, 1.0, shape))
    face, d_p = G.dxCv * G.mask2dCv, dt * G.IdyT
    d_m = dt * jp1(G.IdyT, "h")
    edges, flux = cppm.merid_edges, cppm.merid_flux
    before = (edges.fold_launches, flux.fold_launches, edges.launches,
              flux.launches)
    e_row = _check_edges(
        "ppm_edges_y_fold", shape,
        lambda mono, s2: edges(h, G.mask2dT, 1e-10, mono, s2, fold=True),
        lambda mono, s2: cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono, s2,
                                              cppm._DIR_Y, fold=True), h)
    hl, hr = edges(h, G.mask2dT, 1e-10, fold=True)
    # the fold is not the wrap: the top row's north edge differs
    _, hr_w = cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, False, False,
                                   cppm._DIR_Y)
    if torch.equal(hr_w[:, -1], hr[:, -1]):
        raise AssertionError("fold edges equal the wrap's on the top row")
    f_row = _check_flux(
        "ppm_flux_y_fold", shape,
        lambda **kw: flux(h, hl, hr, face, d_p, d_m, v, fold=True, **kw),
        lambda dw_, rem_: cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, v,
                                              dw_, rem_, cppm._DIR_Y,
                                              fold=True),
        dw, rem)
    after = (edges.fold_launches, flux.fold_launches, edges.launches,
             flux.launches)
    if not (after[0] > before[0] and after[1] > before[1]
            and after[2:] == before[2:]):
        raise AssertionError(f"fold launches miscounted: {before} -> {after}")
    _keep(results, "ppm_edges_y_fold", shape, e_row)
    _keep(results, "ppm_flux_y_fold", shape, f_row)


def _remap_inputs(shape, seed, dev, nz1=None, ties=False):
    """A z* column stack of nz0 layers over 3000 m with 30% noise and
    vanished bottom layers on a quarter of the plane, a target grid of
    ``nz1`` layers (nz0 unless given) renormalised to the same column sums
    or, with ``ties``, the source grid itself, and T/S-like fields."""
    nf, nz0, ny, nx = shape
    rng = np.random.default_rng(seed)
    h0 = (3000.0 / nz0) * (1.0 + 0.3 * rng.uniform(-1, 1, (nz0, ny, nx)))
    h0[-2:, : ny // 4] = 1e-10
    w = 1.0 + 0.3 * rng.uniform(-1, 1, (nz1 or nz0, ny, nx))
    h1 = w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)
    if ties:
        h1 = h0
    zc = np.cumsum(h0, 0) - 0.5 * h0
    base = [4.0 + 16.0 * np.exp(-zc / 800.0), 35.0 + 0 * zc]
    f = np.stack([base[i % 2] + 0.1 * rng.standard_normal(zc.shape)
                  for i in range(nf)])
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return t(f), t(h0), t(h1)


def _check_remap(shape, dev, results, **form):
    """The wrapper remap_columns_multi (reconstruction, then one launch)
    against the reconstruction and the plain version; the times are of the
    launch alone against the plain version alone, then of both with the
    reconstruction.  ``form``: see :func:`_remap_inputs`."""
    nf, nz0, ny, nx = shape
    f, h0, h1 = _remap_inputs(shape, 3, dev, **form)
    wrapper = remap.remap_columns_multi

    def plain_whole():
        c, lo_, hi_ = remap.remap_coefficients(f, h0, remap.PPM_H4)
        return remap.remap_integrals_plain(c, h0, h1, lo_, hi_)

    coef, lo, hi = remap.remap_coefficients(f, h0, remap.PPM_H4)
    npoly, nz1, cols = coef.shape[1], h1.shape[0], ny * nx
    before = wrapper.launches
    out_k = wrapper(f, h0, h1, remap.PPM_H4)
    if wrapper.launches != before + 1:
        raise AssertionError(f"remap {shape}: the wrapper launched "
                             f"{wrapper.launches - before} times, not once")
    out_p = remap.remap_integrals_plain(coef, h0, h1, lo, hi)
    torch.cuda.synchronize()
    err, ulps = rel_err(out_k, out_p), max_ulps(out_k, out_p)
    ms = median_ms(lambda: remap._remap_launch(coef, h0, h1, lo, hi))
    d_ms = device_ms(lambda: remap._remap_launch(coef, h0, h1, lo, hi),
                     "remap_kernel")
    pms = median_ms(lambda: remap.remap_integrals_plain(coef, h0, h1, lo,
                                                        hi), reps=5)
    w_ms = median_ms(lambda: wrapper(f, h0, h1, remap.PPM_H4), reps=5)
    wp_ms = median_ms(plain_whole, reps=5)
    # each input read once and the output written once; the operations the
    # function needs, as an O(nz0 + nz1) merge over the monotone interfaces
    # would do them: xi at each target interface (5, shared by the fields),
    # per field each source cell's whole integral once (npoly + 1) and one
    # partial integral per target interface (2(npoly-1) + 3), then 3 per
    # output cell
    nbytes = 4 * cols * (nf * npoly * nz0 + nz0 + nz1 + 2 * nf + nf * nz1)
    nflops = cols * (5 * (nz1 + 1) + nf * (
        (npoly + 1) * nz0 + (2 * (npoly - 1) + 3) * (nz1 + 1) + 3 * nz1))
    row = _kernel_row(float((out_k - out_p).abs().max()), ms, d_ms, pms,
                      nbytes, nflops, shape)
    what = (f"nf={nf} ({nz0}, {ny}, {nx})"
            + (f" to {nz1} layers" if nz1 != nz0 else "")
            + (" onto the source grid (all ties)" if form.get("ties") else ""))
    log(f"[kernel] remap {what} PPM_H4, wrapper (1 launch): max rel err "
        f"{err:.3e}, max ulps {ulps} (must be 0); launch {ms:.4f} ms "
        f"({d_ms:.4f} ms on the device), plain "
        f"{pms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB, {nflops / 1e9:.3f} GFLOP); with the "
        f"reconstruction: wrapper {w_ms:.4f} ms, plain {wp_ms:.4f} ms")
    if ulps != 0:
        raise AssertionError(f"remap {what}: {ulps} ulps, err {err}")
    TIMES[f"remap {what}"] = ms
    TIMES[f"remap {what} device"] = d_ms
    if shape == REMAP_SHAPES[0] and not form:
        results["remap"] = row


def _noisy_thickness(h, seed):
    """``h`` with 10% noise on the layers that hold water (the vanished
    layers over topography stay as they are)."""
    rng = np.random.default_rng(seed)
    noise = torch.tensor(1.0 + 0.1 * rng.uniform(-1, 1, tuple(h.shape)),
                         dtype=h.dtype, device=h.device)
    return torch.where(h > 1.0, h * noise, h)


def phase_kernels(dev, ms):
    """Every kernel against its plain version on the card; the fold
    branch on the global model ``ms``'s grid and on a polar cap with an
    odd nx."""
    results = {}
    for shape in KERNEL_SHAPES + OBC_KERNEL_SHAPES:
        _check_tridiag_ppm(shape, dev, results)
        torch.cuda.empty_cache()
    _check_fold(ms.grid, ms.params.dyn.dt, _noisy_thickness(ms.state.h, 5),
                dev, results)
    G, _, _, p, _ = polar_cap_bump(**FOLD_CAP, device=dev)
    rng = np.random.default_rng(6)
    h = np.maximum(150.0 + 30.0 * rng.standard_normal((7, G.ny, G.nx)), 1e-10)
    h[-1, -4:, : G.nx // 3] = 1e-10
    _check_fold(G, p.dt, torch.tensor(h, dtype=torch.float32, device=dev),
                dev, results)
    for shape in SHARED_TRIDIAG:
        _check_tridiag_shared(dev, shape)
    for shape in WAVE_TRIDIAG:
        _check_tridiag_wave(shape, dev)
    for shape, form in [(sh, {}) for sh in REMAP_SHAPES] + list(REMAP_FORMS):
        _check_remap(shape, dev, results, **form)
        torch.cuda.empty_cache()
    return results


def phase_fold_exact(dev):
    """A mirror-symmetric bump on the pole of a cap without rotation: the
    evolution across the fold stays mirror-symmetric to the bit."""
    G, GV, s, p, eta0 = polar_cap_bump(device=dev)
    n0 = cppm.merid_flux.fold_launches
    with torch.inference_mode():
        for _ in range(10):
            s = step_dynamics_split_rk2(s, MechForcing(), G, GV, p)
    eta = (s.h.double().sum(0) - G.bathyT.double()) * G.mask2dT
    asym = float((eta - eta.flip(-1)).abs().max())
    log(f"[fold] polar cap {G.nx}x{G.ny}x1, no rotation, 10 steps: mirror "
        f"asymmetry of eta {asym:.3e} (must be 0), eta max "
        f"{float(eta.max()):.5f} m from {eta0.max():.5f} m, "
        f"{cppm.merid_flux.fold_launches - n0} fold flux launches")
    if not (bool(torch.isfinite(eta).all()) and asym == 0.0):
        raise AssertionError(f"fold asymmetry {asym}")
    if not cppm.merid_flux.fold_launches > n0:
        raise AssertionError("the cap launched no fold kernel")


def _flowing(st, G):
    """A 0.5 m/s flow and a T anomaly on thermo_gyre's state: from rest,
    u and v after two cycles sit near the round-off floor of the
    pressure force's column integrals."""
    nz, ny, nx = st.h.shape
    kw = dict(dtype=st.h.dtype, device=st.h.device)
    y, x = torch.linspace(0, 1, ny, **kw), torch.linspace(0, 1, nx, **kw)
    decay = torch.exp(-torch.arange(nz, **kw) / 4.0)[:, None, None]
    return st.replace(
        T=st.T + decay * torch.outer(torch.sin(torch.pi * y),
                                     torch.cos(2 * torch.pi * x)) * G.mask2dT,
        u=0.5 * decay * torch.cos(torch.pi * y)[:, None] * G.mask2dCu,
        v=0.5 * decay * torch.sin(2 * torch.pi * x)[None, :] * G.mask2dCv)


def _small_global(where):
    """The 32x24x5 tripolar global model in float64 on ``where``, as
    (G, GV, state, params, forcing); its mosaic is written beside the
    other outputs of this script."""
    run_dir = os.path.join(OUT, "small_global")
    if not os.path.exists(os.path.join(run_dir, "ocean_hgrid.nc")):
        write_mosaic(run_dir, nx=32, ny_reg=16, ny_cap=8)
    ms = build_model_from_params(
        ParamFile([os.path.join(REPO, "configs", "global_2deg", "MOM_input")],
                  text=SMALL_GLOBAL),
        dtype=torch.float64, device=where, input_dir=run_dir)
    return ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing


def phase_f64(dev):
    """Card (kernels) against CPU (plain versions) in float64: 3 steps of
    the double gyre, 2 thermo cycles of thermo_gyre, 1 thermo cycle of the
    small tripolar global model (T, S, u and v where the layer or face
    holds water)."""
    for name, build, advance, fields in (
            ("double_gyre 24x22x2, 3 steps",
             lambda d: double_gyre(nx=24, ny=22, nz=2, dtype=torch.float64,
                                   device=d),
             lambda st, G, GV, p, f: step_dynamics_split_rk2(st, f, G, GV, p),
             ("h", "u", "v")),
            ("thermo_gyre 16x14x6 from a flowing state, 2 cycles",
             lambda d: thermo_gyre(16, 14, 6, dtype=torch.float64, device=d),
             lambda st, G, GV, p, f: step_mom(st, f, G, GV, p),
             ("h", "u", "v", "T", "S")),
            ("global 32x24x5 (fold, land, GM, KHTR) from a flowing state, "
             "1 cycle", _small_global,
             lambda st, G, GV, p, f: step_mom(st, f, G, GV, p),
             ("h", "u", "v", "T", "S"))):
        out = {}
        n_fold = cppm.merid_flux.fold_launches
        for where in ("cpu", dev):
            G, GV, st, p, f = build(where)
            n = 3
            if "thermo" in name:
                st, n = _flowing(st, G), 2
            elif "global" in name:
                st, n = _flowing(st, G), 1
            with torch.inference_mode():
                for _ in range(n):
                    st = advance(st, G, GV, p, f)
            out[str(where)] = st
        ref, got = out["cpu"], out[str(dev)]
        # T and S in layers that hold water and u and v on faces that do:
        # in a vanished layer (1e-10 m over topography) a velocity is the
        # pressure force's round-off over the face thickness
        h = ref.h
        wet = {"T": h > 1e-3, "S": h > 1e-3,
               "u": 0.5 * (h + ip1(h)) > 1e-3,
               "v": 0.5 * (h + jp1(h, "h" if G.fold_north else None)) > 1e-3}
        errs = {k: rel_err(getattr(got, k).cpu() * wet.get(k, 1),
                           getattr(ref, k) * wet.get(k, 1))
                for k in fields}
        if "global" in name and not cppm.merid_flux.fold_launches > n_fold:
            raise AssertionError("the global cycle launched no fold kernel")
        log(f"[f64] {name}, card vs CPU: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + " (tol 1e-10 relative to max-abs)")
        for k, e in errs.items():
            if not e <= 1e-10:
                raise AssertionError(f"f64 {name} {k}: {e}")
    _f64_new_paths(dev)


def _f64_new_paths(dev):
    """Card against CPU in float64: 2 cycles of the cooled 100-level ePBL
    column of the convection gate (h, u, v, T, S and kv_shear) and 3
    unsplit RK3 steps of a 48x24 soliton (h, u, v); then the kernel
    launches of one ePBL cycle of that column in float32."""
    import torch_gates
    from mom6_tpu_torch.physics.vertical.epbl import epbl_diffusivity
    conv = torch_gates.CONV_BASE + "ENERGETICS_SFC_PBL = True\n"
    cases = (
        ("ePBL column 2x2x100 (cooled 200 W/m2), 2 cycles",
         lambda d: torch_gates.build(d, text=conv, dtype=torch.float64), 2,
         ("h", "u", "v", "T", "S", "kv_shear")),
        ("soliton 48x24x1 (unsplit RK3), 3 steps",
         lambda d: _small_soliton(d, torch.float64), 3, ("h", "u", "v")))
    for name, build, n, fields in cases:
        out = {}
        for where in ("cpu", dev):
            ms = build(where)
            st = ms.state
            with torch.inference_mode():
                for _ in range(n):
                    st = step_mom(st, ms.forcing, ms.grid, ms.vgrid,
                                  ms.params)
            out[str(where)] = st
        ref, got = out["cpu"], out[str(dev)]
        errs = {k: rel_err(getattr(got, k).cpu(), getattr(ref, k))
                for k in fields}
        log(f"[f64] {name}, card vs CPU: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + " (tol 1e-10 relative to max-abs)")
        for k, e in errs.items():
            if not e <= 1e-10:
                raise AssertionError(f"f64 {name} {k}: {e}")
    # what one ePBL cycle costs in launches: the TKE march is a loop over
    # the levels, 3 passes of the MLD feedback
    ms = torch_gates.build(dev, text=conv)
    st, G, GV, f = ms.state, ms.grid, ms.vgrid, ms.forcing
    zero = torch.zeros_like(G.mask2dT)

    def epbl():
        return epbl_diffusivity(st.h, st.T, st.S, G, GV, get_eos("WRIGHT"),
                                zero, zero, f.buoy.heat_flux,
                                cp=ms.params.diabatic.cp,
                                dt=ms.params.dyn.dt * 2)
    one = make_mom_stepper(G, GV, ms.params, f, cycles_per_call=1)
    with torch.inference_mode():
        cyc_ms, cyc_n, _ = _profile(one, st, "epbl_column")
        ep_ms, ep_n, _ = _profile(lambda _: epbl(), st, "epbl_diffusivity")
        epbl()
        torch.cuda.synchronize()
        t0 = time.time()
        epbl()
        torch.cuda.synchronize()
        host = 1e3 * (time.time() - t0)
    log(f"[epbl] the 100-level column in float32: one thermo cycle "
        f"launches {cyc_n} kernels ({cyc_ms:.3f} ms of device time); "
        f"epbl_diffusivity alone {ep_n} kernels, {ep_ms:.3f} ms of device "
        f"time, {host:.3f} ms on the host clock")


def _small_soliton(where, dtype):
    return build_model_from_params(
        ParamFile([os.path.join(REPO, "configs", "soliton", "MOM_input")],
                  text="NIGLOBAL = 48\nNJGLOBAL = 24\n"),
        dtype=dtype, device=where)


# the profiler's host-side entry for launches that stood blocked because
# the device's command buffer was full: the host was ahead of the device
_BLOCKED = "Command Buffer Full"


def _profile(stepper, st, tag):
    """(device time [ms], kernel launches, ms the host stood blocked on a
    full command buffer) of one call of the stepper."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stepper(st)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    key = _device_time_key(ka)
    with open(os.path.join(OUT, f"profile_{tag}.txt"), "w") as fh:
        fh.write(ka.table(sort_by=key, row_limit=40))
    # the kernels themselves (the aten ops above them carry the same
    # device time again)
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(getattr(e, key) for e in kern) / 1e3, \
        sum(e.count for e in kern), \
        sum(e.self_cpu_time_total for e in ka if e.key == _BLOCKED) / 1e3


def _check_counts(counts, per, n, what):
    for k, c in counts.items():
        if c != per[k] * n:
            raise AssertionError(f"{what}: {k} launched {c} times, "
                                 f"expected {per[k]} x {n}")


def _dyn_phase_times(G, GV, st, p, f):
    """Device time [ms] of each part of the double gyre's step."""
    h, u, v = st.h, st.u, st.v
    eta = find_eta(h, G)
    h_u, h_v, cu, cv, rem_u, rem_v = _visc_setup(h, u, v, G, GV, p)
    pf = pressure_force_montgomery(h, G, GV)
    _, uh, vh, _, _ = continuity_ppm(u, v, h, p.dt, G, GV)
    z = torch.zeros_like(u)
    bt = p.bt
    parts = {
        "visc_setup (2 tridiag)": lambda: _visc_setup(h, u, v, G, GV, p),
        "continuity_ppm plain call": lambda: continuity_ppm(
            u, v, h, p.dt, G, GV),
        "continuity_ppm matched call": lambda: continuity_ppm(
            u, v, h, p.dt, G, GV, uhbt=uh.sum(0), vhbt=vh.sum(0),
            visc_rem_u=rem_u, visc_rem_v=rem_v),
        "pressure_force": lambda: pressure_force_montgomery(h, G, GV),
        "coriolis_adv": lambda: coriolis_adv(u, v, h, uh, vh, G, GV),
        f"btstep ({bt.nstep}+{bt.nfilter} substeps)": lambda: btstep(
            u, v, eta, z, z, h, uh, vh, rem_u, rem_v, pf.pbce, pf.eta_PF,
            p.dt, G, GV, bt, taux=f.taux, tauy=f.tauy),
        "vertvisc u": lambda: vertvisc(u, h_u, cu, p.dt, tau=f.taux),
        "step": lambda: step_dynamics_split_rk2(st, f, G, GV, p),
    }
    return {k: median_ms(fn, reps=5, warm=1) for k, fn in parts.items()}


def phase_slice(dev):
    """The adiabatic path at 360x280x8 through run_segment, counting
    launches."""
    G, GV, st, p, f = double_gyre(**SLICE, dtype=torch.float32, device=dev)
    log(f"[slice] double_gyre {G.nx}x{G.ny}x{GV.nz} dt={p.dt}: bt nstep "
        f"{p.bt.nstep} nfilter {p.bt.nfilter}")
    s0 = compute_stats(st, G, GV, p.dt)
    reset_kernel_launches()
    torch.cuda.synchronize()
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=N_STEPS,
                               stats_interval=STATS_INTERVAL, verbose=True)
    counts = kernel_launches()
    log(f"[slice] {N_STEPS} steps in {elapsed:.3f} s with stats: "
        f"{1e3 * elapsed / N_STEPS:.2f} ms/step; launches {counts}")
    _check_counts(counts, PER_STEP, N_STEPS, "double gyre")
    for k in ("h", "u", "v"):
        if not bool(torch.isfinite(getattr(st1, k)).all()):
            raise AssertionError(f"non-finite {k}")
    s1 = compute_stats(st1, G, GV, p.dt)
    drift = abs(s1["mass"] - s0["mass"]) / s0["mass"]
    log(f"[slice] mass drift {drift:.3e} (tol 1e-6), KE {s1['KE']:.6e}, "
        f"h min {float(st1.h.min()):.4e}")
    if not drift < 1e-6:
        raise AssertionError(f"mass drift {drift}")
    if not s1["KE"] > 0.0:
        raise AssertionError("KE is not positive")

    # steady-state step time without the host-side stats
    stepper = make_stepper(G, GV, p, f, steps_per_call=STATS_INTERVAL)
    with torch.inference_mode():
        stepper(st1)
        torch.cuda.synchronize()
        t0 = time.time()
        stepper(st1)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.time() - t0) / STATS_INTERVAL
        log(f"[slice] step time {ms_step:.3f} ms/step (10 steps, host clock,"
            f" synchronised, no stats)")
        one = make_stepper(G, GV, p, f, steps_per_call=1)
        dev_ms, n_kern, blocked = _profile(one, st1, "double_gyre")
        log(f"[slice] profiler, one step: {n_kern} kernel launches, "
            f"{dev_ms:.3f} ms of device time; device idle "
            f"{100.0 * (1.0 - dev_ms / ms_step):.1f}% of the {ms_step:.3f} "
            f"ms step; host blocked on a full command buffer {blocked:.3f} "
            f"ms")
        for k, ms in _dyn_phase_times(G, GV, st1, p, f).items():
            log(f"[phase] {k}: {ms:.3f} ms")
    return counts


def _thermo_phase_times(G, GV, st, p, f):
    """Device time [ms] of each part of the thermo cycle."""
    eos = get_eos(p.eos_name)
    dt_therm = p.dyn.dt * p.n_dyn_per_thermo

    def pf_fn(h, s):
        return pressure_force_fv(h, s.T, s.S, G, GV, eos,
                                 p_surf=f.mech.p_surf, plm_ts=p.pf_recon)

    def hv_fn(u, v, h):
        return horizontal_viscosity(u, v, h, G, p.hor_visc)

    # T, S and the registered passive tracers, as step_mom stacks them
    names = p.tfc.registry.names if p.tfc is not None else []
    tr = torch.stack([st.T, st.S] + [st.tr[n] for n in names])
    passive = tr[2:] if names else None
    what = ", ".join(["T", "S"] + names)
    uhtr, vhtr = st.uh * dt_therm, st.vh * dt_therm
    parts = {}
    if p.diabatic.boundary_layer_scheme == "KPP":
        # imported here: --tree may name a checkout from before KPP
        from mom6_tpu_torch.core.mom import assemble_diffusivity_extras
        from mom6_tpu_torch.physics.vertical.kpp import kpp_diffusivity
        from mom6_tpu_torch.physics.vertical.shear_mixing import \
            shear_mixing_kd
        zero = torch.zeros_like(G.mask2dT)
        taux = f.mech.taux if f.mech.taux is not None else zero
        tauy = f.mech.tauy if f.mech.tauy is not None else zero
        parts["kpp (kpp_diffusivity)"] = lambda: kpp_diffusivity(
            st.h, st.u, st.v, st.T, st.S, G, GV, eos, taux, tauy,
            f.buoy.heat_flux, cp=p.diabatic.cp)
        shear = "" if p.diabatic.use_shear_mixing else ", not on this path"
        parts[f"shear (shear_mixing_kd, LMD94{shear})"] = lambda: \
            shear_mixing_kd(st.h, st.u, st.v, st.T, st.S, G, GV, eos)
        parts["assemble_diffusivity_extras"] = lambda: \
            assemble_diffusivity_extras(st, f, G, GV, p, eos, dt_therm)
    if p.gm is not None:
        parts["thickness_diffuse (GM, neutral slopes)"] = lambda: \
            thickness_diffuse(st.h, G, GV, dt_therm, p.gm, T=st.T, S=st.S,
                              eos=eos)
    if p.meke is not None and st.E_meke is not None:
        from mom6_tpu_torch.physics.lateral.meke import (gm_pe_release,
                                                         meke_diffusivity,
                                                         step_meke)
        _, uhd, vhd = thickness_diffuse(st.h, G, GV, dt_therm, p.gm, T=st.T,
                                        S=st.S, eos=eos)

        def meke():
            kh = meke_diffusivity(st.E_meke, st.h, G, p.meke)
            src = gm_pe_release(st.h, uhd, vhd, G, GV)
            return kh, step_meke(st.E_meke, src, st.h, G, dt_therm, p.meke)
        parts["meke (diffusivity, GM energy source, step)"] = meke
    if p.khtr > 0.0:
        parts[f"tracer_hordiff ({what}; {p.khtr_n_sub} subcycle)"] = \
            lambda: tracer_hordiff(tr, st.h, p.khtr, dt_therm, G,
                                   n_sub=p.khtr_n_sub)
    if names:
        parts["tracer packages (column_physics)"] = lambda: \
            p.tfc.column_physics(st.tr, st.h, dt_therm, G, GV, T=st.T,
                                 S=st.S, forcing=f)
    parts.update({
        "step_mom (one thermo cycle)": lambda: step_mom(st, f, G, GV, p),
        "step_dynamics_split_rk2 (FV PF, friction)": lambda:
            step_dynamics_split_rk2(st, f.mech, G, GV, p.dyn, pf_fn=pf_fn,
                                    hv_fn=hv_fn, kv_int=st.kv_shear),
        "pressure_force_fv": lambda: pf_fn(st.h, st),
        "horizontal_viscosity": lambda: hv_fn(st.u, st.v, st.h),
        f"advect_tracers ({what}; {p.tracer_advect_sub} sub-sweeps)": lambda:
            advect_tracers(tr, st.h, uhtr, vhtr, G,
                           n_sub=p.tracer_advect_sub),
        f"diabatic_ale ({what}: 1 tridiag)": lambda: diabatic_ale(
            st.T, st.S, st.h, f.buoy, dt_therm, G, GV, p.diabatic,
            extra_tracers=passive),
        "ale_regrid_remap (3 remaps)": lambda: ale_regrid_remap(
            st, G, GV, p.ale, extra_tracers=passive),
    })
    reps = 2 if G.nx * G.ny > 200000 else 5
    return {k: median_ms(fn, reps=reps, warm=1) for k, fn in parts.items()}


def full_physics_setup(nx, ny, nz, dt, n_dyn_per_thermo=2,
                       dtype=torch.float32, device="cuda"):
    """bench.py's _full_physics_setup through the port: thermo_gyre with
    GM (KHTH 100) and MEKE, KHTR 50, the ideal age, KPP and shear mixing,
    with E_meke, the tracers and kv_shear allocated."""
    from mom6_tpu_torch.physics.lateral.meke import MEKEParams
    from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
    from mom6_tpu_torch.tracers.packages import IdealAge, TracerFlowControl
    G, GV, st, p, f = thermo_gyre(nx=nx, ny=ny, nz=nz, len_lon_km=4500.0,
                                  len_lat_km=3500.0, dt=dt,
                                  n_dyn_per_thermo=n_dyn_per_thermo,
                                  dtype=dtype, device=device)
    tfc = TracerFlowControl([IdealAge()])
    p = p.replace(gm=GMParams(khth=100.0), meke=MEKEParams(), khtr=50.0,
                  tfc=tfc, diabatic=dataclasses.replace(
                      p.diabatic, boundary_layer_scheme="KPP",
                      use_shear_mixing=True))
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    st = st.replace(E_meke=z(ny, nx),
                    tr=tfc.init_tracers(tuple(st.h.shape), dtype, device),
                    kv_shear=z(nz + 1, ny, nx))
    return G, GV, st, p, f


def _check_age(tag, st, G, elapsed_s):
    """The ideal age: finite; in the top layer only the trace the remap
    brings up from below after the package zeroes it (below 1% of the
    run); positive below it in wet columns; never older than the run,
    to the float32 round-off of its sums (1e-5 relative: one cycle's
    increment is added in float32 each cycle, and the advection and the
    remap sum over neighbours)."""
    age = st.tr["age"]
    run = elapsed_s / (365.0 * 86400.0)
    wet = G.mask2dT > 0.5
    top = float(age[0].abs().max())
    below = age[1:][:, wet]
    log(f"[{tag}] age after {run:.6e} yr: top layer at most {top:.3e} yr "
        f"(the remap's trace; must be < 1% of the run), below it in "
        f"[{float(below.min()):.6e}, {float(below.max()):.6e}] yr (must be "
        f"> 0 and <= the run x (1 + 1e-5))")
    if not bool(torch.isfinite(age).all()):
        raise AssertionError(f"{tag}: non-finite age")
    if not (top < 0.01 * run and bool((below > 0.0).all())
            and float(age.max()) <= run * (1.0 + 1e-5)):
        raise AssertionError(f"{tag}: age out of bounds")


def phase_full_physics(dev):
    """bench.py's full-physics case through run_segment at 360x280x32 and
    at the OM4 tile, counting launches per thermo cycle; returns the counts
    by path."""
    counts_by = {}
    for tag, (nx, ny, nz, dt, n, every) in FULL_PHYSICS.items():
        G, GV, st, p, f = full_physics_setup(nx, ny, nz, dt, device=dev)
        dt_therm = p.dyn.dt * p.n_dyn_per_thermo
        log(f"[{tag}] bench.py's full-physics case {G.nx}x{G.ny}x{GV.nz} dt="
            f"{p.dyn.dt}, {p.n_dyn_per_thermo} baroclinic steps per thermo "
            f"cycle: bt nstep {p.dyn.bt.nstep} nfilter {p.dyn.bt.nfilter}; "
            f"ALE {p.ale.mode} {p.ale.scheme}, EOS {p.eos_name}, GM KHTH "
            f"{p.gm.khth} with MEKE, KHTR {p.khtr}, boundary layer "
            f"{p.diabatic.boundary_layer_scheme}, shear mixing "
            f"{p.diabatic.use_shear_mixing}, tracers "
            f"{p.tfc.registry.names}")
        s0 = compute_stats(st, G, GV, p.dyn.dt)
        reset_kernel_launches()
        torch.cuda.synchronize()
        st1, elapsed = run_segment(st, G, GV, p, f, n_steps=n,
                                   stats_interval=every, verbose=True)
        counts = kernel_launches()
        log(f"[{tag}] {n} thermo cycles in {elapsed:.3f} s with stats: "
            f"{1e3 * elapsed / n:.2f} ms/cycle; launches {counts}; per "
            f"cycle {({k: c / n for k, c in counts.items()})}")
        _check_counts(counts, PER_CYCLE, n, tag)
        counts_by[tag] = counts
        for k in ("h", "u", "v", "T", "S", "E_meke", "kv_shear"):
            if not bool(torch.isfinite(getattr(st1, k)).all()):
                raise AssertionError(f"{tag}: non-finite {k}")
        s1 = compute_stats(st1, G, GV, p.dyn.dt)
        mass = abs(s1["mass"] - s0["mass"]) / s0["mass"]
        salt = abs(s1["salt"] - s0["salt"]) / s0["salt"]
        flux = float((f.buoy.heat_flux.double() * G.areaT.double()
                      * G.mask2dT.double()).sum()) * dt_therm * n
        log(f"[{tag}] mass drift {mass:.3e} (tol 1e-6), salt drift "
            f"{salt:.3e} (tol 1e-5); heat change "
            f"{s1['heat'] - s0['heat']:.6e} J against the surface heat "
            f"flux's {flux:.6e} J over the run (heat content "
            f"{s0['heat']:.6e} J); KE {s1['KE']:.6e} J, T in "
            f"[{float(st1.T.min()):.4f}, {float(st1.T.max()):.4f}], h min "
            f"{float(st1.h.min()):.4e}, E_meke max "
            f"{float(st1.E_meke.max()):.4e} m2/s2")
        if not mass < 1e-6:
            raise AssertionError(f"{tag}: mass drift {mass}")
        if not salt < 1e-5:
            raise AssertionError(f"{tag}: salt drift {salt}")
        if not s1["KE"] > 0.0:
            raise AssertionError(f"{tag}: KE is not positive")
        _check_age(tag, st1, G, n * dt_therm)
        _check_hbl(st1, G, GV, p, f, tag)

        # steady-state cycle time without the host-side stats
        stepper = make_mom_stepper(G, GV, p, f, cycles_per_call=every)
        with torch.inference_mode():
            stepper(st1)
            torch.cuda.synchronize()
            t0 = time.time()
            stepper(st1)
            torch.cuda.synchronize()
            ms_cycle = 1e3 * (time.time() - t0) / every
            sypd = dt_therm / (ms_cycle / 1e3) / 365.0
            log(f"[{tag}] cycle time {ms_cycle:.3f} ms/thermo cycle ({every} "
                f"cycles, host clock, synchronised, no stats): SYPD "
                f"{sypd:.3f} (simulated years per wall day, "
                f"{p.n_dyn_per_thermo} x {p.dyn.dt} s a cycle)")
            one = make_mom_stepper(G, GV, p, f, cycles_per_call=1)
            dev_ms, n_kern, blocked = _profile(one, st1, tag)
            log(f"[{tag}] profiler, one cycle: {n_kern} kernel launches, "
                f"{dev_ms:.3f} ms of device time; device idle "
                f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}% of the "
                f"{ms_cycle:.3f} ms cycle; host blocked on a full command "
                f"buffer {blocked:.3f} ms")
            if tag == "full_physics":
                for k, ms in _thermo_phase_times(G, GV, st1, p, f).items():
                    log(f"[phase] {k}: {ms:.3f} ms")
        del st, st1, stepper, one
        torch.cuda.empty_cache()
    return counts_by


def build_global(dev):
    """configs/global_half_deg as committed, as a user would build it; the
    720x400 mosaic is generated in memory."""
    t0 = time.time()
    ms = build_model_from_params(
        ParamFile([os.path.join(GLOBAL_DIR, "MOM_input")]), device=dev)
    G, p = ms.grid, ms.params
    wet = G.mask2dT > 0.5
    log(f"[global] built configs/global_half_deg as committed (no reduction) "
        f"in {time.time() - t0:.1f} s: {G.nx}x{G.ny}x{ms.vgrid.nz}"
        f", fold_north {G.fold_north}, cyclic_x {G.cyclic_x}, ocean fraction "
        f"{float(G.mask2dT.mean()):.4f}, smallest wet cell "
        f"{float(G.dxT[wet].min()) / 1e3:.2f} x "
        f"{float(G.dyT[wet].min()) / 1e3:.2f} km; dt {p.dyn.dt}, "
        f"{p.n_dyn_per_thermo} baroclinic steps per thermo cycle, bt nstep "
        f"{p.dyn.bt.nstep} nfilter {p.dyn.bt.nfilter}, "
        f"{p.tracer_advect_sub} advection sub-sweeps, KHTH {p.gm.khth}, KHTR "
        f"{p.khtr} ({p.khtr_n_sub} subcycle), KH {p.hor_visc.kh}, EOS "
        f"{p.eos_name}, ALE {p.ale.mode} {p.ale.scheme}, boundary layer "
        f"{p.diabatic.boundary_layer_scheme}, shear mixing "
        f"{p.diabatic.use_shear_mixing}, restoring "
        f"{ms.forcing.buoy.restore_rate * 86400.0:.2f} m/day")
    if (G.nx, G.ny, ms.vgrid.nz) != GLOBAL_SHAPE[::-1] or not G.fold_north:
        raise AssertionError("not the half-degree tripolar grid")
    if p.diabatic.boundary_layer_scheme != "KPP" or ms.state.kv_shear is None:
        raise AssertionError("the committed global_half_deg runs KPP")
    return ms


def phase_global(dev, ms):
    """The tripolar global path at 720x400x32 through run_segment."""
    G, GV, st, p, f = ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing
    n = N_GLOBAL_CYCLES
    s0 = compute_stats(st, G, GV, p.dyn.dt)
    land = G.mask2dT[None] < 0.5
    wet = G.mask2dT > 0.5
    T_land = (st.T * land).clone()
    one = make_mom_stepper(G, GV, p, f, cycles_per_call=1)
    reset_kernel_launches()
    torch.cuda.synchronize()
    with torch.inference_mode():
        st = one(st)
    # KPP's viscosity after the first cycle, on the top interior interface
    kv = st.kv_shear
    kv1 = kv[1][wet]
    log(f"[global] after the first cycle: kv_shear on the top interior "
        f"interface nonzero in {int((kv1 > 0.0).sum())} of {kv1.numel()} "
        f"wet columns, max {float(kv1.max()):.4e} m2/s")
    if not (bool(torch.isfinite(kv).all()) and float(kv.min()) >= 0.0
            and not kv[0].any() and not kv[-1].any()):
        raise AssertionError("kv_shear is not a boundary-layer viscosity")
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=n - 1,
                               stats_interval=n - 1, verbose=True)
    counts = kernel_launches()
    log(f"[global] {n} thermo cycles ({n * p.n_dyn_per_thermo} baroclinic "
        f"steps): the last {n - 1} in {elapsed:.3f} s with one stats line: "
        f"{1e3 * elapsed / (n - 1):.2f} ms/cycle; launches {counts}; per "
        f"cycle {({k: c / n for k, c in counts.items()})}")
    _check_counts(counts, PER_GLOBAL_CYCLE, n, "global")
    if not (counts["ppm_edges_y_fold"] > 0 and counts["ppm_flux_y_fold"] > 0):
        raise AssertionError("the global path launched no fold kernel")
    for k in ("h", "u", "v", "T", "S"):
        if not bool(torch.isfinite(getattr(st1, k)).all()):
            raise AssertionError(f"non-finite {k}")
    s1 = compute_stats(st1, G, GV, p.dyn.dt)
    mass = abs(s1["mass"] - s0["mass"]) / s0["mass"]
    wet_T = st1.T[(~land).expand_as(st1.T)]
    t_lo, t_hi = float(wet_T.min()), float(wet_T.max())
    log(f"[global] mass drift {mass:.3e} (tol 1e-6); wet T in [{t_lo:.4f}, "
        f"{t_hi:.4f}] degC (must be inside (-3, 35)); KE {s1['KE']:.6e} J, "
        f"max CFL {s1['max_CFL']:.4f}, max |u| "
        f"{float(st1.u.abs().max()):.4f} m/s, max |v| "
        f"{float(st1.v.abs().max()):.4f} m/s, h min "
        f"{float(st1.h.min()):.4e}")
    if not mass < 1e-6:
        raise AssertionError(f"mass drift {mass}")
    if not (-3.0 < t_lo and t_hi < 35.0):
        raise AssertionError(f"wet T out of range: {t_lo}, {t_hi}")
    if not torch.equal(st1.T * land, T_land):
        raise AssertionError("land columns of T changed")
    if not s1["KE"] > 0.0:
        raise AssertionError("KE is not positive")
    _check_hbl(st1, G, GV, p, f)
    _check_kpp_cycles(dev, ms)

    # steady-state cycle time without the host-side stats
    with torch.inference_mode():
        one(st1)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(2):
            one(st1)
        torch.cuda.synchronize()
        ms_cycle = 1e3 * (time.time() - t0) / 2
        log(f"[global] cycle time {ms_cycle:.3f} ms/thermo cycle (2 cycles, "
            f"host clock, synchronised, no stats); "
            f"{1e3 * elapsed / (n - 1):.3f} ms/cycle with one stats line per "
            f"{n - 1} cycles")
        dev_ms, n_kern, blocked = _profile(one, st1, "global_half_deg")
        log(f"[global] profiler, one cycle: {n_kern} kernel launches, "
            f"{dev_ms:.3f} ms of device time; device idle "
            f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}% of the {ms_cycle:.3f} "
            f"ms cycle; host blocked on a full command buffer {blocked:.3f} "
            f"ms")
        for k, t in _thermo_phase_times(G, GV, st1, p, f).items():
            log(f"[phase] global {k}: {t:.3f} ms")
    return counts


def _check_hbl(st, G, GV, p, f, tag="global"):
    """KPP's boundary-layer depth on the state: finite, and inside
    [min_hbl, column depth] on wet columns."""
    from mom6_tpu_torch.physics.vertical.kpp import (KPPParams,
                                                     kpp_diffusivity)
    with torch.inference_mode():
        _, hbl, _ = kpp_diffusivity(st.h, st.u, st.v, st.T, st.S, G, GV,
                                    get_eos(p.eos_name), f.mech.taux,
                                    f.mech.tauy, f.buoy.heat_flux,
                                    cp=p.diabatic.cp)
    wet = G.mask2dT > 0.5
    hw, col = hbl[wet], st.h.sum(0)[wet]
    lo, hi = float(hw.min()), float(hw.max())
    log(f"[{tag}] boundary-layer depth on wet columns in [{lo:.3f}, "
        f"{hi:.3f}] m, median {float(hw.median()):.3f} m")
    if not bool(torch.isfinite(hbl).all()):
        raise AssertionError("non-finite boundary-layer depth")
    min_hbl = KPPParams().min_hbl
    if not (lo >= min_hbl
            and bool((hw <= torch.clamp(col, min=min_hbl)).all())):
        raise AssertionError(f"boundary-layer depth outside [min_hbl, "
                             f"column depth]: [{lo}, {hi}]")


def _mixed_top(st, G):
    """The state with a mixed top 375 m: in wet columns, T and S of layers
    1 and 2 those of layer 0."""
    wet = G.mask2dT > 0.5
    T, S = st.T.clone(), st.S.clone()
    for k in (1, 2):
        T[k] = torch.where(wet, T[0], T[k])
        S[k] = torch.where(wet, S[0], S[k])
    return st.replace(T=T, S=S)


def _cooled(ms):
    """The built model's initial state with a mixed top, and its forcing
    with a surface cooling of 300 W m-2."""
    G = ms.grid
    f = dataclasses.replace(ms.forcing, buoy=ms.forcing.buoy.replace(
        heat_flux=-300.0 * G.mask2dT))
    return _mixed_top(ms.state, G), f


def _check_kpp_cycles(dev, ms):
    """KPP where it mixes below the top layer, through step_mom.  (The
    committed configurations start from a linear stratification and
    restore SST with no heat flux: their boundary layer stays inside the
    top layer, where the shape function gives no interior diffusivity.)
    From the initial state with a mixed top under a surface cooling of
    300 W m-2, two thermo cycles, so that the second one's vertical
    friction takes the first one's kv_shear:

    * configs/global_half_deg as committed (``ms``: the main path, float32,
      720x400x32) on the card: kv_shear on the top interior interface
      nonzero after the first cycle, the fields finite after the second;
    * configs/global_2deg as committed in float64, each cycle on the card
      from the CPU's state before it against the CPU's cycle (the second
      one takes the CPU's kv_shear; two free cycles part beyond this
      tolerance, PERF.md section 7): h, u, v, T, S and kv_shear within
      1e-10 of their max-abs (T and S where the layer holds water, u and
      v on faces that do)."""
    G, GV, p = ms.grid, ms.vgrid, ms.params
    wet = G.mask2dT > 0.5
    st, f = _cooled(ms)
    with torch.inference_mode():
        st = step_mom(st, f, G, GV, p)
        kv1 = st.kv_shear[1][wet]
        st = step_mom(st, f, G, GV, p)
    log(f"[global] from a 375 m mixed top under 300 W/m2 of cooling "
        f"(float32, 720x400x32): kv_shear on the top interior interface "
        f"after the first cycle nonzero in {int((kv1 > 0).sum())} of "
        f"{kv1.numel()} wet columns, max {float(kv1.max()):.4e} m2/s")
    if not int((kv1 > 0).sum()) > 0:
        raise AssertionError("kv_shear after a cycle under cooling is zero "
                             "on the top interior interface")
    for k in ("h", "u", "v", "T", "S", "kv_shear"):
        if not bool(torch.isfinite(getattr(st, k)).all()):
            raise AssertionError(f"non-finite {k} after two cooled cycles")
    models = {}
    for where in ("cpu", dev):
        m2 = build_model_from_params(ParamFile([os.path.join(
            REPO, "configs", "global_2deg", "MOM_input")]),
            dtype=torch.float64, device=where)
        models[str(where)] = (m2,) + _cooled(m2)
    (mc, st, fc), (md, _, fd) = models["cpu"], models[str(dev)]
    wet2 = mc.grid.mask2dT > 0.5
    t0 = time.time()
    for n in (1, 2):
        with torch.inference_mode():
            ref = step_mom(st, fc, mc.grid, mc.vgrid, mc.params)
            got = step_mom(st.to(dev), fd, md.grid, md.vgrid, md.params)
        h = ref.h
        wet3 = {"T": h > 1e-3, "S": h > 1e-3,
                "u": 0.5 * (h + ip1(h)) > 1e-3,
                "v": 0.5 * (h + jp1(h, "h")) > 1e-3}
        errs = {k: rel_err(getattr(got, k).cpu() * wet3.get(k, 1),
                           getattr(ref, k) * wet3.get(k, 1))
                for k in ("h", "u", "v", "T", "S", "kv_shear")}
        kv = got.kv_shear[1][wet2.to(dev)]
        log(f"[global] global_2deg (float64) from a mixed top under "
            f"cooling, cycle {n} on the card from the CPU's state before "
            f"it, against the CPU's: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol 1e-10 relative to max-abs); kv_shear on the top "
            f"interior interface nonzero in {int((kv > 0).sum())} of "
            f"{kv.numel()} wet columns ({time.time() - t0:.1f} s)")
        for k, e in errs.items():
            if not e <= 1e-10:
                raise AssertionError(f"KPP cycle {n} card vs CPU {k}: {e}")
        if not int((kv > 0).sum()) > 0:
            raise AssertionError("global_2deg: kv_shear under cooling is "
                                 "zero")
        st = ref


def _golden_stats_errors(got, want):
    """Relative differences of the GOLDEN_TOL numbers of two stats."""
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in GOLDEN_TOL
            if k in want}


def phase_golden(dev):
    """The golden configurations in float64, card against CPU: each
    configuration's free run on the card against its free run on the
    CPU, and each cycle on the card from the CPU's state before it
    against the CPU's cycle; every stats number within GOLDEN_TOL.  The
    port divides by numbers with one rounding and sums the layers in
    order on both devices (framework/arith.py), so the two runs are
    expected to agree to the last bits even over vanished layers, where
    a difference in the last bit grows by orders within a few cycles."""
    failed = []
    for name, n in GOLDEN.items():
        pf = os.path.join(REPO, "configs", name, "MOM_input")
        runs = {}
        t0 = time.time()
        for where in ("cpu", dev):
            ms = build_model_from_params(ParamFile([pf]),
                                         dtype=torch.float64, device=where)
            states = [ms.state]
            with torch.inference_mode():
                for _ in range(n):
                    states.append(step_mom(states[-1], ms.forcing, ms.grid,
                                           ms.vgrid, ms.params))
            runs[str(where)] = (ms, states)
        (ms_c, cpu), (ms_d, card) = runs["cpu"], runs[str(dev)]
        for k in ("h", "u", "v", "T", "S", "kv_shear", "E_meke"):
            x = getattr(card[-1], k)
            if x is not None and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"golden {name}: non-finite {k}")
        dt = ms_c.params.dyn.dt

        def stats(st, ms):
            return compute_stats(st, ms.grid, ms.vgrid, dt)

        free = _golden_stats_errors(stats(card[-1], ms_d),
                                    stats(cpu[-1], ms_c))
        cyc = {k: 0.0 for k in free}
        with torch.inference_mode():
            for before, after in zip(cpu[:-1], cpu[1:]):
                st = step_mom(before.to(dev), ms_d.forcing, ms_d.grid,
                              ms_d.vgrid, ms_d.params)
                e = _golden_stats_errors(stats(st, ms_d), stats(after, ms_c))
                cyc = {k: max(cyc[k], e[k]) for k in cyc}
        same = all(torch.equal(getattr(card[-1], k).cpu(),
                               getattr(cpu[-1], k))
                   for k in ("h", "u", "v", "T", "S")
                   if getattr(cpu[-1], k) is not None)

        def fmt(errs):
            return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())

        log(f"[golden] {name} ({ms_c.grid.nx}x{ms_c.grid.ny}x"
            f"{ms_c.vgrid.nz}, {n} cycles, float64), card vs CPU in "
            f"{time.time() - t0:.1f} s: free runs {fmt(free)}; cycle by "
            f"cycle, largest {fmt(cyc)} (tol: mass, heat, salt 1e-12; KE, "
            f"APE 1e-9 relative); the free runs' final h, u, v, T, S "
            f"{'equal' if same else 'not equal'} to the bit")
        for what, errs in (("free run", free), ("cycle by cycle", cyc)):
            for k, e in errs.items():
                if not e <= GOLDEN_TOL[k]:
                    failed.append(f"{name} {what} {k} {e:.3e}")
    if failed:
        raise AssertionError("golden configurations, card vs CPU: "
                             + "; ".join(failed))


def phase_tracer_batch(dev):
    """configs/tracer_batch in float64: each cycle on the card from the
    CPU's state before it against the CPU's cycle, every tracer, h, T and
    S within 1e-10 of max-abs (CFC's exp, log, sqrt and interpolation may
    part by an ulp between the devices); then the asserts of the
    reference's tests/test_tracers.py on the card's last state.  Returns
    the launch counts of the card's cycles."""
    import torch_gates
    from mom6_tpu_torch.diagnostics.sum_output import tracer_stocks
    n = N_TRACER_CYCLES
    t0 = time.time()
    cpu = torch_gates.build("cpu", "tracer_batch", dtype=torch.float64)
    card = torch_gates.build(dev, "tracer_batch", dtype=torch.float64)
    names = card.params.tfc.registry.names
    G = card.grid
    passes = -(-(2 + len(names)) // 4)
    log(f"[tracer_batch] configs/tracer_batch {G.nx}x{G.ny}x{card.vgrid.nz} "
        f"in float64, {len(names)} registered tracers ({names[0]} ... "
        f"{names[-1]}); the cell-field remap takes T, S and the "
        f"{len(names)} as one call of {2 + len(names)} fields, {passes} "
        f"kernel passes of at most 4")
    st_c = cpu.state
    worst = {}
    reset_kernel_launches()
    with torch.inference_mode():
        for c in range(1, n + 1):
            st_d = step_mom(st_c.to(dev), card.forcing, G, card.vgrid,
                            card.params)
            st_c = step_mom(st_c, cpu.forcing, cpu.grid, cpu.vgrid,
                            cpu.params)
            errs = {k: rel_err(getattr(st_d, k).cpu(), getattr(st_c, k))
                    for k in ("h", "T", "S")}
            errs.update({k: rel_err(st_d.tr[k].cpu(), st_c.tr[k])
                         for k in names})
            worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
            bad = {k: e for k, e in errs.items() if not e <= 1e-10}
            if bad:
                raise AssertionError(f"tracer_batch cycle {c}, card vs CPU: "
                                     f"{bad}")
        torch.cuda.synchronize()
    counts = kernel_launches()
    _check_counts(counts, PER_CYCLE, n, "tracer_batch")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    log(f"[tracer_batch] {n} cycles, each on the card from the CPU's state "
        f"before it, in {time.time() - t0:.1f} s: largest differences "
        + ", ".join(f"{k} {e:.3e}" for k, e in top)
        + f" (tol 1e-10 relative to max-abs, all {len(worst)} fields); "
        f"launches {counts}, remap calls per cycle {counts['remap'] / n:g}")
    tr = st_d.tr
    if len(names) != 24 or sum(k.startswith("dye") for k in names) != 20:
        raise AssertionError(f"tracer_batch registers {names}")
    for k in names:
        if not bool(torch.isfinite(tr[k]).all()):
            raise AssertionError(f"tracer_batch: non-finite {k}")
    lo, hi = [], []
    for m in range(20):
        d = tr[f"dye{m + 1:03d}"]
        lo.append(float(d.min()))
        hi.append(float(d.max()))
    stocks = tracer_stocks(tr, st_d.h, G, names=names)
    log(f"[tracer_batch] the card's state after {n} cycles: dyes in "
        f"[{min(lo):.3e}, {max(hi):.6f}], each painted to at least "
        f"{min(hi):.6f}; stocks cfc11 {stocks['cfc11']:.6e}, cfc12 "
        f"{stocks['cfc12']:.6e} mol, age {stocks['age']:.6e} yr m3")
    if not (min(lo) >= -1e-5 and max(hi) <= 1.0 + 1e-5 and min(hi) > 0.99):
        raise AssertionError("tracer_batch: a dye left [0, 1] or was not "
                             "painted")
    if not (stocks["cfc11"] > 0.0 and stocks["cfc12"] > 0.0
            and stocks["age"] > 0.0):
        raise AssertionError(f"tracer_batch: stocks {stocks}")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the open boundaries in this process

def _obc_cycler(ms):
    """(state, cycle index) -> the state a thermo cycle later, with the
    forcing provider's data at the cycle's midpoint where there is one."""
    dt_cycle = ms.params.dyn.dt * ms.params.n_dyn_per_thermo

    def cycle(st, k):
        f = ms.forcing if ms.forcing_provider is None \
            else ms.forcing_provider((k + 0.5) * dt_cycle)
        with torch.inference_mode():
            return step_mom(st, f, ms.grid, ms.vgrid, ms.params)
    return cycle


def phase_obc(dev):
    """Each run directory with open boundaries as committed, in float32
    on the card: one cycle to warm up, then N_OBC_CYCLES cycles with their
    launches held exactly to ``obc_cycle`` and their wall ms per cycle
    (host clock, synchronised), then one cycle under the profiler (device
    time and idle share).  Returns the launches of the tc3 and dome runs."""
    out = {}
    for name, (n_dyn, bt_cont, thermo) in OBC_CONFIGS.items():
        ms = build_model_from_params(ParamFile([os.path.join(
            TREE, "configs", name, "MOM_input")]), device=dev)
        p = ms.params
        got = (p.n_dyn_per_thermo, p.dyn.bt.use_bt_cont,
               None if not p.thermo_enabled else
               ("layer" if p.ale.mode == "LAYER" else p.ale.mode.lower()))
        if p.obc is None or got != (n_dyn, bt_cont, thermo):
            raise AssertionError(f"{name}: built {got}, obc {p.obc}")
        cycle = _obc_cycler(ms)
        st = cycle(ms.state, 0)
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.time()
        for k in range(1, N_OBC_CYCLES + 1):
            st = cycle(st, k)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0) / N_OBC_CYCLES
        counts = kernel_launches()
        _check_counts(counts, obc_cycle(n_dyn, bt_cont, thermo),
                      N_OBC_CYCLES, name)
        for k in ("h", "u", "v"):
            if not bool(torch.isfinite(getattr(st, k)).all()):
                raise AssertionError(f"{name}: non-finite {k}")
        dev_ms, n_kern, blocked = _profile(
            lambda s: cycle(s, N_OBC_CYCLES + 1), st, f"obc_{name}")
        G = ms.grid
        log(f"[obc] {name} {G.nx}x{G.ny}x{ms.vgrid.nz} float32, "
            f"{n_dyn} split step(s) a cycle (bt nstep {p.dyn.bt.nstep}), "
            f"BT_cont {bt_cont}, thermo {thermo}: {wall:.2f} wall ms per "
            f"cycle over {N_OBC_CYCLES} cycles (host clock, synchronised); "
            f"profiler, one cycle: {n_kern} kernels, {dev_ms:.3f} ms of "
            f"device time, device idle {100.0 * (1.0 - dev_ms / wall):.1f}%"
            f" of the cycle; host blocked on a full command buffer "
            f"{blocked:.3f} ms; hand-written kernel launches per cycle "
            f"{ {k: v // N_OBC_CYCLES for k, v in counts.items()} }")
        if name in ("tc3", "dome"):
            out[f"obc_{name}"] = counts
    return out


# ---------------------------------------------------------------------------
# phase 12: the port's command line, python -m mom6_tpu_torch.drivers.solo

SOLO_OUT = os.path.join(OUT, "solo")
# the run directories of the idealized user cases: card against CPU
NEW_CONFIGS = ("dome2d_overflow", "dumbbell", "hurricane", "neverworld",
               "phillips_channel", "rossby_front", "scm_kpp", "seamount",
               "seasonal_gyre")
# split 2 + 2 against 4 straight thermo cycles; both runs write a stats
# line every cycle (tidal_bay takes its segment data at each stats
# segment's midpoint)
SPLIT_CONFIGS = ("rho_basin", "tracer_batch", "tidal_bay")
N_SOLO_PROCS = 6            # CLI processes at once in the solo checks


def _solo_dir(name, sub, override="", files=()):
    """A fresh copy of configs/<name> (with its data files) and of
    ``files`` (paths in the checkout) under chip_smoke_out/solo
    (seasonal_gyre with its forcing file from the port's writer)."""
    import shutil
    from mom6_tpu_torch.drivers.user_cases import write_seasonal_forcing
    d = os.path.join(SOLO_OUT, sub, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(TREE, "configs", name), d)
    for f in files:
        shutil.copy(os.path.join(TREE, f), d)
    if name == "seasonal_gyre":
        write_seasonal_forcing(os.path.join(d, "forcing_monthly.nc"))
    if override:
        with open(os.path.join(d, "MOM_override"), "w") as f:
            f.write(override)
    return d


def _run_solo(runs, n_at_once=N_SOLO_PROCS):
    """Run each (run directory, CLI arguments) as users do,
    ``python -m mom6_tpu_torch.drivers.solo DIR ARGS``, n at a time; each
    must exit with 0.  Returns {run directory: seconds}."""
    todo, running, secs = list(runs), {}, {}
    while todo or running:
        while todo and len(running) < n_at_once:
            d, args = todo.pop(0)
            running[d] = _start_solo(d, args)
        for d, run in list(running.items()):
            if run[0].poll() is None:
                continue
            del running[d]
            try:
                secs[d] = _end_solo(d, run)
            except AssertionError:
                for other, run_o in running.items():
                    run_o[0].kill()
                    run_o[0].communicate()
                    run_o[2].close()
                raise
        time.sleep(0.2)
    return secs


def _start_solo(d, args):
    """Start ``python -m mom6_tpu_torch.drivers.solo d args``; returns
    (process, start time, its log file)."""
    env = dict(os.environ, PYTHONPATH=TREE, OMP_NUM_THREADS="2")
    log_f = open(os.path.join(d, "solo.log"), "w")
    return (subprocess.Popen(
        [sys.executable, "-m", "mom6_tpu_torch.drivers.solo", d]
        + list(args), cwd=TREE, env=env, stdout=log_f,
        stderr=subprocess.STDOUT), time.time(), log_f)


def _end_solo(d, run):
    """Wait for a run of :func:`_start_solo`; it must exit with 0.
    Returns its seconds."""
    proc, t0, log_f = run
    proc.wait()
    log_f.close()
    if proc.returncode != 0:
        with open(os.path.join(d, "solo.log")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"solo {d} exited with {proc.returncode}: "
                             f"{tail}")
    return time.time() - t0


def _solo_stats(d):
    """ocean.stats of a run directory as a list of {column: value}."""
    from mom6_tpu_torch.diagnostics.sum_output import read_stats
    return read_stats(os.path.join(d, "ocean.stats"))


def _solo_cputime(d):
    """(wall s, SYPD, {timer: s}, kernel launches) of ocean.cputime."""
    with open(os.path.join(d, "ocean.cputime")) as f:
        text = f.read()
    m = re.search(r"wall\s+([0-9.]+) s.*SYPD\s+([0-9.]+)", text)
    timers = {k.strip(): float(v) for k, v in re.findall(
        r"^\s*([a-z][a-z.+ ]+?)\s+([0-9.]+)s\s+\d+ calls", text, re.M)}
    launches = json.loads(text.split("kernel launches: ")[-1].splitlines()[0])
    return float(m.group(1)), float(m.group(2)), timers, launches


def phase_solo_global(dev, ms):
    """configs/global_half_deg as committed through the CLI for one day
    (12 thermo cycles, one ocean.stats line); the outputs; its restart
    restored at full shape; one stats call on the card both ways."""
    from mom6_tpu_torch.diagnostics.sum_output import compute_stats_device
    from mom6_tpu_torch.framework.restart import RestartRegistry
    from mom6_tpu_torch.io.netcdf import read_nc
    d = _solo_dir("global_half_deg", "global")
    secs = _run_solo([(d, ["--days", "1"])], 1)[d]
    G, GV, p = ms.grid, ms.vgrid, ms.params
    n = int(round(86400.0 / (p.dyn.dt * p.n_dyn_per_thermo)))
    lines = _solo_stats(d)
    wall, sypd, timers, launches = _solo_cputime(d)
    log(f"[solo] python -m mom6_tpu_torch.drivers.solo global_half_deg "
        f"--days 1: {n} thermo cycles, {len(lines)} ocean.stats line(s), "
        f"process {secs:.1f} s; ocean.cputime: wall {wall:.2f} s, SYPD "
        f"{sypd:.2f}, {1e3 * wall / n:.1f} wall ms per cycle "
        f"({1e3 * timers.get('ocean dynamics+thermo', 0.0) / n:.1f} ms "
        f"stepping, {1e3 * timers.get('ocean.stats', 0.0):.1f} ms in "
        f"{len(lines)} stats call(s), "
        f"{1e3 * timers.get('diag mediator', 0.0):.1f} ms posting the "
        f"diagnostics); launches {launches}")
    s = lines[-1]
    if len(lines) != 1 or s["step"] != n:
        raise AssertionError(f"global ocean.stats: {lines}")
    if not all(math.isfinite(v) for v in s.values()):
        raise AssertionError(f"global ocean.stats not finite: {s}")
    if not abs(s["dM_net"]) < 1e-6 * s["Mass"]:
        raise AssertionError(f"global mass drift {s['dM_net']}")
    if not ("dS_net" in s and "dH_net" in s):
        raise AssertionError("no salt or heat drift column")
    for f in ("chksum_diag", "ocean.cputime", "ocean_diags.nc",
              "MOM_parameter_doc.all", "MOM_parameter_doc.short",
              os.path.join("RESTART", "ocean_solo.res")):
        if not os.path.exists(os.path.join(d, f)):
            raise AssertionError(f"no {f}")
    res = read_nc(os.path.join(d, "MOM.res.nc"))
    reg = RestartRegistry()
    names = reg.register_state(ms.state)
    for k in names:
        want = tuple(reg.get(k, ms.state).shape)
        if k not in res or res[k].shape != want:
            raise AssertionError(f"MOM.res.nc {k}: {res.get(k, None)}")
    diags = sorted(read_nc(os.path.join(d, "ocean_diags.nc")))
    log(f"[solo] MOM.res.nc holds {names} at full shape {GLOBAL_SHAPE}; "
        f"ocean_diags.nc holds {diags}")
    # the CLI's process builds with no kernel and steps n global cycles
    _check_counts(launches, PER_GLOBAL_CYCLE, n, "solo global_half_deg")
    # the restart on the card, and ocean.stats from it both ways
    st, t_s, _ = reg.restore_state(os.path.join(d, "MOM.res.nc"), ms.state)
    cp = p.diabatic.cp
    with torch.inference_mode():
        s_dev = compute_stats_device(st, G, GV, p.dyn.dt, cp=cp)
        t_dev = median_ms(lambda: compute_stats_device(st, G, GV, p.dyn.dt,
                                                      cp=cp), reps=5, warm=1)
        torch.cuda.synchronize()
        t0 = time.time()
        s_host = compute_stats(st, G, GV, p.dyn.dt, cp=cp)
        t_host = 1e3 * (time.time() - t0)
    for k, tag in (("mass", "Mass"), ("salt", "Salt"), ("heat", "Heat"),
                   ("KE", "KE"), ("APE", "APE")):
        tol = 1e-6 if k in ("KE", "APE") else 1e-11
        if abs(s_dev[k] - s[tag]) > tol * abs(s[tag]):
            raise AssertionError(f"{k}: restored {s_dev[k]} against the "
                                 f"CLI's {s[tag]}")
        if abs(s_dev[k] - s_host[k]) > 1e-5 * abs(s_host[k]):
            raise AssertionError(f"{k}: device {s_dev[k]} host {s_host[k]}")
    rel = {k: abs(s_dev[k] / s_host[k] - 1.0) for k in s_host if s_host[k]}
    log(f"[solo] the restart at t = {t_s:.0f} s on the card gives the CLI's "
        f"ocean.stats line again; one stats call at "
        f"{GLOBAL_SHAPE[2]}x{GLOBAL_SHAPE[1]}x{GLOBAL_SHAPE[0]}: on the card "
        f"(compute_stats_device, fixed-point sums) {t_dev:.2f} ms, on the "
        f"host (compute_stats, float64 reproducing sums) {t_host:.1f} ms; "
        f"relative differences {rel}")
    return launches


def _table_run(d, days, n_dyn, what):
    """Read a diag_table run of the CLI: its ocean.cputime, its launches
    held to its cycles and posts exactly, ocean_diags.nc's fields finite
    and diag_rejected.  Returns (wall s, SYPD, timers, launches, cycles,
    fields)."""
    from mom6_tpu_torch.io.netcdf import read_nc
    lines = _solo_stats(d)
    wall, sypd, timers, launches = _solo_cputime(d)
    n = lines[-1]["step"]
    posts = len(lines)
    want = {k: n * c + posts * table_post(n_dyn)[k]
            for k, c in fold_cycle(n_dyn).items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{n} cycles and {posts} posts: {want}")
    out = read_nc(os.path.join(d, "ocean_diags.nc"))
    fields = sorted(k for k in out if k.startswith("ocean_model_"))
    bad = [k for k in fields if not np.isfinite(out[k]).all()]
    if bad or len(fields) < 120:
        raise AssertionError(f"{what}: {len(fields)} fields, not finite "
                             f"{bad}")
    with open(os.path.join(d, "diag_rejected")) as f:
        rejected = [ln.split(":")[0] for ln in f.read().splitlines()]
    log(f"[table] {what} --days {days}: {n} thermo cycles, {posts} post(s); "
        f"ocean.cputime: wall {wall:.2f} s, SYPD {sypd:.2f}, "
        f"{1e3 * wall / n:.1f} wall ms per cycle "
        f"({1e3 * timers.get('ocean dynamics+thermo', 0.0) / n:.1f} ms "
        f"stepping, {1e3 * timers.get('diag mediator', 0.0) / posts:.1f} "
        f"ms a post); {len(fields)} fields in ocean_diags.nc, all finite; "
        f"rejected {rejected}; launches {launches} = {n} x "
        f"{fold_cycle(n_dyn)} + {posts} x {table_post(n_dyn)}")
    return wall, sypd, timers, launches, n, out


def _post_breakdown(ms, d):
    """One post of the table in this process on the state the CLI's day
    ended with (its MOM.res.nc): the launches of one post, held to
    PER_TABLE_POST, and the device-synchronised host time of the post and
    of its parts."""
    from mom6_tpu_torch.diagnostics import wave_speed as ws
    from mom6_tpu_torch.diagnostics.catalog import DiagContext, serve
    from mom6_tpu_torch.drivers import solo as solo_mod
    from mom6_tpu_torch.framework.diag_mediator import DiagMediator
    from mom6_tpu_torch.framework.restart import RestartRegistry
    G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
    reg = RestartRegistry()
    reg.register_state(ms.state)
    st, _, _ = reg.restore_state(os.path.join(d, "MOM.res.nc"), ms.state)
    eos = get_eos(p.eos_name)
    ke_fn = solo_mod.make_ke_budget_fn(G, GV, p)
    tend_fn = solo_mod.make_tend_fn(G, GV, p)

    def post():
        dm = DiagMediator.from_diag_table(
            os.path.join(d, "diag_table"),
            z_targets=np.asarray(p.ale.dz_nominal),
            rho_targets=GV.Rlay.cpu().numpy().astype(np.float64),
            nz_sigma=GV.nz, areaT=G.areaT.cpu().numpy(), device=st.h.device)
        solo_mod._post_table_diags(dm, st, G, GV, p, f, ke_fn, tend_fn)

    def secs(fn, n=2):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    with torch.inference_mode():
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post()
        torch.cuda.synchronize()
        t_post = 1e3 * (time.perf_counter() - t0)
        counts = kernel_launches()
        _check_counts(counts, PER_TABLE_POST, 1, "one table post")
        parts = {
            "post (the first)": [t_post],
            "KE budget (a split step)": secs(lambda: ke_fn(st, f)),
            "tendencies (a thermo cycle)": secs(lambda: tend_fn(st, f)),
            "wave_speed (10 solves)": secs(lambda: ws.wave_speed(
                st.h, st.T, st.S, G, GV, eos)),
        }

        def rest():
            # the KE budget, the tendencies and cg1 as computed
            ctx = DiagContext(st, G, GV, p, forcing=f, eos=eos)
            ctx._cache.update(ke_terms={}, tend={}, cg1=st.h[0])
            for name in names:
                serve(name, ctx)
        names = cat_names(d)
        parts["the other fields, on the card"] = secs(rest)
    log(f"[table] one post at {GV.nz}x{G.ny}x{G.nx} in this process, on "
        f"the state after the CLI's day: launches {counts} (= "
        f"PER_TABLE_POST); host ms with the device synchronised, the "
        f"parts two calls each after a warm one: " + "; ".join(
            f"{k} {', '.join(f'{v:.1f}' for v in vs)}"
            for k, vs in parts.items()))
    return counts, parts


def cat_names(d):
    """The catalog names of a run directory's diag_table fields."""
    from mom6_tpu_torch.drivers.solo import _base_name
    from mom6_tpu_torch.framework.diag_mediator import parse_diag_table
    return sorted({_base_name(f[1]) for f in parse_diag_table(
        os.path.join(d, "diag_table")).fields})


def phase_solo_table(dev, ms):
    """The diag_table path of the CLI, timed alone: configs/global_half_deg
    with global_2deg's diag_table for a day (12 cycles, one post, f32,
    720x400x32) and configs/global_2deg as committed for a day in float64
    (24 cycles, one post), each in its own process; then one post in this
    process, its launches and its parts.  Returns the launches of the
    two runs."""
    table = (os.path.join("configs", "global_2deg", "diag_table"),)
    d_half = _solo_dir("global_half_deg", "table", files=table)
    d_2deg = _solo_dir("global_2deg", "card", "DOUBLE_PRECISION = True\n")
    secs = _run_solo([(d_half, ["--days", "1"])], 1)
    secs.update(_run_solo([(d_2deg, ["--days", "1"])], 1))
    out = {}
    for d, n_dyn, what in ((d_half, 6, "global_half_deg with the table "
                            "f32"), (d_2deg, 2, "global_2deg f64 on the "
                                     "card")):
        out[d] = _table_run(d, 1, n_dyn, what)
        log(f"[table] {what}: process {secs[d]:.1f} s")
    _post_breakdown(ms, d_half)
    return {"solo_table_global_half_deg": out[d_half][3],
            "solo_table_global_2deg": out[d_2deg][3]}


def _diag_differences(a, b, table, h_wet=1e-3):
    """Each ocean_model_ field's largest difference between two
    ocean_diags.nc contents written for the diag_table ``table``,
    relative to its max-abs in ``b``: on the layers where ``b``'s layer
    holds water (u, v and corner fields where the mean of the two
    neighbours does), at the interfaces where a layer on either side
    does."""
    from mom6_tpu_torch.diagnostics.catalog import CATALOG
    from mom6_tpu_torch.drivers.solo import _base_name
    from mom6_tpu_torch.framework.diag_mediator import parse_diag_table
    field_of = {f"ocean_model_{out}": fld
                for _, fld, out, _, _ in parse_diag_table(table).fields}
    h = np.asarray(b["ocean_model_h"], np.float64)
    wet = {"h": h > h_wet,
           "u": 0.5 * (h + np.roll(h, -1, -1)) > h_wet,
           "v": 0.5 * (h + np.roll(h, -1, -2)) > h_wet}
    wet["q"] = wet["u"] & wet["v"]
    w_lay = h > h_wet
    w_int = np.zeros((h.shape[0] + 1,) + h.shape[1:], bool)
    w_int[:-1] |= w_lay
    w_int[1:] |= w_lay
    out = {}
    for k in sorted(b):
        if not k.startswith("ocean_model_"):
            continue
        w = np.asarray(b[k], np.float64)
        diff = np.abs(np.asarray(a[k], np.float64) - w)
        stagger = CATALOG[_base_name(field_of[k])].stagger
        if w.shape == h.shape:
            diff = diff * wet.get(stagger, wet["h"])
        elif w.shape == w_int.shape:
            diff = diff * w_int
        out[k[len("ocean_model_"):]] = float(
            diff.max() / max(np.abs(w).max(), 1e-300))
    return out


def start_table_cpu():
    """Start configs/global_2deg for a day in float64 on the CPU
    (--device cpu), the reference of phase_solo_table_cpu."""
    cpu = _solo_dir("global_2deg", "cpu", "DOUBLE_PRECISION = True\n")
    return cpu, _start_solo(cpu, ["--days", "1", "--device", "cpu"])


def phase_solo_table_cpu(started):
    """The CPU's day of configs/global_2deg (``started`` by
    start_table_cpu) against the card's of phase_solo_table: the same
    fields and rejections, ocean.stats to the golden tolerances and every
    field of ocean_diags.nc within 1e-10 of its max-abs (on the layers
    and faces that hold water)."""
    from mom6_tpu_torch.io.netcdf import read_nc
    card = os.path.join(SOLO_OUT, "card", "global_2deg")
    cpu, run = started
    secs = _end_solo(cpu, run)
    a = read_nc(os.path.join(card, "ocean_diags.nc"))
    b = read_nc(os.path.join(cpu, "ocean_diags.nc"))
    if sorted(a) != sorted(b):
        raise AssertionError("global_2deg: card and CPU wrote other fields")
    with open(os.path.join(card, "diag_rejected")) as fa, \
            open(os.path.join(cpu, "diag_rejected")) as fb:
        if fa.read() != fb.read():
            raise AssertionError("global_2deg: other rejections")
    errs = {}
    for ra, rb in zip(_solo_stats(card), _solo_stats(cpu)):
        for k in ("Mass", "Salt", "Heat", "KE", "APE"):
            errs[k] = abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-300)
    fields = _diag_differences(a, b, os.path.join(cpu, "diag_table"))
    worst = sorted(fields.items(), key=lambda kv: -kv[1])
    log(f"[table] global_2deg f64 --days 1, card against CPU "
        f"({secs:.1f} s on the CPU with its process): ocean.stats relative "
        f"differences {errs}; {len(fields)} fields of ocean_diags.nc, the "
        f"largest relative differences (of max-abs, where water) "
        f"{worst[:8]}; all: {fields}")
    bad = {k: e for k, e in errs.items()
           if e > (1e-9 if k in ("KE", "APE") else 1e-12)}
    bad.update({k: e for k, e in fields.items() if not e <= 1e-10})
    if bad:
        raise AssertionError(f"global_2deg card against CPU: {bad}")
    return fields


def _cycle_days(name, n):
    """``n`` thermo cycles of configs/<name> in days, as the CLI's --days
    argument."""
    pf = ParamFile([os.path.join(TREE, "configs", name, "MOM_input")])
    dt = pf.get("DT", float)
    return repr(n * pf.get("DT_THERM", float, default=dt) / 86400.0)


def phase_solo_runs(dev):
    """The split runs (rho_basin, tracer_batch and tidal_bay in float64,
    2 + 2 against 4 straight cycles, on the card), the nine new run
    directories and the six with open boundaries for 2 cycles in float64
    on the card and on the CPU, and seasonal_gyre for half a day in
    float32 through its forcing file."""
    from mom6_tpu_torch.io.netcdf import read_nc
    from mom6_tpu_torch.framework.restart import restart_differences
    f64 = "DOUBLE_PRECISION = True\n"
    first = []
    split_ov = {n: f"{f64}ENERGYSAVEDAYS = {_cycle_days(n, 1)}\n"
                for n in SPLIT_CONFIGS}
    for name in SPLIT_CONFIGS:
        ov = split_ov[name]
        first += [(_solo_dir(name, "straight", ov),
                   ["--days", _cycle_days(name, 4)]),
                  (_solo_dir(name, "first", ov),
                   ["--days", _cycle_days(name, 2)])]
    pairs = {}
    for name in NEW_CONFIGS + tuple(OBC_CONFIGS):
        days = _cycle_days(name, 2)
        card = _solo_dir(name, "card", f64)
        cpu = _solo_dir(name, "cpu", f64)
        pairs[name] = (card, cpu)
        first += [(card, ["--days", days]),
                  (cpu, ["--days", days, "--device", "cpu"])]
    sg = _solo_dir("seasonal_gyre", "f32", "ENERGYSAVEDAYS = 0.125\n")
    first.append((sg, ["--days", "0.5"]))
    secs = _run_solo(first)
    second = []
    for name in SPLIT_CONFIGS:
        d = _solo_dir(name, "second", split_ov[name])
        import shutil
        shutil.copy(os.path.join(SOLO_OUT, "first", name, "RESTART",
                                 "ocean_solo.res"), d)
        second.append((d, ["--days", _cycle_days(name, 2), "--restart-in",
                           os.path.join(SOLO_OUT, "first", name,
                                        "MOM.res.nc")]))
    secs.update(_run_solo(second))
    for name in SPLIT_CONFIGS:
        a = read_nc(os.path.join(SOLO_OUT, "straight", name, "MOM.res.nc"))
        b = read_nc(os.path.join(SOLO_OUT, "second", name, "MOM.res.nc"))
        diff = [k for k in a if k != "__step__"
                and not np.array_equal(a[k], b.get(k))]
        if diff or sorted(a) != sorted(b):
            raise AssertionError(f"split {name}: {diff}")
        log(f"[solo] {name} f64 on the card: 2 + 2 cycles (--restart-in) "
            f"equal 4 straight cycles to the bit in all {len(a) - 2} "
            f"restart fields")
    worst = {}
    for name, (card, cpu) in pairs.items():
        a, b = _solo_stats(card), _solo_stats(cpu)
        if len(a) != len(b) or not a:
            raise AssertionError(f"{name}: {a} {b}")
        errs = {}
        for ra, rb in zip(a, b):
            for k in ("Mass", "Salt", "Heat", "KE", "APE"):
                if k in rb:
                    errs[k] = max(errs.get(k, 0.0), abs(ra[k] - rb[k])
                                  / max(abs(rb[k]), 1e-300))
        for k, e in errs.items():
            if e > (1e-9 if k in ("KE", "APE") else 1e-12):
                raise AssertionError(f"{name} card against CPU: {k} {e}")
        errs["fields"] = max(restart_differences(
            os.path.join(card, "MOM.res.nc"),
            os.path.join(cpu, "MOM.res.nc")).values())
        if errs["fields"] > 1e-10:
            raise AssertionError(f"{name} card against CPU: restart fields "
                                 f"{errs['fields']}")
        worst[name] = errs
        extra = ""
        if name in OBC_CONFIGS:
            wall = _solo_cputime(card)[0]
            extra = (f"; ocean.cputime on the card: {1e3 * wall / 2:.1f} "
                     f"wall ms per cycle (beside the gates)")
        log(f"[solo] {name} f64, 2 cycles through the CLI, card against "
            f"CPU: relative differences of ocean.stats and of the restart "
            f"fields (of max-abs; T, S where a layer holds water, u, v on "
            f"faces that do) {errs}; "
            f"{secs[card]:.1f} s on the card, {secs[cpu]:.1f} s on the CPU "
            f"(each with its process){extra}")
    lines = _solo_stats(sg)
    if len(lines) != 4 or not all(math.isfinite(v) for r in lines
                                  for v in r.values()):
        raise AssertionError(f"seasonal_gyre f32: {lines}")
    ms = build_model_from_params(ParamFile([os.path.join(sg, "MOM_input"),
                                            os.path.join(sg, "MOM_override")]),
                                 device=dev)
    dt_seg = 0.125 * 86400.0
    taux = [ms.forcing_provider((c + 0.5) * dt_seg).mech.taux
            for c in range(4)]
    change = [float((taux[c + 1] - taux[c]).abs().max()) for c in range(3)]
    if not all(x > 0.0 for x in change):
        raise AssertionError(f"seasonal_gyre: the wind does not change "
                             f"{change}")
    log(f"[solo] seasonal_gyre f32 --days 0.5 through forcing_monthly.nc: "
        f"{len(lines)} ocean.stats lines, finite, mass drift "
        f"{lines[-1]['dM_net']:.3e} of {lines[-1]['Mass']:.6e} kg; the wind "
        f"at the segments' midpoints changes by {change} Pa from segment to "
        f"segment; {secs[sg]:.1f} s")
    return worst


# the gates by their CPU time, longest first (tests/test_torch_analytic.py)
GATE_ORDER = ("kpp_convective_deepening",
              "phillips_baroclinic_instability_growth",
              "dome_plume_turns_west", "tidal_bay_file_forcing",
              "hurricane_cold_wake", "kelvin_wave_trapped_at_coast",
              "epbl_convective_deepening", "lock_exchange_benjamin_front",
              "ekman_spiral_finite_depth", "stommel_gyre_sverdrup_balance")


def start_gates():
    """The physics gates, each in a process of its own on the card
    (``--gate``), N_GATE_PROCS at a time, the longest first, started by a
    thread; returns the pool for :func:`phase_physics` and
    :func:`stop_gates`."""
    import torch_gates
    names = list(GATE_ORDER) + [g for g in torch_gates.GATES
                                if g not in GATE_ORDER]
    pool = {"todo": names, "running": {}, "done": {}, "t0": time.time(),
            "lock": threading.Lock()}
    pool["thread"] = threading.Thread(target=_pump_gates, args=(pool,),
                                      daemon=True)
    pool["thread"].start()
    return pool


def _pump_gates(pool):
    """Keep N_GATE_PROCS gates running until every gate has ended."""
    while True:
        with pool["lock"]:
            for name, (proc, t0) in list(pool["running"].items()):
                if proc.poll() is not None:
                    out, err = proc.communicate()
                    pool["done"][name] = (proc.returncode, out, err,
                                          time.time() - t0)
                    del pool["running"][name]
            while pool["todo"] and len(pool["running"]) < N_GATE_PROCS:
                name = pool["todo"].pop(0)
                cmd = [sys.executable, os.path.abspath(__file__), "--gate",
                       name] + (["--tree", TREE] if TREE != REPO else [])
                pool["running"][name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), time.time())
            if not pool["running"]:
                return
        time.sleep(0.5)


def stop_gates(pool):
    """End every gate process still running (after a failure)."""
    with pool["lock"]:
        pool["todo"] = []
        for proc, _ in pool["running"].values():
            proc.kill()
            proc.communicate()
        pool["running"] = {}


def phase_physics(pool):
    """Wait for every gate; one line per case; any miss raises.  Returns
    the launch counts summed over the gates."""
    pool["thread"].join()
    counts = {k: 0 for k in kernel_launches()}
    failed = []
    import torch_gates
    for name in torch_gates.GATES:
        rc, out, err, secs = pool["done"][name]
        rec = None
        for ln in out.splitlines():
            if ln.startswith("GATE "):
                rec = json.loads(ln[5:])
        if rc != 0 or rec is None or not rec.get("passed"):
            log(f"[physics] {name}: FAILED ({secs:.1f} s): "
                f"{rec and rec.get('error_text')} {err[-2000:]}")
            failed.append(name)
            continue
        r = rec["record"]
        extra = {k: v for k, v in r.items() if k not in (
            "quantity", "measured", "analytic", "error", "gate", "seconds")}
        log(f"[physics] {name}: {r['quantity']} {r['measured']:.6g} against "
            f"{r['analytic']:.6g} analytic, error {r['error']:+.4g}; gate "
            f"{r['gate']}: passed; {r['seconds']:.1f} s on the card "
            f"({secs:.1f} s with its process)"
            + (f"; {extra}" if extra else ""))
        for k in counts:
            counts[k] += rec["counts"][k]
    log(f"[physics] {len(torch_gates.GATES)} gates in "
        f"{time.time() - pool['t0']:.1f} s, {N_GATE_PROCS} processes at a "
        f"time; launches summed over the gates {counts}")
    if failed:
        raise AssertionError(f"physics gates failed: {failed}")
    return counts


def gate_main(name):
    """``--gate NAME``: one physics gate on the card, its record and its
    launch counts as one JSON line."""
    import torch_gates
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    reset_kernel_launches()
    try:
        rec = torch_gates.run_gate(name, "cuda")
    except AssertionError as e:
        print("GATE " + json.dumps({"passed": False,
                                    "error_text": repr(e)[:2000]}),
              flush=True)
        raise
    print("GATE " + json.dumps({"passed": True, "record": rec,
                                "counts": kernel_launches()}), flush=True)


def main():
    if "--gate" in sys.argv:
        gate_main(sys.argv[sys.argv.index("--gate") + 1])
        return
    t_start = time.time()
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    ms = build_global(dev)
    if "--table" in sys.argv:
        for shape in WAVE_TRIDIAG:
            _check_tridiag_wave(shape, dev)
        t0 = time.time()
        phase_solo_table(dev, ms)
        log(f"[time] solo table: {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_solo_table_cpu(start_table_cpu())
        log(f"[time] solo table, the CPU's run: {time.time() - t0:.1f} s")
        log(f"[card] {card}")
        return
    results = phase_kernels(dev, ms)
    if "--kernels" in sys.argv:
        log(f"[card] {card}")
        log(json.dumps({"tree": TREE, "kernel_ms": TIMES}))
        return
    seconds = {"device, build and kernels": time.time() - t_start}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    timed("fold", phase_fold_exact, dev)
    counts = {"double_gyre": timed("double_gyre", phase_slice, dev)}
    counts.update(timed("full_physics", phase_full_physics, dev))
    counts["global_half_deg"] = timed("global_half_deg", phase_global, dev,
                                      ms)
    counts["solo_global_half_deg"] = timed("solo global_half_deg",
                                           phase_solo_global, dev, ms)
    counts.update(timed("solo table", phase_solo_table, dev, ms))
    counts.update(timed("obc", phase_obc, dev))
    del ms
    torch.cuda.empty_cache()
    # the gates' processes run beside the checks that follow (nothing after
    # this point is timed for a report but the gates themselves)
    pool = start_gates()
    table_cpu = start_table_cpu()
    try:
        timed("f64", phase_f64, dev)
        timed("golden", phase_golden, dev)
        counts["tracer_batch"] = timed("tracer_batch", phase_tracer_batch,
                                       dev)
        timed("solo runs", phase_solo_runs, dev)
        counts["physics"] = timed("physics (the rest of the gates' time)",
                                  phase_physics, pool)
        timed("solo table, the CPU's run (the rest of its time)",
              phase_solo_table_cpu, table_cpu)
    finally:
        stop_gates(pool)
        if table_cpu[1][0].poll() is None:
            table_cpu[1][0].kill()
            table_cpu[1][0].communicate()
    seconds["all"] = time.time() - t_start
    log("[time] " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    rows = []
    for name in kernel_launches():
        src, rep = META[name]
        # launches: on this slice's path, global_half_deg (the wrap rows of
        # the y passes: on thermo_gyre, the last path that launches them);
        # every path's count, each read after its own reset, beside it
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=counts[ROW_PATH.get(
                             name, "global_half_deg")][name],
                         launches_by_path={p: c[name]
                                           for p, c in counts.items()},
                         **results[name]))
    log(f"[card] {card}")
    log(json.dumps({"kernels": rows}))
    if any(not math.isfinite(r["ms"]) for r in rows):
        raise AssertionError("kernel time not measured")
    if any(r["launches"] <= 0 for r in rows):
        raise AssertionError("a kernel was launched no time on its path")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
