"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels [--tree DIR]

With ``--kernels`` only phases 1-3 run and the kernels' times are printed
as one JSON line; ``--tree DIR`` takes the port from another checkout
(say the parent commit, unpacked with ``git archive``), so that two
versions of a kernel are timed by one script on one card.

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels of mom6_tpu_torch/csrc with nvcc, one
   compiler per source, all started together; registers, spills and
   shared memory of the Thomas, the remap and the PPM edge kernels from
   ptxas (no spills allowed);
3. kernels: each kernel against its plain PyTorch version on the card, with
   the kernel's and the plain version's times and the card's bound for the
   same work: the Thomas solve and the PPM passes at the global path's
   (32, 400, 720), the thermo slice's (32, 280, 360), the double gyre's
   (8, 280, 360) and at (75, 270, 360); the Thomas solve as the vertical
   diffusion calls it (coefficients (32, 1, 400, 720) shared by the two
   right-hand sides of a transposed (2, 32, 400, 720) tensor); the ALE
   remap at (nf=2 and 1, 32, 400, 720), (nf=2 and 1, 32, 280, 360) and
   (nf=2, 75, 270, 360), from 32 to 40 layers, with five fields, and onto
   the source grid itself (every interface ties); the y passes across the
   tripolar fold on the half-degree global grid at (32, 400, 720) and on a
   polar cap at (7, 33, 45).  Every kernel must equal its plain version
   to the bit; each kernel's own device time (torch.profiler) is
   reported beside its time from an idle device;
4. the fold, exactly: a bump on the north pole of a polar cap without
   rotation stays mirror-symmetric to the bit over 10 steps;
5. float64, on the card with the kernels against the CPU with the plain
   versions: the split-RK2 double gyre at 24x22x2 for 3 steps, thermo_gyre
   at 16x14x6 for 2 thermo cycles, and one thermo cycle of a 32x24x5
   tripolar global model (configs/global_2deg's MOM_input on a generated
   mosaic, USE_KPP = False);
6. the adiabatic path: the double gyre at 360x280x8 through
   drivers.solo.run_segment for 20 steps in float32, with the launch count
   of every kernel, the ms per baroclinic step and a phase breakdown;
7. the thermo path: thermo_gyre at 360x280x32 through run_segment for 10
   thermo cycles (20 baroclinic steps) in float32, with the launch count of
   every kernel, conservation of mass and salt, the heat budget, the ms per
   thermo cycle, a profile of one cycle and a phase breakdown;
8. the global path: configs/global_half_deg/MOM_input with USE_KPP = False
   through drivers.config_driver.build_model_from_params (the 720x400
   mosaic generated in memory) and run_segment for 3 thermo cycles (18
   baroclinic steps) at 720x400x32 in float32: finite fields, mass drift,
   wet temperatures in range, land columns untouched, the launch count of
   every kernel with the fold launches apart, the ms per thermo cycle
   without and with stats, a profile of one cycle and a phase breakdown;
9. a JSON line of the kernels, then the result line.

Long output (the ptxas report, the profiler tables) goes to
chip_smoke_out/ beside this script.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# the checkout whose port is driven: this one, or --tree DIR
TREE = (os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
        if "--tree" in sys.argv else REPO)
sys.path.insert(0, TREE)

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
    make_mom_stepper, make_stepper, run_segment)
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
THERMO = dict(nx=360, ny=280, nz=32, len_lon_km=4500.0, len_lat_km=3500.0,
              dt=1200.0)
N_CYCLES, CYCLE_STATS = 10, 5
GLOBAL_DIR = os.path.join(REPO, "configs", "global_half_deg")
GLOBAL_SHAPE = (32, 400, 720)
N_GLOBAL_CYCLES = 3
# the small tripolar global model of the float64 check
SMALL_GLOBAL = ("NIGLOBAL = 32\nNJGLOBAL = 24\nNK = 5\nUSE_KPP = False\n"
                "TRACER_ADVECT_SUB = 3\n")
# kernel check shapes: the global path's and the thermo path's (both
# reported in the JSON line), the double gyre's, and a deep (OM4-like)
# column
KERNEL_SHAPES = (GLOBAL_SHAPE, (32, 280, 360), (8, 280, 360), (75, 270, 360))
# (nf, nz0, ny, nx) of the remap: T and S, then u or v, on the global and
# the thermo path; T and S of a deep column
REMAP_SHAPES = ((2, 32, 400, 720), (1, 32, 400, 720), (2, 32, 280, 360),
                (1, 32, 280, 360), (2, 75, 270, 360))
# more forms of the remap, (nf, nz0, ny, nx) and how the target grid is
# made: more target layers than source layers, five fields (two passes of
# the kernel), and a target grid equal to the source grid
REMAP_FORMS = (((2, 32, 400, 720), dict(nz1=40)),
               ((5, 32, 280, 360), {}),
               ((2, 32, 400, 720), dict(ties=True)))
# the Thomas solve as tracers/vert_diff.py calls it: (n_tr, nz, ny, nx)
SHARED_TRIDIAG = (2,) + GLOBAL_SHAPE
# the shape whose numbers a kernel's row of the JSON line carries: that
# of the path that launches it
ROW_SHAPE = {"ppm_edges_y": (32, 280, 360), "ppm_flux_y": (32, 280, 360)}
# ... and the path whose launch count it carries
ROW_PATH = {"ppm_edges_y": "thermo_gyre", "ppm_flux_y": "thermo_gyre"}
FOLD_CAP = dict(nx=45, ny_reg=20, ny_cap=13)       # an odd nx; (7, 33, 45)
# launches per baroclinic step of the double gyre, per thermo cycle of
# thermo_gyre (2 baroclinic steps, then 1 tracer column solve and 3 remaps)
# and per thermo cycle of the global path (6 baroclinic steps, whose y
# passes cross the fold)
PER_STEP = {"tridiag": 6, "ppm_edges_x": 3, "ppm_edges_y": 3,
            "ppm_flux_x": 9, "ppm_flux_y": 9, "ppm_edges_y_fold": 0,
            "ppm_flux_y_fold": 0, "remap": 0}
PER_CYCLE = {"tridiag": 13, "ppm_edges_x": 6, "ppm_edges_y": 6,
             "ppm_flux_x": 18, "ppm_flux_y": 18, "ppm_edges_y_fold": 0,
             "ppm_flux_y_fold": 0, "remap": 3}
PER_GLOBAL_CYCLE = {"tridiag": 37, "ppm_edges_x": 18, "ppm_edges_y": 0,
                    "ppm_flux_x": 54, "ppm_flux_y": 0,
                    "ppm_edges_y_fold": 18, "ppm_flux_y_fold": 54,
                    "remap": 3}
# name -> (wrapper, the attribute that counts these launches)
WRAPPERS = {"tridiag": (solvers.tridiag_solve, "launches"),
            "ppm_edges_x": (cppm.zonal_edges, "launches"),
            "ppm_edges_y": (cppm.merid_edges, "launches"),
            "ppm_flux_x": (cppm.zonal_flux, "launches"),
            "ppm_flux_y": (cppm.merid_flux, "launches"),
            "ppm_edges_y_fold": (cppm.merid_edges, "fold_launches"),
            "ppm_flux_y_fold": (cppm.merid_flux, "fold_launches"),
            "remap": (remap.remap_columns_multi, "launches")}
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


def _check_tridiag_shared(dev):
    """The Thomas solve as tracers/vert_diff.py calls it: coefficients
    (nz, 1, ny, nx) shared by the n_tr right-hand sides of the transposed
    view of an (n_tr, nz, ny, nx) tensor.  Its bound reads a, b, c once
    and reads and writes each right-hand side once: 3 + 2 n_tr passes."""
    n_tr, nz, ny, nx = SHARED_TRIDIAG
    n = nz * ny * nx
    a, b, c, _ = (t[:, None] for t in _tridiag_inputs((nz, ny, nx), 7, dev))
    rng = np.random.default_rng(8)
    d = torch.tensor(rng.standard_normal(SHARED_TRIDIAG),
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
        f"{n_tr} right-hand sides of a transposed {SHARED_TRIDIAG} tensor: "
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
    TIMES[f"tridiag shared {SHARED_TRIDIAG}"] = ms
    TIMES[f"tridiag shared {SHARED_TRIDIAG} device"] = d_ms


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
    for shape in KERNEL_SHAPES:
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
    _check_tridiag_shared(dev)
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


def _reset_counts():
    for w, attr in WRAPPERS.values():
        setattr(w, attr, 0)


def _read_counts():
    return {k: getattr(w, attr) for k, (w, attr) in WRAPPERS.items()}


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
    _reset_counts()
    torch.cuda.synchronize()
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=N_STEPS,
                               stats_interval=STATS_INTERVAL, verbose=True)
    counts = _read_counts()
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

    tr = torch.stack([st.T, st.S])
    uhtr, vhtr = st.uh * dt_therm, st.vh * dt_therm
    parts = {}
    if p.gm is not None:
        parts["thickness_diffuse (GM, neutral slopes)"] = lambda: \
            thickness_diffuse(st.h, G, GV, dt_therm, p.gm, T=st.T, S=st.S,
                              eos=eos)
    if p.khtr > 0.0:
        parts[f"tracer_hordiff (T, S; {p.khtr_n_sub} subcycle)"] = lambda: \
            tracer_hordiff(tr, st.h, p.khtr, dt_therm, G, n_sub=p.khtr_n_sub)
    parts.update({
        "step_mom (one thermo cycle)": lambda: step_mom(st, f, G, GV, p),
        "step_dynamics_split_rk2 (FV PF, friction)": lambda:
            step_dynamics_split_rk2(st, f.mech, G, GV, p.dyn, pf_fn=pf_fn,
                                    hv_fn=hv_fn),
        "pressure_force_fv": lambda: pf_fn(st.h, st),
        "horizontal_viscosity": lambda: hv_fn(st.u, st.v, st.h),
        f"advect_tracers (T, S; {p.tracer_advect_sub} sub-sweeps)": lambda:
            advect_tracers(tr, st.h, uhtr, vhtr, G,
                           n_sub=p.tracer_advect_sub),
        "diabatic_ale (1 tridiag)": lambda: diabatic_ale(
            st.T, st.S, st.h, f.buoy, dt_therm, G, GV, p.diabatic),
        "ale_regrid_remap (3 remaps)": lambda: ale_regrid_remap(
            st, G, GV, p.ale),
    })
    reps = 2 if G.nx * G.ny > 200000 else 5
    return {k: median_ms(fn, reps=reps, warm=1) for k, fn in parts.items()}


def phase_thermo(dev):
    """The thermo path at 360x280x32 through run_segment, counting
    launches per thermo cycle."""
    G, GV, st, p, f = thermo_gyre(**THERMO, dtype=torch.float32, device=dev)
    dt_therm = p.dyn.dt * p.n_dyn_per_thermo
    log(f"[thermo] thermo_gyre {G.nx}x{G.ny}x{GV.nz} dt={p.dyn.dt}, "
        f"{p.n_dyn_per_thermo} baroclinic steps per thermo cycle: bt nstep "
        f"{p.dyn.bt.nstep} nfilter {p.dyn.bt.nfilter}; ALE {p.ale.mode} "
        f"{p.ale.scheme}, EOS {p.eos_name}")
    s0 = compute_stats(st, G, GV, p.dyn.dt)
    _reset_counts()
    torch.cuda.synchronize()
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=N_CYCLES,
                               stats_interval=CYCLE_STATS, verbose=True)
    counts = _read_counts()
    log(f"[thermo] {N_CYCLES} thermo cycles in {elapsed:.3f} s with stats: "
        f"{1e3 * elapsed / N_CYCLES:.2f} ms/cycle; launches {counts}; per "
        f"cycle {({k: c / N_CYCLES for k, c in counts.items()})}")
    _check_counts(counts, PER_CYCLE, N_CYCLES, "thermo_gyre")
    for k in ("h", "u", "v", "T", "S"):
        if not bool(torch.isfinite(getattr(st1, k)).all()):
            raise AssertionError(f"non-finite {k}")
    s1 = compute_stats(st1, G, GV, p.dyn.dt)
    mass = abs(s1["mass"] - s0["mass"]) / s0["mass"]
    salt = abs(s1["salt"] - s0["salt"]) / s0["salt"]
    flux = float((f.buoy.heat_flux.double() * G.areaT.double()
                  * G.mask2dT.double()).sum()) * dt_therm * N_CYCLES
    log(f"[thermo] mass drift {mass:.3e} (tol 1e-6), salt drift {salt:.3e} "
        f"(tol 1e-5); heat change {s1['heat'] - s0['heat']:.6e} J against "
        f"the surface heat flux's {flux:.6e} J over the run (heat content "
        f"{s0['heat']:.6e} J); KE {s1['KE']:.6e} J, T in "
        f"[{float(st1.T.min()):.4f}, {float(st1.T.max()):.4f}], h min "
        f"{float(st1.h.min()):.4e}")
    if not mass < 1e-6:
        raise AssertionError(f"mass drift {mass}")
    if not salt < 1e-5:
        raise AssertionError(f"salt drift {salt}")
    if not s1["KE"] > 0.0:
        raise AssertionError("KE is not positive")

    # steady-state cycle time without the host-side stats
    stepper = make_mom_stepper(G, GV, p, f, cycles_per_call=CYCLE_STATS)
    with torch.inference_mode():
        stepper(st1)
        torch.cuda.synchronize()
        t0 = time.time()
        stepper(st1)
        torch.cuda.synchronize()
        ms_cycle = 1e3 * (time.time() - t0) / CYCLE_STATS
        log(f"[thermo] cycle time {ms_cycle:.3f} ms/thermo cycle "
            f"({CYCLE_STATS} cycles, host clock, synchronised, no stats)")
        one = make_mom_stepper(G, GV, p, f, cycles_per_call=1)
        dev_ms, n_kern, blocked = _profile(one, st1, "thermo_gyre")
        log(f"[thermo] profiler, one cycle: {n_kern} kernel launches, "
            f"{dev_ms:.3f} ms of device time; device idle "
            f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}% of the {ms_cycle:.3f} "
            f"ms cycle; host blocked on a full command buffer {blocked:.3f} "
            f"ms")
        for k, ms in _thermo_phase_times(G, GV, st1, p, f).items():
            log(f"[phase] {k}: {ms:.3f} ms")
    return counts


def build_global(dev):
    """configs/global_half_deg with USE_KPP = False, as a user would build
    it; the 720x400 mosaic is generated in memory."""
    t0 = time.time()
    ms = build_model_from_params(
        ParamFile([os.path.join(GLOBAL_DIR, "MOM_input")],
                  text="USE_KPP = False"), device=dev)
    G, p = ms.grid, ms.params
    wet = G.mask2dT > 0.5
    log(f"[global] built configs/global_half_deg + USE_KPP = False (the only "
        f"reduction) in {time.time() - t0:.1f} s: {G.nx}x{G.ny}x{ms.vgrid.nz}"
        f", fold_north {G.fold_north}, cyclic_x {G.cyclic_x}, ocean fraction "
        f"{float(G.mask2dT.mean()):.4f}, smallest wet cell "
        f"{float(G.dxT[wet].min()) / 1e3:.2f} x "
        f"{float(G.dyT[wet].min()) / 1e3:.2f} km; dt {p.dyn.dt}, "
        f"{p.n_dyn_per_thermo} baroclinic steps per thermo cycle, bt nstep "
        f"{p.dyn.bt.nstep} nfilter {p.dyn.bt.nfilter}, "
        f"{p.tracer_advect_sub} advection sub-sweeps, KHTH {p.gm.khth}, KHTR "
        f"{p.khtr} ({p.khtr_n_sub} subcycle), KH {p.hor_visc.kh}, EOS "
        f"{p.eos_name}, ALE {p.ale.mode} {p.ale.scheme}, restoring "
        f"{ms.forcing.buoy.restore_rate * 86400.0:.2f} m/day")
    if (G.nx, G.ny, ms.vgrid.nz) != GLOBAL_SHAPE[::-1] or not G.fold_north:
        raise AssertionError("not the half-degree tripolar grid")
    return ms


def phase_global(dev, ms):
    """The tripolar global path at 720x400x32 through run_segment."""
    G, GV, st, p, f = ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing
    n = N_GLOBAL_CYCLES
    s0 = compute_stats(st, G, GV, p.dyn.dt)
    land = G.mask2dT[None] < 0.5
    T_land = (st.T * land).clone()
    _reset_counts()
    torch.cuda.synchronize()
    st1, elapsed = run_segment(st, G, GV, p, f, n_steps=n, stats_interval=n,
                               verbose=True)
    counts = _read_counts()
    log(f"[global] {n} thermo cycles ({n * p.n_dyn_per_thermo} baroclinic "
        f"steps) in {elapsed:.3f} s with one stats line: "
        f"{1e3 * elapsed / n:.2f} ms/cycle; launches {counts}; per cycle "
        f"{({k: c / n for k, c in counts.items()})}")
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

    # steady-state cycle time without the host-side stats
    one = make_mom_stepper(G, GV, p, f, cycles_per_call=1)
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
            f"{1e3 * elapsed / n:.3f} ms/cycle with one stats line per {n} "
            f"cycles")
        dev_ms, n_kern, blocked = _profile(one, st1, "global_half_deg")
        log(f"[global] profiler, one cycle: {n_kern} kernel launches, "
            f"{dev_ms:.3f} ms of device time; device idle "
            f"{100.0 * (1.0 - dev_ms / ms_cycle):.1f}% of the {ms_cycle:.3f} "
            f"ms cycle; host blocked on a full command buffer {blocked:.3f} "
            f"ms")
        for k, t in _thermo_phase_times(G, GV, st1, p, f).items():
            log(f"[phase] global {k}: {t:.3f} ms")
    return counts


def main():
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    ms = build_global(dev)
    results = phase_kernels(dev, ms)
    if "--kernels" in sys.argv:
        log(f"[card] {card}")
        log(json.dumps({"tree": TREE, "kernel_ms": TIMES}))
        return
    phase_fold_exact(dev)
    phase_f64(dev)
    counts = {"double_gyre": phase_slice(dev),
              "thermo_gyre": phase_thermo(dev),
              "global_half_deg": phase_global(dev, ms)}
    rows = []
    for name in WRAPPERS:
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
