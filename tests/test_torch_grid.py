"""Parity of the port's constructors (grid, vertical grid, resting state, the
double-gyre experiment) and of interop.py with the JAX reference.

They compute in float64 numpy and cast once, as the reference
does, so their outputs must be bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mom6_tpu.core.state import init_state_resting as ref_init_state
from mom6_tpu.drivers.experiments import double_gyre as ref_double_gyre
from mom6_tpu.grid.grid import _face_masks as ref_face_masks
from mom6_tpu.grid.grid import build_cartesian_grid as ref_grid
from mom6_tpu.grid.vertical import build_layered_vgrid as ref_vgrid
from mom6_tpu_torch import interop
from mom6_tpu_torch.core.state import init_state_resting
from mom6_tpu_torch.drivers.experiments import double_gyre
from mom6_tpu_torch.framework.containers import tensor_fields
from mom6_tpu_torch.grid.grid import Grid, _face_masks, build_cartesian_grid
from mom6_tpu_torch.grid.vertical import build_layered_vgrid

torch.set_num_threads(1)


def _depth(ny, nx):
    d = np.full((ny, nx), 1000.0)
    d[:2, :] = 0.0
    d[:, :3] = 0.0
    d[ny // 2, nx // 2] = 50.0           # a shallow cell inside
    return d


def _assert_fields_equal(ref_obj, port_obj):
    for name, t in tensor_fields(port_obj).items():
        np.testing.assert_array_equal(np.asarray(getattr(ref_obj, name)),
                                      t.numpy(), err_msg=name)


@pytest.mark.parametrize("cyclic_x,reentrant_y", [(False, False),
                                                  (True, False),
                                                  (False, True),
                                                  (True, True)])
@pytest.mark.parametrize("land", [False, True])
def test_cartesian_grid_parity(cyclic_x, reentrant_y, land):
    kw = dict(depth=_depth(16, 20) if land else None, f0=1e-4, beta=2e-11,
              cyclic_x=cyclic_x, reentrant_y=reentrant_y,
              south_lat_km=-300.0)
    G_ref = ref_grid(20, 16, 800.0, 600.0, **kw)
    G = build_cartesian_grid(20, 16, 800.0, 600.0, device="cpu", **kw)
    assert (G.nx, G.ny, G.cyclic_x, G.reentrant_y) == \
        (20, 16, cyclic_x, reentrant_y)
    _assert_fields_equal(G_ref, G)
    # every field its own allocation
    ptrs = [t.data_ptr() for t in tensor_fields(G).values()]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("flags", [(False, False, True), (True, False, True),
                                   (True, True, False)])
def test_face_masks_parity(flags):
    mask = (_depth(12, 10) > 0).astype(np.float64)
    for a, b in zip(ref_face_masks(mask, *flags), _face_masks(mask, *flags)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nz", [1, 2, 8])
def test_layered_vgrid_parity(nz):
    GV_ref = ref_vgrid(nz, gprime_int=0.02)
    GV = build_layered_vgrid(nz, gprime_int=0.02, device="cpu")
    _assert_fields_equal(GV_ref, GV)
    assert (GV.g_earth, GV.rho0, GV.angstrom, GV.h_subroundoff) == \
        (GV_ref.g_earth, GV_ref.rho0, GV_ref.angstrom, GV_ref.h_subroundoff)


def test_init_state_resting_parity():
    """Clipped against bathymetry with land and a shallow cell; exact
    (an f32 cumsum over 3 values sums in the same order)."""
    prof = np.array([300.0, 400.0, 600.0])
    G_ref = ref_grid(20, 16, 800.0, 600.0, depth=_depth(16, 20))
    G = build_cartesian_grid(20, 16, 800.0, 600.0, depth=_depth(16, 20),
                             device="cpu")
    st_ref = ref_init_state(G_ref, ref_vgrid(3), prof, with_thermo=True)
    st = init_state_resting(G, build_layered_vgrid(3, device="cpu"), prof,
                            with_thermo=True)
    _assert_fields_equal(st_ref, st)
    ptrs = [t.data_ptr() for t in tensor_fields(st).values()]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("nx,ny,nz", [(24, 22, 2), (20, 18, 5)])
def test_double_gyre_construction_parity(nx, ny, nz):
    """The port builds the experiment itself; it equals the reference's
    build carried across with interop."""
    ref = ref_double_gyre(nx=nx, ny=ny, nz=nz)
    G, GV, st, p, f = double_gyre(nx=nx, ny=ny, nz=nz, device="cpu")
    G2, GV2, st2, p2, f2 = interop.load_all(*(interop.export(o)
                                              for o in ref), device="cpu")
    for a, b in ((G, G2), (GV, GV2), (st, st2), (f, f2)):
        for name, t in tensor_fields(b).items():
            assert torch.equal(getattr(a, name), t), name
    assert p == p2
    assert (p.bt.nstep, p.bt.nfilter) == (ref[3].bt.nstep, ref[3].bt.nfilter)


def test_interop_rejects_unported_data():
    ref = ref_double_gyre(nx=12, ny=10, nz=2)
    st = interop.export(ref[2].replace(sppt_pattern=jnp.zeros((10, 12))))
    with pytest.raises(NotImplementedError):
        interop.load_state(st, device="cpu")


def test_containers_move_and_cast():
    G = build_cartesian_grid(6, 5, 100.0, 100.0, f0=1e-4, device="cpu")
    G64 = G.to("cpu", torch.float64)
    assert isinstance(G64, Grid) and G64.nx == 6
    assert all(t.dtype == torch.float64 for t in tensor_fields(G64).values())
    assert G64.replace(nx=7).nx == 7
    assert dataclasses.is_dataclass(G64)


def test_compute_stats_and_stats_line_parity():
    """ocean.stats numbers of a perturbed thermo state: the same float64
    numpy arithmetic on the same values, so equal to the last bit."""
    from mom6_tpu.diagnostics import sum_output as ref_so
    from mom6_tpu_torch.diagnostics import sum_output as so
    prof = np.array([300.0, 400.0, 600.0])
    G_ref = ref_grid(20, 16, 800.0, 600.0, depth=_depth(16, 20))
    GV_ref = ref_vgrid(3)
    st_ref = ref_init_state(G_ref, GV_ref, prof, with_thermo=True)
    rng = np.random.default_rng(9)
    pert = {k: (np.asarray(getattr(st_ref, k))
                + rng.standard_normal((3, 16, 20))).astype(np.float32)
            for k in ("h", "u", "v", "T", "S")}
    st_ref = st_ref.replace(**{k: jnp.asarray(a) for k, a in pert.items()})
    G = interop.load_grid(interop.export(G_ref), device="cpu")
    GV = interop.load_vgrid(interop.export(GV_ref), device="cpu")
    st = interop.load_state(interop.export(st_ref), device="cpu")
    want = ref_so.compute_stats(st_ref, G_ref, GV_ref, 900.0)
    got = so.compute_stats(st, G, GV, 900.0)
    assert got == want
    full = dict(want, mass_drift=1.0, salt_drift=2.0, heat_drift=3.0,
                dye=4.0)
    assert so.format_stats_line(12, 0.5, full) == \
        ref_so.format_stats_line(12, 0.5, full)
