"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture) where
torch has no CUDA device.  Run on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q

The kernels perform the plain versions' operations in the same order
(nvcc --fmad=false), so float32 and float64 results are expected to be
bitwise equal; the PPM flux's assertions allow 1e-6 (f32) and 1e-13
(f64) of the field's max-abs for a division the card's libraries might
round apart, those of the Thomas solve, the remap and the PPM edges
demand equality, at the systems PPM_IH4 and JHL's kappa_shear make too.
The catalog's post on the small tripolar model is held card against CPU
in float64.  The remap at PPM_H6's and P3M_H4's coefficients and
init_tracer_from_z's remap from 102 levels are bitwise; HYBGEN, the SSA
solve and the ice-only driver run on the card, held against the CPU in
float64.  The y edges' HALO form (the tile of a mesh rank) equals its
plain version.
"""

import functools

import numpy as np
import pytest
import torch

from mom6_tpu_torch.ale import remapping as R
from mom6_tpu_torch.core import continuity_ppm as cppm
from mom6_tpu_torch.core.dynamics_split_rk2 import (MechForcing,
                                                    step_dynamics_split_rk2)
from mom6_tpu_torch.core.mom import step_mom
from mom6_tpu_torch.drivers.config_driver import build_model_from_params
from mom6_tpu_torch.drivers.experiments import (double_gyre, polar_cap_bump,
                                                thermo_gyre)
from mom6_tpu_torch.framework import solvers
from mom6_tpu_torch.framework.config import ParamFile
from mom6_tpu_torch.framework.stencil import ip1, jp1
from mom6_tpu_torch.grid.tripolar import write_mosaic

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(8, 28, 36), (75, 9, 13)])
def test_tridiag_kernel_matches_plain(cuda, dtype, shape):
    rng = np.random.default_rng(0)
    a = -rng.uniform(0, 1, shape)
    c = -rng.uniform(0, 1, shape)
    b = 2.0 + rng.uniform(0, 1, shape)
    d = rng.standard_normal(shape)
    a, b, c, d = (torch.tensor(x, dtype=dtype, device=cuda)
                  for x in (a, b, c, d))
    n0 = solvers.tridiag_solve.launches
    x = solvers.tridiag_solve(a, b, c, d)
    assert solvers.tridiag_solve.launches == n0 + 1
    assert _rel(x, solvers.tridiag_solve_plain(a, b, c, d)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [1, 2, 32, 75, 130])
@pytest.mark.parametrize("form", ["full", "shared", "shared transposed",
                                  "five tracers"])
def test_tridiag_kernel_forms_are_bitwise(cuda, dtype, nz, form):
    """Depths from 1 to 130 (at 130 a block's cp and dp exceed 48 KB of
    shared memory), an odd plane (partial blocks), coefficients of d's
    shape and coefficients shared by 2 or 5 right-hand sides (5: more than
    one pass carries), d contiguous or the transposed view the vertical
    diffusion passes: 0 ulps against the plain version, one launch, no
    scratch tensor and no copy of an operand."""
    ny, nx = 9, 37
    n_tr = {"full": 0, "five tracers": 5}.get(form, 2)
    rng = np.random.default_rng(nz)
    cshape = (nz, ny, nx) if form == "full" else (nz, 1, ny, nx)
    a = -rng.uniform(0, 1, cshape)
    c = -rng.uniform(0, 1, cshape)
    b = 2.0 + rng.uniform(0, 1, cshape)
    t = lambda v: torch.tensor(v, dtype=dtype, device=cuda)
    a, b, c = t(a), t(b), t(c)
    if form == "full":
        d = t(rng.standard_normal((nz, ny, nx)))
    elif form == "shared":
        d = t(rng.standard_normal((nz, n_tr, ny, nx)))
    else:
        d = t(rng.standard_normal((n_tr, nz, ny, nx))).transpose(0, 1)
    want = solvers.tridiag_solve_plain(a, b, c, d)
    solvers.tridiag_solve(a, b, c, d)                # builds the library
    torch.cuda.synchronize()
    n0 = solvers.tridiag_solve.launches
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    x = solvers.tridiag_solve(a, b, c, d)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    assert solvers.tridiag_solve.launches == n0 + 1
    assert x.shape == d.shape
    if nz > 1:                          # laid out as d is
        assert x.stride() == want.stride()
    assert torch.equal(x, want)
    # x and nothing else (the allocator rounds a block up to 512 bytes)
    assert extra <= x.numel() * x.element_size() + 512


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tridiag_kernel_per_tracer_vertdiff(cuda, dtype):
    """tracer_vertdiff with per-tracer diffusivities (double diffusion):
    one launch of the unshared instance over the tracers' columns, equal
    to the bit to the plain version on the CPU's tensors and to one solve
    per tracer."""
    from mom6_tpu_torch.tracers.vert_diff import tracer_vertdiff
    rng = np.random.default_rng(3)
    n_tr, nz, ny, nx = 3, 12, 9, 37
    h = 1.0 + 50.0 * rng.uniform(0, 1, (nz, ny, nx))
    h[-2:, :3] = 1e-10
    tr = rng.standard_normal((n_tr, nz, ny, nx))
    kd = 10.0 ** rng.uniform(-6, -1, (n_tr, nz + 1, ny, nx))
    flux = 1e-5 * rng.standard_normal((n_tr, ny, nx))
    t = lambda v, dev: torch.tensor(v, dtype=dtype, device=dev)
    n0 = solvers.tridiag_solve.launches
    x = tracer_vertdiff(t(tr, cuda), t(h, cuda), t(kd, cuda), 1800.0,
                        sfc_flux=t(flux, cuda))
    assert solvers.tridiag_solve.launches == n0 + 1
    want = tracer_vertdiff(t(tr, "cpu"), t(h, "cpu"), t(kd, "cpu"), 1800.0,
                           sfc_flux=t(flux, "cpu"))
    assert torch.equal(x.cpu(), want)
    for i in range(n_tr):
        one = tracer_vertdiff(t(tr[i:i + 1], cuda), t(h, cuda),
                              t(kd[i], cuda), 1800.0,
                              sfc_flux=t(flux[i:i + 1], cuda))
        assert torch.equal(x[i], one[0])


def _captured(module, fn):
    """The (a, b, c, d) of every tridiag_solve ``fn()`` makes through
    ``module``'s name for it."""
    seen, orig = [], module.tridiag_solve

    def record(a, b, c, d):
        seen.append((a, b, c, d))
        return orig(a, b, c, d)
    module.tridiag_solve = record
    try:
        fn()
    finally:
        module.tridiag_solve = orig
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("system", ["PPM_IH4", "kappa_shear"])
def test_tridiag_kernel_on_captured_systems(cuda, dtype, system):
    """The systems of PPM_IH4's compact edge values ((nz+1, ny, nx), a
    unit diagonal, the boundary rows pinned) and of JHL's kappa and TKE
    equations ((nz-1, ny, nx), inside kappa_shear's nested loops), made by
    the modules on tc2's built state under a seeded flow: 0 ulps against
    the plain version."""
    from mom6_tpu_torch.ale import remapping
    from mom6_tpu_torch.eos import get_eos
    from mom6_tpu_torch.physics.vertical import kappa_shear as ks
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ms = build_model_from_params(ParamFile([os.path.join(
        repo, "configs", "tc2", "MOM_input")]), dtype=dtype, device=cuda)
    G, st = ms.grid, ms.state
    rng = np.random.default_rng(3)
    t = lambda v: torch.tensor(v, dtype=dtype, device=cuda)
    st = st.replace(u=t(0.3 * rng.standard_normal(tuple(st.u.shape)))
                    * G.mask2dCu,
                    v=t(0.3 * rng.standard_normal(tuple(st.v.shape)))
                    * G.mask2dCv)
    if system == "PPM_IH4":
        seen = _captured(remapping, lambda: remapping.reconstruct(
            st.T, st.h, "PPM_IH4"))
        nz = st.h.shape[0] + 1
        assert all(bool((b == 1.0).all()) for _, b, _, _ in seen)
    else:
        seen = _captured(ks, lambda: ks.kappa_shear(
            st.h, st.u, st.v, st.T, st.S, G, ms.vgrid, get_eos("WRIGHT")))
        nz = st.h.shape[0] - 1
    assert seen and all(d.shape[0] == nz for _, _, _, d in seen)
    for a, b, c, d in seen:
        assert torch.equal(solvers.tridiag_solve(a, b, c, d),
                           solvers.tridiag_solve_plain(a, b, c, d))


def test_tridiag_kernel_refuses_a_depth_beyond_shared_memory(cuda):
    """cp and dp of 40,000 levels do not fit an SM: the launch is refused
    and the wrapper raises, it does not fall back."""
    d = torch.ones((40000, 3), device=cuda)
    with pytest.raises(RuntimeError, match="tridiag_solve"):
        solvers.tridiag_solve(d, 3.0 * d, d, d)
    # and the card is still usable
    e = torch.ones((4, 3), device=cuda)
    assert torch.equal(solvers.tridiag_solve(e, 3.0 * e, e, e),
                       solvers.tridiag_solve_plain(e, 3.0 * e, e, e))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("direction", ["x", "y"])
@pytest.mark.parametrize("variant", ["pos", "cw84", "simple2nd"])
def test_ppm_kernels_match_plain(cuda, dtype, direction, variant):
    G, _, _, p, _ = double_gyre(nx=36, ny=28, nz=4, dtype=dtype,
                                device=cuda)
    rng = np.random.default_rng(1)
    t = lambda x: torch.tensor(x, dtype=dtype, device=cuda)
    h = t(np.maximum(500.0 + 30 * rng.standard_normal((4, 28, 36)), 1e-10))
    u = t(0.3 * rng.standard_normal((4, 28, 36)))
    dw = t(0.05 * rng.standard_normal((28, 36)))
    rem = t(rng.uniform(0.2, 1.0, (4, 28, 36)))
    mono, s2 = variant == "cw84", variant == "simple2nd"
    if direction == "x":
        edges, flux, d = cppm.zonal_edges, cppm.zonal_flux, 0
        face, d_p = G.dyCu * G.mask2dCu, p.dt * G.IdxT
        d_m = p.dt * torch.roll(G.IdxT, -1, -1)
    else:
        edges, flux, d = cppm.merid_edges, cppm.merid_flux, 1
        face, d_p = G.dxCv * G.mask2dCv, p.dt * G.IdyT
        d_m = p.dt * torch.roll(G.IdyT, -1, -2)
    hl, hr = edges(h, G.mask2dT, 1e-10, mono, s2)
    pl, pr = cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono, s2, d)
    assert torch.equal(hl, pl) and torch.equal(hr, pr)
    for kw in ({}, dict(dw=dw, rem=rem)):
        got = flux(h, hl, hr, face, d_p, d_m, u, **kw)
        want = cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, u,
                                   kw.get("dw"), kw.get("rem"), d)
        assert max(_rel(got[0], want[0]), _rel(got[1], want[1])) \
            <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("direction", ["x", "y", "y_fold"])
def test_ppm_flux_per_layer_face_matches_plain(cuda, dtype, direction):
    """The flux kernel's instance with a face of each layer's own (nz, ny,
    nx), the porous barriers' open fractions times the face width, equals
    the plain version bitwise, with and without the Newton terms; the
    plane instance is unchanged beside it."""
    fold = direction == "y_fold"
    if fold:
        G, _, _, p, _ = polar_cap_bump(37, 6, 5, dtype=dtype, device=cuda)
    else:
        G, _, _, p, _ = double_gyre(nx=36, ny=28, nz=4, dtype=dtype,
                                    device=cuda)
    nz, ny, nx = 4, G.ny, G.nx
    rng = np.random.default_rng(7)
    t = lambda x: torch.tensor(x, dtype=dtype, device=cuda)
    h = t(np.maximum(500.0 + 30 * rng.standard_normal((nz, ny, nx)), 1e-10))
    u = t(0.3 * rng.standard_normal((nz, ny, nx)))
    por = t(rng.uniform(0.0, 1.0, (nz, ny, nx)))
    dw = t(0.05 * rng.standard_normal((ny, nx)))
    rem = t(rng.uniform(0.2, 1.0, (nz, ny, nx)))
    if direction == "x":
        edges, flux, d = cppm.zonal_edges, cppm.zonal_flux, 0
        face, d_p = G.dyCu * G.mask2dCu, p.dt * G.IdxT
        d_m = p.dt * torch.roll(G.IdxT, -1, -1)
        hl, hr = edges(h, G.mask2dT, 1e-10)
    else:
        edges, d = cppm.merid_edges, 1
        flux = functools.partial(cppm.merid_flux, fold=fold)
        face, d_p = G.dxCv * G.mask2dCv, p.dt * G.IdyT
        d_m = p.dt * jp1(G.IdyT, "h" if fold else None)
        hl, hr = edges(h, G.mask2dT, 1e-10, fold=fold)
    face3 = (face * por).contiguous()
    for f in (face3, face):
        for kw in ({}, dict(dw=dw, rem=rem)):
            got = flux(h, hl, hr, f, d_p, d_m, u, **kw)
            want = cppm.ppm_flux_plain(h, hl, hr, f, d_p, d_m, u,
                                       kw.get("dw"), kw.get("rem"), d,
                                       fold=fold)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant", ["pos", "cw84", "simple2nd"])
@pytest.mark.parametrize("nx", [8, 37, 48])
def test_ppm_fold_kernels_match_plain(cuda, dtype, variant, nx):
    """The y passes across the tripolar fold on a polar cap with land at
    the bipolar poles: an even nx, an odd nx (the halfway column maps to
    itself) and nx = 8; fold launches are counted apart."""
    G, _, _, p, _ = polar_cap_bump(nx, 6, 5, dtype=dtype, device=cuda)
    nz, ny = 3, G.ny
    rng = np.random.default_rng(3)
    t = lambda x: torch.tensor(x, dtype=dtype, device=cuda)
    h = np.maximum(300.0 + 30 * rng.standard_normal((nz, ny, nx)), 1e-10)
    h[-1, -3:, : nx // 3] = 1e-10
    h, v = t(h), t(0.3 * rng.standard_normal((nz, ny, nx)))
    dw = t(0.05 * rng.standard_normal((ny, nx)))
    rem = t(rng.uniform(0.2, 1.0, (nz, ny, nx)))
    mono, s2 = variant == "cw84", variant == "simple2nd"
    face, d_p = G.dxCv * G.mask2dCv, p.dt * G.IdyT
    d_m = p.dt * jp1(G.IdyT, "h")
    n_e, n_f = cppm.merid_edges.fold_launches, cppm.merid_flux.fold_launches
    w_e, w_f = cppm.merid_edges.launches, cppm.merid_flux.launches
    hl, hr = cppm.merid_edges(h, G.mask2dT, 1e-10, mono, s2, fold=True)
    want_l, want_r = cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono, s2, 1,
                                          fold=True)
    assert torch.equal(hl, want_l) and torch.equal(hr, want_r)
    # and the fold differs from the wrap where it should: the top row
    _, wrap_r = cppm.ppm_edges_plain(h, G.mask2dT, 1e-10, mono, s2, 1)
    assert not torch.equal(wrap_r[:, -1], want_r[:, -1])
    for kw in ({}, dict(dw=dw, rem=rem)):
        got = cppm.merid_flux(h, hl, hr, face, d_p, d_m, v, fold=True, **kw)
        want = cppm.ppm_flux_plain(h, hl, hr, face, d_p, d_m, v,
                                   kw.get("dw"), kw.get("rem"), 1, fold=True)
        assert max(_rel(got[0], want[0]), _rel(got[1], want[1])) \
            <= TOL[dtype]
    assert cppm.merid_edges.fold_launches == n_e + 1
    assert cppm.merid_flux.fold_launches == n_f + 2
    assert (cppm.merid_edges.launches, cppm.merid_flux.launches) == (w_e, w_f)


# (nz, ny, nx) of the edge kernel's tiles (x: 128 cells of a row; y: 32
# columns by 16 rows): smaller than a tile, nz = 1, ny = 2 and 3, sizes
# that are not multiples of a tile, ny a multiple of it (the fold image
# of the top row is the last slope of a tile), and a plane large enough
# that a block walks several layers (x 8, y 4 on an H100) with a partial
# last chunk
EDGE_SHAPES = [(1, 5, 7), (3, 33, 130), (2, 2, 3), (4, 3, 200),
               (2, 64, 33), (5, 70, 257), (25, 1000, 1000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geometry", ["x", "y wrap", "y fold"])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_ppm_edges_kernel_tiles_are_bitwise(cuda, dtype, geometry, shape):
    """Every limiter at 0 ulps against the plain version on the card: a
    smooth field with noise, cells at the 1e-10 floor, signed zeros, land
    (on the fold line too); one launch a call, counted where it belongs."""
    nz, ny, nx = shape
    rng = np.random.default_rng(nz * ny + nx)
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    h = 500.0 + 100.0 * np.sin(0.7 * j + 0.45 * i
                               + rng.uniform(0, 6.3, (nz, 1, 1)))
    h = h + 3.0 * rng.standard_normal(shape)
    h[rng.uniform(0, 1, shape) < 0.1] = 1e-10
    h[rng.uniform(0, 1, shape) < 0.05] = 0.0
    h[rng.uniform(0, 1, shape) < 0.05] = -0.0
    m = (rng.uniform(0, 1, (ny, nx)) >= 0.2).astype(float)
    m[-1, nx // 2] = 0.0
    h, m = (torch.tensor(a, dtype=dtype, device=cuda) for a in (h, m))
    d, fold = (0, False) if geometry == "x" else (1, geometry == "y fold")
    wrapper = cppm.zonal_edges if d == 0 else cppm.merid_edges
    counter = "fold_launches" if fold else "launches"
    for mono, s2 in ((False, False), (True, False), (False, True)):
        n0 = getattr(wrapper, counter)
        got = (cppm.zonal_edges(h, m, 1e-10, mono, s2) if d == 0 else
               cppm.merid_edges(h, m, 1e-10, mono, s2, fold))
        assert getattr(wrapper, counter) == n0 + 1
        want = cppm.ppm_edges_plain(h, m, 1e-10, mono, s2, d, fold)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ppm_edges_kernel_refuses_too_many_layers(cuda):
    """More layers than the grid's y dimension takes (65,535) are refused
    before any launch and the wrappers raise, they do not fall back; the
    card stays usable."""
    h = torch.ones((65536, 2, 3), device=cuda)
    m = torch.ones((2, 3), device=cuda)
    with pytest.raises(RuntimeError, match="zonal_edges"):
        cppm.zonal_edges(h, m, 1e-10)
    with pytest.raises(RuntimeError, match="merid_edges"):
        cppm.merid_edges(h, m, 1e-10, fold=True)
    e = h[:4] * torch.arange(1.0, 4.0, device=cuda)
    got = cppm.merid_edges(e, m, 1e-10, fold=True)
    want = cppm.ppm_edges_plain(e, m, 1e-10, False, False, 1, fold=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fold_kernels_reject_the_x_direction(cuda):
    h = torch.ones((2, 8, 8), device=cuda)
    m = torch.ones((8, 8), device=cuda)
    with pytest.raises(RuntimeError):
        cppm._edges_launch("zonal_edges", h, m, 1e-10, False, False, 0,
                           fold=True)


def test_polar_cap_mirror_symmetry_on_the_card(cuda):
    """Without rotation the bump's evolution across the fold stays
    mirror-symmetric to the bit with the CUDA kernels too."""
    G, GV, s, p, _ = polar_cap_bump(48, 12, 10, device=cuda)
    with torch.inference_mode():
        for _ in range(10):
            s = step_dynamics_split_rk2(s, MechForcing(), G, GV, p)
    eta = (s.h.double().sum(0) - G.bathyT.double()) * G.mask2dT
    assert bool(torch.isfinite(eta).all())
    assert float((eta - eta.flip(-1)).abs().max()) == 0.0


def test_double_gyre_f64_card_matches_cpu(cuda):
    """Three steps with the kernels on the card against the plain
    versions on the CPU, to 1e-10 relative."""
    out = {}
    for dev in ("cpu", cuda):
        G, GV, st, p, f = double_gyre(nx=24, ny=22, nz=2,
                                      dtype=torch.float64, device=dev)
        with torch.inference_mode():
            for _ in range(3):
                st = step_dynamics_split_rk2(st, f, G, GV, p)
        out[str(dev)] = st
    for k in ("h", "u", "v"):
        assert _rel(getattr(out[str(cuda)], k),
                    getattr(out["cpu"], k)) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", [R.PPM_H4, R.PLM])
@pytest.mark.parametrize("shape", [(2, 10, 14, 9, 17), (1, 7, 5, 3, 130),
                                   (5, 32, 32, 11, 37)])
def test_remap_kernel_matches_plain(cuda, dtype, scheme, shape):
    """(nf, nz0, nz1, ny, nx): vanished source layers, odd plane sizes,
    more fields than the kernel takes in one pass; against the plain
    version on the card and the CPU path."""
    nf, nz0, nz1, ny, nx = shape
    rng = np.random.default_rng(2)
    h0 = 20.0 + 10.0 * rng.uniform(0, 1, (nz0, ny, nx))
    h0[2] = 1e-10
    h0[nz0 - 1, : ny // 2] = 1e-10
    w = 0.5 + rng.uniform(0, 1, (nz1, ny, nx))
    h1 = w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)
    f = rng.standard_normal((nf, nz0, ny, nx))
    f, h0, h1 = (torch.tensor(x, dtype=dtype, device=cuda)
                 for x in (f, h0, h1))
    n0 = R.remap_columns_multi.launches
    got = R.remap_columns_multi(f, h0, h1, scheme)
    assert R.remap_columns_multi.launches == n0 + 1
    coef, lo, hi = R.remap_coefficients(f, h0, scheme)
    assert _rel(got, R.remap_integrals_plain(coef, h0, h1, lo, hi)) \
        <= TOL[dtype]
    assert _rel(got, R.remap_columns_multi(f.cpu(), h0.cpu(), h1.cpu(),
                                           scheme)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["ties", "nz1 != nz0", "five fields",
                                  "npoly 5", "one layer", "two layers",
                                  "75 layers", "130 layers", "empty top"])
def test_remap_kernel_forms_are_bitwise(cuda, dtype, case):
    """The remap launch at 0 ulps against the plain version on an odd
    plane (partial blocks): a target grid equal to the source grid (every
    interface ties), more and fewer target layers than source layers, five
    fields (two passes), five coefficients a cell, and depths from 1 to
    130 (at 130 a block's sums exceed 48 KB of shared memory), and a
    first interface that several cells cut and none covers; vanished
    layers in each."""
    nf, nz0, nz1, npoly = {
        "ties": (2, 32, 32, 3), "nz1 != nz0": (2, 20, 33, 3),
        "five fields": (5, 32, 17, 3), "npoly 5": (3, 16, 16, 5),
        "one layer": (2, 1, 1, 3), "two layers": (2, 2, 2, 3),
        "75 layers": (2, 75, 75, 3), "130 layers": (5, 130, 130, 3),
        "empty top": (2, 6, 7, 3)}[case]
    ny, nx = 7, 53
    rng = np.random.default_rng(nz0)
    h0 = 20.0 + 10.0 * rng.uniform(0, 1, (nz0, ny, nx))
    h0[nz0 - 1, ny // 2:] = 1e-10
    if nz0 > 2:
        h0[nz0 // 3, : ny // 2] = 1e-10
    if case == "ties":
        h1 = h0.copy()
    else:
        w = 0.5 + rng.uniform(0, 1, (nz1, ny, nx))
        if nz1 > 2:
            w[nz1 // 2, :, : nx // 3] = 0.0
        h1 = w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)
    if case == "empty top":
        # no source layer covers the first interface whole, three cut it
        h0[:2] = 0.0
        h1[0] = 1e-35
    f = rng.standard_normal((nf, nz0, ny, nx))
    f, h0, h1 = (torch.tensor(v, dtype=dtype, device=cuda)
                 for v in (f, h0, h1))
    coef, lo, hi = R.remap_coefficients(f, h0, R.PPM_H4)
    if npoly == 5:
        coef = torch.tensor(rng.standard_normal((nf, 5, nz0, ny, nx)),
                            dtype=dtype, device=cuda)
    got = R._remap_launch(coef, h0, h1, lo, hi)
    torch.cuda.synchronize()
    assert torch.equal(got, R.remap_integrals_plain(coef, h0, h1, lo, hi))
    assert torch.equal(got, R.remap_integrals_cellwise(coef, h0, h1, lo, hi))


def test_remap_kernel_refuses_a_depth_beyond_shared_memory(cuda):
    """The running sums of 30,000 target layers do not fit an SM: the
    launch is refused and the wrapper raises, it does not fall back."""
    f = torch.ones((1, 4, 2, 3), device=cuda)
    h0 = torch.ones((4, 2, 3), device=cuda)
    h1 = torch.full((30000, 2, 3), 4.0 / 30000, device=cuda)
    with pytest.raises(RuntimeError, match="remap_columns_multi"):
        R.remap_columns_multi(f, h0, h1, R.PCM)
    out = R.remap_columns_multi(f, h0, h0, R.PCM)
    assert torch.equal(out, f)


def _flowing(st, G):
    """A 0.5 m/s flow and a T anomaly on thermo_gyre's state: from rest,
    u and v after two cycles sit near the round-off floor of the
    pressure force's column integrals."""
    nz, ny, nx = st.h.shape
    y = torch.linspace(0, 1, ny, dtype=st.h.dtype, device=st.h.device)
    x = torch.linspace(0, 1, nx, dtype=st.h.dtype, device=st.h.device)
    decay = torch.exp(-torch.arange(nz, dtype=st.h.dtype,
                                    device=st.h.device) / 4.0)[:, None, None]
    return st.replace(
        T=st.T + decay * torch.outer(torch.sin(torch.pi * y),
                                     torch.cos(2 * torch.pi * x)) * G.mask2dT,
        u=0.5 * decay * torch.cos(torch.pi * y)[:, None] * G.mask2dCu,
        v=0.5 * decay * torch.sin(2 * torch.pi * x)[None, :] * G.mask2dCv)


def test_thermo_gyre_f64_card_matches_cpu(cuda):
    """Two thermo cycles from a flowing state with the kernels on the card
    against the plain versions on the CPU, to 1e-10 relative."""
    out = {}
    for dev in ("cpu", cuda):
        G, GV, st, p, f = thermo_gyre(16, 14, 6, dtype=torch.float64,
                                      device=dev)
        st = _flowing(st, G)
        with torch.inference_mode():
            for _ in range(2):
                st = step_mom(st, f, G, GV, p)
        out[str(dev)] = st
    for k in ("h", "u", "v", "T", "S"):
        assert _rel(getattr(out[str(cuda)], k),
                    getattr(out["cpu"], k)) <= 1e-10


SMALL_GLOBAL = ("NIGLOBAL = 32\nNJGLOBAL = 24\nNK = 5\nUSE_KPP = False\n"
                "TRACER_ADVECT_SUB = 3\n")


def test_small_global_f64_card_matches_cpu(cuda, tmp_path):
    """One thermo cycle of the small tripolar global model
    (configs/global_2deg's MOM_input on a generated 32x24x5 mosaic) from a
    flowing state with the kernels on the card against the plain versions
    on the CPU, to 1e-10 relative; the y passes take the fold branch.  T
    and S are compared in layers that hold water and u and v on faces that
    do (more than 1 mm): the pressure force divides by the face thickness,
    so in the vanished layers over topography (1e-10 m) a velocity is
    round-off amplified by 1e10, and the card's exp and log round apart
    from the CPU's.  Those velocities carry no transport: h agrees
    everywhere."""
    import os
    import shutil
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    write_mosaic(str(tmp_path), nx=32, ny_reg=16, ny_cap=8)
    shutil.copy(os.path.join(repo, "configs", "global_2deg", "MOM_input"),
                tmp_path / "MOM_input")
    out = {}
    n0 = cppm.merid_flux.fold_launches
    for dev in ("cpu", cuda):
        ms = build_model_from_params(
            ParamFile([str(tmp_path / "MOM_input")], text=SMALL_GLOBAL),
            dtype=torch.float64, device=dev)
        st = _flowing(ms.state, ms.grid)
        with torch.inference_mode():
            st = step_mom(st, ms.forcing, ms.grid, ms.vgrid, ms.params)
        out[str(dev)] = st
    assert cppm.merid_flux.fold_launches > n0
    h = out["cpu"].h
    wet = {"T": h > 1e-3, "S": h > 1e-3,
           "u": 0.5 * (h + ip1(h)) > 1e-3,
           "v": 0.5 * (h + jp1(h, "h")) > 1e-3}
    for k in ("h", "u", "v", "T", "S"):
        a, b = getattr(out[str(cuda)], k).cpu(), getattr(out["cpu"], k)
        if k in wet:
            a, b = a * wet[k], b * wet[k]
        assert _rel(a, b) <= 1e-10, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_arith_helpers_card_equals_cpu(cuda, dtype):
    """vsum, sdiv and rdiv give the CPU's results to the bit on the card,
    where torch.sum keeps four partial sums and ``tensor / number``
    multiplies by the reciprocal."""
    from mom6_tpu_torch.framework.arith import rdiv, sdiv, vsum
    rng = np.random.default_rng(0)
    for nz in (1, 8, 20, 33):
        x = torch.tensor(rng.standard_normal((nz, 40, 45))
                         * np.logspace(-6, 6, nz)[:, None, None],
                         dtype=dtype)
        assert torch.equal(vsum(x.to(cuda)).cpu(), vsum(x))
    t = torch.tensor(rng.uniform(0.1, 1e3, 4096), dtype=dtype)
    assert torch.equal(sdiv(t.to(cuda), 3600.0).cpu(), sdiv(t, 3600.0))
    assert torch.equal(rdiv(0.45, t.to(cuda)).cpu(), rdiv(0.45, t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpow_stays_on_the_card(cuda, dtype):
    """cpow of a card tensor is torch.pow on the card: no copy to the
    host, and the card's result within the CUDA maths library's stated
    pow error (2 ulps in float64, 4 in float32) of the CPU's."""
    from mom6_tpu_torch.framework.arith import cpow
    t = torch.tensor(np.random.default_rng(4).uniform(1e-6, 4.0, 4096),
                     dtype=dtype)
    for y in (0.5, 1.0 / 6.0, -1.33):
        got = cpow(t.to(cuda), y)
        assert got.device == t.to(cuda).device
        assert torch.equal(got, torch.pow(t.to(cuda), y))
        want = cpow(t, y)
        ulps = 4.0 * torch.finfo(dtype).eps * want.abs()
        assert bool(((got.cpu() - want).abs() <= ulps).all())


def test_catalog_post_f64_card_matches_cpu(cuda, tmp_path):
    """One post of configs/global_2deg's diag_table on the small tripolar
    model (KPP on), float64, from a cycle of a flowing state: every
    catalog field it asks for, the KE budget's split step and the
    tendencies' thermo cycle included, on the card against the CPU within
    1e-10 of max-abs (layers and faces that hold water), and wave_speed's
    Thomas solves at (nz-1, ny, nx) launched on the card."""
    import os
    import shutil
    from mom6_tpu_torch.diagnostics.catalog import (CATALOG, DiagContext,
                                                    serve)
    from mom6_tpu_torch.drivers import solo
    from mom6_tpu_torch.drivers.solo import _base_name
    from mom6_tpu_torch.eos import get_eos
    from mom6_tpu_torch.framework.diag_mediator import parse_diag_table
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    write_mosaic(str(tmp_path), nx=32, ny_reg=16, ny_cap=8)
    shutil.copy(os.path.join(repo, "configs", "global_2deg", "MOM_input"),
                tmp_path / "MOM_input")
    table = parse_diag_table(os.path.join(repo, "configs", "global_2deg",
                                          "diag_table"))
    names = sorted({_base_name(f[1]) for f in table.fields})
    text = SMALL_GLOBAL.replace("USE_KPP = False\n", "") \
        + "ALE_RESOLUTION = 20.0, 80.0, 300.0, 1100.0, 2500.0\n"
    out = {}
    for dev in ("cpu", cuda):
        ms = build_model_from_params(
            ParamFile([str(tmp_path / "MOM_input")], text=text),
            dtype=torch.float64, device=dev)
        G, GV, p, f = ms.grid, ms.vgrid, ms.params, ms.forcing
        n0 = solvers.tridiag_solve.launches
        with torch.inference_mode():
            st = step_mom(_flowing(ms.state, G), f, G, GV, p)
            ctx = DiagContext(st, G, GV, p, forcing=f,
                              eos=get_eos(p.eos_name),
                              ke_budget_fn=solo.make_ke_budget_fn(G, GV, p),
                              tend_fn=solo.make_tend_fn(G, GV, p))
            n1 = solvers.tridiag_solve.launches
            _ = ctx.cg1
            if str(dev) != "cpu":
                assert solvers.tridiag_solve.launches - n1 == 10
            out[str(dev)] = {k: serve(k, ctx) for k in names}
        assert n0 <= n1
    h = out["cpu"]["h"]
    wet = {"h": h > 1e-3, "u": 0.5 * (h + ip1(h)) > 1e-3,
           "v": 0.5 * (h + jp1(h, "h")) > 1e-3}
    wet["q"] = wet["u"] & wet["v"]
    for k in names:
        a, b = out[str(cuda)][k], out["cpu"][k]
        assert (a is None) == (b is None), k
        if b is None:
            continue
        a = a.cpu()
        if b.shape == h.shape:
            m = wet.get(CATALOG[k].stagger, wet["h"])
            a, b = a * m, b * m
        assert _rel(a, b) <= 1e-10, k


def test_threefry_streams_card_equal_cpu(cuda):
    """The port's threefry on the card: keys, splits, fold_in, the 32- and
    64-bit words and the uniforms equal the CPU's (which equal JAX's,
    tests/test_torch_stoch_tides.py) to the bit; the normals within a few
    ulps (the card's logarithm on erfinv's large branch); three float64
    AR(1) steps of a pattern within 1e-10 of max-abs."""
    from mom6_tpu_torch.framework import random as R
    from mom6_tpu_torch.physics.stochastic import SPPTParams, ar1_pattern
    for seed in (0, 7, 2 ** 31 - 1):
        kc, kd = R.PRNGKey(seed), R.PRNGKey(seed, device=cuda)
        assert torch.equal(R.split(kd).cpu(), R.split(kc))
        assert torch.equal(R.fold_in(kd, 5).cpu(), R.fold_in(kc, 5))
        for width in (32, 64):
            assert torch.equal(R.bits(kd, (40, 72), width).cpu(),
                               R.bits(kc, (40, 72), width))
        for dtype, iv, ulps in ((torch.float32, torch.int32, 4),
                                (torch.float64, torch.int64, 4)):
            assert torch.equal(R.uniform(kd, (40, 72), dtype).cpu(),
                               R.uniform(kc, (40, 72), dtype))
            a = R.normal(kd, (40, 72), dtype).cpu().view(iv).long()
            b = R.normal(kc, (40, 72), dtype).view(iv).long()
            assert int((a - b).abs().max()) <= ulps
    p = SPPTParams()
    pats = {}
    for dev in ("cpu", cuda):
        pat = torch.zeros((40, 72), dtype=torch.float64, device=dev)
        key = R.PRNGKey(3, device=dev)
        for _ in range(3):
            pat, key = ar1_pattern(pat, key, 3600.0, p)
        pats[str(dev)] = (pat.cpu(), key.cpu())
    (a, ka), (b, kb) = pats["cpu"], pats[str(cuda)]
    assert torch.equal(ka, kb) and _rel(b, a) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", ["PPM_H6", "P3M_H4"])
def test_new_remap_schemes_kernel_equals_plain(cuda, dtype, scheme):
    """The remap kernel with PPM_H6's three and P3M_H4's five coefficients
    (its quartic instance, counted apart) against the plain version on
    the same coefficients, to the bit, vanished layers included."""
    rng = np.random.default_rng(23)
    nz0, nz1, ny, nx = 32, 28, 20, 24
    h0 = 100.0 * (1.0 + 0.4 * rng.uniform(-1, 1, (nz0, ny, nx)))
    h0[-4:, : ny // 3] = 1e-10
    w = 1.0 + 0.4 * rng.uniform(-1, 1, (nz1, ny, nx))
    h1 = w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)
    zc = np.cumsum(h0, 0) - 0.5 * h0
    f = np.stack([2.0 + 18.0 * np.exp(-zc / 700.0), 35.0 + 0 * zc])
    f = f + 0.1 * rng.standard_normal(f.shape)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    f, h0, h1 = t(f), t(h0), t(h1)
    coef, lo, hi = R.remap_coefficients(f, h0, scheme)
    assert coef.shape[1] == (5 if scheme == "P3M_H4" else 3)
    q0 = R.remap_columns_multi.quartic_launches
    got = R.remap_columns_multi(f, h0, h1, scheme)
    assert R.remap_columns_multi.quartic_launches - q0 == int(
        scheme == "P3M_H4")
    assert torch.equal(got, R.remap_integrals_plain(coef, h0, h1, lo, hi))


def test_z_init_card_equals_cpu(cuda):
    """init_tracer_from_z from WOA's 102 levels onto 32 layers with
    vanished ones: the card's kernel against the CPU's plain version, to
    the bit in float64 and float32."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import torch_gates
    from mom6_tpu_torch.grid.z_init import init_tracer_from_z
    rng = np.random.default_rng(29)
    z_edges = torch_gates.woa_z_edges()
    data = 20.0 - 0.004 * z_edges[:-1, None, None] + rng.standard_normal(
        (102, 12, 16))
    h = 4000.0 / 32 * (1.0 + 0.3 * rng.uniform(-1, 1, (32, 12, 16)))
    h[-3:, :4] = 1e-10
    for dtype in (torch.float64, torch.float32):
        out = [init_tracer_from_z(z_edges, data, torch.tensor(
            h, dtype=dtype, device=dev), None).cpu() for dev in ("cpu", cuda)]
        assert torch.equal(out[0], out[1]), dtype


def test_hybgen_card_equals_cpu(cuda):
    """build_hybgen_grid and hybgen_unmix in float64 on the card against
    the CPU: 1e-12 of max-abs (the CPU's powers are the C library's)."""
    from mom6_tpu_torch.ale.regridding import build_hybgen_grid, hybgen_unmix
    from mom6_tpu_torch.eos import get_eos
    from mom6_tpu_torch.grid.vertical import build_layered_vgrid
    rng = np.random.default_rng(31)
    nz = 20
    h = 150.0 * (1.0 + 0.3 * rng.uniform(-1, 1, (nz, 14, 18)))
    zc = np.cumsum(h, 0) - 0.5 * h
    T = 2.0 + 20.0 * np.exp(-zc / 600.0) + 0.3 * rng.standard_normal(h.shape)
    S = 34.6 + 0.5 * np.exp(-zc / 300.0)
    targets = np.linspace(1031.0, 1037.2, nz).tolist()
    dz0 = np.minimum(3.0 * 1.18 ** np.arange(nz), 450.0).tolist()
    out = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
        GV = build_layered_vgrid(nz, dtype=torch.float64, device=dev)
        eos = get_eos("WRIGHT")
        with torch.inference_mode():
            hn = build_hybgen_grid(t(h), t(T), t(S), GV, eos, targets, dz0)
            out[str(dev)] = (hn,) + hybgen_unmix(t(T), t(S), hn, GV, eos,
                                                 targets)
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert _rel(a, b) <= 1e-12


def test_ssa_and_ice_solo_on_the_card(cuda, tmp_path):
    """ssa_solve in float64 on the driver's wedge, card against CPU within
    1e-10 of the max speed (the CG's inner products sum in another order
    on each device); the ice-only driver on the card writes its files."""
    from mom6_tpu_torch.drivers import ice_solo
    from mom6_tpu_torch.grid.grid import build_cartesian_grid
    from mom6_tpu_torch.physics.ice_shelf_dynamics import SSAParams, ssa_solve
    y = (np.arange(64) + 0.5) / 64
    h = np.broadcast_to(((800.0 - 600.0 * y) * (y < 0.8))[:, None], (64, 8))
    out = {}
    for dev in ("cpu", cuda):
        G = build_cartesian_grid(8, 64, 8.0, 64.0, max_depth=1000.0,
                                 dtype=torch.float64, device=dev)
        with torch.inference_mode():
            out[str(dev)] = ssa_solve(torch.tensor(
                h, dtype=torch.float64, device=dev), G, SSAParams())
    speed = max(float(a.abs().max()) for a in out["cpu"])
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert float((a.cpu() - b).abs().max()) <= 1e-10 * speed
    (tmp_path / "MOM_input").write_text(
        "NIGLOBAL = 16\nNJGLOBAL = 16\nLENLON = 80.0\nLENLAT = 80.0\n"
        "DT = 43200.0\nDAYMAX = 2.0\n")
    ice_solo.main([str(tmp_path)])
    assert (tmp_path / "ice.stats").exists()
    assert (tmp_path / "ICE.res.nc").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant", ["pos", "cw84", "simple2nd"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("ny,nx", [(12, 16), (37, 45)])
def test_ppm_edges_halo_form_matches_plain(cuda, dtype, variant, fold, ny,
                                           nx):
    """The y edges' HALO form (the tile of a mesh rank: two caller-filled
    halo rows on each side, with ``fold`` a fifth row holding the fold
    image of the global top row) against ppm_edges_halo_plain: equal."""
    mono, s2 = variant == "cw84", variant == "simple2nd"
    rows = ny + 4 + int(fold)
    rng = np.random.default_rng(ny + nx)
    h = torch.tensor(0.5 + 50.0 * rng.uniform(size=(5, rows, nx)) ** 3,
                     dtype=dtype, device=cuda)
    mask = torch.tensor((rng.uniform(size=(rows, nx)) > 0.2).astype(float),
                        dtype=dtype, device=cuda)
    got = cppm._edges_halo_launch("halo", h, mask, ny, 1e-10, mono, s2,
                                  fold)
    want = cppm.ppm_edges_halo_plain(h, mask, 1e-10, mono, s2, fold)
    for g, w in zip(got, want):
        assert g.shape == (5, ny, nx)
        assert torch.equal(g, w)
