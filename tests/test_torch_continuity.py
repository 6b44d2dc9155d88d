"""Parity of the port's PPM continuity (mom6_tpu_torch/core/continuity_ppm.py)
with the JAX reference, on CPU where each pass runs its plain PyTorch
version: the edge reconstruction, the x and y passes with every limiter,
with and without the in-kernel Newton velocity u + dw*rem, the matched
(Newton) mass fluxes and the full split continuity.  The reference runs
both its XLA path and its Pallas kernels in interpret mode
(MOM6_TPU_CONTINUITY=pallas), as tests/test_pallas_continuity.py does.
Every case runs on a walled basin, a torus and a tripolar cap with land
at the bipolar poles, whose y pass crosses the northern fold (in the
reference through merid_ghosts(..., fold=True)).

Tolerance: f32 to 1e-5 of each field's max-abs.  The two packages do the
same operations in the same order, but their CPU kernels may contract
products into fused multiply-adds differently, and the Newton iterates
sum over k in different orders; a few f32 ulps of the largest value
cover both with margin.
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from mom6_tpu.core import continuity_ppm as rc  # noqa: E402
from mom6_tpu.grid.grid import build_cartesian_grid  # noqa: E402
from mom6_tpu.grid.vertical import build_layered_vgrid  # noqa: E402
from mom6_tpu_torch import interop  # noqa: E402
from mom6_tpu_torch.core import continuity_ppm as tc  # noqa: E402

torch.set_num_threads(1)

NZ, NY, NX = 3, 16, 24
DT = 900.0
TOL = 1e-5
VARIANTS = {"plain": {}, "monotonic": dict(monotonic=True),
            "simple2nd": dict(simple_2nd=True)}


def _grids():
    depth = np.full((NY, NX), 1000.0)
    depth[:2, :] = 0.0
    depth[:, :2] = 0.0
    out = {"walls": build_cartesian_grid(NX, NY, 2400.0, 1600.0,
                                         depth=depth, f0=1e-4),
           "torus": build_cartesian_grid(NX, NY, 2400.0, 1600.0,
                                         max_depth=1000.0, f0=1e-4,
                                         cyclic_x=True, reentrant_y=True)}
    from make_global_grid import make_tripolar_supergrid
    from mom6_tpu.grid.mosaic import build_grid_from_supergrid
    sg = make_tripolar_supergrid(NX, 10, 6, lat_s=30.0, lat_join=65.0,
                                 lon_bp=100.0)
    depth = np.full((16, NX), 1000.0)
    depth[10:13, :2] = depth[10:13, -1:] = 0.0       # land at the poles
    depth[10:13, NX // 2 - 1:NX // 2 + 1] = 0.0
    depth[-1, 5] = 0.0                               # and on the fold line
    out["fold"] = build_grid_from_supergrid(sg, depth, cyclic_x=True,
                                            fold_north=True)
    return out


@pytest.fixture(scope="module")
def grids():
    """{topo: (reference grid, port grid)}."""
    return {k: (G, interop.load_grid(interop.export(G), device="cpu"))
            for k, G in _grids().items()}


def _rand(G, seed):
    """Thickness with near-massless cells, velocities, Newton inputs."""
    rng = np.random.RandomState(seed)
    depth = np.asarray(G.bathyT)
    h = np.maximum(depth[None] / NZ + 30.0 * rng.randn(NZ, NY, NX), 1e-10)
    h[-1, : NY // 4] = 1e-10
    m = np.asarray(G.mask2dT)
    h = h * m[None] + 1e-10 * (1 - m[None])
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(h=f32(h), u=f32(0.3 * rng.randn(NZ, NY, NX)),
                v=f32(0.3 * rng.randn(NZ, NY, NX)),
                rem=f32(np.clip(rng.rand(NZ, NY, NX), 0.2, 1.0)),
                dw=f32(0.05 * rng.randn(NY, NX)))


def _ref_both(fn):
    """``fn`` under the reference's XLA path and its Pallas kernels."""
    old = os.environ.get("MOM6_TPU_CONTINUITY")
    try:
        os.environ["MOM6_TPU_CONTINUITY"] = "xla"
        a = fn()
        os.environ["MOM6_TPU_CONTINUITY"] = "pallas"
        b = fn()
    finally:
        if old is None:
            os.environ.pop("MOM6_TPU_CONTINUITY", None)
        else:
            os.environ["MOM6_TPU_CONTINUITY"] = old
    return a, b


def _close(refs, gots, tol=TOL):
    for x, y in zip(refs, gots):
        x = np.asarray(x, np.float64)
        y = y.double().numpy()
        scale = np.abs(x).max() + 1e-30
        err = np.abs(x - y).max() / scale
        assert err <= tol, f"max rel diff {err:.2e}"


T = torch.from_numpy
J = jnp.asarray


TOPOS = ["walls", "torus", "fold"]


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_edges_parity(grids, topo, variant):
    G_ref, G = grids[topo]
    x = _rand(G_ref, 1)
    kw = VARIANTS[variant]
    mono, s2 = kw.get("monotonic", False), kw.get("simple_2nd", False)
    fold = topo == "fold"
    _close(rc.ppm_reconstruction_x(J(x["h"]), G_ref.mask2dT, 1e-10, **kw),
           tc.zonal_edges(T(x["h"]), G.mask2dT, 1e-10, mono, s2))
    _close(rc.ppm_reconstruction_y(J(x["h"]), G_ref.mask2dT, 1e-10,
                                   fold=fold, **kw),
           tc.merid_edges(T(x["h"]), G.mask2dT, 1e-10, mono, s2, fold))


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_zonal_pass_parity(grids, topo, variant):
    G_ref, G = grids[topo]
    x = _rand(G_ref, 2)
    kw = VARIANTS[variant]
    (uh_a, _), (uh_b, _) = _ref_both(
        lambda: rc.zonal_mass_flux(J(x["u"]), J(x["h"]), DT, G_ref, **kw))
    uh, _ = tc.zonal_mass_flux(T(x["u"]), T(x["h"]), DT, G, **kw)
    _close([uh_a], [uh])
    _close([uh_b], [uh])


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_meridional_pass_parity(grids, topo, variant):
    G_ref, G = grids[topo]
    x = _rand(G_ref, 3)
    kw = VARIANTS[variant]
    (vh_a, _), (vh_b, _) = _ref_both(
        lambda: rc.meridional_mass_flux(J(x["v"]), J(x["h"]), DT, G_ref,
                                        **kw))
    vh, _ = tc.meridional_mass_flux(T(x["v"]), T(x["h"]), DT, G, **kw)
    _close([vh_a], [vh])
    _close([vh_b], [vh])


def test_fold_plain_versions_mirror_the_top_row(grids):
    """The fold-aware plain versions, held to the definition and not to
    the reference: on a field that is mirror-symmetric in x, the fold
    makes the top row its own j+1 neighbour, so the y edges of the top
    row equal those of the same field with its top row duplicated above
    it (a walled extension), and a fold grid refuses the x direction."""
    _, G = grids["fold"]
    rng = np.random.RandomState(4)
    half = 500.0 + 30.0 * rng.randn(NZ, NY, NX // 2)
    h = T(np.concatenate([half, half[:, :, ::-1]], axis=2).astype(
        np.float32))
    ones = torch.ones((NY, NX))
    h_S, h_N = tc.ppm_edges_plain(h, ones, 1e-10, False, False, tc._DIR_Y,
                                  fold=True)
    ext = torch.cat([h, h[:, -1:], h[:, -2:-1]], dim=1)
    e_S, e_N = tc.ppm_edges_plain(ext, torch.ones((NY + 2, NX)), 1e-10,
                                  False, False, tc._DIR_Y)
    # (rows 0 and 1 see the wrap of the south side, which differs)
    assert torch.equal(h_S[:, 2:], e_S[:, 2:NY])
    assert torch.equal(h_N[:, 2:], e_N[:, 2:NY])
    with pytest.raises(ValueError):
        tc.ppm_edges_plain(h, ones, 1e-10, False, False, tc._DIR_X,
                           fold=True)


@pytest.mark.parametrize("direction", ["x", "y"])
@pytest.mark.parametrize("topo", TOPOS)
def test_flux_at_newton_velocity_parity(grids, direction, topo):
    """The pass at w = u + dw*rem (formed inside the kernel) against the
    reference's flux evaluated at that velocity."""
    G_ref, G = grids[topo]
    x = _rand(G_ref, 5)
    if direction == "x":
        hl, hr = rc.ppm_reconstruction_x(J(x["h"]), G_ref.mask2dT, 1e-10)
        pre = rc._zonal_flux_prep(J(x["h"]), hl, hr, DT, G_ref)
        face, d_p = G.dyCu * G.mask2dCu, DT * G.IdxT
        d_m = DT * torch.roll(G.IdxT, -1, -1)
        edges, flux = tc.zonal_edges, tc.zonal_flux
    else:
        import functools
        from mom6_tpu_torch.framework.stencil import jp1
        fold = topo == "fold"
        hl, hr = rc.ppm_reconstruction_y(J(x["h"]), G_ref.mask2dT, 1e-10,
                                         fold=fold)
        pre = rc._merid_flux_prep(J(x["h"]), hl, hr, DT, G_ref, fold=fold)
        face, d_p = G.dxCv * G.mask2dCv, DT * G.IdyT
        d_m = DT * jp1(G.IdyT, "h" if fold else None)
        edges = functools.partial(tc.merid_edges, fold=fold)
        flux = functools.partial(tc.merid_flux, fold=fold)
    ref = rc._flux_eval_core(J(x["u"]) + J(x["dw"]) * J(x["rem"]), pre)
    h = T(x["h"])
    hl_t, hr_t = edges(h, G.mask2dT, 1e-10)
    got = flux(h, hl_t, hr_t, face, d_p, d_m, T(x["u"]), dw=T(x["dw"]),
               rem=T(x["rem"]))
    _close(ref, got)


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("direction", ["x", "y"])
def test_matched_newton_parity(grids, topo, direction):
    """The Newton flux adjustment to a target barotropic transport."""
    G_ref, G = grids[topo]
    x = _rand(G_ref, 6)
    if direction == "x":
        rfn, tfn, w, kbt = (rc.zonal_mass_flux, tc.zonal_mass_flux, "u",
                            "uhbt")
    else:
        rfn, tfn, w, kbt = (rc.meridional_mass_flux,
                            tc.meridional_mass_flux, "v", "vhbt")
    wh0, _ = rfn(J(x[w]), J(x["h"]), DT, G_ref)
    target = np.asarray(jnp.sum(wh0, axis=0)) * 1.1
    a, b = _ref_both(lambda: rfn(J(x[w]), J(x["h"]), DT, G_ref,
                                 visc_rem=J(x["rem"]), return_cor=True,
                                 **{kbt: J(target)}))
    got = tfn(T(x[w]), T(x["h"]), DT, G, visc_rem=T(x["rem"]),
              return_cor=True, **{kbt: T(target)})
    _close(a, got)
    _close(b, got)


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("x_first", [True, False])
@pytest.mark.parametrize("matched", [False, True])
def test_full_continuity_parity(grids, topo, x_first, matched):
    G_ref, G = grids[topo]
    GV_ref = build_layered_vgrid(NZ, gprime_int=0.01)
    GV = interop.load_vgrid(interop.export(GV_ref), device="cpu")
    x = _rand(G_ref, 7)
    kw_r, kw_t = {}, {}
    if matched:
        _, uh0, vh0, _, _ = rc.continuity_ppm(J(x["u"]), J(x["v"]),
                                              J(x["h"]), DT, G_ref, GV_ref)
        uhbt = np.asarray(jnp.sum(uh0, axis=0)) * 0.9
        vhbt = np.asarray(jnp.sum(vh0, axis=0)) * 1.1
        kw_r = dict(uhbt=J(uhbt), vhbt=J(vhbt), visc_rem_u=J(x["rem"]),
                    visc_rem_v=J(x["rem"]))
        kw_t = dict(uhbt=T(uhbt), vhbt=T(vhbt), visc_rem_u=T(x["rem"]),
                    visc_rem_v=T(x["rem"]))
    a, b = _ref_both(lambda: rc.continuity_ppm(
        J(x["u"]), J(x["v"]), J(x["h"]), DT, G_ref, GV_ref,
        x_first=x_first, return_cor=True, **kw_r))
    got = tc.continuity_ppm(T(x["u"]), T(x["v"]), T(x["h"]), DT, G, GV,
                            x_first=x_first, return_cor=True, **kw_t)
    _close(a, got)
    _close(b, got)
    if topo == "walls":
        # finite-volume: the closed basin keeps its volume
        area = G.areaT.double()
        m0 = float((T(x["h"]).double() * area).sum())
        m1 = float((got[0].double() * area).sum())
        assert abs(m1 - m0) <= 5e-6 * m0


# The edge kernel's order (ppm_edges_padded: each slope once over a padded
# array, the fold image's slope negated in its own orientation) against
# ppm_edges_plain, to the bit: (direction, fold) and (monotonic,
# simple_2nd) by name
GEOMETRIES = {"x": (tc._DIR_X, False), "y wrap": (tc._DIR_Y, False),
              "y fold": (tc._DIR_Y, True)}
LIMITERS = {"pos": (False, False), "cw84": (True, False),
            "simple2nd": (False, True)}
# (nz, ny, nx): even and odd nx (under the fold the halfway column maps to
# itself), nx = 8, ny = 2 and 3, a single column
ORDER_SHAPES = [(3, 16, 24), (2, 7, 9), (2, 2, 8), (2, 3, 8), (1, 5, 1)]


def _edge_inputs(shape, rng, dtype, land=0.2, floor=0.1, zeros=0.1):
    """h around 500 m, smooth with some noise (so that the monotonic
    limiter leaves many cells as they are), with a share of cells at the
    1e-10 floor and of exact zeros of either sign, the top row at the floor
    on a third of the columns; a 0/1 mask with land on the fold line."""
    nz, ny, nx = shape
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, (nz, 1, 1))
    h = 500.0 + 100.0 * np.sin(0.7 * j + 0.45 * i + phase) \
        + 3.0 * rng.standard_normal(shape)
    h[rng.uniform(0, 1, shape) < floor] = 1e-10
    h[rng.uniform(0, 1, shape) < zeros] = 0.0
    h[rng.uniform(0, 1, shape) < zeros] = -0.0
    h[:, -1, : max(1, nx // 3)] = 1e-10
    m = (rng.uniform(0, 1, (ny, nx)) >= land).astype(float)
    m[-1, nx // 2] = 0.0
    return torch.tensor(h, dtype=dtype), torch.tensor(m, dtype=dtype)


def _order_is_bitwise(h, m, geometry, limiter):
    d, fold = GEOMETRIES[geometry]
    mono, s2 = LIMITERS[limiter]
    want = tc.ppm_edges_plain(h, m, 1e-10, mono, s2, d, fold)
    got = tc.ppm_edges_padded(h, m, 1e-10, mono, s2, d, fold)
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("limiter", list(LIMITERS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_edges_in_the_kernels_order_are_bitwise(geometry, limiter, dtype):
    """The CUDA edge kernel's order equals the plain version to the bit:
    land at the fold, h at the 1e-10 floor, signed zeros, and the shapes
    of ORDER_SHAPES, where the fold's two special slopes (the negated
    image of the top row, and the top row seen as cell -1 of row 0) meet
    in one tile at ny = 2 and 3."""
    rng = np.random.default_rng(11)
    for shape in ORDER_SHAPES:
        h, m = _edge_inputs(shape, rng, dtype)
        assert _order_is_bitwise(h, m, geometry, limiter), shape


def test_edges_order_differs_without_the_fold_slopes():
    """The fold's special slopes matter: the wrap's order on the fold
    differs from the fold's plain version on the top rows."""
    rng = np.random.default_rng(12)
    h, m = _edge_inputs((2, 7, 9), rng, torch.float64, land=0.0)
    want = tc.ppm_edges_plain(h, m, 1e-10, False, False, tc._DIR_Y, True)
    wrap = tc.ppm_edges_padded(h, m, 1e-10, False, False, tc._DIR_Y, False)
    assert not torch.equal(want[1][:, -1], wrap[1][:, -1])
    assert not torch.equal(want[0][:, 0], wrap[0][:, 0])


@settings(max_examples=40, deadline=None, derandomize=True)
@given(nz=st.integers(1, 3), ny=st.integers(2, 11), nx=st.integers(1, 11),
       seed=st.integers(0, 2**31 - 1), land=st.floats(0.0, 0.6),
       zeros=st.floats(0.0, 0.5),
       geometry=st.sampled_from(list(GEOMETRIES)),
       limiter=st.sampled_from(list(LIMITERS)), f64=st.booleans())
def test_edges_order_is_bitwise_on_random_fields(nz, ny, nx, seed, land,
                                                 zeros, geometry, limiter,
                                                 f64):
    rng = np.random.default_rng(seed)
    h, m = _edge_inputs((nz, ny, nx), rng,
                        torch.float64 if f64 else torch.float32, land=land,
                        zeros=zeros)
    assert _order_is_bitwise(h, m, geometry, limiter)


def test_kernel_wrappers_have_no_fallback_for_other_devices():
    h = torch.empty((2, 4, 5), device="meta")
    m = torch.empty((4, 5), device="meta")
    with pytest.raises(TypeError):
        tc.zonal_edges(h, m, 1e-10)
    with pytest.raises(TypeError):
        tc.merid_flux(h, h, h, m, m, m, h)
