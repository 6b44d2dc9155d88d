"""Parity of the port's ALE layer (mom6_tpu_torch/ale) with the JAX
reference: the column reconstructions, the remap's plain version against
the reference's scan path and against its Pallas kernel in interpret mode,
conservation and bounds, the z* grid and one regrid/remap cycle; and the
order in which the CUDA kernel forms the remap's sums, stated in plain
PyTorch and in numpy scalars, bitwise against the plain version.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs on the CPU, where ``remap_columns_multi`` takes its scan
path.  float32 tolerance 2e-6 of the field's magnitude (the reference's own
Pallas-vs-scan gate in tests/test_remap_pallas.py): the port sums in the
scan's order, but the two frameworks' CPU kernels may round a cumulative
sum or a division differently.  The float64 comparison runs in the x64
subprocess of tests/test_torch_x64.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from mom6_tpu.ale import remapping as R
from mom6_tpu.ale.ale import ale_regrid_remap as ref_ale_regrid_remap
from mom6_tpu.ale.regridding import build_zstar_grid as ref_zstar
from mom6_tpu.ale.regridding import uniform_dz_profile as ref_uniform_dz
from mom6_tpu.ale.remap_pallas import remap_columns_pallas
from mom6_tpu.drivers.experiments import thermo_gyre as ref_thermo_gyre
from mom6_tpu_torch import interop
from mom6_tpu_torch.ale import remapping as TR
from mom6_tpu_torch.ale.ale import ALEParams, ale_regrid_remap
from mom6_tpu_torch.ale.regridding import (build_zstar_grid,
                                           uniform_dz_profile)
from test_torch_hybgen_ice import reference_p3m_mean_kept

torch.set_num_threads(1)

TOL32 = 2e-6
SCHEMES = [R.PCM, R.PLM, R.PPM_H4]


def _problem(nz0=10, nz1=14, ny=9, nx=17, nf=3, seed=0, vanished=False,
             dtype=np.float32):
    """tests/test_remap_pallas.py's problem: random thicknesses, the
    target grid rescaled to the same column sums, random fields."""
    rng = np.random.RandomState(seed)
    h0 = 20.0 + 10.0 * rng.rand(nz0, ny, nx).astype(dtype)
    if vanished:
        h0[2] = 1e-10
        h0[7, : ny // 2] = 1e-10
    w = 0.5 + rng.rand(nz1, ny, nx).astype(dtype)
    h1 = (w / w.sum(0, keepdims=True) * h0.sum(0, keepdims=True)).astype(
        dtype)
    fields = rng.randn(nf, nz0, ny, nx).astype(dtype)
    return fields, h0, h1


def _close(got, want, tol=TOL32):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("scheme", SCHEMES)
def test_reconstruct_parity(scheme):
    f, h0, _ = _problem(vanished=True, seed=4)
    ref = R.reconstruct(jnp.asarray(f[0]), jnp.asarray(h0), scheme)
    got = TR.reconstruct(torch.from_numpy(f[0]), torch.from_numpy(h0), scheme)
    assert len(got) == 3
    for p in range(3):
        _close(got[p], ref[p])
    for p in range(3, 5):       # the reference's last two are zero here
        assert not np.asarray(ref[p]).any()


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", ["plain", "vanished", "odd"])
def test_remap_plain_matches_scan(scheme, case):
    kw = {"plain": {}, "vanished": dict(vanished=True, seed=1),
          "odd": dict(nz0=7, nz1=5, ny=5, nx=13, nf=2, seed=2)}[case]
    f, h0, h1 = _problem(**kw)
    want = R.remap_columns_multi(jnp.asarray(f), jnp.asarray(h0),
                                 jnp.asarray(h1), scheme)
    before = TR.remap_columns_multi.launches
    got = TR.remap_columns_multi(*(torch.from_numpy(a) for a in (f, h0, h1)),
                                 scheme)
    assert TR.remap_columns_multi.launches == before   # plain on the CPU
    _close(got, want)


@pytest.mark.parametrize("scheme", [R.PLM, R.PPM_H4])
def test_remap_plain_matches_pallas_interpret(scheme):
    """Against the TPU kernel itself in interpret mode, at the reference's
    own Pallas-vs-scan tolerance (its eps 1e-10 against the scan's 1e-30
    and its running target interfaces differ below that)."""
    f, h0, h1 = _problem(ny=5, nx=13, nf=2, seed=2, vanished=True)
    fj, h0j, h1j = (jnp.asarray(a) for a in (f, h0, h1))
    recon = [R.reconstruct(fj[i], h0j, scheme) for i in range(f.shape[0])]
    scale = (1.0, 0.5, 1.0 / 3.0)
    coef = jnp.stack([jnp.stack([scale[p] * r[p] for p in range(3)])
                      for r in recon])
    want = remap_columns_pallas(coef, h0j, h1j, jnp.min(fj, 1),
                                jnp.max(fj, 1), npoly=3, interpret=True)
    got = TR.remap_columns_multi(*(torch.from_numpy(a) for a in (f, h0, h1)),
                                 scheme)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def _cellwise_case(case, dtype):
    """(coef, h0, h1, lo, hi) as tensors of ``dtype``: PPM_H4 coefficients
    of random fields ("npoly5": five random coefficients a cell)."""
    kw = {"plain": dict(nz0=12, nz1=12), "npoly5": dict(nz0=12, nz1=12),
          "vanished": dict(vanished=True, seed=1),
          "odd": dict(nz0=7, nz1=5, ny=5, nx=13, nf=2, seed=2),
          "ties": dict(nz0=12, nz1=12, vanished=True, seed=3),
          "nz1 != nz0": dict(nz0=6, nz1=19, nf=5, seed=4),
          "empty top": dict(nz0=6, nz1=7, seed=5)}[case]
    f, h0, h1 = _problem(dtype=np.float64, **kw)
    if case == "ties":                  # the regrid left every column as is
        h1 = h0.copy()
    if case == "empty top":
        # two source layers of no thickness above a target layer thinner
        # than the floor of 1e-30: each of the three cells below the
        # surface cuts the first interface, none covers it whole
        h0[:2] = 0.0
        h1[0] = 1e-35
    f, h0, h1 = (torch.tensor(a, dtype=dtype) for a in (f, h0, h1))
    coef, lo, hi = TR.remap_coefficients(f, h0, TR.PPM_H4)
    if case == "npoly5":
        rng = np.random.RandomState(6)
        coef = torch.tensor(rng.randn(f.shape[0], 5, *h0.shape), dtype=dtype)
    return coef, h0, h1, lo, hi


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["plain", "vanished", "odd", "ties",
                                  "nz1 != nz0", "npoly5", "empty top"])
def test_remap_cellwise_order_is_bitwise_plain(case, dtype):
    """The kernel's order (no term above the cell, the whole cell without
    a division below it, the division where the interface cuts it) gives
    the plain version's result to the bit."""
    args = _cellwise_case(case, dtype)
    want = TR.remap_integrals_plain(*args)
    assert torch.equal(TR.remap_integrals_cellwise(*args), want)
    assert np.array_equal(_kernel_walk(*args), want.numpy())
    if case == "ties":
        # ... and where nothing moved, the clipped input means come back
        # to the round-off of the differences of the running sums
        coef, h0, _, lo, hi = args
        u0 = coef[:, 0] + coef[:, 1] + coef[:, 2]
        thick = (h0 > 1.0)[None]
        assert float(((want - u0) * thick).abs().max()) <= (
            1e-4 if dtype == torch.float32 else 1e-12)


def _kernel_walk(coef, h0, h1, lo, hi):
    """The loop of csrc/remap.cu, one column at a time in numpy scalars of
    the inputs' type: the source cells outside, the running sum S of the
    whole cells, and the two marks t_first (interfaces above it lie at or
    above the cell's top) and t_whole (interfaces from it on were covered
    whole by every cell so far and have no sum of their own yet)."""
    coef, h0, h1, lo, hi = (a.numpy() for a in (coef, h0, h1, lo, hi))
    ft = h0.dtype.type
    nf, npoly, nz0 = coef.shape[:3]
    nz1, plane = h1.shape[0], h0.shape[1:]
    coef, h0, h1 = (a.reshape(a.shape[:a.ndim - len(plane)] + (-1,))
                    for a in (coef, h0, h1))
    lo, hi = lo.reshape(nf, -1), hi.reshape(nf, -1)
    out = np.empty((nf, nz1, h0.shape[1]), h0.dtype)
    eps, zero, one = ft(1e-30), ft(0), ft(1)

    def horner(c, xi):
        poly = c[npoly - 1]
        for p in range(npoly - 2, -1, -1):
            poly = c[p] + xi * poly
        return poly

    for i in range(h0.shape[1]):
        col = zero
        for k in range(nz0):
            col = col + h0[k, i]
        z1, zsum = [], zero
        for t in range(nz1 + 1):
            if t > 0:
                zsum = zsum + h1[t - 1, i]
            z1.append(min(zsum, col))
        acc = [[None] * (nz1 + 1) for _ in range(nf)]
        S = [zero] * nf
        z0, t_first, t_whole = zero, 0, 0
        for k in range(nz0):
            h0_k = h0[k, i]
            hk = max(h0_k, eps)
            c = coef[:, :, k, i]
            whole = [h0_k * horner(c[q], one) for q in range(nf)]
            while t_first < t_whole and z1[t_first] - z0 <= zero:
                t_first += 1
            for t in range(t_first, t_whole):
                d = z1[t] - z0
                if d <= zero:
                    continue
                if d >= hk:
                    for q in range(nf):
                        acc[q][t] = acc[q][t] + whole[q]
                else:
                    xi = min(max(d / hk, zero), one)
                    for q in range(nf):
                        acc[q][t] = acc[q][t] + h0_k * (xi * horner(c[q], xi))
            while t_whole <= nz1:
                d = z1[t_whole] - z0
                if d >= hk:
                    break
                xi = min(max(d / hk, zero), one)
                for q in range(nf):
                    acc[q][t_whole] = S[q] if d <= zero else \
                        S[q] + h0_k * (xi * horner(c[q], xi))
                t_whole += 1
            S = [S[q] + whole[q] for q in range(nf)]
            z0 = z0 + h0_k
        for t in range(t_whole, nz1 + 1):
            for q in range(nf):
                acc[q][t] = S[q]
        for t in range(nz1):
            ht = max(h1[t, i], eps)
            for q in range(nf):
                u = (acc[q][t + 1] - acc[q][t]) / ht
                out[q, t, i] = min(max(u, lo[q, i]), hi[q, i])
    return out.reshape((nf, nz1) + plane)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(nz0=st.integers(1, 9), nz1=st.integers(1, 9),
       seed=st.integers(0, 2**31 - 1),
       vanished=st.floats(0.0, 0.8), ties=st.booleans(),
       scale=st.sampled_from([1.0, 1.0 - 1e-6, 1.0 + 1e-6, 0.5]),
       f64=st.booleans())
def test_remap_kernel_order_is_bitwise_plain_on_random_stacks(
        nz0, nz1, seed, vanished, ties, scale, f64):
    """Random column stacks in which a share of the source and target
    layers has vanished (1e-10 m or 0), target grids that tie with the
    source's interfaces, and target columns a little deeper or shallower
    than the source's: the kernel's order equals the plain version to the
    bit, in the vectorised form and in the kernel's own loop."""
    rng = np.random.default_rng(seed)
    ncol, nf = 12, 2
    dtype = torch.float64 if f64 else torch.float32
    h0 = 5.0 + 50.0 * rng.uniform(0, 1, (nz0, ncol))
    h0[rng.uniform(0, 1, h0.shape) < vanished] = 1e-10
    if ties:
        h1 = np.concatenate([h0, h0])[:nz1] if nz1 > nz0 else h0[:nz1].copy()
    else:
        w = rng.uniform(0, 1, (nz1, ncol))
        w[rng.uniform(0, 1, w.shape) < vanished] = rng.choice([0.0, 1e-12])
        h1 = w / np.maximum(w.sum(0), 1e-30) * h0.sum(0)
    h1 = h1 * scale
    f = rng.standard_normal((nf, nz0, ncol))
    f, h0, h1 = (torch.tensor(a, dtype=dtype) for a in (f, h0, h1))
    coef, lo, hi = TR.remap_coefficients(f, h0, TR.PPM_H4)
    want = TR.remap_integrals_plain(coef, h0, h1, lo, hi)
    assert torch.equal(TR.remap_integrals_cellwise(coef, h0, h1, lo, hi),
                       want)
    assert np.array_equal(_kernel_walk(coef, h0, h1, lo, hi), want.numpy())


def test_remap_conserves_and_bounds_with_vanished_layers():
    """As the reference's gate for its kernel: column integrals kept to
    float32 round-off of the cumulative sums, outputs inside the source
    column's range."""
    f, h0, h1 = _problem(vanished=True, seed=1)
    out = TR.remap_columns_multi(*(torch.from_numpy(a) for a in (f, h0, h1)),
                                 TR.PLM).double().numpy()
    assert np.isfinite(out).all()
    f64, h064, h164 = (a.astype(np.float64) for a in (f, h0, h1))
    np.testing.assert_allclose((out * h164[None]).sum(1),
                               (f64 * h064[None]).sum(1), rtol=5e-5,
                               atol=1e-3)
    assert (out >= f64.min(1, keepdims=True) - 1e-5).all()
    assert (out <= f64.max(1, keepdims=True) + 1e-5).all()


def test_remap_column_is_one_field_of_multi():
    f, h0, h1 = _problem(nf=1, seed=5)
    t = [torch.from_numpy(a) for a in (f, h0, h1)]
    assert torch.equal(TR.remap_column(t[0][0], t[1], t[2]),
                       TR.remap_columns_multi(*t)[0])


def test_remap_kernel_wrapper_has_no_fallback_for_other_devices():
    d = torch.empty((1, 4, 3), device="meta")
    h = torch.empty((4, 3), device="meta")
    with pytest.raises(TypeError):
        TR.remap_columns_multi(d, h, h, TR.PCM)


# the ids "PPM_IH4", "PPM_H6" and "P3M_H4" keep their names; every
# remap scheme of the reference is ported, so no value is left to refuse:
# each case holds the scheme's remap against the reference (P3M_H4, the
# id PPM_IH4 held last, with vanished layers); the reference's P3M_H4
# takes the port's repair of its cell mean (ROADMAP queue 3)
@pytest.mark.parametrize("scheme,vanished", [
    pytest.param("P3M_H4", True, id="PPM_IH4"),
    pytest.param("PPM_H6", False, id="PPM_H6"),
    pytest.param("P3M_H4", False, id="P3M_H4")])
def test_unported_schemes_raise(scheme, vanished):
    """The new schemes' remaps against the reference (float32, 2e-6 of
    max-abs), on the CPU's plain version; P3M_H4 takes five
    coefficients."""
    f, h0, h1 = _problem(nz0=12, nz1=9, nf=2, vanished=vanished, seed=5)
    with reference_p3m_mean_kept():
        want = R.remap_columns_multi(jnp.asarray(f), jnp.asarray(h0),
                                     jnp.asarray(h1), scheme)
    got = TR.remap_columns_multi(*(torch.from_numpy(a) for a in (f, h0, h1)),
                                 scheme)
    _close(got, want, 2e-6)
    coef = TR.remap_coefficients(torch.from_numpy(f), torch.from_numpy(h0),
                                 scheme)[0]
    assert coef.shape[1] == (5 if scheme == TR.P3M_H4 else 3)


@pytest.fixture(scope="module")
def gyre():
    """thermo_gyre(16, 14, 6) in both packages, the port's carried across,
    with a state whose thicknesses, T, S, u and v vary (from a seed)."""
    ref = ref_thermo_gyre(16, 14, 6)
    G, GV, st, p, f = ref
    rng = np.random.default_rng(3)
    m = np.asarray(G.mask2dT)[None]
    shape = st.h.shape
    h = np.asarray(st.h) * (1.0 + 0.2 * rng.uniform(-1, 1, shape) * m)
    st = st.replace(
        h=jnp.asarray(h, jnp.float32),
        T=jnp.asarray(np.asarray(st.T) + rng.standard_normal(shape) * m,
                      jnp.float32),
        S=jnp.asarray(35.0 + 0.3 * rng.standard_normal(shape) * m,
                      jnp.float32),
        u=jnp.asarray(0.2 * rng.standard_normal(shape)
                      * np.asarray(G.mask2dCu)[None], jnp.float32),
        v=jnp.asarray(0.2 * rng.standard_normal(shape)
                      * np.asarray(G.mask2dCv)[None], jnp.float32))
    port = interop.load_all(*(interop.export(o) for o in (G, GV, st, p, f)),
                            device="cpu")
    return (G, GV, st, p), port


def test_build_zstar_grid_parity(gyre):
    (G, _, st, p), (Gt, _, stt, pt, _) = gyre
    want = ref_zstar(st.h, G.bathyT, jnp.asarray(p.ale.dz_nominal,
                                                 jnp.float32))
    got = build_zstar_grid(stt.h, Gt.bathyT, pt.ale.dz_nominal)
    _close(got, want, 1e-6)
    # each column keeps its sum
    _close(got.sum(0), st.h.sum(0), 1e-6)
    np.testing.assert_array_equal(uniform_dz_profile(6, 3000.0),
                                  ref_uniform_dz(6, 3000.0))


def test_ale_regrid_remap_parity(gyre):
    (G, GV, st, p), (Gt, GVt, stt, pt, _) = gyre
    assert pt.ale == ALEParams(mode=p.ale.mode, dz_nominal=p.ale.dz_nominal,
                               scheme=p.ale.scheme,
                               min_thickness=p.ale.min_thickness)
    want, _ = ref_ale_regrid_remap(st, G, GV, p.ale)
    before = TR.remap_columns_multi.launches
    got, extra = ale_regrid_remap(stt, Gt, GVt, pt.ale)
    assert extra is None
    assert TR.remap_columns_multi.launches == before
    for k in ("h", "T", "S", "u", "v"):
        _close(getattr(got, k), getattr(want, k), 1e-5)


# the ids "SIGMA", "ADAPTIVE", "HYBGEN" and "SIGMA_SHELF_ZSTAR" keep
# their names; every mode and scheme of the reference is ported, so
# nothing is left for ale_regrid_remap to refuse: each case holds the
# mode with the scheme it held against the reference (P3M_H4's with the
# port's repair of its cell mean, ROADMAP queue 3)
@pytest.mark.parametrize("mode,scheme", [
    ("SIGMA", "P3M_H4"), ("ADAPTIVE", "PPM_H6"), ("HYBGEN", "PPM_H4"),
    ("SIGMA_SHELF_ZSTAR", "PPM_H6")],
    ids=["SIGMA", "ADAPTIVE", "HYBGEN", "SIGMA_SHELF_ZSTAR"])
def test_unported_ale_modes_raise(gyre, mode, scheme):
    """One regrid and remap in each mode with its scheme against the
    reference, float32: h to 1e-5 of max-abs; T, S, u and v where the
    new layer or face is thicker than 10 m (a remapped value divides the
    float32 round-off of the column's integral by the cell's
    thickness)."""
    from mom6_tpu.eos import get_eos as ref_get_eos
    from mom6_tpu_torch.framework.stencil import ip1, jp1
    (G, GV, st, p), (Gt, GVt, stt, pt, _) = gyre
    rho = 1035.0 + np.asarray(ref_get_eos("WRIGHT").density(
        st.T, st.S, jnp.full_like(st.T, 2e7), rho_ref=1035.0))
    targets = tuple(np.linspace(rho.min(), rho.max(), 6).astype(
        np.float32).tolist())
    dz = pt.ale.dz_nominal
    kw = dict(mode=mode, scheme=scheme, dz_nominal=dz, rho_targets=targets)
    with reference_p3m_mean_kept():
        want, _ = ref_ale_regrid_remap(st, G, GV, p.ale._replace(**kw))
    got, _ = ale_regrid_remap(stt, Gt, GVt, ALEParams(**kw))
    h = torch.from_numpy(np.array(want.h))
    thick = {"T": h > 10.0, "S": h > 10.0,
             "u": 0.5 * (h + ip1(h)) > 10.0, "v": 0.5 * (h + jp1(h)) > 10.0}
    _close(got.h, want.h, 1e-5)
    for k, m in thick.items():
        # HYBGEN's unmixing swaps a volume h (target - rho_k) / (rho_k+1 -
        # rho_k) of float32 densities near 1035 kg m-3 (ulp 1.2e-4) over
        # the pair's step: T and S to 1e-4
        tol = 1e-4 if mode == "HYBGEN" and k in ("T", "S") else 1e-5
        _close(getattr(got, k) * m, np.asarray(getattr(want, k))
               * m.numpy(), tol)


def test_ale_regrid_remap_rho_parity(gyre):
    """One regrid and remap onto isopycnal targets (the RHO mode, with the
    layers' target densities spread over the column's density range, so
    that some targets fall outside it and their layers vanish)."""
    (G, GV, st, p), (Gt, GVt, stt, pt, _) = gyre
    from mom6_tpu.eos import get_eos as ref_get_eos
    rho = 1035.0 + np.asarray(ref_get_eos("WRIGHT").density(
        st.T, st.S, jnp.full_like(st.T, 2e7), rho_ref=1035.0))
    targets = tuple(np.linspace(rho.min() - 0.5, rho.max() + 0.5,
                                6).tolist())
    ale_r = p.ale._replace(mode="RHO", rho_targets=targets, dz_nominal=())
    ale_t = ALEParams(mode="RHO", rho_targets=targets, scheme=pt.ale.scheme)
    want, _ = ref_ale_regrid_remap(st, G, GV, ale_r)
    got, _ = ale_regrid_remap(stt, Gt, GVt, ale_t)
    wet = np.asarray(want.h) > 1e-3
    for k in ("h", "u", "v"):
        _close(getattr(got, k), getattr(want, k), 1e-5)
    for k in ("T", "S"):
        _close(getattr(got, k) * torch.from_numpy(wet),
               np.asarray(getattr(want, k)) * wet, 1e-5)
    assert 0.0 < wet.mean() < 1.0            # some layers vanish
    _close(got.h.sum(0), st.h.sum(0), 1e-6)  # columns keep their sums
