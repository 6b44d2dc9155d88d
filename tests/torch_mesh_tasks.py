"""Tasks the port's multi-rank tests run on every rank of a
``torch_mesh_ranks.Ranks`` group (each takes the rank's ``ctx`` first).

Every task builds its model whole on the CPU from a seed, lays it on the
meshes of :data:`LAYOUTS` (1x1 on rank 0, 1x2 and 2x1 on ranks 0-1, 2x2
on all four), runs it on each rank's tile and gathers the result onto the
mesh's rank 0, which returns it as numpy; a rank outside a layout's
group skips that layout.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed

from mom6_tpu_torch.parallel.mesh import Mesh, gather, shard_model, shard_over

LAYOUTS = ((1, 1), (1, 2), (2, 1), (2, 2))
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _ranks_of(shape):
    return tuple(range(shape[0] * shape[1]))


def on_layouts(ctx, build, run, fetch, layouts=LAYOUTS, shard=shard_over):
    """{layout: fetch(gathered result)} on rank 0 ({} elsewhere), and
    under "plain" the run off any mesh: ``build()`` -> the global model
    tuple, ``shard(mesh, whole)`` -> the tiles, ``run(mesh, tiles)`` ->
    the tree to gather."""
    out = {}
    if ctx.rank == 0:
        # the port off any mesh
        with torch.inference_mode():
            out["plain"] = fetch(run(None, build()))
    for shape in layouts:
        ranks = _ranks_of(shape)
        if ctx.rank not in ranks:
            continue
        mesh = Mesh(shape, group=ctx.group(ranks), device="cpu")
        tiles = shard(mesh, build())
        with mesh, torch.inference_mode():
            res = run(mesh, tiles)
        got = gather(mesh, res)
        if mesh.rank == 0:
            out[shape] = fetch(got)
    return out


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def state_arrays(st):
    return {k: _np(getattr(st, k)) for k in ("h", "u", "v", "T", "S")
            if getattr(st, k, None) is not None}


def double_gyre_step(ctx, dt_name, n_steps=1):
    """test_sharding.py::test_layout_invariance through the port: the
    16x16x2 double gyre at dt 1200 with a seeded bump on h, one step of
    step_dynamics_split_rk2."""
    from mom6_tpu_torch.core.dynamics_split_rk2 import \
        step_dynamics_split_rk2
    from mom6_tpu_torch.drivers.experiments import double_gyre
    dtype = DTYPES[dt_name]

    def build():
        G, GV, st, p, f = double_gyre(nx=16, ny=16, nz=2, dt=1200.0,
                                      dtype=dtype, device="cpu")
        rng = np.random.default_rng(0)
        h = st.h + torch.as_tensor(rng.standard_normal(st.h.shape),
                                   dtype=dtype)
        return G, GV, st.replace(h=h), p, f

    def run(mesh, tiles):
        G, GV, st, p, f = tiles
        for _ in range(n_steps):
            st = step_dynamics_split_rk2(st, f, G, GV, p)
        return st
    return on_layouts(ctx, build, run, state_arrays)



def full_physics_model(dtype, nx=64, ny=64, nz=8):
    """test_sharding.py::_full_physics_setup through the port: thermo_gyre
    at 64x64x8 with KPP, shear mixing, GM (KHTH 100), MEKE, neutral
    diffusion and KHTR 50, h and u perturbed from a seed."""
    import dataclasses
    from mom6_tpu_torch.drivers.experiments import thermo_gyre
    from mom6_tpu_torch.physics.lateral.meke import MEKEParams
    from mom6_tpu_torch.physics.lateral.thickness_diffuse import GMParams
    G, GV, st, p, f = thermo_gyre(nx=nx, ny=ny, nz=nz, dt=1200.0,
                                  n_dyn_per_thermo=2, dtype=dtype,
                                  device="cpu")
    p = p.replace(gm=GMParams(khth=100.0), meke=MEKEParams(), khtr=50.0,
                  neutral_diffusion=True,
                  diabatic=dataclasses.replace(
                      p.diabatic, boundary_layer_scheme="KPP",
                      use_shear_mixing=True))
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    st = st.replace(
        E_meke=torch.zeros((ny, nx), dtype=dtype),
        kv_shear=torch.zeros((nz + 1, ny, nx), dtype=dtype),
        h=st.h + t(rng.uniform(size=st.h.shape)),
        u=st.u + 0.05 * t(rng.standard_normal(st.u.shape)))
    return G, GV, st, p, f


def full_physics_step(ctx, dt_name):
    """test_sharding.py::test_full_physics_step_layout_invariance through
    the port: one step_mom of :func:`full_physics_model`."""
    from mom6_tpu_torch.core.mom import step_mom
    dtype = DTYPES[dt_name]

    def run(mesh, tiles):
        G, GV, st, p, f = tiles
        return step_mom(st, f, G, GV, p)
    return on_layouts(ctx, lambda: full_physics_model(dtype), run,
                      state_arrays)


def stats(ctx, dt_name):
    """test_sharding.py::test_stats_bitwise_across_meshes through the
    port: ocean.stats of the full-physics state, on the device path and
    on the host path."""
    from mom6_tpu_torch.diagnostics.sum_output import (compute_stats,
                                                       compute_stats_device)
    dtype = DTYPES[dt_name]

    def run(mesh, tiles):
        G, GV, st, p, f = tiles
        dev = compute_stats_device(st, G, GV, 1200.0)
        host = compute_stats(st, G, GV, 1200.0)
        return {"dev": dev, "host": host}
    return on_layouts(ctx, lambda: full_physics_model(dtype), run,
                      lambda x: x)


def tripolar_model(run_dir, overrides, dtype, flowing=True):
    """The small tripolar model of test_torch_global.py (32x24x5 on
    configs/global_2deg's MOM_input), from a flowing state."""
    import os
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    ms = build_model_from_params(
        ParamFile([os.path.join(run_dir, "MOM_input")], text=overrides),
        dtype=dtype, device="cpu")
    st, G = ms.state, ms.grid
    if flowing:
        rng = np.random.default_rng(0)
        nz, ny, nx = st.h.shape
        yy, xx = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx),
                             indexing="ij")
        decay = np.exp(-np.arange(nz) / 3.0)[:, None, None]
        m = G.mask2dT.double().numpy()[None]
        t = lambda a: torch.as_tensor(a, dtype=dtype)
        st = st.replace(
            T=st.T + t((decay * (np.sin(np.pi * yy)
                                 * np.cos(2 * np.pi * xx))[None]
                        + 0.01 * rng.standard_normal(st.h.shape)) * m),
            u=t(0.3 * np.cos(np.pi * yy)[None] * decay
                * G.mask2dCu.double().numpy()[None]),
            v=t(0.3 * np.sin(2 * np.pi * xx)[None] * decay
                * G.mask2dCv.double().numpy()[None]))
    return ms.grid, ms.vgrid, st, ms.params, ms.forcing


def tripolar_step(ctx, dt_name, run_dir, overrides, extra=()):
    """One thermo cycle (step_mom) of :func:`tripolar_model` across the
    fold; ``extra`` names state fields to return beside h, u, v, T, S."""
    from mom6_tpu_torch.core.mom import step_mom
    dtype = DTYPES[dt_name]

    def run(mesh, tiles):
        G, GV, st, p, f = tiles
        return step_mom(st, f, G, GV, p)

    def fetch(st):
        return dict(state_arrays(st),
                    **{k: _np(getattr(st, k)) for k in extra})
    return on_layouts(ctx, lambda: tripolar_model(run_dir, overrides, dtype),
                      run, fetch)


def _plain_kernels():
    """Stand-ins for the PPM kernels' launches on the CPU (for
    ``_edges_launch``, ``_edges_halo_launch`` and ``_flux_launch``): the
    plain versions on the padded tile with the mesh set aside, so that
    they wrap as the kernels do."""
    from mom6_tpu_torch.core import continuity_ppm as cp
    from mom6_tpu_torch.framework import stencil

    def bare(fn):
        def call(*args):
            saved, stencil._MESH = stencil._MESH, None
            try:
                return fn(*args)
            finally:
                stencil._MESH = saved
        return call

    edges = bare(lambda name, h, m, h_min, mono, s2, d:
                 cp.ppm_edges_plain(h, m, h_min, mono, s2, d))
    halo = bare(lambda name, hp, mp, ny, h_min, mono, s2, fold:
                cp.ppm_edges_halo_plain(hp, mp, h_min, mono, s2, fold))
    flux = bare(lambda name, h, hl, hr, face, dp, dm, u, dw, rem, d:
                cp.ppm_flux_plain(h, hl, hr, face, dp, dm, u, dw, rem, d))
    return edges, halo, flux


def ppm_inputs(dtype, nz=3, ny=12, nx=16, fold=False, seed=5):
    """Seeded PPM inputs with land, as (h, mask, face, d_p, d_m, u, dw,
    rem); with ``fold`` the top row's mask is symmetric under the fold."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    mask = (rng.uniform(size=(ny, nx)) > 0.2).astype(np.float64)
    if fold:
        mask[-1] = mask[-1] * mask[-1, ::-1]
    h = t(0.5 + 50.0 * rng.uniform(size=(nz, ny, nx)) ** 3)
    face = t(1e4 * rng.uniform(0.5, 1.5, size=(ny, nx)))
    d_p = t(0.1 * rng.uniform(size=(ny, nx)))
    d_m = t(0.1 * rng.uniform(size=(ny, nx)))
    u = t(rng.standard_normal((nz, ny, nx)))
    dw = t(0.1 * rng.standard_normal((ny, nx)))
    rem = t(rng.uniform(size=(nz, ny, nx)))
    return h, t(mask), face, d_p, d_m, u, dw, rem


def ppm_tiles(ctx, dt_name, fold, monotonic, simple_2nd):
    """The PPM kernels' tile launches (halos, the HALO form and the fold
    across ranks), with the plain versions standing in for the kernels:
    {layout: {name: array}} of the x and y edges and fluxes, the
    Newton form included."""
    from mom6_tpu_torch.core import continuity_ppm as cp
    dtype = DTYPES[dt_name]
    h_min = 1e-10

    def run(mesh, tiles):
        h, mask, face, d_p, d_m, u, dw, rem = tiles
        out = {}
        for d, name in ((cp._DIR_X, "x"), (cp._DIR_Y, "y")):
            f = fold and d == cp._DIR_Y
            if cp._tile_mesh(d, f) is None:
                el, er = cp.ppm_edges_plain(h, mask, h_min, monotonic,
                                            simple_2nd, d, f)
                args = (h, el, er, face, d_p, d_m, u)
                a = cp.ppm_flux_plain(*args, None, None, d, f)
                b = cp.ppm_flux_plain(*args, dw, rem, d, f)
            else:
                el, er = cp._tile_edges(mesh, name, h, mask, h_min,
                                        monotonic, simple_2nd, d, f)
                args = (h, el, er, face, d_p, d_m, u)
                a = cp._tile_flux(mesh, name, *args, None, None, d, f)
                b = cp._tile_flux(mesh, name, *args, dw, rem, d, f)
            out.update({name + "_L": el, name + "_R": er,
                        name + "_uh": a[0], name + "_duh": a[1],
                        name + "_uh_adj": b[0]})
        return out

    def plain():
        h, mask, face, d_p, d_m, u, dw, rem = ppm_inputs(dtype, fold=fold)
        return h, mask, face, d_p, d_m, u, dw, rem

    saved = cp._edges_launch, cp._edges_halo_launch, cp._flux_launch
    cp._edges_launch, cp._edges_halo_launch, cp._flux_launch = \
        _plain_kernels()
    try:
        return on_layouts(ctx, plain, run,
                          lambda x: {k: _np(v) for k, v in x.items()})
    finally:
        cp._edges_launch, cp._edges_halo_launch, cp._flux_launch = saved


# --- the wide-halo barotropic subcycle (test_bt_widehalo.py) ---------------

def bt_grid(case, dtype):
    """The grids of test_bt_widehalo.py: (G, GV, nz, dt)."""
    from mom6_tpu_torch.grid.grid import build_cartesian_grid
    from mom6_tpu_torch.grid.mosaic import build_grid_from_supergrid
    from mom6_tpu_torch.grid.tripolar import make_tripolar_supergrid
    from mom6_tpu_torch.grid.vertical import build_layered_vgrid
    kw = dict(dtype=dtype, device="cpu")
    if case in ("walled", "auto", "undersized"):
        G = build_cartesian_grid(ny=64, nx=64, len_lon_km=1000.0,
                                 len_lat_km=1000.0, max_depth=1000.0,
                                 f0=6e-5, beta=2e-11 if case != "undersized"
                                 else 0.0, **kw)
        nz = 2 if case == "undersized" else 3
        return G, build_layered_vgrid(nz, **kw), nz, 900.0
    if case == "channel":
        G = build_cartesian_grid(ny=64, nx=64, len_lon_km=2000.0,
                                 len_lat_km=1000.0, max_depth=800.0,
                                 f0=-4e-5, beta=1.5e-11, cyclic_x=True, **kw)
        return G, build_layered_vgrid(3, **kw), 3, 900.0
    if case in ("linear", "envelope"):
        G = build_cartesian_grid(ny=64, nx=64, len_lon_km=1000.0,
                                 len_lat_km=1000.0, max_depth=1000.0,
                                 f0=6e-5, beta=2e-11, **kw)
        return G, build_layered_vgrid(2, **kw), 2, 900.0
    if case == "fold":
        sg = make_tripolar_supergrid(64, 20, 12, lat_s=30.0, lat_join=65.0,
                                     lon_bp=100.0)
        ny, nx = 32, 64
        depth = np.full((ny, nx), 1000.0)
        lat_t = sg["y"][1::2, 1::2]
        lon_t = sg["x"][1::2, 1::2]
        for plon in (100.0, 280.0):
            dlon = np.abs(np.mod(lon_t - plon + 180.0, 360.0) - 180.0)
            depth[(np.abs(lat_t - 65.0) < 2.5)
                  & (dlon * np.cos(np.deg2rad(lat_t)) < 4.0)] = 0.0
        G = build_grid_from_supergrid(sg, depth, cyclic_x=True,
                                      fold_north=True, **kw)
        return G, build_layered_vgrid(3, **kw), 3, 600.0
    raise ValueError(case)


def _smooth(ny, nx, kx, ky, amp, phase=0.0):
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    return amp * np.sin(2 * np.pi * (kx * i / nx + ky * j / ny) + phase)


def bt_inputs(G, GV, nz, depth, dtype):
    """test_bt_widehalo.py::_state with numpy: the bumpy flow, eta,
    thicknesses, forcings and remnants (antisymmetrized on a fold)."""
    ny, nx = G.mask2dT.shape
    fold = bool(G.fold_north)
    m = lambda a: a.double().numpy()
    st = lambda fn: np.stack([fn(k) for k in range(nz)])
    u = st(lambda k: _smooth(ny, nx, 2, 1, 0.08, 0.3 * k)) * m(G.mask2dCu)
    v = st(lambda k: _smooth(ny, nx, 1, 2, 0.06, 1.1 + 0.2 * k)) \
        * m(G.mask2dCv)
    if fold:
        v[:, -1, :] = 0.5 * (v[:, -1, :] - v[:, -1, ::-1])
    eta = _smooth(ny, nx, 1, 1, 0.4) * m(G.mask2dT)
    h = np.maximum(depth / nz + st(lambda k: _smooth(ny, nx, 3, 2, 8.0,
                                                      0.7 * k)), 1.0) \
        * m(G.mask2dT) + (1.0 - m(G.mask2dT)) * GV.angstrom
    accel_u = st(lambda k: _smooth(ny, nx, 2, 2, 2e-6, 0.5 * k))
    accel_v = st(lambda k: _smooth(ny, nx, 2, 3, 2e-6, 1.7 + 0.5 * k))
    rem_u = np.clip(0.9 + st(lambda k: _smooth(ny, nx, 1, 3, 0.08, k)),
                    0.2, 1.0)
    rem_v = np.clip(0.9 + st(lambda k: _smooth(ny, nx, 3, 1, 0.08,
                                                k + 0.4)), 0.2, 1.0)
    if fold:
        accel_v[:, -1, :] = 0.5 * (accel_v[:, -1, :] - accel_v[:, -1, ::-1])
        rem_v[:, -1, :] = 0.5 * (rem_v[:, -1, :] + rem_v[:, -1, ::-1])
    pbce = np.full(h.shape, GV.g_earth) \
        * (1.0 - 0.1 * np.arange(nz))[:, None, None]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype)
    return dict(u=t(u), v=t(v), eta=t(eta), h=t(h), accel_u=t(accel_u),
                accel_v=t(accel_v), visc_rem_u=t(rem_u),
                visc_rem_v=t(rem_v), pbce=t(pbce))


def widehalo(ctx, case, wide_halo, R=2, dt_name="f32", shape=(2, 2)):
    """btstep dense and with the wide halo on one mesh, after
    test_bt_widehalo.py::_run_both: {"dense1": one rank off a mesh,
    "dense": the mesh's dense path, "wide": the wide halo} as numpy BTOut
    dicts on rank 0, with each path's exchanges (per rank 0)."""
    from mom6_tpu_torch.core.barotropic import BTParams, btstep
    from mom6_tpu_torch.core.continuity_ppm import set_bt_cont
    dtype = DTYPES[dt_name]
    G, GV, nz, dt = bt_grid(case, dtype)
    depth = 800.0 if case == "channel" else 1000.0
    s = bt_inputs(G, GV, nz, depth, dtype)
    use_btc = case not in ("linear", "envelope")
    taux = None
    if case == "linear":
        taux = torch.as_tensor(_smooth(64, 64, 1, 1, 0.05).astype(
            np.float32), dtype=dtype) * G.mask2dCu
    base = dict(nstep=24, nfilter=8, bebt=0.2, use_bt_cont=use_btc,
                lin_drag=1e-4, cdrag=0.0 if case == "envelope" else 0.003,
                halo_per_substep=R)

    def call(G, s, taux, params):
        btc = set_bt_cont(s["h"], dt, G, GV) if use_btc else None
        return btstep(
            u_in=s["u"], v_in=s["v"], eta_in=s["eta"],
            bc_accel_u=s["accel_u"], bc_accel_v=s["accel_v"], h=s["h"],
            uh_in=torch.zeros_like(s["u"]), vh_in=torch.zeros_like(s["v"]),
            visc_rem_u=s["visc_rem_u"], visc_rem_v=s["visc_rem_v"],
            pbce=s["pbce"], eta_PF=0.5 * s["eta"], dt=dt, G=G, GV=GV,
            params=params, taux=taux, bt_cont=btc)

    out = {}
    if ctx.rank == 0:
        out["dense1"] = {k: _np(v) for k, v in
                         call(G, s, taux, BTParams(**base))._asdict().items()}
    ranks = _ranks_of(shape)
    if ctx.rank not in ranks:
        return out
    mesh = Mesh(shape, group=ctx.group(ranks), device="cpu")
    Gt, st, tx = shard_over(mesh, (G, s, taux))
    for name, w in (("dense", 0), ("wide", wide_halo)):
        p = BTParams(**base, wide_halo=w)
        n0 = mesh.exchanges
        try:
            with mesh:
                res = call(Gt, st, tx, p)
        except ValueError as e:
            out[name] = ("ValueError", str(e))
            continue
        n = mesh.exchanges - n0
        got = gather(mesh, res._asdict())
        if mesh.rank == 0:
            out[name] = {k: _np(v) for k, v in got.items()}
            out[name + "_exchanges"] = n
    return out


def auto_width(ctx, mesh_shape, grid_shape, R=2):
    """auto_wide_halo of the port for a mesh of ``mesh_shape`` (None: no
    mesh): the 2x2 layout read from the active mesh of the four ranks,
    the others given as the layout."""
    from mom6_tpu_torch.core.barotropic import BTParams, auto_wide_halo
    p = BTParams(nstep=24, nfilter=8, wide_halo=-1, halo_per_substep=R)
    if mesh_shape is None:
        return auto_wide_halo(p, grid_shape)
    if tuple(mesh_shape) != (2, 2):
        return auto_wide_halo(p, grid_shape, tuple(mesh_shape))
    with Mesh((2, 2), group=None, device="cpu"):
        return auto_wide_halo(p, grid_shape)


# --- the ensemble over ranks (test_ensemble_spherical.py) -------------------

def _gyre_members(dtype, ne, nx=16, ny=16):
    """double_gyre members told apart by their winds (1 + 0.1 i) and a
    seeded bump on h: (G, GV, params, forces, stacked states, stacked
    winds)."""
    from mom6_tpu_torch.drivers.experiments import double_gyre
    from mom6_tpu_torch.parallel.ensemble import stack_ensemble
    G, GV, st, p, f = double_gyre(nx=nx, ny=ny, nz=2, dt=1800.0,
                                  dtype=dtype, device="cpu")
    rng = np.random.default_rng(3)
    members = [st.replace(h=st.h + torch.as_tensor(
        rng.standard_normal(st.h.shape), dtype=dtype)) for _ in range(ne)]
    taux = torch.stack([f.taux * (1.0 + 0.1 * i) for i in range(ne)])
    return G, GV, p, f, stack_ensemble(members), taux


def ensemble(ctx, dt_name, ne, spatial):
    """ne double-gyre members over the four ranks, each on a ``spatial``
    mesh: one ensemble_step_sharded step of step_dynamics_split_rk2 and
    the members' mean, gathered; rank 0 also returns the one-process
    ensemble_step and ensemble_mean."""
    from mom6_tpu_torch.core.dynamics_split_rk2 import \
        step_dynamics_split_rk2
    from mom6_tpu_torch.parallel.ensemble import (
        ensemble_mean, ensemble_mean_sharded, ensemble_mesh, ensemble_step,
        ensemble_step_sharded, gather_ensemble, shard_ensemble)
    dtype = DTYPES[dt_name]
    G, GV, p, f, ens, taux = _gyre_members(dtype, ne)

    def stepper(G, f):
        def step(s, tx):
            return step_dynamics_split_rk2(s, f.replace(taux=tx), G, GV, p)
        return step

    em = ensemble_mesh(ne, spatial, device="cpu")
    Gt, ft = shard_over(em.spatial, (G, f))
    local = shard_ensemble(ens, em)
    tx_local = shard_over(em.spatial, taux[em.member:em.member + 1])
    out_local = ensemble_step_sharded(stepper(Gt, ft), em)(local, tx_local)
    with em.spatial:
        mean_local = ensemble_mean_sharded(out_local, em)
    got = gather_ensemble(out_local, em)
    mean = gather(em.spatial, mean_local)
    res = {"exchanges": em.spatial.exchanges}
    if got is not None:
        res["ranks"] = state_arrays(got)
    if em.member == 0 and em.spatial.rank == 0:
        res["ranks_mean"] = state_arrays(mean)
    if ctx.rank == 0:
        want = ensemble_step(stepper(G, f))(ens, taux)
        res["one"] = state_arrays(want)
        res["one_mean"] = state_arrays(ensemble_mean(want))
    return res


def eakf(ctx, dt_name, ne, spatial, loc_radius, inflation):
    """One ODA analysis (oda_analysis) of ne thermo_gyre members over the
    ranks, each member on a ``spatial`` mesh, against the one-process
    analysis: the increments and the analysed vector, gathered."""
    from mom6_tpu_torch.drivers.experiments import thermo_gyre
    from mom6_tpu_torch.parallel.ensemble import (
        ensemble_mesh, gather_ensemble, shard_ensemble, stack_ensemble)
    from mom6_tpu_torch.physics.oda_driver import (ODAParams, oda_analysis,
                                                   synthetic_sst_obs)
    from mom6_tpu_torch.physics.oda_eakf import EAKFParams
    dtype = DTYPES[dt_name]
    G, GV, st, p, f = thermo_gyre(nx=16, ny=12, nz=4, dtype=dtype,
                                  device="cpu")
    rng = np.random.default_rng(11)
    members = [st.replace(
        T=st.T + torch.as_tensor(rng.standard_normal(st.T.shape),
                                 dtype=dtype) * G.mask2dT,
        S=st.S + torch.as_tensor(0.1 * rng.standard_normal(st.S.shape),
                                 dtype=dtype) * G.mask2dT)
        for _ in range(ne)]
    ens = stack_ensemble(members)
    truth = st.T + 0.5 * G.mask2dT
    idx, val, var = synthetic_sst_obs(truth, G.mask2dT, 12, 0.1, seed=2)
    # two more observations of the second level and of S
    nz, ny, nx = st.T.shape
    idx = np.concatenate([idx, [ny * nx + 5 * nx + 7,
                                nz * ny * nx + 2 * nx + 9]]).astype(np.int64)
    val = np.concatenate([val, [st.T[1, 5, 7].item() + 0.3, 35.2]])
    var = np.concatenate([var, [0.01, 0.01]])
    pa = ODAParams(eakf=EAKFParams(inflation=inflation,
                                   loc_radius=loc_radius), assim_S=True)
    em = ensemble_mesh(ne, spatial, device="cpu")
    Gt = shard_over(em.spatial, G)
    local = shard_ensemble(ens, em)
    with em.spatial:
        inc, x_a = oda_analysis(local, idx, val, var, Gt, pa, emesh=em)
    got = gather_ensemble(inc._asdict() if hasattr(inc, "_asdict") else
                          {"dT": inc.dT, "dS": inc.dS}, em)
    res = {}
    if got is not None:
        res["ranks"] = {k: _np(v) for k, v in got.items()
                        if torch.is_tensor(v)}
    if ctx.rank == 0:
        inc1, _ = oda_analysis(ens, idx, val, var, G, pa)
        res["one"] = {"dT": _np(inc1.dT), "dS": _np(inc1.dS)}
    return res


# --- builders, refusals and the driver on ranks ----------------------------

def quarter_turn_refused(ctx):
    """The quarter turn of framework/array_transform.py on a tile of the
    2x2 mesh: the NotImplementedError's message, or None where it ran."""
    from mom6_tpu_torch.framework.array_transform import rotate_scalar
    mesh = Mesh((2, 2), group=None, device="cpu")
    a = shard_over(mesh, torch.zeros((8, 8)))
    try:
        with mesh:
            rotate_scalar(a)
        return None
    except NotImplementedError as e:
        return str(e)


def build_on_mesh(ctx, run_dir, overrides):
    """build_model_from_params with ``mesh`` on the 2x2 mesh against
    shard_over of the whole build: whether every tile is the same, and
    BT_WIDE_HALO's width."""
    import os
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    from mom6_tpu_torch.framework.containers import tensor_fields
    from mom6_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device="cpu")          # the most square: 2x2
    pf = lambda: ParamFile([os.path.join(run_dir, "MOM_input")],  # noqa
                           text=overrides)
    ms = build_model_from_params(pf(), device="cpu", mesh=mesh)
    whole = build_model_from_params(pf(), device="cpu")
    G, GV, st, p, f = shard_over(mesh, (whole.grid, whole.vgrid,
                                        whole.state, whole.params,
                                        whole.forcing))
    same = all(torch.equal(getattr(a, n), t)
               for a, b in ((ms.grid, G), (ms.state, st))
               for n, t in tensor_fields(b).items())
    return dict(same=same, shape=tuple(ms.state.h.shape),
                width=ms.params.dyn.bt.wide_halo, layout=mesh.shape,
                tile=(mesh.py, mesh.px), bounds=mesh.tile_bounds())


def run_segment_stats(ctx, tmp):
    """run_segment of two double-gyre steps, a stats line each, on one
    rank and on the 2x2 mesh (only the mesh's rank 0 writes): the two
    files' text."""
    import os
    from mom6_tpu_torch.drivers.experiments import double_gyre
    from mom6_tpu_torch.drivers.solo import run_segment
    G, GV, st, p, f = double_gyre(nx=16, ny=16, nz=2, device="cpu")
    out = {}
    if ctx.rank == 0:
        path = os.path.join(tmp, "one.stats")
        run_segment(st, G, GV, p, f, n_steps=2, stats_interval=1,
                    stats_path=path)
        out["one"] = open(path).read()
    mesh = Mesh((2, 2), group=None, device="cpu")
    tiles = shard_over(mesh, (G, GV, st, p, f))
    path = os.path.join(tmp, "ranks.stats")
    with mesh:
        run_segment(tiles[2], tiles[0], tiles[1], tiles[3], tiles[4],
                    n_steps=2, stats_interval=1, stats_path=path)
    torch.distributed.barrier()
    if ctx.rank == 0:
        out["ranks"] = open(path).read()
    return out


def _count_global(ctx, run_dir, overrides):
    import os, time
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    from mom6_tpu_torch.core.mom import step_mom
    mesh = Mesh((2, 2), group=None, device="cpu")
    ms = build_model_from_params(ParamFile([os.path.join(run_dir, "MOM_input")], text=overrides), device="cpu", mesh=mesh)
    with mesh, torch.inference_mode():
        t = time.time()
        st = step_mom(ms.state, ms.forcing, ms.grid, ms.vgrid, ms.params)
        t = time.time() - t
    return mesh.exchanges, mesh.bytes_sent, t, ms.params.dyn.bt.nstep, ms.params.n_dyn_per_thermo


def widehalo_cycle(ctx, run_dir, overrides):
    """One thermo cycle of the small tripolar model on the 2x2 mesh with
    the dense barotropic path and with BT_WIDE_HALO's width of
    ``overrides`` (bound to the mesh by shard_model): the gathered h, u,
    v of each, and each path's exchanges (rank 0)."""
    import os
    from mom6_tpu_torch.core.mom import step_mom
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    from mom6_tpu_torch.parallel.mesh import shard_model
    ms = build_model_from_params(
        ParamFile([os.path.join(run_dir, "MOM_input")], text=overrides),
        device="cpu")
    width = ms.params.dyn.bt.wide_halo
    out = {}
    for name, w in (("dense", 0), ("wide", width)):
        mesh = Mesh((2, 2), group=None, device="cpu")
        p = ms.params.replace(dyn=ms.params.dyn.replace(
            bt=ms.params.dyn.bt.replace(wide_halo=w)))
        G, GV, st, p, f = shard_model(mesh, ms.grid, ms.vgrid, ms.state, p,
                                      ms.forcing)
        with mesh, torch.inference_mode():
            s = step_mom(st, f, G, GV, p)
        got = gather(mesh, {k: getattr(s, k) for k in ("h", "u", "v")})
        if got is not None:
            out[name] = {k: _np(v) for k, v in got.items()}
            out[name + "_exchanges"] = mesh.exchanges
    return out


# --- every step_mom option and the host work on ranks -------------------------

# the layout of the option and host-work tasks: four ranks, the plane
# split in both axes (the fold's partner tiles on the top rank row)
OPT_LAYOUTS = ((2, 2),)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def param_model(dtype, config=None, text="", run_dir=None):
    """build_model_from_params of configs/<config> (or of ``run_dir``)
    with ``text`` on top of its MOM_input, on the CPU: the ModelSetup."""
    from mom6_tpu_torch.drivers.config_driver import build_model_from_params
    from mom6_tpu_torch.framework.config import ParamFile
    d = run_dir or os.path.join(REPO, "configs", config)
    return build_model_from_params(
        ParamFile([os.path.join(d, "MOM_input")], text=text or None),
        dtype=dtype, device="cpu", input_dir=d)


def _whole(ms):
    return ms.grid, ms.vgrid, ms.state, ms.params, ms.forcing


def _shard_model(mesh, whole):
    return shard_model(mesh, *whole)


def cycles(mesh, tiles, provider, n):
    """``n`` thermo cycles (step_mom) of the model ``tiles``, each with
    the provider's forcing at its start where there is a provider (cut
    to the tile on a mesh)."""
    from mom6_tpu_torch.core.mom import step_mom
    G, GV, st, p, f = tiles
    for c in range(n):
        if provider is not None:
            f = provider(c * p.dyn.dt * p.n_dyn_per_thermo)
            if mesh is not None:
                f = shard_over(mesh, f)
        st = step_mom(st, f, G, GV, p)
    return st


def option_cycles(ctx, dt_name, config, text="", n=1, extra=(),
                  run_dir=None):
    """``n`` thermo cycles of configs/<config> (or of ``run_dir``) with
    ``text``, built once, cut by shard_model on the layouts of
    :data:`OPT_LAYOUTS`: h, u, v, T, S and the ``extra`` state fields."""
    ms = param_model(DTYPES[dt_name], config, text, run_dir)

    def run(mesh, tiles):
        return cycles(mesh, tiles, ms.forcing_provider, n)

    def fetch(st):
        return dict(state_arrays(st),
                    **{k: _np(getattr(st, k)) for k in extra})
    return on_layouts(ctx, lambda: _whole(ms), run, fetch, OPT_LAYOUTS,
                      _shard_model)


def ssa(ctx, dt_name):
    """ssa_solve (two Picard iterations of 12 CG iterations) of a shelf
    that thins eastward over a 16x16 walled basin, seeded: the corner
    velocities and the CG residuals."""
    from mom6_tpu_torch.grid.grid import build_cartesian_grid
    from mom6_tpu_torch.physics.ice_shelf_dynamics import SSAParams, \
        ssa_solve
    dtype = DTYPES[dt_name]
    G = build_cartesian_grid(ny=16, nx=16, len_lon_km=160.0,
                             len_lat_km=160.0, max_depth=1000.0,
                             dtype=dtype, device="cpu")
    rng = np.random.default_rng(4)
    x = np.arange(16)[None, :] * np.ones((16, 1))
    h = np.where(x < 12, 600.0 * (1.0 - x / 16.0), 0.0) \
        + 5.0 * rng.uniform(size=(16, 16))
    h = torch.as_tensor(h, dtype=dtype) * G.mask2dT

    def run(mesh, tiles):
        G, h = tiles
        u, v = ssa_solve(h, G, SSAParams(n_picard=2, n_cg=12))
        return {"u": u, "v": v, "residuals": ssa_solve.residuals}
    return on_layouts(ctx, lambda: (G, h), run,
                      lambda x: {k: _np(v) for k, v in x.items()},
                      OPT_LAYOUTS)


def _registered(reg, st):
    return {n: _np(reg.get(n, st)) for n in reg.names}


def restart_to_one(ctx, dt_name, tmp, config, text):
    """A cycle on the 2x2 mesh and on one rank, each saved to a restart
    (whole and with IO_LAYOUT 2,2); rank 0 then restores the ranks' file
    on one rank: {"same_files": whether the files are equal variable by
    variable, "restored"/"want": the registered fields}."""
    import torch.distributed as dist
    from mom6_tpu_torch.framework.restart import RestartRegistry
    from mom6_tpu_torch.io.netcdf import read_nc
    ms = param_model(DTYPES[dt_name], config, text)
    whole = _whole(ms)
    out = {}
    mesh = Mesh((2, 2), group=None, device="cpu")
    tiles = shard_model(mesh, *whole)
    with mesh, torch.inference_mode():
        st = cycles(mesh, tiles, ms.forcing_provider, 1)
        reg = RestartRegistry()
        reg.register_state(st)
        for name, layout in (("ranks.nc", None), ("ranks_io.nc", (2, 2))):
            reg.save_restart(os.path.join(tmp, name), st, time_seconds=1800.0,
                             step=3, io_layout=layout)
    dist.barrier()
    if ctx.rank != 0:
        return out
    with torch.inference_mode():
        st1 = cycles(None, whole, ms.forcing_provider, 1)
        reg = RestartRegistry()
        reg.register_state(st1)
        for name, layout in (("one.nc", None), ("one_io.nc", (2, 2))):
            reg.save_restart(os.path.join(tmp, name), st1,
                             time_seconds=1800.0, step=3, io_layout=layout)
        back, t, step = reg.restore_state(os.path.join(tmp, "ranks.nc"),
                                          whole[2])
    files = [("ranks.nc", "one.nc")] + [
        (f"ranks_io.nc.{n:04d}", f"one_io.nc.{n:04d}") for n in range(4)]
    same = True
    for a, b in files:
        x, y = (read_nc(os.path.join(tmp, f)) for f in (a, b))
        same = same and sorted(x) == sorted(y) and all(
            np.array_equal(x[k], y[k]) for k in x)
    out.update(same_files=same, time=(t, step), names=reg.names,
               restored=_registered(reg, back), want=_registered(reg, st1))
    return out


def restart_from_one(ctx, dt_name, tmp, config, text):
    """A cycle on one rank saved (whole and with IO_LAYOUT 2,2) by rank
    0, restored on the 2x2 mesh from each file and gathered: {"whole",
    "io": the registered fields, "want": one rank's}."""
    import torch.distributed as dist
    from mom6_tpu_torch.framework.restart import RestartRegistry
    ms = param_model(DTYPES[dt_name], config, text)
    whole = _whole(ms)
    out = {}
    if ctx.rank == 0:
        with torch.inference_mode():
            st1 = cycles(None, whole, ms.forcing_provider, 1)
        reg = RestartRegistry()
        reg.register_state(st1)
        for name, layout in (("one.nc", None), ("one_io.nc", (2, 2))):
            reg.save_restart(os.path.join(tmp, name), st1, io_layout=layout)
        out["want"] = _registered(reg, st1)
    dist.barrier()
    mesh = Mesh((2, 2), group=None, device="cpu")
    G, GV, st, p, f = shard_model(mesh, *whole)
    with mesh, torch.inference_mode():
        reg = RestartRegistry()
        reg.register_state(st)
        for key, name in (("whole", "one.nc"), ("io", "one_io.nc")):
            back = reg.restore_state(os.path.join(tmp, name), st)[0]
            got = {n: gather(mesh, reg.get(n, back)) for n in reg.names}
            if mesh.rank == 0:
                out[key] = {n: _np(v) for n, v in got.items()}
    return out


def split_run(ctx, dt_name, tmp, config, text):
    """Two cycles on the 2x2 mesh split by a restart the ranks save and
    restore, against two straight cycles on one rank: the registered
    fields of each."""
    from mom6_tpu_torch.framework.restart import RestartRegistry
    ms = param_model(DTYPES[dt_name], config, text)
    whole = _whole(ms)
    out = {}
    mesh = Mesh((2, 2), group=None, device="cpu")
    G, GV, st, p, f = shard_model(mesh, *whole)
    path = os.path.join(tmp, "split.nc")
    with mesh, torch.inference_mode():
        s1 = cycles(mesh, (G, GV, st, p, f), ms.forcing_provider, 1)
        reg = RestartRegistry()
        reg.register_state(st)
        reg.save_restart(path, s1)
        back = reg.restore_state(path, st)[0]
        s2 = cycles(mesh, (G, GV, back, p, f), ms.forcing_provider, 1)
        got = {n: gather(mesh, reg.get(n, s2)) for n in reg.names}
    if ctx.rank == 0:
        out["ranks"] = {n: _np(v) for n, v in got.items()}
        with torch.inference_mode():
            want = cycles(None, whole, ms.forcing_provider, 2)
        out["one"] = _registered(reg, want)
    return out


def dossier(ctx, dt_name, run_dir, overrides):
    """worst_cfl_dossier of the flowing tripolar model's state (rank 0's
    dict; None elsewhere)."""
    from mom6_tpu_torch.diagnostics.point_accel import worst_cfl_dossier

    def run(mesh, tiles):
        G, GV, st, p, f = tiles
        return worst_cfl_dossier(st, G, 1200.0)
    return on_layouts(ctx, lambda: tripolar_model(run_dir, overrides,
                                                  DTYPES[dt_name]),
                      run, lambda d: d, OPT_LAYOUTS)


def diag_table(ctx, dt_name, run_dir, overrides, table, tmp):
    """A cycle of the flowing tripolar model, then the diag_table's
    fields posted as the CLI posts them (drivers/solo.py's
    _table_setup and _post_table_diags, the mediator built from the
    global grid) and written by flush_all: every variable of the written
    file, per layout."""
    from mom6_tpu_torch.core.mom import step_mom
    from mom6_tpu_torch.drivers.solo import _post_table_diags, _table_setup
    from mom6_tpu_torch.framework.diag_mediator import DiagMediator
    from mom6_tpu_torch.io.netcdf import read_nc
    dtype = DTYPES[dt_name]
    whole = tripolar_model(run_dir, overrides, dtype)
    G, GV, st, p, f = whole
    nz = st.h.shape[0]
    z_targets = np.asarray(p.ale.dz_nominal) if p.ale.dz_nominal \
        else np.full(nz, float(G.bathyT.max()) / nz)
    kw = dict(z_targets=z_targets,
              rho_targets=GV.Rlay.numpy().astype(np.float64)
              if GV.Rlay is not None else None,
              nz_sigma=nz, areaT=G.areaT.numpy(), device="cpu")
    n = [0]

    def run(mesh, tiles):
        G, GV, st, p, f = tiles
        out = os.path.join(tmp, f"diags{n[0]}_{ctx.rank}")
        n[0] += 1
        os.makedirs(out, exist_ok=True)
        dm = DiagMediator.from_diag_table(table, **kw)
        ke_fn, tend_fn = _table_setup(dm, st, p, f, G, GV, out)
        s = step_mom(st, f, G, GV, p)
        _post_table_diags(dm, s, G, GV, p, f, ke_fn, tend_fn)
        files = dm.flush_all(out, time_seconds=1800.0)
        return {name: read_nc(os.path.join(out, name + ".nc"))
                for name in files}
    return on_layouts(ctx, lambda: whole, run, lambda d: d, OPT_LAYOUTS)
