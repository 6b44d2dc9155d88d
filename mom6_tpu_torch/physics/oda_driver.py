"""One analysis of the ensemble ODA cycle (twin of
mom6_tpu/physics/oda_driver.py, the role of MOM_oda_driver.F90:824):
the members' T (and S) flattened on their device, the EAKF of
physics/oda_eakf.py over the observations, and the analysis increments
as a per-member ``IncrementalUpdate`` that step_mom applies ramped
through ``Forcing.oda_inc``.

The localization's distance is that of the reference: grid indices (j,
i) from ``np.mgrid``, every level of a column at the column's place.  It
ignores the cyclic x boundary and the tripolar fold, so an observation
at i = 0 does not reach i = nx - 1 (a fault of the reference, matched;
ROADMAP queue 3).  ``synthetic_sst_obs`` draws with numpy's
``default_rng(seed)`` on the host, so both packages draw the same
observations.

Over ranks (``emesh``, parallel/ensemble.py::ensemble_mesh) each rank
holds its member's tile: the analysis gathers every member's tile over
the ranks that hold the same tile, takes each observed element from the
rank whose tile holds it (the observation indices stay global), and
runs the update on its tile with the elements' global places; it keeps
its own member's increments.  The result is the one-process analysis to
the bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_tpu_torch.physics.oda_eakf import EAKFParams, eakf_update
from mom6_tpu_torch.physics.oda_incupd import IncrementalUpdate

__all__ = ["ODAParams", "oda_analysis", "synthetic_sst_obs"]


@dataclasses.dataclass(frozen=True)
class ODAParams:
    eakf: EAKFParams = EAKFParams()
    ramp_seconds: float = 6.0 * 3600.0
    assim_T: bool = True
    assim_S: bool = False


def oda_analysis(ens_state, obs_idx, obs_val, obs_var, G,
                 p: ODAParams = ODAParams(), emesh=None):
    """One analysis.  ``ens_state``: a state with a leading member axis
    (parallel/ensemble.py::stack_ensemble); ``obs_idx``: (n_obs,)
    indices into the flattened assimilated vector (T, then S), a surface
    T observation at (j, i) being j*nx + i.  Returns (IncrementalUpdate
    with (ne, nz, ny, nx) increments, the (ne, n) analysed vector).  With
    ``emesh`` (see the module's note) ``ens_state`` is this rank's member
    (a member axis of one) on its tile, and so are the results."""
    if emesh is not None:
        return _analysis_on_ranks(ens_state, obs_idx, obs_val, obs_var, G,
                                  p, emesh)
    ens_T, ens_S = ens_state.T, ens_state.S
    ne = ens_T.shape[0]
    shape_T = tuple(ens_T.shape[1:])
    parts = [ens_T.reshape(ne, -1)]
    if p.assim_S:
        parts.append(ens_S.reshape(ne, -1))
    x_f = torch.cat(parts, dim=1)
    coords = None
    if p.eakf.loc_radius > 0.0:
        # each element's (j, i); the levels at their column's place
        nz, ny, nx = shape_T
        jj, ii = np.mgrid[0:ny, 0:nx]
        c2 = np.stack([jj.ravel(), ii.ravel()], axis=-1).astype(np.float32)
        reps = nz * (2 if p.assim_S else 1)
        coords = torch.from_numpy(c2).to(x_f.device).repeat(reps, 1)
    x_a = eakf_update(x_f, obs_idx, obs_val, obs_var, p.eakf, coords=coords)
    dx = x_a - x_f
    n_t = int(np.prod(shape_T))
    mask = G.mask2dT[None, None]
    dT = dx[:, :n_t].reshape((ne,) + shape_T) * mask
    dS = dx[:, n_t:].reshape((ne,) + shape_T) * mask if p.assim_S else None
    return IncrementalUpdate(dT=dT, dS=dS, ramp_seconds=p.ramp_seconds), x_a


def _analysis_on_ranks(ens_local, obs_idx, obs_val, obs_var, G, p, emesh):
    """:func:`oda_analysis` of the members' tiles over ranks."""
    mesh = emesh.spatial
    ens_T = emesh.all_members(ens_local.T[0])
    parts = [ens_T]
    if p.assim_S:
        parts.append(emesh.all_members(ens_local.S[0]))
    ne = ens_T.shape[0]
    nz, ty, tx = ens_T.shape[1:]
    ny, nx = mesh.ny, mesh.nx
    x_f = torch.cat([a.reshape(ne, -1) for a in parts], dim=1)
    idx = np.asarray(obs_idx.cpu() if torch.is_tensor(obs_idx)
                     else obs_idx).astype(np.int64)
    # each observation's variable, level and column on the global grid
    n_glob = nz * ny * nx
    var, rest = np.divmod(idx, n_glob)
    lev, col = np.divmod(rest, ny * nx)
    jo, io = np.divmod(col, nx)
    owner = (jo // ty) * mesh.shape[1] + io // tx
    local = var * (nz * ty * tx) + lev * (ty * tx) \
        + (jo % ty) * tx + io % tx
    # the local index of the observed element on its owner (0 elsewhere)
    mine = np.where(owner == mesh.rank, local, 0)

    def observed(o, i, ens):
        y = ens[:, int(mine[o])]
        return mesh.broadcast_from(y, int(owner[o]))

    coords = obs_coords = None
    if p.eakf.loc_radius > 0.0:
        jj, ii = np.mgrid[mesh.j0:mesh.j0 + ty, mesh.i0:mesh.i0 + tx]
        c2 = np.stack([jj.ravel(), ii.ravel()], axis=-1).astype(np.float32)
        coords = torch.from_numpy(c2).to(x_f.device).repeat(len(parts) * nz,
                                                            1)
        obs_coords = torch.from_numpy(np.stack(
            [jo, io], axis=-1).astype(np.float32)).to(x_f.device)
    x_a = eakf_update(x_f, mine, obs_val, obs_var, p.eakf, coords=coords,
                      observed=observed, obs_coords=obs_coords)
    m = emesh.member
    dx = (x_a - x_f)[m:m + 1]
    n_t = nz * ty * tx
    mask = G.mask2dT[None, None]
    dT = dx[:, :n_t].reshape((1, nz, ty, tx)) * mask
    dS = dx[:, n_t:].reshape((1, nz, ty, tx)) * mask if p.assim_S else None
    return (IncrementalUpdate(dT=dT, dS=dS, ramp_seconds=p.ramp_seconds),
            x_a[m:m + 1])


def synthetic_sst_obs(truth_T, mask, n_obs, noise_std, seed=0):
    """Twin-experiment observations: ``n_obs`` wet surface points of the
    truth's T, drawn without replacement, with Gaussian error.  Returns
    (indices into the flattened (nz, ny, nx) T, values, variances) as
    numpy; ``truth_T`` and ``mask`` may be tensors on any device."""
    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)
    rng = np.random.default_rng(seed)
    nz, ny, nx = truth_T.shape
    wet = np.argwhere(host(mask) > 0.5)
    sel = wet[rng.choice(len(wet), size=n_obs, replace=False)]
    idx = (sel[:, 0] * nx + sel[:, 1]).astype(np.int32)   # k = 0
    vals = host(truth_T[0])[sel[:, 0], sel[:, 1]] \
        + noise_std * rng.standard_normal(n_obs)
    var = np.full(n_obs, noise_std ** 2)
    return idx, vals.astype(np.float64), var
