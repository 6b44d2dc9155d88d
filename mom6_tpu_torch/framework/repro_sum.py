"""Order-invariant (reproducing) global sums
(twin of mom6_tpu/framework/repro_sum.py: reproducing_sum on the host,
fixed_point_sum on the tensor's device).

Each real is decomposed into 6 integer limbs of 46 bits (MOM6's
extended-fixed-point design, MOM_coms.F90:30-70); integer addition is
associative, so the sum is bitwise independent of summation order.

Divergence from the reference: the reference sums each limb in int64,
which overflows once an array has more than 2^17 elements (a limb digit
is below 2^46), and then returns a wrong total (by -4.3e-6 relative for
the mass of the 360x280x8 double gyre).  Here each limb is summed in
chunks of 2^16 elements, whose int64 sums cannot overflow, and the chunk
sums are added as Python integers.  Below 2^17 elements the two agree
bitwise.

:func:`fixed_point_sum` decomposes each value into ``n_limbs`` integer
digits of ``bits`` bits below a power-of-two bound and sums each digit
over the array as integers, so its result is bitwise independent of the
order of the elements; the exact integer totals are combined into one
float of the input's dtype with Neumaier's compensated summation in a
fixed order.  Divergence from the reference: its
``_exact_int_sum_pieces`` sums the low and the high bytes of each digit
in int32, which is exact only below 2^23 elements (a low byte is below
2^8); above it the sum wraps (global_half_deg's 3-D fields hold
720*400*32 = 9,216,000 elements).  Here those sums are int64 (the
default of ``torch.sum`` on an int32 tensor), exact at any size a card
holds, and below 2^23 elements the result equals the reference's
bitwise.

On a mesh (parallel/mesh.py), where the arrays are the rank's tiles, both
sums all-reduce their integer limbs (an int64 SUM) before they combine
them, so that the result is the one-rank sum to the bit at any rank
count.
"""

from __future__ import annotations

import numpy as np
import torch

from mom6_tpu_torch.framework import stencil

__all__ = ["reproducing_sum", "fixed_point_sum", "global_max",
           "global_min"]


def global_max(x) -> float:
    """The largest value of a tensor or array over every tile of the
    active mesh (of ``x`` alone off a mesh), as a float."""
    m = float(np.max(x.detach().cpu().numpy() if torch.is_tensor(x)
                     else np.asarray(x)))
    mesh = stencil._MESH
    if mesh is None:
        return m
    return float(mesh.all_max(torch.tensor([m], dtype=torch.float64))[0])


def global_min(x) -> float:
    """:func:`global_max` for the smallest value."""
    m = float(np.min(x.detach().cpu().numpy() if torch.is_tensor(x)
                     else np.asarray(x)))
    mesh = stencil._MESH
    if mesh is None:
        return m
    return float(mesh.all_min(torch.tensor([m], dtype=torch.float64))[0])


def _carry(limbs):
    for j in range(_NLIMB - 1, 0, -1):
        carry = limbs[j] >> _BITS
        limbs[j] -= carry << _BITS
        limbs[j - 1] += carry
    return limbs

_NLIMB = 6
_BITS = 46
_TOP_EXP = 3 * _BITS - 63  # largest representable magnitude ~ 2^75
_CHUNK = 1 << 16           # |chunk sum| < 2^(46+16): no int64 overflow


def _exact_int_sum(c: np.ndarray) -> int:
    """Exact sum of int64 values below 2^46 in magnitude."""
    n = c.size - c.size % _CHUNK
    total = sum(int(s) for s in c[:n].reshape(-1, _CHUNK).sum(axis=1))
    return total + int(c[n:].sum())


def reproducing_sum(x, scale: float = 1.0) -> float:
    """Exact order-invariant sum of a real numpy array (of every tile of
    the active mesh)."""
    x = np.asarray(x, dtype=np.float64).ravel() * scale
    mesh = stencil._MESH
    limbs = [0] * _NLIMB
    r = x / (2.0 ** _TOP_EXP)
    c = np.empty_like(r)
    for j in range(_NLIMB):
        r *= 2.0 ** _BITS
        np.floor(r, out=c)
        limbs[j] += _exact_int_sum(c.astype(np.int64))
        r -= c
    limbs = _carry(limbs)
    if mesh is not None:
        # limbs 1.. below 2^46 after the carry: their sums over the ranks
        # cannot overflow, and the carry is canonical again after them
        got = mesh.all_sum(torch.tensor(limbs, dtype=torch.int64))
        limbs = _carry([int(v) for v in got.tolist()])
    elif x.size == 0:
        return 0.0
    total = 0.0
    for j in range(_NLIMB):
        total += float(limbs[j]) * 2.0 ** (_TOP_EXP - (j + 1) * _BITS)
    return total


def fixed_point_sum(x: torch.Tensor, max_mag: float, n_limbs: int = 4,
                    bits: int = 14, dims=None) -> torch.Tensor:
    """Order-invariant sum of ``x`` over ``dims`` (all by default) on its
    device, as a tensor of ``x``'s dtype; the dimensions left over are a
    batch of independent sums, each the one the reference's function
    gives for that slice.  ``max_mag`` must bound ``max(|x|)``: the sum is
    exact to ``n_limbs * bits`` bits below the power of two above it (on
    a mesh, a bound over every tile).  On a mesh a sum over the plane's
    axes adds the digits' sums of every tile."""
    dtype = x.dtype
    top = float(2.0 ** np.ceil(np.log2(max_mag)))
    dims = tuple(range(x.dim())) if dims is None else tuple(
        d % x.dim() for d in dims)
    mesh = stencil._MESH
    plane = {x.dim() - 2, x.dim() - 1} & set(dims)
    if mesh is not None and len(plane) == 1:
        raise ValueError("fixed_point_sum: a sum along one axis of the "
                         "plane is not decomposed on a mesh")
    if not plane:
        mesh = None                     # a sum within each column
    r = (x / top).to(torch.float32)
    limbs = []
    for _ in range(n_limbs):
        r = r * float(2.0 ** bits)
        c = torch.floor(r)
        limbs.append(c.to(torch.int32))
        r = r - c
    limbs = torch.stack(limbs)                  # (n_limbs, *x.shape)
    red = tuple(d + 1 for d in dims)
    # the high and low bytes of every digit, summed exactly in int64
    s_hi = torch.sum(limbs >> 8, dim=red)       # (n_limbs, *batch)
    s_lo = torch.sum(limbs & 0xFF, dim=red)
    if mesh is not None:
        s_hi = mesh.all_sum(s_hi)
        s_lo = mesh.all_sum(s_lo)
    total = torch.zeros(s_hi.shape[1:], dtype=torch.float32,
                        device=x.device)
    comp = torch.zeros_like(total)
    for j in range(n_limbs):
        scale = top * 2.0 ** (-(j + 1) * bits)
        for sub_scale, piece in _exact_int_sum_pieces(s_hi[j], s_lo[j]):
            v = piece * float(np.float32(scale * sub_scale))
            t = total + v
            comp = comp + torch.where(total.abs() >= v.abs(),
                                      (total - t) + v, (v - t) + total)
            total = t
    return (total + comp).to(dtype)


def _exact_int_sum_pieces(s_hi: torch.Tensor, s_lo: torch.Tensor):
    """[(scale, float32 piece), ...] with sum(scale * piece) equal to
    256 s_hi + s_lo: each integer sum split into base-4096 digits (the
    top one signed) by arithmetic shifts, so every piece is below 2^24
    and converts to float32 exactly."""
    out = []
    for base, s in ((256.0, s_hi), (1.0, s_lo)):
        c0 = s - ((s >> 12) << 12)
        s1 = s >> 12
        c1 = s1 - ((s1 >> 12) << 12)
        s2 = s1 >> 12
        out.append((base, c0.to(torch.float32)))
        out.append((base * 4096.0, c1.to(torch.float32)))
        out.append((base * 4096.0 ** 2, s2.to(torch.float32)))
    return out
