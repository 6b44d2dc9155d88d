// PPM continuity passes (edge reconstruction, face flux) for NVIDIA Hopper.
//
// Replaces the Pallas TPU kernels mom6_tpu/core/pallas_continuity.py::
// _zonal_kernel and ::_merid_kernel (the periodic wrap and, for the y
// direction, the tripolar northern fold).  The math is
// mom6_tpu/core/continuity_ppm.py: _recon_core (_ppm_edges, then
// _ppm_limit_pos, _ppm_limit_cw84 or simple_2nd) and _flux_pre_core +
// _flux_eval_core, in the same operation order (the library is built with
// --fmad=false, as the plain PyTorch versions round every op on its own).
//
// Schedule: that of the reference's XLA path, not of the Pallas blocks.
// The reconstruction is hoisted out of the Newton flux-adjust loop, so
// there are two kernels per direction:
//   ppm_edges<DIR, LIM>: tiles of cells:       h, mask -> h_L, h_R
//   ppm_flux<DIR, ADJ>:  one thread per face:  h, h_L, h_R, face, d_p,
//                        d_m, u [, dw, rem] -> uh, duh/du
// with w = u + dw*rem formed in the kernel for the Newton iterates.  The
// face width is one plane (ny, nx), or with FACE3D a field (nz, ny, nx):
// the porous barriers' open fractions times the face width.
// DIR is the direction: x (stride 1, wrap at nx) or y (stride nx, wrap
// at ny).  A wrapped index reproduces jnp.roll/torch.roll, so the kernels
// read the +-1/+-2 neighbours directly: the y pass needs no ghost slab.
//
// FOLD (y only) is the tripolar northern fold: the top edge of the grid
// is identified with itself under i -> nx-1-i, so the neighbour at row
// j+s >= ny is the cell (2ny-1-(j+s), nx-1-i).  The south side keeps
// the wrap of torch.roll (that row is land or wall-masked).  Across the
// fold the image cell is seen upside down: its slope changes sign (the
// "dh" ghost of the plain version) and its south/north edge pair swaps
// (jp1_sn).  The Pallas kernel gets these as ghost rows precomputed on
// a slab; here the kernels read the mirrored addresses themselves.
//
// What bounds them: device-memory bandwidth (read h, write h_L and h_R;
// read 5 to 7 fields and write 2 for the flux), if the instructions per
// cell stay few enough.  The edge kernel computes each cell's limited
// slope once, for a tile and a halo cell on each side, and forms the
// edges from the three slopes in shared memory; only threads that load a
// halo cell compute a wrapped or mirrored address, and a block reuses its
// mask tile and its addresses for every layer it walks.  x: a block
// stages a run of 128 cells of a row (plus two on each side).  y: a block
// stages a tile of 32 columns by 16 rows (plus two rows on each side); its
// four warps take every fourth row, each reading and writing 32
// neighbouring columns of a row.  The flux kernel is one thread per face,
// ~30 flops.  A matched continuity call reads the hoisted edges 4 times
// (1 plain + 3 Newton evaluations).

#include <climits>

#include <cuda_runtime.h>

namespace {

enum { DIR_X = 0, DIR_Y = 1 };
enum { LIM_POS = 0, LIM_CW84 = 1, LIM_SIMPLE2 = 2 };

template <typename T>
__device__ __forceinline__ T dmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T dmin(T a, T b) { return a < b ? a : b; }

// 2-D index of the neighbour at offset s along DIR of the cell (j, i),
// with the circular wrap of torch.roll; with FOLD a row beyond the top
// is the x-mirrored image below the fold line.
template <int DIR, bool FOLD>
__device__ __forceinline__ int shift2d(int j, int i, int s, int ny,
                                       int nx) {
  if (DIR == DIR_X) {
    int ii = (i + s) % nx;
    if (ii < 0) ii += nx;
    return j * nx + ii;
  }
  int jj = j + s;
  if (FOLD && jj >= ny) return (2 * ny - 1 - jj) * nx + (nx - 1 - i);
  jj %= ny;
  if (jj < 0) jj += ny;
  return jj * nx + i;
}

// A neighbour hn of the cell h seen through its mask m: land takes the
// cell's own value.
template <typename T>
__device__ __forceinline__ T masked(T m, T hn, T h) {
  return m * hn + (T(1) - m) * h;
}

// _ppm_edges: masked neighbours and the Lin-limited slope.
template <typename T>
__device__ __forceinline__ void edge_slope(T h, T hm, T hp, T mm, T mc,
                                           T mp, T& h_m, T& h_p, T& slp) {
  h_m = masked(mm, hm, h);
  h_p = masked(mp, hp, h);
  T s = T(0.5) * (h_p - h_m);
  const T dMx = dmax(dmax(h_p, h_m), h) - h;
  const T dMn = h - dmin(dmin(h_p, h_m), h);
  const T sg = s > T(0) ? T(1) : (s < T(0) ? T(-1) : T(0));
  s = sg * dmin(fabs(s), T(2) * dmin(dMx, dMn));
  slp = s * ((mm * mc) * mp);
}

// _ppm_limit_pos
template <typename T>
__device__ __forceinline__ void limit_pos(T h, T& hl, T& hr, T h_min) {
  const T curv = T(3) * ((hl + hr) - T(2) * h);
  const T dh = hr - hl;
  const bool min_inside = (curv > T(0)) && (fabs(dh) < curv);
  const bool flatten = min_inside && (h <= h_min);
  const T denom = curv * curv + (T(3) * dh) * dh;
  const T num = (T(12) * curv) * (h - h_min);
  const bool needs_scale = min_inside && !flatten && (num < denom);
  // (a branch: most cells need no division)
  T scale = T(1);
  if (needs_scale) scale = num / dmax(denom, T(1e-30));
  const T l2 = h + scale * (hl - h);
  const T r2 = h + scale * (hr - h);
  hl = flatten ? h : l2;
  hr = flatten ? h : r2;
}

// _ppm_limit_cw84
template <typename T>
__device__ __forceinline__ void limit_cw84(T h, T& hl, T& hr) {
  const bool not_mono = (hr - h) * (h - hl) <= T(0);
  const T rl_diff = hr - hl;
  const T rl_mean = T(0.5) * (hr + hl);
  const T fun_fac = (T(6) * rl_diff) * (h - rl_mean);
  const T rl_diff2 = rl_diff * rl_diff;
  T l2 = fun_fac > rl_diff2 ? T(3) * h - T(2) * hr : hl;
  T r2 = fun_fac < -rl_diff2 ? T(3) * h - T(2) * hl : hr;
  hl = not_mono ? h : l2;
  hr = not_mono ? h : r2;
}

// The edge pair of a cell from its masked neighbours h_m, h_p and the
// slopes of its minus neighbour, itself and its plus neighbour (the
// second half of _recon_core), then the limiter.
template <typename T, int LIM>
__device__ __forceinline__ void edge_values(T hc, T h_m, T h_p, T slp_m,
                                            T slp, T slp_p, T h_min,
                                            T& out_l, T& out_r) {
  const T one_sixth = T(1.0 / 6.0);
  out_l = T(0.5) * (h_m + hc) + one_sixth * (slp_m - slp);
  out_r = T(0.5) * (h_p + hc) + one_sixth * (slp - slp_p);
  if (LIM == LIM_CW84) {
    limit_cw84(hc, out_l, out_r);
  } else {
    limit_pos(hc, out_l, out_r, h_min);
  }
}

// simple_2nd: the means of the cell and its masked neighbours
template <typename T>
__device__ __forceinline__ void edge_simple2(T hc, T hm, T hp, T mm, T mp,
                                             T& out_l, T& out_r) {
  const T h_m = masked(mm, hm, hc);
  const T h_p = masked(mp, hp, hc);
  out_l = T(0.5) * (h_m + hc);
  out_r = T(0.5) * (h_p + hc);
}

// A coordinate outside [0, n) wrapped as torch.roll wraps it; only the
// threads that load a halo cell call it.
__device__ __forceinline__ int wrap(int c, int n) {
  c %= n;
  return c < 0 ? c + n : c;
}

constexpr int kEdgeThreads = 128;
// layers a block walks, at most
constexpr int kMaxChunk = 8;
// x: a block is kTileX cells of one row
constexpr int kTileX = kEdgeThreads;
// y: a block is a tile of kColsY columns (a warp) by kRowsY rows, its
// kStripsY warps taking every kStripsY-th row; positions -2 .. kRowsY+1
// of the tile are staged, kLoadsY rows a thread
constexpr int kColsY = 32;
constexpr int kStripsY = kEdgeThreads / kColsY;
constexpr int kRowsY = 16;
constexpr int kStageY = kRowsY + 4;
constexpr int kLoadsY = kStageY / kStripsY;
static_assert(kStageY % kStripsY == 0, "whole staged rows a thread");

// x: the layers k0 .. k0+nk-1 of the tile.  Positions -2 .. kTileX+1 of
// the row (a position outside the row wraps) are staged in shared memory,
// h anew for each layer, the mask once; each thread forms the slope of
// its own cell, threads 0 and 1 also those of the halo cells -1 and
// kTileX, and then the edges from the three slopes in shared memory.  The
// next layer's loads are started before this layer is computed.
template <typename T, int LIM>
__device__ __forceinline__ void edges_x_tile(const T* __restrict__ h,
                                             const T* __restrict__ mask,
                                             T* __restrict__ h_l,
                                             T* __restrict__ h_r, int k0,
                                             int nk, int ny, int nx,
                                             T h_min) {
  __shared__ T s_m[kTileX + 4];     // position p at p + 2
  __shared__ T s_h[kTileX + 4];
  __shared__ T s_s[kTileX + 2];     // slope of position p at p + 1
  const int tiles = (nx + kTileX - 1) / kTileX;
  const int j = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - j * tiles) * kTileX;
  const int t = threadIdx.x;
  const long long plane = (long long)ny * nx;
  const long long row = (long long)j * nx;
  // thread t loads position t - 2 and, for t < 4, kTileX - 2 + t
  const bool two = t < 4;
  int ca = i0 + t - 2;
  if (ca < 0 || ca >= nx) ca = wrap(ca, nx);
  int cb = i0 + kTileX - 2 + t;
  if (cb >= nx) cb = wrap(cb, nx);
  s_m[t] = mask[row + ca];
  if (two) s_m[kTileX + t] = mask[row + cb];
  __syncthreads();
  const T mm = s_m[t + 1], mc = s_m[t + 2], mp = s_m[t + 3];
  // the halo cell of threads 0 and 1: its minus neighbour's index in s_h
  const bool halo = t < 2;
  const int q = t == 0 ? 0 : kTileX + 1;
  T em = T(0), ec = T(0), ep = T(0);
  if (halo) {
    em = s_m[q];
    ec = s_m[q + 1];
    ep = s_m[q + 2];
  }
  const bool valid = i0 + t < nx;
  const long long own = row + i0 + t;
  T ra = h[k0 * plane + row + ca];
  T rb = two ? h[k0 * plane + row + cb] : T(0);
  for (int k = k0; k < k0 + nk; ++k) {
    s_h[t] = ra;
    if (two) s_h[kTileX + t] = rb;
    __syncthreads();
    if (k + 1 < k0 + nk) {
      const long long nb = (k + 1) * plane + row;
      ra = h[nb + ca];
      if (two) rb = h[nb + cb];
    }
    const T hc = s_h[t + 2], hm = s_h[t + 1], hp = s_h[t + 3];
    T out_l, out_r;
    if (LIM == LIM_SIMPLE2) {
      edge_simple2(hc, hm, hp, mm, mp, out_l, out_r);
      __syncthreads();
    } else {
      T h_m, h_p, slp;
      edge_slope(hc, hm, hp, mm, mc, mp, h_m, h_p, slp);
      s_s[t + 1] = slp;
      if (halo) {
        T t0, t1, s_halo;
        edge_slope(s_h[q + 1], s_h[q], s_h[q + 2], em, ec, ep, t0, t1,
                   s_halo);
        s_s[q] = s_halo;
      }
      __syncthreads();
      edge_values<T, LIM>(hc, h_m, h_p, s_s[t], slp, s_s[t + 2], h_min,
                          out_l, out_r);
    }
    if (valid) {
      h_l[k * plane + own] = out_l;
      h_r[k * plane + own] = out_r;
    }
  }
}

// y: the layers k0 .. k0+nk-1 of a tile of kColsY columns by kRowsY rows
// from row j0.  Warp w stages the positions w, w+kStripsY, ... of -2 ..
// kRowsY+1 (a row below 0 wraps; with FOLD a row at or beyond ny is the
// x-mirrored image below the fold line, any other wraps), the mask once
// and h layer by layer, the next layer's loads started before this one is
// computed.  The slopes of positions -1 .. kRowsY are formed once, then
// the edges of the tile's rows.  Everything is per column: a thread
// beyond nx stages a column that exists and stores nothing.  With FOLD
// two slopes are special, each in one warp-uniform row: the image of the
// top row (row ny) is taken in its own orientation, minus and plus
// neighbours swapped, and negated, as the plain version's "dh" ghost; and
// in the first tile the cell -1, the top row, has its fold image and not
// row 0 as its plus neighbour (staged in s_img).
//
// HALO is the tile of a rank of a mesh: h and the mask carry two rows
// below row 0 and two above row ny-1 that the caller filled (the
// neighbour ranks' rows, or on the top rank row the fold's ghost rows in
// the orientation of the tile), and nothing wraps or mirrors.  The image
// of the top row then stands in the halo in the tile's orientation, where
// its slope, formed with the neighbours it has there, is the negated
// slope of its own orientation to the bit (the limiter's operations are
// symmetric in the two neighbours).  With FOLD the tile is on the bottom
// rank row and its cell -1, the global top row, takes as its plus
// neighbour a fifth halo row after the top two: the fold image of the
// global top row over the tile's columns.  The outputs are the ny rows.
template <typename T, int LIM, bool FOLD, bool HALO>
__device__ __forceinline__ void edges_y_tile(const T* __restrict__ h,
                                             const T* __restrict__ mask,
                                             T* __restrict__ h_l,
                                             T* __restrict__ h_r, int k0,
                                             int nk, int ny, int nx,
                                             T h_min) {
  __shared__ T s_m[kStageY][kColsY];            // position p at p + 2
  __shared__ T s_h[kStageY][kColsY];
  __shared__ T s_s[kRowsY + 2][kColsY];         // position p at p + 1
  __shared__ T s_img[2][kColsY];                // FOLD, first tile: h, mask
  const int col_tiles = (nx + kColsY - 1) / kColsY;
  const int bj = blockIdx.x / col_tiles;
  const int i = (blockIdx.x - bj * col_tiles) * kColsY + threadIdx.x;
  const int j0 = bj * kRowsY;
  const int c = threadIdx.x, w = threadIdx.y;
  const bool valid_col = i < nx;
  const int ic = valid_col ? i : nx - 1;
  const long long plane = (long long)ny * nx;
  const long long in_plane =
      HALO ? (long long)(ny + 4 + (FOLD ? 1 : 0)) * nx : plane;
  int off[kLoadsY];
#pragma unroll
  for (int q = 0; q < kLoadsY; ++q) {
    int jj = j0 + w + kStripsY * q - 2, ii = ic;
    if (HALO) {
      // rows beyond the halo are never read for a stored cell
      jj = min(max(jj, -2), ny + 1) + 2;
    } else if (jj < 0 || jj >= ny) {
      if (FOLD && jj >= ny) {
        // a row beyond ny + 1 is never read for a stored cell
        jj = max(2 * ny - 1 - jj, 0);
        ii = nx - 1 - ic;
      } else {
        jj = wrap(jj, ny);
      }
    }
    off[q] = jj * nx + ii;
    s_m[w + kStripsY * q][c] = mask[off[q]];
  }
  const bool first = FOLD && j0 == 0;
  const int img =
      HALO ? (ny + 4) * nx + ic : (ny - 1) * nx + (nx - 1 - ic);
  if (first && w == 0) s_img[1][c] = mask[img];
  T v[kLoadsY], v_img = T(0);
#pragma unroll
  for (int q = 0; q < kLoadsY; ++q) v[q] = h[k0 * in_plane + off[q]];
  if (first && w == 0) v_img = h[k0 * in_plane + img];
  for (int g = 0; g < nk; ++g) {
    const long long base = (k0 + g) * plane;
    const long long in_base = (k0 + g) * in_plane;
#pragma unroll
    for (int q = 0; q < kLoadsY; ++q) s_h[w + kStripsY * q][c] = v[q];
    if (first && w == 0) s_img[0][c] = v_img;
    __syncthreads();
    if (g + 1 < nk) {
#pragma unroll
      for (int q = 0; q < kLoadsY; ++q)
        v[q] = h[in_base + in_plane + off[q]];
      if (first && w == 0) v_img = h[in_base + in_plane + img];
    }
    if (LIM == LIM_SIMPLE2) {
#pragma unroll
      for (int q = 0; q < kRowsY / kStripsY; ++q) {
        const int p = w + kStripsY * q;
        T out_l, out_r;
        edge_simple2(s_h[p + 2][c], s_h[p + 1][c], s_h[p + 3][c],
                     s_m[p + 1][c], s_m[p + 3][c], out_l, out_r);
        if (valid_col && j0 + p < ny) {
          h_l[base + (long long)(j0 + p) * nx + i] = out_l;
          h_r[base + (long long)(j0 + p) * nx + i] = out_r;
        }
      }
      __syncthreads();
      continue;
    }
    // slopes of positions p = w - 1 + kStripsY*q <= kRowsY
#pragma unroll
    for (int q = 0; q < kLoadsY; ++q) {
      const int p = w - 1 + kStripsY * q;
      if (p <= kRowsY) {
        const int s = p + 2;
        T lo = s_h[s - 1][c], hi = s_h[s + 1][c];
        T m_lo = s_m[s - 1][c], m_hi = s_m[s + 1][c];
        bool flip = false;
        if (FOLD) {
          if (j0 + p == -1) {
            hi = s_img[0][c];
            m_hi = s_img[1][c];
          } else if (!HALO && j0 + p == ny) {
            flip = true;
            const T a = lo, b = m_lo;
            lo = hi;
            hi = a;
            m_lo = m_hi;
            m_hi = b;
          }
        }
        T a, b, sl;
        edge_slope(s_h[s][c], lo, hi, m_lo, s_m[s][c], m_hi, a, b, sl);
        s_s[p + 1][c] = flip ? -sl : sl;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsY / kStripsY; ++q) {
      const int p = w + kStripsY * q;
      const int s = p + 2;
      const T hc = s_h[s][c];
      const T mm = s_m[s - 1][c], mp = s_m[s + 1][c];
      const T h_m = masked(mm, s_h[s - 1][c], hc);
      const T h_p = masked(mp, s_h[s + 1][c], hc);
      T out_l, out_r;
      edge_values<T, LIM>(hc, h_m, h_p, s_s[p][c], s_s[p + 1][c],
                          s_s[p + 2][c], h_min, out_l, out_r);
      if (valid_col && j0 + p < ny) {
        h_l[base + (long long)(j0 + p) * nx + i] = out_l;
        h_r[base + (long long)(j0 + p) * nx + i] = out_r;
      }
    }
    __syncthreads();
  }
}

// One launch per (direction, limiter, fold, halo): the x tiles or the y
// tiles of every layer chunk of kc layers (blockIdx.y).
template <typename T, int DIR, int LIM, bool FOLD, bool HALO = false>
__global__ void __launch_bounds__(kEdgeThreads)
    ppm_edges_kernel(const T* __restrict__ h, const T* __restrict__ mask,
                     T* __restrict__ h_l, T* __restrict__ h_r, int nz,
                     int ny, int nx, int kc, T h_min) {
  const int k0 = blockIdx.y * kc;
  const int nk = min(nz - k0, kc);
  if constexpr (DIR == DIR_X) {
    edges_x_tile<T, LIM>(h, mask, h_l, h_r, k0, nk, ny, nx, h_min);
  } else {
    edges_y_tile<T, LIM, FOLD, HALO>(h, mask, h_l, h_r, k0, nk, ny, nx,
                                     h_min);
  }
}

// FACE3D: the face width is a field of its own for each layer (the porous
// barriers' open fractions), (nz, ny, nx); otherwise one plane (ny, nx)
template <typename T, int DIR, bool ADJ, bool FOLD, bool FACE3D>
__global__ void ppm_flux_kernel(const T* __restrict__ h,
                                const T* __restrict__ h_l,
                                const T* __restrict__ h_r,
                                const T* __restrict__ face,
                                const T* __restrict__ d_p,
                                const T* __restrict__ d_m,
                                const T* __restrict__ u,
                                const T* __restrict__ dw,
                                const T* __restrict__ rem,
                                T* __restrict__ uh, T* __restrict__ duh,
                                int nz, int ny, int nx) {
  const long long plane = (long long)ny * nx;
  const long long n = plane * nz;
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int p = (int)(idx % plane);
  const long long base = idx - p;
  const int j = p / nx, i = p % nx;
  const long long ip = base + shift2d<DIR, FOLD>(j, i, 1, ny, nx);
  // _flux_pre_core
  const T hc = h[idx], hL = h_l[idx], hR = h_r[idx];
  const T eL = h_l[ip], eR = h_r[ip], hn = h[ip];
  // across the fold the plus cell is seen upside down: its edge pair
  // swaps; its curvature is that of the image cell itself
  const bool swap = FOLD && j == ny - 1;
  const T Lp = swap ? eR : eL, Rp = swap ? eL : eR;
  const T curv_p = (hL + hR) - T(2) * hc;
  const T curv_m = (eL + eR) - T(2) * hn;
  const T h_zero = T(0.5) * (Lp + hR);
  // _flux_eval_core
  T w = u[idx];
  if (ADJ) w = w + dw[p] * rem[idx];
  const T f = FACE3D ? face[idx] : face[p];
  const T cfl_p = w * d_p[p];
  const T cfl_m = (-w) * d_m[p];
  const T h_avg_p = hR + cfl_p * (T(0.5) * (hL - hR)
                                  + curv_p * (cfl_p - T(1.5)));
  const T h_avg_m = Lp + cfl_m * (T(0.5) * (Rp - Lp)
                                  + curv_m * (cfl_m - T(1.5)));
  const T h_marg_p = hR + cfl_p * ((hL - hR)
                                   + (T(3) * curv_p) * (cfl_p - T(1)));
  const T h_marg_m = Lp + cfl_m * ((Rp - Lp)
                                   + (T(3) * curv_m) * (cfl_m - T(1)));
  const T h_avg = w > T(0) ? h_avg_p : (w < T(0) ? h_avg_m : h_zero);
  const T h_marg = w > T(0) ? h_marg_p : (w < T(0) ? h_marg_m : h_zero);
  uh[idx] = (f * w) * h_avg;
  duh[idx] = f * h_marg;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n < 1) {
      cudaGetLastError();
      n = 1;
    }
  }
  return n;
}

// Layers a block of the edge kernel walks, reusing its mask and its
// index arithmetic: the most of 8, 4, 2 and 1 that still gives the grid
// 64 blocks an SM, so that the last wave is a small part of the launch.
inline int layers_per_block(long long tiles, int nz) {
  const long long want = 64LL * sm_count();
  for (int kc = kMaxChunk; kc > 1; kc /= 2)
    if (tiles * ceil_div(nz, kc) >= want) return kc;
  return 1;
}

// the largest layer count the grid takes (its y dimension)
constexpr int kMaxLayers = 65535;

template <typename T, int DIR, bool FOLD, bool HALO = false>
int edges_dir(const T* h, const T* mask, T* hl, T* hr, int nz, int ny,
              int nx, int limiter, T h_min, cudaStream_t s) {
  const long long tiles =
      DIR == DIR_X ? (long long)ceil_div(nx, kTileX) * ny
                   : (long long)ceil_div(nx, kColsY) * ceil_div(ny, kRowsY);
  const int kc = layers_per_block(tiles, nz);
  const dim3 grid((unsigned)tiles, (unsigned)ceil_div(nz, kc));
  const dim3 block = DIR == DIR_X ? dim3(kTileX) : dim3(kColsY, kStripsY);
  if (limiter == LIM_POS) {
    ppm_edges_kernel<T, DIR, LIM_POS, FOLD, HALO><<<grid, block, 0, s>>>(
        h, mask, hl, hr, nz, ny, nx, kc, h_min);
  } else if (limiter == LIM_CW84) {
    ppm_edges_kernel<T, DIR, LIM_CW84, FOLD, HALO><<<grid, block, 0, s>>>(
        h, mask, hl, hr, nz, ny, nx, kc, h_min);
  } else if (limiter == LIM_SIMPLE2) {
    ppm_edges_kernel<T, DIR, LIM_SIMPLE2, FOLD, HALO><<<grid, block, 0, s>>>(
        h, mask, hl, hr, nz, ny, nx, kc, h_min);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the fold is a boundary of the y direction and needs two rows
inline bool fold_ok(int dir, int fold, int ny) {
  return !fold || (dir == DIR_Y && ny >= 2);
}

// Refused with cudaErrorInvalidValue, before any launch: more than
// kMaxLayers layers, a plane of more than INT_MAX cells (the kernel's
// offsets in a plane are int), a fold that is not a y boundary of at least
// two rows, an unknown direction or limiter.
template <typename T>
int edges(const T* h, const T* mask, T* hl, T* hr, int nz, int ny, int nx,
          int dir, int fold, int limiter, double h_min, void* stream) {
  if ((long long)nz * ny * nx == 0) return 0;
  if (nz > kMaxLayers || (long long)ny * nx > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (!fold_ok(dir, fold, ny)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dir == DIR_X)
    return edges_dir<T, DIR_X, false>(h, mask, hl, hr, nz, ny, nx, limiter,
                                      T(h_min), s);
  if (dir == DIR_Y && fold)
    return edges_dir<T, DIR_Y, true>(h, mask, hl, hr, nz, ny, nx, limiter,
                                     T(h_min), s);
  if (dir == DIR_Y)
    return edges_dir<T, DIR_Y, false>(h, mask, hl, hr, nz, ny, nx, limiter,
                                      T(h_min), s);
  return (int)cudaErrorInvalidValue;
}

// The y pass over the tile of a mesh rank (HALO): h (nz, ny+4, nx) and
// the mask (ny+4, nx) with their two caller-filled halo rows on each
// side, or with ``fold`` (the bottom rank row of a folded grid) ny+5 rows,
// the fifth halo row the fold image of the global top row; h_l and h_r
// are (nz, ny, nx).  Refused like edges().
template <typename T>
int edges_halo(const T* h, const T* mask, T* hl, T* hr, int nz, int ny,
               int nx, int fold, int limiter, double h_min, void* stream) {
  if ((long long)nz * ny * nx == 0) return 0;
  if (nz > kMaxLayers || (long long)(ny + 5) * nx > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fold)
    return edges_dir<T, DIR_Y, true, true>(h, mask, hl, hr, nz, ny, nx,
                                           limiter, T(h_min), s);
  return edges_dir<T, DIR_Y, false, true>(h, mask, hl, hr, nz, ny, nx,
                                          limiter, T(h_min), s);
}

template <typename T, int DIR, bool FOLD, bool FACE3D>
int flux_dir(const T* h, const T* hl, const T* hr, const T* face,
             const T* dp, const T* dm, const T* u, const T* dw, const T* rem,
             T* uh, T* duh, int nz, int ny, int nx, cudaStream_t s) {
  const long long n = (long long)nz * ny * nx;
  const unsigned b = blocks_for(n);
  if (dw != nullptr) {
    ppm_flux_kernel<T, DIR, true, FOLD, FACE3D><<<b, kThreads, 0, s>>>(
        h, hl, hr, face, dp, dm, u, dw, rem, uh, duh, nz, ny, nx);
  } else {
    ppm_flux_kernel<T, DIR, false, FOLD, FACE3D><<<b, kThreads, 0, s>>>(
        h, hl, hr, face, dp, dm, u, dw, rem, uh, duh, nz, ny, nx);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DIR, bool FOLD>
int flux_face(const T* h, const T* hl, const T* hr, const T* face,
              const T* dp, const T* dm, const T* u, const T* dw,
              const T* rem, T* uh, T* duh, int nz, int ny, int nx,
              int face3d, cudaStream_t s) {
  if (face3d)
    return flux_dir<T, DIR, FOLD, true>(h, hl, hr, face, dp, dm, u, dw, rem,
                                        uh, duh, nz, ny, nx, s);
  return flux_dir<T, DIR, FOLD, false>(h, hl, hr, face, dp, dm, u, dw, rem,
                                       uh, duh, nz, ny, nx, s);
}

// face3d: the face width is (nz, ny, nx), not (ny, nx)
template <typename T>
int flux(const T* h, const T* hl, const T* hr, const T* face, const T* dp,
         const T* dm, const T* u, const T* dw, const T* rem, T* uh, T* duh,
         int nz, int ny, int nx, int dir, int fold, int face3d,
         void* stream) {
  if ((long long)nz * ny * nx == 0) return 0;
  if ((dw == nullptr) != (rem == nullptr)) return (int)cudaErrorInvalidValue;
  if (!fold_ok(dir, fold, ny)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dir == DIR_X)
    return flux_face<T, DIR_X, false>(h, hl, hr, face, dp, dm, u, dw, rem,
                                      uh, duh, nz, ny, nx, face3d, s);
  if (dir == DIR_Y && fold)
    return flux_face<T, DIR_Y, true>(h, hl, hr, face, dp, dm, u, dw, rem,
                                     uh, duh, nz, ny, nx, face3d, s);
  if (dir == DIR_Y)
    return flux_face<T, DIR_Y, false>(h, hl, hr, face, dp, dm, u, dw, rem,
                                      uh, duh, nz, ny, nx, face3d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mom6_ppm_edges_f32(const float* h, const float* mask,
                                  float* hl, float* hr, int nz, int ny,
                                  int nx, int dir, int fold, int limiter,
                                  double h_min, void* stream) {
  return edges<float>(h, mask, hl, hr, nz, ny, nx, dir, fold, limiter,
                      h_min, stream);
}

extern "C" int mom6_ppm_edges_f64(const double* h, const double* mask,
                                  double* hl, double* hr, int nz, int ny,
                                  int nx, int dir, int fold, int limiter,
                                  double h_min, void* stream) {
  return edges<double>(h, mask, hl, hr, nz, ny, nx, dir, fold, limiter,
                       h_min, stream);
}

extern "C" int mom6_ppm_flux_f32(const float* h, const float* hl,
                                 const float* hr, const float* face,
                                 const float* dp, const float* dm,
                                 const float* u, const float* dw,
                                 const float* rem, float* uh, float* duh,
                                 int nz, int ny, int nx, int dir, int fold,
                                 int face3d, void* stream) {
  return flux<float>(h, hl, hr, face, dp, dm, u, dw, rem, uh, duh, nz, ny,
                     nx, dir, fold, face3d, stream);
}

extern "C" int mom6_ppm_flux_f64(const double* h, const double* hl,
                                 const double* hr, const double* face,
                                 const double* dp, const double* dm,
                                 const double* u, const double* dw,
                                 const double* rem, double* uh, double* duh,
                                 int nz, int ny, int nx, int dir, int fold,
                                 int face3d, void* stream) {
  return flux<double>(h, hl, hr, face, dp, dm, u, dw, rem, uh, duh, nz, ny,
                      nx, dir, fold, face3d, stream);
}

extern "C" int mom6_ppm_edges_halo_f32(const float* h, const float* mask,
                                       float* hl, float* hr, int nz,
                                       int ny, int nx, int fold,
                                       int limiter, double h_min,
                                       void* stream) {
  return edges_halo<float>(h, mask, hl, hr, nz, ny, nx, fold, limiter,
                           h_min, stream);
}

extern "C" int mom6_ppm_edges_halo_f64(const double* h, const double* mask,
                                       double* hl, double* hr, int nz,
                                       int ny, int nx, int fold,
                                       int limiter, double h_min,
                                       void* stream) {
  return edges_halo<double>(h, mask, hl, hr, nz, ny, nx, fold, limiter,
                            h_min, stream);
}
