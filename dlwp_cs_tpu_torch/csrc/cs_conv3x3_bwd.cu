// Backward of the fused halo-pad + 3x3 cubed-sphere convolution for Hopper
// (sm_90a): the input cotangent (dx kernel) and the weight and bias gradients
// (dw kernel) of csrc/cs_conv3x3.cu.
//
// Replaces the TPU kernels dlwp_cs_tpu/ops/pallas_conv.py::_bwd_dx_kernel
// (launched by _dx_via_kernel) and ::_bwd_dw_kernel (launched by
// _backward_all), the reference's "fused" backward.
//
// With P the (n+2) x (n+2) padded face that the forward reads (csrc/
// cs_conv3x3.cu: P[0,:] = ext S, P[n+1,:] = ext N, P[1..n,0] = ext W[1..n],
// P[1..n,n+1] = ext E[1..n], P[1..n,1..n] = x) and g the face's weight group
// (equatorial for faces 0-3, polar for 4-5):
//
// dx kernel, per (batch item, face):
//     dxp[a,b,:] = sum_{dy,dx} K_g[dy,dx] . dout[a-dy, b-dx, :]   (a, b in 0..n+1)
//   i.e. a correlation of dout, zero-extended by 2, with the spatially
//   flipped, channel-transposed taps.  The kernel writes dxp's interior as
//   dx (B,6,n,n,Cin) and its ring straight into the ghost-strip cotangent
//   d_ext (B,6,4,n+2,Cin): rows S and N whole, corners included, columns W
//   and E at rows 1..n with both ends zero (the forward reads W/E only at
//   rows 1..n).  No padded frame goes through device memory.  f32 sums, one
//   rounding to dout's dtype, as the reference stores dxp in x's dtype.
//   Its second entry point (cs_conv3x3_dx_ring_launch, the RAW instance of
//   the same kernel) replaces tools/kernel_variants.py::_dx_aligned_kernel
//   (launched by dx_aligned): the same sums, with the ring written raw,
//   [row 0, row n+1, column 0, column n+1] of dxp, corners included at both
//   ends of the W/E columns.  Every other value it writes is the default
//   instance's, bit for bit.
//
// dw kernel:
//     dK_g[dy,dx] = sum_{b, f in g, i, j} P[i+dy, j+dx, :] (x) dout[i, j, :]
//     db_g        = sum_{b, f in g, i, j} dout[i, j, :]
//   in f32.  The reference's separate W/E ghost-column input (dcols) is a
//   Mosaic workaround: here the W/E ghost columns are staged into shared
//   memory with the face, as in the forward.  Each block sums a fixed,
//   contiguous slice of the group's (batch, face, row chunk) items for one
//   (Cin, Cout) tile and writes its partial sum; the caller adds the
//   partials in a fixed order (torch.sum).  No float atomics: two identical
//   calls give bitwise-equal gradients.
//
// What bounds them on this card: each does the forward's work,
// 2*B*6*n^2*9*Cin*Cout operations, and waits on the staging of its tiles
// into shared memory; at the flagship training batch (16) the products
// bound them.  The dx kernel runs the forward's tensor-core routine
// (cs_conv3x3_tile.cuh::tc_conv) in both dtypes: an implicit GEMM with M =
// frame pixels (row tiles of the (n+2)^2 frame), N = a Cin slice and K = 9
// x Cout, the dout rows of a Cout chunk staged once by cp.async (zero past
// the face: the zero extension by 2) and read at 9 shifted addresses, the
// flipped, transposed taps of the block's Cin slice resident in shared
// memory (straight copies of rows of k, k-contiguous, in float32 too), two
// stages, and a block walking several row tiles of one (face group, Cin
// slice).  float32 runs it as 3xTF32, as the forward does: each staged
// chunk split once into TF32 hi and lo halves, three m16n8k8 products a k
// step.  The CUDA-core instance it replaced in both dtypes (row tiles of
// the frame, Cout staged in chunks of 16 as f32, 4-pixel x 8-channel
// register tiles, the Cin slice capped at 64 by the caller) stays as a
// timing row of the kernel tools.
//
// The dw kernel is an implicit GEMM with a long K on the tensor cores:
// dK[(tap, ci), co] = sum_p P[p + shift(tap)][ci] dout[p][co]
// with M = 9 x Cin (the tap outer, Cin in groups of 16), N = Cout and K =
// the pixels of one face group (up to 16 x 4 x 48^2).  A block owns 9 taps
// x 16 or 32 Cin channels x 32 or 64 Cout channels; per item (R whole face
// rows) it stages the R + 2 padded rows of its Cin channels and the R rows
// of dout of its Cout channels, both pixel-major ([pixel][channel], padded
// by 8 so that the rows of an ldmatrix fall in distinct bank groups), by
// cp.async into two stages, the next item's while this one multiplies.
// In bfloat16 both operands come from ldmatrix .trans: A (channels x
// pixels) at 9 shifted addresses of the staged rows, one pointer per pixel
// (a k16 step may cross a face row: n = 24 and 12 are not multiples of
// 16), B (pixels x channels) from the dout rows.  Each warp owns one (Cin group of 16,
// dy): 3 m16 tiles (dx = 0..2) x 4 n8 tiles, mma.sync.m16n8k16 with bf16
// in and f32 sums.  db comes from the same products: a ones fragment as A
// (db = 1^T dout), issued round-robin by the warps of the blocks of the
// first Cin tile and added across warps in a fixed order.  A tensor-core
// sum is not rounded as an FMA is, so each item's products go into fresh
// fragments, added into the f32 sums with ordinary adds: no chain longer
// than one item's k16 steps.  float32 (cs_conv3x3_dw_tf32_kernel) keeps
// these blocks, warps and items as 3xTF32 on m16n8k8: 32-bit fragment
// loads in place of ldmatrix, each staged item split once into hi and lo
// halves (a third stage-sized buffer), three products a k8 step and db as
// 1.hi + 1.lo (see the kernel).  The CUDA-core instance it replaced in
// both dtypes (a 4 (Cin) x 8 (Cout) register tile per (thread, tap), one
// float4 of P and two of dout read from shared memory per 32 FMAs) stays as
// a timing row of the kernel tools.  The partials (nsplit x 2 x 9 x Cin x
// Cout floats) stay under 20 MiB at the flagship's shapes.  wgmma and TMA
// are left for later work.
//
// Layouts (channels last, all contiguous):
//   x    (B, 6, n, n, Cin)   ext (B, 6, 4, n+2, Cin)   dout (B, 6, n, n, Cout)
//   k_*  (3, 3, Cin, Cout) HWIO
//   dx   (B, 6, n, n, Cin)   d_ext (B, 6, 4, n+2, Cin)
//   dk_part (nsplit, 2, 3, 3, Cin, Cout) f32   db_part (nsplit, 2, Cout) f32

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "cs_conv3x3_tile.cuh"

namespace {

using cs3x3::bf16;
using cs3x3::TcGeom;
using cs3x3::TcTile;

constexpr int PX = 4;             // dx: frame pixels per thread, along a row
constexpr int CO = 8;             // dx: Cin channels per thread
constexpr int CC = 16;            // dx: Cout channels staged per chunk
constexpr int MAX_THREADS = 256;  // dx: threads per block, all staging
constexpr int STAGE = 4;          // staging loads in flight per thread

constexpr int DW_CI = 16;  // dw: Cin channels per block (4 quads)
constexpr int DW_CO = 32;  // dw: Cout channels per block (4 octets)
constexpr int DW_THREADS = 9 * (DW_CI / 4) * (DW_CO / 8);  // tap x quad x octet

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct DxGeom {
  int n, m;     // face size; frame size m = n + 2
  int cin;      // output channels (x's)
  int cout;     // reduced channels (dout's)
  int h;        // frame rows per tile
  int cs;       // Cin channels per block (a power of two >= CO)
  int cs_log2;
  int nslices;  // Cin slices
  int ncg;      // column groups of PX pixels per frame row
  int nog;      // channel groups of CO per slice
  int wp;       // staged tile width: ncg * PX + 2 >= n + 4
  int plane;    // shared-memory pitch of one staged channel (odd)
};

// Grid (frame-row tiles * Cin slices, 6, B).  Staged tile row pr, column pc
// is dout[a0 + pr - 2, pc - 2] (zero outside the face), so frame pixel
// (a, b) reads staged rows a - a0 .. +2 and columns b .. b + 2, each with the
// flipped tap K[2 - ey, 2 - ex].
template <typename T, bool RAW>
__global__ void __launch_bounds__(MAX_THREADS) cs_conv3x3_dx_kernel(
    const T* __restrict__ dout, const T* __restrict__ keq, const T* __restrict__ kpo,
    T* __restrict__ dx, T* __restrict__ dext, DxGeom g) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                  // [CC][plane], row-major (h+2) x wp
  float* wts = smem + CC * g.plane;    // [9][CC][cs]

  const int n = g.n, m = g.m, cin = g.cin, cout = g.cout;
  const int a0 = (blockIdx.x / g.nslices) * g.h;
  const int ci0 = (blockIdx.x % g.nslices) * g.cs;
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const T* __restrict__ k = f < 4 ? keq : kpo;
  const T* __restrict__ df = dout + face * n * n * cout;

  const int per_row = g.ncg * g.nog;
  const bool active = threadIdx.x < g.h * per_row;
  const int rr = threadIdx.x / per_row;
  const int cg = (threadIdx.x % per_row) / g.nog;
  const int c_lo = (threadIdx.x % g.nog) * CO;
  const int j0 = cg * PX;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.f;

  const int ntile = (g.h + 2) * g.wp * CC;
  const int nw = 9 * CC * g.cs;
  for (int c0 = 0; c0 < cout; c0 += CC) {
    __syncthreads();  // the previous chunk has been consumed
    // ---- zero-extended dout tile; element idx = cell * CC + cl ----
    for (int base = threadIdx.x; base < ntile; base += STAGE * MAX_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        const int cell = idx / CC;
        const int dr = a0 + cell / g.wp - 2;
        const int dc = cell % g.wp - 2;
        const int co = c0 + idx % CC;
        v[u] = (idx < ntile && co < cout && dr >= 0 && dr < n && dc >= 0 && dc < n)
                   ? to_f32(df[((long long)dr * n + dc) * cout + co])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        if (idx < ntile) tile[(idx % CC) * g.plane + idx / CC] = v[u];
      }
    }
    // ---- flipped, transposed taps: wts[(tap * CC + cl) * cs + c] =
    // K[2 - ey, 2 - ex][ci0 + c][c0 + cl] with tap = ey * 3 + ex ----
    for (int base = threadIdx.x; base < nw; base += STAGE * MAX_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        const int ci = ci0 + (idx & (g.cs - 1));
        const int t = idx >> g.cs_log2;
        const int co = c0 + t % CC;
        const int tap = t / CC;
        v[u] = (idx < nw && ci < cin && co < cout)
                   ? to_f32(k[((long long)(8 - tap) * cin + ci) * cout + co])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        if (idx < nw) wts[idx] = v[u];
      }
    }
    __syncthreads();
    if (active) {
      const int cmax = min(CC, cout - c0);
      for (int cl = 0; cl < cmax; ++cl) {
        const float* tp = tile + cl * g.plane + rr * g.wp + j0;
#pragma unroll
        for (int ey = 0; ey < 3; ++ey) {
          float in[PX + 2];
#pragma unroll
          for (int q = 0; q < PX + 2; ++q) in[q] = tp[ey * g.wp + q];
#pragma unroll
          for (int ex = 0; ex < 3; ++ex) {
            const float4* w4 = reinterpret_cast<const float4*>(
                wts + ((ey * 3 + ex) * CC + cl) * g.cs + c_lo);
            const float4 wa = w4[0], wb = w4[1];
            const float w[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int o = 0; o < CO; ++o) acc[p][o] = fmaf(in[p + ex], w[o], acc[p][o]);
          }
        }
      }
    }
  }
  const int a = a0 + rr;
  if (!active || a >= m) return;
  T* __restrict__ ef = dext + face * 4 * m * cin;
  const T zero = from_f32<T>(0.f);
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const int ci = ci0 + c_lo + o;
    if (ci >= cin) break;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int b = j0 + p;
      if (b >= m) continue;
      const T val = from_f32<T>(acc[p][o]);
      if (a >= 1 && a <= n && b >= 1 && b <= n) {
        dx[((face * n + a - 1) * n + b - 1) * cin + ci] = val;
      } else if (a == 0 || a == n + 1) {
        // S / N ghost row, corners included; a corner also zeroes the end
        // of its W / E strip, which the forward never reads (RAW: the
        // corner itself, as the raw ring holds it)
        ef[((long long)(a == 0 ? 0 : 1) * m + b) * cin + ci] = val;
        if (b == 0) ef[(2LL * m + a) * cin + ci] = RAW ? val : zero;
        if (b == m - 1) ef[(3LL * m + a) * cin + ci] = RAW ? val : zero;
      } else {
        ef[((long long)(b == 0 ? 2 : 3) * m + a) * cin + ci] = val;  // W / E column
      }
    }
  }
}

struct DwGeom {
  int n, cin, cout, batch;
  int rows;    // face rows staged per item
  int nchunk;  // row chunks per face
  int nsplit;  // reduction slices per face group
  int ncib;    // Cin blocks of DW_CI
};

// Grid (Cin blocks * Cout blocks, nsplit, 2 face groups); DW_THREADS threads,
// thread t owns tap t / 16, Cin quad (t % 16) / 4 and Cout octet t % 4.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS) cs_conv3x3_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ ext, const T* __restrict__ dout,
    float* __restrict__ dk_part, float* __restrict__ db_part, DwGeom g) {
  extern __shared__ __align__(16) float smem[];
  const int n = g.n, cin = g.cin, cout = g.cout, R = g.rows, pw = n + 2;
  float* ps = smem;                          // [(R+2) * pw][DW_CI]: P rows
  float* ds = smem + (R + 2) * pw * DW_CI;   // [R * n][DW_CO]: dout rows

  const int cib = blockIdx.x % g.ncib;
  const int ci0 = cib * DW_CI;
  const int co0 = (blockIdx.x / g.ncib) * DW_CO;
  const int s = blockIdx.y;
  const int grp = blockIdx.z;
  const int nf = grp == 0 ? 4 : 2;
  const int f_base = grp == 0 ? 0 : 4;
  const long long items = (long long)g.batch * nf * g.nchunk;
  const long long lo = items * s / g.nsplit;
  const long long hi = items * (s + 1) / g.nsplit;

  const int tid = threadIdx.x;
  const int tap = tid / 16;
  const int dy = tap / 3, dxo = tap % 3;
  const int ciq = (tid % 16) / 4;
  const int coo = tid % 4;
  const bool do_db = tap == 0 && ciq == 0 && cib == 0;  // 4 threads: 32 Cout

  float acc[4][8];
  float dacc[8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[a][o] = 0.f;
#pragma unroll
  for (int o = 0; o < 8; ++o) dacc[o] = 0.f;

  const int np = (R + 2) * pw * DW_CI;
  const int nd = R * n * DW_CO;
  for (long long it = lo; it < hi; ++it) {
    const int chunk = (int)(it % g.nchunk);
    const long long bf = it / g.nchunk;  // batch item * nf + face in group
    const long long face = (bf / nf) * 6 + f_base + (int)(bf % nf);
    const int r0 = chunk * R;
    const T* __restrict__ xf = x + face * n * n * cin;
    const T* __restrict__ ef = ext + face * 4 * pw * cin;
    const T* __restrict__ df = dout + face * n * n * cout;
    __syncthreads();  // the previous item has been consumed
    // ---- P rows r0 .. r0 + R + 1 (padded coordinates), zero past row n+1 ----
    for (int base = tid; base < np; base += STAGE * DW_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        const int cell = idx / DW_CI;
        const int ci = ci0 + idx % DW_CI;
        const int pc = cell % pw;
        const int q = r0 + cell / pw;
        v[u] = 0.f;
        if (idx < np && ci < cin && q <= n + 1) {
          long long off;
          if (q == 0) off = (long long)pc * cin;                          // S, corners included
          else if (q == n + 1) off = (1LL * pw + pc) * cin;               // N, corners included
          else if (pc == 0) off = (2LL * pw + q) * cin;                   // W ghost column
          else if (pc == n + 1) off = (3LL * pw + q) * cin;               // E ghost column
          else off = -1;
          v[u] = off >= 0 ? to_f32(ef[off + ci])
                          : to_f32(xf[((long long)(q - 1) * n + pc - 1) * cin + ci]);
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        if (idx < np) ps[idx] = v[u];
      }
    }
    // ---- dout rows r0 .. r0 + R - 1, zero past row n - 1 ----
    for (int base = tid; base < nd; base += STAGE * DW_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        const int cell = idx / DW_CO;
        const int co = co0 + idx % DW_CO;
        const int r = r0 + cell / n;
        v[u] = (idx < nd && co < cout && r < n)
                   ? to_f32(df[((long long)r * n + cell % n) * cout + co])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        if (idx < nd) ds[idx] = v[u];
      }
    }
    __syncthreads();
    const int rmax = min(R, n - r0);
    for (int r = 0; r < rmax; ++r) {
      const float* prow = ps + ((r + dy) * pw + dxo) * DW_CI + ciq * 4;
      const float* drow = ds + r * n * DW_CO + coo * 8;
      for (int j = 0; j < n; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + j * DW_CI);
        const float4 da = *reinterpret_cast<const float4*>(drow + j * DW_CO);
        const float4 db = *reinterpret_cast<const float4*>(drow + j * DW_CO + 4);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dv[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[a][o] = fmaf(pv[a], dv[o], acc[a][o]);
        if (do_db) {
#pragma unroll
          for (int o = 0; o < 8; ++o) dacc[o] += dv[o];
        }
      }
    }
  }
  // every block writes its whole tile, zeros for an empty slice
  float* __restrict__ out = dk_part + ((long long)(s * 2 + grp) * 9 + tap) * cin * cout;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ci = ci0 + ciq * 4 + a;
    if (ci >= cin) break;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int co = co0 + coo * 8 + o;
      if (co < cout) out[(long long)ci * cout + co] = acc[a][o];
    }
  }
  if (do_db) {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int co = co0 + coo * 8 + o;
      if (co < cout) db_part[((long long)s * 2 + grp) * cout + co] = dacc[o];
    }
  }
}

// ---- the dw kernel on the tensor cores (bfloat16) -------------------------

constexpr int DWT_PAD = 8;            // elements after each staged cell's channels
constexpr int DWT_MAX_THREADS = 192;  // 6 warps

struct DwTcGeom {
  int n, cin, cout, batch;
  int esize;      // bytes per element: 2 (bfloat16) or 4 (float32)
  int rows;       // face rows per item (R)
  int nchunk;     // items per face: ceil(n / R)
  int nsplit;     // K slices per face group
  int threads;    // 96 cig ng: warps (Cin group, dy) x Cout groups
  int ncib, ncob; // Cin and Cout tiles
  int kpx;        // pixels per k step: 16 (m16n8k16) or 8 (m16n8k8.tf32)
  int steps;      // k steps per item: ceil(R n / kpx)
  int pw;         // padded row: n + 2 cells
  int pstage;     // elements of the staged P rows: (R + 2) pw (16 cig + 8)
  int dstage;     // elements of the staged dout rows: kpx steps (32 ng + 8)
  int vec, dvec;  // P / dout staging: 16-byte (1) or 8-byte (2) async copies, or loads
};

// Fills g for blocks of 16 cig Cin x 32 ng Cout channels of esize-byte
// elements; false on sizes the kernel cannot take.  The host plan
// (ops/hopper_conv.py::dw_tc_geom) computes the same numbers.
inline bool make_dw_tc_geom(DwTcGeom& g, int batch, int n, int cin, int cout, int rows,
                            int nsplit, int cig, int ng, int esize) {
  if (batch < 1 || n < 1 || cin < 1 || cout < 1 || rows < 1 || rows > n || nsplit < 1 ||
      nsplit > 65535 || (cig != 1 && cig != 2) || (ng != 1 && ng != 2) || cig * ng > 2 ||
      (esize != 2 && esize != 4))
    return false;
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.batch = batch;
  g.esize = esize;
  g.rows = rows;
  g.nchunk = (n + rows - 1) / rows;
  g.nsplit = nsplit;
  g.threads = 96 * cig * ng;
  g.ncib = (cin + 16 * cig - 1) / (16 * cig);
  g.ncob = (cout + 32 * ng - 1) / (32 * ng);
  g.kpx = esize == 4 ? 8 : 16;
  g.steps = (rows * n + g.kpx - 1) / g.kpx;
  g.pw = n + 2;
  g.pstage = (rows + 2) * g.pw * (16 * cig + DWT_PAD);
  g.dstage = g.kpx * g.steps * (32 * ng + DWT_PAD);
  g.vec = 0;
  g.dvec = 0;
  return (long long)g.ncib * g.ncob <= 0x7fffffffLL;
}

// two stages and, in float32, the lo halves of the one in use
inline size_t dw_tc_smem_bytes(const DwTcGeom& g) {
  return (size_t)g.esize * (g.esize == 4 ? 3 : 2) * ((size_t)g.pstage + g.dstage);
}

// cells x width channels from channel c0 into S (cell pitch `pitch`):
// cell(c) is the cell's first channel in device memory, or nullptr for a
// zero cell; zero past C channels.  vec: 16-byte or 8-byte async copies
// (C a multiple of 16 or 8 bytes' worth of channels, aligned), else
// ordinary loads.
template <typename T, typename CellFn>
__device__ __forceinline__ void dw_stage(T* S, int pitch, int cells, int width, int c0, int C,
                                         int vec, int threads, const T* any,
                                         const CellFn& cell) {
  constexpr int E16 = 16 / sizeof(T), E8 = 8 / sizeof(T);  // channels per 16 / 8 bytes
  if (vec == 1) {
    const int gpc = width / E16;
    for (int u = threadIdx.x; u < cells * gpc; u += threads) {
      const int c = u / gpc, grp = u - c * gpc;
      const int ch = c0 + grp * E16;
      const T* p = ch < C ? cell(c) : nullptr;
      cs3x3::cp_async16(S + c * pitch + grp * E16, p ? p + ch : any, p ? 16 : 0);
    }
  } else if (vec == 2) {
    const int gpc = width / E8;
    for (int u = threadIdx.x; u < cells * gpc; u += threads) {
      const int c = u / gpc, grp = u - c * gpc;
      const int ch = c0 + grp * E8;
      const T* p = ch < C ? cell(c) : nullptr;
      cs3x3::cp_async8(S + c * pitch + grp * E8, p ? p + ch : any, p ? 8 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < cells * width; u += threads) {
      const int c = u / width, e = u - c * width;
      const T* p = c0 + e < C ? cell(c) : nullptr;
      S[c * pitch + e] = p ? p[c0 + e] : from_f32<T>(0.f);
    }
  }
}

// Grid (Cin tiles * Cout tiles, nsplit, 2 face groups), 96 CIG NG threads:
// warp w owns (Cin group, dy) = ((w % WM) / 3, (w % WM) % 3) and Cout
// channels 32 (w / WM) .. + 31 of the block's tile.
template <int CIG, int NG>
__global__ void __launch_bounds__(DWT_MAX_THREADS, 2) cs_conv3x3_dw_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ext, const bf16* __restrict__ dout,
    float* __restrict__ dk_part, float* __restrict__ db_part, DwTcGeom g) {
  constexpr int WM = 3 * CIG;
  constexpr int PPS = 16 * CIG + DWT_PAD, DPS = 32 * NG + DWT_PAD;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* St = reinterpret_cast<bf16*>(dw_smem);  // two stages of [P rows | dout rows]
  const int stage = g.pstage + g.dstage;
  const int n = g.n, pw = g.pw, cin = g.cin, cout = g.cout;

  const int cib = blockIdx.x % g.ncib;
  const int ci0 = cib * 16 * CIG;
  const int co0 = (blockIdx.x / g.ncib) * 32 * NG;
  const int s = blockIdx.y, grp = blockIdx.z;
  const int nf = grp == 0 ? 4 : 2, f_base = grp == 0 ? 0 : 4;
  const long long items = (long long)g.batch * nf * g.nchunk;
  const long long lo = items * s / g.nsplit, hi = items * (s + 1) / g.nsplit;
  const bool do_db = cib == 0;  // block-uniform

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm_i = warp % WM, wn_i = warp / WM;
  const int cg = wm_i / 3, dy = wm_i % 3;
  const int gid = lane >> 2, tig = lane & 3;
  // A = P^T by ldmatrix .trans: this lane's pixel in a k16 step, channel offset
  const int a_px = (lane & 7) + ((lane >> 4) << 3);
  const int a_ch = cg * 16 + ((lane >> 3) & 1) * 8;
  // B = dout by ldmatrix .trans: this lane's pixel row and channel offset
  const int b_px = lane & 15;
  const int b_ch = wn_i * 32 + (lane >> 4) * 8;
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};

  // item it (batch item, face of the group, row chunk) into stage S
  const auto stage_item = [&](long long it, bf16* S) {
    const int r0 = (int)(it % g.nchunk) * g.rows;
    const long long bf = it / g.nchunk;
    const long long face = (bf / nf) * 6 + f_base + (int)(bf % nf);
    const bf16* __restrict__ xf = x + face * n * n * cin;
    const bf16* __restrict__ ef = ext + face * 4 * pw * cin;
    const bf16* __restrict__ df = dout + (face * n + r0) * n * cout;
    // padded rows r0 .. r0 + R + 1: S, N rows (corners included), W, E
    // columns from ext, the interior from x, zero past row n + 1
    dw_stage(S, PPS, (g.rows + 2) * pw, 16 * CIG, ci0, cin, g.vec, g.threads, x,
             [&](int c) -> const bf16* {
               const int q = r0 + c / pw, pc = c % pw;
               if (q > n + 1) return nullptr;
               if (q == 0) return ef + (long long)pc * cin;
               if (q == n + 1) return ef + (1LL * pw + pc) * cin;
               if (pc == 0) return ef + (2LL * pw + q) * cin;
               if (pc == n + 1) return ef + (3LL * pw + q) * cin;
               return xf + ((long long)(q - 1) * n + pc - 1) * cin;
             });
    // the item's pixels of dout, zero past its rows and past row n - 1
    const int valid = min(g.rows, n - r0) * n;
    dw_stage(S + g.pstage, DPS, 16 * g.steps, 32 * NG, co0, cout, g.dvec, g.threads, dout,
             [&](int q) -> const bf16* { return q < valid ? df + (long long)q * cout : nullptr; });
  };

  float sum[3][4][4], dsum[4][2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[dx][nt][r] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) dsum[nt][0] = dsum[nt][1] = 0.f;

  if (lo < hi) stage_item(lo, St);
  cs3x3::cp_async_commit();
  int buf = 0;
  for (long long it = lo; it < hi; ++it) {
    cs3x3::cp_async_wait_all();
    __syncthreads();  // item it has landed in buf; the other stage is consumed
    if (it + 1 < hi) stage_item(it + 1, St + (buf ^ 1) * stage);
    cs3x3::cp_async_commit();
    const bf16* P = St + buf * stage + dy * pw * PPS + a_ch;
    const bf16* D = St + buf * stage + g.pstage + b_px * DPS + b_ch;
    float frag[3][4][4], dfrag[4][4];  // this item's products
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        frag[0][nt][r] = frag[1][nt][r] = frag[2][nt][r] = 0.f;
        dfrag[nt][r] = 0.f;
      }
    int i = a_px / n, j = a_px - (a_px / n) * n;  // this lane's pixel of step 0
    for (int st = 0; st < g.steps; ++st) {
      const int cell = i < g.rows ? i * pw + j : 0;  // past the item: a zero dout row
      uint32_t a[3][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) cs3x3::ldsm_x4_t(a[dx], P + (cell + dx) * PPS);
      uint32_t b[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        cs3x3::ldsm_x4_t(r, D + st * 16 * DPS + jj * 16);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) cs3x3::mma_bf16(frag[dx][nt], a[dx], b[nt][0], b[nt][1]);
      if (do_db && st % WM == wm_i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) cs3x3::mma_bf16(dfrag[nt], ones, b[nt][0], b[nt][1]);
      }
      j += 16;
      while (j >= n) {
        j -= n;
        ++i;
      }
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[dx][nt][r] += frag[dx][nt][r];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      dsum[nt][0] += dfrag[nt][0];
      dsum[nt][1] += dfrag[nt][1];
    }
    buf ^= 1;
  }
  cs3x3::cp_async_wait_all();
  __syncthreads();  // the stages are free: the db reduction below reuses them

  // every block writes its whole tile, zeros for an empty slice: row gid
  // (+8) of each m16 tile is Cin channel cg * 16 + gid (+8), columns 2 tig, +1
  float* __restrict__ out = dk_part + (long long)(s * 2 + grp) * 9 * cin * cout;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int tap = dy * 3 + dx;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + cg * 16 + gid + half * 8;
      if (ci >= cin) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + wn_i * 32 + nt * 8 + 2 * tig;
        float* o = out + ((long long)tap * cin + ci) * cout + co;
        const float v0 = sum[dx][nt][2 * half], v1 = sum[dx][nt][2 * half + 1];
        if (co + 1 < cout && cout % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (co < cout) o[0] = v0;
          if (co + 1 < cout) o[1] = v1;
        }
      }
    }
  }
  if (do_db) {
    // every row of a ones product is db: the warps' sums of row gid = 0,
    // added over the warps along M in order
    float* red = reinterpret_cast<float*>(dw_smem);  // [WM][32 NG]
    if (gid == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        red[wm_i * 32 * NG + wn_i * 32 + nt * 8 + 2 * tig] = dsum[nt][0];
        red[wm_i * 32 * NG + wn_i * 32 + nt * 8 + 2 * tig + 1] = dsum[nt][1];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 32 * NG; c += blockDim.x) {
      float v = red[c];
      for (int w = 1; w < WM; ++w) v += red[w * 32 * NG + c];
      if (co0 + c < cout) db_part[((long long)s * 2 + grp) * cout + co0 + c] = v;
    }
  }
}

// ---- the dw kernel on the tensor cores (float32, 3xTF32) -----------------

// The bfloat16 kernel's blocks, warps and items, with K steps of 8 pixels
// (mma.sync.m16n8k8.tf32).  ldmatrix moves 16-bit elements, so each
// fragment element is one 32-bit shared load: A (channels x pixels) holds
// channel gid (+8) and pixel tig (+4) of the lane, B (pixels x channels)
// pixel tig (+4) and channel gid.  Row gid of an m16 tile is channel
// 2 gid of its 16 and row gid + 8 channel 2 gid + 1, and column gid of the
// n8 tiles 2jj and 2jj + 1 is channel 16 jj + 2 gid and 2 gid + 1: so a
// lane's two channels of A, and of B for two n8 tiles, are one float2,
// and its sums for one Cin channel are 4 consecutive Cout channels (one
// float4 store).  Cells of 16 cig + 8 (P) and 32 ng + 8 (dout) floats, 8
// or 24 words mod 32, put a half-warp's float2 loads on 32 banks.  Each
// staged item is split once when it has landed (hi in place, lo into a
// third stage-sized buffer); each k step issues lo.hi, hi.lo and hi.hi
// into the item's fresh fragments, and db takes 1.hi + 1.lo of dout (1 is
// exact in TF32).
template <int CIG, int NG>
__global__ void __launch_bounds__(DWT_MAX_THREADS, 1) cs_conv3x3_dw_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ ext, const float* __restrict__ dout,
    float* __restrict__ dk_part, float* __restrict__ db_part, DwTcGeom g) {
  constexpr int WM = 3 * CIG;
  constexpr int PPS = 16 * CIG + DWT_PAD, DPS = 32 * NG + DWT_PAD;
  constexpr int PG = PPS / 4 - 2, DG = DPS / 4 - 2;  // float4 groups of a cell's channels
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* St = reinterpret_cast<float*>(dw_smem);  // two stages of [P rows | dout rows]
  const int stage = g.pstage + g.dstage;
  float* Lo = St + 2 * stage;  // the lo halves of the stage in use
  const int n = g.n, pw = g.pw, cin = g.cin, cout = g.cout;

  const int cib = blockIdx.x % g.ncib;
  const int ci0 = cib * 16 * CIG;
  const int co0 = (blockIdx.x / g.ncib) * 32 * NG;
  const int s = blockIdx.y, grp = blockIdx.z;
  const int nf = grp == 0 ? 4 : 2, f_base = grp == 0 ? 0 : 4;
  const long long items = (long long)g.batch * nf * g.nchunk;
  const long long first = items * s / g.nsplit, last = items * (s + 1) / g.nsplit;
  const bool do_db = cib == 0;  // block-uniform

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm_i = warp % WM, wn_i = warp / WM;
  const int cg = wm_i / 3, dy = wm_i % 3;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t ones[4] = {0x3F800000u, 0x3F800000u, 0x3F800000u, 0x3F800000u};

  // item it (batch item, face of the group, row chunk) into stage S
  const auto stage_item = [&](long long it, float* S) {
    const int r0 = (int)(it % g.nchunk) * g.rows;
    const long long bf = it / g.nchunk;
    const long long face = (bf / nf) * 6 + f_base + (int)(bf % nf);
    const float* __restrict__ xf = x + face * n * n * cin;
    const float* __restrict__ ef = ext + face * 4 * pw * cin;
    const float* __restrict__ df = dout + (face * n + r0) * n * cout;
    dw_stage(S, PPS, (g.rows + 2) * pw, 16 * CIG, ci0, cin, g.vec, g.threads, x,
             [&](int c) -> const float* {
               const int q = r0 + c / pw, pc = c % pw;
               if (q > n + 1) return nullptr;
               if (q == 0) return ef + (long long)pc * cin;
               if (q == n + 1) return ef + (1LL * pw + pc) * cin;
               if (pc == 0) return ef + (2LL * pw + q) * cin;
               if (pc == n + 1) return ef + (3LL * pw + q) * cin;
               return xf + ((long long)(q - 1) * n + pc - 1) * cin;
             });
    const int valid = min(g.rows, n - r0) * n;
    dw_stage(S + g.pstage, DPS, 8 * g.steps, 32 * NG, co0, cout, g.dvec, g.threads, dout,
             [&](int q) -> const float* { return q < valid ? df + (long long)q * cout : nullptr; });
  };
  // the landed stage S: hi in place, lo into Lo at the same offsets
  const auto split = [&](float* S) {
    const int pn = (g.rows + 2) * pw * PG, dn = 8 * g.steps * DG;
    for (int u = threadIdx.x; u < pn + dn; u += g.threads) {
      int off;
      if (u < pn) {
        const int c = u / PG;
        off = c * PPS + (u - c * PG) * 4;
      } else {
        const int q = (u - pn) / DG;
        off = g.pstage + q * DPS + (u - pn - q * DG) * 4;
      }
      uint4 v = *reinterpret_cast<const uint4*>(S + off), l;
      cs3x3::split_tf32(v.x, v.x, l.x);
      cs3x3::split_tf32(v.y, v.y, l.y);
      cs3x3::split_tf32(v.z, v.z, l.z);
      cs3x3::split_tf32(v.w, v.w, l.w);
      *reinterpret_cast<uint4*>(S + off) = v;
      *reinterpret_cast<uint4*>(Lo + off) = l;
    }
  };

  float sum[3][4][4], dsum[4][2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[dx][nt][r] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) dsum[nt][0] = dsum[nt][1] = 0.f;

  if (first < last) stage_item(first, St);
  cs3x3::cp_async_commit();
  int buf = 0;
  for (long long it = first; it < last; ++it) {
    cs3x3::cp_async_wait_all();
    __syncthreads();  // item it has landed in buf; the other stage and Lo are consumed
    if (it + 1 < last) stage_item(it + 1, St + (buf ^ 1) * stage);
    cs3x3::cp_async_commit();
    split(St + buf * stage);
    __syncthreads();
    // this lane's A channels (2 gid, +1) at the warp's dy, and B channels
    // (2 gid, +1 of each 16) at pixel tig; lo_off: the lo halves
    const float* P = St + buf * stage + dy * pw * PPS + cg * 16 + 2 * gid;
    const float* D = St + buf * stage + g.pstage + tig * DPS + wn_i * 32 + 2 * gid;
    const int lo_off = (int)(Lo - (St + buf * stage));
    float frag[3][4][4], dfrag[4][4];  // this item's products
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        frag[0][nt][r] = frag[1][nt][r] = frag[2][nt][r] = 0.f;
        dfrag[nt][r] = 0.f;
      }
    // this lane's pixels tig and tig + 4 of step 0, as (face row, column)
    int i0 = tig / n, j0 = tig - (tig / n) * n;
    int i1 = (tig + 4) / n, j1 = tig + 4 - ((tig + 4) / n) * n;
    for (int st = 0; st < g.steps; ++st) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* d = D + st * 8 * DPS + jj * 16;
        const float2 h0 = *reinterpret_cast<const float2*>(d);
        const float2 h1 = *reinterpret_cast<const float2*>(d + 4 * DPS);
        const float2 l0 = *reinterpret_cast<const float2*>(d + lo_off);
        const float2 l1 = *reinterpret_cast<const float2*>(d + lo_off + 4 * DPS);
        bh[2 * jj][0] = __float_as_uint(h0.x);
        bh[2 * jj + 1][0] = __float_as_uint(h0.y);
        bh[2 * jj][1] = __float_as_uint(h1.x);
        bh[2 * jj + 1][1] = __float_as_uint(h1.y);
        bl[2 * jj][0] = __float_as_uint(l0.x);
        bl[2 * jj + 1][0] = __float_as_uint(l0.y);
        bl[2 * jj][1] = __float_as_uint(l1.x);
        bl[2 * jj + 1][1] = __float_as_uint(l1.y);
      }
      // past the item: a zero dout row
      const int c0 = i0 < g.rows ? i0 * pw + j0 : 0, c1 = i1 < g.rows ? i1 * pw + j1 : 0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* p0 = P + (c0 + dx) * PPS;
        const float* p1 = P + (c1 + dx) * PPS;
        const float2 h0 = *reinterpret_cast<const float2*>(p0);
        const float2 h1 = *reinterpret_cast<const float2*>(p1);
        const float2 l0 = *reinterpret_cast<const float2*>(p0 + lo_off);
        const float2 l1 = *reinterpret_cast<const float2*>(p1 + lo_off);
        const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h0.y),
                                __float_as_uint(h1.x), __float_as_uint(h1.y)};
        const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l0.y),
                                __float_as_uint(l1.x), __float_as_uint(l1.y)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          cs3x3::mma_tf32(frag[dx][nt], al, bh[nt][0], bh[nt][1]);
          cs3x3::mma_tf32(frag[dx][nt], ah, bl[nt][0], bl[nt][1]);
          cs3x3::mma_tf32(frag[dx][nt], ah, bh[nt][0], bh[nt][1]);
        }
      }
      if (do_db && st % WM == wm_i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          cs3x3::mma_tf32(dfrag[nt], ones, bl[nt][0], bl[nt][1]);
          cs3x3::mma_tf32(dfrag[nt], ones, bh[nt][0], bh[nt][1]);
        }
      }
      j0 += 8;
      while (j0 >= n) {
        j0 -= n;
        ++i0;
      }
      j1 += 8;
      while (j1 >= n) {
        j1 -= n;
        ++i1;
      }
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[dx][nt][r] += frag[dx][nt][r];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      dsum[nt][0] += dfrag[nt][0];
      dsum[nt][1] += dfrag[nt][1];
    }
    buf ^= 1;
  }
  cs3x3::cp_async_wait_all();
  __syncthreads();  // the stages are free: the db reduction below reuses them

  // every block writes its whole tile, zeros for an empty slice: row gid
  // (+8) of each m16 tile is Cin channel 2 gid (+1) of the warp's 16; a
  // lane holds Cout channels 16 jj + 4 tig .. + 3 of its warp's 32
  float* __restrict__ out = dk_part + (long long)(s * 2 + grp) * 9 * cin * cout;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int tap = dy * 3 + dx;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + cg * 16 + 2 * gid + half;
      if (ci >= cin) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int co = co0 + wn_i * 32 + jj * 16 + 4 * tig;
        float* o = out + ((long long)tap * cin + ci) * cout + co;
        const float v[4] = {sum[dx][2 * jj][2 * half], sum[dx][2 * jj + 1][2 * half],
                            sum[dx][2 * jj][2 * half + 1], sum[dx][2 * jj + 1][2 * half + 1]};
        if (co + 3 < cout && cout % 4 == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (co + e < cout) o[e] = v[e];
        }
      }
    }
  }
  if (do_db) {
    // every row of a ones product is db: the warps' sums of row gid = 0,
    // added over the warps along M in order
    float* red = reinterpret_cast<float*>(dw_smem);  // [WM][32 NG]
    if (gid == 0) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* r = red + wm_i * 32 * NG + wn_i * 32 + jj * 16 + 4 * tig + e;
          r[0] = dsum[2 * jj + e][0];
          r[2] = dsum[2 * jj + e][1];
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 32 * NG; c += blockDim.x) {
      float v = red[c];
      for (int w = 1; w < WM; ++w) v += red[w * 32 * NG + c];
      if (co0 + c < cout) db_part[((long long)s * 2 + grp) * cout + co0 + c] = v;
    }
  }
}

// The dx kernel's outputs, f32 sums rounded once to T: frame pixel (a, b)
// = (r0 + i, j), as the CUDA-core instance writes them.
template <typename T, bool RAW>
struct DxEpi {
  T* __restrict__ dx;
  T* __restrict__ dext;
  int n, cin;
  __device__ __forceinline__ void put(long long face, int a, int b, int ci, float v) const {
    if (ci >= cin) return;
    const int m = n + 2;
    const T val = from_f32<T>(v);
    T* __restrict__ ef = dext + face * 4 * m * cin;
    if (a >= 1 && a <= n && b >= 1 && b <= n) {
      dx[((face * n + a - 1) * n + b - 1) * cin + ci] = val;
    } else if (a == 0 || a == n + 1) {
      ef[((long long)(a == 0 ? 0 : 1) * m + b) * cin + ci] = val;
      const T zero = from_f32<T>(0.f);
      if (b == 0) ef[(2LL * m + a) * cin + ci] = RAW ? val : zero;
      if (b == m - 1) ef[(3LL * m + a) * cin + ci] = RAW ? val : zero;
    } else {
      ef[((long long)(b == 0 ? 2 : 3) * m + a) * cin + ci] = val;  // W / E column
    }
  }
  __device__ __forceinline__ void store(const TcTile& t, int i, int j, int c, float v0,
                                        float v1) const {
    const int a = t.r0 + i;
    if (a >= 1 && a <= n && j >= 1 && j <= n && c + 1 < cin && cin % 2 == 0) {
      // an interior pixel: both channels in one store
      T* o = dx + ((t.face * n + a - 1) * n + j - 1) * cin + c;
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      return;
    }
    put(t.face, a, j, c, v0);
    put(t.face, a, j, c + 1, v1);
  }
};

template <typename T, int NW, int KC, bool RAW>
__global__ void __launch_bounds__(cs3x3::TC_MAX_THREADS) cs_conv3x3_dx_tc_kernel(
    const T* __restrict__ dout, const T* __restrict__ keq, const T* __restrict__ kpo,
    T* __restrict__ dx, T* __restrict__ dext, TcGeom g, int batch) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const cs3x3::DxSrc<T> src{dout, g.cols - 2, g.kch};
  const DxEpi<T, RAW> epi{dx, dext, g.cols - 2, g.nch};
  cs3x3::GridWalk walk(g, batch);
  cs3x3::tc_conv<T, NW, KC, true>(g, src, walk, epi, keq, kpo, tc_smem);
}

// Lets a kernel take up to the card's opt-in shared memory per block; set
// once per kernel and device, not at every launch.
template <auto Kernel>
cudaError_t allow_large_smem(int device) {
  static std::atomic<unsigned long long> done{0};  // bit d: done on device d
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, bool RAW>
cudaError_t launch_dx(const void* dout, const void* keq, const void* kpo, void* dx,
                      void* dext, int batch, const DxGeom& g, size_t smem, int device,
                      cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<cs_conv3x3_dx_kernel<T, RAW>>(device);
    if (err != cudaSuccess) return err;
  }
  const int ntiles = (g.m + g.h - 1) / g.h;
  dim3 grid(ntiles * g.nslices, 6, batch);
  cs_conv3x3_dx_kernel<T, RAW><<<grid, MAX_THREADS, smem, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(keq), static_cast<const T*>(kpo),
      static_cast<T*>(dx), static_cast<T*>(dext), g);
  return cudaGetLastError();
}

template <typename T, int NW, int KC, bool RAW>
cudaError_t launch_dx_tc_nw(const TcGeom& g, int batch, size_t smem, int device,
                            cudaStream_t stream, const T* dout, const T* keq, const T* kpo,
                            T* dx, T* dext) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<cs_conv3x3_dx_tc_kernel<T, NW, KC, RAW>>(device);
    if (err != cudaSuccess) return err;
  }
  const long long p0 = (4LL * batch * g.ntr + g.tpb - 1) / g.tpb;
  const long long p1 = (2LL * batch * g.ntr + g.tpb - 1) / g.tpb;
  const long long blocks = g.nslices * (p0 + p1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cs_conv3x3_dx_tc_kernel<T, NW, KC, RAW><<<(unsigned)blocks, g.threads, smem, stream>>>(
      dout, keq, kpo, dx, dext, g, batch);
  return cudaGetLastError();
}

// float32 takes at most 4 n8 tiles per warp (make_tc_geom)
template <typename T, int KC, bool RAW>
cudaError_t launch_dx_tc(const TcGeom& g, int batch, size_t smem, int device, cudaStream_t s,
                         const void* dout, const void* keq, const void* kpo, void* dx,
                         void* dext) {
  const T *d = static_cast<const T*>(dout), *k0 = static_cast<const T*>(keq),
          *k1 = static_cast<const T*>(kpo);
  T *o = static_cast<T*>(dx), *e = static_cast<T*>(dext);
  switch (g.nw) {
    case 1: return launch_dx_tc_nw<T, 1, KC, RAW>(g, batch, smem, device, s, d, k0, k1, o, e);
    case 2: return launch_dx_tc_nw<T, 2, KC, RAW>(g, batch, smem, device, s, d, k0, k1, o, e);
    case 4: return launch_dx_tc_nw<T, 4, KC, RAW>(g, batch, smem, device, s, d, k0, k1, o, e);
    default:
      if constexpr (std::is_same<T, float>::value) return cudaErrorInvalidValue;
      else return launch_dx_tc_nw<T, 8, KC, RAW>(g, batch, smem, device, s, d, k0, k1, o, e);
  }
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* ext, const void* dout, void* dk_part,
                      void* db_part, const DwGeom& g, int ncob, size_t smem, int device,
                      cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<cs_conv3x3_dw_kernel<T>>(device);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(g.ncib * ncob, g.nsplit, 2);
  cs_conv3x3_dw_kernel<T><<<grid, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ext), static_cast<const T*>(dout),
      static_cast<float*>(dk_part), static_cast<float*>(db_part), g);
  return cudaGetLastError();
}

template <int CIG, int NG>
cudaError_t launch_dw_tc_cfg(const DwTcGeom& g, size_t smem, int device, cudaStream_t stream,
                             const void* x, const void* ext, const void* dout, float* dk_part,
                             float* db_part) {
  dim3 grid(g.ncib * g.ncob, g.nsplit, 2);
  if (g.esize == 4) {
    if (smem > 48 * 1024) {
      cudaError_t err = allow_large_smem<cs_conv3x3_dw_tf32_kernel<CIG, NG>>(device);
      if (err != cudaSuccess) return err;
    }
    cs_conv3x3_dw_tf32_kernel<CIG, NG><<<grid, g.threads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(ext),
        static_cast<const float*>(dout), dk_part, db_part, g);
    return cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<cs_conv3x3_dw_tc_kernel<CIG, NG>>(device);
    if (err != cudaSuccess) return err;
  }
  cs_conv3x3_dw_tc_kernel<CIG, NG><<<grid, g.threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ext), static_cast<const bf16*>(dout),
      dk_part, db_part, g);
  return cudaGetLastError();
}

// The CUDA-core dw kernel in either dtype.
int dw_cc_entry(int dtype, int device, const void* x, const void* ext, const void* dout,
                void* dk_part, void* db_part, int batch, int n, int cin, int cout, int rows,
                int nsplit, void* stream) {
  if (device < 0 || device >= 64 || batch < 1 || n < 1 || cin < 1 || cout < 1 ||
      rows < 1 || rows > n || nsplit < 1 || nsplit > 65535)
    return cudaErrorInvalidValue;
  DwGeom g;
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.batch = batch;
  g.rows = rows;
  g.nchunk = (n + rows - 1) / rows;
  g.nsplit = nsplit;
  g.ncib = (cin + DW_CI - 1) / DW_CI;
  const int ncob = (cout + DW_CO - 1) / DW_CO;
  if ((long long)g.ncib * ncob > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(rows + 2) * (n + 2) * DW_CI + (size_t)rows * n * DW_CO);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, ext, dout, dk_part, db_part, g, ncob, smem, device, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, ext, dout, dk_part, db_part, g, ncob, smem, device, s);
  return cudaErrorInvalidValue;
}

// The CUDA-core dx kernel (RAW: the raw ring in place of d_ext).
template <bool RAW>
int dx_cc_entry(int dtype, int device, const void* dout, const void* keq, const void* kpo,
                void* dx, void* dext, int batch, int n, int cin, int cout, int h, int cs,
                void* stream) {
  const int m = n + 2;
  if (device < 0 || device >= 64 || batch < 1 || batch > 65535 || n < 1 || cin < 1 ||
      cout < 1 || h < 1 || h > m || cs < CO || (cs & (cs - 1)) != 0)
    return cudaErrorInvalidValue;
  DxGeom g;
  g.n = n;
  g.m = m;
  g.cin = cin;
  g.cout = cout;
  g.h = h;
  g.cs = cs;
  for (g.cs_log2 = 0; (1 << g.cs_log2) < cs; ++g.cs_log2) {
  }
  g.nslices = (cin + cs - 1) / cs;
  g.ncg = (m + PX - 1) / PX;
  g.nog = cs / CO;
  g.wp = g.ncg * PX + 2;
  g.plane = (h + 2) * g.wp;
  g.plane += 1 - g.plane % 2;
  if (h * g.ncg * g.nog > MAX_THREADS) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)CC * g.plane + (size_t)9 * CC * cs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx<float, RAW>(dout, keq, kpo, dx, dext, batch, g, smem, device, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16, RAW>(dout, keq, kpo, dx, dext, batch, g, smem, device, s);
  return cudaErrorInvalidValue;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The tensor-core kernel in either dtype (tc_plan's h, cs, nw, tpb; smem
// checked).
template <bool RAW>
int dx_entry(int dtype, int device, const void* dout, const void* keq, const void* kpo,
             void* dx, void* dext, int batch, int n, int cin, int cout, int h, int cs, int nw,
             int tpb, int smem, void* stream) {
  if ((dtype != 0 && dtype != 1) || device < 0 || device >= 64 || batch < 1 ||
      batch > 65535 || n < 1)
    return cudaErrorInvalidValue;
  const bool f32 = dtype == 0;
  TcGeom g;
  if (!cs3x3::make_tc_geom(g, n + 2, n + 2, cout, cin, h, cs, nw, tpb, true, f32) ||
      cs3x3::tc_smem_bytes(g) != (size_t)smem)
    return cudaErrorInvalidValue;
  const int per16 = f32 ? 4 : 8;  // channels per 16 bytes
  g.vec = cout % per16 == 0 && aligned(dout, 16)          ? 1
          : cout % (per16 / 2) == 0 && aligned(dout, 8) ? 2
                                                          : 0;
  g.wvec = cout % per16 == 0 && aligned(keq, 16) && aligned(kpo, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return g.kc == 16 ? launch_dx_tc<float, 16, RAW>(g, batch, smem, device, s, dout, keq, kpo,
                                                     dx, dext)
                      : launch_dx_tc<float, 32, RAW>(g, batch, smem, device, s, dout, keq, kpo,
                                                     dx, dext);
  return g.kc == 16
             ? launch_dx_tc<bf16, 16, RAW>(g, batch, smem, device, s, dout, keq, kpo, dx, dext)
             : launch_dx_tc<bf16, 32, RAW>(g, batch, smem, device, s, dout, keq, kpo, dx, dext);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  device: the current device, which the
// stream belongs to.  h: frame rows per tile; cs: Cin channels per slice;
// with tc_plan's nw, tpb and the shared memory they give (checked here).
// Returns a cudaError_t (0 = success).
int cs_conv3x3_dx_launch(int dtype, int device, const void* dout, const void* keq,
                         const void* kpo, void* dx, void* dext, int batch, int n, int cin,
                         int cout, int h, int cs, int nw, int tpb, int smem, void* stream) {
  return dx_entry<false>(dtype, device, dout, keq, kpo, dx, dext, batch, n, cin, cout, h, cs,
                         nw, tpb, smem, stream);
}

// As cs_conv3x3_dx_launch, writing the raw ring [row 0, row n+1, column 0,
// column n+1] of the (n+2)^2 cotangent into dring (B, 6, 4, n+2, Cin).
int cs_conv3x3_dx_ring_launch(int dtype, int device, const void* dout, const void* keq,
                              const void* kpo, void* dx, void* dring, int batch, int n,
                              int cin, int cout, int h, int cs, int nw, int tpb, int smem,
                              void* stream) {
  return dx_entry<true>(dtype, device, dout, keq, kpo, dx, dring, batch, n, cin, cout, h, cs,
                        nw, tpb, smem, stream);
}

// The CUDA-core dx kernel in either dtype (raw: the raw ring), with
// tile_plan's h and cs: the instances that the tensor-core kernel
// replaced, kept so that the kernel tools can time the two side by side
// (ops/conv_variants.py::cs_conv3x3_dx_cudacore).
int cs_conv3x3_dx_cc_launch(int dtype, int device, const void* dout, const void* keq,
                            const void* kpo, void* dx, void* dext, int raw, int batch, int n,
                            int cin, int cout, int h, int cs, void* stream) {
  return raw ? dx_cc_entry<true>(dtype, device, dout, keq, kpo, dx, dext, batch, n, cin, cout,
                                 h, cs, stream)
             : dx_cc_entry<false>(dtype, device, dout, keq, kpo, dx, dext, batch, n, cin, cout,
                                  h, cs, stream);
}

// The tensor-core dw kernel in either dtype (float32 as 3xTF32), with
// dw_tc_plan's rows (face rows per item), nsplit (K slices per face group),
// cig (Cin groups of 16 per block), ng (Cout groups of 32) and the shared
// memory they give (checked here).  dk_part and db_part are float32,
// written whole.
int cs_conv3x3_dw_launch(int dtype, int device, const void* x, const void* ext,
                         const void* dout, void* dk_part, void* db_part, int batch, int n,
                         int cin, int cout, int rows, int nsplit, int cig, int ng, int smem,
                         void* stream) {
  if ((dtype != 0 && dtype != 1) || device < 0 || device >= 64) return cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2, per16 = 16 / esize;  // channels per 16 bytes
  DwTcGeom g;
  if (!make_dw_tc_geom(g, batch, n, cin, cout, rows, nsplit, cig, ng, esize) ||
      dw_tc_smem_bytes(g) != (size_t)smem)
    return cudaErrorInvalidValue;
  g.vec = cin % per16 == 0 && aligned(x, 16) && aligned(ext, 16)           ? 1
          : cin % (per16 / 2) == 0 && aligned(x, 8) && aligned(ext, 8) ? 2
                                                                         : 0;
  g.dvec = cout % per16 == 0 && aligned(dout, 16)          ? 1
           : cout % (per16 / 2) == 0 && aligned(dout, 8) ? 2
                                                           : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *dk = static_cast<float*>(dk_part), *db = static_cast<float*>(db_part);
  if (cig == 2) return launch_dw_tc_cfg<2, 1>(g, smem, device, s, x, ext, dout, dk, db);
  if (ng == 2) return launch_dw_tc_cfg<1, 2>(g, smem, device, s, x, ext, dout, dk, db);
  return launch_dw_tc_cfg<1, 1>(g, smem, device, s, x, ext, dout, dk, db);
}

// The CUDA-core dw kernel in either dtype, with dw_plan's rows (face rows
// staged per item, <= n) and nsplit (reduction slices per face group,
// 1..65535): the instances that the tensor-core kernels replaced, kept so
// that the kernel tools can time the two side by side
// (ops/conv_variants.py::cs_conv3x3_dw_cudacore).
int cs_conv3x3_dw_cc_launch(int dtype, int device, const void* x, const void* ext,
                            const void* dout, void* dk_part, void* db_part, int batch, int n,
                            int cin, int cout, int rows, int nsplit, void* stream) {
  return dw_cc_entry(dtype, device, x, ext, dout, dk_part, db_part, batch, n, cin, cout, rows,
                     nsplit, stream);
}

const char* cs_conv3x3_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
