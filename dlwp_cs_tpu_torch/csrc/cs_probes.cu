// Small probe kernels for Hopper (sm_90a): the shared-memory store probe and
// the lowering probes of the reference's kernel tools, each a small
// computation with a result that a plain version checks
// (dlwp_cs_tpu_torch/tools/probes.py).
//
// Replaces the TPU kernels
//   * tools/kernel_variants.py::_store_kernel (launched by lane_store):
//     cs_lane_store_tiles_kernel.  x stored into 3 channel-offset slices of
//     a scratch (pixels, 3C) row in shared memory and summed back: 3 x;
//   * tools/mosaic_bisect.py kA (padded-face assembly, ghost rows then ghost
//     columns, output xpad[1:N+1, 2:N+2]) and tools/mosaic_bisect2.py mk (the
//     same scratch with only the ghost rows, or only the W column, written;
//     its four variants differ only in Pallas indexing syntax, so here they
//     are one kernel and an edge mask): cs_probe_gather_kernel;
//   * mosaic_bisect.py kB (a weight tap selected by program id):
//     cs_probe_select_vec_kernel; kC (a (N, N, C) x (C, D) product, f32
//     sums) and kD (9 shifted products from a zero-framed scratch):
//     cs_probe_conv_tc_kernel, 1 or 9 taps; kE (a bias add):
//     cs_probe_bias_kernel;
//   * tools/mosaic_bisect3.py k1 (dw as x.reshape(n^2, C)^T . g.reshape(n^2,
//     D), f32) and k2 (the same as a product batched over the columns and a
//     sum over them): cs_probe_dw_tc_kernel, per-pixel runs or whole
//     columns.
//
// What bounds them on this card: each moves at most a few MB and does at
// most 0.6 GFLOP, so one launch's latency, and the serial path of its
// slowest block, bound them.  The designs, each for what its probe
// computes:
//   * lane store: bytes bound it (x read once, 3 x written once).  Tiles
//     of several face rows' pixels (up to 1,024 16-byte items a tile), a
//     grid of a few blocks an SM looping over the tiles; each thread holds
//     four 16-byte loads in flight, stores each into the three slices of
//     its pixel's scratch row at channel offsets 0, C, 2C with 16-byte
//     shared stores (where C's bytes are a multiple of 16; else the same
//     kernel moves one element at a time), reads the three back, sums
//     (s0 + s1) + s2 in f32, rounds once and stores 16 bytes.  The shared
//     accesses are volatile, so the round trip through the scratch is kept
//     (each thread reads back what it wrote: no barrier).  A thread's
//     (pixel, item) pairs advance by a constant step, no division per
//     element.  Bitwise 3 x in both types (x + x is exact);
//   * assembly: the output window xpad[1:N+1, 2:N+2] holds no ghost row, so
//     out[:, :N-1] = x[:, 1:] and out[:, N-1] is the E ghost column (or
//     zero): a direct gather, one block a row, 16-byte accesses; exact;
//   * select: 16-byte copies, several blocks a program; exact;
//   * dot and shifted dots: the implicit GEMM of cs_tap_gemm.cuh on the
//     tensor cores (bfloat16 mma.sync, float32 3xTF32): the rows of h face
//     rows staged once (the shifted probe's as a zero-framed tile read at 9
//     shifted addresses), the taps of a slice of D resident;
//   * dw: a GEMM with K = the n^2 pixels, split over blocks, both operands
//     K-major along pixels (bfloat16 ldmatrix .trans; float32 3xTF32 with
//     32-bit fragment loads of operands split once as they were staged);
//     k1's K slices are runs of consecutive pixels, each chunk of 64 into
//     fresh sums, k2's whole columns, each column's sum first, as the
//     reference sums them; each block writes its slice's partial sum and
//     the caller adds the partials in a fixed order (torch.sum): two calls
//     are bitwise equal;
//   * bias: one thread per output, as before (already faster than torch's
//     add).
// The kernels they replaced (cs_lane_store_kernel, one block of 256
// threads a face row, 2- or 4-byte accesses, a division and a modulo per
// element and a barrier in every tiny block; cs_probe_assemble_kernel, 13 blocks and four
// passes with a barrier each; cs_probe_select_kernel; cs_probe_dot_kernel,
// cs_probe_shifted_kernel and cs_probe_dw_kernel, one thread per output
// with a serial f32 chain) stay as timing rows (tools/probes.py's *_v1
// probes); no tool path selects them.
//
// Element types: float32 (dtype 0) and bfloat16 (dtype 1); dw outputs are
// float32.  Layouts are contiguous, channels last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "cs_tap_gemm.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x (R, n, C) -> out (R, n, C): per row r, s[j][k*C + c] = x[r][j][c] for the
// three slices k, then out = s[.][c] + s[.][C + c] + s[.][2C + c].
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_lane_store_kernel(const T* __restrict__ x,
                                                                 T* __restrict__ out, int n,
                                                                 int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);  // [n][3c]
  const long long row = blockIdx.x;
  const T* xr = x + row * n * c;
  for (int e = threadIdx.x; e < n * c; e += THREADS) {
    const int j = e / c, ch = e % c;
    const T v = xr[e];
    s[j * 3 * c + ch] = v;
    s[j * 3 * c + c + ch] = v;
    s[j * 3 * c + 2 * c + ch] = v;
  }
  __syncthreads();
  T* orow = out + row * n * c;
  for (int e = threadIdx.x; e < n * c; e += THREADS) {
    const int j = e / c, ch = e % c;
    const T* sj = s + j * 3 * c;
    orow[e] = from_f32<T>(to_f32(sj[ch]) + to_f32(sj[c + ch]) + to_f32(sj[2 * c + ch]));
  }
}

// ---- the lane store on tiles of pixels --------------------------------------
// items a thread moves per tile: 16-byte items (VEC), else single elements
constexpr int LS_VEC_ITEMS = 4, LS_ELEM_ITEMS = 8;

__device__ __forceinline__ uint32_t sm_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// volatile shared accesses: the scratch round trip is not forwarded away
__device__ __forceinline__ void sts(void* p, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(sm_addr(p)), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void sts(void* p, float v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sm_addr(p)), "r"(__float_as_uint(v)) : "memory");
}
__device__ __forceinline__ void sts(void* p, __nv_bfloat16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(sm_addr(p)), "h"(__bfloat16_as_ushort(v))
               : "memory");
}
__device__ __forceinline__ void lds(uint4& v, const void* p) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(sm_addr(p)) : "memory");
}
__device__ __forceinline__ void lds(float& v, const void* p) {
  uint32_t u;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u) : "r"(sm_addr(p)) : "memory");
  v = __uint_as_float(u);
}
__device__ __forceinline__ void lds(__nv_bfloat16& v, const void* p) {
  unsigned short u;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(u) : "r"(sm_addr(p)) : "memory");
  v = __ushort_as_bfloat16(u);
}

// (a + b) + c in f32, rounded once to T, per element of an item
template <typename T>
__device__ __forceinline__ T sum3(T a, T b, T c) {
  return from_f32<T>((to_f32(a) + to_f32(b)) + to_f32(c));
}
template <typename T>
__device__ __forceinline__ uint4 sum3(uint4 a, uint4 b, uint4 c) {
  uint4 r;
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  const T* pc = reinterpret_cast<const T*>(&c);
  T* pr = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) pr[e] = sum3<T>(pa[e], pb[e], pc[e]);
  return r;
}

// x, out (npix, C), viewed as npix * u items (16-byte items where VEC,
// else elements; u items a pixel).  Tile t holds pixels t*p .. t*p+p-1;
// the block stores each of its pixels' items into the slices [0:C],
// [C:2C], [2C:3C] of the pixel's scratch row s[q][3u], reads them back and
// writes their sum.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) cs_lane_store_tiles_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long npix, int u, int p, long long ntiles) {
  typedef typename std::conditional<VEC, uint4, T>::type Item;
  constexpr int J = VEC ? LS_VEC_ITEMS : LS_ELEM_ITEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  Item* s = reinterpret_cast<Item*>(smem);  // [p][3u]
  const Item* __restrict__ xi = reinterpret_cast<const Item*>(x);
  Item* __restrict__ oi = reinterpret_cast<Item*>(out);
  // this thread's items of a tile, tid + j * THREADS, as (pixel q, item v):
  // one division here, then a constant step
  int q[J], v[J];
  {
    const int dq = THREADS / u, dv = THREADS % u;
    int qq = threadIdx.x / u, vv = threadIdx.x % u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      q[j] = qq;
      v[j] = vv;
      qq += dq;
      vv += dv;
      if (vv >= u) {
        vv -= u;
        ++qq;
      }
    }
  }
  const long long items = npix * u;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long base = t * p * (long long)u;
    Item r[J];
#pragma unroll
    for (int j = 0; j < J; ++j)  // every load in flight before any store
      if (q[j] < p && base + threadIdx.x + j * THREADS < items)
        r[j] = xi[base + threadIdx.x + j * THREADS];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (q[j] < p && base + threadIdx.x + j * THREADS < items) {
        Item* row = s + (long long)q[j] * 3 * u + v[j];
        sts(row, r[j]);
        sts(row + u, r[j]);
        sts(row + 2 * u, r[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (q[j] < p && base + threadIdx.x + j * THREADS < items) {
        const Item* row = s + (long long)q[j] * 3 * u + v[j];
        Item a, b, c;
        lds(a, row);
        lds(b, row + u);
        lds(c, row + 2 * u);
        oi[base + threadIdx.x + j * THREADS] = sum3<T>(a, b, c);
      }
    }
  }
}

// Edge mask bits of the assembly probe: which ghost lines are written.
constexpr int GHOST_S = 1, GHOST_N = 2, GHOST_W = 4, GHOST_E = 8;

// x (N, N, C), e (4, N+2, C) [S, N, W, E] -> out (N, N, C) = xpad[1:N+1,
// 2:N+2].  Each block assembles the padded rows p0 .. p0+R-1 of xpad in
// shared memory in the probe's order: zeros and the interior, then the
// masked ghost rows (whole, corners included), then the masked ghost
// columns (whole, so they overwrite the corners).
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_probe_assemble_kernel(
    const T* __restrict__ x, const T* __restrict__ e, T* __restrict__ out, int N, int C,
    int R, int mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xpad = reinterpret_cast<T*>(smem);  // [R][N+2][C]
  const int p0 = blockIdx.x * R;
  const int W = N + 2;
  const int cells = R * W * C;
  for (int idx = threadIdx.x; idx < cells; idx += THREADS) {
    const int ch = idx % C, pc = (idx / C) % W, p = p0 + idx / (W * C);
    xpad[idx] = (p >= 1 && p <= N && pc >= 1 && pc <= N)
                    ? x[((long long)(p - 1) * N + pc - 1) * C + ch]
                    : from_f32<T>(0.f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * W * C; idx += THREADS) {
    const int ch = idx % C, pc = (idx / C) % W, p = p0 + idx / (W * C);
    if (p == 0 && (mask & GHOST_S)) xpad[idx] = e[(0LL * W + pc) * C + ch];
    if (p == N + 1 && (mask & GHOST_N)) xpad[idx] = e[(1LL * W + pc) * C + ch];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * 2 * C; idx += THREADS) {
    const int ch = idx % C, side = (idx / C) % 2, r = idx / (2 * C), p = p0 + r;
    if (p > N + 1) continue;
    if (side == 0 && (mask & GHOST_W)) xpad[(r * W + 0) * C + ch] = e[(2LL * W + p) * C + ch];
    if (side == 1 && (mask & GHOST_E))
      xpad[(r * W + N + 1) * C + ch] = e[(3LL * W + p) * C + ch];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * N * C; idx += THREADS) {
    const int ch = idx % C, j = (idx / C) % N, r = idx / (N * C), p = p0 + r;
    if (p >= 1 && p <= N)
      out[((long long)(p - 1) * N + j) * C + ch] = xpad[(r * W + j + 2) * C + ch];
  }
}

// k1, k2 (3, 3, C, D) -> out (S, C, D): block s takes tap (1, 1) of k1 for
// s < 4 (the equatorial faces' id range), of k2 otherwise.
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_probe_select_kernel(const T* __restrict__ k1,
                                                                   const T* __restrict__ k2,
                                                                   T* __restrict__ out, int cd) {
  const int s = blockIdx.x;
  const T* src = (s < 4 ? k1 : k2) + 4LL * cd;  // tap (1, 1)
  for (int e = threadIdx.x; e < cd; e += THREADS) out[(long long)s * cd + e] = src[e];
}

// x (P, C) . k (C, D) -> out (P, D), f32 sums in channel order.
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_probe_dot_kernel(const T* __restrict__ x,
                                                                const T* __restrict__ k,
                                                                T* __restrict__ out, int P, int C,
                                                                int D) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)P * D) return;
  const int d = idx % D;
  const T* xp = x + (idx / D) * C;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(to_f32(xp[c]), to_f32(k[(long long)c * D + d]), acc);
  out[idx] = from_f32<T>(acc);
}

// x (N, N, C), k (3, 3, C, D) -> out (N, N, D): block i stages padded rows
// i .. i+2 of the zero-framed face in shared memory (f32) and sums the 9
// taps (dy, dx, then channels) per output.
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_probe_shifted_kernel(const T* __restrict__ x,
                                                                    const T* __restrict__ k,
                                                                    T* __restrict__ out, int N,
                                                                    int C, int D) {
  extern __shared__ __align__(16) float pad[];  // [3][N+2][C]
  const int i = blockIdx.x, W = N + 2;
  for (int idx = threadIdx.x; idx < 3 * W * C; idx += THREADS) {
    const int ch = idx % C, pc = (idx / C) % W, p = i + idx / (W * C);
    pad[idx] = (p >= 1 && p <= N && pc >= 1 && pc <= N)
                   ? to_f32(x[((long long)(p - 1) * N + pc - 1) * C + ch])
                   : 0.f;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < N * D; o += THREADS) {
    const int j = o / D, d = o % D;
    float acc = 0.f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        const float* pr = pad + ((long long)dy * W + j + dx) * C;
        const T* kt = k + (long long)(dy * 3 + dx) * C * D + d;
        for (int c = 0; c < C; ++c) acc = fmaf(pr[c], to_f32(kt[(long long)c * D]), acc);
      }
    out[((long long)i * N + j) * D + d] = from_f32<T>(acc);
  }
}

// x (P, D) + b (D) -> out (P, D), in f32 with one rounding.
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_probe_bias_kernel(const T* __restrict__ x,
                                                                 const T* __restrict__ b,
                                                                 T* __restrict__ out, int P,
                                                                 int D) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)P * D) return;
  out[idx] = from_f32<T>(to_f32(x[idx]) + to_f32(b[idx % D]));
}

// x (n, n, C), g (n, n, D) -> out (C, D) f32.  BATCHED = false: one sum over
// the n^2 pixels in row-major order (k1); true: per column j the sum over
// rows i, then the sum of the n column sums (k2).
template <typename T, bool BATCHED>
__global__ void __launch_bounds__(THREADS) cs_probe_dw_kernel(const T* __restrict__ x,
                                                               const T* __restrict__ g,
                                                               float* __restrict__ out, int n,
                                                               int C, int D) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)C * D) return;
  const int c = idx / D, d = idx % D;
  float acc = 0.f;
  if (!BATCHED) {
    for (long long p = 0; p < (long long)n * n; ++p)
      acc = fmaf(to_f32(x[p * C + c]), to_f32(g[p * D + d]), acc);
  } else {
    for (int j = 0; j < n; ++j) {
      float col = 0.f;
      for (int i = 0; i < n; ++i) {
        const long long p = (long long)i * n + j;
        col = fmaf(to_f32(x[p * C + c]), to_f32(g[p * D + d]), col);
      }
      acc += col;
    }
  }
  out[idx] = acc;
}

// ---- the redesigned probes -------------------------------------------------

// x (N, N, C), e (4, N+2, C) -> out (N, N, C) = xpad[1:N+1, 2:N+2]: x's
// columns 1.., then the E ghost column at rows 1..N (or zeros).  Block i
// writes output row i, V elements a thread (C a multiple of V).
template <typename T, int V>
__global__ void __launch_bounds__(128) cs_probe_gather_kernel(const T* __restrict__ x,
                                                               const T* __restrict__ e,
                                                               T* __restrict__ out, int N, int C,
                                                               int mask) {
  using Vec = typename std::conditional<V * sizeof(T) == 16, uint4, T>::type;
  const int i = blockIdx.x;
  const int nv = N * C / V;
  for (int q = threadIdx.x; q < nv; q += 128) {
    const int idx = q * V, j = idx / C, c = idx - j * C;
    Vec v;
    if (j < N - 1) {
      v = *reinterpret_cast<const Vec*>(x + ((long long)i * N + j + 1) * C + c);
    } else if (mask & GHOST_E) {
      v = *reinterpret_cast<const Vec*>(e + (3LL * (N + 2) + i + 1) * C + c);
    } else {
      if constexpr (V * sizeof(T) == 16) v = make_uint4(0, 0, 0, 0);
      else v = from_f32<T>(0.f);
    }
    *reinterpret_cast<Vec*>(out + ((long long)i * N) * C + idx) = v;
  }
}

// k1, k2 (3, 3, C, D) -> out (S, C, D): program s copies tap (1, 1) of k1
// for s < 4, of k2 otherwise; grid (S, chunks of 128 vectors).
template <typename T, int V>
__global__ void __launch_bounds__(128) cs_probe_select_vec_kernel(const T* __restrict__ k1,
                                                                   const T* __restrict__ k2,
                                                                   T* __restrict__ out, int cd) {
  using Vec = typename std::conditional<V * sizeof(T) == 16, uint4, T>::type;
  const int s = blockIdx.x;
  const int q = blockIdx.y * 128 + threadIdx.x;
  if (q >= cd / V) return;
  const Vec* src = reinterpret_cast<const Vec*>((s < 4 ? k1 : k2) + 4LL * cd);
  reinterpret_cast<Vec*>(out + (long long)s * cd)[q] = src[q];
}

// The dot and shifted-dots probes' geometry (tools/probes.py::conv_geom
// computes the same).
struct ConvGeom {
  int N, C, D;
  int ntaps;  // 1 (dot) or 9 (shifted)
  int h;      // face rows per block
  int dn;     // output channels per block (a multiple of 16)
  int cp, kpe, kpt, wpitch, mg;
  int a_units, w_bytes, smem;
  bool avec, wvec;
};

bool make_conv_geom(int N, int C, int D, int esize, bool shifted, int h, int dn, ConvGeom& g) {
  if (N < 1 || C < 1 || D < 1 || h < 1 || h > N || dn < 16 || dn % 16) return false;
  g.N = N;
  g.C = C;
  g.D = D;
  g.ntaps = shifted ? 9 : 1;
  g.h = h;
  g.dn = dn;
  const int upe = esize / 2, step = 8 / upe;
  int cpe = (C + step - 1) / step * step;
  while ((cpe * upe / 8) % 2 == 0) cpe += step;  // an odd multiple of 8 units
  g.cp = cpe * upe;
  g.kpe = (C + 16 / upe - 1) / (16 / upe) * (16 / upe);
  g.kpt = g.kpe * upe;
  g.wpitch = dn + 8;
  const int mt = (h * N + 15) / 16;
  g.mg = std::min(tapgemm::MG, std::max(1, mt * (dn / 16) / (tapgemm::THREADS / 32)));
  const int cells = shifted ? (h + 2) * (N + 2) : h * N;
  g.a_units = (cells + 1) * g.cp;
  g.w_bytes = g.ntaps * g.kpe * g.wpitch * esize;
  const long long smem = (long long)g.w_bytes + 2LL * g.a_units;
  if (smem > 232448) return false;
  g.smem = (int)smem;
  return true;
}

// x (N, N, C) with k (C, D) (ntaps 1) or k (3, 3, C, D) on the zero-framed
// face (ntaps 9) -> out (N, N, D).  Grid (ceil(N / h), ceil(D / dn)).
template <typename T>
__global__ void __launch_bounds__(tapgemm::THREADS) cs_probe_conv_tc_kernel(
    const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ out, ConvGeom g) {
  using tapgemm::bf16;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int N = g.N, C = g.C, D = g.D, W2 = N + 2;
  const int i0 = blockIdx.x * g.h, hv = min(g.h, N - i0);
  const int d0 = blockIdx.y * g.dn, dnv = min(g.dn, D - d0);
  const bool shifted = g.ntaps == 9;
  T* W = reinterpret_cast<T*>(smem_tc);
  bf16* A = reinterpret_cast<bf16*>(smem_tc + g.w_bytes);
  tapgemm::stage_taps<T>(W, g.ntaps, g.kpe, C, g.dn, d0, D, D, g.wpitch, g.wvec,
                         [&](int tap) { return k + (long long)tap * C * D; });
  const int cells = shifted ? (hv + 2) * W2 : hv * N;
  tapgemm::stage_cells<T>(A, cells + 1, C, g.cp, g.avec, x, [&](int c) -> const T* {
    if (c >= cells) return nullptr;  // one zero cell past the last
    if (!shifted) return x + ((long long)i0 * N + c) * C;
    const int fi = i0 - 1 + c / W2, fj = c % W2 - 1;  // staged cell -> face pixel
    if (fi < 0 || fi >= N || fj < 0 || fj >= N) return nullptr;
    return x + ((long long)fi * N + fj) * C;
  });
  cs3x3::cp_async_commit();
  cs3x3::cp_async_wait_all();
  __syncthreads();
  const int cp = g.cp;
  tapgemm::Gemm gm{hv * N, g.ntaps, g.kpt, g.dn / 16, g.mg, g.wpitch};
  tapgemm::gemm<T>(
      gm, A, W,
      [=](int m) { return shifted ? ((m / N) * W2 + m % N) * cp : m * cp; },
      [=](int tap) { return ((tap / 3) * W2 + tap % 3) * cp; },
      [&](int m, int nl, float v0, float v1) {
        T* o = out + ((long long)i0 * N + m) * D + d0 + nl;
        if (nl < dnv) o[0] = from_f32<T>(v0);
        if (nl + 1 < dnv) o[1] = from_f32<T>(v1);
      });
}

// The dw probes: block tile DW_MC Cin x DW_ND Cout channels, chunks of up
// to DW_KS pixels; 4 warps, warp w owns m16 tile w % 2 and n8 tiles
// 4 (w / 2) .. +3.  Staged rows [pixel][channel]: pitches of 40 and 72
// elements put the rows of an ldmatrix (16-bit units: odd multiples of 8)
// or a fragment's 32-bit loads (8 words mod 32) on distinct banks.
constexpr int DW_MC = 32, DW_ND = 64, DW_KS = 64, DW_XP = 40, DW_GP = 72;

// x (n, n, C), g (n, n, D) -> part (nsplit, C, D) float32: block (tile,
// s) sums the pixels of K slice s (batched = 0: pixels n^2 s / nsplit ..
// n^2 (s + 1) / nsplit - 1 in chunks of DW_KS, each chunk into fresh sums;
// batched = 1: columns n s / nsplit .. n (s + 1) / nsplit - 1, each
// column's rows into fresh sums, then the column sums in order).
template <typename T>
__global__ void __launch_bounds__(128) cs_probe_dw_tc_kernel(const T* __restrict__ x,
                                                              const T* __restrict__ g,
                                                              float* __restrict__ part, int n,
                                                              int C, int D, int batched,
                                                              int nsplit, int vec) {
  using tapgemm::bf16;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int STEP = F32 ? 8 : 16;  // pixels per k step
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* X = reinterpret_cast<T*>(smem_tc);  // [DW_KS][DW_XP]
  T* G = X + DW_KS * DW_XP;              // [DW_KS][DW_GP]
  float* Xlo = reinterpret_cast<float*>(G + DW_KS * DW_GP);  // float32: the lo halves
  float* Glo = Xlo + DW_KS * DW_XP;
  const int ctiles = (C + DW_MC - 1) / DW_MC;
  const int c0 = (blockIdx.x % ctiles) * DW_MC, d0 = (blockIdx.x / ctiles) * DW_ND;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp & 1, nq = warp >> 1;
  float acc[4][4], sum[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  // the slice: (column or run start, end); a chunk is up to DW_KS pixels
  const long long total = batched ? n : (long long)n * n;
  const int lo = (int)(total * s / nsplit), hi = (int)(total * (s + 1) / nsplit);
  int unit = lo, i0 = 0;  // batched: column, first row of the chunk; else first pixel
  while (unit < hi) {
    const int len = batched ? min(DW_KS, n - i0) : min(DW_KS, hi - unit);
    const int klen = (len + STEP - 1) / STEP * STEP;
    auto pixel = [&](int r) -> long long {
      return batched ? (long long)(i0 + r) * n + unit : (long long)unit + r;
    };
    // stage rows r < klen (zero past len): X[r][c] = x[p][c0 + c], G[r][d] = g[p][d0 + d]
    if (vec) {  // 16-byte copies; float32 split once they have landed
      constexpr int VE = 16 / sizeof(T), XV = DW_MC / VE, RV = (DW_MC + DW_ND) / VE;
      for (int u = threadIdx.x; u < klen * RV; u += 128) {
        const int r = u / RV, q = (u - r * RV) * VE;
        const bool isx = q < XV * VE;
        const int ch = isx ? q : q - XV * VE, cl = isx ? C : D, base = isx ? c0 : d0;
        const bool on = r < len && base + ch < cl;
        const T* src = isx ? x : g;
        cs3x3::cp_async16(isx ? X + r * DW_XP + ch : G + r * DW_GP + ch,
                          on ? src + pixel(r) * cl + base + ch : src, on ? 16 : 0);
      }
      cs3x3::cp_async_commit();
      cs3x3::cp_async_wait_all();
      if constexpr (F32) {
        __syncthreads();
        for (int u = threadIdx.x; u < klen * (DW_MC + DW_ND); u += 128) {
          const int r = u / (DW_MC + DW_ND), q = u - r * (DW_MC + DW_ND);
          const bool isx = q < DW_MC;
          const int off = isx ? r * DW_XP + q : r * DW_GP + q - DW_MC;
          uint32_t* h = reinterpret_cast<uint32_t*>(isx ? X : G) + off;
          uint32_t a, b;
          cs3x3::split_tf32(*h, a, b);
          *h = a;
          (isx ? Xlo : Glo)[off] = __uint_as_float(b);
        }
      }
    } else {
      for (int u = threadIdx.x; u < klen * (DW_MC + DW_ND); u += 128) {
        const int r = u / (DW_MC + DW_ND), q = u - r * (DW_MC + DW_ND);
        const bool isx = q < DW_MC;
        const int ch = isx ? q : q - DW_MC;
        const int cl = isx ? C : D, base = isx ? c0 : d0;
        float v = 0.f;
        if (r < len && base + ch < cl) v = to_f32((isx ? x : g)[pixel(r) * cl + base + ch]);
        const int off = isx ? r * DW_XP + ch : r * DW_GP + ch;
        T* dst = isx ? X : G;
        if constexpr (F32) {
          uint32_t h, l;
          cs3x3::split_tf32(__float_as_uint(v), h, l);
          reinterpret_cast<uint32_t*>(dst)[off] = h;
          (isx ? Xlo : Glo)[off] = __uint_as_float(l);
        } else {
          dst[off] = from_f32<T>(v);
        }
      }
    }
    __syncthreads();
    const bool fresh = !batched || i0 == 0;
    if (fresh) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[j][r] = 0.f;
    }
    for (int kk = 0; kk < klen; kk += STEP) {
      if constexpr (F32) {
        const float* Xf = reinterpret_cast<const float*>(X);
        const float* Gf = reinterpret_cast<const float*>(G);
        uint32_t ah[4], al[4];
        const int m = mt * 16 + gid;
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a0..a3: (m, k), (m + 8, k), (m, k + 4), (m + 8, k + 4)
          const int o = (kk + tig + (q >> 1) * 4) * DW_XP + m + (q & 1) * 8;
          ah[q] = __float_as_uint(Xf[o]);
          al[q] = __float_as_uint(Xlo[o]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = nq * 32 + j * 8 + gid;
          const int o0 = (kk + tig) * DW_GP + nn, o1 = o0 + 4 * DW_GP;
          const uint32_t bh0 = __float_as_uint(Gf[o0]), bh1 = __float_as_uint(Gf[o1]);
          const uint32_t bl0 = __float_as_uint(Glo[o0]), bl1 = __float_as_uint(Glo[o1]);
          cs3x3::mma_tf32(sum[j], al, bh0, bh1);
          cs3x3::mma_tf32(sum[j], ah, bl0, bl1);
          cs3x3::mma_tf32(sum[j], ah, bh0, bh1);
        }
      } else {
        const bf16* Xb = reinterpret_cast<const bf16*>(X);
        const bf16* Gb = reinterpret_cast<const bf16*>(G);
        uint32_t a[4];
        cs3x3::ldsm_x4_t(a, Xb + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * DW_XP + mt * 16 +
                                ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b[4];
          cs3x3::ldsm_x4_t(b, Gb + (kk + (lane & 15)) * DW_GP + nq * 32 + jj * 16 +
                                  (lane >> 4) * 8);
          cs3x3::mma_bf16(sum[2 * jj], a, b[0], b[1]);
          cs3x3::mma_bf16(sum[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
    // advance: a run ends its chunk; a column ends after its last rows
    bool done;
    if (batched) {
      i0 += len;
      done = i0 >= n;
      if (done) {
        i0 = 0;
        ++unit;
      }
    } else {
      unit += len;
      done = true;
    }
    if (done) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] += sum[j][r];
    }
    __syncthreads();  // the stage is free again
  }
  // sums of channels c = c0 + 16 mt + gid (+8), d = d0 + 32 nq + 8 j + 2 tig (+1)
  float* p = part + (long long)s * C * D;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + mt * 16 + gid + (r >> 1) * 8;
      const int dd = d0 + nq * 32 + j * 8 + 2 * tig + (r & 1);
      if (c < C && dd < D) p[(long long)c * D + dd] = acc[j][r];
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline unsigned blocks_for(long long work) { return (unsigned)((work + THREADS - 1) / THREADS); }

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; the stream last;
// returns a cudaError_t (0 = success).
extern "C" {

// x, out (rows, n, c): rows = B * 6 * n face rows.
int cs_lane_store_launch(int dtype, const void* x, void* out, int rows, int n, int c,
                         void* stream) {
  if (rows < 1 || n < 1 || c < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elt = dtype == 0 ? 4 : 2;
  const size_t smem = elt * 3 * n * c;
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(cs_lane_store_kernel<float>, smem)) != cudaSuccess) return err;
    cs_lane_store_kernel<float><<<rows, THREADS, smem, s>>>(static_cast<const float*>(x),
                                                            static_cast<float*>(out), n, c);
  } else if (dtype == 1) {
    if ((err = allow_smem(cs_lane_store_kernel<__nv_bfloat16>, smem)) != cudaSuccess) return err;
    cs_lane_store_kernel<__nv_bfloat16><<<rows, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, c);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x, out (npix, c); vec: 16-byte items (c's bytes a multiple of 16, x and
// out 16-byte aligned), else elements; p pixels a tile (p * items a pixel
// <= the items a block moves per tile); grid blocks looping over the tiles.
int cs_lane_store_tiles_launch(int dtype, const void* x, void* out, long long npix, int c,
                               int vec, int p, int grid, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || npix < 1 || c < 1 || p < 1 || grid < 1 ||
      (vec && (c * esize) % 16))
    return cudaErrorInvalidValue;
  const int u = vec ? c * esize / 16 : c;
  const int isize = vec ? 16 : esize;
  if ((long long)p * u > (long long)(vec ? LS_VEC_ITEMS : LS_ELEM_ITEMS) * THREADS)
    return cudaErrorInvalidValue;
  const long long ntiles = (npix + p - 1) / p;
  const size_t smem = (size_t)isize * 3 * p * u;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define CS_LANE_STORE(T, V)                                                              \
  if ((err = allow_smem(cs_lane_store_tiles_kernel<T, V>, smem)) != cudaSuccess) return err; \
  cs_lane_store_tiles_kernel<T, V><<<grid, THREADS, smem, s>>>(                          \
      static_cast<const T*>(x), static_cast<T*>(out), npix, u, p, ntiles)
  if (dtype == 0 && vec) {
    CS_LANE_STORE(float, true);
  } else if (dtype == 0) {
    CS_LANE_STORE(float, false);
  } else if (vec) {
    CS_LANE_STORE(__nv_bfloat16, true);
  } else {
    CS_LANE_STORE(__nv_bfloat16, false);
  }
#undef CS_LANE_STORE
  return cudaGetLastError();
}

// x (N, N, C), e (4, N+2, C), out (N, N, C); R padded rows per block; mask
// of GHOST_S | GHOST_N | GHOST_W | GHOST_E.
int cs_probe_assemble_launch(int dtype, const void* x, const void* e, void* out, int N, int C,
                             int R, int mask, void* stream) {
  if (N < 1 || C < 1 || R < 1 || mask < 0 || mask > 15) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elt = dtype == 0 ? 4 : 2;
  const size_t smem = elt * (size_t)R * (N + 2) * C;
  const unsigned grid = (N + 2 + R - 1) / R;
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(cs_probe_assemble_kernel<float>, smem)) != cudaSuccess) return err;
    cs_probe_assemble_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(e), static_cast<float*>(out), N,
        C, R, mask);
  } else if (dtype == 1) {
    if ((err = allow_smem(cs_probe_assemble_kernel<__nv_bfloat16>, smem)) != cudaSuccess)
      return err;
    cs_probe_assemble_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(e),
        static_cast<__nv_bfloat16*>(out), N, C, R, mask);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// k1, k2 (3, 3, C, D), out (S, C, D): S programs.
int cs_probe_select_launch(int dtype, const void* k1, const void* k2, void* out, int S, int C,
                           int D, void* stream) {
  if (S < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    cs_probe_select_kernel<float><<<S, THREADS, 0, s>>>(
        static_cast<const float*>(k1), static_cast<const float*>(k2), static_cast<float*>(out),
        C * D);
  else if (dtype == 1)
    cs_probe_select_kernel<__nv_bfloat16><<<S, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k1), static_cast<const __nv_bfloat16*>(k2),
        static_cast<__nv_bfloat16*>(out), C * D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// x (P, C), k (C, D), out (P, D).
int cs_probe_dot_launch(int dtype, const void* x, const void* k, void* out, int P, int C, int D,
                        void* stream) {
  if (P < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((long long)P * D);
  if (dtype == 0)
    cs_probe_dot_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k), static_cast<float*>(out), P,
        C, D);
  else if (dtype == 1)
    cs_probe_dot_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
        static_cast<__nv_bfloat16*>(out), P, C, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// x (N, N, C), k (3, 3, C, D), out (N, N, D).
int cs_probe_shifted_launch(int dtype, const void* x, const void* k, void* out, int N, int C,
                            int D, void* stream) {
  if (N < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 3 * (N + 2) * C;
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(cs_probe_shifted_kernel<float>, smem)) != cudaSuccess) return err;
    cs_probe_shifted_kernel<float><<<N, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k), static_cast<float*>(out), N,
        C, D);
  } else if (dtype == 1) {
    if ((err = allow_smem(cs_probe_shifted_kernel<__nv_bfloat16>, smem)) != cudaSuccess)
      return err;
    cs_probe_shifted_kernel<__nv_bfloat16><<<N, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
        static_cast<__nv_bfloat16*>(out), N, C, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x (P, D), b (D), out (P, D).
int cs_probe_bias_launch(int dtype, const void* x, const void* b, void* out, int P, int D,
                         void* stream) {
  if (P < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((long long)P * D);
  if (dtype == 0)
    cs_probe_bias_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(b), static_cast<float*>(out), P,
        D);
  else if (dtype == 1)
    cs_probe_bias_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), P, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// x (n, n, C), g (n, n, D), out (C, D) float32; batched: 0 = k1, 1 = k2.
int cs_probe_dw_launch(int dtype, const void* x, const void* g, void* out, int n, int C, int D,
                       int batched, void* stream) {
  if (n < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for((long long)C * D);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    const float *xf = static_cast<const float*>(x), *gf = static_cast<const float*>(g);
    if (batched) cs_probe_dw_kernel<float, true><<<grid, THREADS, 0, s>>>(xf, gf, o, n, C, D);
    else cs_probe_dw_kernel<float, false><<<grid, THREADS, 0, s>>>(xf, gf, o, n, C, D);
  } else if (dtype == 1) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
    if (batched)
      cs_probe_dw_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(xb, gb, o, n, C, D);
    else
      cs_probe_dw_kernel<__nv_bfloat16, false><<<grid, THREADS, 0, s>>>(xb, gb, o, n, C, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The redesigned probes.  x (N, N, C), e (4, N+2, C), out (N, N, C); vec 1
// or 16 bytes (C a multiple, the addresses aligned).
int cs_probe_gather_launch(int dtype, const void* x, const void* e, void* out, int N, int C,
                           int mask, int vec, void* stream) {
  if (N < 1 || C < 1 || mask < 0 || mask > 15) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vmax = dtype == 0 ? 4 : 8;
  if (vec != 1 && !(vec == vmax && C % vmax == 0)) return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    cs_probe_gather_kernel<float, 4><<<N, 128, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<const float*>(e),
                                                       static_cast<float*>(out), N, C, mask);
  else if (dtype == 0)
    cs_probe_gather_kernel<float, 1><<<N, 128, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<const float*>(e),
                                                       static_cast<float*>(out), N, C, mask);
  else if (dtype == 1 && vec == 8)
    cs_probe_gather_kernel<__nv_bfloat16, 8><<<N, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(e),
        static_cast<__nv_bfloat16*>(out), N, C, mask);
  else if (dtype == 1)
    cs_probe_gather_kernel<__nv_bfloat16, 1><<<N, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(e),
        static_cast<__nv_bfloat16*>(out), N, C, mask);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// k1, k2 (3, 3, C, D), out (S, C, D); vec 1 or 16 bytes (C D a multiple,
// the addresses aligned).
int cs_probe_select_vec_launch(int dtype, const void* k1, const void* k2, void* out, int S,
                               int C, int D, int vec, void* stream) {
  if (S < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cd = C * D, vmax = dtype == 0 ? 4 : 8;
  if (vec != 1 && !(vec == vmax && cd % vmax == 0)) return cudaErrorInvalidValue;
  const dim3 grid(S, (cd / vec + 127) / 128);
  if (dtype == 0 && vec == 4)
    cs_probe_select_vec_kernel<float, 4><<<grid, 128, 0, s>>>(
        static_cast<const float*>(k1), static_cast<const float*>(k2), static_cast<float*>(out),
        cd);
  else if (dtype == 0)
    cs_probe_select_vec_kernel<float, 1><<<grid, 128, 0, s>>>(
        static_cast<const float*>(k1), static_cast<const float*>(k2), static_cast<float*>(out),
        cd);
  else if (dtype == 1 && vec == 8)
    cs_probe_select_vec_kernel<__nv_bfloat16, 8><<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k1), static_cast<const __nv_bfloat16*>(k2),
        static_cast<__nv_bfloat16*>(out), cd);
  else if (dtype == 1)
    cs_probe_select_vec_kernel<__nv_bfloat16, 1><<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k1), static_cast<const __nv_bfloat16*>(k2),
        static_cast<__nv_bfloat16*>(out), cd);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// x (N, N, C); k (C, D) (shifted 0) or (3, 3, C, D) (shifted 1); out (N, N,
// D).  h, dn: tools/probes.py::conv_plan's, with the shared memory they
// give (checked here).
int cs_probe_conv_tc_launch(int dtype, const void* x, const void* k, void* out, int N, int C,
                            int D, int shifted, int h, int dn, int smem, void* stream) {
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  ConvGeom g;
  if (esize == 0 || !make_conv_geom(N, C, D, esize, shifted != 0, h, dn, g) || g.smem != smem)
    return cudaErrorInvalidValue;
  g.avec = (C * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.wvec = (D * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + h - 1) / h, (D + dn - 1) / dn);
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(cs_probe_conv_tc_kernel<float>, smem)) != cudaSuccess) return err;
    cs_probe_conv_tc_kernel<float><<<grid, tapgemm::THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k), static_cast<float*>(out), g);
  } else {
    if ((err = allow_smem(cs_probe_conv_tc_kernel<__nv_bfloat16>, smem)) != cudaSuccess)
      return err;
    cs_probe_conv_tc_kernel<__nv_bfloat16><<<grid, tapgemm::THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
        static_cast<__nv_bfloat16*>(out), g);
  }
  return cudaGetLastError();
}

// x (n, n, C), g (n, n, D), part (nsplit, C, D) float32, written whole;
// batched: 0 = k1, 1 = k2; nsplit <= n^2 (k1) or n (k2).
int cs_probe_dw_tc_launch(int dtype, const void* x, const void* g, void* part, int n, int C,
                          int D, int batched, int nsplit, void* stream) {
  if (n < 1 || C < 1 || D < 1 || nsplit < 1 || nsplit > 65535 ||
      nsplit > (batched ? n : n * n) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(((C + DW_MC - 1) / DW_MC) * ((D + DW_ND - 1) / DW_ND), nsplit);
  const size_t esize = dtype == 0 ? 4 : 2;
  const size_t smem = (size_t)DW_KS * (DW_XP + DW_GP) * (esize + (dtype == 0 ? 4 : 0));
  const int vec = (C * esize) % 16 == 0 && (D * esize) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0;
  float* p = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(cs_probe_dw_tc_kernel<float>, smem)) != cudaSuccess) return err;
    cs_probe_dw_tc_kernel<float><<<grid, 128, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), p, n, C, D, batched, nsplit,
        vec);
  } else {
    if ((err = allow_smem(cs_probe_dw_tc_kernel<__nv_bfloat16>, smem)) != cudaSuccess)
      return err;
    cs_probe_dw_tc_kernel<__nv_bfloat16><<<grid, 128, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), p, n, C, D,
        batched, nsplit, vec);
  }
  return cudaGetLastError();
}

const char* cs_probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
