// Ring-fix kernels of the xring cubed-sphere convolution for Hopper (sm_90a).
//
// The xring conv computes a 3x3 cubed-sphere conv as two full 6-face SAME
// convs (zero padding; cuDNN, outside these kernels), one per weight group,
// plus an O(perimeter) correction that brings in the halo: along each face
// edge e the zero-padded ghost line is replaced by the ghost strip
// ext[b, f, e] (B, 6, 4, n+2, Cin; edges S, N, W, E; positions 0 and n+1 are
// the corner ghosts).  Per face f (weight group g: equatorial for f < 4,
// polar otherwise), edge e and along-edge position t:
//     fix_e[t, :] = sum_{dy<3} ext[b, f, e, t+dy, :] . K_g[tap(e, dy)]
// with tap(S, dy) = K[0, dy], tap(N, dy) = K[2, dy], tap(W, dy) = K[dy, 0],
// tap(E, dy) = K[dy, 2]; and the corner ghosts, which enter through both of
// their edges, once:
//     corner_c = ext[b, f, S or N, 0 or n+1, :] . K_g[corner tap]
// for [sw, se, nw, ne] = (S, 0, K[0,0]), (S, n+1, K[0,2]), (N, 0, K[2,0]),
// (N, n+1, K[2,2]).  Sums in f32.
//
// Two functions, each one launch of one kernel:
// * the fixes (cs_ring_fixes_tc_kernel) replace dlwp_cs_tpu/ops/
//   ring_kernel.py::_ring_kernel (ring_fixes_pallas): the fixes (B, 6, 4,
//   n, D) and the corners (B, 6, 4, D), each rounded once to the input dtype;
// * the fused apply (cs_xring_tc_kernel) replaces ring_kernel.py::
//   _fused_kernel (xring_fused_apply): out = select_f(base_eq, base_po) +
//   S|row 0 + N|row n-1 + W|col 0 + E|col n-1 - sw - se - nw - ne, in that
//   order in f32, rounded once to the output dtype (the bias is added
//   afterwards, in that dtype, by the caller).
// The kernels read the two weight groups' HWIO kernels (3, 3, Cin, D)
// directly, already rounded to the input dtype; the centre tap is unused.
//
// What bounds them on this card: the fused apply is an elementwise pass over
// one SAME-conv output plus O(perimeter) dots; at the ConvLSTM's gate convs
// (n=48, D=128, batch 1) 7.3 MB of bf16 read and written against 35-57
// MFLOP, so device memory sets the least time (2.2 us at 3.35 TB/s).  The
// design, one launch of two kinds of block:
// * ring blocks, one per (weight group, edge, chunk of spb strips, slice of
//   dn output channels): the reference's own formulation, strips @ taps
//   (dlwp_cs_tpu/ops/ring_kernel.py::_fused_kernel), as a GEMM on the tensor
//   cores (cs_tap_gemm.cuh) whose M rows are the (face, item, position)
//   triples of the chunk.  Row t's K vector is positions t..t+2 of its
//   staged strip, so A is row pointers into the strips (no im2col), and B
//   is the edge's three taps, staged once for every face and item of the
//   group.  bfloat16 on mma.sync.m16n8k16, float32 as 3xTF32 with fresh
//   sums per tap.  The epilogue adds the fix to the base line in f32 and
//   rounds once.  The S and N blocks write their whole lines, corners
//   included: for a corner pixel they add the W or E fix of that one row
//   and subtract the corner dot, both computed on the CUDA cores over the
//   slice's channels while the strips and taps land (the W/E strip's own positions
//   are read, not assumed equal to the S/N corner ghosts), in the
//   reference's order; the W and E blocks write rows 1..n-2;
// * copy blocks: rows 1..n-2, columns 1..n-2 of every face are the
//   selected base bit for bit (a base value rounded from f32 back to its
//   own type is itself), copied with 16-byte accesses, four in flight a
//   thread, over as many blocks as fill the card twice.
// The fixes kernel runs the same ring blocks with a store epilogue and
// launches no copy blocks.  The host plan (ops/ring_kernel.py::ring_plan)
// picks spb, dn and the copy blocks; the C side recomputes the shared
// memory and refuses a plan whose count differs.
//
// cs_ring_fixes_kernel and cs_xring_apply_kernel (one block per 8 x 8
// output tile or edge chunk, the fix dots serial on the CUDA cores: 24-32 us
// a launch at the gate shapes, 11-15x the bound) are the kernels the ring
// blocks replaced, kept only as timing rows (ops/conv_variants.py::
// ring_fixes_cudacore, xring_fused_apply_cudacore); no path selects them.
//
// Layouts (channels last, all contiguous):
//   ext   (B, 6, 4, n+2, Cin)    k_*  (3, 3, Cin, D) HWIO
//   base_*, out (B, 6, n, n, D)   fixes (B, 6, 4, n, D)   corners (B, 6, 4, D)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "cs_tap_gemm.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int P = 4;      // along-edge positions per thread in the fix dots
constexpr int MAX_H = 64;  // tile side / edge chunk cap
constexpr int EDGE_S = 0, EDGE_N = 1, EDGE_W = 2, EDGE_E = 3;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// flat HWIO tap index (ky * 3 + kx) of edge e's dy-th tap, and of corner ci
__device__ __forceinline__ int edge_tap(int e, int dy) {
  return e == EDGE_S ? dy : e == EDGE_N ? 6 + dy : e == EDGE_W ? dy * 3 : dy * 3 + 2;
}
__device__ __forceinline__ int corner_tap(int ci) { return (ci >> 1) * 6 + (ci & 1) * 2; }

struct Geom {
  int n, cin, d;
  int h;       // tile side (apply) or edge chunk (fixes)
  int ntile;   // ceil(n / h)
  int strip;   // staged strip floats: (ceil(h / P) * P + 2) * cin
};

// Stage positions t0 .. t0+len+1 of ghost strip e (contiguous rows of Cin)
// as f32.  Entries past len+2 positions are left as they are: they feed
// only accumulators that are never written.
template <typename T>
__device__ void stage_strip(const T* __restrict__ ef, int e, int t0, int len,
                            const Geom& g, float* strip) {
  const T* src = ef + ((long long)e * (g.n + 2) + t0) * g.cin;
  const int count = (len + 2) * g.cin;
  for (int i = threadIdx.x; i < count; i += THREADS) strip[i] = to_f32(src[i]);
}

// fix[s * d + dd] = sum_dy sum_c strip[s + dy, c] * K[tap(e, dy), c, dd]
// for s < len, in f32.
template <typename T>
__device__ void edge_fixes(const float* strip, const T* __restrict__ k, int e, int len,
                           const Geom& g, float* fix) {
  const int cin = g.cin, d = g.d;
  const int items = d * ((len + P - 1) / P);
  for (int item = threadIdx.x; item < items; item += THREADS) {
    const int dd = item % d;
    const int s0 = (item / d) * P;
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      const T* __restrict__ kp = k + (long long)edge_tap(e, dy) * cin * d + dd;
      const float* sp = strip + (s0 + dy) * cin;
      for (int c = 0; c < cin; ++c) {
        const float w = to_f32(kp[(long long)c * d]);
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(sp[p * cin + c], w, acc[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (s0 + p < len) fix[(s0 + p) * d + dd] = acc[p];
  }
}

// out[dd] = sum_c src[c] * K[corner_tap(ci), c, dd], in f32
template <typename T>
__device__ void corner_dot(const float* src, const T* __restrict__ k, int ci, const Geom& g,
                           float* out) {
  for (int dd = threadIdx.x; dd < g.d; dd += THREADS) {
    const T* __restrict__ kp = k + (long long)corner_tap(ci) * g.cin * g.d + dd;
    float acc = 0.f;
    for (int c = 0; c < g.cin; ++c) acc = fmaf(src[c], to_f32(kp[(long long)c * g.d]), acc);
    out[dd] = acc;
  }
}

// Grid (4 * ntile, 6, B): block = (edge, chunk of h positions), face, item.
template <typename T>
__global__ void __launch_bounds__(THREADS) cs_ring_fixes_kernel(
    const T* __restrict__ ext, const T* __restrict__ keq, const T* __restrict__ kpo,
    T* __restrict__ fixes, T* __restrict__ corners, Geom g) {
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;              // [strip]
  float* fix = smem + g.strip;      // [h][d]
  float* cor = fix + g.h * g.d;     // [2][d]
  const int n = g.n, d = g.d;
  const int e = blockIdx.x / g.ntile;
  const int t0 = (blockIdx.x % g.ntile) * g.h;
  const int len = min(g.h, n - t0);
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const T* __restrict__ k = f < 4 ? keq : kpo;
  stage_strip(ext + face * 4 * (n + 2) * g.cin, e, t0, len, g, strip);
  __syncthreads();
  edge_fixes(strip, k, e, len, g, fix);
  // S/N strips end in the corner ghosts: [sw, se] on S, [nw, ne] on N
  const bool lo = e <= EDGE_N && t0 == 0, hi = e <= EDGE_N && t0 + len == n;
  if (lo) corner_dot(strip, k, 2 * e, g, cor);
  if (hi) corner_dot(strip + (len + 1) * g.cin, k, 2 * e + 1, g, cor + d);
  __syncthreads();
  T* out = fixes + ((face * 4 + e) * n + t0) * d;
  for (int i = threadIdx.x; i < len * d; i += THREADS) out[i] = from_f32<T>(fix[i]);
  T* cor_out = corners + (face * 4 + 2 * e) * d;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    if (lo) cor_out[i] = from_f32<T>(cor[i]);
    if (hi) cor_out[d + i] = from_f32<T>(cor[d + i]);
  }
}

// V consecutive elements as one 16-byte (or, for V = 1, scalar) access
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(p[i]);
  }
}
template <typename T, int V>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = src[i];
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = from_f32<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(in[i]);
  }
}

// Grid (ntile * ntile, 6, B): block = (h x h output tile, face, item).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) cs_xring_apply_kernel(
    const T* __restrict__ base_eq, const T* __restrict__ base_po, const T* __restrict__ ext,
    const T* __restrict__ keq, const T* __restrict__ kpo, T* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;               // [strip]
  float* fix = smem + g.strip;       // [4][h][d]  edges S, N, W, E
  float* cor = fix + 4 * g.h * g.d;  // [4][d]     sw, se, nw, ne
  const int n = g.n, d = g.d, h = g.h;
  const int r0 = (blockIdx.x / g.ntile) * h, c0 = (blockIdx.x % g.ntile) * h;
  const int th = min(h, n - r0), tw = min(h, n - c0);
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const T* __restrict__ k = f < 4 ? keq : kpo;
  const T* __restrict__ base = (f < 4 ? base_eq : base_po) + face * n * n * d;
  const bool has[4] = {r0 == 0, r0 + th == n, c0 == 0, c0 + tw == n};
  // the boundary lines this tile holds, and its corners (from the S/N strips)
  for (int e = 0; e < 4; ++e) {
    if (!has[e]) continue;
    const int t0 = e <= EDGE_N ? c0 : r0, len = e <= EDGE_N ? tw : th;
    __syncthreads();  // the strip buffer is free again
    stage_strip(ext + face * 4 * (n + 2) * g.cin, e, t0, len, g, strip);
    __syncthreads();
    edge_fixes(strip, k, e, len, g, fix + e * h * d);
    if (e <= EDGE_N && has[EDGE_W]) corner_dot(strip, k, 2 * e, g, cor + 2 * e * d);
    if (e <= EDGE_N && has[EDGE_E])
      corner_dot(strip + (len + 1) * g.cin, k, 2 * e + 1, g, cor + (2 * e + 1) * d);
  }
  __syncthreads();
  // one pass over the tile: th rows of tw * d contiguous elements each.  A
  // pixel off the face's boundary ring gets no fix: its output is its base,
  // bit for bit, and is copied as it is.
  const int row_vecs = tw * d / V;
  for (int u = threadIdx.x; u < th * row_vecs; u += THREADS) {
    const int i = r0 + u / row_vecs;
    const int el = (u - (i - r0) * row_vecs) * V;
    const int j = c0 + el / d, dd0 = el - (j - c0) * d;
    const long long off = ((long long)i * n + j) * d + dd0;
    if (i != 0 && i != n - 1 && j != 0 && j != n - 1) {
      copy_vec<T, V>(out + face * n * n * d + off, base + off);
      continue;
    }
    float acc[V];
    load_vec<T, V>(base + off, acc);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int dd = dd0 + q;
      if (i == 0) acc[q] += fix[(EDGE_S * h + j - c0) * d + dd];
      if (i == n - 1) acc[q] += fix[(EDGE_N * h + j - c0) * d + dd];
      if (j == 0) acc[q] += fix[(EDGE_W * h + i - r0) * d + dd];
      if (j == n - 1) acc[q] += fix[(EDGE_E * h + i - r0) * d + dd];
      if (i == 0 && j == 0) acc[q] -= cor[0 * d + dd];
      if (i == 0 && j == n - 1) acc[q] -= cor[1 * d + dd];
      if (i == n - 1 && j == 0) acc[q] -= cor[2 * d + dd];
      if (i == n - 1 && j == n - 1) acc[q] -= cor[3 * d + dd];
    }
    store_vec<T, V>(out + face * n * n * d + off, acc);
  }
}

// ---- the ring blocks on the tensor cores, and the copy blocks -------------

struct RingGeom {
  int batch, n, cin, d;
  int cp;        // staged 16-bit units per strip position (an odd multiple of 8)
  int kpt;       // K units per tap: Cin rounded up to a k step
  int kpe;       // the same in elements (B rows per tap)
  int dn;        // output channels per ring block (a multiple of 16)
  int nsplit;    // slices of D
  int spb;       // strips per ring block
  int nch[2];    // strip chunks per edge of the equatorial / polar group
  int nring;     // ring blocks
  int ncopy;     // copy blocks (the fused apply; 0 for the fixes)
  int wpitch;    // B pitch in elements: dn + 8
  int a_units;   // one staged-cell buffer, 16-bit units
  int w_bytes;   // B
  int raw;       // Cin's bytes not a multiple of 16: bytes of one strip's raw copy, else 0
  int raw_off;   // where the raw copies start
  int smem;      // bytes
  bool avec, wvec;  // 16-byte staging of the strips / the taps
};

// Staged cells per strip: positions 0..n+1 of the block's edge strip, then
// four more, for the S/N blocks [P0, 0, 0, P(n+1)]: the windows of the
// corner dots (taps dy = 0..2: sw/nw reads P0 with the dy = 0 tap, se/ne
// P(n+1) with the dy = 2 one, so they are rows of the edge's own GEMM).
__host__ __device__ inline int ring_cells(int n) { return n + 6; }

// The plan's numbers (ops/ring_kernel.py::ring_geom computes the same); false
// on sizes the kernel cannot take.
bool make_ring_geom(int batch, int n, int cin, int d, int esize, int spb, int dn, int ncopy,
                    bool apply, RingGeom& g) {
  if (batch < 1 || n < 2 || cin < 1 || d < 1 || spb < 1 || spb > 8 || dn < 16 ||
      dn % 16 || ncopy < 0 || (apply && n > 2 && ncopy < 1) || (!apply && ncopy != 0))
    return false;
  g.batch = batch;
  g.n = n;
  g.cin = cin;
  g.d = d;
  const int upe = esize / 2, step = 16 / upe;  // units per element, elements per k step
  int cpe = (cin + 8 / upe - 1) / (8 / upe) * (8 / upe);
  while ((cpe * upe / 8) % 2 == 0) cpe += 8 / upe;  // an odd multiple of 8 units
  g.cp = cpe * upe;
  g.kpe = (cin + step - 1) / step * step;
  g.kpt = g.kpe * upe;
  g.dn = dn;
  g.nsplit = (d + dn - 1) / dn;
  g.spb = spb;
  g.nch[0] = (4 * batch + spb - 1) / spb;
  g.nch[1] = (2 * batch + spb - 1) / spb;
  g.nring = 4 * (g.nch[0] + g.nch[1]) * g.nsplit;
  g.ncopy = ncopy;
  g.wpitch = dn + 8;
  g.a_units = (spb * ring_cells(n) + 1) * g.cp;
  g.w_bytes = 3 * g.kpe * g.wpitch * esize;
  long long smem = (long long)g.w_bytes + 2LL * g.a_units +
                   (apply ? (long long)spb * n * (dn + 8) * esize + 4LL * 2 * spb : 0);
  g.raw = (cin * esize) % 16 ? ((n + 2) * cin * esize + 15) / 16 * 16 + 16 : 0;
  g.raw_off = (int)((smem + 15) / 16 * 16);
  if (g.raw) smem = g.raw_off + (long long)spb * g.raw;
  if (smem > 232448 || (long long)g.nring + ncopy > 0x7fffffffLL) return false;
  g.smem = (int)smem;
  return true;
}

// rows m < nrows of dn channels from src(m) (a row's first channel, d0 of
// its pixel) into R at a pitch of rp; zero past dnv.  vec: 16-byte copies
// by cp.async (in flight until the caller waits), else ordinary loads.  A
// thread keeps one column slot of every groups-th row.
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* R, int nrows, int dn, int dnv, int rp, bool vec,
                                           const T* any, Src src) {
  constexpr int VE = 16 / sizeof(T);
  const int per = vec ? dn / VE : dn, step = vec ? VE : 1;
  const int groups = max(1, tapgemm::THREADS / per);
  for (int j = threadIdx.x; j < groups * per; j += tapgemm::THREADS) {
    const int m0 = j / per, col = (j - m0 * per) * step;
    for (int m = m0; m < nrows; m += groups) {
      const bool on = col < dnv;
      if (vec)
        cs3x3::cp_async16(R + m * rp + col, on ? src(m) + col : any, on ? 16 : 0);
      else
        R[m * rp + col] = on ? src(m)[col] : from_f32<T>(0.f);
    }
  }
}

// One ring block (see the header).  APPLY: the fused apply's epilogue into
// out (V: 16-byte staging of the base lines where V elements are 16 bytes),
// the corner handoff through cx and cnt; else the fixes' into fixes and
// corners.
template <typename T, bool APPLY, int V>
__device__ __forceinline__ void ring_block(int r, const T* __restrict__ base_eq,
                                           const T* __restrict__ base_po,
                                           const T* __restrict__ ext, const T* __restrict__ keq,
                                           const T* __restrict__ kpo, T* __restrict__ out,
                                           T* __restrict__ fixes, T* __restrict__ corners,
                                           float* __restrict__ cx, int* __restrict__ cnt,
                                           const RingGeom& g, unsigned char* smem) {
  using tapgemm::bf16;
  const int n = g.n, d = g.d, cin = g.cin, dn = g.dn;
  const int slice = r % g.nsplit;
  r /= g.nsplit;
  const int per_edge = g.nch[0] + g.nch[1];
  const int e = r / per_edge;
  int ch = r - e * per_edge;
  const int grp = ch < g.nch[0] ? 0 : 1;
  if (grp) ch -= g.nch[0];
  const int nf = grp ? 2 : 4, f0 = grp ? 4 : 0;
  const int s0 = ch * g.spb, ns = min(g.spb, g.batch * nf - s0);
  const int d0 = slice * dn, dnv = min(dn, d - d0);
  const bool sn = e <= EDGE_N;
  const int cps = ring_cells(n), cp = g.cp;
  const T* __restrict__ k = grp ? kpo : keq;
  const T* __restrict__ base = grp ? base_po : base_eq;
  auto face_of = [&](int s) -> long long {  // batch item * 6 + face of strip s
    const int sg = s0 + s;
    return (long long)(sg / nf) * 6 + f0 + sg % nf;
  };
  // the output pixel of position t along the edge, strip s
  auto pixel = [&](int s, int t) -> long long {
    const int i = e == EDGE_S ? 0 : e == EDGE_N ? n - 1 : t;
    const int j = e <= EDGE_N ? t : e == EDGE_W ? 0 : n - 1;
    return (face_of(s) * n + i) * n + j;
  };
  // the corner [sw, se, nw, ne] at the edge's start (end = 0) or end (1)
  auto corner = [&](int end) { return sn ? 2 * e + end : 2 * end + (e == EDGE_E); };
  T* W = reinterpret_cast<T*>(smem);  // the edge's 3 taps
  bf16* A = reinterpret_cast<bf16*>(smem + g.w_bytes);
  const int bp = dn + 8;                          // base tile pitch
  T* bt = reinterpret_cast<T*>(A + g.a_units);  // [s * n + t][bp]
  int* last = reinterpret_cast<int*>(bt + g.spb * n * bp);  // [s * 2 + end]

  tapgemm::stage_taps<T>(W, 3, g.kpe, cin, dn, d0, d, d, g.wpitch, g.wvec, [&](int dy) {
    return k + (long long)edge_tap(e, dy) * cin * d;
  });
  const int ncells = ns * cps + 1;  // one zero cell past the last strip
  // strip s's positions, contiguous in device memory
  auto strip = [&](int s) { return ext + (face_of(s) * 4 + e) * (n + 2) * cin; };
  unsigned char* raw = smem + g.raw_off;
  if (g.raw) {
    // Cin's bytes are not a multiple of 16: each strip as one run of
    // 16-byte copies (from the 16-byte boundary before it: the granules
    // that hold a tensor's bytes lie in its allocation), repacked below
    const int per = g.raw / 16;
    for (int u = threadIdx.x; u < ns * per; u += tapgemm::THREADS) {
      const int s = u / per, q = u - s * per;
      const uintptr_t start = reinterpret_cast<uintptr_t>(strip(s));
      const uintptr_t from = (start & ~uintptr_t(15)) + 16 * q;
      const bool on = from < start + (uintptr_t)(n + 2) * cin * sizeof(T);
      cs3x3::cp_async16(raw + s * g.raw + 16 * q,
                        on ? reinterpret_cast<const void*>(from) : ext, on ? 16 : 0);
    }
  } else {
    tapgemm::stage_cells<T>(A, ncells, cin, cp, g.avec, ext, [&](int c) -> const T* {
      const int s = c / cps, p = c - s * cps;
      if (s >= ns) return nullptr;
      if (p < n + 2) return strip(s) + (long long)p * cin;
      const int x = p - (n + 2);  // S/N: [P0, 0, 0, P(n+1)]
      return sn && (x == 0 || x == 3) ? strip(s) + (long long)(x ? n + 1 : 0) * cin : nullptr;
    });
  }
  if constexpr (APPLY)
    stage_rows<T>(bt, ns * n, dn, dnv, bp, V * sizeof(T) == 16, base, [&](int m) {
      const int s = m / n;
      return base + pixel(s, m - s * n) * d + d0;
    });
  cs3x3::cp_async_commit();
  cs3x3::cp_async_wait_all();
  __syncthreads();
  if (g.raw) {  // the raw strips into cells: Cin values, zeros to cp; the extra cells
    constexpr int UPE = sizeof(T) / 2;
    const int cpe = cp / UPE;
    for (int s = 0; s < ns; ++s) {
      const T* rs = reinterpret_cast<const T*>(
          raw + s * g.raw + (reinterpret_cast<uintptr_t>(strip(s)) & 15));
      bf16* as = A + s * cps * cp;
      for (int u = threadIdx.x; u < cps * cpe; u += tapgemm::THREADS) {
        const int p = u / cpe, k = u - p * cpe;
        // S/N: cells n+2 and n+5 repeat positions 0 and n+1
        const int pos = p < n + 2 ? p : sn && p == n + 2 ? 0 : sn && p == n + 5 ? n + 1 : -1;
        tapgemm::put(as, p * cp + k * UPE,
                     pos >= 0 && k < cin ? rs[pos * cin + k] : from_f32<T>(0.f));
      }
    }
    for (int u = threadIdx.x; u < cpe; u += tapgemm::THREADS)  // the zero cell
      tapgemm::put(A + ns * cps * cp, u * UPE, from_f32<T>(0.f));
    __syncthreads();
  }

  // the edge's GEMM: n rows a strip, + the two corner dots for S/N
  const int rps = sn ? n + 2 : n;
  const int mt = (ns * rps + 15) / 16, pairs = dn / 16;
  const tapgemm::Gemm gm{ns * rps, 3, g.kpt, pairs,
                         min(tapgemm::MG, max(1, mt * pairs / (tapgemm::THREADS / 32))),
                         g.wpitch};
  auto row_off = [=](int m) {
    const int s = m / rps, t = m - s * rps;
    return (s * cps + (t < n ? t : t == n ? n + 2 : n + 3)) * cp;
  };
  auto tap_off = [=](int dy) { return dy * cp; };
  if constexpr (APPLY) {
    tapgemm::gemm<T>(gm, A, W, row_off, tap_off, [&](int m, int nl, float v0, float v1) {
      const int s = m / rps, t = m - s * rps;
      if (t >= n || t == 0 || t == n - 1) {  // a corner's term: to the handoff
        const int end = t == 0 || t == n ? 0 : 1;
        const int term = t >= n ? 2 : sn ? 0 : 1;  // S|N fix, W|E fix, corner dot
        float* x = cx + ((face_of(s) * 4 + corner(end)) * 3 + term) * d + d0 + nl;
        if (nl < dnv) x[0] = v0;
        if (nl + 1 < dnv) x[1] = v1;
        return;
      }
      const long long o = pixel(s, t) * d + d0 + nl;
      const T* b = bt + (s * n + t) * bp + nl;
      if (nl < dnv) out[o] = from_f32<T>(to_f32(b[0]) + v0);
      if (nl + 1 < dnv) out[o + 1] = from_f32<T>(to_f32(b[1]) + v1);
    });
    // The corners: the S/N block of a corner holds its S|N fix and corner
    // dot, the W/E block its W|E fix.  Each publishes its terms, then counts
    // itself in; the second of the two to arrive writes the corner
    // (base + S|N fix + W|E fix - corner, the same sum whichever it is) and
    // resets the count for the next launch.
    __syncthreads();
    if (threadIdx.x < 2 * ns) {
      __threadfence();  // after the barrier: the whole block's terms before the count
      const int s = threadIdx.x >> 1, end = threadIdx.x & 1;
      int* c = cnt + (face_of(s) * 4 + corner(end)) * g.nsplit + slice;
      const int second = atomicAdd(c, 1) == 1;
      if (second) *c = 0;
      last[threadIdx.x] = second;
    }
    __syncthreads();
    for (int u = threadIdx.x; u < 2 * ns * dnv; u += tapgemm::THREADS) {
      const int dl = u % dnv, se = u / dnv, s = se >> 1, end = se & 1;
      if (!last[se]) continue;
      const int t = end ? n - 1 : 0;
      const float* x = cx + ((face_of(s) * 4 + corner(end)) * 3) * d + d0 + dl;
      float a = to_f32(bt[(s * n + t) * bp + dl]);
      a += __ldcg(x);          // S|N fix
      a += __ldcg(x + d);      // W|E fix
      a -= __ldcg(x + 2 * d);  // corner
      out[pixel(s, t) * d + d0 + dl] = from_f32<T>(a);
    }
  } else {
    tapgemm::gemm<T>(gm, A, W, row_off, tap_off, [&](int m, int nl, float v0, float v1) {
      const int s = m / rps, t = m - s * rps;
      T* o = t < n ? fixes + ((face_of(s) * 4 + e) * n + t) * d + d0 + nl
                   : corners + (face_of(s) * 4 + 2 * e + t - n) * d + d0 + nl;
      if (nl < dnv) o[0] = from_f32<T>(v0);
      if (nl + 1 < dnv) o[1] = from_f32<T>(v1);
    });
  }
}

// A copy block: rows 1..n-2, columns 1..n-2 of the faces, the q-th of
// ncopy: interior rows q, q + ncopy, ..., a thread's vectors of several
// rows in flight at once (UNROLL loads, then UNROLL stores).
template <typename T, int V>
__device__ __forceinline__ void copy_block(const T* __restrict__ base_eq,
                                           const T* __restrict__ base_po, T* __restrict__ out,
                                           const RingGeom& g, int q) {
  using Vec = typename std::conditional<V * sizeof(T) == 16, uint4, T>::type;
  constexpr int UNROLL = 8;
  const int n = g.n, rows = g.batch * 6 * (n - 2);
  const int len = (n - 2) * g.d / V;  // vectors in a row's interior
  const int per = (len + tapgemm::THREADS - 1) / tapgemm::THREADS;  // a thread's, per row
  const int items = (rows - q + g.ncopy - 1) / g.ncopy * per;
  const Vec* beq = reinterpret_cast<const Vec*>(base_eq);
  const Vec* bpo = reinterpret_cast<const Vec*>(base_po);
  Vec* o = reinterpret_cast<Vec*>(out);
  for (int it0 = 0; it0 < items; it0 += UNROLL) {
    Vec buf[UNROLL];
    long long off[UNROLL];
#pragma unroll
    for (int w = 0; w < UNROLL; ++w) {
      const int it = it0 + w, k = it / per;
      const int v = threadIdx.x + (it - k * per) * tapgemm::THREADS;
      const int u = q + k * g.ncopy, face = u / (n - 2);
      off[w] = -1;
      if (it < items && v < len) {
        off[w] = (((long long)face * n + 1 + (u - face * (n - 2))) * n + 1) * (g.d / V) + v;
        buf[w] = (face % 6 < 4 ? beq : bpo)[off[w]];
      }
    }
#pragma unroll
    for (int w = 0; w < UNROLL; ++w)
      if (off[w] >= 0) o[off[w]] = buf[w];
  }
}

// Grid: nring ring blocks and ncopy copy blocks, alternating while both
// last (so that the copy streams from the start beside the ring blocks'
// GEMMs), then the rest of the more numerous kind.
template <typename T, int V>
__global__ void __launch_bounds__(tapgemm::THREADS, 2) cs_xring_tc_kernel(
    const T* __restrict__ base_eq, const T* __restrict__ base_po, const T* __restrict__ ext,
    const T* __restrict__ keq, const T* __restrict__ kpo, T* __restrict__ out,
    float* __restrict__ cx, int* __restrict__ cnt, RingGeom g) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int both = min(g.nring, g.ncopy), b = blockIdx.x;
  const bool copy = b < 2 * both ? (b & 1) : g.ncopy > g.nring;
  const int idx = b < 2 * both ? b >> 1 : b - both;
  if (copy) {
    copy_block<T, V>(base_eq, base_po, out, g, idx);
    return;
  }
  ring_block<T, true, V>(idx, base_eq, base_po, ext, keq, kpo, out, nullptr, nullptr, cx, cnt, g,
                         smem_tc);
}

// Grid: nring ring blocks.
template <typename T>
__global__ void __launch_bounds__(tapgemm::THREADS, 2) cs_ring_fixes_tc_kernel(
    const T* __restrict__ ext, const T* __restrict__ keq, const T* __restrict__ kpo,
    T* __restrict__ fixes, T* __restrict__ corners, RingGeom g) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  ring_block<T, false, 1>(blockIdx.x, nullptr, nullptr, ext, keq, kpo, nullptr, fixes, corners,
                          nullptr, nullptr, g, smem_tc);
}

// Lets a kernel take up to the card's opt-in shared memory per block (wide
// D or Cin past the default 48 KB); set once per kernel and device.
template <typename K>
cudaError_t allow_large_smem(K kernel, std::atomic<unsigned long long>& done, int device) {
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

bool make_geom(int batch, int n, int cin, int d, int h, Geom& g) {
  if (batch < 1 || batch > 65535 || n < 2 || cin < 1 || d < 1 || h < 1 || h > MAX_H)
    return false;
  g.n = n;
  g.cin = cin;
  g.d = d;
  g.h = h < n ? h : n;
  g.ntile = (n + g.h - 1) / g.h;
  g.strip = (((g.h + P - 1) / P) * P + 2) * cin;
  return true;
}

template <typename T>
cudaError_t launch_fixes(const void* ext, const void* keq, const void* kpo, void* fixes,
                         void* corners, int batch, const Geom& g, int device,
                         cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem = sizeof(float) * ((size_t)g.strip + (size_t)(g.h + 2) * g.d);
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem(cs_ring_fixes_kernel<T>, done, device);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(4 * g.ntile, 6, batch);
  cs_ring_fixes_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(ext), static_cast<const T*>(keq), static_cast<const T*>(kpo),
      static_cast<T*>(fixes), static_cast<T*>(corners), g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_apply(const void* beq, const void* bpo, const void* ext, const void* keq,
                         const void* kpo, void* out, int batch, const Geom& g, int device,
                         cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem = sizeof(float) * ((size_t)g.strip + (size_t)(4 * g.h + 4) * g.d);
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem(cs_xring_apply_kernel<T, V>, done, device);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(g.ntile * g.ntile, 6, batch);
  cs_xring_apply_kernel<T, V><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(beq), static_cast<const T*>(bpo), static_cast<const T*>(ext),
      static_cast<const T*>(keq), static_cast<const T*>(kpo), static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_tc(bool apply, const void* beq, const void* bpo, const void* ext,
                      const void* keq, const void* kpo, void* out, void* fixes, void* corners,
                      void* cx, void* cnt, const RingGeom& g, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> done_apply{0}, done_fixes{0};
  const T *e = static_cast<const T*>(ext), *kq = static_cast<const T*>(keq),
          *kp = static_cast<const T*>(kpo);
  if (apply) {
    if (g.smem > 48 * 1024) {
      cudaError_t err = allow_large_smem(cs_xring_tc_kernel<T, V>, done_apply, device);
      if (err != cudaSuccess) return err;
    }
    cs_xring_tc_kernel<T, V><<<g.nring + g.ncopy, tapgemm::THREADS, g.smem, stream>>>(
        static_cast<const T*>(beq), static_cast<const T*>(bpo), e, kq, kp, static_cast<T*>(out),
        static_cast<float*>(cx), static_cast<int*>(cnt), g);
  } else {
    if (g.smem > 48 * 1024) {
      cudaError_t err = allow_large_smem(cs_ring_fixes_tc_kernel<T>, done_fixes, device);
      if (err != cudaSuccess) return err;
    }
    cs_ring_fixes_tc_kernel<T><<<g.nring, tapgemm::THREADS, g.smem, stream>>>(
        e, kq, kp, static_cast<T*>(fixes), static_cast<T*>(corners), g);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  device: the current device, which the
// stream belongs to.  h: positions per edge chunk (at most 64).  The last
// size is unused (the entry points share one signature shape).  Returns a
// cudaError_t (0 = success).
int cs_ring_fixes_launch(int dtype, int device, const void* ext, const void* keq,
                         const void* kpo, void* fixes, void* corners, int batch, int n,
                         int cin, int d, int h, int unused, void* stream) {
  (void)unused;
  Geom g;
  if (device < 0 || device >= 64 || !make_geom(batch, n, cin, d, h, g))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fixes<float>(ext, keq, kpo, fixes, corners, batch, g, device, s);
  if (dtype == 1)
    return launch_fixes<__nv_bfloat16>(ext, keq, kpo, fixes, corners, batch, g, device, s);
  return cudaErrorInvalidValue;
}

// h: output tile side (at most 64).  vec: 1 for scalar accesses, or 16-byte
// accesses (4 float32 / 8 bfloat16 elements; D must be a multiple).
int cs_xring_apply_launch(int dtype, int device, const void* base_eq, const void* base_po,
                          const void* ext, const void* keq, const void* kpo, void* out,
                          int batch, int n, int cin, int d, int h, int vec, void* stream) {
  Geom g;
  if (device < 0 || device >= 64 || !make_geom(batch, n, cin, d, h, g))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && d % 4 == 0)
    return launch_apply<float, 4>(base_eq, base_po, ext, keq, kpo, out, batch, g, device, s);
  if (dtype == 0 && vec == 1)
    return launch_apply<float, 1>(base_eq, base_po, ext, keq, kpo, out, batch, g, device, s);
  if (dtype == 1 && vec == 8 && d % 8 == 0)
    return launch_apply<__nv_bfloat16, 8>(base_eq, base_po, ext, keq, kpo, out, batch, g,
                                          device, s);
  if (dtype == 1 && vec == 1)
    return launch_apply<__nv_bfloat16, 1>(base_eq, base_po, ext, keq, kpo, out, batch, g,
                                          device, s);
  return cudaErrorInvalidValue;
}

// The ring blocks on the tensor cores: apply 1 = the fused apply (base_*,
// out, and the corner handoff: cx, float32 (B, 6, 4, 3, D), any contents;
// cnt, int32 (B, 6, 4, nsplit), zero, left zero), 0 = the fixes (fixes,
// corners).  spb, dn and ncopy: ops/ring_kernel.py::ring_plan's, with the
// shared memory they give (checked here).  vec: the base lines' and copy
// blocks' access, 1 (scalar) or 16 bytes (4 float32 / 8 bfloat16 elements;
// D must be a multiple).
int cs_ring_tc_launch(int dtype, int device, int apply, const void* base_eq, const void* base_po,
                      const void* ext, const void* keq, const void* kpo, void* out, void* fixes,
                      void* corners, void* cx, void* cnt, int batch, int n, int cin, int d,
                      int spb, int dn, int ncopy, int vec, int smem, void* stream) {
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  RingGeom g;
  if (esize == 0 || device < 0 || device >= 64 ||
      !make_ring_geom(batch, n, cin, d, esize, spb, dn, ncopy, apply != 0, g) || g.smem != smem)
    return cudaErrorInvalidValue;
  const int vmax = 16 / esize;
  if (vec != 1 && !(vec == vmax && d % vmax == 0)) return cudaErrorInvalidValue;
  g.avec = (cin * esize) % 16 == 0 && aligned16(ext);
  g.wvec = (d * esize) % 16 == 0 && aligned16(keq) && aligned16(kpo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a = apply != 0;
  if (dtype == 0 && vec == 4)
    return launch_tc<float, 4>(a, base_eq, base_po, ext, keq, kpo, out, fixes, corners, cx, cnt,
                               g, device, s);
  if (dtype == 0)
    return launch_tc<float, 1>(a, base_eq, base_po, ext, keq, kpo, out, fixes, corners, cx, cnt,
                               g, device, s);
  if (vec == 8)
    return launch_tc<__nv_bfloat16, 8>(a, base_eq, base_po, ext, keq, kpo, out, fixes, corners,
                                       cx, cnt, g, device, s);
  return launch_tc<__nv_bfloat16, 1>(a, base_eq, base_po, ext, keq, kpo, out, fixes, corners, cx,
                                     cnt, g, device, s);
}

const char* cs_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
