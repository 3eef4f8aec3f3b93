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
// Two kernels:
// * cs_ring_fixes_kernel replaces dlwp_cs_tpu/ops/ring_kernel.py::_ring_kernel
//   (ring_fixes_pallas): it writes the fixes (B, 6, 4, n, D) and the corners
//   (B, 6, 4, D), each rounded once to the input dtype.
// * cs_xring_apply_kernel replaces ring_kernel.py::_fused_kernel
//   (xring_fused_apply): out = select_f(base_eq, base_po) + S|row 0 +
//   N|row n-1 + W|col 0 + E|col n-1 - sw - se - nw - ne, in that order in
//   f32, rounded once to the output dtype (the bias is added afterwards, in
//   that dtype, by the caller).
// The kernels read the two weight groups' HWIO kernels (3, 3, Cin, D)
// directly, already rounded to the input dtype; the centre tap is unused.
//
// What bounds them on this card: the fused kernel's work is an elementwise
// pass over one SAME-conv output plus a few perimeter dots; at the
// ConvLSTM's gate convs (n=48, D=128, batch 1) 7.3 MB of bf16 read and
// written against 35 MFLOP, so the least time is set by device memory
// (about 2 us at 3.35 TB/s).  The design: one block per (h x h output tile,
// face, batch item); it reads only the base its face selects (the TPU
// kernel read both, a Mosaic shape constraint), with 16-byte accesses, and
// copies the pixels off the face's boundary ring as they are (a base value
// rounded from f32 back to its own type is itself).  A tile on the boundary
// first computes the fixes of its own boundary lines, and the corners it
// holds, into shared memory in f32: its slice of the ghost strip is staged
// as f32, each thread keeps P along-edge positions of one output channel in
// registers and reads each tap from device memory once for them.  These
// fix loops, on the CUDA cores, set the time of this version: about 15
// instructions per 4 FMAs, 3*Cin in a row, and two edges in a row in a
// corner tile (24-32 us a launch at the gate shapes at batch 1).  Staging
// the taps in shared memory, unrolling the tap loads and register tiles over
// output channels all measured slower; mma for the fix dots is next.  The
// fixes kernel runs the same staging and loop, one block per (edge chunk of
// h positions, face, batch item).
//
// Layouts (channels last, all contiguous):
//   ext   (B, 6, 4, n+2, Cin)    k_*  (3, 3, Cin, D) HWIO
//   base_*, out (B, 6, n, n, D)   fixes (B, 6, 4, n, D)   corners (B, 6, 4, D)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

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

const char* cs_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
