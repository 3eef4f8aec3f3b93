// Small probe kernels for Hopper (sm_90a): the shared-memory store probe and
// the lowering probes of the reference's kernel tools, each a small
// computation with a result that a plain version checks
// (dlwp_cs_tpu_torch/tools/probes.py).
//
// Replaces the TPU kernels
//   * tools/kernel_variants.py::_store_kernel (launched by lane_store):
//     cs_lane_store_kernel.  x stored into 3 channel-offset slices of a
//     scratch (n, 3C) row in shared memory and summed back: 3 x;
//   * tools/mosaic_bisect.py kA (padded-face assembly, ghost rows then ghost
//     columns, output xpad[1:N+1, 2:N+2]) and tools/mosaic_bisect2.py mk (the
//     same scratch with only the ghost rows, or only the W column, written;
//     its four variants differ only in Pallas indexing syntax, so here they
//     are one kernel and an edge mask): cs_probe_assemble_kernel;
//   * mosaic_bisect.py kB (a weight tap selected by program id):
//     cs_probe_select_kernel; kC (a (N, N, C) x (C, D) product, f32 sums):
//     cs_probe_dot_kernel; kD (9 shifted products from a zero-framed
//     scratch): cs_probe_shifted_kernel; kE (a bias add):
//     cs_probe_bias_kernel;
//   * tools/mosaic_bisect3.py k1 (dw as x.reshape(n^2, C)^T . g.reshape(n^2,
//     D), f32) and k2 (the same as a product batched over the columns and a
//     sum over them): cs_probe_dw_kernel, BATCHED false and true.
//
// What bounds them on this card: each moves at most a few MB and does at
// most 0.6 GFLOP, so one launch's latency and, for the products, each
// thread's serial chain of f32 FMAs (CUDA cores; one output per thread)
// bound them.  They are probes of a pattern, not paths to tune: a scratch
// row per block in shared memory, one thread per output, sums in f32 and
// one rounding to the output type.  The sum orders follow the reference
// bodies where the result depends on them: k1 sums every pixel in one
// chain, k2 sums each column's rows first.
//
// Element types: float32 (dtype 0) and bfloat16 (dtype 1); dw outputs are
// float32.  Layouts are contiguous, channels last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

const char* cs_probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
