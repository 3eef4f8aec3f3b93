// The int8 base convolution of the quantized cubed-sphere conv, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The reference computes the quantized conv's base
// term as two zero-padded SAME XLA convolutions, s8 x s8 -> s32, over all six
// faces, and keeps each face's group (dlwp_cs_tpu/ops/quant.py::
// cs_conv3x3_int8 -> _same_conv_int8 -> ops/ringfix.py::_same_conv).  PyTorch
// has no int8 convolution on CUDA (cuDNN's is not reachable from F.conv2d),
// so the port writes one.
//
// What it computes, for face f of batch item b, with g the weight group of f
// (0, equatorial, for faces 0-3; 1, polar, for faces 4-5):
//     acc[i,j,co] = sum_{dy,dx,ci} qx[b,f,i+dy-1,j+dx-1,ci] * qk[g,dy,dx,ci,co]
//     out[b,f,i,j,co] = T(float(acc[i,j,co]) * scale[g,co])
// with qx zero outside the face, acc an exact s32 sum (|acc| <= 9 Cin 127^2
// < 2^31), float(acc) rounded to nearest even, one float32 product and one
// rounding to T (round to nearest even).  Only the group that the face keeps
// is computed: the reference computes both and selects, and the selected
// integers are the same, so the result is bitwise equal to its
// (dlwp_cs_tpu_torch/ops/quant.py::cs_conv3x3_int8_plain holds it so).
//
// What bounds it on this card: at the flagship U-Net's shapes (C48, batch 1)
// a conv is 0.1-0.8 G int8 operations against 1979 T/s of the tensor cores
// and 0.1-2.2 MB against 3.35 TB/s, so bytes bound it, and under a
// microsecond either way: the launch and each block's serial chain of
// staging and products decide its time.  The design is the simplest implicit
// GEMM on the tensor cores: per face, M = the face's pixels, N = Cout, K =
// 9 Cin in the (dy, dx, ci) order of the HWIO kernel's rows.  A block of 4
// warps owns a tile of BM pixels of one face and BN output channels (64 x 64,
// or 128 x 32 where Cout <= 32), walks K in chunks of 64 bytes staged into
// shared memory by cp.async in two stages (the next chunk in flight while
// this one multiplies), and each warp runs mma.sync.m16n8k32 (s8 x s8 ->
// s32) on a 32 x 32 tile.  K and N are padded with zeros inside the kernel
// (cp.async with a source size of 0): no shape is refused, a Cin that is not
// a multiple of 4 only stages byte by byte.  wgmma, TMA and fusing the
// quantize pass into the staging are later work.
//
// Layouts (channels last, all contiguous):
//   qx    (B, 6, n, n, Cin) int8
//   wt    (2, Cout, 9 Cin) int8: each group's HWIO kernel with K contiguous
//         per output channel (the wrapper transposes the quantized kernel)
//   scale (2, Cout) float32: the activation scale times each group's
//         per-channel weight scale, formed on the device by the wrapper
//   out   (B, 6, n, n, Cout) T (float32 or bfloat16)
// Grid (ceil(n^2 / BM), ceil(Cout / BN), 6 B), 128 threads a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "cs_conv3x3_tile.cuh"

namespace {

constexpr int THREADS = 128;    // 4 warps, each a 32 x 32 output tile
constexpr int BK = 64;          // K bytes a stage holds: two k32 steps
constexpr int PITCH = BK + 16;  // bytes a staged row takes: 16-byte aligned
                                // rows whose fragment reads hit 32 banks

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One VEC-byte unit global -> shared; zeros where !ok.  cp.async for 16 and
// 4 bytes (the source aligned to them), a plain byte copy otherwise.
template <int VEC>
__device__ __forceinline__ void stage_unit(int8_t* dst, const int8_t* src, bool ok,
                                           const int8_t* any) {
  if constexpr (VEC == 16) {
    cs3x3::cp_async16(dst, ok ? src : any, ok ? 16 : 0);
  } else if constexpr (VEC == 4) {
    cs3x3::cp_async4(dst, ok ? src : any, ok ? 4 : 0);
  } else {
    *dst = ok ? *src : int8_t(0);
  }
}

// A chunk: BM pixels (from p0) x BK bytes of K (from k0) of the face xf,
// each row the 3x3 window's values at K positions k = tap Cin + ci.
template <int BM, int VEC>
__device__ __forceinline__ void stage_a(int8_t* As, const int8_t* xf, int n, int cin, int K,
                                        int p0, int k0) {
  constexpr int UPR = BK / VEC;  // units per staged row
  for (int u = threadIdx.x; u < BM * UPR; u += THREADS) {
    const int m = u / UPR, kk = (u - m * UPR) * VEC;
    const int p = p0 + m, k = k0 + kk;
    const int8_t* src = nullptr;
    if (p < n * n && k < K) {
      const int tap = k / cin, ci = k - tap * cin;
      const int i = p / n + tap / 3 - 1, j = p % n + tap % 3 - 1;
      if (i >= 0 && i < n && j >= 0 && j < n) src = xf + ((long long)i * n + j) * cin + ci;
    }
    stage_unit<VEC>(As + m * PITCH + kk, src, src != nullptr, xf);
  }
}

// B chunk: BN output channels (from n0) x BK bytes of K (from k0) of the
// group's transposed kernel wg (Cout, K).
template <int BN, int VEC>
__device__ __forceinline__ void stage_b(int8_t* Bs, const int8_t* wg, int cout, int K, int n0,
                                        int k0) {
  constexpr int UPR = BK / VEC;
  for (int u = threadIdx.x; u < BN * UPR; u += THREADS) {
    const int r = u / UPR, kk = (u - r * UPR) * VEC;
    const int co = n0 + r, k = k0 + kk;
    const bool ok = co < cout && k < K;
    stage_unit<VEC>(Bs + r * PITCH + kk, ok ? wg + (long long)co * K + k : wg, ok, wg);
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 32, row) . b (32 x 8, col), s8 x s8 -> s32, exact
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// WM x WN warps of 32 x 32 each: BM = 32 WM pixels, BN = 32 WN channels.
template <typename T, int WM, int WN, int VEC>
__global__ void __launch_bounds__(THREADS)
    cs_conv3x3_int8_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ wt,
                           const float* __restrict__ scale, T* __restrict__ out, int n,
                           int cin, int cout) {
  static_assert(WM * WN * 32 == THREADS, "4 warps");
  constexpr int BM = 32 * WM, BN = 32 * WN;
  __shared__ __align__(16) int8_t As[2][BM * PITCH];
  __shared__ __align__(16) int8_t Bs[2][BN * PITCH];
  const int K = 9 * cin;
  const int face = blockIdx.z;  // b * 6 + f
  const int grp = face % 6 < 4 ? 0 : 1;
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int8_t* xf = qx + (long long)face * n * n * cin;
  const int8_t* wg = wt + (long long)grp * cout * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int nk = (K + BK - 1) / BK;
  stage_a<BM, VEC>(As[0], xf, n, cin, K, p0, 0);
  stage_b<BN, VEC>(Bs[0], wg, cout, K, n0, 0);
  cs3x3::cp_async_commit();
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      // the other stage was last read in iteration it - 1, behind its barrier
      stage_a<BM, VEC>(As[(it + 1) & 1], xf, n, cin, K, p0, (it + 1) * BK);
      stage_b<BN, VEC>(Bs[(it + 1) & 1], wg, cout, K, n0, (it + 1) * BK);
      cs3x3::cp_async_commit();
      cp_async_wait_one();
    } else {
      cs3x3::cp_async_wait_all();
    }
    __syncthreads();
    const int8_t* A = As[it & 1] + (wm * 32 + gid) * PITCH + tig * 4;
    const int8_t* B = Bs[it & 1] + (wn * 32 + gid) * PITCH + tig * 4;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* r = A + mt * 16 * PITCH + s * 32;
        a[mt][0] = ld32(r);                  // row gid, k 4 tig..
        a[mt][1] = ld32(r + 8 * PITCH);      // row gid + 8
        a[mt][2] = ld32(r + 16);             // row gid, k 16 + 4 tig..
        a[mt][3] = ld32(r + 8 * PITCH + 16); // row gid + 8, k 16 + 4 tig..
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* c = B + nt * 8 * PITCH + s * 32;
        b[nt][0] = ld32(c);       // channel gid, k 4 tig..
        b[nt][1] = ld32(c + 16);  // k 16 + 4 tig..
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row gid, channels 2 tig, 2 tig + 1; c2, c3 at row
  // gid + 8
  T* of = out + (long long)face * n * n * cout;
  const float* sg = scale + grp * cout;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 32 + mt * 16 + gid + half * 8;
      if (p >= n * n) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + nt * 8 + tig * 2 + e;
          if (co < cout)
            of[(long long)p * cout + co] =
                from_f32<T>(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), sg[co]));
        }
    }
}

template <typename T, int WM, int WN, int VEC>
cudaError_t launch(const void* qx, const void* wt, const void* scale, void* out, int batch,
                   int n, int cin, int cout, cudaStream_t s) {
  const dim3 grid((unsigned)((n * n + 32 * WM - 1) / (32 * WM)),
                  (unsigned)((cout + 32 * WN - 1) / (32 * WN)), (unsigned)(6 * batch));
  cs_conv3x3_int8_kernel<T, WM, WN, VEC><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<T*>(out), n, cin, cout);
  return cudaGetLastError();
}

template <typename T, int WM, int WN>
cudaError_t launch_vec(int vec, const void* qx, const void* wt, const void* scale, void* out,
                       int batch, int n, int cin, int cout, cudaStream_t s) {
  if (vec == 16) return launch<T, WM, WN, 16>(qx, wt, scale, out, batch, n, cin, cout, s);
  if (vec == 4) return launch<T, WM, WN, 4>(qx, wt, scale, out, batch, n, cin, cout, s);
  return launch<T, WM, WN, 1>(qx, wt, scale, out, batch, n, cin, cout, s);
}

template <typename T>
cudaError_t launch_typed(int vec, const void* qx, const void* wt, const void* scale, void* out,
                         int batch, int n, int cin, int cout, cudaStream_t s) {
  // 128 pixels x 32 channels where one 32-channel tile covers Cout, else 64 x 64
  if (cout <= 32) return launch_vec<T, 4, 1>(vec, qx, wt, scale, out, batch, n, cin, cout, s);
  return launch_vec<T, 2, 2>(vec, qx, wt, scale, out, batch, n, cin, cout, s);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// dtype of out: 0 = float32, 1 = bfloat16.  device: the current device,
// which the stream belongs to.  qx (B, 6, n, n, Cin) int8, wt (2, Cout, 9
// Cin) int8, scale (2, Cout) float32, out (B, 6, n, n, Cout).  Returns a
// cudaError_t (0 = success).
int cs_conv3x3_int8_launch(int dtype, int device, const void* qx, const void* wt,
                           const void* scale, void* out, int batch, int n, int cin, int cout,
                           void* stream) {
  if (device < 0 || device >= 64 || batch < 1 || 6LL * batch > 65535 || n < 1 || cin < 1 ||
      cout < 1 || 9LL * cin > (1LL << 30) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // staged units: 16 bytes where Cin (so every K row and every tap's
  // channels) and both pointers allow, else 4, else single bytes
  const int vec = cin % 16 == 0 && aligned(qx, 16) && aligned(wt, 16) ? 16
                  : cin % 4 == 0 && aligned(qx, 4) && aligned(wt, 4)  ? 4
                                                                      : 1;
  if (dtype == 0)
    return launch_typed<float>(vec, qx, wt, scale, out, batch, n, cin, cout, s);
  return launch_typed<bf16>(vec, qx, wt, scale, out, batch, n, cin, cout, s);
}

const char* cs_conv3x3_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
