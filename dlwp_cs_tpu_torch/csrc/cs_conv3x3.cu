// Fused halo-pad + 3x3 cubed-sphere convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel dlwp_cs_tpu/ops/pallas_conv.py::_kernel in all four
// of its launch shapes: the whole-face launch (_forward, grid (B, 6)); the
// row-banded launch (_forward_blocked, h < n), whose band ghost rows are the
// face's own neighbouring rows and whose band corners are the W/E ghost
// columns at those rows (_blocked_ext); and the two shard-local launches of
// the spatially decomposed path, on a shard's row band
// (dlwp_cs_tpu/parallel/pallas_band.py::_forward, #8) and on its tile
// (dlwp_cs_tpu/parallel/pallas_tile.py::_forward, #9).  The kernel works on a
// local block of H rows and W columns of every face (H = W = n for a whole
// face, H = n / S for a band, H <= W for a tile) whose ghost rows -1 and H
// and ghost columns -1 and W arrive in ext; a row tile of h < H rows inside
// the block is the normal case, so one kernel body covers all four.
//
// What it computes, per face f of batch item b, with P the (H+2) x (W+2)
// padded block  P[0,:] = ext S, P[H+1,:] = ext N, P[1..H,0] = ext W[1..H],
// P[1..H,W+1] = ext E[1..H], P[1..H,1..W] = x:
//     out[i,j,:] = sum_{dy,dx} P[i+dy, j+dx, :] . K_g[dy,dx] + b_g
// with g the equatorial group for faces 0-3 and the polar group for 4-5, f32
// accumulation and one rounding to x's dtype at the end.  Weights and biases
// arrive already rounded to x's dtype (the wrapper checks).
//
// What bounds it on this card, and the design: both dtypes run on the
// tensor cores (the header of cs_conv3x3_tile.cuh has the tap loop).  At
// the serving shapes (C48 U-Net, batch 1) the work per conv is 0.05-0.4
// GFLOP and under 1 MB of traffic, well under a microsecond at the H100's
// peak rates, so latency bounds it: the staging into shared memory and
// each block's serial chain of products.  At batch 8 and above the
// products bound it: the tensor cores with the fragment loads that feed
// them.  It answers with an implicit GEMM on mma.sync (bfloat16:
// m16n8k16; float32: m16n8k8 in TF32, three products per step, 3xTF32): a
// block keeps its face group's weights for its output-channel slice
// resident in shared memory and walks several row tiles of that group
// (tpb), staging each Cin chunk of a tile's padded rows once, by cp.async
// into two stages, while the previous chunk multiplies.  The host plan
// (ops/hopper_conv.py::tc_plan) sizes the tiles, slices and walks so that
// a batch-1 face set fills the 132 SMs and a batch-16 one keeps several
// blocks per SM; float32 values take twice the shared memory, so its
// slices are narrower where the weights are large.  The padded tile never
// exists in device memory: the W/E ghost columns and the ghost rows go
// straight into shared memory.  A shard's band or tile is a quarter of a
// face or less, so the same bound holds there with fewer tiles per launch;
// the halo exchange that fills ext runs before the launch, outside the
// kernel.  wgmma (A from registers, 64-row tiles) and TMA are not used:
// mma.sync and cp.async first.  The CUDA-core loop that both dtypes ran
// before (conv_tile, register tiles of 4 pixels x 8 channels) stays
// compiled as a timing row (cs_conv3x3_cc_launch).
//
// Layouts (channels last, all contiguous):
//   x    (B, 6, H, W, Cin)        ext (B, 6, 4, W+2, Cin)   edges S, N, W, E
//   k_*  (3, 3, Cin, Cout) HWIO   b_* (Cout,)               out (B, 6, H, W, Cout)
// The W/E ghost columns sit at positions 1..H of their W+2 strips, so H <= W.
// A 1-D grid of nslices * (P_eq + P_pole) blocks, each walking tpb (batch
// item, face of its group, row tile) items of one (face group, Cout slice)
// (GridWalk), the tap loop tc_conv; where a slice's weights and two stages
// do not fit the shared memory (the bfloat16 forward from Cin = 512), the
// weights ride in the stages with each chunk (wstream = 1).  The
// CUDA-core timing row: grid (row tiles * Cout slices, 6, B), one block per
// (row tile, face, batch item, Cout slice), the tap loop conv_tile.  Both
// loops live in cs_conv3x3_tile.cuh, shared with the band conv fused with
// the band-row exchange (cs_band_overlap.cu, #11); this file adds their
// ghost cells (ext).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "cs_conv3x3_tile.cuh"

namespace {

using namespace cs3x3;

// Ghost cells from the strips ext (B, 6, 4, W+2, Cin) [S, N, W, E]: the S/N
// rows whole (corners included), the W/E columns at positions 1..H.
template <typename T>
struct ExtGhost {
  const T* __restrict__ ext;
  int rows, cols, cin;
  // the ghost cell's first channel
  __device__ __forceinline__ const T* cell(long long face, int fr, int pc) const {
    const T* ef = ext + face * 4 * (cols + 2) * cin;
    long long off;
    if (fr == -1) off = (0LL * (cols + 2) + pc) * cin;         // S ghost row
    else if (fr == rows) off = (1LL * (cols + 2) + pc) * cin;  // N ghost row
    else if (pc == 0) off = (2LL * (cols + 2) + fr + 1) * cin; // W ghost column
    else off = (3LL * (cols + 2) + fr + 1) * cin;              // E ghost column
    return ef + off;
  }
  __device__ __forceinline__ float operator()(long long face, int fr, int pc, int ci) const {
    return to_f32(cell(face, fr, pc)[ci]);
  }
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) cs_conv3x3_kernel(
    const T* __restrict__ x, const T* __restrict__ ext,
    const T* __restrict__ keq, const T* __restrict__ kpo,
    const T* __restrict__ beq, const T* __restrict__ bpo,
    T* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = (blockIdx.x / g.nslices) * g.h;
  const int co0 = (blockIdx.x % g.nslices) * g.cs;
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  conv_tile(x, ExtGhost<T>{ext, g.rows, g.cols, g.cin}, keq, kpo, beq, bpo, out, g, r0, co0,
            f, face, smem);
}

// The outputs: f32 sums + the group's bias, one rounding to T.
template <typename T>
struct FwdEpi {
  T* __restrict__ out;
  const T* __restrict__ beq;
  const T* __restrict__ bpo;
  int rows, cols, cout;
  __device__ __forceinline__ void store(const TcTile& t, int i, int j, int n, float v0,
                                        float v1) const {
    if (n >= cout) return;
    const T* __restrict__ bias = t.f < 4 ? beq : bpo;
    T* o = out + ((t.face * rows + t.r0 + i) * cols + j) * cout + n;
    const T lo = from_f32<T>(v0 + to_f32(bias[n]));
    if (n + 1 >= cout) {
      o[0] = lo;
      return;
    }
    const T hi = from_f32<T>(v1 + to_f32(bias[n + 1]));
    if (cout % 2 != 0) {
      o[0] = lo;
      o[1] = hi;
    } else if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(o) = make_float2(lo, hi);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(lo, hi);
    }
  }
};

// WS: the weights streamed with each chunk (a separate instance, so that
// the resident one carries none of the streamed mode's selects)
template <typename T, int NW, int KC, bool WS>
__global__ void __launch_bounds__(TC_MAX_THREADS) cs_conv3x3_tc_kernel(
    const T* __restrict__ x, const T* __restrict__ ext, const T* __restrict__ keq,
    const T* __restrict__ kpo, const T* __restrict__ beq, const T* __restrict__ bpo,
    T* __restrict__ out, TcGeom g, int batch) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const FwdSrc<T, ExtGhost<T>> src{x, ExtGhost<T>{ext, g.rows, g.cols, g.kch}, g.rows, g.cols,
                                   g.kch};
  const FwdEpi<T> epi{out, beq, bpo, g.rows, g.cols, g.nch};
  GridWalk walk(g, batch);
  tc_conv<T, NW, KC, false, WS>(g, src, walk, epi, keq, kpo, tc_smem);
}

// Lets a kernel take up to the card's opt-in shared memory per block (the
// largest tiles need more than the default 48 KB).  Set once per kernel and
// device, not at every launch.
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

template <typename T>
cudaError_t launch_cc(const void* x, const void* ext, const void* keq, const void* kpo,
                      const void* beq, const void* bpo, void* out, int batch, const Geom& g,
                      size_t smem, int device, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<cs_conv3x3_kernel<T>>(device);
    if (err != cudaSuccess) return err;
  }
  const int ntiles = (g.rows + g.h - 1) / g.h;
  dim3 grid(ntiles * g.nslices, 6, batch);
  cs_conv3x3_kernel<T><<<grid, MAX_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ext), static_cast<const T*>(keq),
      static_cast<const T*>(kpo), static_cast<const T*>(beq), static_cast<const T*>(bpo),
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T, int NW, int KC, bool WS>
cudaError_t launch_tc_ws(const TcGeom& g, int batch, size_t smem, int device,
                         cudaStream_t stream, const T* x, const T* ext, const T* keq,
                         const T* kpo, const T* beq, const T* bpo, T* out) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<cs_conv3x3_tc_kernel<T, NW, KC, WS>>(device);
    if (err != cudaSuccess) return err;
  }
  const long long p0 = (4LL * batch * g.ntr + g.tpb - 1) / g.tpb;
  const long long p1 = (2LL * batch * g.ntr + g.tpb - 1) / g.tpb;
  const long long blocks = g.nslices * (p0 + p1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cs_conv3x3_tc_kernel<T, NW, KC, WS><<<(unsigned)blocks, g.threads, smem, stream>>>(
      x, ext, keq, kpo, beq, bpo, out, g, batch);
  return cudaGetLastError();
}

template <typename T, int NW, int KC>
cudaError_t launch_tc_nw(const TcGeom& g, int batch, size_t smem, int device,
                         cudaStream_t stream, const T* x, const T* ext, const T* keq,
                         const T* kpo, const T* beq, const T* bpo, T* out) {
  return g.wstream
             ? launch_tc_ws<T, NW, KC, true>(g, batch, smem, device, stream, x, ext, keq, kpo,
                                             beq, bpo, out)
             : launch_tc_ws<T, NW, KC, false>(g, batch, smem, device, stream, x, ext, keq, kpo,
                                              beq, bpo, out);
}

// float32 takes at most 4 n8 tiles per warp (make_tc_geom)
template <typename T, int KC>
cudaError_t launch_tc(const TcGeom& g, int batch, size_t smem, int device, cudaStream_t s,
                      const T* x, const T* ext, const T* k0, const T* k1, const T* b0,
                      const T* b1, T* o) {
  switch (g.nw) {
    case 1: return launch_tc_nw<T, 1, KC>(g, batch, smem, device, s, x, ext, k0, k1, b0, b1, o);
    case 2: return launch_tc_nw<T, 2, KC>(g, batch, smem, device, s, x, ext, k0, k1, b0, b1, o);
    case 4: return launch_tc_nw<T, 4, KC>(g, batch, smem, device, s, x, ext, k0, k1, b0, b1, o);
    default:
      if constexpr (std::is_same<T, float>::value) return cudaErrorInvalidValue;
      else return launch_tc_nw<T, 8, KC>(g, batch, smem, device, s, x, ext, k0, k1, b0, b1, o);
  }
}

template <typename T>
cudaError_t launch_tc_typed(TcGeom& g, int batch, size_t smem, int device, cudaStream_t s,
                            const void* x, const void* ext, const void* keq, const void* kpo,
                            const void* beq, const void* bpo, void* out) {
  const T *tx = static_cast<const T*>(x), *te = static_cast<const T*>(ext),
          *k0 = static_cast<const T*>(keq), *k1 = static_cast<const T*>(kpo),
          *b0 = static_cast<const T*>(beq), *b1 = static_cast<const T*>(bpo);
  T* o = static_cast<T*>(out);
  return g.kc == 16 ? launch_tc<T, 16>(g, batch, smem, device, s, tx, te, k0, k1, b0, b1, o)
                    : launch_tc<T, 32>(g, batch, smem, device, s, tx, te, k0, k1, b0, b1, o);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  device: the current device, which the
// stream belongs to.  x (B, 6, rows, cols, Cin), ext (B, 6, 4, cols+2, Cin)
// with the W/E ghosts at positions 1..rows, so rows <= cols: whole faces
// (rows = cols = n, #1) or a shard's band or tile (#8, #9).  The
// tensor-core kernel with tc_plan's h (output rows per tile), cs (output
// channels per slice), nw (n8 tiles per warp) and tpb (tiles per block),
// the weights of a block's slice resident (wstream = 0) or streamed with
// each staged chunk (wstream = 1, tc_plan's streamed plans); smem must be
// the shared memory those give (the plan's own count, checked here).
// Returns a cudaError_t (0 = success).
int cs_conv3x3_launch(int dtype, int device, const void* x, const void* ext,
                      const void* keq, const void* kpo, const void* beq,
                      const void* bpo, void* out, int batch, int rows, int cols,
                      int cin, int cout, int h, int cs, int nw, int tpb, int smem,
                      int wstream, void* stream) {
  if (device < 0 || device >= 64 || batch < 1 || batch > 65535 || rows > cols ||
      (dtype != 0 && dtype != 1) || (wstream != 0 && wstream != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0;
  TcGeom g;
  if (!make_tc_geom(g, rows, cols, cin, cout, h, cs, nw, tpb, false, f32, wstream == 1) ||
      tc_smem_bytes(g) != (size_t)smem)
    return cudaErrorInvalidValue;
  // x and ext are read-only here, so 8-byte copies (through L1) may serve
  // channels in fours (bfloat16) or twos (float32)
  const int per16 = f32 ? 4 : 8;
  const bool a8 = aligned(x, 8) && aligned(ext, 8);
  g.vec = cin % per16 == 0 && aligned(x, 16) && aligned(ext, 16) ? 1
          : cin % (per16 / 2) == 0 && a8                         ? 2
                                                                 : 0;
  g.wvec = !f32 && cout % 8 == 0 && aligned(keq, 16) && aligned(kpo, 16);
  if (f32)
    return launch_tc_typed<float>(g, batch, smem, device, s, x, ext, keq, kpo, beq, bpo, out);
  return launch_tc_typed<bf16>(g, batch, smem, device, s, x, ext, keq, kpo, beq, bpo, out);
}

// The CUDA-core kernel in either dtype, with tile_plan's h and cs: the
// instances that the tensor-core kernel replaced in both dtypes, kept so
// that the kernel tools can time the two side by side
// (ops/conv_variants.py::cs_conv3x3_cudacore).
int cs_conv3x3_cc_launch(int dtype, int device, const void* x, const void* ext,
                         const void* keq, const void* kpo, const void* beq, const void* bpo,
                         void* out, int batch, int rows, int cols, int cin, int cout, int h,
                         int cs, void* stream) {
  Geom g;
  if (device < 0 || device >= 64 || batch < 1 || batch > 65535 ||
      !make_geom(g, rows, cols, cin, cout, h, cs))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cc<float>(x, ext, keq, kpo, beq, bpo, out, batch, g, smem, device, s);
  if (dtype == 1)
    return launch_cc<__nv_bfloat16>(x, ext, keq, kpo, beq, bpo, out, batch, g, smem, device,
                                    s);
  return cudaErrorInvalidValue;
}

const char* cs_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
