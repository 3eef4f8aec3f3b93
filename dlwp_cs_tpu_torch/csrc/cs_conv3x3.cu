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
// What bounds it on this card: at the serving shapes (C48 U-Net, batch 1)
// the work per conv is 0.05-0.4 GFLOP and under 1 MB of traffic, well under
// a microsecond at the H100's peak rates, so latency bounds it: the staging
// of each Cin chunk into shared memory (dependent global loads) and each
// thread's serial chain of 9*Cin*32 FMAs.  At batch 8 and above the FMA
// rate of the CUDA cores bounds it (this version uses no tensor cores).  The
// design answers with small row tiles, so that a batch-1 face set still
// spreads over the 132 SMs; with all 256 threads of a block staging, four
// independent loads in flight each; and with register tiles of 4 pixels x
// 8 output channels per thread, reading each staged input value once per
// 3 taps.  The padded tile never exists in device memory: the W/E ghost
// columns and the ghost rows go straight into shared memory.  A shard's band
// or tile is a quarter of a face or less, so the same latency bound holds
// there with fewer blocks per launch; the halo exchange that fills ext runs
// before the launch, outside the kernel.  mma/wgmma, TMA and CUDA graphs are
// left for later work.
//
// Layouts (channels last, all contiguous):
//   x    (B, 6, H, W, Cin)        ext (B, 6, 4, W+2, Cin)   edges S, N, W, E
//   k_*  (3, 3, Cin, Cout) HWIO   b_* (Cout,)               out (B, 6, H, W, Cout)
// The W/E ghost columns sit at positions 1..H of their W+2 strips, so H <= W.
// Grid: (row tiles * Cout slices, 6, B); one block per (row tile, face,
// batch item, Cout slice).  Each block loops over Cin in chunks of CC,
// staging the (h+2) x (W+2) padded tile and that chunk's taps of the face's
// weight group in shared memory as f32.  That tap loop lives in
// cs_conv3x3_tile.cuh, shared with the band conv fused with the band-row
// exchange (cs_band_overlap.cu, #11); this file adds its ghost cells (ext).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "cs_conv3x3_tile.cuh"

namespace {

using namespace cs3x3;

// Ghost cells from the strips ext (B, 6, 4, W+2, Cin) [S, N, W, E]: the S/N
// rows whole (corners included), the W/E columns at positions 1..H.
template <typename T>
struct ExtGhost {
  const T* __restrict__ ext;
  int rows, cols, cin;
  __device__ __forceinline__ float operator()(long long face, int fr, int pc, int ci) const {
    const T* ef = ext + face * 4 * (cols + 2) * cin;
    long long off;
    if (fr == -1) off = (0LL * (cols + 2) + pc) * cin;         // S ghost row
    else if (fr == rows) off = (1LL * (cols + 2) + pc) * cin;  // N ghost row
    else if (pc == 0) off = (2LL * (cols + 2) + fr + 1) * cin; // W ghost column
    else off = (3LL * (cols + 2) + fr + 1) * cin;              // E ghost column
    return to_f32(ef[off + ci]);
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

// Lets the kernel take up to the card's opt-in shared memory per block (the
// largest flagship tile needs ~80 KB, past the default 48 KB).  Set once per
// element type and device, not at every launch.
template <typename T>
cudaError_t allow_large_smem(int device) {
  static std::atomic<unsigned long long> done{0};  // bit d: done on device d
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cs_conv3x3_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* ext, const void* keq, const void* kpo,
                   const void* beq, const void* bpo, void* out, int batch, const Geom& g,
                   size_t smem, int device, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<T>(device);
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  device: the current device, which the
// stream belongs to.  x (B, 6, rows, cols, Cin), ext (B, 6, 4, cols+2, Cin)
// with the W/E ghosts at positions 1..rows, so rows <= cols: whole faces
// (rows = cols = n, #1) or a shard's band or tile (#8, #9).  h: output rows
// per block; cs: output channels per block (a power of two >= 8).  Returns a
// cudaError_t (0 = success).
int cs_conv3x3_launch(int dtype, int device, const void* x, const void* ext,
                      const void* keq, const void* kpo, const void* beq,
                      const void* bpo, void* out, int batch, int rows, int cols,
                      int cin, int cout, int h, int cs, void* stream) {
  Geom g;
  if (device < 0 || device >= 64 || batch < 1 || batch > 65535 ||
      !make_geom(g, rows, cols, cin, cout, h, cs))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ext, keq, kpo, beq, bpo, out, batch, g, smem, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ext, keq, kpo, beq, bpo, out, batch, g, smem, device,
                                 s);
  return cudaErrorInvalidValue;
}

const char* cs_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
