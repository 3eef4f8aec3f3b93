// The fused 3x3 cubed-sphere conv of a shard's row band with the band-row
// exchange inside it, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlwp_cs_tpu/parallel/overlap_band.py::_kernel
// (band_conv3x3_overlap, #11): the band conv of #8 (cs_conv3x3.cu on a band)
// whose two ghost rows are not exchanged before the launch but copied from
// the ring neighbours during it, by the protocol of cs_band_proto.cuh.  The
// host-side exchange (parallel/halo.py under the "zero" band transport)
// still brings the seam material: the S/N ghost rows of the end shards and
// the polar faces' corner cells (`seam`), and the W/E ghost columns of the
// band's rows (`wecols`).  The kernel assembles each ghost row as the TPU
// kernel does:
//   * on the first shard (S row) or the last (N row), the seam row whole;
//   * elsewhere the row received from the neighbour, with its two corner
//     cells from the seam row on a polar face, and on an equatorial face from
//     the W/E partner face's received row at its seam column (the corner
//     table, overlap_band.py::_eq_corner_table, packed into `corners`).
//
// What bounds it on this card: the conv's own latency bound (cs_conv3x3.cu)
// plus the exchange's (cs_band_xchg.cu): flag round trips and, where the
// ranks share one card, the other ranks' time slices.  The TPU kernel splits
// each face's taps to compute the interior while its DMAs fly; here the
// overlap is between blocks: every block first sends its share of the two
// slabs, then computes the tiles that touch no ghost row, and only then
// waits for the arrivals and computes the tiles of rows 0 and h-1.  Every
// tile runs the 9-tap loop of cs_conv3x3_tile.cuh in #8's order, so the
// output equals #8's bitwise for the same inputs.
//
// The launch is cooperative: a grid of at most the blocks that fit on the
// card at once, each walking over tiles, so that no block waits on a block
// that is not running.
//
// Layouts (channels last, contiguous): x (B, 6, h, n, Cin); seam and wecols
// (B, 6, 2, n+2, Cin) [S row, N row] and [W column, E column] (at positions
// 1..h); kernels (3, 3, Cin, Cout) HWIO, biases (Cout,); out (B, 6, h, n,
// Cout).  The slots hold (B, 6, 1, n, Cin) each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cs_band_proto.cuh"
#include "cs_conv3x3_tile.cuh"

namespace {

using namespace cs3x3;
using namespace csband;

__device__ __forceinline__ float ld_cg_f32(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
struct OverlapGhost {
  const T* __restrict__ seam;
  const T* __restrict__ wecols;
  const T* below;  // my received slots (B, 6, 1, n, Cin), written by the peers
  const T* above;
  int rows, cols, cin;
  bool first, last;
  int corners;  // per equatorial face f, 6 bits: W partner (2), its column is
                // n-1 (1), E partner (2), its column is n-1 (1)

  __device__ __forceinline__ float operator()(long long face, int fr, int pc, int ci) const {
    const long long strip = (long long)(cols + 2) * cin;
    if (fr == -1 || fr == rows) {
      const bool south = fr == -1;
      const T* row = seam + (face * 2 + (south ? 0 : 1)) * strip;
      const int f = (int)(face % 6);
      if (south ? first : last) return to_f32(row[(long long)pc * cin + ci]);
      const T* slot = south ? below : above;
      if (pc >= 1 && pc <= cols)
        return ld_cg_f32(slot + (face * cols + pc - 1) * cin + ci);
      if (f >= 4) return to_f32(row[(long long)pc * cin + ci]);
      const int bits = (corners >> (6 * f)) >> (pc == 0 ? 0 : 3);
      const long long partner = face - f + (bits & 3);
      const int col = (bits & 4) ? cols - 1 : 0;
      return ld_cg_f32(slot + (partner * cols + col) * cin + ci);
    }
    const T* strip_we = wecols + (face * 2 + (pc == 0 ? 0 : 1)) * strip;
    return to_f32(strip_we[(long long)(fr + 1) * cin + ci]);
  }
};

template <typename T>
struct Args {
  Ring ring;
  const T* x;
  const T* seam;
  const T* wecols;
  const T* keq;
  const T* kpo;
  const T* beq;
  const T* bpo;
  T* out;
  Geom g;
  int batch;
  int first, last, corners;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) cs_band_overlap_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const Geom& g = a.g;
  barrier_and_send(a.ring, reinterpret_cast<const char*>(a.x), 6LL * a.batch, g.rows,
                   (long long)g.cols * g.cin * sizeof(T), 1);
  const OverlapGhost<T> ghost{
      a.seam, a.wecols,
      reinterpret_cast<const T*>(a.ring.me + HEADER),
      reinterpret_cast<const T*>(a.ring.me + HEADER + a.ring.cap),
      g.rows, g.cols, g.cin, a.first != 0, a.last != 0, a.corners};
  const int per_face = ((g.rows + g.h - 1) / g.h) * g.nslices;
  const int items = per_face * 6 * a.batch;
  // pass 0: tiles that touch no ghost row; pass 1: the rest, after the
  // arrivals they read (the end shards' seam rows need none)
  bool waited = false;
  for (int pass = 0; pass < 2; ++pass) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int t = it % per_face;
      const int f = (it / per_face) % 6;
      const int b = it / (per_face * 6);
      const int r0 = (t / g.nslices) * g.h;
      const bool south = r0 == 0, north = r0 + g.h >= g.rows;
      if ((south || north) != (pass == 1)) continue;
      if (pass == 1 && !waited) {
        wait_arrivals(a.ring, !a.first, !a.last);
        waited = true;
      }
      conv_tile(a.x, ghost, a.keq, a.kpo, a.beq, a.bpo, a.out, g, r0, (t % g.nslices) * g.cs,
                f, (long long)b * 6 + f, smem);
    }
  }
}

template <typename T>
cudaError_t launch(Args<T>& a, unsigned long long* sent, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.g);
  const void* fn = reinterpret_cast<const void*>(cs_band_overlap_kernel<T>);
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // past the default 48 KB, opt in to this launch's dynamic shared memory
  // (the kernel also has a little static shared memory, which the card's
  // per-block limit must leave room for)
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, MAX_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long items =
      6LL * a.batch * ((a.g.rows + a.g.h - 1) / a.g.h) * a.g.nslices;
  const int grid = (int)(items < (long long)per_sm * sms ? items : (long long)per_sm * sms);
  a.ring.sent = *sent + grid;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(MAX_THREADS), args, smem, stream);
  if (err == cudaSuccess) *sent = a.ring.sent;
  return err;
}

}  // namespace

extern "C" {

// Kernel #11 on the current stream.  dtype: 0 = float32, 1 = bfloat16.
// x (B, 6, rows, cols, Cin) with rows * S = cols; seam, wecols (B, 6, 2,
// cols+2, Cin); HWIO kernels and biases of x's dtype; out (B, 6, rows, cols,
// Cout).  h, cs: the tile plan (as cs_conv3x3_launch).  first, last: this
// shard is the first or the last of the ring; corners: the packed corner
// table.  me, right, left, cap, epoch, *sent, timeout_ns, diag, rank: the
// ring, as cs_band_xchg_launch.  Returns a cudaError_t (0 = success).
int cs_band_overlap_launch(int dtype, int device, const void* x, const void* seam,
                           const void* wecols, const void* keq, const void* kpo,
                           const void* beq, const void* bpo, void* out, void* me,
                           void* right, void* left, long long cap, int batch, int rows,
                           int cols, int cin, int cout, int h, int cs, int first, int last,
                           int corners, unsigned long long epoch, unsigned long long* sent,
                           long long timeout_ns, void* diag, int rank, void* stream) {
  Geom g;
  if (device < 0 || batch < 1 || timeout_ns < 1 || !make_geom(g, rows, cols, cin, cout, h, cs))
    return cudaErrorInvalidValue;
  const long long esize = dtype == 0 ? 4 : 2;
  if (6LL * batch * cols * cin * esize > cap) return cudaErrorInvalidValue;
  Ring r;
  r.me = static_cast<char*>(me);
  r.right = static_cast<char*>(right);
  r.left = static_cast<char*>(left);
  r.cap = cap;
  r.epoch = epoch;
  r.sent = 0;
  r.timeout_ns = timeout_ns;
  r.diag = static_cast<long long*>(diag);
  r.rank = rank;
  r.kernel = 11;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a{r, static_cast<const float*>(x), static_cast<const float*>(seam),
                  static_cast<const float*>(wecols), static_cast<const float*>(keq),
                  static_cast<const float*>(kpo), static_cast<const float*>(beq),
                  static_cast<const float*>(bpo), static_cast<float*>(out), g, batch,
                  first, last, corners};
    return launch(a, sent, device, s);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    Args<B> a{r, static_cast<const B*>(x), static_cast<const B*>(seam),
              static_cast<const B*>(wecols), static_cast<const B*>(keq),
              static_cast<const B*>(kpo), static_cast<const B*>(beq),
              static_cast<const B*>(bpo), static_cast<B*>(out), g, batch, first, last,
              corners};
    return launch(a, sent, device, s);
  }
  return cudaErrorInvalidValue;
}

const char* cs_band_overlap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
