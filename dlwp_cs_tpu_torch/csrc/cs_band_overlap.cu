// The fused 3x3 cubed-sphere conv of a shard's row band with the band-row
// exchange inside it, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlwp_cs_tpu/parallel/overlap_band.py::_kernel
// (band_conv3x3_overlap, #11): the band conv of #8 (cs_conv3x3.cu on a band)
// whose two ghost rows are not exchanged before the conv but received from
// the ring neighbours around it, by the protocol of cs_band_proto.cuh.  The
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
// plus the exchange's (cs_band_xchg.cu): launches, signal round trips and,
// where the ranks share one card, the switches between their contexts.  The
// TPU kernel splits each face's taps to compute the interior while its DMAs
// fly; here one call is a sequence on the stream in which no thread waits
// for another rank: the send kernel of my two boundary rows and the arrival
// signals; pass 0, an ordinary launch of one block per tile that touches no
// ghost row, while the neighbours' rows are in flight; the arrival
// wait, held in the GPU's front end; pass 1, the tiles of rows 0 and h-1,
// which read the received slots through L2; the consumed signals.  Every
// tile runs #8's tap loop of cs_conv3x3_tile.cuh (tc_conv on the tensor
// cores, in both dtypes, with #8's K order), so the output equals #8's
// bitwise for the same inputs.  The first design (cs_band_overlap_v1_kernel,
// kept as a timing row) ran the whole call as one cooperative kernel that
// spun on the arrivals between its two passes.
//
// Layouts (channels last, contiguous): x (B, 6, h, n, Cin); seam and wecols
// (B, 6, 2, n+2, Cin) [S row, N row] and [W column, E column] (at positions
// 1..h); kernels (3, 3, Cin, Cout) HWIO, biases (Cout,); out (B, 6, h, n,
// Cout).  The slots hold (B, 6, 1, n, Cin) each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

  // the ghost cell's first channel; slot: it lies in a received slot,
  // written by a peer during the launch (read through L2 only)
  __device__ __forceinline__ const T* cell(long long face, int fr, int pc, bool& slot) const {
    const long long strip = (long long)(cols + 2) * cin;
    slot = false;
    if (fr == -1 || fr == rows) {
      const bool south = fr == -1;
      const T* row = seam + (face * 2 + (south ? 0 : 1)) * strip;
      const int f = (int)(face % 6);
      if (south ? first : last) return row + (long long)pc * cin;
      const T* slot_rows = south ? below : above;
      slot = true;
      if (pc >= 1 && pc <= cols) return slot_rows + (face * cols + pc - 1) * cin;
      if (f >= 4) {
        slot = false;
        return row + (long long)pc * cin;
      }
      const int bits = (corners >> (6 * f)) >> (pc == 0 ? 0 : 3);
      const long long partner = face - f + (bits & 3);
      const int col = (bits & 4) ? cols - 1 : 0;
      return slot_rows + (partner * cols + col) * cin;
    }
    const T* strip_we = wecols + (face * 2 + (pc == 0 ? 0 : 1)) * strip;
    return strip_we + (long long)(fr + 1) * cin;
  }
  // for tc_conv's 16-byte copies, which read through L2 only
  __device__ __forceinline__ const T* cell(long long face, int fr, int pc) const {
    bool slot;
    return cell(face, fr, pc, slot);
  }
  __device__ __forceinline__ float operator()(long long face, int fr, int pc, int ci) const {
    bool slot;
    const T* p = cell(face, fr, pc, slot) + ci;
    return slot ? ld_cg_f32(p) : to_f32(*p);
  }
};

template <typename T>
struct Args {
  Ring ring;     // v1
  const T* below;  // my received slots of the call's parity
  const T* above;
  const T* x;
  const T* seam;
  const T* wecols;
  const T* keq;
  const T* kpo;
  const T* beq;
  const T* bpo;
  T* out;
  TcGeom tg;
  int batch;
  int first, last, corners;
};

// The first design's walk of the tensor-core loop: the block's items (it =
// blockIdx.x, + gridDim.x, ...) of pass 0 (tiles that touch no ghost row),
// then those of pass 1, after the arrivals they read (the end shards' seam
// rows need none).
struct OverlapWalk {
  const Ring* ring;
  int it, pass, items, per_face, rows;
  const TcGeom* g;
  bool first, last, waited;
  __device__ bool next(TcTile& t) {
    while (pass < 2) {
      for (; it < items; it += gridDim.x) {
        const int tt = it % per_face;
        const int r0 = (tt / g->nslices) * g->h;
        const bool edge = r0 == 0 || r0 + g->h >= rows;
        if (edge != (pass == 1)) continue;
        t.f = (it / per_face) % 6;
        t.face = (long long)(it / (per_face * 6)) * 6 + t.f;
        t.r0 = r0;
        t.n0 = (tt % g->nslices) * g->cs;
        t.key = (t.f < 4 ? 0 : g->nslices) + tt % g->nslices;
        it += gridDim.x;
        return true;
      }
      ++pass;
      it = blockIdx.x;
    }
    return false;
  }
  __device__ void before(const TcTile& t) {
    const bool edge = t.r0 == 0 || t.r0 + g->h >= rows;
    if (edge && !waited) {
      wait_arrivals(*ring, !first, !last);
      waited = true;
    }
  }
};

// One tile a block: item blockIdx.x of the pass's tiles, in the order
// (batch item, face, row tile of the pass, slice).  Pass 0: row tiles 1 ..
// ntr-2, which touch no ghost row; pass 1: row tiles 0 and ntr-1.  (#8's
// walk of several tiles a block, its weights staged once, timed the same
// on ranks sharing the card: the context switches bound a call.)
struct PassWalk {
  int pass, nrt;
  const TcGeom* g;
  bool done;
  __device__ bool next(TcTile& t) {
    if (done) return false;
    done = true;
    const int it = blockIdx.x, per_face = nrt * g->nslices;
    const int tt = it % per_face, rt = tt / g->nslices, slice = tt % g->nslices;
    const int tr = pass == 0 ? rt + 1 : (rt == 0 ? 0 : g->ntr - 1);
    t.face = it / per_face;
    t.f = (int)(t.face % 6);
    t.r0 = tr * g->h;
    t.n0 = slice * g->cs;
    t.key = (t.f < 4 ? 0 : g->nslices) + slice;
    return true;
  }
  __device__ void before(const TcTile&) const {}
};

// row tiles of each pass
__host__ __device__ inline int pass_row_tiles(const TcGeom& g, int pass) {
  return pass == 0 ? (g.ntr > 2 ? g.ntr - 2 : 0) : (g.ntr > 1 ? 2 : 1);
}

template <typename T>
struct BandEpi {
  T* __restrict__ out;
  const T* __restrict__ beq;
  const T* __restrict__ bpo;
  int rows, cols, cout;
  __device__ __forceinline__ void store(const TcTile& t, int i, int j, int n, float v0,
                                        float v1) const {
    if (n >= cout) return;
    const T* __restrict__ bias = t.f < 4 ? beq : bpo;
    T* o = out + ((t.face * rows + t.r0 + i) * cols + j) * cout + n;
    o[0] = from_f32<T>(v0 + to_f32(bias[n]));
    if (n + 1 < cout) o[1] = from_f32<T>(v1 + to_f32(bias[n + 1]));
  }
};

// One pass of #11: the tiles of `pass` (PassWalk), the ghost rows read from
// the received slots of the call's parity.
template <typename T, int NW, int KC>
__global__ void __launch_bounds__(TC_MAX_THREADS) cs_band_overlap_tc_kernel(Args<T> a,
                                                                            int pass) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcGeom& g = a.tg;
  const OverlapGhost<T> ghost{a.seam, a.wecols, a.below, a.above, g.rows, g.cols, g.kch,
                              a.first != 0, a.last != 0, a.corners};
  const FwdSrc<T, OverlapGhost<T>> src{a.x, ghost, g.rows, g.cols, g.kch};
  const BandEpi<T> epi{a.out, a.beq, a.bpo, g.rows, g.cols, g.nch};
  PassWalk walk{pass, pass_row_tiles(g, pass), &g, false};
  tc_conv<T, NW, KC, false>(g, src, walk, epi, a.keq, a.kpo, tc_smem);
}

// The first design, a timing row: one cooperative kernel that sends, walks
// pass 0, spins on the arrivals and walks pass 1 (OverlapWalk).
template <typename T, int NW, int KC>
__global__ void __launch_bounds__(TC_MAX_THREADS) cs_band_overlap_v1_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcGeom& g = a.tg;
  barrier_and_send(a.ring, reinterpret_cast<const char*>(a.x), 6LL * a.batch, g.rows,
                   (long long)g.cols * g.kch * sizeof(T), 1);
  const OverlapGhost<T> ghost{a.seam, a.wecols, a.below, a.above, g.rows, g.cols, g.kch,
                              a.first != 0, a.last != 0, a.corners};
  const FwdSrc<T, OverlapGhost<T>> src{a.x, ghost, g.rows, g.cols, g.kch};
  const BandEpi<T> epi{a.out, a.beq, a.bpo, g.rows, g.cols, g.nch};
  OverlapWalk walk{&a.ring, (int)blockIdx.x, 0, g.ntr * g.nslices * 6 * a.batch,
                   g.ntr * g.nslices, g.rows, &g, a.first != 0, a.last != 0, false};
  tc_conv<T, NW, KC, false>(g, src, walk, epi, a.keq, a.kpo, tc_smem);
}

// Opt in past the default 48 KB of dynamic shared memory (the kernel also
// has a little static shared memory, which the card's per-block limit must
// leave room for).
inline cudaError_t allow_smem(const void* fn, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

template <typename Fn>
cudaError_t launch_coop(Fn kernel, Ring& ring, void* args, int threads, size_t smem,
                        long long items, unsigned long long* sent, int device,
                        cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = allow_smem(fn, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)(items < (long long)per_sm * sms ? items : (long long)per_sm * sms);
  ring.sent = *sent + grid;
  void* kargs[] = {args};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), kargs, smem, stream);
  if (err == cudaSuccess) *sent = ring.sent;
  return err;
}

template <int V>
using I = std::integral_constant<int, V>;

// go(NW, KC) on the kernel instance of the plan's n8 tiles per warp and K
// chunk (float32 takes at most 4 n8 tiles per warp: make_tc_geom)
template <typename T, typename Go>
int with_plan(int nw, int kc, Go&& go) {
  const bool k16 = kc == 16;
  switch (nw) {
    case 1: return k16 ? go(I<1>{}, I<16>{}) : go(I<1>{}, I<32>{});
    case 2: return k16 ? go(I<2>{}, I<16>{}) : go(I<2>{}, I<32>{});
    case 4: return k16 ? go(I<4>{}, I<16>{}) : go(I<4>{}, I<32>{});
    default:
      if constexpr (std::is_same<T, float>::value) return cudaErrorInvalidValue;
      else return k16 ? go(I<8>{}, I<16>{}) : go(I<8>{}, I<32>{});
  }
}

// One call of #11: steps 1-7 of cs_band_proto.cuh with the two passes.
template <typename T>
int launch_passes(Args<T>& a, const Call& c, size_t smem, int sms, long long lag_ns,
                  cudaStream_t s) {
  const TcGeom& g = a.tg;
  return with_plan<T>(g.nw, g.kc, [&](auto nw, auto kc) -> int {
    const auto kernel = cs_band_overlap_tc_kernel<T, decltype(nw)::value, decltype(kc)::value>;
    int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (!err)
      err = enqueue_send(c, reinterpret_cast<const char*>(a.x), 6LL * a.batch, g.rows,
                         (long long)g.cols * g.kch * sizeof(T), 1, sms, s);
    for (int pass = 0; pass < 2 && !err; ++pass) {
      if (pass == 1) err = enqueue_arrivals(c, a.first == 0, a.last == 0, s);
      if (pass == 1 && !err) err = enqueue_lag(lag_ns, s);
      const long long blocks = 6LL * a.batch * pass_row_tiles(g, pass) * g.nslices;
      if (err || blocks == 0) continue;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      kernel<<<(unsigned)blocks, g.threads, smem, s>>>(a, pass);
      err = cudaGetLastError();
    }
    if (!err) err = enqueue_consumed(c, s);
    return err;
  });
}

template <typename T>
int launch_v1(Args<T>& a, size_t smem, unsigned long long* sent, int device, cudaStream_t s) {
  const TcGeom& g = a.tg;
  const long long items = 6LL * a.batch * g.ntr * g.nslices;
  return with_plan<T>(g.nw, g.kc, [&](auto nw, auto kc) -> int {
    return launch_coop(cs_band_overlap_v1_kernel<T, decltype(nw)::value, decltype(kc)::value>,
                       a.ring, &a, g.threads, smem, items, sent, device, s);
  });
}

// The checks and the tile geometry both launches share; false on sizes or
// a plan the kernel cannot take.
bool make_call_geom(TcGeom& tg, int dtype, int device, int batch, int rows, int cols,
                    int cin, int cout, int h, int cs, int nw, int smem, long long cap,
                    const void* x, const void* seam, const void* wecols, const void* keq,
                    const void* kpo, const void* me) {
  if (device < 0 || batch < 1 || (dtype != 0 && dtype != 1)) return false;
  const bool f32 = dtype == 0;
  if (!make_tc_geom(tg, rows, cols, cin, cout, h, cs, nw, 1, false, f32) ||
      tc_smem_bytes(tg) != (size_t)smem)
    return false;
  const long long esize = f32 ? 4 : 2;
  if (6LL * batch * cols * cin * esize > cap) return false;
  // the received slots are written by the peers: 16-byte copies (through L2
  // only) or ordinary loads, never the 8-byte copies through L1
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  tg.vec = cin % (f32 ? 4 : 8) == 0 && a16(x) && a16(seam) && a16(wecols) && a16(me) &&
           cap % 16 == 0;
  tg.wvec = !f32 && cout % 8 == 0 && a16(keq) && a16(kpo);
  return true;
}

template <typename T>
Args<T> make_args(const Ring& r, const char* below, const char* above, const void* x,
                  const void* seam, const void* wecols, const void* keq, const void* kpo,
                  const void* beq, const void* bpo, void* out, const TcGeom& tg, int batch,
                  int first, int last, int corners) {
  return Args<T>{r, reinterpret_cast<const T*>(below), reinterpret_cast<const T*>(above),
                 static_cast<const T*>(x), static_cast<const T*>(seam),
                 static_cast<const T*>(wecols), static_cast<const T*>(keq),
                 static_cast<const T*>(kpo), static_cast<const T*>(beq),
                 static_cast<const T*>(bpo), static_cast<T*>(out), tg, batch, first, last,
                 corners};
}

}  // namespace

extern "C" {

// Kernel #11 on the current stream: steps 1-7 of cs_band_proto.cuh around
// its two passes.  dtype: 0 = float32, 1 = bfloat16.  x (B, 6, rows, cols,
// Cin) with rows * S = cols; seam, wecols (B, 6, 2, cols+2, Cin); HWIO
// kernels and biases of x's dtype; out (B, 6, rows, cols, Cout).  h, cs, nw,
// smem: the tile plan (as cs_conv3x3_launch: tc_plan's h, cs, nw and its
// shared memory; one tile a block).  first, last: this shard is the first
// or the last of the ring; corners: the packed corner table.  me, right,
// left, cap, epoch, consumed, ticket, ticket_value, lag_ns: the ring and
// the call, as cs_band_xchg_launch (the hold before pass 1).  Returns a
// cudaError_t, or MEMOP_ERROR + a CUresult (0 = success).
int cs_band_overlap_launch(int dtype, int device, const void* x, const void* seam,
                           const void* wecols, const void* keq, const void* kpo,
                           const void* beq, const void* bpo, void* out, void* me,
                           void* right, void* left, long long cap, int batch, int rows,
                           int cols, int cin, int cout, int h, int cs, int nw, int smem,
                           int first, int last, int corners, unsigned long long epoch,
                           unsigned long long consumed, void* ticket,
                           unsigned long long ticket_value, long long lag_ns, void* stream) {
  TcGeom tg{};
  if (epoch < 1 || !make_call_geom(tg, dtype, device, batch, rows, cols, cin, cout, h, cs, nw,
                                   smem, cap, x, seam, wecols, keq, kpo, me))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Call c{static_cast<char*>(me), static_cast<char*>(right), static_cast<char*>(left), cap,
               epoch, consumed, static_cast<unsigned long long*>(ticket), ticket_value};
  const char* below = c.my_slot(false);
  const char* above = c.my_slot(true);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Ring r{};
  if (dtype == 0) {
    auto a = make_args<float>(r, below, above, x, seam, wecols, keq, kpo, beq, bpo, out, tg,
                              batch, first, last, corners);
    return launch_passes(a, c, (size_t)smem, sms, lag_ns, s);
  }
  auto a = make_args<bf16>(r, below, above, x, seam, wecols, keq, kpo, beq, bpo, out, tg, batch,
                           first, last, corners);
  return launch_passes(a, c, (size_t)smem, sms, lag_ns, s);
}

// The first design of #11, a timing row (parallel/overlap_band.py::
// band_conv3x3_overlap_v1), on a buffer of its own: one cooperative kernel
// that spins (its slots: parity 0).  The arguments as cs_band_overlap_launch
// but the call's: *sent, timeout_ns, diag, rank, as cs_band_xchg_v1_launch.
int cs_band_overlap_v1_launch(int dtype, int device, const void* x, const void* seam,
                              const void* wecols, const void* keq, const void* kpo,
                              const void* beq, const void* bpo, void* out, void* me,
                              void* right, void* left, long long cap, int batch, int rows,
                              int cols, int cin, int cout, int h, int cs, int nw, int smem,
                              int first, int last, int corners, unsigned long long epoch,
                              unsigned long long* sent, long long timeout_ns, void* diag,
                              int rank, void* stream) {
  TcGeom tg{};
  if (timeout_ns < 1 || !make_call_geom(tg, dtype, device, batch, rows, cols, cin, cout, h, cs,
                                        nw, smem, cap, x, seam, wecols, keq, kpo, me))
    return cudaErrorInvalidValue;
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
  const char* below = r.me + slot_offset(0, false, cap);
  const char* above = r.me + slot_offset(0, true, cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto a = make_args<float>(r, below, above, x, seam, wecols, keq, kpo, beq, bpo, out, tg,
                              batch, first, last, corners);
    return launch_v1(a, (size_t)smem, sent, device, s);
  }
  auto a = make_args<bf16>(r, below, above, x, seam, wecols, keq, kpo, beq, bpo, out, tg, batch,
                           first, last, corners);
  return launch_v1(a, (size_t)smem, sent, device, s);
}

const char* cs_band_overlap_error_string(int err) { return error_string(err); }

}  // extern "C"
