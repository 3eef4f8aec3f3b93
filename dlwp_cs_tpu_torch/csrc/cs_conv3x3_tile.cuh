// The tap loops of the fused 3x3 cubed-sphere conv, shared by its launches.
//
// Two routines compute one output tile of a local block of H rows and W
// columns of every face.  The padded tile never exists in device memory:
// interior cells come from x, and every ghost cell (block row -1 or H,
// padded column 0 or W+1) from the caller's Ghost functor, so the launches
// differ only in where their ghost cells live:
//   * cs_conv3x3.cu: ghost strips exchanged or built before the launch
//     (whole faces #1/#2, a shard's band #8 or tile #9, precomputed strips
//     #12);
//   * cs_band_overlap.cu: the seam rows and W/E strips of the host-side
//     exchange, and band rows received from the ring neighbours by remote
//     copies during the launch (#11).
//
// conv_tile (the CUDA-core instances that tc_conv replaced, float32 and
// bfloat16, kept only as timing rows of the kernel tools): the CUDA cores.  h rows from r0, cs output channels from co0; Cin in chunks of
// CC staged in shared memory as f32 with that chunk's taps; register tiles
// of PX pixels x CO channels per thread.  Every output is summed in the same
// order (Cin chunk, channel, dy, dx) in f32 with one rounding to T at the
// end.
//
// tc_conv (bfloat16 and float32): an implicit GEMM on the tensor cores.  A
// tile is M output pixels (h whole rows of one face, flattened, in m16 row
// tiles) x N output channels (a slice of cs); K is 9 x Cin, walked in one
// fixed order: Cin chunk, tap (dy, dx), k step.  Shared memory is laid out
// in 16-bit units: a bfloat16 value takes one, a float32 value two, so a
// chunk of KC units (16 or 32) holds KC bfloat16 or KC / 2 float32
// channels, a k step of 16 units is one m16n8k16 (bf16) or one m16n8k8
// (tf32) product, and every ldmatrix address is the same in both types.
// What bounds it: at batch 1 the work of a conv is 0.03-0.3 GFLOP, under a
// microsecond at the card's 989 TFLOP/s, so the latency of each block's
// serial path (staging its weights, then a chain of mma.sync per warp) sets
// the time; at batch 16 the products (50 GFLOP a U-Net step) and the
// shared-memory fragment loads that feed them.  The design:
//   * the (h+2) x (W+2) padded rows of a Cin chunk are staged once, each
//     cell's channels padded by 8 units so that the 8 rows of an ldmatrix
//     fall in 8 distinct 16-byte bank groups; each of the 9 taps reads its
//     A fragments from that tile at a shifted address (ldmatrix with one
//     pointer per pixel row, computed once per tile): nothing is copied
//     nine times;
//   * bfloat16: mma.sync.m16n8k16, bf16 in, f32 sums, the weights read as
//     B by ldmatrix .trans from [tap * Cin + ci][n] rows;
//   * float32 (3xTF32): each f32 operand is split as hi = tf32(v) and lo =
//     tf32(v - hi), both rounded to nearest (ties away from zero, as
//     cvt.rna.tf32.f32, but by integer ops: a conversion runs at an eighth
//     of the FP32 rate), and each k step issues mma.sync.m16n8k8.tf32
//     three times, lo.hi, hi.lo, then hi.hi (only lo.lo, about 2^-22 of a
//     product, is dropped).  A staged chunk is split once, when it has
//     landed: hi in place, lo into a third stage-sized buffer, so the 9
//     taps and the warps along N that read each value do not split it
//     again; the weights' B fragments are split as they are loaded.
//     ldmatrix moves 16-bit elements, but a row of 16 bytes is 4 f32
//     channels, so the A fragments (pixels x channels) come from the same
//     non-transposed ldmatrix as in bfloat16, and the weights are staged
//     transposed once per block, [n][tap * Cin + ci], so that the B
//     fragments do too.  A tensor-core sum is not rounded as an FMA is,
//     so each tap's products go into a fresh fragment that is then added
//     into the f32 sums with ordinary adds: no chain of more than
//     3 x KC / 16 products;
//   * each warp owns 2 m16 tiles x NW n8 tiles; the block's warps split M,
//     and N where M is small, so a batch-1 block has several short mma
//     chains rather than one long one;
//   * cp.async (16 bytes, L2 only) into a ring of two stages: chunk k+1 -
//     or the next tile's first chunk - loads while chunk k is multiplied,
//     one barrier per chunk.  Ghost cells come through the Ghost functor's
//     cell pointers by the same copies; channels that 16-byte copies do not
//     take (the U-Net's 12-channel input in bfloat16) are staged by 8-byte
//     copies or ordinary loads, zero-filled past Cin;
//   * the block's weights (its face group's taps for its N slice, all of K)
//     stay resident in shared memory while it walks several tiles of the
//     same (face group, slice), so staged weights serve more than one tile;
//     they are staged again only where a walk changes group or slice
//     (#11's walk);
//   * streamed weights (wstream; tc_conv's WS, an instance of its own; the
//     forward only, where a slice's resident weights and two stages do not
//     fit: bfloat16 from Cin = 512 at 8 channels a slice, whose rows pad 8
//     channels to 24): each stage carries its chunk's weights (9 taps x kc
//     units x cs) beside its input chunk, by the same copies, and the tap
//     loop reads them there.
//     The K order and every product are those of the resident mode, so
//     the two give bitwise equal outputs; the weights are then staged
//     once per chunk of every tile instead of once per block;
//   * the same routine runs the dx kernel in both types (cs_conv3x3_bwd.cu):
//     a correlation of dout, zero-extended by 2, with the flipped,
//     transposed taps over the (n+2)^2 frame; only the staging sources,
//     the weight layout and the stores differ.  Its taps are n x k rows of
//     k in both types, so float32's are straight copies too.
// Each output's sum runs in that K order whatever the tile height, the
// launch, or the block's walk, with one rounding to T at the end, so two
// launches that stage the same values give bitwise equal outputs (#12 and
// #1, #11 and #8, the shards' forecasts and one card's).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cs3x3 {

constexpr int PX = 4;             // output pixels per thread, consecutive along a row
constexpr int CO = 8;             // output channels per thread
constexpr int CC = 16;            // input channels staged per chunk
constexpr int MAX_THREADS = 256;  // threads per block, all staging
constexpr int STAGE = 4;          // staging loads in flight per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geom {
  int rows, cols;  // the local block: H rows, W columns of every face
  int cin, cout;
  int h;        // output rows per tile
  int cs;       // output channels per block (a power of two >= CO)
  int cs_log2;
  int nslices;  // Cout slices
  int ncg;      // column groups of PX pixels per row
  int nog;      // channel groups of CO per slice
  int wp;       // staged tile width: ncg * PX + 2 >= W + 2 (extra columns zero)
  int plane;    // shared-memory pitch of one staged channel (odd: no bank conflicts)
};

// Fills g from the block and tile sizes; false on sizes the kernel cannot take.
inline bool make_geom(Geom& g, int rows, int cols, int cin, int cout, int h, int cs) {
  if (rows < 1 || rows > cols || cin < 1 || cout < 1 || h < 1 || h > rows || cs < CO ||
      (cs & (cs - 1)) != 0)
    return false;
  g.rows = rows;
  g.cols = cols;
  g.cin = cin;
  g.cout = cout;
  g.h = h;
  g.cs = cs;
  for (g.cs_log2 = 0; (1 << g.cs_log2) < cs; ++g.cs_log2) {
  }
  g.nslices = (cout + cs - 1) / cs;
  g.ncg = (cols + PX - 1) / PX;
  g.nog = cs / CO;
  g.wp = g.ncg * PX + 2;
  g.plane = (h + 2) * g.wp;
  g.plane += 1 - g.plane % 2;
  return h * g.ncg * g.nog <= MAX_THREADS;
}

inline size_t smem_bytes(const Geom& g) {
  return sizeof(float) * ((size_t)CC * g.plane + (size_t)9 * CC * g.cs);
}

// One output tile (see the header).  face = batch item * 6 + f.  Every
// thread of the block must call it: it synchronises the block.
template <typename T, typename Ghost>
__device__ __forceinline__ void conv_tile(
    const T* __restrict__ x, const Ghost& ghost, const T* __restrict__ keq,
    const T* __restrict__ kpo, const T* __restrict__ beq, const T* __restrict__ bpo,
    T* __restrict__ out, const Geom& g, int r0, int co0, int f, long long face,
    float* smem) {
  float* tile = smem;                  // [CC][plane], row-major (h+2) x wp
  float* wts = smem + CC * g.plane;    // [9][CC][cs]

  const int rows = g.rows, cols = g.cols, cin = g.cin, cout = g.cout;
  const T* __restrict__ k = f < 4 ? keq : kpo;
  const T* __restrict__ bias = f < 4 ? beq : bpo;
  const T* __restrict__ xf = x + face * rows * cols * cin;

  // this thread's register tile: row rr, pixels j0..j0+PX-1, channels c_lo..c_lo+CO-1
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

  const int ntile = (g.h + 2) * g.wp * CC;  // staged cells x CC channels
  const int nw = 9 * CC * g.cs;               // staged taps x CC x cs
  for (int c0 = 0; c0 < cin; c0 += CC) {
    __syncthreads();  // the previous chunk (or tile) has been consumed
    // Every thread of the block stages, STAGE loads in flight at a time:
    // the loads are issued before any of their shared-memory stores.
    // ---- padded tile: staged row pr is block row r0 - 1 + pr; element
    // idx = cell * CC + cl, consecutive threads on consecutive channels ----
    for (int base = threadIdx.x; base < ntile; base += STAGE * MAX_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        const int cell = idx / CC;
        const int pc = cell % g.wp;
        const int fr = r0 - 1 + cell / g.wp;
        const int ci = c0 + idx % CC;
        v[u] = 0.f;
        if (idx < ntile && ci < cin && pc <= cols + 1 && fr <= rows) {
          v[u] = (fr == -1 || fr == rows || pc == 0 || pc == cols + 1)
                     ? ghost(face, fr, pc, ci)
                     : to_f32(xf[((long long)fr * cols + pc - 1) * cin + ci]);
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        if (idx < ntile) tile[(idx % CC) * g.plane + idx / CC] = v[u];
      }
    }
    // ---- this chunk's taps of the face's weight group, zero past Cin/Cout;
    // element idx = (tap * CC + cl) * cs + co ----------------------------
    for (int base = threadIdx.x; base < nw; base += STAGE * MAX_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        const int co = co0 + (idx & (g.cs - 1));
        const int t = idx >> g.cs_log2;
        const int ci = c0 + t % CC;
        const int tap = t / CC;
        v[u] = (idx < nw && ci < cin && co < cout)
                   ? to_f32(k[((long long)tap * cin + ci) * cout + co])
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
      const int cmax = min(CC, cin - c0);
      for (int cl = 0; cl < cmax; ++cl) {
        const float* tp = tile + cl * g.plane + rr * g.wp + j0;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float in[PX + 2];
#pragma unroll
          for (int q = 0; q < PX + 2; ++q) in[q] = tp[dy * g.wp + q];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4* w4 = reinterpret_cast<const float4*>(
                wts + ((dy * 3 + dx) * CC + cl) * g.cs + c_lo);
            const float4 wa = w4[0], wb = w4[1];
            const float w[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int o = 0; o < CO; ++o) acc[p][o] = fmaf(in[p + dx], w[o], acc[p][o]);
          }
        }
      }
    }
  }
  const int r = r0 + rr;
  if (!active || r >= rows) return;
  T* orow = out + (face * rows + r) * cols * cout;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const int co = co0 + c_lo + o;
    if (co >= cout) break;
    const float bv = to_f32(bias[co]);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int j = j0 + p;
      if (j < cols) orow[(long long)j * cout + co] = from_f32<T>(acc[p][o] + bv);
    }
  }
}




// ---- the tensor-core routine (bfloat16 and float32) ------------------------

typedef __nv_bfloat16 bf16;

constexpr int TC_MAX_THREADS = 256;  // 8 warps
constexpr int TC_PAD = 8;            // 16-bit units after each staged cell's channels

struct TcGeom {
  int rows, cols;  // output block per face (dx: the (n+2)^2 frame)
  int kch, nch;    // reduced channels (K = 9 kch) and output channels (N)
  int h;           // output rows per tile
  int cs;          // output channels per slice (8, 16, 32 or 64)
  int nw;          // n8 tiles per warp (1, 2, 4 or 8; float32 at most 4)
  int wn, wm;      // warps along N and along M (2 m16 tiles each)
  int threads;
  int nslices;     // N slices
  int ntr;         // row tiles per face
  int unit;        // 16-bit units per element: 1 (bfloat16) or 2 (float32)
  int kc;          // K units per staged chunk (16, or 32 past 16 units)
  int nchunks, kp; // chunks; kp = nchunks * kc units
  int wp;          // staged columns: cols + 2
  int kps;         // pitch of one staged cell: kc + TC_PAD units
  int stage;       // units of one stage: (h + 2) * wp * kps
  int wpitch;      // weight row pitch in units (see tc_stage_weights)
  int wstream;     // weights streamed with each chunk (1) or resident (0)
  int wstage;      // units of one stage's weights (streamed), or of all of them
  int wsize;       // units of the weights: resident, or two stages of them
  int tpb;         // tiles per block of a whole-grid walk
  int vec;         // staged cells by 16-byte (1) or 8-byte (2) async copies
  int wvec;        // bfloat16 forward weights by 16-byte async copies
};

// Fills g; false on sizes the routine cannot take.  dx: the weight layout
// of the dx kernel; f32: float32 elements; stream: the weights streamed
// with each chunk.  The host plan (ops/hopper_conv.py::tc_plan) computes
// the same numbers.
inline bool make_tc_geom(TcGeom& g, int rows, int cols, int kch, int nch, int h, int cs,
                         int nw, int tpb, bool dx, bool f32 = false, bool stream = false) {
  if (rows < 1 || cols < 1 || kch < 1 || nch < 1 || h < 1 || h > rows || tpb < 1) return false;
  if (cs != 8 && cs != 16 && cs != 32 && cs != 64) return false;
  if (nw != 1 && nw != 2 && nw != 4 && nw != 8) return false;
  if (8 * nw > cs || (f32 && nw > 4)) return false;
  g.rows = rows;
  g.cols = cols;
  g.kch = kch;
  g.nch = nch;
  g.h = h;
  g.cs = cs;
  g.nw = nw;
  g.wn = cs / (8 * nw);
  const int mtiles = (h * cols + 15) / 16;
  g.wm = (mtiles + 1) / 2;
  g.threads = 32 * g.wm * g.wn;
  if (g.threads > TC_MAX_THREADS) return false;
  g.nslices = (nch + cs - 1) / cs;
  g.ntr = (rows + h - 1) / h;
  g.unit = f32 ? 2 : 1;
  g.kc = kch * g.unit <= 16 ? 16 : 32;
  g.nchunks = (kch * g.unit + g.kc - 1) / g.kc;
  g.kp = g.nchunks * g.kc;
  g.wp = cols + 2;
  g.kps = g.kc + TC_PAD;
  g.stage = (h + 2) * g.wp * g.kps;
  g.wstream = stream;
  const int klen = stream ? g.kc : g.kp;  // units of K a tap holds in shared memory
  if (dx || f32) {
    g.wpitch = 9 * klen + TC_PAD;  // [n][tap * klen + k]: an odd multiple of 16 bytes
    g.wstage = cs * g.wpitch;
  } else {
    g.wpitch = cs + ((cs / 8) % 2 == 0 ? 8 : 16);  // [tap * klen + k][n]: likewise
    g.wstage = 9 * klen * g.wpitch;
  }
  g.wsize = stream ? 2 * g.wstage : g.wstage;
  g.tpb = tpb;
  g.vec = 0;
  g.wvec = 0;
  return true;
}

// the weights (resident, or two stages of them), two stages and, in
// float32, the lo halves of one stage
inline size_t tc_smem_bytes(const TcGeom& g) {
  return 2 * ((size_t)g.wsize + (g.unit == 2 ? 3 : 2) * (size_t)g.stage);
}

// One tile: face = batch item * 6 + f, output rows r0.., channels n0..;
// key names the weights it needs (face group, slice).
struct TcTile {
  long long face;
  int f, r0, n0, key;
};

// The tiles of one block of a whole-grid launch: the grid holds nslices x
// P_g blocks per face group g (P_g = ceil(items_g / tpb)); a block walks
// tpb consecutive items (batch item, face of the group, row tile) of one
// (group, slice), so its weights stay staged.  ops/hopper_conv.py::
// tc_blocks enumerates the same.
struct GridWalk {
  int q, hi, grp, slice, nf, ntr, h, cs, nslices;
  __device__ GridWalk(const TcGeom& g, int batch) {
    ntr = g.ntr;
    h = g.h;
    cs = g.cs;
    nslices = g.nslices;
    const int per0 = 4 * batch * ntr, per1 = 2 * batch * ntr;
    const int p0 = (per0 + g.tpb - 1) / g.tpb, p1 = (per1 + g.tpb - 1) / g.tpb;
    int bid = blockIdx.x;
    int per;
    if (bid < nslices * p0) {
      grp = 0;
      nf = 4;
      per = per0;
      slice = bid / p0;
      bid -= slice * p0;
    } else {
      bid -= nslices * p0;
      grp = 1;
      nf = 2;
      per = per1;
      slice = bid / p1;
      bid -= slice * p1;
    }
    q = bid * g.tpb;
    hi = min(q + g.tpb, per);
  }
  __device__ bool next(TcTile& t) {
    if (q >= hi) return false;
    const int tr = q % ntr, fb = q / ntr;
    t.f = grp * 4 + fb % nf;
    t.face = (long long)(fb / nf) * 6 + t.f;
    t.r0 = tr * h;
    t.n0 = slice * cs;
    t.key = grp * nslices + slice;
    ++q;
    return true;
  }
  __device__ void before(const TcTile&) const {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared through L2 only; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
// 8 and 4 bytes (through L1: only for inputs that no one writes during the
// launch)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// an f32 bit pattern rounded to TF32 (10 explicit mantissa bits), to
// nearest, ties away from zero: the magnitude bits rounded at bit 13
__device__ __forceinline__ uint32_t tf32_rna(uint32_t v) { return (v + 0x1000u) & 0xFFFFE000u; }
// v (an f32 bit pattern) as hi + lo, each rounded to TF32
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__uint_as_float(v) - __uint_as_float(hi)));
}
// float32: the staged chunk S (cells of kps units, kc units of data each)
// split in place into its TF32 hi halves, the lo halves into L at the same
// offsets.  Every thread of the block must call it.
__device__ __forceinline__ void tc_split_stage(bf16* S, bf16* L, const TcGeom& g) {
  const int fpc = g.kc / 2;  // floats per cell
  const int n = (g.h + 2) * g.wp * fpc;
  for (int u = threadIdx.x; u < n; u += g.threads) {
    const int cell = u / fpc, off = cell * g.kps + 2 * (u - cell * fpc);
    uint32_t* sp = reinterpret_cast<uint32_t*>(S + off);
    uint32_t hi, lo;
    split_tf32(*sp, hi, lo);
    *sp = hi;
    *reinterpret_cast<uint32_t*>(L + off) = lo;
  }
}

// The forward's staging source: staged row pr, column pc of the tile at r0
// is block row r0 - 1 + pr, padded column pc; interior cells from x, the
// ring from the Ghost functor, rows past the ghost row zero.
template <typename T, typename Ghost>
struct FwdSrc {
  const T* __restrict__ x;
  Ghost ghost;
  int rows, cols, cin;
  __device__ __forceinline__ const T* base() const { return x; }  // any valid address
  // the cell's first channel, or nullptr for a zero cell
  __device__ __forceinline__ const T* cell(const TcTile& t, int pr, int pc) const {
    const int fr = t.r0 - 1 + pr;
    if (fr > rows) return nullptr;
    if (fr >= 0 && fr < rows && pc >= 1 && pc <= cols)
      return x + ((t.face * rows + fr) * cols + pc - 1) * cin;
    return ghost.cell(t.face, fr, pc);
  }
  __device__ __forceinline__ T elem(const TcTile& t, int pr, int pc, int ci) const {
    const int fr = t.r0 - 1 + pr;
    if (fr > rows) return from_f32<T>(0.f);
    if (fr >= 0 && fr < rows && pc >= 1 && pc <= cols)
      return x[((t.face * rows + fr) * cols + pc - 1) * cin + ci];
    return from_f32<T>(ghost(t.face, fr, pc, ci));  // exact: a value of type T
  }
};

// The dx kernel's: staged row pr, column pc of the frame tile at a0 is
// dout[a0 + pr - 2, pc - 2], zero outside the face.
template <typename T>
struct DxSrc {
  const T* __restrict__ dout;
  int n, cout;
  __device__ __forceinline__ const T* base() const { return dout; }  // any valid address
  __device__ __forceinline__ const T* cell(const TcTile& t, int pr, int pc) const {
    const int dr = t.r0 + pr - 2, dc = pc - 2;
    if (dr < 0 || dr >= n || dc < 0 || dc >= n) return nullptr;
    return dout + ((t.face * n + dr) * n + dc) * cout;
  }
  __device__ __forceinline__ T elem(const TcTile& t, int pr, int pc, int ci) const {
    const T* p = cell(t, pr, pc);
    return p ? p[ci] : from_f32<T>(0.f);
  }
};

// Chunk k of tile t into the stage S (16-bit units): the cell = pr * wp +
// pc holds channels k * kc / unit .. of staged cell (pr, pc) from unit
// cell * kps, zero past kch.
template <typename T, typename Src>
__device__ __forceinline__ void tc_stage_chunk(bf16* S, const Src& src, const TcTile& t, int k,
                                               const TcGeom& g) {
  constexpr int U = sizeof(T) / 2;
  const int cells = (g.h + 2) * g.wp;
  const int c0 = k * g.kc / U;
  if (g.vec == 1) {
    const int gpc = g.kc / 8;  // 16-byte groups per cell
    const int units = cells * gpc;
    for (int u = threadIdx.x; u < units; u += g.threads) {
      const int cell = u / gpc, grp = u - cell * gpc;
      const int pr = cell / g.wp, pc = cell - pr * g.wp;
      const int c = c0 + grp * (8 / U);
      const T* p = c < g.kch ? src.cell(t, pr, pc) : nullptr;
      cp_async16(S + cell * g.kps + grp * 8, p ? p + c : src.base(), p ? 16 : 0);
    }
  } else if (g.vec == 2) {
    const int gpc = g.kc / 4;  // 8-byte groups per cell
    const int units = cells * gpc;
    for (int u = threadIdx.x; u < units; u += g.threads) {
      const int cell = u / gpc, grp = u - cell * gpc;
      const int pr = cell / g.wp, pc = cell - pr * g.wp;
      const int c = c0 + grp * (4 / U);
      const T* p = c < g.kch ? src.cell(t, pr, pc) : nullptr;
      cp_async8(S + cell * g.kps + grp * 4, p ? p + c : src.base(), p ? 8 : 0);
    }
  } else {
    // ordinary loads, 4 in flight per thread before their stores
    const int epc = g.kc / U;  // elements per cell
    const int units = cells * epc;
    for (int base = threadIdx.x; base < units; base += 4 * g.threads) {
      T v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = base + i * g.threads;
        const int cell = u / epc, cc = u - cell * epc;
        const int pr = cell / g.wp, pc = cell - pr * g.wp;
        v[i] = (u < units && c0 + cc < g.kch) ? src.elem(t, pr, pc, c0 + cc) : from_f32<T>(0.f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = base + i * g.threads;
        if (u < units) reinterpret_cast<T*>(S + (u / epc) * g.kps)[u % epc] = v[i];
      }
    }
  }
}

// The weights of tile t's (face group, slice) for the K units kb ..
// kb + kl of every tap (kb = 0, kl = kp: all of them, resident; kb = k kc,
// kl = kc: chunk k's, streamed), zero past kch and nch, in 16-bit units.
// k is HWIO (3, 3, Cin, Cout) of the group.  With K unit kb + q:
//   bfloat16 forward: Ws[tap * kl + q][c] = k[tap][kb + q][n0 + c]
//                     (B as k x n, n contiguous: straight copies of rows of k)
//   dx:               Ws[c][tap * kl + q] = k[8 - tap][n0 + c][kb + q]
//                     (B as n x k, k contiguous: straight copies of rows of k)
//   float32 forward:  Ws[c][(tap * kl + 2 q) / 2] = k[tap][(kb + 2 q) / 2][n0 + c], as f32
//                     (B as n x k: transposed here, by 4-byte copies)
//   float32 dx:       Ws[c][(tap * kl + 2 q) / 2] = k[8 - tap][n0 + c][(kb + 2 q) / 2], as f32
//                     (B as n x k, k contiguous: straight copies of rows of k)
// with, for dx, kch = Cout (K) and nch = Cin (N).
template <bool DX, typename T>
__device__ __forceinline__ void tc_stage_weights(bf16* Ws, const T* __restrict__ k,
                                                 const TcTile& t, const TcGeom& g, int kb,
                                                 int kl) {
  if constexpr (DX && std::is_same<T, float>::value) {
    float* Wf = reinterpret_cast<float*>(Ws);
    const int kpe = kl / 2, kbe = kb / 2, wpe = g.wpitch / 2;  // in floats
    const int rows = g.cs * 9;                                // (c, tap)
    if (g.wvec) {                                             // Cout a multiple of 4, aligned
      const int gpr = kpe / 4;
      for (int u = threadIdx.x; u < rows * gpr; u += g.threads) {
        const int row = u / gpr, q = (u - row * gpr) * 4;
        const int c = row / 9, tap = row - c * 9;
        const int ci = t.n0 + c, co = kbe + q;
        const bool ok = ci < g.nch && co < g.kch;
        const float* p = k + ((long long)(8 - tap) * g.nch + ci) * g.kch + co;
        cp_async16(Wf + c * wpe + tap * kpe + q, ok ? p : k, ok ? 16 : 0);
      }
    } else {
      for (int u = threadIdx.x; u < rows * kpe; u += g.threads) {
        const int row = u / kpe, q = u - row * kpe;
        const int c = row / 9, tap = row - c * 9;
        const int ci = t.n0 + c, co = kbe + q;
        const bool ok = ci < g.nch && co < g.kch;
        const float* p = k + ((long long)(8 - tap) * g.nch + ci) * g.kch + co;
        cp_async4(Wf + c * wpe + tap * kpe + q, ok ? p : k, ok ? 4 : 0);
      }
    }
  } else if constexpr (std::is_same<T, float>::value) {
    float* Wf = reinterpret_cast<float*>(Ws);
    const int kpe = kl / 2, kbe = kb / 2, wpe = g.wpitch / 2;  // in floats
    const int rows = 9 * kpe;  // (tap, ci), consecutive threads on c
    for (int u = threadIdx.x; u < rows * g.cs; u += g.threads) {
      const int row = u / g.cs, c = u - row * g.cs;
      const int tap = row / kpe, ci = kbe + row - tap * kpe;
      const bool ok = ci < g.kch && t.n0 + c < g.nch;
      const float* p = k + ((long long)tap * g.kch + ci) * g.nch + t.n0 + c;
      cp_async4(Wf + c * wpe + row, ok ? p : k, ok ? 4 : 0);
    }
  } else if (!DX) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    // rows (tap, ci) of cs channels from n0; k row (tap, ci) has nch channels
    const int rows = 9 * kl;
    if (g.wvec) {
      const int gpr = g.cs / 8;
      for (int u = threadIdx.x; u < rows * gpr; u += g.threads) {
        const int row = u / gpr, c = (u - row * gpr) * 8;
        const int tap = row / kl, ci = kb + row - tap * kl;
        const bool ok = ci < g.kch && t.n0 + c < g.nch;
        const bf16* p = k + ((long long)tap * g.kch + ci) * g.nch + t.n0 + c;
        cp_async16(Ws + row * g.wpitch + c, ok ? p : k, ok ? 16 : 0);
      }
    } else {
      for (int u = threadIdx.x; u < rows * g.cs; u += g.threads) {
        const int row = u / g.cs, c = u - row * g.cs;
        const int tap = row / kl, ci = kb + row - tap * kl;
        Ws[row * g.wpitch + c] = (ci < g.kch && t.n0 + c < g.nch)
                                     ? k[((long long)tap * g.kch + ci) * g.nch + t.n0 + c]
                                     : zero;
      }
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    // rows c of the slice, 9 taps of kl reduced channels each; k row
    // (tap, ci) has kch (= Cout) channels
    const int rows = g.cs * 9;
    if (g.wvec) {
      const int gpr = kl / 8;
      for (int u = threadIdx.x; u < rows * gpr; u += g.threads) {
        const int row = u / gpr, q = (u - row * gpr) * 8;
        const int c = row / 9, tap = row - c * 9;
        const int ci = t.n0 + c, co = kb + q;
        const bool ok = ci < g.nch && co < g.kch;
        const bf16* p = k + ((long long)(8 - tap) * g.nch + ci) * g.kch + co;
        cp_async16(Ws + c * g.wpitch + tap * kl + q, ok ? p : k, ok ? 16 : 0);
      }
    } else {
      for (int u = threadIdx.x; u < rows * kl; u += g.threads) {
        const int row = u / kl, q = u - row * kl;
        const int c = row / 9, tap = row - c * 9;
        const int ci = t.n0 + c, co = kb + q;
        Ws[c * g.wpitch + tap * kl + q] =
            (ci < g.nch && co < g.kch) ? k[((long long)(8 - tap) * g.nch + ci) * g.kch + co]
                                        : zero;
      }
    }
  }
}

// T: bf16 or float.  KC: g.kc, the K units per chunk
// (16 or 32), fixed at compile time so that a chunk's 9 x KC / 16 steps
// unroll.  The block walks its tiles (Walk::next; Walk::before(t) runs, on
// every thread, before t's first chunk is requested, and may synchronise
// the block).  Per tile, Epi::store(t, i, j, n, v0, v1) takes the f32 sums
// of output row i, column j of the tile, channels n and n + 1 (n even;
// either may be past nch).  Every thread of the block must call it; it
// synchronises the block.  keq / kpo: the weight groups (faces 0-3, 4-5).
template <typename T, int NW, int KC, bool DX, bool WS = false, typename Src, typename Walk,
          typename Epi>
__device__ __forceinline__ void tc_conv(const TcGeom& g, const Src& src, Walk& walk,
                                        const Epi& epi, const T* __restrict__ keq,
                                        const T* __restrict__ kpo, unsigned char* smem_raw) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr bool BT = DX || F32;  // weights as n x k rows
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // resident, or two stages of weights
  bf16* St = Ws + g.wsize;  // two stages
  bf16* Lo = St + 2 * g.stage;  // float32: the lo halves of the stage in use
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm_i = warp % g.wm, wn_i = warp / g.wm;
  const int gid = lane >> 2, tig = lane & 3;
  const int nbase = wn_i * NW * 8;  // this warp's first channel in the slice

  // chunk kk of tile tt into stage b: its input cells and, streamed, its weights
  auto stage = [&](int b, const TcTile& tt, int kk) {
    tc_stage_chunk<T>(St + b * g.stage, src, tt, kk, g);
    if constexpr (WS)
      tc_stage_weights<DX>(Ws + b * g.wstage, tt.f < 4 ? keq : kpo, tt, g, kk * g.kc, g.kc);
  };
  TcTile t, tn;
  if (!walk.next(t)) return;
  bool has_next = walk.next(tn);
  bool staged = false;  // streamed: t's first chunk sits in stage buf
  int key = -1, k = 0, buf = 0;
  float acc[2][NW][4];
  int a_cell[2];
  bool m_on[2];
  for (;;) {
    cp_async_wait_all();
    __syncthreads();  // stage buf has landed; the other stage is consumed
    // the first tile; streamed, a tile whose first chunk the last did not
    // stage; resident, the weights of another group or slice (uniform)
    if (k == 0 && (WS ? !staged : t.key != key)) {
      walk.before(t);
      if constexpr (!WS) tc_stage_weights<DX>(Ws, t.f < 4 ? keq : kpo, t, g, 0, g.kp);
      stage(buf, t, 0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      key = t.key;
    }
    if constexpr (WS) staged = false;
    if (k + 1 < g.nchunks) {
      stage(buf ^ 1, t, k + 1);
    } else if (has_next && (WS || tn.key == key)) {
      walk.before(tn);
      stage(buf ^ 1, tn, 0);
      if constexpr (WS) staged = true;
    }
    cp_async_commit();
    if constexpr (F32) {
      tc_split_stage(St + buf * g.stage, Lo, g);
      __syncthreads();
    }
    if (k == 0) {
      const int valid = min(g.h, g.rows - t.r0) * g.cols;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = (2 * wm_i + mt) * 16;
        m_on[mt] = m0 < valid;
        const int p = m0 + (lane & 15);
        const int i = p / g.cols, j = p - i * g.cols;
        a_cell[mt] = p < valid ? i * g.wp + j : 0;
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
      }
    }
    // ---- chunk k: 9 taps x KC / 16 steps of 16 units ----
    constexpr int KPS = KC + TC_PAD;
    const bf16* S = St + buf * g.stage + (lane >> 4) * 8;
    const bf16* a_row[2] = {S + a_cell[0] * KPS, S + a_cell[1] * KPS};
    // float32: a_row[mt] + lo_off holds the lo halves of a_row[mt]
    const int lo_off = Lo - (St + buf * g.stage);
    const int row_step = g.wp * KPS;  // one staged row
    // B fragments: this lane's row of tap 0, unit k * KC (streamed: the
    // stage's unit 0), and the steps to the next tap, the next 16 units,
    // the next n8 pair
    const bf16* W = WS ? Ws + buf * g.wstage : Ws;
    const int kofs = WS ? 0 : k * KC, klen = WS ? KC : g.kp;
    const bf16* wk =
        BT ? W + (nbase + ((lane >> 4) << 3) + (lane & 7)) * g.wpitch + kofs +
                 ((lane >> 3) & 1) * 8
           : W + (kofs + (lane & 15)) * g.wpitch + nbase + (lane >> 4) * 8;
    const int tap_step = BT ? klen : klen * g.wpitch;
    const int kk_step = BT ? 16 : 16 * g.wpitch;
    const int pair_step = BT ? 16 * g.wpitch : 16;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * row_step + (tap % 3) * KPS;
      float part[2][NW][4];  // float32: this tap's products (see the header)
      if constexpr (F32) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[mt][nt][r] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const bf16* wb = wk + tap * tap_step + (kk / 16) * kk_step;
        uint32_t b[NW][2];
        if constexpr (NW == 1) {
          uint32_t r[2];
          if constexpr (BT) ldsm_x2(r, wb); else ldsm_x2_t(r, wb);
          b[0][0] = r[0];
          b[0][1] = r[1];
        } else {
#pragma unroll
          for (int j = 0; j < NW / 2; ++j) {
            uint32_t r[4];
            if constexpr (BT) ldsm_x4(r, wb + j * pair_step); else ldsm_x4_t(r, wb + j * pair_step);
            b[2 * j][0] = r[0];
            b[2 * j][1] = r[1];
            b[2 * j + 1][0] = r[2];
            b[2 * j + 1][1] = r[3];
          }
        }
        if constexpr (F32) {
          uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) split_tf32(b[nt][e], bh[nt][e], bl[nt][e]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (!m_on[mt]) continue;
            uint32_t ah[4], al[4];
            ldsm_x4(ah, a_row[mt] + shift + kk);
            ldsm_x4(al, a_row[mt] + lo_off + shift + kk);
#pragma unroll
            for (int nt = 0; nt < NW; ++nt) {
              mma_tf32(part[mt][nt], al, bh[nt][0], bh[nt][1]);
              mma_tf32(part[mt][nt], ah, bl[nt][0], bl[nt][1]);
              mma_tf32(part[mt][nt], ah, bh[nt][0], bh[nt][1]);
            }
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (!m_on[mt]) continue;
            uint32_t a[4];
            ldsm_x4(a, a_row[mt] + shift + kk);
#pragma unroll
            for (int nt = 0; nt < NW; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
      if constexpr (F32) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] += part[mt][nt][r];
      }
    }
    if (k + 1 < g.nchunks) {
      ++k;
    } else {
      // ---- the tile's sums: row gid (+8) of each m16 tile, channels 2 tig, +1
      const int valid = min(g.h, g.rows - t.r0) * g.cols;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!m_on[mt]) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (2 * wm_i + mt) * 16 + gid + half * 8;
          if (p >= valid) continue;
          const int i = p / g.cols, j = p - i * g.cols;
#pragma unroll
          for (int nt = 0; nt < NW; ++nt)
            epi.store(t, i, j, t.n0 + nbase + nt * 8 + 2 * tig, acc[mt][nt][2 * half],
                      acc[mt][nt][2 * half + 1]);
        }
      }
      if (!has_next) break;
      t = tn;
      has_next = walk.next(tn);
      k = 0;
    }
    buf ^= 1;
  }
  cp_async_wait_all();  // nothing left in flight when the block ends
}

}  // namespace cs3x3
