// Tensor-core formulations of the fused halo-pad + 3x3 cubed-sphere conv for
// Hopper (sm_90a): kn2row (the "npack" kernel) and im2col.  bfloat16 inputs,
// float32 sums, one rounding to bfloat16.
//
// Replaces two TPU kernels that compute the function of
// dlwp_cs_tpu/ops/pallas_conv.py::_kernel (csrc/cs_conv3x3.cu here) in another
// shape of matrix product:
//   * dlwp_cs_tpu/ops/pallas_conv.py::_kernel_npack (launched by
//     tools/kernel_variants.py::call_kernel from its "npack" row): kn2row.
//     Per dy, one product of the padded face's rows with the dy slice of the
//     tap-packed weights (Cin, 9*Cout), then the dx-shifted adds of its three
//     Cout slices: cs_conv3x3_npack_tiles_kernel (namespace kn2, at the
//     end), and the kernel of the first design, cs_conv3x3_npack_kernel,
//     which stays as a timing row;
//   * tools/kernel_variants.py::_kernel_im2col (launched by call_im2col):
//     im2col.  The 9 shifted windows of the padded face side by side in one
//     (pixels, 9*Cin) column tile, one product with the weights (9*Cin, Cout):
//     cs_conv3x3_im2col_gemm_kernel (below, after the two kernels of the
//     first design, which stay: kn2row, and the im2col kernel as a timing
//     row, cs_conv3x3_im2col_kernel).
// The reference's W/E ghost-column correction dots (a Mosaic workaround) and
// its batch->lane packing (a TPU layout) are not part of the math: here the
// W/E ghost columns are staged with the face, and the packing, where a tool
// times it, is a reshape outside the kernel.
//
// What each computes, per face f of batch item b, with P the (n+2)^2 padded
// face (P[0,:] = ext S, P[n+1,:] = ext N, corners included; P[1..n,0] = ext
// W[1..n], P[1..n,n+1] = ext E[1..n]; P[1..n,1..n] = x) and g the face's
// weight group (equatorial for faces 0-3, polar for 4-5):
//     out[i,j,:] = sum_{dy,dx} P[i+dy, j+dx, :] . K_g[dy,dx] + b_g
// with the weights passed tap-packed as the tools pass them:
//     npack:  taps (Cin, 9*Cout), taps[ci, (dy*3+dx)*Cout + co] = K[dy,dx,ci,co]
//     im2col: taps (9*Cin, Cout), taps[(dy*3+dx)*Cin + ci, co] = K[dy,dx,ci,co]
//
// What bounds them on this card: each does the conv's 2*B*6*n^2*9*Cin*Cout
// operations (kn2row (n+2)/n of that: its products cover the n+2 padded
// columns), on the tensor cores by mma.sync.m16n8k16 (bf16 in,
// f32 sums); at the flagship shapes that is 0.03-0.3 GFLOP a conv at batch 1,
// well under a microsecond at 989 TFLOP/s, and under a megabyte of traffic.
// So latency bounds them: the staging of the padded rows and of the weights
// into shared memory (global loads, 16 bytes a thread where Cin allows), the
// barriers between the phases, and, for kn2row, the round trip of each
// product through shared memory for the shifted adds.  The design answers
// with row tiles of one face (1 to 8 output rows) so that a batch-1 face set
// spreads over the SMs, 256 threads that all stage, and fragments loaded from
// rows padded by 8 elements (16 bytes), so that the 32 lanes of a fragment
// load hit 32 distinct banks.  No wgmma, no TMA, no double buffering: the
// simple kernel first.
//
// Layouts (channels last, all contiguous, bf16):
//   x (B, 6, n, n, Cin)   ext (B, 6, 4, n+2, Cin) [S, N, W, E]   b_* (Cout,)
//   out (B, 6, n, n, Cout)
// Grid: (row tiles, 6, B); 256 threads.  Shared memory per block:
//   T   (h+2) x mp x kps bf16: the padded rows r0 .. r0+h+1 (mp >= n+2
//       columns rounded up to 16, kps = Cin rounded up to 16, plus 8);
//   npack:  Bs (3*Cout rounded up to 8) x kps bf16 (one dy slice of the
//           taps, k contiguous), Pf mp x (3*Cout + 8) f32 (one product),
//           O h x n x Cout f32 (the output sums);
//   im2col: Col M x (9*kp + 8) bf16 (M = h*n rounded up to 16), Bs Cout8 x
//           kps bf16 (one tap's weights, k contiguous).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cs_conv3x3_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NPACK_TPW = 8;   // npack: accumulator tiles per warp and pass
constexpr int IM_TPW = 8;      // im2col: accumulator tiles per warp (whole block)
constexpr int PAD = 8;         // bf16 elements after each staged row
constexpr int STAGE = 4;       // staging loads in flight per thread

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct MmaGeom {
  int n, cin, cout;
  int h;     // output rows per block
  int kp;    // Cin rounded up to 16
  int kps;   // pitch of one staged cell or weight column: kp + PAD
  int mp;    // staged columns per padded row: n + 2 rounded up to 16
  int nb;    // npack: product columns per dy, 3 * Cout rounded up to 8
  int pps;   // npack: f32 pitch of one product row, nb + 8
  int m;     // im2col: column-tile rows, h * n rounded up to 16
  int kcs;   // im2col: pitch of one column-tile row, 9 * kp + PAD
  int co8;   // im2col: Cout rounded up to 8
  int vec;   // 16-byte staging copies (Cin % 8 == 0, 16-byte aligned x and ext)
  int wvec;  // 16-byte weight loads (Cout % 8 == 0, 16-byte aligned weights)
};

// The cell (p, pc) of the padded face: a pointer to its Cin channels.
__device__ __forceinline__ const bf16* cell_ptr(const bf16* xf, const bf16* ef, int n, int cin,
                                                int p, int pc) {
  const long long m = n + 2;
  if (p == 0) return ef + (long long)pc * cin;                   // S, corners included
  if (p == n + 1) return ef + (m + pc) * cin;                    // N, corners included
  if (pc == 0) return ef + (2 * m + p) * cin;                    // W ghost column
  if (pc == n + 1) return ef + (3 * m + p) * cin;                // E ghost column
  return xf + ((long long)(p - 1) * n + pc - 1) * cin;
}

// T[pr][pc][ci] = P[r0 + pr][pc][ci] for pr < rows, pc < mp, ci < kp; zero
// past the padded face and past Cin.  Every thread has STAGE loads in flight
// before it stores any of them.
__device__ void stage_rows(bf16* T, const bf16* xf, const bf16* ef, const MmaGeom& g, int r0,
                           int rows) {
  const int n = g.n, cin = g.cin;
  if (g.vec) {
    const int cv = g.kp / 8;
    const int total = rows * g.mp * cv;
    for (int base = threadIdx.x; base < total; base += STAGE * THREADS) {
      uint4 v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        const int ci = (idx % cv) * 8;
        const int cell = idx / cv;
        const int pc = cell % g.mp, p = r0 + cell / g.mp;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < total && ci < cin && p <= n + 1 && pc <= n + 1)
          v[u] = *reinterpret_cast<const uint4*>(cell_ptr(xf, ef, n, cin, p, pc) + ci);
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        if (idx < total)
          *reinterpret_cast<uint4*>(T + (long long)(idx / cv) * g.kps + (idx % cv) * 8) = v[u];
      }
    }
  } else {
    const int total = rows * g.mp * g.kp;
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int base = threadIdx.x; base < total; base += STAGE * THREADS) {
      bf16 v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        const int ci = idx % g.kp;
        const int cell = idx / g.kp;
        const int pc = cell % g.mp, p = r0 + cell / g.mp;
        v[u] = (idx < total && ci < cin && p <= n + 1 && pc <= n + 1)
                   ? cell_ptr(xf, ef, n, cin, p, pc)[ci]
                   : zero;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        if (idx < total) T[(long long)(idx / g.kp) * g.kps + idx % g.kp] = v[u];
      }
    }
  }
}

// Weights transposed into shared memory, k contiguous: Bs[c][k] = w[k * ld +
// c] for k < nk, c < nc; zero for k in [nk, kp) and c in [nc, ncp) (ncp a
// multiple of 8).  vec: 16-byte loads of 8 consecutive c (nc % 8 == 0,
// w and ld 16-byte aligned).  Consecutive threads take consecutive k, so the
// transposed stores of a warp fall in distinct banks.
__device__ void stage_weights(bf16* Bs, const bf16* w, long long ld, int nk, int nc, int ncp,
                              const MmaGeom& g, bool vec) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (vec) {
    const int total = (ncp / 8) * g.kp;
    for (int base = threadIdx.x; base < total; base += STAGE * THREADS) {
      uint4 v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        const int k = idx % g.kp, c = (idx / g.kp) * 8;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < total && k < nk && c < nc)
          v[u] = *reinterpret_cast<const uint4*>(w + k * ld + c);
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        if (idx >= total) continue;
        const int k = idx % g.kp, c = (idx / g.kp) * 8;
        const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};  // 2 bf16 each, low first
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Bs[(long long)(c + j) * g.kps + k] =
              __ushort_as_bfloat16((unsigned short)(words[j / 2] >> (16 * (j % 2))));
      }
    }
  } else {
    const int total = ncp * g.kp;
    for (int base = threadIdx.x; base < total; base += STAGE * THREADS) {
      bf16 v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        const int k = idx % g.kp, c = idx / g.kp;
        v[u] = (idx < total && k < nk && c < nc) ? w[k * ld + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * THREADS;
        if (idx < total) Bs[(long long)(idx / g.kp) * g.kps + idx % g.kp] = v[u];
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += A(16 x 16) . B(16 x 8) on the tensor cores.  a: row 0, k 0 of the A
// tile in shared memory (rows lda apart, k contiguous); b: column 0, k 0 of
// the B tile (columns ldb apart, k contiguous).  d is the m16n8 f32
// accumulator fragment: d[0], d[1] at row lane/4, columns 2*(lane%4) + 0, 1;
// d[2], d[3] at row lane/4 + 8.
__device__ __forceinline__ void mma_16x8x16(float (&d)[4], const bf16* a, int lda, const bf16* b,
                                            int ldb) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bf16* ap = a + gid * lda + tig * 2;
  const bf16* bp = b + gid * ldb + tig * 2;
  const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * lda), a2 = ld32(ap + 8),
                 a3 = ld32(ap + 8 * lda + 8);
  const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- kn2row ----------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) cs_conv3x3_npack_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ext, const bf16* __restrict__ teq,
    const bf16* __restrict__ tpo, const bf16* __restrict__ beq, const bf16* __restrict__ bpo,
    bf16* __restrict__ out, MmaGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = g.n, cin = g.cin, cout = g.cout, h = g.h;
  bf16* T = reinterpret_cast<bf16*>(smem);                            // [h+2][mp][kps]
  bf16* Bs = T + (long long)(h + 2) * g.mp * g.kps;                   // [nb][kps]
  float* Pf = reinterpret_cast<float*>(Bs + (long long)g.nb * g.kps); // [mp][pps]
  float* O = Pf + (long long)g.mp * g.pps;                             // [h][n][cout]

  const int r0 = blockIdx.x * h;
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const bf16* __restrict__ taps = f < 4 ? teq : tpo;
  const bf16* __restrict__ bias = f < 4 ? beq : bpo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  stage_rows(T, x + face * n * n * cin, ext + face * 4 * (n + 2) * cin, g, r0, h + 2);
  for (int e = threadIdx.x; e < h * n * cout; e += THREADS) O[e] = 0.f;

  const int nt = g.nb / 8, ntl = (g.mp / 16) * nt;
  for (int dy = 0; dy < 3; ++dy) {
    __syncthreads();  // the previous dy slice has been consumed
    // Bs[c][k] = taps[k][dy * 3 * Cout + c]: the three dx slices of this dy
    stage_weights(Bs, taps + dy * 3 * cout, 9LL * cout, cin, 3 * cout, g.nb, g, g.wvec);
    __syncthreads();
    for (int i = 0; i < h && r0 + i < n; ++i) {
      // the product of padded row r0 + i + dy (all n + 2 columns) with Bs
      const bf16* A = T + (long long)(i + dy) * g.mp * g.kps;
      for (int base = 0; base < ntl; base += NWARPS * NPACK_TPW) {
        float acc[NPACK_TPW][4];
        int a_off[NPACK_TPW], b_off[NPACK_TPW];  // this warp's tiles, outside the k loop
#pragma unroll
        for (int q = 0; q < NPACK_TPW; ++q) {
          const int t = base + q * NWARPS + warp;
          a_off[q] = (t / nt) * 16 * g.kps;
          b_off[q] = (t % nt) * 8 * g.kps;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;
        }
        for (int k = 0; k < g.kp; k += 16) {
#pragma unroll
          for (int q = 0; q < NPACK_TPW; ++q) {
            if (base + q * NWARPS + warp < ntl)
              mma_16x8x16(acc[q], A + a_off[q] + k, g.kps, Bs + b_off[q] + k, g.kps);
          }
        }
#pragma unroll
        for (int q = 0; q < NPACK_TPW; ++q) {
          const int t = base + q * NWARPS + warp;
          if (t < ntl) {
            float* p = Pf + (long long)((t / nt) * 16 + gid) * g.pps + (t % nt) * 8 + tig * 2;
            p[0] = acc[q][0];
            p[1] = acc[q][1];
            p[8 * g.pps] = acc[q][2];
            p[8 * g.pps + 1] = acc[q][3];
          }
        }
      }
      __syncthreads();
      // the kn2row shift: output column j takes product rows j, j+1, j+2
      // from the dx = 0, 1, 2 slices
      float* Oi = O + (long long)i * n * cout;
      for (int e = threadIdx.x; e < n * cout; e += THREADS) {
        const int j = e / cout, co = e % cout;
        const float* p = Pf + (long long)j * g.pps + co;
        Oi[e] += p[0] + p[g.pps + cout] + p[2 * g.pps + 2 * cout];
      }
      __syncthreads();  // Pf is free for the next row
    }
  }
  const int rows = min(h, n - r0);
  bf16* orow = out + (face * n + r0) * n * cout;
  for (int e = threadIdx.x; e < rows * n * cout; e += THREADS)
    orow[e] = __float2bfloat16_rn(O[e] + __bfloat162float(bias[e % cout]));
}

// ---- im2col ----------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) cs_conv3x3_im2col_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ext, const bf16* __restrict__ weq,
    const bf16* __restrict__ wpo, const bf16* __restrict__ beq, const bf16* __restrict__ bpo,
    bf16* __restrict__ out, MmaGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = g.n, cin = g.cin, cout = g.cout, h = g.h;
  bf16* T = reinterpret_cast<bf16*>(smem);           // [h+2][mp][kps]
  bf16* Col = T + (long long)(h + 2) * g.mp * g.kps; // [m][kcs]
  bf16* Bs = Col + (long long)g.m * g.kcs;           // [co8][kps]

  const int r0 = blockIdx.x * h;
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const bf16* __restrict__ w = f < 4 ? weq : wpo;
  const bf16* __restrict__ bias = f < 4 ? beq : bpo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int valid = min(h, n - r0) * n;  // output pixels of this tile

  stage_rows(T, x + face * n * n * cin, ext + face * 4 * (n + 2) * cin, g, r0, h + 2);
  __syncthreads();
  // the column tile: Col[m][t * kp + ci] = P[r0 + i + dy][j + dx][ci] for
  // output pixel m = i * n + j and tap t = dy * 3 + dx; zero rows past the tile
  {
    const int cv = g.kp / 8;
    const int total = g.m * 9 * cv;
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int unit = idx / cv;  // (pixel, tap)
      const int ci = (idx - unit * cv) * 8;
      const int m = unit / 9, t = unit - m * 9;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < valid) {
        const int i = m / n, j = m - i * n, dy = t / 3, dx = t - dy * 3;
        v = *reinterpret_cast<const uint4*>(
            T + ((long long)(i + dy) * g.mp + j + dx) * g.kps + ci);
      }
      *reinterpret_cast<uint4*>(Col + (long long)m * g.kcs + t * g.kp + ci) = v;
    }
  }
  const int nt = g.co8 / 8, ntl = (g.m / 16) * nt;
  float acc[IM_TPW][4];
  int a_off[IM_TPW], b_off[IM_TPW];  // this warp's tiles, outside the tap and k loops
#pragma unroll
  for (int q = 0; q < IM_TPW; ++q) {
    const int tl = q * NWARPS + warp;
    a_off[q] = (tl / nt) * 16 * g.kcs;
    b_off[q] = (tl % nt) * 8 * g.kps;
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;
  }
  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the column tile is written; the previous tap's Bs consumed
    // Bs[c][k] = w[t * Cin + k][c]: this tap's (Cin, Cout) block, k contiguous
    stage_weights(Bs, w + (long long)t * cin * cout, cout, cin, cout, g.co8, g, g.wvec);
    __syncthreads();
    const bf16* colt = Col + t * g.kp;
    for (int k = 0; k < g.kp; k += 16) {
#pragma unroll
      for (int q = 0; q < IM_TPW; ++q) {
        if (q * NWARPS + warp < ntl)
          mma_16x8x16(acc[q], colt + a_off[q] + k, g.kcs, Bs + b_off[q] + k, g.kps);
      }
    }
  }
  // bias and one rounding, straight from the accumulator fragments
  bf16* otile = out + (face * n + r0) * n * cout;
#pragma unroll
  for (int q = 0; q < IM_TPW; ++q) {
    const int tl = q * NWARPS + warp;
    if (tl >= ntl) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (tl / nt) * 16 + gid + half * 8;
      if (m >= valid) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (tl % nt) * 8 + tig * 2 + e;
        if (c < cout)
          otile[(long long)m * cout + c] =
              __float2bfloat16_rn(acc[q][half * 2 + e] + __bfloat162float(bias[c]));
      }
    }
  }
}


// ---- im2col as one GEMM per weight group (cs_conv3x3_im2col_gemm_kernel) ----
//
// The function of cs_conv3x3_im2col_kernel, tiled for this card.  What held
// that kernel back: blocks of one face's 1-8 output rows, each staging all
// nine taps' weights through L2 for a few dozen pixels; a serial chain of
// staging, column building and nine barrier-separated tap products, no copy
// overlapping a product; accumulators capped at 64 tiles a block (h * n *
// Cout <= 8192: not even one row at n = 48, Cout = 256); 2-byte stores from
// the fragments.
//
// Here the pixels of faces 0-3 over the batch are the M rows of one GEMM
// with K_eq, those of faces 4-5 of one with K_pole: out_g (M_g, Cout) =
// Col_g (M_g, 9*kp) . W_g (9*kp, Cout) + b_g, kp = Cin rounded up to 16, K
// ordered (tap, cin) as the weights are.  A block owns a BM x BN tile
// (BM 64 or 128 pixels, BN 32 or 64 channels; ops/conv_variants.py::
// im2col_plan picks the configuration) and walks K in windows: tpw whole
// taps (tpw * kp <= the window's width) or one slice of bks channels of a
// tap.  For each window the block's BM rows of the column matrix are
// gathered by cp.async straight from x and the ext strips (a (pixel, tap)
// row is one contiguous Cin run of one or the other; channels past Cin and
// rows past M_g zero-filled by the copy's source size), and the window's
// rows of the weights (one BN slice) likewise; three stages, so that two
// windows' copies are in flight during a window's products.  Fragments by
// ldmatrix from rows padded by 8 elements (the 8 rows of a load hit
// distinct banks; B by .trans from k-major rows), the next k step's loaded
// before this one's mma.sync m16n8k16 (bf16, f32 sums).  At batch 1 the
// tiles are few (a face group of a 24 x 24 face is 2,304 pixels) and each
// block's walk over K is a chain of latencies, one barrier and one copy
// wait a window: there the windows are as wide as the blocks' shared
// memory allows (up to 256 of K, all nine taps at Cin <= 16), the tiles
// small (64 pixels), and KG = 2 groups of warps share each window's k
// steps (k step s to group s % KG), adding their partial sums through
// shared memory in group order.  With many tiles (batch 16) 128-pixel
// tiles and windows of at most 128 that keep two blocks an SM.  Epilogue: bias, one rounding, the tile staged in shared
// memory and written with 16-byte stores.  Copies are 16 bytes where Cin's
// (Cout's) bytes and the addresses allow, else 8 or 4 (Cin = 12: 24-byte
// runs), else plain 2-byte loads (odd Cin).  Each output is one block's
// sum in one fixed order: launches agree bit for bit.
//
// What bounds it (tools/im2col_phases.py: variants with phases compiled
// out, and the K window widths, timed on the card; PERF.md): not the
// bytes (the bound is a few us a conv) but a chain of latencies per
// window: its copy wait and barrier, the ldmatrix loads and the products.
// Fewer, wider windows are what shortened it at batch 1.
namespace im2 {

constexpr int STAGES = 3;
constexpr int PADE = 8;  // bf16 elements after each staged row

struct Geom {
  int batch, n, cin, cout;
  int bm, bn, threads, kg;  // tile rows, columns; threads a block; warp groups along K
  int kp;                   // a tap's K run: Cin rounded up to 16
  int bks, nsl, tpw;        // a window: tpw whole taps (nsl = 1, bks = kp) or a bks slice
  int nwin;                 // windows: ceil(9 / tpw) * nsl
  int ga, gb, go;           // copy granules (bytes) of A rows, B rows; 16-byte stores
  int apitch, bpitch;       // staged A and B row pitches (elements)
  int mt_eq, mt_po, nt;     // M tiles of each group, N tiles
  int ub_log2;              // log2 of B units a row (bn * 2 / gb)
  long long m_eq, m_po;     // M of each group
};

// The configurations the plan chooses from: (warps along M, along N, m16
// tiles a warp, n8 tiles a warp, warp groups along K).
template <int WM_, int WN_, int TM_, int TN_, int KG_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, TM = TM_, TN = TN_, KG = KG_;
  static constexpr int BM = WM * TM * 16, BN = WN * TN * 8;
  static constexpr int THREADS = WM * WN * KG * 32;
};
typedef Cfg<2, 2, 2, 2, 2> Cfg0;  // 64 x 32, 8 warps (2 groups along K): batch 1
typedef Cfg<2, 2, 2, 4, 2> Cfg1;  // 64 x 64, the same
typedef Cfg<4, 2, 2, 2, 1> Cfg2;  // 128 x 32, 8 warps: many tiles
typedef Cfg<4, 2, 2, 4, 1> Cfg3;  // 128 x 64, 8 warps

inline size_t smem_bytes(const Geom& g) {
  const int kw = g.tpw * g.bks;
  const size_t stages = (size_t)STAGES * 2 * ((size_t)g.bm * g.apitch + (size_t)kw * g.bpitch);
  const size_t epilogue = (size_t)(g.kg - 1) * g.bm * g.bn * 4 + (size_t)g.bm * g.bpitch * 2;
  return stages > epilogue ? stages : epilogue;
}

inline int granule(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void copy_unit(bf16* dst, const bf16* src, int g, int bytes) {
  if (g == 16) cs3x3::cp_async16(dst, src, bytes);
  else if (g == 8) cs3x3::cp_async8(dst, src, bytes);
  else cs3x3::cp_async4(dst, src, bytes);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS) cs_conv3x3_im2col_gemm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ext, const bf16* __restrict__ weq,
    const bf16* __restrict__ wpo, const bf16* __restrict__ beq, const bf16* __restrict__ bpo,
    bf16* __restrict__ out, Geom g) {
  constexpr int LPR = C::THREADS / C::BM;  // threads a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const int kw = g.tpw * g.bks;
  bf16* stage_a = reinterpret_cast<bf16*>(smem);                   // [STAGES][BM][apitch]
  bf16* stage_b = stage_a + (long long)STAGES * C::BM * g.apitch;  // [STAGES][kw][bpitch]
  const int n = g.n, cin = g.cin, cout = g.cout;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the block's tile: N tiles fastest, so the blocks of one M tile run together
  const int bid = blockIdx.x;
  const int nti = bid % g.nt, mti = bid / g.nt;
  const int grp = mti < g.mt_eq ? 0 : 1;
  const long long m0 = (long long)(grp ? mti - g.mt_eq : mti) * C::BM;
  const long long mg = grp ? g.m_po : g.m_eq;
  const int nf = grp ? 2 : 4, f0 = grp ? 4 : 0;
  const int n0 = nti * C::BN;
  const bf16* __restrict__ w = grp ? wpo : weq;
  const bf16* __restrict__ bias = grp ? bpo : beq;

  // this thread's row of the tile (LPR threads a row): its pixel, once
  const int r = tid / LPR, lr = tid % LPR;
  const long long m = m0 + r;
  const bool valid = m < mg;
  int i = 0, j = 0;
  long long face = 0;
  if (valid) {
    const long long per_item = (long long)nf * n * n;
    const long long bimg = m / per_item;
    const long long rem = m - bimg * per_item;
    const int fl = (int)(rem / ((long long)n * n));
    const int pix = (int)(rem - (long long)fl * n * n);
    i = pix / n;
    j = pix - i * n;
    face = bimg * 6 + f0 + fl;
  }
  const bf16* xf = x + face * n * n * cin;
  const bf16* ef = ext + face * 4 * (n + 2) * cin;

  // window q: taps t0 .. t0 + nt_w - 1, channels c0 .. c0 + wd of each
  auto window = [&](int q, int& t0, int& ntw, int& c0, int& wd) {
    const int tg = q / g.nsl;
    t0 = tg * g.tpw;
    ntw = min(g.tpw, 9 - t0);
    c0 = (q - tg * g.nsl) * g.bks;
    wd = min(g.bks, g.kp - c0);
  };
  auto load_window = [&](int q, int st) {
    int t0, ntw, c0, wd;
    window(q, t0, ntw, c0, wd);
    const int avail = 2 * max(0, min(wd, cin - c0));  // bytes of a tap's run
    bf16* arow = stage_a + ((long long)st * C::BM + r) * g.apitch;
    bf16* bst = stage_b + (long long)st * kw * g.bpitch;
    for (int tt = 0; tt < ntw; ++tt) {
      const int t = t0 + tt, dy = t / 3, dx = t - dy * 3;
      // A: this thread's row, the (pixel, tap) cell's channels c0 .. c0 + wd
      bf16* adst = arow + tt * wd;
      const bf16* asrc = valid ? cell_ptr(xf, ef, n, cin, i + dy, j + dx) + c0 : x;
      if (g.ga > 2) {
        for (int u = lr; u < 2 * wd / g.ga; u += LPR) {
          const int off = u * g.ga;
          const int bytes = valid && avail > off ? g.ga : 0;
          copy_unit(adst + off / 2, bytes ? asrc + off / 2 : x, g.ga, bytes);
        }
      } else {
        for (int e = lr; e < wd; e += LPR)
          adst[e] = valid && 2 * e < avail ? asrc[e] : __float2bfloat16_rn(0.f);
      }
      // B: weight rows t * Cin + c0 + kk, columns n0 .. n0 + BN
      bf16* bdst = bst + (long long)tt * wd * g.bpitch;
      const bf16* bsrc = w + ((long long)t * cin + c0) * cout + n0;
      if (g.gb > 2) {
        const int ub = 1 << g.ub_log2, eu = g.gb / 2;
        for (int idx = tid; idx < wd * ub; idx += C::THREADS) {
          const int kk = idx >> g.ub_log2, uu = idx & (ub - 1);
          const int bytes = (c0 + kk < cin && n0 + uu * eu < cout) ? g.gb : 0;
          copy_unit(bdst + kk * g.bpitch + uu * eu,
                    bytes ? bsrc + (long long)kk * cout + uu * eu : w, g.gb, bytes);
        }
      } else {
        for (int idx = tid; idx < wd * C::BN; idx += C::THREADS) {
          const int kk = idx / C::BN, cc = idx - kk * C::BN;
          bdst[kk * g.bpitch + cc] = (c0 + kk < cin && n0 + cc < cout)
                                         ? bsrc[(long long)kk * cout + cc]
                                         : __float2bfloat16_rn(0.f);
        }
      }
    }
  };

  float acc[C::TM][C::TN][4];
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int b = 0; b < C::TN; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
  const int kgi = warp / (C::WM * C::WN), wt = warp % (C::WM * C::WN);
  const int wm0 = (wt % C::WM) * C::TM * 16, wn0 = (wt / C::WM) * C::TN * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < g.nwin) load_window(s, s);
    cs3x3::cp_async_commit();
  }
  for (int q = 0; q < g.nwin; ++q) {
    cp_async_wait_stages();
    __syncthreads();  // window q has landed; window q - 1's stage is free
    if (q + STAGES - 1 < g.nwin) load_window(q + STAGES - 1, (q + STAGES - 1) % STAGES);
    cs3x3::cp_async_commit();
    int t0, ntw, c0, wd;
    window(q, t0, ntw, c0, wd);
    const int st = q % STAGES, nks = ntw * wd / 16;
    const bf16* as = stage_a + (long long)st * C::BM * g.apitch + (wm0 + (lane & 15)) * g.apitch +
                     (lane >> 4) * 8;
    const bf16* bs = stage_b + (long long)st * kw * g.bpitch +
                     ((lane & 7) + ((lane >> 3) & 1) * 8) * g.bpitch + wn0 + (lane >> 4) * 8;
    // this warp group's k steps kgi, kgi + KG, ...: the next one's fragments
    // are loaded before this one's products (two register sets, named)
    uint32_t af0[C::TM][4], bf0[C::TN][2], af1[C::TM][4], bf1[C::TN][2];
    auto frags = [&](int s, uint32_t (&af)[C::TM][4], uint32_t (&bf)[C::TN][2]) {
#pragma unroll
      for (int a = 0; a < C::TM; ++a) cs3x3::ldsm_x4(af[a], as + a * 16 * g.apitch + s * 16);
#pragma unroll
      for (int b = 0; b < C::TN; b += 2) {
        uint32_t t4[4];
        cs3x3::ldsm_x4_t(t4, bs + s * 16 * g.bpitch + b * 8);
        bf[b][0] = t4[0];
        bf[b][1] = t4[1];
        bf[b + 1][0] = t4[2];
        bf[b + 1][1] = t4[3];
      }
    };
    auto mmas = [&](const uint32_t (&af)[C::TM][4], const uint32_t (&bf)[C::TN][2]) {
#pragma unroll
      for (int a = 0; a < C::TM; ++a)
#pragma unroll
        for (int b = 0; b < C::TN; ++b) cs3x3::mma_bf16(acc[a][b], af[a], bf[b][0], bf[b][1]);
    };
    if (kgi < nks) frags(kgi, af0, bf0);
    for (int s = kgi; s < nks; s += 2 * C::KG) {
      if (s + C::KG < nks) frags(s + C::KG, af1, bf1);
      mmas(af0, bf0);
      if (s + C::KG >= nks) break;
      if (s + 2 * C::KG < nks) frags(s + 2 * C::KG, af0, bf0);
      mmas(af1, bf1);
    }
  }
  cs3x3::cp_async_wait_all();
  __syncthreads();  // every product done: the stages hold the epilogue now

  // the warp groups' partial sums, added in group order by group 0
  float* red = reinterpret_cast<float*>(smem);  // [KG - 1][BM][BN]
  bf16* ot = reinterpret_cast<bf16*>(red + (long long)(C::KG - 1) * C::BM * C::BN);
  const int gid = lane >> 2, tig = lane & 3;
  if (C::KG > 1) {
    if (kgi > 0) {
      float* rp = red + (long long)(kgi - 1) * C::BM * C::BN;
#pragma unroll
      for (int a = 0; a < C::TM; ++a)
#pragma unroll
        for (int b = 0; b < C::TN; ++b)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(rp + (wm0 + a * 16 + gid + hh * 8) * C::BN + wn0 +
                                       b * 8 + tig * 2) =
                make_float2(acc[a][b][2 * hh], acc[a][b][2 * hh + 1]);
    }
    __syncthreads();
  }
  if (kgi == 0) {
    // bias and one rounding into the tile [BM][bpitch], two bf16 a 32-bit store
#pragma unroll
    for (int b = 0; b < C::TN; ++b) {
      const int cc = wn0 + b * 8 + tig * 2;
      const float b0 = n0 + cc < cout ? __bfloat162float(bias[n0 + cc]) : 0.f;
      const float b1 = n0 + cc + 1 < cout ? __bfloat162float(bias[n0 + cc + 1]) : 0.f;
#pragma unroll
      for (int a = 0; a < C::TM; ++a)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = wm0 + a * 16 + gid + hh * 8;
          float v0 = acc[a][b][2 * hh], v1 = acc[a][b][2 * hh + 1];
#pragma unroll
          for (int k = 0; k < C::KG - 1; ++k) {
            const float2 p = *reinterpret_cast<const float2*>(
                red + ((long long)k * C::BM + rr) * C::BN + cc);
            v0 += p.x;
            v1 += p.y;
          }
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(v0 + b0);
          v.y = __float2bfloat16_rn(v1 + b1);
          *reinterpret_cast<__nv_bfloat162*>(ot + rr * g.bpitch + cc) = v;
        }
    }
  }
  __syncthreads();
  if (!valid) return;
  const int ncols = min(C::BN, cout - n0);
  bf16* orow = out + ((face * n + i) * (long long)n + j) * cout + n0;
  const bf16* trow = ot + r * g.bpitch;
  if (g.go) {
    for (int u = lr; u < ncols / 8; u += LPR)
      *reinterpret_cast<uint4*>(orow + u * 8) = *reinterpret_cast<const uint4*>(trow + u * 8);
  } else {
    for (int e = lr; e < ncols; e += LPR) orow[e] = trow[e];
  }
}

// Fills g for configuration cfg (Cfg0..Cfg3), window slices bks and taps
// tpw; false on what the kernel cannot take.
inline bool make_geom(Geom& g, int batch, int n, int cin, int cout, int cfg, int bks, int tpw,
                      int ga, int gb, int go) {
  static const int bms[4] = {Cfg0::BM, Cfg1::BM, Cfg2::BM, Cfg3::BM};
  static const int bns[4] = {Cfg0::BN, Cfg1::BN, Cfg2::BN, Cfg3::BN};
  static const int ths[4] = {Cfg0::THREADS, Cfg1::THREADS, Cfg2::THREADS, Cfg3::THREADS};
  static const int kgs[4] = {Cfg0::KG, Cfg1::KG, Cfg2::KG, Cfg3::KG};
  if (cfg < 0 || cfg > 3 || batch < 1 || n < 1 || cin < 1 || cout < 1) return false;
  g.batch = batch;
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.bm = bms[cfg];
  g.bn = bns[cfg];
  g.threads = ths[cfg];
  g.kg = kgs[cfg];
  g.kp = (cin + 15) / 16 * 16;
  // whole taps (bks = kp) or slices of one tap, 16-channel multiples
  if (bks < 16 || bks % 16 || bks > g.kp || tpw < 1 || tpw > 9 || (tpw > 1 && bks != g.kp))
    return false;
  g.bks = bks;
  g.tpw = tpw;
  g.nsl = (g.kp + bks - 1) / bks;
  g.nwin = (9 + tpw - 1) / tpw * g.nsl;
  // a granule of 2 (plain loads) always works; a larger one must divide
  // the row's bytes (the caller checks the addresses)
  if ((ga != 2 && ga != 4 && ga != 8 && ga != 16) || (gb != 2 && gb != 4 && gb != 8 && gb != 16))
    return false;
  if (ga > granule(2 * cin) || gb > granule(2 * cout)) return false;
  if (go && cout % 8) return false;
  g.ga = ga;
  g.gb = gb;
  g.go = go;
  g.apitch = tpw * bks + PADE;
  g.bpitch = g.bn + PADE;
  g.m_eq = (long long)batch * 4 * n * n;
  g.m_po = (long long)batch * 2 * n * n;
  g.mt_eq = (int)((g.m_eq + g.bm - 1) / g.bm);
  g.mt_po = (int)((g.m_po + g.bm - 1) / g.bm);
  g.nt = (cout + g.bn - 1) / g.bn;
  const int ub = gb > 2 ? 2 * g.bn / gb : 1;
  g.ub_log2 = 0;
  while ((1 << g.ub_log2) < ub) ++g.ub_log2;
  return (long long)(g.mt_eq + g.mt_po) * g.nt < (1LL << 31);
}

template <class C>
int launch_gemm(int device, const void* x, const void* ext, const void* weq, const void* wpo,
                const void* beq, const void* bpo, void* out, const Geom& g, size_t smem,
                void* stream) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cs_conv3x3_im2col_gemm_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((long long)(g.mt_eq + g.mt_po) * g.nt);
  cs_conv3x3_im2col_gemm_kernel<C><<<blocks, C::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ext), static_cast<const bf16*>(weq),
      static_cast<const bf16*>(wpo), static_cast<const bf16*>(beq),
      static_cast<const bf16*>(bpo), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

}  // namespace im2


// ---- kn2row on tiles of output rows (cs_conv3x3_npack_tiles_kernel) ------
//
// The function of cs_conv3x3_npack_kernel in the same formulation, tiled
// for this card.  What held that kernel back: for each of a block's output
// rows and each dy one product over one padded row (n + 2 <= 64 cells: 1-4
// M tiles, almost no products in flight), stored to a shared f32 buffer,
// two barriers and a pass of shifted adds into shared f32 output sums: 6 h
// barriers and 3 h shared round trips a block; the dy slice of the weights
// and the padded rows staged by plain loads, no copy overlapping a
// product; fragments by 32-bit loads; the f32 output sums in shared memory
// (h n Cout 4 bytes), which kept n = 48 with 128 -> 128 channels out.
//
// Here a block takes h output rows r0 .. r0 + h - 1 of one face and bn
// output channels c0 .. c0 + bn - 1 (bn a multiple of 8;
// ops/conv_variants.py::npack_plan picks h and bn).  It stages the tile's
// h + 2 padded rows, all of Cin, as one run of cells (cell q = padded row
// r0 + q / (n + 2), column q % (n + 2); kp = Cin rounded up to 16, rows
// padded by 8 elements), and the dy slice of the taps for its channels,
// (kp, 3 sw) k-major: the three dx slices' sw columns side by side (sw =
// bn, or Cout where Cout < bn), all by cp.async (16, 8 or 4 bytes as
// Cin's and Cout's bytes allow, else plain loads; zero fill past Cin, Cout and the face by the copies' source size).
// Two weight buffers where shared memory allows: dy 0's and dy 1's slices
// are copied with the cells, dy 2's while dy 0's products are summed.
// Per dy one product over all the tile's cells at once: M = h (n + 2) rows
// (cells dy (n + 2) .. on, so M tiles run across padded rows), N = 3 sw
// rounded up to 8, K = kp; warps take chunks of one M tile x 6 n8 tiles
// (the last M tile's rows past the cells read the last cell; its sums are
// not read), fragments by
// ldmatrix (B by .trans), the next k step's loaded before this one's
// mma.sync m16n8k16 (bf16, f32 sums).  The chunk's sums go to a shared f32
// product buffer once; after one barrier each thread adds, for the output
// units it holds in registers (8 channels of one pixel, at most 4 a
// thread), product rows i (n + 2) + j + dx of the dx slice, dx = 0, 1, 2:
// one shared exchange and two barriers a dy, in the fixed order dy then
// dx, so launches agree bit for bit.  Epilogue: bias, one rounding,
// 16-byte stores (Cout % 8 == 0), else 2-byte ones.
//
// What bounds it: not the bytes or the operations (kn2row does (n + 2)/n
// of the conv's products, well under a microsecond a conv at 989 TFLOP/s)
// but the chain of each block: the copies' latency, then three rounds of
// products, a shared exchange and two barriers.  The exchange of the f32
// product through shared memory is the largest phase (at (48, 32 -> 32)
// batch 16 it stores about 270 MB a conv to shared memory against 29 MB of
// HBM traffic); tools/npack_phases.py times the kernel with each phase
// compiled out.
namespace kn2 {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TM = 1;    // M tiles (16 cells) of a warp's chunk
constexpr int TN = 6;    // n8 tiles of a warp's chunk: 48 product columns
constexpr int OU = 4;    // output units (8 channels of a pixel) a thread holds at most
constexpr int PADE = 8;  // bf16 elements after each staged cell (and some weight rows)
constexpr int PADF = 8;  // floats after each product row

struct Geom {
  int n, cin, cout;
  int h, bn, wbufs;  // output rows and channels a tile; weight buffers (1 or 2)
  int sw, nw;        // channels of a dx run (bn; Cout where Cout < bn); 3 sw rounded up to 8
  int kp, apitch;    // Cin rounded up to 16; staged cell pitch kp + PADE
  int wpitch;        // staged weight row pitch: nw, plus PADE where nw / 8 is even
  int ppitch;        // product row pitch nw + PADF (floats)
  int mt;            // M tiles of a product: h (n + 2) rows over 16
  int cells;         // staged cells: (h + 2)(n + 2)
  int rt, ct;        // row tiles, channel tiles
  int ga, gb, go;    // copy granules (bytes) of cells and weight runs; 16-byte stores
};

inline size_t smem_bytes(const Geom& g) {
  return 2 * ((size_t)g.cells * g.apitch + (size_t)g.wbufs * g.kp * g.wpitch) +
         4 * (size_t)16 * g.mt * g.ppitch;
}

inline bool make_geom(Geom& g, int n, int cin, int cout, int h, int bn, int wbufs, int ga,
                      int gb, int go) {
  if (n < 1 || cin < 1 || cout < 1 || h < 1 || h > n || bn < 8 || bn % 8 || bn > 1024 ||
      (wbufs != 1 && wbufs != 2))
    return false;
  if ((long long)h * n * (bn / 8) > (long long)OU * THREADS) return false;
  if ((ga != 2 && ga != 4 && ga != 8 && ga != 16) || (gb != 2 && gb != 4 && gb != 8 && gb != 16))
    return false;
  if (ga > im2::granule(2 * cin) || gb > im2::granule(2 * cout)) return false;
  if (go && cout % 8) return false;
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.h = h;
  g.bn = bn;
  g.wbufs = wbufs;
  g.ga = ga;
  g.gb = gb;
  g.go = go;
  g.kp = round_up(cin, 16);
  g.apitch = g.kp + PADE;
  // a tile narrower than bn holds its three runs side by side, so that
  // Cout < 8 stages no more weights than the first design; a weight row of
  // an odd count of 16 bytes already puts ldmatrix's eight rows in eight
  // distinct bank groups, an even count takes PADE more
  g.sw = cout < bn ? cout : bn;
  g.nw = round_up(3 * g.sw, 8);
  g.wpitch = g.nw + ((g.nw / 8) % 2 ? 0 : PADE);
  g.ppitch = g.nw + PADF;
  g.mt = (h * (n + 2) + 15) / 16;
  g.cells = (h + 2) * (n + 2);
  g.rt = (n + h - 1) / h;
  g.ct = (cout + bn - 1) / bn;
  return (long long)g.rt * g.ct < (1LL << 31);
}

// A narrow instance: runs of a width that is not a multiple of 4 (read
// by plain loads) or an odd count of n8 tiles (the last loaded alone).
// Tiles of bn >= 16 channels never are, and keep the wide instance's code.
inline bool narrow(const Geom& g) { return g.sw % 4 || (g.nw / 8) % 2; }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// two blocks an SM: at most 128 registers a thread
template <bool NARROW>
__global__ void __launch_bounds__(THREADS, 2) cs_conv3x3_npack_tiles_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ext, const bf16* __restrict__ teq,
    const bf16* __restrict__ tpo, const bf16* __restrict__ beq, const bf16* __restrict__ bpo,
    bf16* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* T = reinterpret_cast<bf16*>(smem);                                // [cells][apitch]
  bf16* W = T + (long long)g.cells * g.apitch;                            // [wbufs][kp][wpitch]
  float* Pf = reinterpret_cast<float*>(W + (long long)g.wbufs * g.kp * g.wpitch);  // [16 mt][ppitch]
  const int n = g.n, cin = g.cin, cout = g.cout, np2 = n + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rti = blockIdx.x / g.ct, cti = blockIdx.x - rti * g.ct;
  const int r0 = rti * g.h, c0 = cti * g.bn;
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const bf16* __restrict__ taps = f < 4 ? teq : tpo;
  const bf16* __restrict__ bias = f < 4 ? beq : bpo;
  const bf16* xf = x + face * n * n * cin;
  const bf16* ef = ext + face * 4 * np2 * cin;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the tile's padded rows, all of Cin, cell q at T[q]; zero past the face
  // and past Cin
  {
    const int upc = 2 * g.kp / g.ga;  // copy units a cell
    for (int idx = tid; idx < g.cells * upc; idx += THREADS) {
      const int q = idx / upc, u = idx - q * upc;
      const int pr = q / np2, pc = q - pr * np2, p = r0 + pr;
      const int off = u * g.ga / 2;  // elements into the cell
      const bool ok = p <= n + 1 && off < cin;
      bf16* tdst = T + (long long)q * g.apitch + off;
      const bf16* tsrc = ok ? cell_ptr(xf, ef, n, cin, p, pc) + off : x;
      if (g.ga > 2) {
        im2::copy_unit(tdst, tsrc, g.ga, ok ? g.ga : 0);
      } else {
        *tdst = ok ? *tsrc : zero;
      }
    }
  }
  // the dy slice of the taps for channels c0 .. c0 + sw - 1 into buffer
  // buf: W[k][dx sw + c] = taps[k][(3 dy + dx) Cout + c0 + c]; zero past Cin
  // and Cout
  auto stage_weights = [&](int dy, int buf) {
    bf16* Wb = W + (long long)buf * g.kp * g.wpitch;
    const int eu = g.gb / 2, upr = g.sw / eu;  // elements a unit, units a dx run
    for (int idx = tid; idx < g.kp * 3 * upr; idx += THREADS) {
      const int k = idx / (3 * upr), rem = idx - k * 3 * upr;
      const int dx = rem / upr, co = c0 + (rem - dx * upr) * eu;
      const bool ok = k < cin && co < cout;
      bf16* wdst = Wb + (long long)k * g.wpitch + dx * g.sw + (co - c0);
      const bf16* wsrc = ok ? taps + (long long)k * 9 * cout + (3 * dy + dx) * cout + co : taps;
      if (g.gb > 2) {
        im2::copy_unit(wdst, wsrc, g.gb, ok ? g.gb : 0);
      } else {
        *wdst = ok ? *wsrc : zero;
      }
    }
  };
  stage_weights(0, 0);
  cs3x3::cp_async_commit();
  if (g.wbufs > 1) {
    stage_weights(1, 1);
    cs3x3::cp_async_commit();
  }

  // this thread's output units: u = (i n + j) (bn / 8) + cg, 8 channels
  // each; poff: the product offset of its dx = 0 run (-1: no unit)
  const int bu = (g.sw + 7) / 8, rows = min(g.h, n - r0), units = rows * n * bu;
  float o[OU][8];
  int poff[OU];
#pragma unroll
  for (int v = 0; v < OU; ++v) {
    const int u = tid + v * THREADS, pix = u / bu, i = pix / n, j = pix - i * n;
    poff[v] = u < units ? (i * np2 + j) * g.ppitch + (u - pix * bu) * 8 : -1;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[v][e] = 0.f;
  }

  const int nts = g.nw / 8, nc = (nts + TN - 1) / TN;  // n8 tiles of a product, chunks
  const int chunks = (g.mt + TM - 1) / TM * nc;
  for (int dy = 0; dy < 3; ++dy) {
    if (g.wbufs > 1 && dy < 2) cp_async_wait_one();
    else cs3x3::cp_async_wait_all();
    __syncthreads();  // dy's weights (and the cells) have landed; Pf is free
    const int buf = g.wbufs > 1 ? dy % 2 : 0;
    const bf16* Wb = W + (long long)buf * g.kp * g.wpitch;
    // the product of cells dy (n + 2) + m, m < 16 mt, with the slice
    for (int c = warp; c < chunks; c += NWARPS) {
      const int mc = c / nc, nt0 = (c - mc * nc) * TN, mt0 = mc * TM;
      const int tms = min(TM, g.mt - mt0), tns = min(TN, nts - nt0);
      float acc[TM][TN][4];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
      // A rows past the staged cells (the last M tile's padding, whose
      // sums no output reads) read the last cell
      const bf16* as[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a)
        as[a] = T + (long long)min(dy * np2 + (mt0 + a) * 16 + (lane & 15), g.cells - 1) *
                        g.apitch + (lane >> 4) * 8;
      const bf16* bs = Wb + (long long)((lane & 7) + ((lane >> 3) & 1) * 8) * g.wpitch +
                       nt0 * 8 + (lane >> 4) * 8;
      uint32_t af0[TM][4], bf0[TN][2], af1[TM][4], bf1[TN][2];
      auto frags = [&](int s, uint32_t (&af)[TM][4], uint32_t (&bfr)[TN][2]) {
#pragma unroll
        for (int a = 0; a < TM; ++a)
          if (a < tms) cs3x3::ldsm_x4(af[a], as[a] + s * 16);
        // pairs of n8 tiles; an odd last one alone (a weight row may end
        // with it)
#pragma unroll
        for (int b = 0; b < TN; b += 2) {
          if (b >= tns) break;
          if (!NARROW || b + 1 < tns) {
            uint32_t t4[4];
            cs3x3::ldsm_x4_t(t4, bs + (long long)s * 16 * g.wpitch + b * 8);
            bfr[b][0] = t4[0];
            bfr[b][1] = t4[1];
            bfr[b + 1][0] = t4[2];
            bfr[b + 1][1] = t4[3];
          } else {
            cs3x3::ldsm_x2_t(bfr[b], bs + (long long)s * 16 * g.wpitch + b * 8);
          }
        }
      };
      auto mmas = [&](const uint32_t (&af)[TM][4], const uint32_t (&bfr)[TN][2]) {
#pragma unroll
        for (int a = 0; a < TM; ++a) {
          if (a >= tms) continue;
#pragma unroll
          for (int b = 0; b < TN; ++b)
            if (b < tns) cs3x3::mma_bf16(acc[a][b], af[a], bfr[b][0], bfr[b][1]);
        }
      };
      const int ks = g.kp / 16;
      frags(0, af0, bf0);
      for (int s = 0; s < ks; s += 2) {
        if (s + 1 < ks) frags(s + 1, af1, bf1);
        mmas(af0, bf0);
        if (s + 1 >= ks) break;
        if (s + 2 < ks) frags(s + 2, af0, bf0);
        mmas(af1, bf1);
      }
      // the chunk's sums to the product buffer, once
      const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        if (a >= tms) continue;
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          if (b >= tns) break;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(
                Pf + (long long)((mt0 + a) * 16 + gid + hh * 8) * g.ppitch + (nt0 + b) * 8 +
                tig * 2) = make_float2(acc[a][b][2 * hh], acc[a][b][2 * hh + 1]);
        }
      }
    }
    __syncthreads();  // the product is complete; this dy's weight buffer is free
    if (dy + g.wbufs < 3) {
      stage_weights(dy + g.wbufs, buf);
      cs3x3::cp_async_commit();
    }
    // the kn2row shift: output (i, j) takes product rows i (n + 2) + j + dx
    // of the dx slice, dx = 0, 1, 2 (16-byte loads but in the narrow
    // instance; the sums of channels past Cout are never stored)
#pragma unroll
    for (int v = 0; v < OU; ++v) {
      if (poff[v] >= 0) {
        const float* pp = Pf + poff[v];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* q = pp + dx * (g.ppitch + g.sw);
          const float4 lo = NARROW ? make_float4(q[0], q[1], q[2], q[3])
                                   : *reinterpret_cast<const float4*>(q);
          const float4 hi = NARROW ? make_float4(q[4], q[5], q[6], q[7])
                                   : *reinterpret_cast<const float4*>(q + 4);
          o[v][0] += lo.x;
          o[v][1] += lo.y;
          o[v][2] += lo.z;
          o[v][3] += lo.w;
          o[v][4] += hi.x;
          o[v][5] += hi.y;
          o[v][6] += hi.z;
          o[v][7] += hi.w;
        }
      }
    }
  }

  cs3x3::cp_async_wait_all();  // nothing is left in flight when the block ends
  // bias, one rounding, 16-byte stores
#pragma unroll
  for (int v = 0; v < OU; ++v) {
    const int u = tid + v * THREADS;
    if (u >= units) continue;
    const int pix = u / bu, cg = u - pix * bu, i = pix / n, j = pix - i * n;
    const int co = c0 + cg * 8;
    if (co >= cout) continue;
    bf16* op = out + ((face * n + r0 + i) * (long long)n + j) * cout + co;
    __align__(16) bf16 r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      r[e] = __float2bfloat16_rn(o[v][e] + (co + e < cout ? __bfloat162float(bias[co + e]) : 0.f));
    if (g.go && co + 8 <= cout) {
      *reinterpret_cast<uint4*>(op) = *reinterpret_cast<const uint4*>(r);
    } else {
      for (int e = 0; e < 8 && co + e < cout; ++e) op[e] = r[e];
    }
  }
}

}  // namespace kn2

// Fills g and the shared memory a block needs; false on sizes the kernels
// cannot take.
bool make_geom(MmaGeom& g, int n, int cin, int cout, int h, int vec, int wvec, bool im2col,
               size_t* smem) {
  if (n < 1 || cin < 1 || cout < 1 || h < 1 || h > n) return false;
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.h = h;
  g.kp = round_up(cin, 16);
  g.kps = g.kp + PAD;
  g.mp = round_up(n + 2, 16);
  g.nb = round_up(3 * cout, 8);
  g.pps = g.nb + 8;
  g.m = round_up(h * n, 16);
  g.kcs = 9 * g.kp + PAD;
  g.co8 = round_up(cout, 8);
  g.vec = vec && cin % 8 == 0;
  g.wvec = wvec && cout % 8 == 0;
  const size_t t = sizeof(bf16) * (size_t)(h + 2) * g.mp * g.kps;
  if (im2col) {
    if ((g.m / 16) * (g.co8 / 8) > NWARPS * IM_TPW) return false;
    *smem = t + sizeof(bf16) * ((size_t)g.m * g.kcs + (size_t)g.co8 * g.kps);
  } else {
    *smem = t + sizeof(bf16) * (size_t)g.nb * g.kps +
            sizeof(float) * ((size_t)g.mp * g.pps + (size_t)h * n * cout);
  }
  return true;
}

template <typename Kernel>
int launch(Kernel kernel, int device, const void* x, const void* ext, const void* weq,
           const void* wpo, const void* beq, const void* bpo, void* out, int batch,
           const MmaGeom& g, size_t smem, void* stream) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((g.n + g.h - 1) / g.h, 6, batch);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ext), static_cast<const bf16*>(weq),
      static_cast<const bf16*>(wpo), static_cast<const bf16*>(beq),
      static_cast<const bf16*>(bpo), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16, the only type these kernels take.  device: the
// current device, which the stream belongs to.  taps (Cin, 9*Cout) per
// weight group; h: output rows per block; vec: 1 if x and ext are 16-byte
// aligned (16-byte staging copies where Cin % 8 == 0); wvec: 1 if both
// weight groups are (16-byte weight loads where Cout % 8 == 0).  Returns a
// cudaError_t (0 = success).
int cs_conv3x3_npack_launch(int dtype, int device, const void* x, const void* ext,
                            const void* teq, const void* tpo, const void* beq, const void* bpo,
                            void* out, int batch, int n, int cin, int cout, int h, int vec,
                            int wvec, void* stream) {
  MmaGeom g;
  size_t smem = 0;
  if (dtype != 1 || device < 0 || batch < 1 || batch > 65535 ||
      !make_geom(g, n, cin, cout, h, vec, wvec, false, &smem))
    return cudaErrorInvalidValue;
  return launch(cs_conv3x3_npack_kernel, device, x, ext, teq, tpo, beq, bpo, out, batch, g,
                smem, stream);
}

// As cs_conv3x3_npack_launch, with weights (9*Cin, Cout) per group; at most
// 64 accumulator tiles of 16 x 8 per block (h * n * Cout <= 8192, rounded).
int cs_conv3x3_im2col_launch(int dtype, int device, const void* x, const void* ext,
                             const void* weq, const void* wpo, const void* beq, const void* bpo,
                             void* out, int batch, int n, int cin, int cout, int h, int vec,
                             int wvec, void* stream) {
  MmaGeom g;
  size_t smem = 0;
  if (dtype != 1 || device < 0 || batch < 1 || batch > 65535 ||
      !make_geom(g, n, cin, cout, h, vec, wvec, true, &smem))
    return cudaErrorInvalidValue;
  return launch(cs_conv3x3_im2col_kernel, device, x, ext, weq, wpo, beq, bpo, out, batch, g,
                smem, stream);
}

// #13: im2col as one GEMM per weight group (cs_conv3x3_im2col_gemm_kernel),
// weights (9*Cin, Cout) per group.  cfg: the tile configuration (0: 64 x 32
// pixels x channels, 8 warps in 2 groups along K; 1: 64 x 64, the same; 2:
// 128 x 32, 8 warps; 3: 128 x 64, 8 warps); a K window is tpw whole taps
// (bks = Cin rounded up to 16) or one bks-wide slice of a tap (tpw = 1);
// ga / gb: the copy granule in bytes of the column gather (x and ext) and
// of the weight rows (16, 8, 4: the largest dividing Cin's / Cout's bytes
// and the addresses; 2: plain loads); go: 16-byte output stores (Cout % 8
// == 0).  smem must equal the bytes the kernel computes
// (ops/conv_variants.py::im2col_plan).
int cs_conv3x3_im2col_gemm_launch(int dtype, int device, const void* x, const void* ext,
                                  const void* weq, const void* wpo, const void* beq,
                                  const void* bpo, void* out, int batch, int n, int cin,
                                  int cout, int cfg, int bks, int tpw, int ga, int gb, int go,
                                  int smem, void* stream) {
  im2::Geom g;
  if (dtype != 1 || device < 0 ||
      !im2::make_geom(g, batch, n, cin, cout, cfg, bks, tpw, ga, gb, go))
    return cudaErrorInvalidValue;
  const size_t bytes = im2::smem_bytes(g);
  if ((size_t)smem != bytes) return cudaErrorInvalidValue;
#define CS_IM2COL_GEMM(C) \
  im2::launch_gemm<C>(device, x, ext, weq, wpo, beq, bpo, out, g, bytes, stream)
  switch (cfg) {
    case 0: return CS_IM2COL_GEMM(im2::Cfg0);
    case 1: return CS_IM2COL_GEMM(im2::Cfg1);
    case 2: return CS_IM2COL_GEMM(im2::Cfg2);
    default: return CS_IM2COL_GEMM(im2::Cfg3);
  }
#undef CS_IM2COL_GEMM
}

// #3: kn2row on tiles of h output rows x bn output channels
// (cs_conv3x3_npack_tiles_kernel), taps (Cin, 9*Cout) per weight group.
// wbufs: weight buffers (2: the next dy slice copied while one multiplies;
// 1: copied during the shifted adds); ga / gb: the copy granule in bytes of
// the staged cells (x and ext) and of the weight runs (16, 8, 4: the
// largest dividing Cin's / Cout's bytes and the addresses; 2: plain
// loads); go: 16-byte output stores (Cout % 8 == 0).  smem must equal the
// bytes the kernel computes (ops/conv_variants.py::npack_launch).
int cs_conv3x3_npack_tiles_launch(int dtype, int device, const void* x, const void* ext,
                                  const void* teq, const void* tpo, const void* beq,
                                  const void* bpo, void* out, int batch, int n, int cin,
                                  int cout, int h, int bn, int wbufs, int ga, int gb, int go,
                                  int smem, void* stream) {
  kn2::Geom g;
  if (dtype != 1 || device < 0 || batch < 1 || batch > 65535 ||
      !kn2::make_geom(g, n, cin, cout, h, bn, wbufs, ga, gb, go))
    return cudaErrorInvalidValue;
  const size_t bytes = kn2::smem_bytes(g);
  if ((size_t)smem != bytes) return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  const auto kernel = kn2::narrow(g) ? kn2::cs_conv3x3_npack_tiles_kernel<true>
                                     : kn2::cs_conv3x3_npack_tiles_kernel<false>;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)(g.rt * g.ct), 6, batch);
  kernel<<<grid, kn2::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ext), static_cast<const bf16*>(teq),
      static_cast<const bf16*>(tpo), static_cast<const bf16*>(beq),
      static_cast<const bf16*>(bpo), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

// Blocks of the kn2row tile kernel (its narrow instance where narrow != 0)
// an SM holds at once with smem bytes of dynamic shared memory (its
// registers and shared memory both counted), into *blocks.
int cs_conv3x3_npack_tiles_occupancy(int smem, int narrow, void* blocks) {
  const auto kernel = narrow ? kn2::cs_conv3x3_npack_tiles_kernel<true>
                             : kn2::cs_conv3x3_npack_tiles_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(blocks), kernel,
                                                       kn2::THREADS, smem);
}

const char* cs_conv3x3_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
