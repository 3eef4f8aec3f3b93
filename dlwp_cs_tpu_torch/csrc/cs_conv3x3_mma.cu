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
//     Cout slices;
//   * tools/kernel_variants.py::_kernel_im2col (launched by call_im2col):
//     im2col.  The 9 shifted windows of the padded face side by side in one
//     (pixels, 9*Cin) column tile, one product with the weights (9*Cin, Cout).
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
// operations (kn2row 3x that: its product covers the n+2 padded columns and
// all three dx slices), on the tensor cores by mma.sync.m16n8k16 (bf16 in,
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

const char* cs_conv3x3_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
