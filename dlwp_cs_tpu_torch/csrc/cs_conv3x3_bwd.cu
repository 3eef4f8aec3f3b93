// Backward of the fused halo-pad + 3x3 cubed-sphere convolution for Hopper
// (sm_90a): the input cotangent (dx kernel) and the weight and bias gradients
// (dw kernel) of csrc/cs_conv3x3.cu.
//
// Replaces the TPU kernels dlwp_cs_tpu/ops/pallas_conv.py::_bwd_dx_kernel
// (launched by _dx_via_kernel) and ::_bwd_dw_kernel (launched by
// _backward_all), the reference's "fused" backward.
//
// With P the (n+2) x (n+2) padded face that the forward reads (csrc/
// cs_conv3x3.cu: P[0,:] = ext S, P[n+1,:] = ext N, P[1..n,0] = ext W[1..n],
// P[1..n,n+1] = ext E[1..n], P[1..n,1..n] = x) and g the face's weight group
// (equatorial for faces 0-3, polar for 4-5):
//
// dx kernel, per (batch item, face):
//     dxp[a,b,:] = sum_{dy,dx} K_g[dy,dx] . dout[a-dy, b-dx, :]   (a, b in 0..n+1)
//   i.e. a correlation of dout, zero-extended by 2, with the spatially
//   flipped, channel-transposed taps.  The kernel writes dxp's interior as
//   dx (B,6,n,n,Cin) and its ring straight into the ghost-strip cotangent
//   d_ext (B,6,4,n+2,Cin): rows S and N whole, corners included, columns W
//   and E at rows 1..n with both ends zero (the forward reads W/E only at
//   rows 1..n).  No padded frame goes through device memory.  f32 sums, one
//   rounding to dout's dtype, as the reference stores dxp in x's dtype.
//   Its second entry point (cs_conv3x3_dx_ring_launch, the RAW instance of
//   the same kernel) replaces tools/kernel_variants.py::_dx_aligned_kernel
//   (launched by dx_aligned): the same sums, with the ring written raw,
//   [row 0, row n+1, column 0, column n+1] of dxp, corners included at both
//   ends of the W/E columns.  Every other value it writes is the default
//   instance's, bit for bit.
//
// dw kernel:
//     dK_g[dy,dx] = sum_{b, f in g, i, j} P[i+dy, j+dx, :] (x) dout[i, j, :]
//     db_g        = sum_{b, f in g, i, j} dout[i, j, :]
//   in f32.  The reference's separate W/E ghost-column input (dcols) is a
//   Mosaic workaround: here the W/E ghost columns are staged into shared
//   memory with the face, as in the forward.  Each block sums a fixed,
//   contiguous slice of the group's (batch, face, row chunk) items for one
//   (Cin, Cout) tile and writes its partial sum; the caller adds the
//   partials in a fixed order (torch.sum).  No float atomics: two identical
//   calls give bitwise-equal gradients.
//
// What bounds them on this card: each does the forward's work,
// 2*B*6*n^2*9*Cin*Cout operations, here as FMAs on the CUDA cores (no
// tensor cores in this version), and waits on the staging of its tiles
// into shared memory; at the flagship training batch (16) both keep it far
// above the least time its bytes or operations need.  The dx kernel reuses
// the forward's design (row tiles of the frame, Cout staged in chunks of 16
// as f32, 4-pixel x 8-channel register tiles; the caller caps its Cin
// slice at 64 so the staged weights stay small).  The dw kernel keeps a
// 4 (Cin) x 8 (Cout) register tile per (thread, tap) and reads one float4
// of P and two of dout from shared memory per 32 FMAs; the caller stages
// few rows per item and sizes the grid for several blocks per SM, so that
// blocks hide each other's staging.  Its partials (nsplit x 2 x 9 x Cin x
// Cout floats) stay at tens of MB at most, not one block per (batch, face).
// mma/wgmma, TMA and double-buffered staging are left for later work.
//
// Layouts (channels last, all contiguous):
//   x    (B, 6, n, n, Cin)   ext (B, 6, 4, n+2, Cin)   dout (B, 6, n, n, Cout)
//   k_*  (3, 3, Cin, Cout) HWIO
//   dx   (B, 6, n, n, Cin)   d_ext (B, 6, 4, n+2, Cin)
//   dk_part (nsplit, 2, 3, 3, Cin, Cout) f32   db_part (nsplit, 2, Cout) f32

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int PX = 4;             // dx: frame pixels per thread, along a row
constexpr int CO = 8;             // dx: Cin channels per thread
constexpr int CC = 16;            // dx: Cout channels staged per chunk
constexpr int MAX_THREADS = 256;  // dx: threads per block, all staging
constexpr int STAGE = 4;          // staging loads in flight per thread

constexpr int DW_CI = 16;  // dw: Cin channels per block (4 quads)
constexpr int DW_CO = 32;  // dw: Cout channels per block (4 octets)
constexpr int DW_THREADS = 9 * (DW_CI / 4) * (DW_CO / 8);  // tap x quad x octet

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct DxGeom {
  int n, m;     // face size; frame size m = n + 2
  int cin;      // output channels (x's)
  int cout;     // reduced channels (dout's)
  int h;        // frame rows per tile
  int cs;       // Cin channels per block (a power of two >= CO)
  int cs_log2;
  int nslices;  // Cin slices
  int ncg;      // column groups of PX pixels per frame row
  int nog;      // channel groups of CO per slice
  int wp;       // staged tile width: ncg * PX + 2 >= n + 4
  int plane;    // shared-memory pitch of one staged channel (odd)
};

// Grid (frame-row tiles * Cin slices, 6, B).  Staged tile row pr, column pc
// is dout[a0 + pr - 2, pc - 2] (zero outside the face), so frame pixel
// (a, b) reads staged rows a - a0 .. +2 and columns b .. b + 2, each with the
// flipped tap K[2 - ey, 2 - ex].
template <typename T, bool RAW>
__global__ void __launch_bounds__(MAX_THREADS) cs_conv3x3_dx_kernel(
    const T* __restrict__ dout, const T* __restrict__ keq, const T* __restrict__ kpo,
    T* __restrict__ dx, T* __restrict__ dext, DxGeom g) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                  // [CC][plane], row-major (h+2) x wp
  float* wts = smem + CC * g.plane;    // [9][CC][cs]

  const int n = g.n, m = g.m, cin = g.cin, cout = g.cout;
  const int a0 = (blockIdx.x / g.nslices) * g.h;
  const int ci0 = (blockIdx.x % g.nslices) * g.cs;
  const int f = blockIdx.y;
  const long long face = (long long)blockIdx.z * 6 + f;
  const T* __restrict__ k = f < 4 ? keq : kpo;
  const T* __restrict__ df = dout + face * n * n * cout;

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

  const int ntile = (g.h + 2) * g.wp * CC;
  const int nw = 9 * CC * g.cs;
  for (int c0 = 0; c0 < cout; c0 += CC) {
    __syncthreads();  // the previous chunk has been consumed
    // ---- zero-extended dout tile; element idx = cell * CC + cl ----
    for (int base = threadIdx.x; base < ntile; base += STAGE * MAX_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        const int cell = idx / CC;
        const int dr = a0 + cell / g.wp - 2;
        const int dc = cell % g.wp - 2;
        const int co = c0 + idx % CC;
        v[u] = (idx < ntile && co < cout && dr >= 0 && dr < n && dc >= 0 && dc < n)
                   ? to_f32(df[((long long)dr * n + dc) * cout + co])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        if (idx < ntile) tile[(idx % CC) * g.plane + idx / CC] = v[u];
      }
    }
    // ---- flipped, transposed taps: wts[(tap * CC + cl) * cs + c] =
    // K[2 - ey, 2 - ex][ci0 + c][c0 + cl] with tap = ey * 3 + ex ----
    for (int base = threadIdx.x; base < nw; base += STAGE * MAX_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * MAX_THREADS;
        const int ci = ci0 + (idx & (g.cs - 1));
        const int t = idx >> g.cs_log2;
        const int co = c0 + t % CC;
        const int tap = t / CC;
        v[u] = (idx < nw && ci < cin && co < cout)
                   ? to_f32(k[((long long)(8 - tap) * cin + ci) * cout + co])
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
      const int cmax = min(CC, cout - c0);
      for (int cl = 0; cl < cmax; ++cl) {
        const float* tp = tile + cl * g.plane + rr * g.wp + j0;
#pragma unroll
        for (int ey = 0; ey < 3; ++ey) {
          float in[PX + 2];
#pragma unroll
          for (int q = 0; q < PX + 2; ++q) in[q] = tp[ey * g.wp + q];
#pragma unroll
          for (int ex = 0; ex < 3; ++ex) {
            const float4* w4 = reinterpret_cast<const float4*>(
                wts + ((ey * 3 + ex) * CC + cl) * g.cs + c_lo);
            const float4 wa = w4[0], wb = w4[1];
            const float w[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int o = 0; o < CO; ++o) acc[p][o] = fmaf(in[p + ex], w[o], acc[p][o]);
          }
        }
      }
    }
  }
  const int a = a0 + rr;
  if (!active || a >= m) return;
  T* __restrict__ ef = dext + face * 4 * m * cin;
  const T zero = from_f32<T>(0.f);
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const int ci = ci0 + c_lo + o;
    if (ci >= cin) break;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int b = j0 + p;
      if (b >= m) continue;
      const T val = from_f32<T>(acc[p][o]);
      if (a >= 1 && a <= n && b >= 1 && b <= n) {
        dx[((face * n + a - 1) * n + b - 1) * cin + ci] = val;
      } else if (a == 0 || a == n + 1) {
        // S / N ghost row, corners included; a corner also zeroes the end
        // of its W / E strip, which the forward never reads (RAW: the
        // corner itself, as the raw ring holds it)
        ef[((long long)(a == 0 ? 0 : 1) * m + b) * cin + ci] = val;
        if (b == 0) ef[(2LL * m + a) * cin + ci] = RAW ? val : zero;
        if (b == m - 1) ef[(3LL * m + a) * cin + ci] = RAW ? val : zero;
      } else {
        ef[((long long)(b == 0 ? 2 : 3) * m + a) * cin + ci] = val;  // W / E column
      }
    }
  }
}

struct DwGeom {
  int n, cin, cout, batch;
  int rows;    // face rows staged per item
  int nchunk;  // row chunks per face
  int nsplit;  // reduction slices per face group
  int ncib;    // Cin blocks of DW_CI
};

// Grid (Cin blocks * Cout blocks, nsplit, 2 face groups); DW_THREADS threads,
// thread t owns tap t / 16, Cin quad (t % 16) / 4 and Cout octet t % 4.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS) cs_conv3x3_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ ext, const T* __restrict__ dout,
    float* __restrict__ dk_part, float* __restrict__ db_part, DwGeom g) {
  extern __shared__ __align__(16) float smem[];
  const int n = g.n, cin = g.cin, cout = g.cout, R = g.rows, pw = n + 2;
  float* ps = smem;                          // [(R+2) * pw][DW_CI]: P rows
  float* ds = smem + (R + 2) * pw * DW_CI;   // [R * n][DW_CO]: dout rows

  const int cib = blockIdx.x % g.ncib;
  const int ci0 = cib * DW_CI;
  const int co0 = (blockIdx.x / g.ncib) * DW_CO;
  const int s = blockIdx.y;
  const int grp = blockIdx.z;
  const int nf = grp == 0 ? 4 : 2;
  const int f_base = grp == 0 ? 0 : 4;
  const long long items = (long long)g.batch * nf * g.nchunk;
  const long long lo = items * s / g.nsplit;
  const long long hi = items * (s + 1) / g.nsplit;

  const int tid = threadIdx.x;
  const int tap = tid / 16;
  const int dy = tap / 3, dxo = tap % 3;
  const int ciq = (tid % 16) / 4;
  const int coo = tid % 4;
  const bool do_db = tap == 0 && ciq == 0 && cib == 0;  // 4 threads: 32 Cout

  float acc[4][8];
  float dacc[8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[a][o] = 0.f;
#pragma unroll
  for (int o = 0; o < 8; ++o) dacc[o] = 0.f;

  const int np = (R + 2) * pw * DW_CI;
  const int nd = R * n * DW_CO;
  for (long long it = lo; it < hi; ++it) {
    const int chunk = (int)(it % g.nchunk);
    const long long bf = it / g.nchunk;  // batch item * nf + face in group
    const long long face = (bf / nf) * 6 + f_base + (int)(bf % nf);
    const int r0 = chunk * R;
    const T* __restrict__ xf = x + face * n * n * cin;
    const T* __restrict__ ef = ext + face * 4 * pw * cin;
    const T* __restrict__ df = dout + face * n * n * cout;
    __syncthreads();  // the previous item has been consumed
    // ---- P rows r0 .. r0 + R + 1 (padded coordinates), zero past row n+1 ----
    for (int base = tid; base < np; base += STAGE * DW_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        const int cell = idx / DW_CI;
        const int ci = ci0 + idx % DW_CI;
        const int pc = cell % pw;
        const int q = r0 + cell / pw;
        v[u] = 0.f;
        if (idx < np && ci < cin && q <= n + 1) {
          long long off;
          if (q == 0) off = (long long)pc * cin;                          // S, corners included
          else if (q == n + 1) off = (1LL * pw + pc) * cin;               // N, corners included
          else if (pc == 0) off = (2LL * pw + q) * cin;                   // W ghost column
          else if (pc == n + 1) off = (3LL * pw + q) * cin;               // E ghost column
          else off = -1;
          v[u] = off >= 0 ? to_f32(ef[off + ci])
                          : to_f32(xf[((long long)(q - 1) * n + pc - 1) * cin + ci]);
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        if (idx < np) ps[idx] = v[u];
      }
    }
    // ---- dout rows r0 .. r0 + R - 1, zero past row n - 1 ----
    for (int base = tid; base < nd; base += STAGE * DW_THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        const int cell = idx / DW_CO;
        const int co = co0 + idx % DW_CO;
        const int r = r0 + cell / n;
        v[u] = (idx < nd && co < cout && r < n)
                   ? to_f32(df[((long long)r * n + cell % n) * cout + co])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int idx = base + u * DW_THREADS;
        if (idx < nd) ds[idx] = v[u];
      }
    }
    __syncthreads();
    const int rmax = min(R, n - r0);
    for (int r = 0; r < rmax; ++r) {
      const float* prow = ps + ((r + dy) * pw + dxo) * DW_CI + ciq * 4;
      const float* drow = ds + r * n * DW_CO + coo * 8;
      for (int j = 0; j < n; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + j * DW_CI);
        const float4 da = *reinterpret_cast<const float4*>(drow + j * DW_CO);
        const float4 db = *reinterpret_cast<const float4*>(drow + j * DW_CO + 4);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dv[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[a][o] = fmaf(pv[a], dv[o], acc[a][o]);
        if (do_db) {
#pragma unroll
          for (int o = 0; o < 8; ++o) dacc[o] += dv[o];
        }
      }
    }
  }
  // every block writes its whole tile, zeros for an empty slice
  float* __restrict__ out = dk_part + ((long long)(s * 2 + grp) * 9 + tap) * cin * cout;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ci = ci0 + ciq * 4 + a;
    if (ci >= cin) break;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int co = co0 + coo * 8 + o;
      if (co < cout) out[(long long)ci * cout + co] = acc[a][o];
    }
  }
  if (do_db) {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int co = co0 + coo * 8 + o;
      if (co < cout) db_part[((long long)s * 2 + grp) * cout + co] = dacc[o];
    }
  }
}

// Lets a kernel take up to the card's opt-in shared memory per block; set
// once per kernel and device, not at every launch.
template <int Kernel, typename T>
cudaError_t allow_large_smem(const void* fn, int device) {
  static std::atomic<unsigned long long> done{0};  // bit d: done on device d
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, bool RAW>
cudaError_t launch_dx(const void* dout, const void* keq, const void* kpo, void* dx,
                      void* dext, int batch, const DxGeom& g, size_t smem, int device,
                      cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<RAW ? 2 : 0, T>(
        (const void*)cs_conv3x3_dx_kernel<T, RAW>, device);
    if (err != cudaSuccess) return err;
  }
  const int ntiles = (g.m + g.h - 1) / g.h;
  dim3 grid(ntiles * g.nslices, 6, batch);
  cs_conv3x3_dx_kernel<T, RAW><<<grid, MAX_THREADS, smem, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(keq), static_cast<const T*>(kpo),
      static_cast<T*>(dx), static_cast<T*>(dext), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* ext, const void* dout, void* dk_part,
                      void* db_part, const DwGeom& g, int ncob, size_t smem, int device,
                      cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = allow_large_smem<1, T>((const void*)cs_conv3x3_dw_kernel<T>, device);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(g.ncib * ncob, g.nsplit, 2);
  cs_conv3x3_dw_kernel<T><<<grid, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ext), static_cast<const T*>(dout),
      static_cast<float*>(dk_part), static_cast<float*>(db_part), g);
  return cudaGetLastError();
}

// The dx kernel (RAW: the raw ring in place of d_ext).
template <bool RAW>
int dx_entry(int dtype, int device, const void* dout, const void* keq, const void* kpo,
             void* dx, void* dext, int batch, int n, int cin, int cout, int h, int cs,
             void* stream) {
  const int m = n + 2;
  if (device < 0 || device >= 64 || batch < 1 || batch > 65535 || n < 1 || cin < 1 ||
      cout < 1 || h < 1 || h > m || cs < CO || (cs & (cs - 1)) != 0)
    return cudaErrorInvalidValue;
  DxGeom g;
  g.n = n;
  g.m = m;
  g.cin = cin;
  g.cout = cout;
  g.h = h;
  g.cs = cs;
  for (g.cs_log2 = 0; (1 << g.cs_log2) < cs; ++g.cs_log2) {
  }
  g.nslices = (cin + cs - 1) / cs;
  g.ncg = (m + PX - 1) / PX;
  g.nog = cs / CO;
  g.wp = g.ncg * PX + 2;
  g.plane = (h + 2) * g.wp;
  g.plane += 1 - g.plane % 2;
  if (h * g.ncg * g.nog > MAX_THREADS) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)CC * g.plane + (size_t)9 * CC * cs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx<float, RAW>(dout, keq, kpo, dx, dext, batch, g, smem, device, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16, RAW>(dout, keq, kpo, dx, dext, batch, g, smem, device, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  device: the current device, which the
// stream belongs to.  h: frame rows per block; cs: Cin channels per block
// (a power of two >= 8).  Returns a cudaError_t (0 = success).
int cs_conv3x3_dx_launch(int dtype, int device, const void* dout, const void* keq,
                         const void* kpo, void* dx, void* dext, int batch, int n, int cin,
                         int cout, int h, int cs, void* stream) {
  return dx_entry<false>(dtype, device, dout, keq, kpo, dx, dext, batch, n, cin, cout, h, cs,
                         stream);
}

// As cs_conv3x3_dx_launch, writing the raw ring [row 0, row n+1, column 0,
// column n+1] of the (n+2)^2 cotangent into dring (B, 6, 4, n+2, Cin).
int cs_conv3x3_dx_ring_launch(int dtype, int device, const void* dout, const void* keq,
                              const void* kpo, void* dx, void* dring, int batch, int n,
                              int cin, int cout, int h, int cs, void* stream) {
  return dx_entry<true>(dtype, device, dout, keq, kpo, dx, dring, batch, n, cin, cout, h, cs,
                        stream);
}

// rows: face rows staged per item (<= n); nsplit: reduction slices per face
// group (1..65535).  dk_part and db_part are float32, written whole.
int cs_conv3x3_dw_launch(int dtype, int device, const void* x, const void* ext,
                         const void* dout, void* dk_part, void* db_part, int batch, int n,
                         int cin, int cout, int rows, int nsplit, void* stream) {
  if (device < 0 || device >= 64 || batch < 1 || n < 1 || cin < 1 || cout < 1 ||
      rows < 1 || rows > n || nsplit < 1 || nsplit > 65535)
    return cudaErrorInvalidValue;
  DwGeom g;
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.batch = batch;
  g.rows = rows;
  g.nchunk = (n + rows - 1) / rows;
  g.nsplit = nsplit;
  g.ncib = (cin + DW_CI - 1) / DW_CI;
  const int ncob = (cout + DW_CO - 1) / DW_CO;
  if ((long long)g.ncib * ncob > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(rows + 2) * (n + 2) * DW_CI + (size_t)rows * n * DW_CO);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, ext, dout, dk_part, db_part, g, ncob, smem, device, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, ext, dout, dk_part, db_part, g, ncob, smem, device, s);
  return cudaErrorInvalidValue;
}

const char* cs_conv3x3_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
