// A small implicit GEMM on the tensor cores whose A rows are pointers into
// staged cells, shared by the ring-fix kernels (cs_ring.cu) and the lowering
// probes (cs_probes.cu).
//
// out[m, n] = sum_tap sum_{k < kpt} A_m,tap[k] * B[tap * kpt + k, n]
//
// Staged cells hold the channels of one pixel (or strip position) each,
// padded with zeros to cp 16-bit units, cp an odd multiple of 8 so that the
// 8 rows of an ldmatrix fall in 8 distinct 16-byte bank groups.  Row m's
// tap t starts at unit row_off(m) + tap_off(t): a ghost strip's window of 3
// positions, a pixel's 3x3 neighbourhood in a zero-framed tile, or a plain
// row are the same walk, and nothing is copied once per tap.  A tap covers
// kpt units (the channels rounded up to one k step of 16 units); where kpt
// is more than the cell's channels the read runs into the padding or the
// next cell, whose values are finite and meet zero rows of B.
//
// bfloat16: mma.sync.m16n8k16, f32 sums carried across every tap; B (K x N,
// N contiguous, 16-bit pitch = an odd multiple of 8 units) by ldmatrix
// .trans.  float32: 3xTF32 on m16n8k8 (cs_conv3x3_tile.cuh): the staged A
// cells hold the f32 values (ldmatrix moves 16-bit units, so a row of 16
// bytes is 4 channels and the fragments come as in bfloat16), B is read by
// 32-bit loads (pitch 8 or 24 words mod 32: the 4 k rows of a fragment on
// 32 distinct banks), and both are split into TF32 hi and lo halves as
// they are loaded (a staged lo buffer would double the strips' shared
// memory; the split is 8 integer operations a register against the 6
// products it feeds); each tap's products go into fresh fragments that are
// added into the f32 sums with ordinary adds, so no tensor-core chain is
// longer than one tap's k steps.
//
// Work: items of (up to MG m16 tiles, a pair of n8 tiles), dealt round-robin
// to the block's warps; each item walks every tap and k step and hands its
// sums to the epilogue.

#pragma once

#include "cs_conv3x3_tile.cuh"

namespace tapgemm {

using cs3x3::bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int MG = 3;         // m16 tiles per work item, at most

struct Gemm {
  int rows;     // valid M rows
  int ntaps;    // K segments
  int kpt;      // 16-bit units per tap: a multiple of 16
  int npairs;   // pairs of n8 tiles (16 output channels each)
  int mg;       // m16 tiles per work item, 1..MG
  int wpitch;   // B row pitch in elements (bf16 units / f32 words)
};

// scalar staging: values a thread loads before it stores them (one load's
// latency a round, not one a value)
constexpr int GATHER = 8;

// One staged value, at 16-bit unit `unit` (a float32 value takes two).
template <typename T> __device__ __forceinline__ void put(bf16* A, int unit, T v) {
  *reinterpret_cast<T*>(A + unit) = v;
}

// ncells cells of cin channels into A at a pitch of cp units, zero past
// cin; src(c) is cell c's first channel in device memory, or nullptr for a
// zero cell; any: a valid address in device memory (the zero copies'
// source, never read).  vec: 16-byte copies by cp.async (cin a multiple of
// 16 bytes' worth, every cell address aligned), in flight until the caller
// waits (cp_async_commit / cp_async_wait_all, then a barrier); else
// ordinary loads.  Every thread of the block must call it.
template <typename T, typename Src>
__device__ __forceinline__ void stage_cells(bf16* A, int ncells, int cin, int cp, bool vec,
                                            const T* any, Src src) {
  constexpr int UPE = sizeof(T) / 2;  // 16-bit units per element
  const int cpe = cp / UPE;           // elements per cell
  // a thread keeps one vector (or element) slot k of every groups-th cell,
  // so that the index work is one division per thread and src(c) per cell
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    const int per = cpe / VE;  // vectors per cell (cp is a multiple of 8 units)
    const int groups = max(1, THREADS / per);
    for (int j = threadIdx.x; j < groups * per; j += THREADS) {
      const int c0 = j / per, k = (j - c0 * per) * VE;
      for (int c = c0; c < ncells; c += groups) {
        const T* p = src(c);
        const bool on = p != nullptr && k < cin;
        cs3x3::cp_async16(A + c * cp + k * UPE, on ? p + k : any, on ? 16 : 0);
      }
    }
  } else {
    const int groups = max(1, THREADS / cpe);
    for (int j = threadIdx.x; j < groups * cpe; j += THREADS) {
      const int c0 = j / cpe, k = j - c0 * cpe;
      for (int c = c0; c < ncells; c += GATHER * groups) {
        T v[GATHER];
#pragma unroll
        for (int w = 0; w < GATHER; ++w) {
          const T* p = c + w * groups < ncells ? src(c + w * groups) : nullptr;
          v[w] = (p != nullptr && k < cin) ? p[k] : cs3x3::from_f32<T>(0.f);
        }
#pragma unroll
        for (int w = 0; w < GATHER; ++w)
          if (c + w * groups < ncells) put(A, (c + w * groups) * cp + k * UPE, v[w]);
      }
    }
  }
}

// B rows tap * kpe + k (kpe = kpt in elements) of dn columns: row (tap, k)
// is taps(tap)[k * ld + d0 ..] for k < cin and d0 + col < d, else zero.
// vec: 16-byte copies by cp.async (ld, d0 and the row addresses 16-byte
// aligned), in flight until the caller waits; else ordinary loads.
template <typename T, typename Taps>
__device__ __forceinline__ void stage_taps(T* W, int ntaps, int kpe, int cin, int dn, int d0,
                                           int d, int ld, int wpitch, bool vec, Taps taps) {
  // a thread keeps one column slot of every groups-th row, its tap and row
  // within the tap carried from row to row
  const int rows = ntaps * kpe;
  constexpr int VE = 16 / sizeof(T);
  const int per = vec ? dn / VE : dn, step = vec ? VE : 1;
  const int groups = max(1, THREADS / per);
  for (int j = threadIdx.x; j < groups * per; j += THREADS) {
    const int r0 = j / per, col = (j - r0 * per) * step;
    int tap = r0 / kpe, k = r0 - tap * kpe;
    for (int r = r0; r < rows; r += groups) {
      const bool on = k < cin && d0 + col < d;
      T* dst = W + (long long)r * wpitch + col;
      if (vec) {
        cs3x3::cp_async16(dst, on ? taps(tap) + (long long)k * ld + d0 + col : taps(0),
                          on ? 16 : 0);
      } else {
        *dst = on ? taps(tap)[(long long)k * ld + d0 + col] : cs3x3::from_f32<T>(0.f);
      }
      for (k += groups; k >= kpe; k -= kpe) ++tap;
    }
  }
}

// The GEMM (see the header).  A: the staged cells; W: B as stage_taps left
// it.  Epi: epi(m, n, v0, v1) takes the f32 sums of row m < g.rows,
// channels n and n + 1 (n even, local to the block's slice).  bfloat16
// runs the k steps of all taps as one sequence, each step's fragments
// loaded while the step before is multiplied (two register sets, the loop
// unrolled by two so that both stay in registers); float32 keeps one set
// (two would not fit 128 registers) and a fresh sum per tap.  The code is
// run once or a few times a block, so its size is time (the instruction
// cache is cold): the epilogue is one loop over the item's sums, not an
// unrolled copy per fragment.  Every warp must call it; it does not
// synchronise the block.
template <typename T, typename RowOff, typename TapOff, typename Epi>
__device__ __forceinline__ void gemm(const Gemm& g, const bf16* A, const T* W, RowOff row_off,
                                     TapOff tap_off, const Epi& epi) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt_total = (g.rows + 15) / 16;
  const int mgroups = (mt_total + g.mg - 1) / g.mg;
  const int kpe = F32 ? g.kpt / 2 : g.kpt;
  for (int item = warp; item < mgroups * g.npairs; item += THREADS / 32) {
    const int mt0 = (item / g.npairs) * g.mg, np = item % g.npairs;
    int a_off[MG];
    bool on[MG];
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      on[i] = i < g.mg && mt0 + i < mt_total;
      const int p = min((mt0 + i) * 16 + (lane & 15), g.rows - 1);
      a_off[i] = on[i] ? row_off(p) + (lane >> 4) * 8 : 0;
    }
    float acc[MG][2][4];
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
    if constexpr (F32) {
      for (int tap = 0; tap < g.ntaps; ++tap) {
        const int toff = tap_off(tap);
        float part[MG][2][4];  // this tap's products
#pragma unroll
        for (int i = 0; i < MG; ++i)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[i][nt][r] = 0.f;
        for (int kk = 0; kk < g.kpt; kk += 16) {
          const int k0 = tap * kpe + kk / 2;
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* wb = W + (long long)(k0 + tig) * g.wpitch + np * 16 + nt * 8 + gid;
            cs3x3::split_tf32(__float_as_uint(wb[0]), bh[nt][0], bl[nt][0]);
            cs3x3::split_tf32(__float_as_uint(wb[4 * g.wpitch]), bh[nt][1], bl[nt][1]);
          }
#pragma unroll
          for (int i = 0; i < MG; ++i) {
            if (!on[i]) continue;
            uint32_t ah[4], al[4];
            cs3x3::ldsm_x4(ah, A + a_off[i] + toff + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) cs3x3::split_tf32(ah[q], ah[q], al[q]);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              cs3x3::mma_tf32(part[i][nt], al, bh[nt][0], bh[nt][1]);
              cs3x3::mma_tf32(part[i][nt], ah, bl[nt][0], bl[nt][1]);
              cs3x3::mma_tf32(part[i][nt], ah, bh[nt][0], bh[nt][1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MG; ++i)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][nt][r] += part[i][nt][r];
      }
    } else {
      // the step being fetched: tap, unit kk, the tap's A offset
      int tap = 0, kk = 0, toff = g.ntaps > 0 ? tap_off(0) : 0;
      auto fetch = [&](uint32_t (&b)[4], uint32_t (&a)[MG][4]) {
        cs3x3::ldsm_x4_t(b, reinterpret_cast<const bf16*>(W) +
                                (long long)(tap * kpe + kk + (lane & 15)) * g.wpitch + np * 16 +
                                (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MG; ++i)
          if (on[i]) cs3x3::ldsm_x4(a[i], A + a_off[i] + toff + kk);
        kk += 16;
        if (kk == g.kpt) {
          kk = 0;
          if (++tap < g.ntaps) toff = tap_off(tap);
        }
      };
      auto multiply = [&](const uint32_t (&b)[4], const uint32_t (&a)[MG][4]) {
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          if (!on[i]) continue;
          cs3x3::mma_bf16(acc[i][0], a[i], b[0], b[1]);
          cs3x3::mma_bf16(acc[i][1], a[i], b[2], b[3]);
        }
      };
      const int nsteps = g.ntaps * (g.kpt / 16);
      uint32_t b0[4], b1[4], a0[MG][4], a1[MG][4];
      if (nsteps > 0) fetch(b0, a0);
      for (int s = 0; s < nsteps; s += 2) {
        if (s + 1 < nsteps) fetch(b1, a1);
        multiply(b0, a0);
        if (s + 1 >= nsteps) break;
        if (s + 2 < nsteps) fetch(b0, a0);
        multiply(b1, a1);
      }
    }
    // the item's sums: fragment (i, nt) holds rows gid (+8), channels 2 tig, +1
    float sums[MG * 8];
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sums[(i * 2 + nt) * 4 + r] = acc[i][nt][r];
#pragma unroll 1
    for (int q = 0; q < MG * 4; ++q) {  // (i, nt, half)
      const int i = q >> 2, nt = (q >> 1) & 1, half = q & 1;
      const int m = (mt0 + i) * 16 + gid + half * 8;
      if (i < g.mg && mt0 + i < mt_total && m < g.rows)
        epi(m, np * 16 + nt * 8 + 2 * tig, sums[(i * 2 + nt) * 4 + 2 * half],
            sums[(i * 2 + nt) * 4 + 2 * half + 1]);
    }
  }
}

}  // namespace tapgemm
