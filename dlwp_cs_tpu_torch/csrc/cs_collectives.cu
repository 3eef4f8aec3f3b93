// The named-axis collectives (ppermute, all_gather, psum) between the ranks
// of one host, for Hopper (sm_90a), over buffers mapped into each other's
// address space by CUDA IPC.
//
// Replaces XLA's device collectives, which the reference reaches through
// lax.ppermute, lax.all_gather and lax.psum inside shard_map
// (dlwp_cs_tpu/parallel/halo.py, halo2d.py, sharding.py, train/sequence.py);
// there is no Pallas kernel behind them.  Every rank of a group of S ranks
// owns one buffer (cs_band_xchg.cu::cs_sym_alloc) laid out as
//   [0, header)                        64-bit counters, one per 128-byte line:
//                                      ARRIVED[s] (line s): the epoch whose slab
//                                      the rank at coordinate s last stored
//                                      here; CONSUMED[d] (line S + d): the
//                                      epoch whose slab of mine the rank d last
//                                      read; GAVE_UP[s] (line 2S + s)
//   [header + (p S + s) cap, + cap)    slot [p][s]: the slab of the rank s of
//                                      an epoch e with e % 2 == p
// and maps every peer's buffer (parallel/symmetric.py::GroupBuffer, which
// numbers the calls and bounds the waits).  One call, epoch e, parity p, is a
// sequence on the caller's stream in which no thread waits for another rank
// (the waits are stream memory operations, cs_band_proto.cuh):
//  1. wait until CONSUMED[d] reaches the last epoch that stored into d's slot
//     [p][me], for each destination d (normally long passed);
//  2. cs_coll_send_kernel stores my slab into slot [p][me] of each
//     destination's buffer (every peer for all_gather and psum; the one
//     destination under the permutation for ppermute);
//  3. cuStreamWriteValue64 writes e into each destination's ARRIVED[me]
//     (a system-wide fence first, so the stores land before it);
//  4. wait until my ARRIVED[s] reaches e for each source s I read;
//  5. cs_coll_reduce_kernel (psum: the S slabs summed in rank order, my own
//     read from my input) or cs_coll_unpack_kernel (all_gather: the slabs
//     interleaved into the tiled or stacked output; ppermute: one slab);
//  6. write e into each source's CONSUMED[me].
// The host (parallel/device_collectives.py) enqueues the steps through the
// entry points below.
//
// What bounds it on this card: the bytes are small next to the HBM rate
// (a halo strip, or a gradient bucket of a few MB), so latency bounds it:
// two launches and a signal round trip through the GPU's front end and,
// where the ranks share one card, the switches between their contexts.
//
// The sum: in the tensor's dtype, in rank order 0..S-1, rounding after each
// add as a chain of torch.add does (bf16 and f16: each partial sum rounded
// from float), so every rank gets the same bits and the plain version
// (parallel/device_collectives.py::psum_plain) gives them too.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "cs_band_proto.cuh"

namespace {

using namespace csband;

constexpr int THREADS = 256;
constexpr int MAX_PEERS = 16;  // ranks of one group (GroupBuffer checks it)

struct Ptrs {
  char* p[MAX_PEERS];
};

struct ConstPtrs {
  const char* p[MAX_PEERS];
};

// Step 2: nbytes of x into each of the ndst destination slots, in units of
// U, spread over the grid.  Loads of x go through L1 (each is read ndst
// times); the stores go to peers' memory.
template <typename U>
__global__ void __launch_bounds__(THREADS)
    cs_coll_send_kernel(Ptrs dst, int ndst, const char* __restrict__ x, long long units) {
  const long long total = units * ndst;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const int d = (int)(i / units);
    const long long j = i - (long long)d * units;
    reinterpret_cast<U*>(dst.p[d])[j] = reinterpret_cast<const U*>(x)[j];
  }
}

// Step 5 of all_gather and ppermute: out viewed as (outer, nsrc, inner)
// bytes, out[o, s, :] = src[s][o, :], in units of U.  Loads bypass L1 (the
// slots are written by other ranks).
template <typename U>
__global__ void __launch_bounds__(THREADS)
    cs_coll_unpack_kernel(char* __restrict__ out, ConstPtrs src, int nsrc, long long outer,
                          long long inner_units) {
  const long long row = inner_units * nsrc;
  const long long total = outer * row;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const long long o = i / row, r = i - o * row;
    const int s = (int)(r / inner_units);
    const long long j = r - (long long)s * inner_units;
    reinterpret_cast<U*>(out)[i] =
        __ldcg(reinterpret_cast<const U*>(src.p[s]) + o * inner_units + j);
  }
}

// The element type's sum as a chain of torch.adds: Acc is what one add
// computes in, T what it rounds to.
template <typename T>
struct Add {
  using Acc = T;
  static __device__ __forceinline__ Acc load(const T* p) { return __ldcg(p); }
  static __device__ __forceinline__ Acc add(Acc a, Acc b) { return a + b; }
  static __device__ __forceinline__ T store(Acc a) { return a; }
};

template <>
struct Add<float> {
  using Acc = float;
  static __device__ __forceinline__ float load(const float* p) { return __ldcg(p); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float store(float a) { return a; }
};

template <>
struct Add<double> {
  using Acc = double;
  static __device__ __forceinline__ double load(const double* p) { return __ldcg(p); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double store(double a) { return a; }
};

template <>
struct Add<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float a) { return __float2bfloat16_rn(a); }
};

template <>
struct Add<__half> {
  using Acc = float;
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(__ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __half2float(__float2half_rn(__fadd_rn(a, b)));
  }
  static __device__ __forceinline__ __half store(float a) { return __float2half_rn(a); }
};

// Step 5 of psum: out[i] = ((src[0][i] + src[1][i]) + ...) + src[n-1][i],
// VEC elements a thread at a time (16-byte loads where the pointers and the
// length allow).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    cs_coll_reduce_kernel(T* __restrict__ out, ConstPtrs src, int nsrc, long long numel) {
  using A = Add<T>;
  const long long groups = numel / VEC;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += step) {
    typename A::Acc acc[VEC];
    const T* s0 = reinterpret_cast<const T*>(src.p[0]) + g * VEC;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = A::load(s0 + v);
    for (int s = 1; s < nsrc; ++s) {
      const T* sp = reinterpret_cast<const T*>(src.p[s]) + g * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = A::add(acc[v], A::load(sp + v));
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[g * VEC + v] = A::store(acc[v]);
  }
}

// dtype codes of the reduce entry
enum Dtype { F32 = 0, BF16 = 1, F64 = 2, F16 = 3, I32 = 4, I64 = 5 };

int grid_for(long long items, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    sms = 132;
  const long long want = (items + THREADS - 1) / THREADS;
  const long long cap = 4LL * sms;
  return (int)(want < 1 ? 1 : want < cap ? want : cap);
}

unsigned long long address_bits(const void* const* p, int n) {
  unsigned long long a = 0;
  for (int i = 0; i < n; ++i) a |= (unsigned long long)p[i];
  return a;
}

int unit_of(unsigned long long bits) {
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : bits % 2 == 0 ? 2 : 1;
}

template <typename T>
int launch_reduce(void* out, const ConstPtrs& src, int nsrc, long long numel, int device,
                  cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned long long bits =
      address_bits(reinterpret_cast<const void* const*>(src.p), nsrc) |
      (unsigned long long)out;
  T* o = static_cast<T*>(out);
  if (VEC > 1 && bits % 16 == 0 && numel % VEC == 0) {
    cs_coll_reduce_kernel<T, VEC><<<grid_for(numel / VEC, device), THREADS, 0, s>>>(
        o, src, nsrc, numel);
  } else {
    cs_coll_reduce_kernel<T, 1><<<grid_for(numel, device), THREADS, 0, s>>>(o, src, nsrc,
                                                                           numel);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Step 2 on `stream`: nbytes of x into each of the ndst slots dst[0..ndst).
int cs_coll_send_launch(int device, const void* x, long long nbytes, void** dst, int ndst,
                        void* stream) {
  if (ndst < 1 || ndst > MAX_PEERS || nbytes < 1) return cudaErrorInvalidValue;
  Ptrs d{};
  for (int i = 0; i < ndst; ++i) d.p[i] = static_cast<char*>(dst[i]);
  const int unit = unit_of(address_bits(dst, ndst) | (unsigned long long)x |
                           (unsigned long long)nbytes);
  const long long units = nbytes / unit;
  const int grid = grid_for(units * ndst, device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char* xp = static_cast<const char*>(x);
  switch (unit) {
    case 16: cs_coll_send_kernel<uint4><<<grid, THREADS, 0, s>>>(d, ndst, xp, units); break;
    case 8: cs_coll_send_kernel<unsigned long long><<<grid, THREADS, 0, s>>>(d, ndst, xp, units); break;
    case 4: cs_coll_send_kernel<unsigned int><<<grid, THREADS, 0, s>>>(d, ndst, xp, units); break;
    case 2: cs_coll_send_kernel<unsigned short><<<grid, THREADS, 0, s>>>(d, ndst, xp, units); break;
    default: cs_coll_send_kernel<unsigned char><<<grid, THREADS, 0, s>>>(d, ndst, xp, units);
  }
  return cudaGetLastError();
}

// Step 5 of all_gather / ppermute on `stream`: out (outer, nsrc, inner
// bytes) from src[s] (outer, inner bytes) each.
int cs_coll_unpack_launch(int device, void* out, const void** src, int nsrc, long long outer,
                          long long inner, void* stream) {
  if (nsrc < 1 || nsrc > MAX_PEERS || outer < 1 || inner < 1) return cudaErrorInvalidValue;
  ConstPtrs p{};
  for (int i = 0; i < nsrc; ++i) p.p[i] = static_cast<const char*>(src[i]);
  const int unit = unit_of(address_bits(src, nsrc) | (unsigned long long)out |
                           (unsigned long long)inner);
  const long long iu = inner / unit;
  const int grid = grid_for(outer * nsrc * iu, device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* o = static_cast<char*>(out);
  switch (unit) {
    case 16: cs_coll_unpack_kernel<uint4><<<grid, THREADS, 0, s>>>(o, p, nsrc, outer, iu); break;
    case 8: cs_coll_unpack_kernel<unsigned long long><<<grid, THREADS, 0, s>>>(o, p, nsrc, outer, iu); break;
    case 4: cs_coll_unpack_kernel<unsigned int><<<grid, THREADS, 0, s>>>(o, p, nsrc, outer, iu); break;
    case 2: cs_coll_unpack_kernel<unsigned short><<<grid, THREADS, 0, s>>>(o, p, nsrc, outer, iu); break;
    default: cs_coll_unpack_kernel<unsigned char><<<grid, THREADS, 0, s>>>(o, p, nsrc, outer, iu);
  }
  return cudaGetLastError();
}

// Step 5 of psum on `stream`: out (numel elements of `dtype`, a Dtype code)
// = the nsrc slabs src[0..nsrc) summed in that order.
int cs_coll_reduce_launch(int device, int dtype, void* out, const void** src, int nsrc,
                          long long numel, void* stream) {
  if (nsrc < 1 || nsrc > MAX_PEERS || numel < 1) return cudaErrorInvalidValue;
  ConstPtrs p{};
  for (int i = 0; i < nsrc; ++i) p.p[i] = static_cast<const char*>(src[i]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch_reduce<float>(out, p, nsrc, numel, device, s);
    case BF16: return launch_reduce<__nv_bfloat16>(out, p, nsrc, numel, device, s);
    case F64: return launch_reduce<double>(out, p, nsrc, numel, device, s);
    case F16: return launch_reduce<__half>(out, p, nsrc, numel, device, s);
    case I32: return launch_reduce<int>(out, p, nsrc, numel, device, s);
    case I64: return launch_reduce<long long>(out, p, nsrc, numel, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Steps 1, 4 on `stream`: hold it until each word addr[i] is >= want[i]
// (want 0: no wait).
int cs_coll_wait(void** addr, const unsigned long long* want, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    if (want[i] == 0) continue;
    const int err = stream_wait(s, addr[i], want[i]);
    if (err) return err;
  }
  return 0;
}

// Steps 3, 6 on `stream`: write `value` to each word addr[i].
int cs_coll_signal(void** addr, int n, unsigned long long value, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const int err = stream_write(s, addr[i], value);
    if (err) return err;
  }
  return 0;
}

const char* cs_collectives_error_string(int err) { return error_string(err); }

}  // extern "C"
