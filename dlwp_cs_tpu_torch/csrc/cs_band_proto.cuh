// The band-row exchange between ring neighbours, over buffers mapped into
// each other's address space by CUDA IPC.  Shared by the band exchange
// (cs_band_xchg.cu, #10) and the band conv fused with it (cs_band_overlap.cu,
// #11).
//
// Every rank of a mesh dimension of S >= 2 ranks owns one device buffer
// (cs_band_xchg.cu::cs_sym_alloc) laid out as
//   [0, HEADER)                          64-bit counters, one per 128-byte line
//   [HEADER + (2p) cap, ... + cap)       the `below` slot of parity p: the -1
//                                        neighbour's top rows of an epoch e
//                                        with e % 2 == p
//   [HEADER + (2p + 1) cap, ... + cap)   the `above` slot of parity p: the +1
//                                        neighbour's bottom rows
// (p = 0, 1: four slots) and maps its two ring neighbours' buffers (one
// peer, both directions, when S == 2).  The counters rise forever: the host
// numbers the calls (epochs) and every counter is set to the epoch it has
// reached, so a call never meets a flag of an earlier one.
//
// One call, epoch e, parity p = e % 2, is a sequence on the caller's stream
// in which no thread waits for another rank: every wait on a neighbour is a
// stream wait (cuStreamWaitValue64, GEQ), held in the GPU's front end, so a
// context with nothing runnable gives up its time slice to the ranks that
// share the card (a spinning kernel kept its whole slice):
//  1. wait until CONSUMED_BY_RIGHT and CONSUMED_BY_LEFT reach the last epoch
//     that used parity p's slots (normally e - 2; the host keeps it): both
//     neighbours have read what I last stored there;
//  2. a plain kernel stores my top rows into the +1 neighbour's `below` slot
//     of parity p and my bottom rows into the -1 neighbour's `above` slot;
//  3. cuStreamWriteValue64 writes e into the +1 neighbour's ARRIVED_BELOW and
//     the -1 neighbour's ARRIVED_ABOVE.  Its default flags put a system-wide
//     fence before the write, so the kernel's stores are visible first;
//  4. (#11: the conv's tiles that touch no ghost row, while the rows fly)
//  5. wait until my ARRIVED_BELOW and ARRIVED_ABOVE reach e (#11: those its
//     ghost rows read; the end shards read a seam row instead), then write
//     the ticket of this call into a host-mapped word, which the host's
//     watchdog reads (below);
//  6. a kernel reads my slots of parity p through L2 (#10: the copy into
//     `below`/`above`; #11: the tiles of rows 0 and h-1);
//  7. write e into the -1 neighbour's CONSUMED_BY_RIGHT and the +1
//     neighbour's CONSUMED_BY_LEFT.
// Why a slot is never overwritten while it is read: the sender of epoch e
// waits in step 1 until the reader has written CONSUMED for the last epoch
// that used the slot, and the reader writes it (step 7) after the kernel
// that read the slot has ended (step 6), in stream order.  In the common
// case the wait has long passed: a rank sends e only after its stream has
// passed the arrival wait of e - 1, and the neighbour wrote ARRIVED(e - 1)
// after its reads of epoch e - 2, so two parities need no neighbour barrier.
// With S == 2 the one peer receives both signals in separate counters, and
// both slabs in separate slots.
//
// A stream wait has no timeout of its own.  The host bounds it
// (parallel/symmetric.py, its watchdog): when a call's waits have not
// passed after the bound, it writes what the first of them waited for into
// the host-mapped record `diag`, writes the epoch into both neighbours'
// GAVE_UP_* counters, and releases its own stream by writing the awaited
// values from a second stream; the call's outputs are garbage, and the host
// raises an error naming the rank, the epoch and the counter before it
// launches again or hands the outputs on.  A neighbour that finds GAVE_UP
// raised raises too.
//
// The first design (the `_v1` kernels, kept as timing rows on a buffer of
// their own) ran the call as one cooperative kernel whose threads spun on
// the counters (wait_for, below): a neighbour barrier on READY_FROM_*, the
// sends counted in SENT, and the arrivals, each bounded on %globaltimer.  On
// a card that ranks share, each such call waited out the other ranks' time
// slices twice, and a trap in one rank's context left a neighbour's spinning
// kernel unscheduled for good, so its waits give up through ABORT instead of
// trapping.

#pragma once

#include <cuda.h>  // the CUDA driver API's types; its entry points come through the runtime
#include <cuda_runtime.h>

#include <cstdio>

namespace csband {

constexpr long long HEADER = 2048;  // bytes before the first slot
constexpr int LINE = 16;            // 64-bit words per counter (128 bytes)
enum Counter {
  READY_FROM_LEFT = 0,     // v1: the -1 neighbour reached the epoch
  READY_FROM_RIGHT = 1,    // v1: the +1 neighbour reached the epoch
  ARRIVED_BELOW = 2,       // the -1 neighbour's top rows are in my `below` slot
  ARRIVED_ABOVE = 3,       // the +1 neighbour's bottom rows are in my `above` slot
  SENT = 4,                // v1: blocks of my grid whose stores are out (cumulative)
  TIMEOUTS = 5,            // v1: waits of this process that ran out
  ABORT = 6,               // v1: the last epoch in which a wait of mine ran out
  CONSUMED_BY_RIGHT = 7,   // the +1 neighbour has read my top rows of the epoch
  CONSUMED_BY_LEFT = 8,    // the -1 neighbour has read my bottom rows of the epoch
  GAVE_UP_LEFT = 9,        // the -1 neighbour's wait of the epoch ran out
  GAVE_UP_RIGHT = 10,      // the +1 neighbour's wait of the epoch ran out
  NCOUNTERS = 11,
};
static_assert(NCOUNTERS * LINE * 8 <= HEADER, "the counters outgrow the header");
// the host-mapped record of the first wait that ran out (long long each)
enum Diag { D_FLAG, D_RANK, D_EPOCH, D_COUNTER, D_SEEN, D_WANT, D_TIMEOUT_NS, D_KERNEL, D_LEN };

__host__ __device__ __forceinline__ long long slot_offset(int parity, bool above,
                                                          long long cap) {
  return HEADER + (2LL * parity + (above ? 1 : 0)) * cap;
}

struct Ring {
  char* me;     // my buffer
  char* right;  // the +1 neighbour's buffer, mapped
  char* left;   // the -1 neighbour's buffer, mapped (== right when S == 2)
  long long cap;             // bytes of each slot
  unsigned long long epoch;  // this call
  unsigned long long sent;   // v1: SENT once every block of this call has counted itself
  long long timeout_ns;      // v1
  long long* diag;  // v1: host-mapped record (device address)
  int rank;         // my coordinate along the dimension, for the record
  int kernel;       // 10 or 11, for the record
};

__host__ __device__ __forceinline__ unsigned long long* counter(char* buf, int c) {
  return reinterpret_cast<unsigned long long*>(buf) + c * LINE;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_add_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// v1 (and the probe's spinning round): one thread waits until my counter c
// reaches `want`: true when it did; false when this call's waits gave up
// (after r.timeout_ns, recording what it waited for, or at once after
// another wait of the call ran out).
__device__ __noinline__ bool wait_for(const Ring& r, int c, unsigned long long want) {
  const unsigned long long* p = counter(r.me, c);
  unsigned long long seen = ld_acquire_sys(p);
  if (seen >= want) return true;
  unsigned long long* abort = counter(r.me, ABORT);
  const long long start = globaltimer();
  while ((seen = ld_acquire_sys(p)) < want) {
    if (ld_acquire_sys(abort) >= r.epoch) return false;
    if (globaltimer() - start > r.timeout_ns) {
      if (atomicAdd(counter(r.me, TIMEOUTS), 1ull) == 0) {
        volatile long long* d = r.diag;
        d[D_RANK] = r.rank;
        d[D_EPOCH] = (long long)r.epoch;
        d[D_COUNTER] = c;
        d[D_SEEN] = (long long)seen;
        d[D_WANT] = (long long)want;
        d[D_TIMEOUT_NS] = r.timeout_ns;
        d[D_KERNEL] = r.kernel;
        __threadfence_system();
        d[D_FLAG] = 1;
        __threadfence_system();
      }
      st_release_sys(abort, r.epoch);
      return false;
    }
    __nanosleep(256);
  }
  return true;
}

// Copies nchunk chunks of `chunk` bytes, chunk i from src + i * stride, to
// dst + i * chunk, in units of U, spread over every thread of the grid.
// Loads bypass L1 (the source may be a slot a peer wrote).
template <typename U>
__device__ __forceinline__ void copy_units(char* dst, const char* src, long long stride,
                                           long long chunk, long long nchunk) {
  const long long per = chunk / (long long)sizeof(U);
  const long long total = per * nchunk;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const long long c = i / per, j = i - c * per;
    reinterpret_cast<U*>(dst)[i] =
        __ldcg(reinterpret_cast<const U*>(src + c * stride) + j);
  }
}

// The widest unit (16 bytes down to 1) that divides the sizes and the addresses.
__host__ __device__ __forceinline__ int copy_unit(const void* dst, const void* src,
                                                  long long stride, long long chunk) {
  const unsigned long long a = (unsigned long long)dst | (unsigned long long)src |
                               (unsigned long long)stride | (unsigned long long)chunk;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2 : 1;
}

// copy_units in the widest unit that divides the sizes and the addresses.
__device__ __forceinline__ void copy_chunks(char* dst, const char* src, long long stride,
                                            long long chunk, long long nchunk) {
  switch (copy_unit(dst, src, stride, chunk)) {
    case 16: copy_units<uint4>(dst, src, stride, chunk, nchunk); break;
    case 8: copy_units<unsigned long long>(dst, src, stride, chunk, nchunk); break;
    case 4: copy_units<unsigned int>(dst, src, stride, chunk, nchunk); break;
    case 2: copy_units<unsigned short>(dst, src, stride, chunk, nchunk); break;
    default: copy_units<unsigned char>(dst, src, stride, chunk, nchunk);
  }
}

// Step 2 for the band x (nbf = B*6 blocks of `rows` rows of `row_bytes`
// each): my top `width` rows into `to_right` (the +1 neighbour's `below`
// slot of the call's parity), my bottom rows into `to_left` (the -1
// neighbour's `above` slot).  Every thread of every block calls it.
__device__ __forceinline__ void send_rows(char* to_right, char* to_left, const char* x,
                                          long long nbf, int rows, long long row_bytes,
                                          int width) {
  const long long stride = (long long)rows * row_bytes, chunk = (long long)width * row_bytes;
  copy_chunks(to_right, x + (long long)(rows - width) * row_bytes, stride, chunk, nbf);
  copy_chunks(to_left, x, stride, chunk, nbf);
}

// v1: steps 1-3 of the first design for the band x: the barrier, this
// block's share of both sends, and (block 0) the arrival signals.  Every
// thread of every block calls it.  A block whose barrier gave up sends
// nothing (its neighbour may still read its slots), and then no arrival is
// signalled.
__device__ __forceinline__ void barrier_and_send(const Ring& r, const char* x, long long nbf,
                                                 int rows, long long row_bytes, int width) {
  __shared__ int opened;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st_release_sys(counter(r.right, READY_FROM_LEFT), r.epoch);
    st_release_sys(counter(r.left, READY_FROM_RIGHT), r.epoch);
  }
  if (threadIdx.x == 0)
    opened = wait_for(r, READY_FROM_LEFT, r.epoch) && wait_for(r, READY_FROM_RIGHT, r.epoch);
  __syncthreads();
  if (opened) {
    const long long stride = (long long)rows * row_bytes, chunk = (long long)width * row_bytes;
    // my top rows -> the +1 neighbour's `below`; my bottom rows -> the -1's `above`
    copy_chunks(r.right + HEADER, x + (long long)(rows - width) * row_bytes, stride, chunk, nbf);
    copy_chunks(r.left + HEADER + r.cap, x, stride, chunk, nbf);
    __threadfence_system();
  }
  __syncthreads();
  if (threadIdx.x == 0 && opened) {
    red_add_release_sys(counter(r.me, SENT), 1ull);
    if (blockIdx.x == 0 && wait_for(r, SENT, r.sent)) {
      __threadfence_system();
      st_release_sys(counter(r.right, ARRIVED_BELOW), r.epoch);
      st_release_sys(counter(r.left, ARRIVED_ABOVE), r.epoch);
    }
  }
}

// v1: the arrival wait for one block: thread 0 waits until the slots it
// reads have arrived (or the call gave up); the whole block may read them
// after the call.
__device__ __forceinline__ void wait_arrivals(const Ring& r, bool below, bool above) {
  if (threadIdx.x == 0) {
    if (!below || wait_for(r, ARRIVED_BELOW, r.epoch)) {
      if (above) wait_for(r, ARRIVED_ABOVE, r.epoch);
    }
    __threadfence();
  }
  __syncthreads();
}

// ---- the host's half: stream memory operations ----
//
// cuStreamWriteValue64 and cuStreamWaitValue64 come from the CUDA driver API
// through cudaGetDriverEntryPoint, so the libraries link the runtime alone.  Their
// CUresult errors are returned as MEMOP_ERROR + the CUresult, which
// error_string names.

constexpr int MEMOP_ERROR = 100000;

struct MemOps {
  CUresult (*write)(CUstream, CUdeviceptr, cuuint64_t, unsigned int) = nullptr;
  CUresult (*wait)(CUstream, CUdeviceptr, cuuint64_t, unsigned int) = nullptr;
  CUresult (*attribute)(int*, CUdevice_attribute, CUdevice) = nullptr;
  CUresult (*name)(CUresult, const char**) = nullptr;
  cudaError_t status = cudaSuccess;

  template <typename Fn>
  void load(const char* symbol, Fn& fn) {
    if (status != cudaSuccess) return;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    status = cudaGetDriverEntryPointByVersion(symbol, &p, 12000, cudaEnableDefault, &q);
#else
    status = cudaGetDriverEntryPoint(symbol, &p, cudaEnableDefault, &q);
#endif
    if (status == cudaSuccess && (q != cudaDriverEntryPointSuccess || p == nullptr))
      status = cudaErrorSymbolNotFound;
    fn = reinterpret_cast<Fn>(p);
  }
  MemOps() {
    load("cuStreamWriteValue64", write);
    load("cuStreamWaitValue64", wait);
    load("cuDeviceGetAttribute", attribute);
    load("cuGetErrorName", name);
  }
};

inline const MemOps& memops() {
  static const MemOps ops;
  return ops;
}

inline int memop_result(CUresult r) { return r == CUDA_SUCCESS ? 0 : MEMOP_ERROR + (int)r; }

// 1 in *ok when `device` takes 64-bit stream memory operations, else 0.
inline int memops_supported(int device, int* ok) {
  const MemOps& m = memops();
  *ok = 0;
  if (m.status != cudaSuccess) return m.status;
  return memop_result(
      m.attribute(ok, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, (CUdevice)device));
}

// Enqueue: write `value` to the 64-bit word at `addr` (device memory, a
// peer's mapped buffer or mapped host memory), after a fence (default flags).
inline int stream_write(cudaStream_t s, const void* addr, unsigned long long value) {
  const MemOps& m = memops();
  if (m.status != cudaSuccess) return m.status;
  return memop_result(m.write(reinterpret_cast<CUstream>(s),
                              reinterpret_cast<CUdeviceptr>(addr), value, 0));
}

// Enqueue: hold the stream until the word at `addr` is >= `value`.
inline int stream_wait(cudaStream_t s, const void* addr, unsigned long long value) {
  const MemOps& m = memops();
  if (m.status != cudaSuccess) return m.status;
  return memop_result(m.wait(reinterpret_cast<CUstream>(s), reinterpret_cast<CUdeviceptr>(addr),
                             value, CU_STREAM_WAIT_VALUE_GEQ));
}

// ---- one call of the protocol, the steps of the header on stream s ----

constexpr int SEND_THREADS = 256;

// step 2 as a kernel of its own (no thread of it waits on anything)
static __global__ void __launch_bounds__(SEND_THREADS)
    send_rows_kernel(char* to_right, char* to_left, const char* x, long long nbf, int rows,
                     long long row_bytes, int width) {
  send_rows(to_right, to_left, x, nbf, rows, row_bytes, width);
}

// Holds the stream `ns` nanoseconds (one thread): a rank made to lag before
// it reads its slots, in tests of the slots' reuse.
static __global__ void lag_kernel(long long ns) {
  const long long start = globaltimer();
  while (globaltimer() - start < ns) __nanosleep(1000);
}

inline int enqueue_lag(long long ns, cudaStream_t s) {
  if (ns <= 0) return 0;
  lag_kernel<<<1, 1, 0, s>>>(ns);
  return cudaGetLastError();
}

// What one call moves each way (nbf blocks of `width` rows of `row_bytes`)
// and the buffers it moves them between.
struct Call {
  char* me;
  char* right;
  char* left;
  long long cap;
  unsigned long long epoch;
  unsigned long long consumed;  // step 1's target: the last epoch that used this parity
  unsigned long long* ticket;   // host-mapped word the watchdog reads
  unsigned long long ticket_value;
  int parity() const { return (int)(epoch % 2); }
  char* my_slot(bool above) const { return me + slot_offset(parity(), above, cap); }
};

// Steps 1-3: the wait for the slots, the send kernel, the arrival signals.
inline int enqueue_send(const Call& c, const char* x, long long nbf, int rows,
                        long long row_bytes, int width, int sms, cudaStream_t s) {
  int err = 0;
  if (c.consumed > 0) {
    err = stream_wait(s, counter(c.me, CONSUMED_BY_RIGHT), c.consumed);
    if (!err) err = stream_wait(s, counter(c.me, CONSUMED_BY_LEFT), c.consumed);
    if (err) return err;
  }
  char* to_right = c.right + slot_offset(c.parity(), false, c.cap);
  char* to_left = c.left + slot_offset(c.parity(), true, c.cap);
  const long long chunk = (long long)width * row_bytes;
  const int unit = copy_unit(to_right, x, (long long)rows * row_bytes, chunk);
  const long long units = chunk * nbf / unit;
  const long long want = (units + SEND_THREADS - 1) / SEND_THREADS;
  const int grid = (int)(want < 4LL * sms ? want : 4LL * sms);
  send_rows_kernel<<<grid, SEND_THREADS, 0, s>>>(to_right, to_left, x, nbf, rows, row_bytes,
                                                 width);
  err = cudaGetLastError();
  if (!err) err = stream_write(s, counter(c.right, ARRIVED_BELOW), c.epoch);
  if (!err) err = stream_write(s, counter(c.left, ARRIVED_ABOVE), c.epoch);
  return err;
}

// Step 5: the arrival waits (those asked for), then the ticket.
inline int enqueue_arrivals(const Call& c, bool below, bool above, cudaStream_t s) {
  int err = 0;
  if (below) err = stream_wait(s, counter(c.me, ARRIVED_BELOW), c.epoch);
  if (!err && above) err = stream_wait(s, counter(c.me, ARRIVED_ABOVE), c.epoch);
  if (!err) err = stream_write(s, c.ticket, c.ticket_value);
  return err;
}

// Step 7: my slots of this epoch are read.
inline int enqueue_consumed(const Call& c, cudaStream_t s) {
  int err = stream_write(s, counter(c.left, CONSUMED_BY_RIGHT), c.epoch);
  if (!err) err = stream_write(s, counter(c.right, CONSUMED_BY_LEFT), c.epoch);
  return err;
}

inline const char* error_string(int err) {
  if (err < MEMOP_ERROR) return cudaGetErrorString(static_cast<cudaError_t>(err));
  static thread_local char msg[96];
  const char* name = nullptr;
  if (memops().name == nullptr ||
      memops().name(static_cast<CUresult>(err - MEMOP_ERROR), &name) != CUDA_SUCCESS)
    name = "unknown CUresult";
  std::snprintf(msg, sizeof msg, "stream memory operation: %s", name);
  return msg;
}

}  // namespace csband
