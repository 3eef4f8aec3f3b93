// The band-row exchange between ring neighbours, in a kernel, over buffers
// mapped into each other's address space by CUDA IPC.  Shared by the band
// exchange (cs_band_xchg.cu, #10) and the band conv fused with it
// (cs_band_overlap.cu, #11).
//
// Every rank of a mesh dimension of S >= 2 ranks owns one device buffer
// (cs_band_xchg.cu::cs_sym_alloc) laid out as
//   [0, HEADER)                 64-bit counters, one per 128-byte line
//   [HEADER, HEADER + cap)      the `below` slot: the -1 neighbour's top rows
//   [HEADER + cap, ... + 2 cap) the `above` slot: the +1 neighbour's bottom rows
// and maps its two ring neighbours' buffers (one peer, both directions, when
// S == 2).  The counters rise forever: the host numbers the calls (epochs)
// and every counter is set to the epoch it has reached, so a kernel that has
// not run yet never meets a flag of the current call.
//
// One call, epoch e, launched cooperatively (every block resident at once):
//  1. barrier: block 0 signals "ready for e" to both neighbours
//     (READY_FROM_LEFT of the +1 neighbour, READY_FROM_RIGHT of the -1), and
//     every block waits until both neighbours have signalled e.  A neighbour
//     that signals e has finished its kernel of e - 1, so its slots no longer
//     hold anything it still has to read;
//  2. send: every block stores its share of my top rows into the +1
//     neighbour's `below` slot and of my bottom rows into the -1 neighbour's
//     `above` slot, fences at system scope and counts itself in my SENT;
//  3. block 0 waits for every block's count, then release-stores e into the
//     +1 neighbour's ARRIVED_BELOW and the -1 neighbour's ARRIVED_ABOVE;
//  4. a block that reads a received slot first waits (acquire) until its
//     own ARRIVED_* counter reaches e, then reads the slot bypassing L1.
// With S == 2 the one peer receives both signals in separate counters, and
// both slabs in separate slots.  No block waits on another block of its own
// grid except block 0 in step 3, on sends that every block makes before it
// waits on anything past the barrier, which block 0 opens for all.
//
// Every wait is bounded on %globaltimer (seconds).  A wait that runs out
// writes what it waited for into the host-mapped record `diag` (the first
// one only), raises my ABORT counter to the epoch, so that every other wait
// of the call gives up at once, and returns: the kernel ends, its outputs
// are garbage, and the host raises an error naming the rank, the epoch and
// the counter before it launches again or hands the outputs on
// (parallel/symmetric.py).  The kernel does not trap: on a card that ranks
// share, a trap in one rank's context left a neighbour's spinning kernel
// unscheduled for good, where the neighbour's own bound should have ended
// it (one H100, 4 ranks, 3 of them waiting for the fourth).

#pragma once

#include <cuda_runtime.h>

namespace csband {

constexpr long long HEADER = 1024;  // bytes before the `below` slot
constexpr int LINE = 16;            // 64-bit words per counter (128 bytes)
enum Counter {
  READY_FROM_LEFT = 0,   // the -1 neighbour reached the epoch
  READY_FROM_RIGHT = 1,  // the +1 neighbour reached the epoch
  ARRIVED_BELOW = 2,     // the -1 neighbour's top rows are in my `below` slot
  ARRIVED_ABOVE = 3,     // the +1 neighbour's bottom rows are in my `above` slot
  SENT = 4,              // blocks of my grid whose stores are out (cumulative)
  TIMEOUTS = 5,          // waits of this process that ran out
  ABORT = 6,             // the last epoch in which a wait of mine ran out
};
// the host-mapped record of the first wait that ran out (long long each)
enum Diag { D_FLAG, D_RANK, D_EPOCH, D_COUNTER, D_SEEN, D_WANT, D_TIMEOUT_NS, D_KERNEL, D_LEN };

struct Ring {
  char* me;     // my buffer
  char* right;  // the +1 neighbour's buffer, mapped
  char* left;   // the -1 neighbour's buffer, mapped (== right when S == 2)
  long long cap;             // bytes of each slot
  unsigned long long epoch;  // this call
  unsigned long long sent;   // SENT once every block of this call has counted itself
  long long timeout_ns;
  long long* diag;  // host-mapped record (device address)
  int rank;         // my coordinate along the dimension, for the record
  int kernel;       // 10 or 11, for the record
};

__device__ __forceinline__ unsigned long long* counter(char* buf, int c) {
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

// One thread waits until my counter c reaches `want`: true when it did;
// false when this call's waits gave up (after r.timeout_ns, recording what
// it waited for, or at once after another wait of the call ran out).
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
// Loads bypass L1 (the source may be a slot a peer wrote during this kernel).
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

// copy_units in the widest unit that divides the sizes and the addresses.
__device__ __forceinline__ void copy_chunks(char* dst, const char* src, long long stride,
                                            long long chunk, long long nchunk) {
  const unsigned long long a = (unsigned long long)dst | (unsigned long long)src |
                               (unsigned long long)stride | (unsigned long long)chunk;
  if (a % 16 == 0) copy_units<uint4>(dst, src, stride, chunk, nchunk);
  else if (a % 8 == 0) copy_units<unsigned long long>(dst, src, stride, chunk, nchunk);
  else if (a % 4 == 0) copy_units<unsigned int>(dst, src, stride, chunk, nchunk);
  else if (a % 2 == 0) copy_units<unsigned short>(dst, src, stride, chunk, nchunk);
  else copy_units<unsigned char>(dst, src, stride, chunk, nchunk);
}

// Steps 1-3 for the band x (nbf = B*6 blocks of `rows` rows of `row_bytes`
// each): the barrier, this block's share of both sends, and (block 0) the
// arrival signals.  Every thread of every block calls it.  A block whose
// barrier gave up sends nothing (its neighbour may still read its slots),
// and then no arrival is signalled.
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

// Step 4 for one block: wait (thread 0) until the slots it reads have
// arrived (or the call gave up); the whole block may read them after the
// call.
__device__ __forceinline__ void wait_arrivals(const Ring& r, bool below, bool above) {
  if (threadIdx.x == 0) {
    if (!below || wait_for(r, ARRIVED_BELOW, r.epoch)) {
      if (above) wait_for(r, ARRIVED_ABOVE, r.epoch);
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace csband
