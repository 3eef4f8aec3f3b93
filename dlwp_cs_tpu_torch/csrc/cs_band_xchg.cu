// The band-row halo exchange as one kernel of remote copies, for Hopper
// (sm_90a), and the symmetric buffers it copies into.
//
// Replaces the TPU kernel dlwp_cs_tpu/parallel/rdma_halo.py::_kernel
// (band_exchange_rdma, #10): a neighbour barrier, then my top `w` rows to the
// +1 neighbour's `below` and my bottom `w` rows to the -1 neighbour's
// `above`, then a wait for both of mine.  On the TPU the two copies are DMAs
// over the inter-chip links; here they are stores of the kernel's threads
// into the neighbours' buffers, which CUDA IPC maps into this process (on
// one card, or over NVLink between the cards of one host).  The protocol is
// cs_band_proto.cuh's; after it each block copies its share of the two
// received slots into the output tensors.
//
// What bounds it on this card: it moves B*6*w*n*C elements each way (at most
// a few MB at the flagship's shapes: under a microsecond of HBM traffic), so
// latency bounds it: the launch, two system-scope flag round trips and,
// where the ranks share one card, the time slices of the other ranks'
// contexts, which the barrier and the wait have to sit out.  The design
// answers with one cooperative launch of a few blocks, each of which sends
// before it waits on anything past the barrier.
//
// The symmetric buffers: cs_sym_alloc takes one buffer from cudaMalloc (not
// from PyTorch's caching allocator, which sub-allocates: an IPC handle names
// a whole allocation) and exports it; cs_sym_open maps a peer's buffer from
// its handle; cs_sym_close and cs_sym_free undo them.  The host exchanges the
// handles over the process group and keeps the epochs
// (dlwp_cs_tpu_torch/parallel/symmetric.py).

#include <cuda_runtime.h>

#include <atomic>
#include <cstring>

#include "cs_band_proto.cuh"

namespace {

using namespace csband;

constexpr int THREADS = 256;
std::atomic<int> g_allocated{0}, g_opened{0};

// x (B, 6, rows, cols, C) of `elem` bytes; below, above (B, 6, w, cols, C)
__global__ void __launch_bounds__(THREADS) cs_band_xchg_kernel(
    Ring r, const char* __restrict__ x, char* __restrict__ below, char* __restrict__ above,
    long long nbf, int rows, long long row_bytes, int width) {
  barrier_and_send(r, x, nbf, rows, row_bytes, width);
  wait_arrivals(r, true, true);
  const long long chunk = (long long)width * row_bytes;
  copy_chunks(below, r.me + HEADER, chunk, chunk, nbf);
  copy_chunks(above, r.me + HEADER + r.cap, chunk, chunk, nbf);
}

}  // namespace

extern "C" {

// One buffer of `bytes` (zeroed) on `device` and its IPC handle (64 bytes
// written to `handle`).
int cs_sym_alloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    return err;
  }
  std::memcpy(handle, &h, sizeof(h));
  ++g_allocated;
  return cudaDeviceSynchronize();
}

// Maps a peer's buffer from its 64-byte handle.
int cs_sym_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  if (err == cudaSuccess) err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (err == cudaSuccess) ++g_opened;
  return err;
}

int cs_sym_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  if (err == cudaSuccess) --g_opened;
  return err;
}

int cs_sym_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  if (err == cudaSuccess) --g_allocated;
  return err;
}

// Buffers of this process still allocated, and peers' buffers still mapped.
int cs_sym_live(int* allocated, int* opened) {
  *allocated = g_allocated.load();
  *opened = g_opened.load();
  return cudaSuccess;
}

// The host-mapped timeout record (D_LEN long longs, zeroed), once per
// process: its host address, which under unified addressing is also the
// address the kernels write.
int cs_sym_diag(void** host) {
  static long long* rec = nullptr;
  if (rec == nullptr) {
    cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&rec), D_LEN * sizeof(long long),
                                    cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) {
      rec = nullptr;
      return err;
    }
    std::memset(rec, 0, D_LEN * sizeof(long long));
    void* dev = nullptr;
    err = cudaHostGetDevicePointer(&dev, rec, 0);
    if (err != cudaSuccess) return err;
    if (dev != rec) return cudaErrorNotSupported;
  }
  *host = rec;
  return cudaSuccess;
}

// Kernel #10 on the current stream.  x (B, 6, rows, cols, C) of elem_bytes
// each, contiguous; below and above (B, 6, width, cols, C).  me, right,
// left: my buffer and the neighbours' (mapped); cap: bytes of each slot
// (>= B*6*width*cols*C*elem_bytes).  *sent: my SENT target before the call,
// raised by the grid.  Returns a cudaError_t (0 = success).
int cs_band_xchg_launch(int device, const void* x, void* below, void* above, void* me,
                        void* right, void* left, long long cap, int batch, int rows,
                        int cols, int chans, int width, int elem_bytes,
                        unsigned long long epoch, unsigned long long* sent,
                        long long timeout_ns, void* diag, int rank, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || chans < 1 || width < 1 || width > rows ||
      elem_bytes < 1 || timeout_ns < 1)
    return cudaErrorInvalidValue;
  const long long row_bytes = (long long)cols * chans * elem_bytes;
  const long long nbf = 6LL * batch;
  if (nbf * width * row_bytes > cap) return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cs_band_xchg_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // a block per 64 KB of each slab, up to one per SM
  const long long want = (nbf * width * row_bytes + 65535) / 65536;
  const int grid = (int)(want < sms ? want : sms);
  Ring r;
  r.me = static_cast<char*>(me);
  r.right = static_cast<char*>(right);
  r.left = static_cast<char*>(left);
  r.cap = cap;
  r.epoch = epoch;
  r.sent = *sent + grid;
  r.timeout_ns = timeout_ns;
  r.diag = static_cast<long long*>(diag);
  r.rank = rank;
  r.kernel = 10;
  const char* xp = static_cast<const char*>(x);
  char* bp = static_cast<char*>(below);
  char* ap = static_cast<char*>(above);
  void* args[] = {&r, &xp, &bp, &ap, const_cast<long long*>(&nbf), &rows,
                  const_cast<long long*>(&row_bytes), &width};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cs_band_xchg_kernel),
                                    dim3(grid), dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) *sent = r.sent;
  return err;
}

const char* cs_band_xchg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
