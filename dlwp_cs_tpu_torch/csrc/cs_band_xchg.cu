// The band-row halo exchange between ring neighbours, for Hopper (sm_90a),
// and the symmetric buffers it copies into.
//
// Replaces the TPU kernel dlwp_cs_tpu/parallel/rdma_halo.py::_kernel
// (band_exchange_rdma, #10): my top `w` rows to the +1 neighbour's `below`
// and my bottom `w` rows to the -1 neighbour's `above`, then a wait for both
// of mine.  On the TPU the two copies are DMAs over the inter-chip links;
// here they are stores of a kernel's threads into the neighbours' buffers,
// which CUDA IPC maps into this process (on one card, or over NVLink between
// the cards of one host).  The protocol is cs_band_proto.cuh's: a send
// kernel, the arrival signals and waits as stream memory operations, and an
// unpack kernel that copies my two received slots into the output tensors.
//
// What bounds it on this card: it moves B*6*w*n*C elements each way (at most
// a few MB at the flagship's shapes: under a microsecond of HBM traffic), so
// latency bounds it: two launches, two signal round trips through the GPU's
// front end and, where the ranks share one card, the switches between their
// contexts.  No thread waits for another rank, so a rank whose stream waits
// has nothing runnable and its context yields the card to the others; the
// first design (cs_band_xchg_v1_kernel, kept as a timing row) spun in one
// cooperative kernel and sat out the other ranks' time slices.
//
// The symmetric buffers: cs_sym_alloc takes one buffer from cudaMalloc (not
// from PyTorch's caching allocator, which sub-allocates: an IPC handle names
// a whole allocation) and exports it; cs_sym_open maps a peer's buffer from
// its handle; cs_sym_close and cs_sym_free undo them.  The host exchanges the
// handles over the process group, keeps the epochs and bounds the waits
// (dlwp_cs_tpu_torch/parallel/symmetric.py); cs_sym_side_read and
// cs_sym_side_write give its watchdog a stream of its own.  cs_sym_round and
// cs_sym_spin_round are the two sides of tools/xchg_probe.py.

#include <cuda_runtime.h>

#include <atomic>
#include <cstring>
#include <mutex>

#include "cs_band_proto.cuh"

namespace {

using namespace csband;

constexpr int THREADS = 256;
std::atomic<int> g_allocated{0}, g_opened{0};

// The first design, a timing row: one cooperative kernel that spins.
// x (B, 6, rows, cols, C) of `elem` bytes; below, above (B, 6, w, cols, C)
__global__ void __launch_bounds__(THREADS) cs_band_xchg_v1_kernel(
    Ring r, const char* __restrict__ x, char* __restrict__ below, char* __restrict__ above,
    long long nbf, int rows, long long row_bytes, int width) {
  barrier_and_send(r, x, nbf, rows, row_bytes, width);
  wait_arrivals(r, true, true);
  const long long chunk = (long long)width * row_bytes;
  copy_chunks(below, r.me + HEADER, chunk, chunk, nbf);
  copy_chunks(above, r.me + HEADER + r.cap, chunk, chunk, nbf);
}

// Step 6 of #10: my two received slots of the call's parity into the outputs.
__global__ void __launch_bounds__(THREADS) cs_band_unpack_kernel(
    char* __restrict__ below, char* __restrict__ above, const char* from_below,
    const char* from_above, long long nbf, long long chunk) {
  copy_chunks(below, from_below, chunk, chunk, nbf);
  copy_chunks(above, from_above, chunk, chunk, nbf);
}

// The probe's spinning round: one thread signals both neighbours' READY_*
// and spins until both of mine reach the epoch.
__global__ void cs_sym_spin_round_kernel(Ring r) {
  st_release_sys(counter(r.right, READY_FROM_LEFT), r.epoch);
  st_release_sys(counter(r.left, READY_FROM_RIGHT), r.epoch);
  if (wait_for(r, READY_FROM_LEFT, r.epoch)) wait_for(r, READY_FROM_RIGHT, r.epoch);
}

// A non-blocking stream per device for the host's watchdog, which may run
// while the caller's stream is held by a wait.
cudaError_t side_stream(int device, cudaStream_t* s) {
  static cudaStream_t streams[64] = {};
  static std::mutex lock;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && streams[device] == nullptr)
    err = cudaStreamCreateWithFlags(&streams[device], cudaStreamNonBlocking);
  *s = streams[device];
  return err;
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

// `bytes` of zeroed host memory, mapped for the device (the timeout record,
// the watchdog's tickets); its host address, which under unified addressing
// is also the address the device writes.
int cs_sym_host_alloc(long long bytes, void** host) {
  void* p = nullptr;
  cudaError_t err = cudaHostAlloc(&p, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  std::memset(p, 0, (size_t)bytes);
  void* dev = nullptr;
  err = cudaHostGetDevicePointer(&dev, p, 0);
  if (err == cudaSuccess && dev != p) err = cudaErrorNotSupported;
  if (err != cudaSuccess) {
    cudaFreeHost(p);
    return err;
  }
  *host = p;
  return cudaSuccess;
}

// 1 in *ok when `device` takes 64-bit stream memory operations
// (CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS), else 0.
int cs_sym_memops(int device, int* ok) { return memops_supported(device, ok); }

// Enqueue on `stream`: write `value` to the word at `addr`; hold the stream
// until the word at `addr` is >= `value`.
int cs_sym_write(void* addr, unsigned long long value, void* stream) {
  return stream_write(static_cast<cudaStream_t>(stream), addr, value);
}

int cs_sym_wait(void* addr, unsigned long long value, void* stream) {
  return stream_wait(static_cast<cudaStream_t>(stream), addr, value);
}

// On this process's side stream of `device`, and waiting for it: copy
// `bytes` from device memory `src` to host memory `dst`; write `value` to
// the word at `addr`.
int cs_sym_side_read(int device, const void* src, void* dst, long long bytes) {
  cudaStream_t s;
  cudaError_t err = side_stream(device, &s);
  if (err == cudaSuccess) err = cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return err;
}

int cs_sym_side_write(int device, void* addr, unsigned long long value) {
  cudaStream_t s;
  int err = side_stream(device, &s);
  if (!err) err = stream_write(s, addr, value);
  if (!err) err = cudaStreamSynchronize(s);
  return err;
}

// The probe's rounds on the current stream: write the epoch into both
// neighbours' READY_* and wait until both of mine reach it, as stream memory
// operations (cs_sym_round) or in a one-thread kernel that spins
// (cs_sym_spin_round, bounded as the v1 kernels).
int cs_sym_round(void* me, void* right, void* left, unsigned long long epoch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = stream_write(s, counter(static_cast<char*>(right), READY_FROM_LEFT), epoch);
  if (!err) err = stream_write(s, counter(static_cast<char*>(left), READY_FROM_RIGHT), epoch);
  if (!err) err = stream_wait(s, counter(static_cast<char*>(me), READY_FROM_LEFT), epoch);
  if (!err) err = stream_wait(s, counter(static_cast<char*>(me), READY_FROM_RIGHT), epoch);
  return err;
}

int cs_sym_spin_round(void* me, void* right, void* left, unsigned long long epoch,
                      long long timeout_ns, void* diag, int rank, void* stream) {
  Ring r{};
  r.me = static_cast<char*>(me);
  r.right = static_cast<char*>(right);
  r.left = static_cast<char*>(left);
  r.epoch = epoch;
  r.timeout_ns = timeout_ns;
  r.diag = static_cast<long long*>(diag);
  r.rank = rank;
  r.kernel = 10;
  cs_sym_spin_round_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(r);
  return cudaGetLastError();
}

// Kernel #10 on the current stream: steps 1-7 of cs_band_proto.cuh.  x (B,
// 6, rows, cols, C) of elem_bytes each, contiguous; below and above (B, 6,
// width, cols, C).  me, right, left: my buffer and the neighbours' (mapped);
// cap: bytes of each slot (>= B*6*width*cols*C*elem_bytes); consumed: the
// last epoch that used this epoch's parity (0: none); ticket: the
// host-mapped word written with ticket_value once the arrival waits have
// passed; lag_ns: a hold of the stream before the unpack (0 but in tests).
// Returns a cudaError_t, or MEMOP_ERROR + a CUresult (0 = success).
int cs_band_xchg_launch(int device, const void* x, void* below, void* above, void* me,
                        void* right, void* left, long long cap, int batch, int rows,
                        int cols, int chans, int width, int elem_bytes,
                        unsigned long long epoch, unsigned long long consumed, void* ticket,
                        unsigned long long ticket_value, long long lag_ns, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || chans < 1 || width < 1 || width > rows ||
      elem_bytes < 1 || epoch < 1)
    return cudaErrorInvalidValue;
  const long long row_bytes = (long long)cols * chans * elem_bytes;
  const long long nbf = 6LL * batch;
  const long long chunk = (long long)width * row_bytes;
  if (nbf * chunk > cap) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return cerr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Call c{static_cast<char*>(me), static_cast<char*>(right), static_cast<char*>(left), cap,
               epoch, consumed, static_cast<unsigned long long*>(ticket), ticket_value};
  int err = enqueue_send(c, static_cast<const char*>(x), nbf, rows, row_bytes, width, sms, s);
  if (!err) err = enqueue_arrivals(c, true, true, s);
  if (!err) err = enqueue_lag(lag_ns, s);
  if (err) return err;
  const long long units = chunk * nbf / copy_unit(below, c.my_slot(false), chunk, chunk);
  const long long want = (units + THREADS - 1) / THREADS;
  const int grid = (int)(want < 4LL * sms ? want : 4LL * sms);
  cs_band_unpack_kernel<<<grid, THREADS, 0, s>>>(static_cast<char*>(below),
                                                 static_cast<char*>(above), c.my_slot(false),
                                                 c.my_slot(true), nbf, chunk);
  err = cudaGetLastError();
  if (!err) err = enqueue_consumed(c, s);
  return err;
}

// The first design of #10, a timing row (parallel/rdma_halo.py::
// band_exchange_rdma_v1), on a buffer of its own: one cooperative kernel
// whose threads spin on the counters.  *sent: my SENT target before the
// call, raised by the grid; timeout_ns, diag, rank: the bound of its waits
// and the record a wait that runs out writes.
int cs_band_xchg_v1_launch(int device, const void* x, void* below, void* above, void* me,
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cs_band_xchg_v1_kernel,
                                                        THREADS, 0);
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
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cs_band_xchg_v1_kernel),
                                    dim3(grid), dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) *sent = r.sent;
  return err;
}

const char* cs_band_xchg_error_string(int err) { return error_string(err); }

}  // extern "C"
