// A host function called from inside a CUDA graph's conditional bodies, for
// Hopper (sm_90a): the host crossing of a host likelihood on the device run
// loop, through a mailbox in mapped pinned memory.
//
// Replaces: JAX's host callback of `host_likelihood=True`
// (tempest_tpu/utils/wrappers.py:88-131: `jax.pure_callback`, or
// `io_callback` where object blobs make the call a side effect), which XLA
// runs inside its one device program, in the body of the MCMC while_loop and
// of the run loop (tempest_tpu/fused.py:365-456). It is not a Pallas kernel.
// Its plain version, the route of CPU tensors, is
// tempest_tpu_torch/utils/wrappers.py's `HostLikelihood.plain`: one blocking
// read of the points and the step's `active` flag, the host call, a copy
// back.
//
// Why a kernel and not a graph host node: CUDA takes kernel, memset, memcpy,
// child-graph and conditional nodes in a conditional node's body, and on the
// card (CUDA runtime 12.9, driver 13.0) it captures a host function in a
// WHILE body but refuses to instantiate the graph (scripts/capture_probe.py
// --host-node). A kernel node may touch any memory the device can reach, so
// the crossing is two kernel nodes around a mailbox that both sides see:
//
//  - tempest_host_alloc(bytes, &host, &device) allocates the mailbox with
//    cudaHostAlloc(cudaHostAllocMapped | cudaHostAllocPortable), zeroed, and
//    gives both addresses; tempest_host_free(host) frees it. The layout
//    (tempest_tpu_torch/ops/cuda_host.py): a 128-byte header (the request
//    sequence at byte 0, written by the device; the reply sequence at 64
//    and the status at 72, written by the host), the points (N x d of the
//    run's type), logl (N float32) and the blob rows (N x B of their type),
//    each region at a multiple of 128 bytes.
//  - tempest_host_call(stream, ...) launches, on `stream`, where the 0-d bool
//    `active` holds (a null `active` always; an inactive step launches the
//    two kernels, and they return at once: no copy, no handshake):
//     1. post: a grid copies the points into the mailbox with 16-byte
//        stores where both ends are 16-byte aligned (whole lines cross the
//        link; 4-byte words otherwise and for the tail), each thread ending
//        with __threadfence_system(). The CTA that arrives last (a device
//        word counts the arrivals) makes the handshake: the next sequence
//        number s from a device word (`counter[0]`, this mailbox's requests
//        so far), s stored to the request word with release semantics at
//        system scope, then an acquire load of the reply word at system
//        scope until it reads s (__nanosleep 64 ns, doubled to at most 512);
//        a nonzero status (the host function raised) sets the device word
//        `failed`, which the predicates of the WHILE nodes around the call
//        AND in, so the replay ends within one step. Folding the handshake
//        into the post saves a node's launch and the second fence.
//     2. fetch: a grid reads logl and the blob rows from the mailbox with
//        16-byte relaxed loads at system scope (nothing stale from a cache)
//        into the caller's buffers where they are 16-byte aligned, logl
//        converted to the run's type; an inactive step leaves them as they
//        are (the wrapper fills them with the walkers' rows first), so
//        nothing runs after the call on the host's side.
//    Sequence numbers, not flags: the host serves a request where the
//    request word differs from the reply word and answers with that number,
//    so a word a past replay left means nothing. Outside a graph the caller
//    queues nothing after the call until it has ended: a kernel loaded
//    lazily, or a new CUDA allocation, waits for the device, which waits
//    for the host (so tempest_host_alloc loads the kernels).
//    The host side (ops/cuda_host.py `served`) runs on the thread that
//    replays the graph: it launches the work, then polls every mailbox's
//    request and reply words and an event's query of the work's end, and
//    answers a request by calling the host function and writing logl, the
//    blob rows, the status and then the reply word (x86 keeps stores in
//    order). It makes no blocking CUDA call while the graph runs: the
//    kernel would wait on it.
//
// `stamps`, where not null, takes %globaltimer (ns) marks of each request in
// a ring of kRing slots of four: the post's end (every CTA arrived), the
// request stored, the reply seen and the fetch's end (the last CTA's); the
// host's marks are cuda_host.py's. They split a handshake (chip_smoke.py
// phase 4j).
//
// What bounds it on this card: the host link and the round trip, not the
// device. Its bytes are the points out and logl (and the blob rows) in,
// at the link's rated rate (PCIe Gen5 x16, 64 GB/s each way); the round
// trip is a system-scope store seen by the host's poll and its reply seen
// by the kernel's poll. tempest_host_pingpong(rounds, &ms) measures that
// round trip alone: one kernel makes `rounds` exchanges with a host C
// thread that spins on the request word and writes the reply, timed by
// CUDA events.
// The device does nothing else meanwhile: the body waits for the
// likelihood, as XLA's program waits for its callback.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <thread>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;
constexpr unsigned long long kRing = 64;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_relaxed_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint4 load_relaxed_sys_v4(const uint4* p) {
  uint4 v;
  asm volatile("ld.relaxed.sys.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_relaxed_sys_u8(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.sys.global.u8 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Store `seq` to the request word (release, system scope), then wait until
// the reply word reads `seq` (acquire, system scope; __nanosleep between
// loads, 64 ns doubled to at most 512).
__device__ __forceinline__ void exchange(unsigned long long* request,
                                         const unsigned long long* reply,
                                         unsigned long long seq) {
  store_release_sys(request, seq);
  unsigned ns = 64;
  while (load_acquire_sys(reply) != seq) {
    __nanosleep(ns);
    if (ns < 512) ns *= 2;
  }
}

__device__ __forceinline__ bool skipped(const bool* active) {
  return active != nullptr && !*active;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// counter[0]: the requests made; counter[1]: the post's CTAs arrived.
__global__ void __launch_bounds__(kThreads)
    post_kernel(const bool* active, const uint32_t* __restrict__ x, uint32_t* box_x,
                long long x_bytes, unsigned long long* counter, unsigned long long* request,
                const unsigned long long* reply, const uint32_t* status, int* failed,
                unsigned long long* stamps) {
  if (skipped(active)) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long lines = aligned16(x) && aligned16(box_x) ? x_bytes / 16 : 0;
  const uint4* x16 = reinterpret_cast<const uint4*>(x);
  uint4* box16 = reinterpret_cast<uint4*>(box_x);
  for (long long i = first; i < lines; i += stride) box16[i] = x16[i];
  for (long long i = 4 * lines + first; i < x_bytes / 4; i += stride) box_x[i] = x[i];
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (atomicAdd(counter + 1, 1ull) != gridDim.x - 1) return;
  // the last CTA: every CTA's points are out
  counter[1] = 0;
  __threadfence_system();
  const unsigned long long seq = counter[0] + 1;
  counter[0] = seq;
  unsigned long long* mark = stamps == nullptr ? nullptr : stamps + 4 * ((seq - 1) % kRing);
  if (mark) mark[0] = now_ns();
  store_release_sys(request, seq);
  if (mark) mark[1] = now_ns();
  unsigned ns = 64;
  while (load_acquire_sys(reply) != seq) {
    __nanosleep(ns);
    if (ns < 512) ns *= 2;
  }
  if (mark) mark[2] = now_ns();
  if (load_relaxed_sys(status) != 0) *failed = 1;
}

// The round trip alone: `rounds` exchanges, sequence numbers 1..rounds.
__global__ void pingpong_kernel(unsigned long long* request, const unsigned long long* reply,
                                int rounds) {
  __threadfence_system();
  for (int r = 1; r <= rounds; ++r) exchange(request, reply, static_cast<unsigned long long>(r));
}

__global__ void __launch_bounds__(kThreads)
    fetch_kernel(const bool* active, const uint32_t* box_logl, void* __restrict__ logl,
                 int logl_f64, long long n, const uint8_t* box_blobs,
                 uint8_t* __restrict__ blobs, long long blob_bytes,
                 const unsigned long long* counter, unsigned long long* stamps) {
  if (skipped(active)) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // logl: four values a 16-byte load (the mailbox's region is aligned)
  const long long quads = aligned16(logl) ? n / 4 : 0;
  const uint4* box_quads = reinterpret_cast<const uint4*>(box_logl);
  for (long long i = first; i < quads; i += stride) {
    const uint4 v = load_relaxed_sys_v4(box_quads + i);
    const float4 f = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                 __uint_as_float(v.z), __uint_as_float(v.w));
    if (logl_f64) {
      double2* out = static_cast<double2*>(logl) + 2 * i;
      out[0] = make_double2(f.x, f.y);
      out[1] = make_double2(f.z, f.w);
    } else {
      static_cast<float4*>(logl)[i] = f;
    }
  }
  for (long long i = 4 * quads + first; i < n; i += stride) {
    const float v = __uint_as_float(load_relaxed_sys(box_logl + i));
    if (logl_f64) {
      static_cast<double*>(logl)[i] = static_cast<double>(v);
    } else {
      static_cast<float*>(logl)[i] = v;
    }
  }
  // the blob rows: 16 bytes a load where the caller's buffer is aligned,
  // then the tail a byte at a time
  const long long chunks = aligned16(blobs) ? blob_bytes / 16 : 0;
  const uint4* box_chunks = reinterpret_cast<const uint4*>(box_blobs);
  uint4* out_chunks = reinterpret_cast<uint4*>(blobs);
  for (long long i = first; i < chunks; i += stride) {
    out_chunks[i] = load_relaxed_sys_v4(box_chunks + i);
  }
  for (long long b = 16 * chunks + first; b < blob_bytes; b += stride) {
    blobs[b] = static_cast<uint8_t>(load_relaxed_sys_u8(box_blobs + b));
  }
  if (stamps != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(stamps + 4 * ((counter[0] - 1) % kRing) + 3, now_ns());
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

extern "C" int tempest_host_alloc(long long bytes, void* host_out, void* device_out) {
  if (bytes <= 0) return cudaErrorInvalidValue;
  // Load the kernels now: loaded lazily at its first launch, the fetch
  // kernel's load could wait for the device while the handshake spins.
  cudaFuncAttributes attributes;
  const void* kernels[] = {reinterpret_cast<const void*>(post_kernel),
                           reinterpret_cast<const void*>(fetch_kernel)};
  for (const void* kernel : kernels) {
    cudaError_t loaded = cudaFuncGetAttributes(&attributes, kernel);
    if (loaded != cudaSuccess) return loaded;
  }
  void* host = nullptr;
  cudaError_t err = cudaHostAlloc(&host, static_cast<size_t>(bytes),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  memset(host, 0, static_cast<size_t>(bytes));
  void* device = nullptr;
  err = cudaHostGetDevicePointer(&device, host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(host);
    return err;
  }
  *static_cast<void**>(host_out) = host;
  *static_cast<void**>(device_out) = device;
  return cudaSuccess;
}

extern "C" int tempest_host_free(void* host) { return cudaFreeHost(host); }

// One host call: the two kernels above on `stream`. `box` is the mailbox's
// device address; `x_offset`, `logl_offset` and `blobs_offset` its regions'
// byte offsets (the header at 0; multiples of 16). `x` holds `x_bytes` bytes
// (a multiple of 4), `logl` n float32 (double where `logl_f64`), written
// from the reply's float32, `blobs` `blob_bytes` bytes (none when 0), both
// written only where the step is active; `active` a device bool or null;
// `counter` two device uint64 (zero at first), `failed` a device int32,
// `stamps` null or 4 kRing device uint64.
extern "C" int tempest_host_call(void* stream_ptr, const void* active, const void* x,
                                 long long x_bytes, void* box, long long x_offset,
                                 long long logl_offset, long long blobs_offset, void* logl,
                                 int logl_f64, long long n, void* blobs, long long blob_bytes,
                                 void* counter, void* failed, void* stamps) {
  if (x_bytes <= 0 || x_bytes % 4 != 0 || n <= 0 || blob_bytes < 0) return cudaErrorInvalidValue;
  if (x_offset % 16 || logl_offset % 16 || blobs_offset % 16) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool* flag = static_cast<const bool*>(active);
  uint8_t* base = static_cast<uint8_t*>(box);
  unsigned long long* count = static_cast<unsigned long long*>(counter);
  unsigned long long* marks = static_cast<unsigned long long*>(stamps);
  post_kernel<<<blocks_for(x_bytes / 16), kThreads, 0, stream>>>(
      flag, static_cast<const uint32_t*>(x), reinterpret_cast<uint32_t*>(base + x_offset),
      x_bytes, count, reinterpret_cast<unsigned long long*>(base),
      reinterpret_cast<const unsigned long long*>(base + 64),
      reinterpret_cast<const uint32_t*>(base + 72), static_cast<int*>(failed), marks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long items = n / 4 > blob_bytes / 16 ? n / 4 : blob_bytes / 16;
  fetch_kernel<<<blocks_for(items), kThreads, 0, stream>>>(
      flag, reinterpret_cast<const uint32_t*>(base + logl_offset), logl, logl_f64, n,
      base + blobs_offset, static_cast<uint8_t*>(blobs), blob_bytes, count, marks);
  return cudaGetLastError();
}

// The link's round trip (ms an exchange) into `*ms_out`: a mapped mailbox of
// its own, `pingpong_kernel` making `rounds` exchanges on a stream of its
// own between two CUDA events, and a host thread answering each request as
// soon as its spin on the request word sees it (no sleep, no Python). The
// calling thread waits on the end event.
extern "C" int tempest_host_pingpong(int rounds, float* ms_out) {
  if (rounds <= 0) return cudaErrorInvalidValue;
  void* host = nullptr;
  cudaError_t err = cudaHostAlloc(&host, 128, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  memset(host, 0, 128);
  void* device = nullptr;
  cudaStream_t stream = nullptr;
  cudaEvent_t start = nullptr, stop = nullptr;
  std::atomic<bool> quit(false);
  volatile unsigned long long* words = static_cast<volatile unsigned long long*>(host);
  std::thread server([&]() {
    for (unsigned long long s = 1; s <= static_cast<unsigned long long>(rounds); ++s) {
      while (words[0] != s) {
        if (quit.load(std::memory_order_relaxed)) return;
      }
      std::atomic_thread_fence(std::memory_order_seq_cst);
      words[8] = s;  // the reply word, byte 64
    }
  });
  err = cudaHostGetDevicePointer(&device, host, 0);
  if (err == cudaSuccess) err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = cudaEventCreate(&start);
  if (err == cudaSuccess) err = cudaEventCreate(&stop);
  if (err == cudaSuccess) err = cudaEventRecord(start, stream);
  if (err == cudaSuccess) {
    unsigned long long* base = static_cast<unsigned long long*>(device);
    pingpong_kernel<<<1, 1, 0, stream>>>(base, base + 8, rounds);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = cudaEventRecord(stop, stream);
  if (err == cudaSuccess) err = cudaEventSynchronize(stop);
  if (err != cudaSuccess) quit.store(true);
  server.join();
  float ms = 0.0f;
  if (err == cudaSuccess) err = cudaEventElapsedTime(&ms, start, stop);
  if (err == cudaSuccess) *ms_out = ms / static_cast<float>(rounds);
  if (start) cudaEventDestroy(start);
  if (stop) cudaEventDestroy(stop);
  if (stream) cudaStreamDestroy(stream);
  cudaFreeHost(host);
  return err;
}
