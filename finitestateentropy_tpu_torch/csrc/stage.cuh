// Staging a group's stream into shared memory with cp.async, shared by the
// decode kernels (rans_decode.cu, rans_decode_flat.cu, turbo_fse_decode.cu,
// fse_decode.cu, huf_decode.cu), and the SM count the compat kernels size
// their launches by.
//
// ChunkRing is the flat-rank decodes' stream cache.  Those wires ship no
// per-step cursors (v1, v0) or ship them but may lie about them (totals), so
// a batch's window is not known before the batch runs; what is known is how
// far a batch can move the cursor: at most K steps of one refill (v1,
// totals) or of 15 bits (v0) per lane.  The ring holds the stream by absolute
// position in chunks of C elements, chunk c in slot c & 3, and is filled one
// chunk at a time, one batch ahead, from the top of the stream down: when a
// batch starts at cursor c, the next batch reads nothing below c - 2C, so
// the chunk below the lowest fetched one is fetched when c - 2C reaches it.
// With C >= the most a batch can read, a batch reads at most chunks
// lo..lo+2, while the fetch in flight fills the slot of lo+3 (lo-1).  The
// fetch is issued after the batch's first block barrier, when no warp still
// reads the batch before, and waited for before the next batch's first one.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stage {

// the current device's SM count, read once
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// cp_async16 only where p holds (a predicate, no branch)
__device__ __forceinline__ void cp_async16_if(bool p, void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n"
      "\t@q cp.async.cg.shared.global [%1], [%2], 16;\n\t}\n" ::"r"(static_cast<int>(p)),
      "r"(d), "l"(src)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread committed has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but this thread's N most recent commit groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n16 16-byte units from src to dst (both 16-byte aligned), spread over the
// block's threads.
__device__ __forceinline__ void copy16(void* dst, const void* src, int n16,
                                       int tid, int nthreads) {
  for (int i = tid; i < n16; i += nthreads)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

__device__ __forceinline__ int clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The ring of 4 chunks of 2^LOG_C elements of type E over a stream of n
// elements (n and the stream's address 16-byte multiples).  lo..top are the
// chunks fetched so far; every thread of the block holds the same lo and
// top, and calls start and advance together.
template <typename E, int LOG_C>
struct ChunkRing {
  static constexpr int C = 1 << LOG_C;
  static constexpr int kPerUnit = 16 / static_cast<int>(sizeof(E));
  E* buf;          // 4*C elements of shared memory
  const E* src;
  int n;
  int lo, top;

  __device__ __forceinline__ void fetch(int c, int tid, int nthreads) {
    const int first = c << LOG_C;
    const int len = n - first < C ? n - first : C;
    copy16(buf + (c & 3) * C, src + first, len / kPerUnit, tid, nthreads);
  }

  // Fetches the chunk holding element `top_elem` (clamped into the stream)
  // and the one below it, and commits them: what the first batch reads.
  __device__ __forceinline__ void start(int top_elem, int tid, int nthreads) {
    top = top_elem >> LOG_C;
    lo = top > 0 ? top - 1 : 0;
    for (int c = lo; c <= top; ++c) fetch(c, tid, nthreads);
    cp_async_commit();
  }

  // One batch ahead: fetches and commits the chunk below lo when the next
  // batch may read from element `low_elem` (clamped) down.
  __device__ __forceinline__ void advance(int low_elem, int tid, int nthreads) {
    if (lo > (low_elem >> LOG_C)) {
      fetch(--lo, tid, nthreads);
      cp_async_commit();
    }
  }

  // element i (clamped into the stream) if its chunk is resident
  __device__ __forceinline__ E at(int i) const { return buf[i & (4 * C - 1)]; }
};

}  // namespace stage
