// v0 TurboFSE decode for Hopper (sm_90a): the bit-granular tANS wire.
//
// Replaces finitestateentropy_tpu/turbo/kernels.py:_decode_kernel
// (turbo_fse_decode).  The output equals the numpy twin
// turbo/format.py:turbo_fse_decompress.
//
// One block of 1024 threads per group; thread k is lane k (row k>>7, column
// k&127).  Each lane runs one tANS chain over the 2048-entry table packed as
// base << 16 | nbBits << 8 | symbol, which the block keeps in shared memory
// (8 KiB).  Per step t = 4*t4 + p:
//   1. e = table[state & 2047] gives the step's symbol, nb and base;
//   2. the inclusive prefix of nb over the 1024 lanes in ascending order (a
//      warp shuffle scan, then a scan of the 32 warp totals after one
//      barrier) places the lane's field: it starts at bit off = cursor -
//      prefix and holds nb bits (fields are read LIFO from csize_bits down,
//      lanes ascending within a step).  The TPU kernel took the prefix from
//      a bf16 matmul and scalar row offsets;
//   3. the two u32 stream words at off >> 5 and (off >> 5) + 1, read as one
//      64-bit value shifted right by off & 31 (no shift by 32 when the field
//      starts on a word boundary), masked to nb bits (nb = 0 gives 0), give
//      state = base + bits; the cursor drops by the step's total;
//   4. four steps' symbols pack into one output word, byte p at bit 8p.
// The last step of the last supercycle reads no bits (the encoder seeds
// those symbols for free).  The initial state is init & 2047.  err is the
// final cursor itself, 0 on a well-formed stream, as the TPU kernel's
// trailer row carries it.  Word indices clamp into the group's buffer, so a
// corrupt stream, whose cursor may go negative, reads in bounds; on a
// well-formed stream the TPU kernel's 8-row window never clamps (wrows_for
// leaves 16 rows of slack), so the direct read equals it bit for bit.  The
// warp-total buffer is double-buffered and flips every step, so one barrier
// per step suffices.
//
// What bounds it: each step is a shared table load, a 1024-thread barrier
// and a dependent stream load, so a group's 4*t4_count steps form a latency
// chain (1028 steps for 1 MiB + 4 KiB of padding); bytes moved are about
// the compressed size plus the output.  One block per group leaves SMs idle
// when a batch has fewer groups than the card has SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;
constexpr int kTable = 2048;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kLanes)
turbo_fse_decode(const int32_t* __restrict__ csize_bits,
                 const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ init,
                 const uint32_t* __restrict__ stream, int stream_words,
                 int32_t* __restrict__ out, int32_t* __restrict__ err,
                 int t4_count) {
  __shared__ uint32_t tbl[kTable];
  __shared__ int warp_tot[2][32];

  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  for (int i = k; i < kTable; i += kLanes)
    tbl[i] = static_cast<uint32_t>(tables[static_cast<size_t>(g) * kTable + i]);

  const uint32_t* words = stream + static_cast<size_t>(g) * stream_words;
  int32_t* o = out + static_cast<size_t>(g) * t4_count * kLanes + k;
  uint32_t state = static_cast<uint32_t>(init[static_cast<size_t>(g) * kLanes + k]);
  int cursor = csize_bits[g];
  int buf = 0;
  __syncthreads();

  for (int t4 = 0; t4 < t4_count; ++t4) {
    uint32_t word = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t e = tbl[state & (kTable - 1)];
      word |= (e & 0xFFu) << (8 * p);
      if (p == 3 && t4 == t4_count - 1) break;   // the last step reads no bits
      const int nb = static_cast<int>((e >> 8) & 0xFu);
      int incl = nb;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31) warp_tot[buf][w] = incl;
      __syncthreads();
      int wsum = warp_tot[buf][lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, wsum, d);
        if (lane >= d) wsum += v;
      }
      const int before = __shfl_sync(kFull, wsum, (w + 31) & 31);
      const int total = __shfl_sync(kFull, wsum, 31);
      const int off = cursor - ((w ? before : 0) + incl);
      const int wi = off >> 5;                    // floor, also when off < 0
      const uint64_t pair =
          (static_cast<uint64_t>(words[clamp_index(wi + 1, stream_words)]) << 32) |
          words[clamp_index(wi, stream_words)];
      const uint32_t bits =
          static_cast<uint32_t>(pair >> (off & 31)) & ((1u << nb) - 1u);
      state = (e >> 16) + bits;
      cursor -= total;
      buf ^= 1;
    }
    o[static_cast<size_t>(t4) * kLanes] = static_cast<int32_t>(word);
  }
  if (k == 0) err[g] = cursor;
}

}  // namespace

// csize_bits: [G] i32; tables: [G, 2048] i32 (base << 16 | nb << 8 | sym);
// init: [G, 1024] i32 (the states, masked to 11 bits here); stream: [G,
// stream_words] u32 payload words, zero past the payload; out: [G,
// t4_count*1024] i32, four bytes per word; err: [G] i32, the final cursor.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int turbo_fse_decode_launch(const void* csize_bits,
                                       const void* tables, const void* init,
                                       const void* stream, int stream_words,
                                       void* out, void* err, int groups,
                                       int t4_count, void* cuda_stream) {
  if (t4_count < 1 || stream_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  turbo_fse_decode<<<groups, kLanes, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(csize_bits), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(init), static_cast<const uint32_t*>(stream),
      stream_words, static_cast<int32_t*>(out), static_cast<int32_t*>(err),
      t4_count);
  return static_cast<int>(cudaGetLastError());
}
