// v0 TurboFSE decode for Hopper (sm_90a): the bit-granular tANS wire.
//
// Replaces finitestateentropy_tpu/turbo/kernels.py:_decode_kernel
// (turbo_fse_decode).  The output equals the numpy twin
// turbo/format.py:turbo_fse_decompress.
//
// The function.  Each of a group's 1024 lanes (row k>>7, column k&127) runs
// one tANS chain over the 2048-entry table packed as base << 16 | nbBits << 8
// | symbol.  Per step t = 4*t4 + p:
//   1. e = table[state & 2047] gives the step's symbol, nb and base;
//   2. the inclusive prefix of nb over the 1024 lanes in ascending order
//      places the lane's field: it starts at bit off = cursor - prefix and
//      holds nb bits (fields are read LIFO from csize_bits down, lanes
//      ascending within a step).  The TPU kernel took the prefix from a bf16
//      matmul and scalar row offsets;
//   3. the two u32 stream words at off >> 5 and (off >> 5) + 1 (floored, and
//      clamped into the group's buffer, so a corrupt stream, whose cursor may
//      go negative, reads in bounds), read as one 64-bit value shifted right
//      by off & 31 (no shift by 32 when the field starts on a word
//      boundary), masked to nb bits (nb = 0 gives 0), give state = base +
//      bits; the cursor drops by the step's total;
//   4. four steps' symbols pack into one output word, byte p at bit 8p.
// The last step of the last supercycle reads no bits (the encoder seeds
// those symbols for free).  The initial state is init & 2047.  err is the
// final cursor itself, 0 on a well-formed stream, as the TPU kernel's
// trailer row carries it.
//
// The design.  One block of 8 warps per group, one warp per 128-lane row;
// thread i of warp w holds the four contiguous lanes w*128 + 4i .. +3, so
// the lane's prefix within the row is a local sum plus the exclusive warp
// prefix of the threads' sums (six ballots of the sum's bits and their
// popcounts: no dependent shuffle chain), and the four output bytes words
// are one 16-byte store.  The rows' totals meet in a double-buffered [2][8]
// array behind one 256-thread barrier a step.  The stream is staged in a
// ring of four 4096-word chunks (stage.cuh: ChunkRing), fetched with
// cp.async one 8-step batch ahead: nb is a 4-bit field, so a step moves the
// cursor by at most 1024*15 bits and a batch starting at cursor c reads
// words inside [(c - 8*15360) >> 5, ((c - 1) >> 5) + 1], at most 3842
// words.  The cursor is the kernel's own chain, so no read leaves the
// fetched chunks, and a corrupt stream's clamped indices land in them too.
// The cursor runs in 64 bits (as the plain version's does) and is clamped,
// keeping its residue mod 32, to a range that gives every field the same
// clamped words and shift.
//
// What bounds it on the H100: each step waits on a shared table read, the
// ballots, the 256-thread exchange of the row totals and the shared stream
// reads (chip_smoke.py's chain), so a group's 4*t4_count steps form one
// chain (1028 steps for 1 MiB + 4 KiB of padding); one block per group
// leaves SMs idle when a batch has fewer groups than the card has SMs.
// Bytes moved are about the compressed size plus the output.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "stage.cuh"

namespace {

using stage::clamp;

constexpr int kLanes = 1024;
constexpr int kTable = 2048;
constexpr int kChains = 4;                // contiguous lanes a thread
constexpr int kWarps = kLanes / (32 * kChains);
constexpr int kThreads = 32 * kWarps;
// bits of a thread's nb sum (<= 15 * kChains)
constexpr int kSumBits = kChains == 1 ? 4 : kChains == 2 ? 5 : kChains == 4 ? 6 : 7;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBatch = 8;                 // steps per ring advance
constexpr int kStepBits = 15 * kLanes;    // the most bits a step reads
constexpr int kLogChunk = 12;             // 4096 words
using Ring = stage::ChunkRing<uint32_t, kLogChunk>;
static_assert(Ring::C >= kBatch * kStepBits / 32 + 2, "a batch's words fit a chunk");
static_assert(kWarps % 4 == 0 && kWarps <= 32, "the exchange reads the totals as int4");
constexpr int kRingBytes = 4 * Ring::C * static_cast<int>(sizeof(uint32_t));
constexpr int kLow = -(1 << 16);          // cursor clamp, multiples of 32

// The cursor clamped into [kLow, high] with its residue mod 32 kept: below
// kLow every field reads word 0 twice, above high the last word twice.
__device__ __forceinline__ int clamp_cursor(long long c, int high) {
  const int r = static_cast<int>(c & 31);
  return c < kLow ? kLow + r : (c > high ? high + r : static_cast<int>(c));
}

// kChains i32 at p, one vector access (p aligned to kChains words)
__device__ __forceinline__ void load_lanes(const int32_t* p, uint32_t* v) {
  if constexpr (kChains == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (kChains == 2) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    for (int j = 0; j < kChains; ++j) v[j] = p[j];
  }
}

__device__ __forceinline__ void store_lanes(int32_t* p, const uint32_t* v) {
  if constexpr (kChains == 4)
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  else if constexpr (kChains == 2)
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  else
    for (int j = 0; j < kChains; ++j) p[j] = v[j];
}

__global__ void __launch_bounds__(kThreads)
turbo_fse_decode(const int32_t* __restrict__ csize_bits,
                 const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ init,
                 const uint32_t* __restrict__ stream, int stream_words,
                 int32_t* __restrict__ out, int32_t* __restrict__ err,
                 int t4_count) {
  extern __shared__ __align__(16) uint32_t ring_buf[];
  __shared__ __align__(16) uint32_t tbl[kTable];
  __shared__ __align__(16) int cnt[2][kWarps];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int T = 4 * t4_count;
  const int last = stream_words - 1;
  const int high = (last + 2) * 32 + 16384;
  const unsigned lt_mask = (1u << lane) - 1u;          // lanes < lane

  long long cursor = csize_bits[g];
  stage::copy16(tbl, tables + static_cast<size_t>(g) * kTable, kTable / 4, tid,
                kThreads);
  Ring ring{ring_buf, stream + static_cast<size_t>(g) * stream_words, stream_words,
            0, 0};
  // the top word a batch at cursor c reads: ((c - 1) >> 5) + 1
  ring.start(clamp(((clamp_cursor(cursor, high) - 1) >> 5) + 1, 0, last), tid,
             kThreads);

  uint32_t state[kChains];
  load_lanes(init + static_cast<size_t>(g) * kLanes + kChains * tid, state);
  int32_t* o = out + static_cast<size_t>(g) * t4_count * kLanes + kChains * tid;
  stage::cp_async_wait_all();
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += kBatch) {
    // the lowest word the next batch may read
    const int low = clamp((clamp_cursor(cursor, high) - 2 * kBatch * kStepBits) >> 5, 0, last);
    uint32_t word[kChains] = {};
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int t = t0 + s;
      if (t >= T) break;                       // uniform; T is a multiple of 4
      const int p = s & 3;
      uint32_t e[kChains];
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        e[j] = tbl[state[j] & (kTable - 1)];
        word[j] |= (e[j] & 0xFFu) << (8 * p);
      }
      if (t + 1 < T) {                         // the last step reads no bits
        int q[kChains];                        // inclusive prefix over the thread's lanes
        int sum = 0;
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
          sum += static_cast<int>((e[j] >> 8) & 0xFu);
          q[j] = sum;
        }
        // the warp's exclusive prefix and total of sum
        int excl = 0, wtot = 0;
#pragma unroll
        for (int b = 0; b < kSumBits; ++b) {
          const unsigned bb = __ballot_sync(kFull, (sum >> b) & 1);
          excl += __popc(bb & lt_mask) << b;
          wtot += __popc(bb) << b;
        }
        if (lane == 0) cnt[s & 1][w] = wtot;
        if (s == 0) stage::cp_async_wait_all();   // the last batch's chunk is in
        __syncthreads();
        // every warp is past the last batch: the next batch's chunk may land
        if (s == 0) ring.advance(low, tid, kThreads);
        int below = 0, total = 0;
#pragma unroll
        for (int k = 0; k < kWarps / 4; ++k) {
          const int4 c4 = reinterpret_cast<const int4*>(cnt[s & 1])[k];
          const int rt[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            below += 4 * k + r < w ? rt[r] : 0;
            total += rt[r];
          }
        }
        const int c = clamp_cursor(cursor, high);
        const int base = c - below - excl;
        // the field reads; in_stream: every field of the step starts in
        // [c - total, c] and both its words lie in the stream (a uniform
        // test), so no word index needs the clamp
        auto read = [&](auto in_stream) {
#pragma unroll
          for (int j = 0; j < kChains; ++j) {
            const int nb = static_cast<int>((e[j] >> 8) & 0xFu);
            const int off = base - q[j];
            const int wi = off >> 5;           // floor, also when off < 0
            const int i0 = decltype(in_stream)::value ? wi : clamp(wi, 0, last);
            const int i1 = decltype(in_stream)::value ? wi + 1 : clamp(wi + 1, 0, last);
            const uint64_t pair = (static_cast<uint64_t>(ring.at(i1)) << 32) | ring.at(i0);
            const uint32_t bits =
                static_cast<uint32_t>(pair >> (off & 31)) & ((1u << nb) - 1u);
            state[j] = (e[j] >> 16) + bits;
          }
        };
        if (c - total >= 0 && (c >> 5) + 1 <= last) read(std::true_type{});
        else read(std::false_type{});
        cursor -= total;
      }
      if (p == 3) {
        store_lanes(o + static_cast<size_t>(t >> 2) * kLanes, word);
#pragma unroll
        for (int j = 0; j < kChains; ++j) word[j] = 0u;
      }
    }
  }
  stage::cp_async_wait_all();
  if (tid == 0) err[g] = static_cast<int32_t>(cursor);   // as torch's int64 -> int32
}

}  // namespace

// csize_bits: [G] i32; tables: [G, 2048] i32 (base << 16 | nb << 8 | sym);
// init: [G, 1024] i32 (the states, masked to 11 bits here); stream: [G,
// stream_words] u32 payload words, zero past the payload (16-byte aligned,
// stream_words a multiple of 4, at most 2^24); out: [G, t4_count*1024] i32,
// four bytes per word; err: [G] i32, the final cursor.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int turbo_fse_decode_launch(const void* csize_bits,
                                       const void* tables, const void* init,
                                       const void* stream, int stream_words,
                                       void* out, void* err, int groups,
                                       int t4_count, void* cuda_stream) {
  if (t4_count < 1 || stream_words < 4 || stream_words % 4 ||
      stream_words > (1 << 24) || reinterpret_cast<uintptr_t>(stream) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      turbo_fse_decode, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  turbo_fse_decode<<<groups, kThreads, kRingBytes,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(csize_bits), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(init), static_cast<const uint32_t*>(stream),
      stream_words, static_cast<int32_t*>(out), static_cast<int32_t*>(err),
      t4_count);
  return static_cast<int>(cudaGetLastError());
}
