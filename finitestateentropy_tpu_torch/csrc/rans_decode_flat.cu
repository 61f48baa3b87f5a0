// TurboRANS decode for Hopper (sm_90a) with the rank taken over all 1024
// lanes of a group: the v1 wire (no section) and the totals wire
// (FLAG_TOTALS, one shipped total per step).
//
// Replaces finitestateentropy_tpu/turbo/rans_kernels.py:_rans_decode_kernel
// (rans_decode: v1 frames of ratio mode, v1 pair and the U16 codec's ratio
// frames), _rans_decode_v2t_kernel (rans_decode_v2 with [G,T] steptots) and
// the totals mode of _rans_decode_w_kernel (rans_decode_w with [G,T]
// steptots, :1380-1389).
//
// The function.  Per step t = SPC*t4 + p and lane k (row k>>7, column
// k&127), rans_step.cuh advances the state x by one table lookup and gives
// the step's value (byte, pair LUT value, u16 symbol), packed at bit
// 32/SPC*p of the output word; then
//   if x < 2^16: x = (x << 16) | stream_hw[cursor - rank]
// with rank the lane's inclusive rank among all flagged lanes of the group,
// row-major.  The cursor:
//   v1      starts at csize_hw and drops by each step's total, so the chain
//           needs the step's group-wide total;
//   totals  cursors[t], precomputed from the shipped totals outside the
//           kernel (as the JAX wrappers do outside Pallas, :1253-1255).
// Every stream index is clamped into the group's buffer, so a corrupt frame
// cannot read out of bounds.  The kernel writes the residue x ^ 2^16 of
// every lane and the final cursor of each group (the JAX kernel's trailer
// tiles): a well-formed v1 stream ends with both zero, which the wrapper
// turns into err (the totals wire checks its cursors outside the kernel).
//
// The design.  One block of 16 warps per group, one warp per 64-lane half
// row: thread i of warp w holds lanes w*64 + j*32 + i, j = 0..1, two state
// chains (kChains; four chains in 8 warps, and eight in 4, measured
// slower: PERF.md).  The rank within the warp's lanes is two ballots (the
// popcount of the earlier ballot plus this one's below the thread), as in
// rans_decode.cu; the warps' counts meet in a double-buffered [2][16] array
// behind one 512-thread barrier a step, where lane r of every warp takes
// warp r's count and two warp reductions (__reduce_add_sync) give the count
// of the lanes before the warp's own and the step's total.  A step skips
// the per-lane index clamps when a uniform test finds its whole range in
// the stream.  The stream is
// staged in a ring of four 8192-halfword chunks (stage.cuh: ChunkRing),
// fetched with cp.async one 8-step batch ahead: a step refills at most 1024
// halfwords, so a batch starting at cursor c reads inside [c - 8192, c), and
// the next one above c - 16384.  The refill reads the ring.  On the v1
// wire the cursor is the kernel's own chain, so no read, corrupt frame or
// not, leaves the fetched chunks; on the totals wire a corrupt frame's
// shipped cursors can point anywhere, so a read outside the batch's
// resident chunks is redone after the refills, warp-uniformly, from global
// memory at the same clamped index, as the plain version reads it.  The batch's cursors are loaded one
// batch ahead into registers.  The v1 cursor runs in 64 bits (as the plain
// version's does) and is clamped before the position arithmetic to a range
// that clamps to the same stream index.
//
// Shared memory, sized per launch: the table (up to 16384 words, u16x at
// tableLog 13: 64 KiB) and the ring (64 KiB): at most 128 KiB.
//
// What bounds it on the H100: each step waits on a shared table read, a
// multiply-add with its ballot, the 512-thread exchange of the warp counts
// and a shared stream read (chip_smoke.py's chain); a group's T steps form
// one chain (1024 steps per 1 MiB group on the byte wire, 512 on pair and
// u16), and one block per group leaves SMs idle when a batch has fewer
// groups than the card has SMs.  With every warp of the block waiting at
// the barrier each step, the warps' latencies add rather than overlap: the
// exchange, the ring read and the table read were each a large share of a
// step in PERF.md's ablations.  Bytes moved are about the compressed size
// plus the output.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "rans_step.cuh"
#include "stage.cuh"

namespace {

using namespace rans_step;
using stage::clamp;

constexpr int kLanes = 1024;
constexpr int kChains = 2;                // state chains a thread
constexpr int kSpan = 32 * kChains;       // lanes a warp holds
constexpr int kWarps = kLanes / kSpan;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTable = 2 * 8192;       // u16x at tlog 13
constexpr int kBatch = 8;                 // steps per ring advance
constexpr int kLogChunk = 13;             // 8192 halfwords
using Ring = stage::ChunkRing<uint16_t, kLogChunk>;
static_assert(Ring::C >= kBatch * kLanes, "a batch reads at most K*1024 halfwords");
static_assert(kWarps <= 32, "a warp's lanes read the counts");
constexpr int kRingBytes = 4 * Ring::C * static_cast<int>(sizeof(uint16_t));
// a cursor clamped to [-kSlack, last + kSlack] gives every lane the index the
// unclamped cursor gives it, once clamped into the stream (rank <= 1024)
constexpr int kSlack = 4096;

__device__ __forceinline__ int clamp_cursor(long long c, int last) {
  return static_cast<int>(c < -kSlack ? -kSlack : (c > last + kSlack ? last + kSlack : c));
}

template <int MODE, bool TOTALS>
__global__ void __launch_bounds__(kThreads)
rans_decode_flat(const int32_t* __restrict__ tables, int table_words, int aux,
                 const int32_t* __restrict__ init,
                 const uint16_t* __restrict__ stream, int stream_hw,
                 const int32_t* __restrict__ csize,
                 const int32_t* __restrict__ cursors,
                 int32_t* __restrict__ out, int32_t* __restrict__ res,
                 int32_t* __restrict__ cend, int t4_count, int tlog) {
  constexpr int SPC = spc<MODE>();
  static_assert(kBatch % SPC == 0, "a batch holds whole output words");
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(16) int cnt[2][kWarps];
  uint32_t* tbl = smem;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int T = SPC * t4_count;
  const int last = stream_hw - 1;
  const uint16_t* hw = stream + static_cast<size_t>(g) * stream_hw;
  const int32_t* cur = TOTALS ? cursors + static_cast<size_t>(g) * T : nullptr;

  // the batch's cursors (totals), loaded one batch ahead
  int c_now[kBatch], c_next[kBatch];
  if constexpr (TOTALS) {
#pragma unroll
    for (int s = 0; s < kBatch; ++s) c_now[s] = s < T ? cur[s] : 0;
  }
  long long cursor = csize[g];
  stage::copy16(tbl, tables + static_cast<size_t>(g) * table_words,
                table_words / 4, tid, kThreads);
  Ring ring{reinterpret_cast<uint16_t*>(smem + table_words), hw, stream_hw, 0, 0};
  ring.start(clamp((TOTALS ? clamp_cursor(c_now[0], last) : clamp_cursor(cursor, last)) - 1,
                   0, last), tid, kThreads);

  const int lane0 = w * kSpan + lane;                    // lane j*32 + lane0
  int32_t* o = out + static_cast<size_t>(g) * t4_count * kLanes + lane0;
  uint32_t x[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    x[j] = static_cast<uint32_t>(init[static_cast<size_t>(g) * kLanes + lane0 + 32 * j]);
  const uint32_t mask = (1u << tlog) - 1u;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane
  stage::cp_async_wait_all();
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += kBatch) {
    // the chunks this batch may read; the chunk fetched during it fills the
    // slot above them
    const int rlo = ring.lo, rhi = min(ring.top, ring.lo + 2);
    const int c_b = TOTALS ? clamp_cursor(c_now[0], last) : clamp_cursor(cursor, last);
    if constexpr (TOTALS) {
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
        c_next[s] = t0 + kBatch + s < T ? cur[t0 + kBatch + s] : 0;
    }
    uint32_t word[kChains] = {};
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      if (t0 + s >= T) break;                  // uniform; T is a multiple of SPC
      constexpr int kParts = 32 / SPC;
      const int p = s % SPC;
      uint32_t x0[kChains];
      unsigned bal[kChains];
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        word[j] |= advance<MODE>(tbl, aux, x[j], tlog, mask) << (kParts * p);
        bal[j] = __ballot_sync(kFull, x[j] < kRansL);
        mine += __popc(bal[j]);
      }
      if (lane == 0) cnt[s & 1][w] = mine;
      if (s == 0) stage::cp_async_wait_all();   // the last batch's chunk is in
      __syncthreads();
      // every warp is past the last batch: the next batch's chunk may land
      if (s == 0) ring.advance(clamp(c_b - 2 * Ring::C, 0, last), tid, kThreads);
      // lane r < kWarps takes warp r's count; two warp reductions give the
      // count of the lanes before this warp's and the step's total
      const int rc = lane < kWarps ? cnt[s & 1][lane] : 0;
      const int below = __reduce_add_sync(kFull, lane < w ? rc : 0);
      const int total = __reduce_add_sync(kFull, rc);
      const int c = TOTALS ? clamp_cursor(c_now[s], last) : clamp_cursor(cursor, last);
      const int start = c - below;
      // the refills; in_stream: every index of the step, [c - total, c), lies
      // in the stream (a uniform test), so none needs the clamp
      auto refill = [&](auto in_stream) {
        int before = 0;
        unsigned slow = 0;
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
          const bool flag = x[j] < kRansL;
          const int pos = start - (before + __popc(bal[j] & le_mask));
          const int pc = decltype(in_stream)::value ? pos : clamp(pos, 0, last);
          x0[j] = x[j];
          x[j] = flag ? (x[j] << 16) | ring.at(pc) : x[j];
          if constexpr (TOTALS) {
            const int ch = pc >> kLogChunk;
            slow |= static_cast<unsigned>(
                        flag && static_cast<unsigned>(ch - rlo) > static_cast<unsigned>(rhi - rlo))
                    << j;
          }
          before += __popc(bal[j]);
        }
        return slow;
      };
      const unsigned slow = c - total >= 0 && c <= last + 1 ? refill(std::true_type{})
                                                          : refill(std::false_type{});
      if (TOTALS && __any_sync(kFull, slow)) {   // a corrupt frame: clamped global reads
        int before = 0;
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
          if ((slow >> j) & 1u)
            x[j] = (x0[j] << 16) |
                   hw[clamp(start - (before + __popc(bal[j] & le_mask)), 0, last)];
          before += __popc(bal[j]);
        }
      }
      cursor -= total;
      if (p == SPC - 1) {
        const int t4 = (t0 + s) / SPC;
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
          o[static_cast<size_t>(t4) * kLanes + 32 * j] = static_cast<int32_t>(word[j]);
          word[j] = 0u;
        }
      }
    }
    if constexpr (TOTALS) {
#pragma unroll
      for (int s = 0; s < kBatch; ++s) c_now[s] = c_next[s];
    }
  }
  stage::cp_async_wait_all();
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    res[static_cast<size_t>(g) * kLanes + lane0 + 32 * j] = static_cast<int32_t>(x[j] ^ kRansL);
  // the plain version keeps the cursor in 64 bits and tests it against 0:
  // saturate, so a nonzero cursor never reads 0
  if (tid == 0)
    cend[g] = static_cast<int32_t>(cursor < INT_MIN ? INT_MIN : (cursor > INT_MAX ? INT_MAX : cursor));
}

template <int MODE, bool TOTALS>
int launch(const void* tables, int table_words, const void* init,
           const void* stream, int stream_hw, const void* csize,
           const void* cursors, void* out, void* res, void* cend, int groups,
           int t4_count, int tlog, cudaStream_t s) {
  const int smem = table_words * static_cast<int>(sizeof(uint32_t)) + kRingBytes;
  cudaError_t e = cudaFuncSetAttribute(
      rans_decode_flat<MODE, TOTALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_decode_flat<MODE, TOTALS><<<groups, kThreads, smem, s>>>(
      static_cast<const int32_t*>(tables), table_words,
      aux_of(MODE, table_words), static_cast<const int32_t*>(init),
      static_cast<const uint16_t*>(stream), stream_hw,
      static_cast<const int32_t*>(csize), static_cast<const int32_t*>(cursors),
      static_cast<int32_t*>(out), static_cast<int32_t*>(res),
      static_cast<int32_t*>(cend), t4_count, tlog);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: [G, table_words] i32 in the layout of `mode` (rans_step.cuh:
// 0 byte, 1 pair, 3 u16, 4 u16x; quad frames always ship row counts), at
// least the words that mode needs at tlog and at most 16384, a multiple of
// 4; init: [G, 1024] i32; stream: [G, stream_hw] u16 (the packed payload
// words viewed as halfwords; 16-byte aligned, stream_hw a multiple of 8);
// csize: [G] i32; cursors: [G, spc*t4_count] i32 for the totals wire (byte
// mode only), or null for v1; out: [G, t4_count*1024] i32; res: [G, 1024]
// i32; cend: [G] i32, the final cursor (saturated to i32).  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int rans_decode_flat_launch(const void* tables, int table_words,
                                       const void* init, const void* stream,
                                       int stream_hw, const void* csize,
                                       const void* cursors, void* out,
                                       void* res, void* cend, int groups,
                                       int t4_count, int tlog, int mode,
                                       void* cuda_stream) {
  const bool totals = cursors != nullptr;
  if ((mode != kByte && mode != kPair && mode != kU16 && mode != kU16x) ||
      (totals && mode != kByte) || tlog < 5 || tlog > 13 ||
      table_words < table_words_needed(mode, tlog) || table_words > kMaxTable ||
      table_words % 4 || t4_count < 1 || stream_hw < 8 || stream_hw % 8 ||
      stream_hw > (1 << 30) || reinterpret_cast<uintptr_t>(stream) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(cuda_stream);
  decltype(&launch<kByte, false>) run = &launch<kU16x, false>;
  if (totals) run = &launch<kByte, true>;
  else if (mode == kByte) run = &launch<kByte, false>;
  else if (mode == kPair) run = &launch<kPair, false>;
  else if (mode == kU16) run = &launch<kU16, false>;
  return run(tables, table_words, init, stream, stream_hw, csize, cursors,
             out, res, cend, groups, t4_count, tlog, s);
}
