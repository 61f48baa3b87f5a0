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
// Per step t = SPC*t4 + p and lane k (row k>>7, column k&127),
// rans_step.cuh advances the state x by one table lookup and gives the
// step's value (byte, pair LUT value, u16 symbol), packed at bit 32/SPC*p of
// the output word; then
//   if x < 2^16: x = (x << 16) | stream_hw[cursor - rank]
// with rank the lane's inclusive rank among all flagged lanes of the group,
// row-major.  No row offsets are shipped, so the rank needs the counts of
// every row: one block of 1024 threads per group (thread k is lane k), and
// the rank comes from a warp ballot and a scan of the 32 warp counts, as in
// rans_encode.cu.  The cursor:
//   v1      starts at csize_hw and drops by each step's total (the scan's
//           last entry), so the chain needs the step's block-wide total;
//   totals  cursors[t], precomputed from the shipped totals outside the
//           kernel (as the JAX wrappers do outside Pallas, :1253-1255).
// The warp-count buffer is double-buffered and flips every step, so one
// barrier per step suffices.  The table lives in dynamic shared memory (up
// to 16384 words, u16x at tlog 13).  Every stream index is clamped into the
// group's buffer, so a corrupt frame cannot read out of bounds.  The kernel
// writes the residue x ^ 2^16 of every lane and the final cursor of each
// group (the JAX kernel's trailer tiles): a well-formed v1 stream ends with
// both zero, which the wrapper turns into err (the totals wire checks its
// cursors outside the kernel instead).
//
// What bounds it: each step is a table lookup, a 1024-thread barrier, a
// 32-entry shuffle scan and a dependent stream read, so a group's
// T = SPC*t4_count steps form a latency chain (1024 steps per 1 MiB group on
// the byte wire, 512 on pair and u16).  One block per group leaves SMs idle
// when a batch has fewer groups than the card has SMs.  Bytes moved are
// about the compressed size plus the output.
#include <cstdint>
#include <cuda_runtime.h>

#include "rans_step.cuh"

namespace {

using namespace rans_step;

constexpr int kLanes = 1024;
constexpr int kMaxTable = 2 * 8192;   // u16x at tlog 13

template <int MODE, bool TOTALS>
__global__ void __launch_bounds__(kLanes)
rans_decode_flat(const int32_t* __restrict__ tables, int table_words, int aux,
                 const int32_t* __restrict__ init,
                 const uint16_t* __restrict__ stream, int stream_hw,
                 const int32_t* __restrict__ csize,
                 const int32_t* __restrict__ cursors,
                 int32_t* __restrict__ out, int32_t* __restrict__ res,
                 int32_t* __restrict__ cend, int t4_count, int tlog) {
  constexpr int SPC = spc<MODE>();
  extern __shared__ uint32_t tbl[];
  __shared__ int warp_cnt[2][32];

  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  const int T = SPC * t4_count;
  for (int i = k; i < table_words; i += kLanes)
    tbl[i] = static_cast<uint32_t>(tables[static_cast<size_t>(g) * table_words + i]);

  const uint16_t* hw = stream + static_cast<size_t>(g) * stream_hw;
  const int32_t* cur = TOTALS ? cursors + static_cast<size_t>(g) * T : nullptr;
  int32_t* o = out + static_cast<size_t>(g) * t4_count * kLanes + k;
  uint32_t x = static_cast<uint32_t>(init[static_cast<size_t>(g) * kLanes + k]);
  const uint32_t mask = (1u << tlog) - 1u;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane
  int cursor = csize[g];
  int buf = 0;
  __syncthreads();

  for (int t4 = 0; t4 < t4_count; ++t4) {
    uint32_t word = 0;
#pragma unroll
    for (int p = 0; p < SPC; ++p) {
      word |= advance<MODE>(tbl, aux, x, tlog, mask) << (32 / SPC * p);
      const bool flag = x < kRansL;
      const unsigned b = __ballot_sync(kFull, flag);
      if (lane == 0) warp_cnt[buf][w] = __popc(b);
      __syncthreads();
      int incl = warp_cnt[buf][lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      const int before = __shfl_sync(kFull, incl, (w + 31) & 31);
      const int total = __shfl_sync(kFull, incl, 31);
      if (flag) {
        const int start = TOTALS ? cur[SPC * t4 + p] : cursor;
        const int rank = (w ? before : 0) + __popc(b & le_mask);
        long long pos = static_cast<long long>(start) - rank;
        pos = pos < 0 ? 0 : (pos >= stream_hw ? stream_hw - 1 : pos);
        x = (x << 16) | hw[pos];
      }
      cursor -= total;
      buf ^= 1;
    }
    o[static_cast<size_t>(t4) * kLanes] = static_cast<int32_t>(word);
  }
  res[static_cast<size_t>(g) * kLanes + k] = static_cast<int32_t>(x ^ kRansL);
  if (k == 0) cend[g] = cursor;
}

template <int MODE, bool TOTALS>
int launch(const void* tables, int table_words, const void* init,
           const void* stream, int stream_hw, const void* csize,
           const void* cursors, void* out, void* res, void* cend, int groups,
           int t4_count, int tlog, cudaStream_t s) {
  const int smem = table_words * static_cast<int>(sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(
      rans_decode_flat<MODE, TOTALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_decode_flat<MODE, TOTALS><<<groups, kLanes, smem, s>>>(
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
// least the words that mode needs at tlog and at most 16384; init: [G, 1024]
// i32; stream: [G, stream_hw] u16 (the packed payload words viewed as
// halfwords); csize: [G] i32; cursors: [G, spc*t4_count] i32 for the totals
// wire (byte mode only), or null for v1; out: [G, t4_count*1024] i32; res:
// [G, 1024] i32; cend: [G] i32, the final cursor.  Returns the launch's
// cudaError_t (0 = launched).
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
      table_words < table_words_needed(mode, tlog) || table_words > kMaxTable)
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
