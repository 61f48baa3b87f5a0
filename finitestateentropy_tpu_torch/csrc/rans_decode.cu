// TurboRANS decode for Hopper (sm_90a), rows-section wire (FLAG_STEPTOTS,
// per-step per-row renorm counts): byte, pair, quad, u16 and u16x wires.
//
// Replaces finitestateentropy_tpu/turbo/rans_kernels.py:_rans_decode_v2_kernel
// (rans_decode_v2 with [G,T,8] steptots) and the rows mode of
// _rans_decode_w_kernel (rans_decode_w): the two TPU kernels compute the same
// function and differ only in how they fit the stream into VMEM (resident
// with an nway interleave, or DMA windows from HBM).  Neither constraint
// exists here, so both entries launch this kernel.
//
// Per step t = SPC*t4 + p and lane, rans_step.cuh advances the state x by
// one table lookup and gives the step's value (a byte, a u16 symbol, a pair
// or a quad LUT value), packed at bit 32/SPC*p of the output word; then
//   if x < 2^16: x = (x << 16) | stream_hw[cursor[t] - rank]
// with rank = the shipped row offset of the lane's row + the lane's
// inclusive rank among the row's flagged lanes.  cursor[t] and the row
// offsets are precomputed from the shipped counts outside the kernel (as
// the JAX wrappers do outside Pallas), so the eight rows of a group never
// talk to each other: each 128-lane row is its own block, grid (G, 8).
// That spreads a batch over 8x as many SMs as one block per group would.
//
// The table lives in dynamic shared memory, sized by the launch: 2^tlog
// words (byte, u16), plus the 256-word id LUT (pair, quad: 4352 words at
// tlog 12), or twice 2^tlog (u16x: 16384 words, 64 KiB, at tlog 13, past
// the 48 KiB a launch gets without opting in).  A supercycle's SPC outputs
// are packed in a register and stored as one coalesced word.  Every stream
// index is clamped into the group's buffer, so a corrupt frame cannot read
// out of bounds; it shows as a final state != 2^16 (res = x ^ 2^16 != 0),
// which the wrapper turns into err.
//
// What bounds it: each step's stream read depends on the state the step
// just computed (a dependent global load per step), plus a 128-thread
// barrier for the row prefix, so a group's T = SPC*t4_count steps form a
// latency chain (1024 steps per 1 MiB group on the byte wire, 512 on pair
// and u16, 256 on quad); bytes moved are about the compressed size plus
// the output.
#include <cstdint>
#include <cuda_runtime.h>

#include "rans_step.cuh"

namespace {

using namespace rans_step;

constexpr int kRow = 128;
constexpr int kLanes = 1024;
constexpr int kMaxTable = 2 * 8192;   // u16x at tlog 13

template <int MODE>
__global__ void __launch_bounds__(kRow)
rans_decode_rows(const int32_t* __restrict__ tables, int table_words, int aux,
                 const int32_t* __restrict__ init,
                 const uint16_t* __restrict__ stream, int stream_hw,
                 const int32_t* __restrict__ cursors,
                 const int32_t* __restrict__ roff,
                 int32_t* __restrict__ out, int32_t* __restrict__ res,
                 int t4_count, int tlog) {
  constexpr int SPC = spc<MODE>();
  extern __shared__ uint32_t tbl[];
  __shared__ int warp_cnt[2][4];

  const int g = blockIdx.x;
  const int row = blockIdx.y;
  const int col = threadIdx.x;
  const int lane = col & 31;
  const int w = col >> 5;
  const int T = SPC * t4_count;
  for (int i = col; i < table_words; i += kRow)
    tbl[i] = static_cast<uint32_t>(tables[static_cast<size_t>(g) * table_words + i]);

  const uint16_t* hw = stream + static_cast<size_t>(g) * stream_hw;
  const int32_t* cur = cursors + static_cast<size_t>(g) * T;
  const int32_t* ro = roff + static_cast<size_t>(g) * T * 8 + row;
  const int lane_id = row * kRow + col;
  int32_t* o = out + static_cast<size_t>(g) * t4_count * kLanes + lane_id;
  uint32_t x = static_cast<uint32_t>(init[static_cast<size_t>(g) * kLanes + lane_id]);
  const uint32_t mask = (1u << tlog) - 1u;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane
  int buf = 0;
  __syncthreads();

  for (int t4 = 0; t4 < t4_count; ++t4) {
    uint32_t word = 0;
#pragma unroll
    for (int p = 0; p < SPC; ++p) {
      const int t = SPC * t4 + p;
      word |= advance<MODE>(tbl, aux, x, tlog, mask) << (32 / SPC * p);
      const bool flag = x < kRansL;
      const unsigned b = __ballot_sync(kFull, flag);
      // warp counts double-buffered, flipped every step: one barrier per step
      if (lane == 0) warp_cnt[buf][w] = __popc(b);
      __syncthreads();
      if (flag) {
        int rank = ro[t * 8] + __popc(b & le_mask);
        for (int i = 0; i < w; ++i) rank += warp_cnt[buf][i];
        long long pos = static_cast<long long>(cur[t]) - rank;
        pos = pos < 0 ? 0 : (pos >= stream_hw ? stream_hw - 1 : pos);
        x = (x << 16) | hw[pos];
      }
      buf ^= 1;
    }
    o[static_cast<size_t>(t4) * kLanes] = static_cast<int32_t>(word);
  }
  res[static_cast<size_t>(g) * kLanes + lane_id] = static_cast<int32_t>(x ^ kRansL);
}

template <int MODE>
int launch(const void* tables, int table_words, const void* init,
           const void* stream, int stream_hw, const void* cursors,
           const void* roff, void* out, void* res, int groups, int t4_count,
           int tlog, cudaStream_t s) {
  const int smem = table_words * static_cast<int>(sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(
      rans_decode_rows<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_decode_rows<MODE><<<dim3(groups, 8), kRow, smem, s>>>(
      static_cast<const int32_t*>(tables), table_words,
      aux_of(MODE, table_words), static_cast<const int32_t*>(init),
      static_cast<const uint16_t*>(stream), stream_hw,
      static_cast<const int32_t*>(cursors), static_cast<const int32_t*>(roff),
      static_cast<int32_t*>(out), static_cast<int32_t*>(res), t4_count, tlog);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: [G, table_words] i32 in the layout of `mode` (rans_step.cuh:
// 0 byte, 1 pair, 2 quad, 3 u16, 4 u16x), at least the words that mode
// needs at tlog and at most 16384; init: [G, 1024] i32; stream:
// [G, stream_hw] u16 (the packed payload words viewed as halfwords);
// cursors: [G, spc*t4_count] i32; roff: [G, spc*t4_count, 8] i32; out:
// [G, t4_count*1024] i32; res: [G, 1024] i32.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int rans_decode_launch(const void* tables, int table_words,
                                  const void* init, const void* stream,
                                  int stream_hw, const void* cursors,
                                  const void* roff, void* out, void* res,
                                  int groups, int t4_count, int tlog, int mode,
                                  void* cuda_stream) {
  if (mode < kByte || mode > kU16x || tlog < 5 || tlog > 13 ||
      table_words < table_words_needed(mode, tlog) || table_words > kMaxTable)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(cuda_stream);
  decltype(&launch<kByte>) run = &launch<kU16x>;
  if (mode == kByte) run = &launch<kByte>;
  if (mode == kPair) run = &launch<kPair>;
  if (mode == kQuad) run = &launch<kQuad>;
  if (mode == kU16) run = &launch<kU16>;
  return run(tables, table_words, init, stream, stream_hw, cursors, roff, out,
             res, groups, t4_count, tlog, s);
}
