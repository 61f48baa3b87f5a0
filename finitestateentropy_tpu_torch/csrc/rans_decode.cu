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
// The function.  Per step t = SPC*t4 + p and lane, rans_step.cuh advances
// the state x by one table lookup and gives the step's value (a byte, a u16
// symbol, a pair or a quad LUT value), packed at bit 32/SPC*p of the output
// word; then
//   if x < 2^16: x = (x << 16) | stream_hw[cursor[t] - rank]
// with rank = the shipped row offset of the lane's row + the lane's
// inclusive rank among the row's flagged lanes.  cursor[t] and the row
// offsets are precomputed from the shipped counts outside the kernel (as
// the JAX wrappers do outside Pallas), so the eight rows of a group never
// talk to each other.  Every stream index is clamped into the group's
// buffer, so a corrupt frame cannot read out of bounds; it shows as a final
// state != 2^16 (res = x ^ 2^16 != 0), which the wrapper turns into err.
//
// The design.  One warp per 128-lane row: thread i holds lanes j*32 + i, j =
// 0..3, four independent state chains.  The rank among the row's flagged
// lanes is four ballots (the popcounts of the earlier ballots plus this
// one's below the thread), so a step takes no barrier and no shared count.
// The stream is staged: the K = 16 steps of a batch read exactly the
// halfwords [cursor[t+K], cursor[t]) of the group (the last batch down to
// 0), at most K*1024 of them on a well-formed frame, and the batch's
// cursors and row offsets are known before it starts.  So each block copies
// batch b+1's window into a shared-memory double buffer with cp.async while
// it decodes batch b, along with the cursors and row offsets of batch b+2
// (a ring of three), and the refill halfword comes from shared memory.  One
// block barrier per batch hands the buffers over.  An index outside the
// staged window (only a corrupt frame has one: cursors that disagree with
// the flags, or a window over K*1024 halfwords) reads the clamped global
// halfword, as the plain version does.  A block holds 1, 2, 4 or 8 rows of
// one group, the most that still gives every SM a block (64 groups: 2 rows,
// 256 blocks); every block of a group stages the same window.
//
// Shared memory, sized per launch: the table (2^tlog words for byte and
// u16; plus the 256-word id LUT for pair and quad; twice 2^tlog for u16x,
// 64 KiB at tableLog 13), three meta chunks (2.3 KiB) and two windows of
// K*1024 + 16 halfwords (64 KiB), or of the stream's length + 16 when the
// stream is shorter: at most 130 KiB, one block per SM at u16x / tableLog
// 13, past the 48 KiB a launch gets without opting in.
//
// What bounds it on the H100: the integer work, about 20 operations a
// lane-step (chip_smoke.py's count); a thread's four chains each wait on a
// shared table load, a multiply-add, a ballot and a shared stream read per
// step.  Bytes moved are about the compressed size plus the output.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "rans_step.cuh"
#include "stage.cuh"

namespace {

using namespace rans_step;
using stage::cp_async4;
using stage::cp_async_commit;
using stage::cp_async_wait_all;

constexpr int kLanes = 1024;
constexpr int kMaxTable = 2 * 8192;   // u16x at tlog 13
constexpr int kBatch = 16;            // steps per staged window
constexpr int kCap = kBatch * kLanes; // a well-formed window: a step reads <= 1024
// one meta chunk: the cursors of steps cK..cK+K and the K x 8 row offsets
constexpr int kMetaUsed = kBatch + 1 + 8 * kBatch;
constexpr int kMeta = (kMetaUsed + 3) / 4 * 4;
constexpr int kMaxThreads = 256;

// The staged halfwords [lo, hi) of a batch, copied from `base` (lo rounded
// down to 16 bytes): [cursor[cK+K], cursor[cK]) from the batch's meta chunk,
// down to 0 for the last batch, clamped into the stream and to cap.
struct Window {
  int lo, hi, base;
};

__device__ __forceinline__ Window window_of(const int* meta, bool last,
                                            int stream_hw, int cap) {
  const int hi = min(max(meta[0], 0), stream_hw);
  int lo = last ? 0 : min(max(meta[kBatch], 0), hi);
  lo = max(lo, hi - cap);
  return {lo, hi, lo & ~7};
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
rans_decode_rows(const int32_t* __restrict__ tables, int table_words, int aux,
                 const int32_t* __restrict__ init,
                 const uint16_t* __restrict__ stream, int stream_hw,
                 const int32_t* __restrict__ cursors,
                 const int32_t* __restrict__ roff,
                 int32_t* __restrict__ out, int32_t* __restrict__ res,
                 int t4_count, int tlog, int cap) {
  constexpr int SPC = spc<MODE>();
  const int win_hw = cap + 16;         // a buffer: the window widened to 16-byte ends
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tbl = smem;
  int* meta = reinterpret_cast<int*>(smem + table_words);
  uint16_t* win = reinterpret_cast<uint16_t*>(meta + 3 * kMeta);

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = blockIdx.y * (nthreads >> 5) + (tid >> 5);
  const int g = blockIdx.x;
  const int T = SPC * t4_count;
  const int batches = (T + kBatch - 1) / kBatch;
  for (int i = tid; i < table_words; i += nthreads)
    tbl[i] = static_cast<uint32_t>(tables[static_cast<size_t>(g) * table_words + i]);

  const uint16_t* hw = stream + static_cast<size_t>(g) * stream_hw;
  const int32_t* cur = cursors + static_cast<size_t>(g) * T;
  const int32_t* ro = roff + static_cast<size_t>(g) * T * 8;

  auto stage_meta = [&](int c) {
    int* dst = meta + (c % 3) * kMeta;
    for (int i = tid; i < kMetaUsed; i += nthreads) {
      const int step = c * kBatch + (i <= kBatch ? i : (i - kBatch - 1) / 8);
      if (step < T)
        cp_async4(dst + i, i <= kBatch ? cur + step
                                       : ro + static_cast<size_t>(c) * kBatch * 8 + (i - kBatch - 1));
    }
  };
  auto stage_window = [&](int c) {
    const Window wd = window_of(meta + (c % 3) * kMeta, c + 1 == batches, stream_hw, cap);
    stage::copy16(win + (c & 1) * win_hw, hw + wd.base,
                  (((wd.hi + 7) & ~7) - wd.base) / 8, tid, nthreads);
  };

  if (batches > 0) {
    stage_meta(0);
    if (batches > 1) stage_meta(1);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    stage_window(0);
    cp_async_commit();
  }

  const int lane0 = row * 128 + lane;                    // lane j*32 + lane0
  int32_t* o = out + static_cast<size_t>(g) * t4_count * kLanes + lane0;
  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = static_cast<uint32_t>(init[static_cast<size_t>(g) * kLanes + lane0 + 32 * j]);
  const uint32_t mask = (1u << tlog) - 1u;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane

  for (int b = 0; b < batches; ++b) {
    cp_async_wait_all();
    __syncthreads();      // window b and meta b+1 in; batch b-1's buffers free
    if (b + 1 < batches) stage_window(b + 1);
    if (b + 2 < batches) stage_meta(b + 2);
    cp_async_commit();

    const int* mc = meta + (b % 3) * kMeta;
    const Window wd = window_of(mc, b + 1 == batches, stream_hw, cap);
    const uint16_t* sw = win + (b & 1) * win_hw;
    const int s0 = b * kBatch;
    const int t4_end = min(t4_count, (s0 + kBatch) / SPC);
    for (int t4 = s0 / SPC; t4 < t4_end; ++t4) {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int p = 0; p < SPC; ++p) {
        const int sl = t4 * SPC + p - s0;
        // the row's stream position less its lanes' ranks (<= 128); exact in
        // 32 bits unless the counts are corrupt, and then the step reads
        // through the slow path below
        const long long start64 =
            static_cast<long long>(mc[sl]) - mc[kBatch + 1 + sl * 8 + row];
        const bool start_ok = start64 >= INT_MIN + 256 && start64 <= INT_MAX;
        const int start = static_cast<int>(start64);
        uint32_t v[4], x0[4];
        unsigned bal[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = advance<MODE>(tbl, aux, x[j], tlog, mask);
          bal[j] = __ballot_sync(kFull, x[j] < kRansL);
        }
        int before = 0;
        unsigned slow = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // every lane reads the window (in bounds whatever pos is), so the
          // refill takes no branch
          const bool flag = x[j] < kRansL;
          const int pos = start - (before + __popc(bal[j] & le_mask));
          const bool in_window =
              start_ok && static_cast<unsigned>(pos) - static_cast<unsigned>(wd.lo) <
                              static_cast<unsigned>(wd.hi - wd.lo);
          const uint32_t h = sw[in_window ? pos - wd.base : 0];
          x0[j] = x[j];
          x[j] = flag ? (x[j] << 16) | h : x[j];
          slow |= static_cast<unsigned>(flag && !in_window) << j;
          before += __popc(bal[j]);
          word[j] |= v[j] << (32 / SPC * p);
        }
        if (__any_sync(kFull, slow)) {      // a corrupt frame: clamped global reads
          before = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((slow >> j) & 1u) {
              long long pos = start64 - (before + __popc(bal[j] & le_mask));
              pos = pos < 0 ? 0 : (pos >= stream_hw ? stream_hw - 1 : pos);
              x[j] = (x0[j] << 16) | hw[pos];
            }
            before += __popc(bal[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[static_cast<size_t>(t4) * kLanes + 32 * j] = static_cast<int32_t>(word[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    res[static_cast<size_t>(g) * kLanes + lane0 + 32 * j] =
        static_cast<int32_t>(x[j] ^ kRansL);
}

// Rows per block: the most (8, 4, 2, 1) that still gives every SM a block.
int rows_per_block(int groups) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  int rpb = 8;
  while (rpb > 1 && groups * (8 / rpb) < sms) rpb >>= 1;
  return rpb;
}

template <int MODE>
int launch(const void* tables, int table_words, const void* init,
           const void* stream, int stream_hw, const void* cursors,
           const void* roff, void* out, void* res, int groups, int t4_count,
           int tlog, cudaStream_t s) {
  // the window: K*1024 halfwords, or the whole stream when it is shorter
  const int cap = stream_hw < kCap ? stream_hw : kCap;
  const int smem = (table_words + 3 * kMeta) * static_cast<int>(sizeof(uint32_t)) +
                   2 * (cap + 16) * static_cast<int>(sizeof(uint16_t));
  if (smem > 48 * 1024) {              // past the default, opt in
    const cudaError_t e = cudaFuncSetAttribute(
        rans_decode_rows<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rpb = rows_per_block(groups);
  rans_decode_rows<MODE><<<dim3(groups, 8 / rpb), 32 * rpb, smem, s>>>(
      static_cast<const int32_t*>(tables), table_words,
      aux_of(MODE, table_words), static_cast<const int32_t*>(init),
      static_cast<const uint16_t*>(stream), stream_hw,
      static_cast<const int32_t*>(cursors), static_cast<const int32_t*>(roff),
      static_cast<int32_t*>(out), static_cast<int32_t*>(res), t4_count, tlog,
      cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: [G, table_words] i32 in the layout of `mode` (rans_step.cuh:
// 0 byte, 1 pair, 2 quad, 3 u16, 4 u16x), at least the words that mode
// needs at tlog and at most 16384; init: [G, 1024] i32; stream:
// [G, stream_hw] u16 (the packed payload words viewed as halfwords; 16-byte
// aligned, stream_hw a multiple of 8); cursors: [G, spc*t4_count] i32;
// roff: [G, spc*t4_count, 8] i32; out: [G, t4_count*1024] i32; res:
// [G, 1024] i32.  Returns the launch's cudaError_t (0 = launched).
extern "C" int rans_decode_launch(const void* tables, int table_words,
                                  const void* init, const void* stream,
                                  int stream_hw, const void* cursors,
                                  const void* roff, void* out, void* res,
                                  int groups, int t4_count, int tlog, int mode,
                                  void* cuda_stream) {
  if (mode < kByte || mode > kU16x || tlog < 5 || tlog > 13 ||
      table_words < table_words_needed(mode, tlog) || table_words > kMaxTable ||
      table_words % 4 || stream_hw % 8 || stream_hw > (1 << 30) ||
      reinterpret_cast<uintptr_t>(stream) % 16)
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
