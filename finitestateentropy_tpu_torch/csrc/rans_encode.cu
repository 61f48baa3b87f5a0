// TurboRANS encode for Hopper (sm_90a): byte, pair and quad wires, and the
// U16 codec's u16 and u16x modes, in both output layouts.
//
// rans_encode_launch replaces, in finitestateentropy_tpu/turbo/rans_kernels.py,
//   _rans_encode_rl_kernel  (rans_encode2(..., rowloc=True), the row-local
//                            placement) and
//   _rans_encode2_kernel    (rans_encode2(..., rowloc=False), the flat
//                            placement by binary search):
// both write the same packed wire, two halfwords per output word; and
//   _rans_encode_kernel     (rans_encode, the v1 encode, :303-459): one
//                            halfword per output i32, as that kernel lays it
//                            out.
// On the TPU the placements differ only in how Mosaic, which has no scatter,
// pulls each halfword into place; here the halfwords are stored where they
// go, so one entry serves all three.  The output bytes equal the numpy
// twins turbo/rans.py:rans_compress, turbo/pair.py:pair_compress,
// turbo/quad.py:quad_compress and turbo/rans16.py:rans16_compress.
//
// The function.  A group is 1024 lanes (row k>>7, column k&127).  Steps run
// in reverse, as rANS encodes: step t = SPC*t4 + p takes symbol p of the
// lane's source word t4, p from SPC-1 down to 0.  SPC (steps per source
// word) is the mode:
//   4  byte wire: symbol p is byte p of the word;
//   2  pair wire: symbol p is the u16 pair id (word >> 16p) & 0xFFFF;
//   1  quad wire: the word holds one quad id, word & 0xFF;
//   2  u16 modes: symbol p is (word >> 16p) & 0xFFFF, with 1024-entry
//      tables (12-bit fields, symbols <= 1023) or 4096-entry tables
//      ((cumul << 14) | freq, symbols <= 4095 at tableLog 12-13).
// Pair and quad ids are < 256, so those modes share the 256-entry tables.
// A symbol past the tables (only a malformed source holds one) reads zero
// entries, as the TPU kernel's chunk select gives them.  Per step each lane
//   - emits its low halfword and shifts x right by 16 when x >= f << (32-tlog),
//   - divides by f with a mulhi by the magic reciprocal and two corrections,
//   - x = (q << tlog) + cumul + r.
// Emitted halfwords are placed at cursor + total - rank, with rank the flat
// inclusive rank of the lane among the step's flagged lanes (row-major),
// the order the decoder reads them back; the cursor then advances by the
// step's total.  The per-row counts of every step are the FLAG_STEPTOTS
// section (ratio mode drops them).
//
// The design: count, then place.  A lane's state x never depends on where
// its halfwords go, only the placement does, and the placement of step t
// needs the totals of every step coded before it.  So the entry launches
// three kernels:
//   1. rans_encode_lanes: the state chains, one lane a thread.  A warp is
//      32 consecutive lanes (a quarter row, a "sub-row"); the rank among its
//      flagged lanes is one ballot.  Each step stores the sub-row's emitted
//      halfwords, in rank order, into a staging slot of its own ([G, T, 32,
//      32] halfwords; predicated stores, no branch) and their count into
//      counts[G, T, 32].  No barrier at all after the tables are in shared
//      memory (freq and cumul beside the magic reciprocal: one 8-byte read
//      a lane-step); the next 8 source words of each lane are loaded into
//      registers before the current 8 are coded, so no step waits on a
//      global load (the quad wire reads a word every step).  A block holds
//      1, 2, 4 or 8 warps of one group, the most that still gives every SM
//      a block; a 64-group batch is 2048 warps, four for each of the card's
//      528 schedulers, which hide each other's latencies.
//   2. rans_encode_scan: one block per group, a thread per step, turns the
//      counts into each sub-row-step's base, the sum of the totals of steps
//      t..T-1 less the sub-row's offset in the step (a block scan over the
//      steps, 1024 at a time); csize, the sum of all totals; and the
//      per-row counts (stots[G, T, 8], the sums of four sub-rows) unless
//      stots is null.
//   3. rans_encode_place: a warp per step copies the step's staged
//      halfwords to base - rank, dropping those at or past the stream's end.
// The staging, counts and base buffers are the caller's scratch.
//
// What bounds it on the H100: the integer work of the chains, about 25
// operations a lane-step (chip_smoke.py's count), over the SMs' INT32
// units; each chain's step is about ten dependent operations (the state
// recurrence).  Bytes moved are the source, the tables, and about twice
// the compressed size (staged, then placed).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 256;       // 8 warps of one group
constexpr int kPrefetch = 8;           // source words loaded a batch ahead
constexpr int kScan = 1024;            // steps per block-scan round
constexpr int kSub = 32;               // sub-rows (warps) per group
constexpr int kPlaceSteps = 8;         // steps (one warp each) per place block

template <int SPC>
__device__ __forceinline__ uint32_t symbol_of(uint32_t word, int p) {
  if (SPC == 4) return (word >> (8 * p)) & 0xFFu;
  if (SPC == 2) return (word >> (16 * p)) & 0xFFFFu;
  return word & 0xFFu;
}

// Stores v at p when pred holds, as one predicated store: a branch around
// the store would cost a reconvergence point per lane-step.  No memory
// clobber: nothing in the kernel reads the staging back, so the table
// reads of later steps may move above it.
__device__ __forceinline__ void store_if(uint16_t* p, uint32_t v, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.u16 [%0], %1;\n}\n"
      ::"l"(p), "h"(static_cast<unsigned short>(v)), "r"(static_cast<unsigned>(pred)));
}

// SYMS: table entries (256, 1024 or 4096).
template <int SPC, int SYMS>
__global__ void __launch_bounds__(kMaxThreads)
rans_encode_lanes(const int32_t* __restrict__ fc_tables,
                  const int32_t* __restrict__ magic_tables,
                  const int32_t* __restrict__ src,
                  uint16_t* __restrict__ stage, int32_t* __restrict__ counts,
                  int32_t* __restrict__ finals, int t4_count, int tlog) {
  __shared__ uint2 fm[SYMS];           // (cumul, freq) field word, magic
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = blockIdx.x;
  const int k = blockIdx.y * nthreads + tid;             // lane in the group
  const int sub = k >> 5;
  for (int i = tid; i < SYMS; i += nthreads)
    fm[i] = make_uint2(
        static_cast<uint32_t>(fc_tables[static_cast<size_t>(g) * SYMS + i]),
        static_cast<uint32_t>(magic_tables[static_cast<size_t>(g) * SYMS + i]));
  __syncthreads();

  const int T = SPC * t4_count;
  const int32_t* s = src + static_cast<size_t>(g) * t4_count * 1024 + k;
  // stage[g][t][sub][q] (q the rank from 0), counts[g][t][sub]
  uint16_t* stg = stage + (static_cast<size_t>(g) * T * kSub + sub) * 32 - 1;
  int32_t* cnt = counts + static_cast<size_t>(g) * T * kSub + sub;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane
  const int shift = 32 - tlog;
  uint32_t x = kRansL;

  // the SPC steps of source word t4
  auto code_word = [&](uint32_t w, int t4) {
#pragma unroll
    for (int p = SPC - 1; p >= 0; --p) {
      const int t = SPC * t4 + p;
      const uint32_t sym = symbol_of<SPC>(w, p);
      const uint2 em = sym < static_cast<uint32_t>(SYMS) ? fm[sym] : make_uint2(0u, 0u);
      // 4096-entry tables hold 14-bit fields (tableLog up to 13)
      const uint32_t f = SYMS == 4096 ? em.x & 0x3FFFu : em.x & 0xFFFu;
      const uint32_t cu = SYMS == 4096 ? em.x >> 14 : (em.x >> 12) & 0xFFFu;
      const bool flag = x >= (f << shift);
      const uint32_t emit = x & 0xFFFFu;
      const uint32_t xs = flag ? x >> 16 : x;
      uint32_t q = __umulhi(xs, em.y);
      uint32_t r = xs - q * f;
      if (r >= f) { ++q; r -= f; }
      if (r >= f) { ++q; r -= f; }
      x = (q << tlog) + cu + r;
      const unsigned bal = __ballot_sync(kFull, flag);
      store_if(stg + static_cast<size_t>(t) * 1024 + __popc(bal & le_mask), emit, flag);
      if (lane == 0) cnt[static_cast<size_t>(t) * kSub] = __popc(bal);
    }
  };

  // Words go in batches of kPrefetch, each loaded one batch ahead; the
  // t4_count % kPrefetch words left (the lowest) are loaded with the last
  // full batch and coded after it.
  const int full = t4_count / kPrefetch;
  const int rem = t4_count % kPrefetch;
  uint32_t next[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    const int t4 = t4_count - 1 - i;
    next[i] = t4 >= 0 ? static_cast<uint32_t>(s[static_cast<size_t>(t4) * 1024]) : 0u;
  }
  for (int b = 0; b < full; ++b) {
    const int hi = t4_count - 1 - b * kPrefetch;         // first word, going down
    uint32_t word[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      // the next full batch's words, or after the last one the remainder's
      const int t4 = b + 1 < full ? hi - kPrefetch - i : (i < rem ? rem - 1 - i : -1);
      word[i] = next[i];
      if (t4 >= 0) next[i] = static_cast<uint32_t>(s[static_cast<size_t>(t4) * 1024]);
    }
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) code_word(word[i], hi - i);
  }
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i)
    if (i < rem) code_word(next[i], rem - 1 - i);
  finals[static_cast<size_t>(g) * 1024 + k] = static_cast<int32_t>(x);
}

// base[g][t][s] = (sum of the totals of steps t..T-1) - (sub-row s's offset
// in step t): the stream position just past the sub-row's halfwords of
// step t.  csize[g] = the sum of all totals; stots[g][t][r] = the count of
// row r (sub-rows 4r..4r+3) unless stots is null.  One block of kScan
// threads per group; thread i takes step top - i of each round, so the
// inclusive scan over i runs in coding order.
__global__ void __launch_bounds__(kScan)
rans_encode_scan(const int32_t* __restrict__ counts, int32_t* __restrict__ base,
                 int32_t* __restrict__ stots, int32_t* __restrict__ csize, int T) {
  __shared__ int warp_sum[kScan / 32];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  int carry = 0;
  for (int top = T - 1; top >= 0; top -= kScan) {
    const int t = top - tid;
    const size_t at = (static_cast<size_t>(g) * T + (t < 0 ? 0 : t)) * kSub;
    int c[kSub];
    int total = 0;
#pragma unroll
    for (int v = 0; v < kSub / 4; ++v) {
      const int4 q = t >= 0 ? reinterpret_cast<const int4*>(counts + at)[v]
                            : make_int4(0, 0, 0, 0);
      c[4 * v] = q.x, c[4 * v + 1] = q.y, c[4 * v + 2] = q.z, c[4 * v + 3] = q.w;
      total += q.x + q.y + q.z + q.w;
    }
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[w] = incl;
    __syncthreads();
    if (w == 0) {
      int v = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
      }
      warp_sum[lane] = v;
    }
    __syncthreads();
    const int suffix = carry + incl + (w ? warp_sum[w - 1] : 0);
    if (t >= 0) {
      int off = 0;
#pragma unroll
      for (int v = 0; v < kSub / 4; ++v) {
        int4 q;
        q.x = suffix - off, off += c[4 * v];
        q.y = suffix - off, off += c[4 * v + 1];
        q.z = suffix - off, off += c[4 * v + 2];
        q.w = suffix - off, off += c[4 * v + 3];
        reinterpret_cast<int4*>(base + at)[v] = q;
      }
      if (stots) {
#pragma unroll
        for (int v = 0; v < 2; ++v)
          reinterpret_cast<int4*>(stots + (static_cast<size_t>(g) * T + t) * 8)[v] = make_int4(
              c[16 * v] + c[16 * v + 1] + c[16 * v + 2] + c[16 * v + 3],
              c[16 * v + 4] + c[16 * v + 5] + c[16 * v + 6] + c[16 * v + 7],
              c[16 * v + 8] + c[16 * v + 9] + c[16 * v + 10] + c[16 * v + 11],
              c[16 * v + 12] + c[16 * v + 13] + c[16 * v + 14] + c[16 * v + 15]);
      }
    }
    carry += warp_sum[kScan / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) csize[g] = carry;
}

// A warp per step: the step's halfwords, sub-row after sub-row in rank
// order, go to base[s] - 1 - q (q the lane's rank in its sub-row, from 0).
template <typename OutT>
__global__ void __launch_bounds__(32 * kPlaceSteps)
rans_encode_place(const uint16_t* __restrict__ stage,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ base, OutT* __restrict__ stream,
                  int stream_hw, int T) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.y * kPlaceSteps + (threadIdx.x >> 5);
  if (t >= T) return;
  const size_t at = (static_cast<size_t>(g) * T + t) * kSub;
  const int c = counts[at + lane];
  const int b = base[at + lane];
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int off = incl - c;                              // sub-row lane's offset
  const int total = __shfl_sync(kFull, incl, 31);
  const uint16_t* st = stage + at * 32;
  OutT* out = stream + static_cast<size_t>(g) * stream_hw;
  for (int f0 = 0; f0 < total; f0 += 32) {
    const int f = f0 + lane;
    // the last sub-row whose offset is <= f holds halfword f of the step
    int s = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, off, s + step) <= f) s += step;
    }
    const int q = f - __shfl_sync(kFull, off, s);
    const int pos = __shfl_sync(kFull, b, s) - 1 - q;
    if (f < total && pos < stream_hw) out[pos] = static_cast<OutT>(st[s * 32 + q]);
  }
}

// Warps per block: the most (8, 4, 2, 1) that still gives every SM a block.
int warps_per_block(int groups) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  int wpb = kMaxThreads / 32;
  while (wpb > 1 && groups * (kSub / wpb) < sms) wpb >>= 1;
  return wpb;
}

template <int SPC, int SYMS, typename OutT>
int launch(const void* fc, const void* magic, const void* src, void* stream,
           int stream_hw, void* finals, void* csize, void* stots, void* counts,
           void* stage, void* base, int groups, int t4_count, int tlog,
           void* cuda_stream) {
  const auto s = static_cast<cudaStream_t>(cuda_stream);
  const int T = SPC * t4_count;
  const int wpb = warps_per_block(groups);
  rans_encode_lanes<SPC, SYMS><<<dim3(groups, kSub / wpb), 32 * wpb, 0, s>>>(
      static_cast<const int32_t*>(fc), static_cast<const int32_t*>(magic),
      static_cast<const int32_t*>(src), static_cast<uint16_t*>(stage),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(finals), t4_count,
      tlog);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_encode_scan<<<groups, kScan, 0, s>>>(
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(base),
      static_cast<int32_t*>(stots), static_cast<int32_t*>(csize), T);
  e = cudaGetLastError();
  if (e != cudaSuccess || T == 0) return static_cast<int>(e);
  rans_encode_place<OutT>
      <<<dim3(groups, (T + kPlaceSteps - 1) / kPlaceSteps), 32 * kPlaceSteps, 0, s>>>(
          static_cast<const uint16_t*>(stage), static_cast<const int32_t*>(counts),
          static_cast<const int32_t*>(base), static_cast<OutT*>(stream),
          stream_hw, T);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (spc, table entries, layout), or null.
using Launch = decltype(&launch<4, 256, uint16_t>);
template <typename OutT>
Launch pick(int spc, int syms) {
  if (syms == 256 && spc == 4) return &launch<4, 256, OutT>;
  if (syms == 256 && spc == 2) return &launch<2, 256, OutT>;
  if (syms == 256 && spc == 1) return &launch<1, 256, OutT>;
  if (syms == 1024 && spc == 2) return &launch<2, 1024, OutT>;
  if (syms == 4096 && spc == 2) return &launch<2, 4096, OutT>;
  return nullptr;
}

}  // namespace

// fc, magic: [G, nch*128] i32: nch 2 (byte symbols, pair or quad ids,
// (cumul << 12) | freq), 8 (u16 symbols <= 1023, the same fields) or 32
// (u16 symbols <= 4095, (cumul << 14) | freq); src: [G, t4_count*1024] i32
// (4 bytes, 2 pair ids or u16 symbols, or 1 quad id per word); spc: 4
// (byte), 2 (pair, u16) or 1 (quad).  packed 1: stream is [G, stream_hw]
// u16, two halfwords per word (rans_encode2); packed 0: [G, stream_hw] i32,
// one halfword per entry (rans_encode).  Zeroed by the caller.  finals:
// [G, 1024] i32; csize: [G] i32; stots: [G, spc*t4_count, 8] i32, the
// per-step row counts, or null; counts, base: [G, spc*t4_count, 32] i32
// and stage: [G, spc*t4_count, 32, 32] u16, scratch (counts 16-byte
// aligned).  Returns the first launch error's cudaError_t (0 = all three
// launched).
extern "C" int rans_encode_launch(const void* fc, const void* magic,
                                  const void* src, void* stream, int stream_hw,
                                  void* finals, void* csize, void* stots,
                                  void* counts, void* stage, void* base,
                                  int groups, int t4_count, int tlog, int spc,
                                  int nch, int packed, void* cuda_stream) {
  const Launch run = packed ? pick<uint16_t>(spc, nch * 128)
                            : pick<int32_t>(spc, nch * 128);
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(fc, magic, src, stream, stream_hw, finals, csize, stots, counts,
             stage, base, groups, t4_count, tlog, cuda_stream);
}
