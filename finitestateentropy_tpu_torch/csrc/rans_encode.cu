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
// pulls each halfword into place; here each flagged lane stores its own, so
// one kernel serves all three entries.  The output bytes equal the numpy
// twins turbo/rans.py:rans_compress, turbo/pair.py:pair_compress,
// turbo/quad.py:quad_compress and turbo/rans16.py:rans16_compress.
//
// One block of 1024 threads per group; thread k is lane k (row k>>7, column
// k&127), so row r is warps 4r..4r+3.  Steps run in reverse, as rANS
// encodes: step t = SPC*t4 + p takes symbol p of the lane's source word t4,
// p from SPC-1 down to 0.  SPC (steps per source word) is the mode:
//   4  byte wire: symbol p is byte p of the word;
//   2  pair wire: symbol p is the u16 pair id (word >> 16p) & 0xFFFF;
//   1  quad wire: the word holds one quad id, word & 0xFF;
//   2  u16 modes: symbol p is (word >> 16p) & 0xFFFF, with 1024-entry
//      tables (12-bit fields, symbols <= 1023) or 4096-entry tables
//      ((cumul << 14) | freq, symbols <= 4095 at tableLog 12-13).
// Pair and quad ids are < 256, so those modes share the 256-entry tables.
// A symbol past the tables (only a malformed source holds one) reads zero
// entries, as the TPU kernel's chunk select gives them.
// Per step each lane
//   - emits its low halfword and shifts x right by 16 when x >= f << (32-tlog),
//   - divides by f with a mulhi by the magic reciprocal and two corrections,
//   - x = (q << tlog) + cumul + r.
// Emitted halfwords are placed at cursor + total - rank, with rank the flat
// inclusive rank of the lane among the flagged lanes (row-major), which is
// the order the decoder reads them back.  The rank comes from a warp ballot
// and a scan of the 32 warp counts; each flagged lane stores its halfword
// itself (the TPU kernel's binary-search "pull" placement existed only
// because Mosaic has no scatter).  The per-row totals of every step go to
// stots[t][row] (the FLAG_STEPTOTS section) unless stots is null (ratio
// mode drops them).
//
// What bounds it: the x chain is a few dependent integer ops per step and
// runs at ALU latency, but every step ends in one block-wide barrier (the
// cursor needs the step's total), so the chain of a 1 MiB group (1024 steps
// on the byte wire, 512 on pair, 256 on quad) is bounded by barrier and
// shared-memory latency, not by bytes (a group reads 1 MiB and writes about
// its compressed size).  One block per group leaves SMs idle when a batch
// has fewer groups than the card has SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kLanes = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int SPC>
__device__ __forceinline__ uint32_t symbol_of(uint32_t word, int p) {
  if (SPC == 4) return (word >> (8 * p)) & 0xFFu;
  if (SPC == 2) return (word >> (16 * p)) & 0xFFFFu;
  return word & 0xFFu;
}

// SYMS: table entries (256, 1024 or 4096); OutT: the stream's element,
// uint16_t for the packed wire, int32_t for one halfword per i32.
template <int SPC, int SYMS, typename OutT>
__global__ void __launch_bounds__(kLanes)
rans_encode_lanes(const int32_t* __restrict__ fc_tables,
                  const int32_t* __restrict__ magic_tables,
                  const int32_t* __restrict__ src,
                  OutT* __restrict__ stream, int stream_hw,
                  int32_t* __restrict__ finals, int32_t* __restrict__ csize,
                  int32_t* __restrict__ stots, int t4_count, int tlog) {
  __shared__ uint32_t fc[SYMS];
  __shared__ uint32_t mg[SYMS];
  __shared__ int warp_cnt[2][32];

  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  const int row = k >> 7;
  for (int i = k; i < SYMS; i += kLanes) {
    fc[i] = static_cast<uint32_t>(fc_tables[static_cast<size_t>(g) * SYMS + i]);
    mg[i] = static_cast<uint32_t>(magic_tables[static_cast<size_t>(g) * SYMS + i]);
  }
  __syncthreads();

  const int32_t* s = src + static_cast<size_t>(g) * t4_count * kLanes + k;
  OutT* hw = stream + static_cast<size_t>(g) * stream_hw;
  int32_t* st = stots ? stots + static_cast<size_t>(g) * t4_count * SPC * 8 : nullptr;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane
  const int shift = 32 - tlog;

  uint32_t x = kRansL;
  int cursor = 0;
  int buf = 0;
  for (int t4 = t4_count - 1; t4 >= 0; --t4) {
    const uint32_t word = static_cast<uint32_t>(s[static_cast<size_t>(t4) * kLanes]);
#pragma unroll
    for (int p = SPC - 1; p >= 0; --p) {
      const uint32_t sym = symbol_of<SPC>(word, p);
      const bool known = sym < static_cast<uint32_t>(SYMS);
      const uint32_t e = known ? fc[sym] : 0u;
      const uint32_t m = known ? mg[sym] : 0u;
      // 4096-entry tables hold 14-bit fields (tableLog up to 13)
      const uint32_t f = SYMS == 4096 ? e & 0x3FFFu : e & 0xFFFu;
      const uint32_t cu = SYMS == 4096 ? e >> 14 : (e >> 12) & 0xFFFu;
      const bool flag = x >= (f << shift);
      const uint32_t emit = x & 0xFFFFu;
      if (flag) x >>= 16;
      uint32_t q = __umulhi(x, m);
      uint32_t r = x - q * f;
      if (r >= f) { ++q; r -= f; }
      if (r >= f) { ++q; r -= f; }
      x = (q << tlog) + cu + r;

      // flat inclusive rank: ballot within the warp, scan across warps.
      // warp_cnt is double-buffered, so one barrier per step suffices.
      const unsigned b = __ballot_sync(kFull, flag);
      if (lane == 0) warp_cnt[buf][w] = __popc(b);
      __syncthreads();
      int incl = warp_cnt[buf][lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int before = __shfl_sync(kFull, incl, (w + 31) & 31);
      const int total = __shfl_sync(kFull, incl, 31);
      const int row_hi = __shfl_sync(kFull, incl, 4 * row + 3);
      const int row_lo = __shfl_sync(kFull, incl, (4 * row + 31) & 31);
      if (flag) {
        const int rank = (w ? before : 0) + __popc(b & le_mask);
        const int pos = cursor + total - rank;
        if (pos < stream_hw) hw[pos] = static_cast<OutT>(emit);
      }
      if (st && (k & 127) == 0) st[(SPC * t4 + p) * 8 + row] = row_hi - (row ? row_lo : 0);
      cursor += total;
      buf ^= 1;
    }
  }
  finals[static_cast<size_t>(g) * kLanes + k] = static_cast<int32_t>(x);
  if (k == 0) csize[g] = cursor;
}

template <int SPC, int SYMS, typename OutT>
int launch(const void* fc, const void* magic, const void* src, void* stream,
           int stream_hw, void* finals, void* csize, void* stots, int groups,
           int t4_count, int tlog, void* cuda_stream) {
  rans_encode_lanes<SPC, SYMS, OutT>
      <<<groups, kLanes, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
          static_cast<const int32_t*>(fc), static_cast<const int32_t*>(magic),
          static_cast<const int32_t*>(src), static_cast<OutT*>(stream),
          stream_hw, static_cast<int32_t*>(finals),
          static_cast<int32_t*>(csize), static_cast<int32_t*>(stots),
          t4_count, tlog);
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
// [G, 1024] i32; csize: [G] i32; stots: [G, spc*t4_count, 8] i32, or null.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int rans_encode_launch(const void* fc, const void* magic,
                                  const void* src, void* stream, int stream_hw,
                                  void* finals, void* csize, void* stots,
                                  int groups, int t4_count, int tlog, int spc,
                                  int nch, int packed, void* cuda_stream) {
  const Launch run = packed ? pick<uint16_t>(spc, nch * 128)
                            : pick<int32_t>(spc, nch * 128);
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(fc, magic, src, stream, stream_hw, finals, csize, stots, groups,
             t4_count, tlog, cuda_stream);
}
