// TurboRANS byte-wire encode for Hopper (sm_90a).
//
// Replaces finitestateentropy_tpu/turbo/rans_kernels.py:_rans_encode_rl_kernel
// (rans_encode2(..., rowloc=True)), and computes the same wire as
// _rans_encode2_kernel.  The output bytes equal the numpy twin
// turbo/rans.py:rans_compress.
//
// One block of 1024 threads per group; thread k is lane k (row k>>7, column
// k&127), so row r is warps 4r..4r+3.  Steps run in reverse, as rANS
// encodes: step t = 4*t4 + p takes byte p of the lane's source word t4.
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
// stots[t][row]: the FLAG_STEPTOTS section.
//
// What bounds it: the x chain is a few dependent integer ops per step and
// runs at ALU latency, but every step ends in one block-wide barrier (the
// cursor needs the step's total), so the 1024-step chain of a 1 MiB group
// is bounded by barrier and shared-memory latency, not by bytes (a group
// reads 1 MiB and writes about its compressed size).  One block per group
// leaves SMs idle when a batch has fewer groups than the card has SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kLanes = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kLanes)
rans_encode_lanes(const int32_t* __restrict__ fc_tables,
                  const int32_t* __restrict__ magic_tables,
                  const int32_t* __restrict__ src,
                  uint16_t* __restrict__ stream, int stream_hw,
                  int32_t* __restrict__ finals, int32_t* __restrict__ csize,
                  int32_t* __restrict__ stots, int t4_count, int tlog) {
  __shared__ uint32_t fc[256];
  __shared__ uint32_t mg[256];
  __shared__ int warp_cnt[2][32];

  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  const int row = k >> 7;
  if (k < 256) {
    fc[k] = static_cast<uint32_t>(fc_tables[g * 256 + k]);
    mg[k] = static_cast<uint32_t>(magic_tables[g * 256 + k]);
  }
  __syncthreads();

  const int32_t* s = src + static_cast<size_t>(g) * t4_count * kLanes + k;
  uint16_t* hw = stream + static_cast<size_t>(g) * stream_hw;
  int32_t* st = stots + static_cast<size_t>(g) * t4_count * 4 * 8;
  const unsigned le_mask = 0xFFFFFFFFu >> (31 - lane);   // lanes <= lane
  const int shift = 32 - tlog;

  uint32_t x = kRansL;
  int cursor = 0;
  int buf = 0;
  for (int t4 = t4_count - 1; t4 >= 0; --t4) {
    const uint32_t word = static_cast<uint32_t>(s[static_cast<size_t>(t4) * kLanes]);
#pragma unroll
    for (int p = 3; p >= 0; --p) {
      const uint32_t sym = (word >> (8 * p)) & 0xFFu;
      const uint32_t e = fc[sym];
      const uint32_t m = mg[sym];
      const uint32_t f = e & 0xFFFu;
      const uint32_t cu = (e >> 12) & 0xFFFu;
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
        if (pos < stream_hw) hw[pos] = static_cast<uint16_t>(emit);
      }
      if ((k & 127) == 0) st[(4 * t4 + p) * 8 + row] = row_hi - (row ? row_lo : 0);
      cursor += total;
      buf ^= 1;
    }
  }
  finals[static_cast<size_t>(g) * kLanes + k] = static_cast<int32_t>(x);
  if (k == 0) csize[g] = cursor;
}

}  // namespace

// fc, magic: [G, 256] i32; src: [G, t4_count*1024] i32 (4 source bytes per
// word); stream: [G, stream_hw] u16, zeroed by the caller; finals:
// [G, 1024] i32; csize: [G] i32; stots: [G, 4*t4_count, 8] i32.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int rans_encode_launch(const void* fc, const void* magic,
                                  const void* src, void* stream, int stream_hw,
                                  void* finals, void* csize, void* stots,
                                  int groups, int t4_count, int tlog,
                                  void* cuda_stream) {
  rans_encode_lanes<<<groups, kLanes, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(fc), static_cast<const int32_t*>(magic),
      static_cast<const int32_t*>(src), static_cast<uint16_t*>(stream),
      stream_hw, static_cast<int32_t*>(finals), static_cast<int32_t*>(csize),
      static_cast<int32_t*>(stots), t4_count, tlog);
  return static_cast<int>(cudaGetLastError());
}
