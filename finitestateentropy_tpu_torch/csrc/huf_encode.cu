// 4-stream Huff0 encode for Hopper (sm_90a), a batch of blocks a launch.
//
// Replaces finitestateentropy_tpu/ops/huf_kernels.py:huf_encode_4x_batch,
// per-symbol (value, nbBits) gathers and a prefix-sum bit pack per stream
// (ops/bitio.py:pack_fields).  The output equals the plain version
// ops/huf_kernels.py:huf_encode_4x_batch_plain bit for bit.
//
// The function.  Block b of n bytes splits into four segments of
// seg = (n+3)/4 bytes, the fourth n - 3*seg (never below 0).  Stream k
// holds the codes of its segment's bytes in descending position order, each
// value masked to its nbBits, then a 1-bit endMark; a stream has at most
// seg_cap + 1 fields, seg_cap = (max_block+3)/4 (only a block longer than
// max_block reaches the limit, and loses its endMark).  sizes[b, k] is the
// stream's length in bytes.  The words past a stream's size are 0, and the
// words past the row's W are dropped but counted in the size.  Positions
// and symbols clamp into the row and the tables, as the JAX gathers do.
//
// The design.  The function has no loop-carried state but the bit cursor
// (huf_kernels.py:3-6), so a stream is split over a warp: a CTA is one
// block, warp k runs stream k (2048 blocks of 32 KiB: 2048 CTAs of 128
// threads, 12 an SM at 40 registers).  The block's code table sits in
// shared memory as one u32 a symbol, (value & mask(nbBits)) | nbBits << 16.
// The stream goes in chunks of 128 fields, four consecutive fields a lane:
// the lane loads their bytes (one aligned word where the segment allows, a
// chunk ahead, so the load is in flight while the chunk before is placed),
// looks up their codes and joins them into one 64-bit field; a warp scan of
// the lanes' widths gives each its bit offset from the stream's running
// total; each lane ORs its bits into the warp's shared word buffer (at most
// three words, lane 0 with the carried bits of the chunk before), and the
// warp stores the full words coalesced and carries the last partial word
// into the next chunk, as the FSE encode's placement (fse_encode.cu).  The
// endMark is the field after the last code.  The warp then stores the
// partial word and zeroes the row's words past it, so the kernel writes
// every output word.  A table with an nbBits outside [0, 16] (never one
// huf_build_ctable gives) makes the CTA run the first design: one thread a
// stream through a 64-bit bit container.
//
// What bounds it on the H100: its integer operations (about 10 a symbol:
// the byte load, the code lookup, the mask and the bit placement), 0.04 ms
// for the 64 MiB of a 2048-block batch; the bytes (the source read once,
// the streams written once) take less.  The kernel is bound by its
// instruction issue instead (the loads, lookups, scan, placement and stores
// of each chunk), at about three times the operations bound.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"

namespace {

using compat::BitSink;
using compat::clampi;
using compat::mask32;

constexpr int kThreads = 128;              // a warp a stream, a block a CTA
constexpr int kPerLane = 4;                // consecutive fields a lane joins
constexpr int kChunk = 32 * kPerLane;      // fields a warp places at once
constexpr int kMaxNb = 16;                 // the shared form: kPerLane fields in 64 bits
constexpr int kSyms = 256;                 // byte symbols
// a warp's word buffer: the carried word and a chunk's bits, and the two
// words a lane's 64 bits can spill past the last
constexpr int kBuf = (31 + kChunk * kMaxNb) / 32 + 3;
constexpr int kBufs = 3;                   // chunk c fills buffer c % 3, zeroes (c - 1) % 3
constexpr int kBufLanes = (kBuf + 31) / 32;  // a buffer's words a lane stores or zeroes
static_assert(kPerLane == 4 && kPerLane * kMaxNb <= 64,
              "a lane's bytes are one word, its fields one 64-bit field");

// The first design: one thread writes stream k of block b through a 64-bit
// bit container; the row, zeroed first by the warp, keeps 0 past its size.
__device__ void encode_serial(const uint8_t* __restrict__ row, int S, int nn,
                              const int32_t* __restrict__ vt, const int32_t* __restrict__ bt,
                              int nsym, uint32_t* __restrict__ orow, int W, int k,
                              int max_block, int32_t* __restrict__ size) {
  const int seg = (nn + 3) >> 2;           // floor division, as JAX's //
  const int start = k * seg;
  const int seg_len = max(k < 3 ? seg : nn - 3 * seg, 0);
  const int fields = (max_block + 3) / 4 + 1;
  const int active = min(seg_len, fields);
  BitSink out(orow, W);
  const int top = start + seg_len - 1;
  for (int e = 0; e < active; ++e) {
    const int s = clampi(__ldg(row + clampi(top - e, 0, S - 1)), 0, nsym - 1);
    out.put(static_cast<uint32_t>(__ldg(vt + s)), __ldg(bt + s));
  }
  if (seg_len < fields) out.put(1u, 1);    // the endMark
  out.finish();
  *size = out.bytes();
}

__global__ void __launch_bounds__(kThreads)
huf_encode_kernel(const uint8_t* __restrict__ src, int S,
                  const int32_t* __restrict__ n,
                  const int32_t* __restrict__ val,
                  const int32_t* __restrict__ nbt, int nsym,
                  uint32_t* __restrict__ words, int W,
                  int32_t* __restrict__ sizes, int max_block) {
  __shared__ uint32_t code[kSyms];
  __shared__ uint32_t wbuf[kThreads / 32][kBufs][kBuf];
  const int b = blockIdx.x;
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* vt = val + static_cast<size_t>(b) * nsym;
  const int32_t* bt = nbt + static_cast<size_t>(b) * nsym;
  bool ok = true;
  for (int s = threadIdx.x; s < kSyms; s += kThreads) {
    const int sc = min(s, nsym - 1);
    const int nb = __ldg(bt + sc);
    ok &= nb >= 0 && nb <= kMaxNb;
    code[s] = (static_cast<uint32_t>(__ldg(vt + sc)) & mask32(nb)) |
              static_cast<uint32_t>(nb) << 16;
  }
  for (int i = threadIdx.x; i < (kThreads / 32) * kBufs * kBuf; i += kThreads)
    (&wbuf[0][0][0])[i] = 0;
  const bool shared_form = __syncthreads_and(ok);

  const uint8_t* row = src + static_cast<size_t>(b) * S;
  uint32_t* orow = words + static_cast<size_t>(4 * b + k) * W;
  const int nn = n[b];
  if (!shared_form) {
    for (int i = lane; i < W; i += 32) orow[i] = 0;
    __syncwarp();
    if (lane == 0)
      encode_serial(row, S, nn, vt, bt, nsym, orow, W, k, max_block, sizes + 4 * b + k);
    return;
  }

  const int seg = (nn + 3) >> 2;           // floor division, as JAX's //
  const int start = k * seg;
  const int seg_len = max(k < 3 ? seg : nn - 3 * seg, 0);
  const int fields = (max_block + 3) / 4 + 1;
  const int active = min(seg_len, fields);
  const int end_mark = seg_len < fields ? seg_len : -1;   // the endMark's field
  const int count = active + (end_mark >= 0);             // fields with bits
  const int top = start + seg_len - 1;
  int pos = 0;             // bits placed so far
  uint32_t carry = 0;      // the bits of word pos / 32 placed so far
  int prev_end = 0;        // the words the chunk before filled, less one
  uint32_t* const bufs = &wbuf[k][0][0];
  int buf = 0;             // the buffer this chunk fills
  // chunk c: lane i's fields 4i..4i+3, joined first field lowest into acc,
  // width bits, placed after the chunk before
  auto place = [&](uint64_t acc, int width) {
    int incl = width;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    // buffer word 0 is the stream's word pos / 32; lane 0's bits start at
    // pos % 32, and it ORs in the carried bits below them
    uint32_t* wb = bufs + buf * kBuf;
    const int off = (pos & 31) + incl - width;
    const int w = off >> 5, sh = off & 31;
    const uint32_t lo = static_cast<uint32_t>(acc), hi = static_cast<uint32_t>(acc >> 32);
    if (width > 0 || lane == 0) atomicOr(wb + w, lo << sh | (lane == 0 ? carry : 0u));
    if (sh + width > 32) atomicOr(wb + w + 1, __funnelshift_l(lo, hi, sh));
    if (sh + width > 64) atomicOr(wb + w + 2, hi >> (32 - sh));
    __syncwarp();
    const int end = (pos & 31) + total;
    const int g0 = pos >> 5;
#pragma unroll
    for (int j = 0; j < kBufLanes; ++j) {
      const int i = lane + 32 * j;
      if (i < end >> 5 && g0 + i < W) orow[g0 + i] = wb[i];
    }
    carry = wb[end >> 5];
    // the buffer the chunk before filled, read before this chunk's
    // __syncwarp, zeroed before the next one's, filled again the chunk after
    uint32_t* old = bufs + (buf == 0 ? kBufs - 1 : buf - 1) * kBuf;
#pragma unroll
    for (int j = 0; j < kBufLanes; ++j) {
      const int i = lane + 32 * j;
      if (i <= prev_end) old[i] = 0;
    }
    prev_end = end >> 5;
    buf = buf == kBufs - 1 ? 0 : buf + 1;
    pos += total;
  };

  // field e is the byte at top - e.  Whole chunks of a segment that ends a
  // 4-byte word inside the row (the codec's): a lane's four bytes are one
  // aligned word (field 4i + q its byte 3 - q), loaded a chunk ahead
  int c = 0;
  const bool by_word = ((top + 1) & 3) == 0 && top < S && (S & 3) == 0 &&
                       reinterpret_cast<uintptr_t>(src) % 4 == 0;
  const int whole = by_word ? active / kChunk : 0;
  if (whole > 0) {
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(row);
    const int w0 = (top - 3 - kPerLane * lane) >> 2;
    uint32_t next = __ldg(wrow + w0);
    for (; c < whole; ++c) {
      const uint32_t wd = next;
      if (c + 1 < whole) next = __ldg(wrow + w0 - (c + 1) * (kChunk / 4));
      uint64_t acc = 0;
      int width = 0;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const uint32_t cd = code[(wd >> (24 - 8 * q)) & 0xFF];
        acc |= static_cast<uint64_t>(cd & 0xFFFFu) << width;
        width += static_cast<int>(cd >> 16);
      }
      place(acc, width);
    }
  }
  // the other chunks: byte loads clamped into the row; the fields past
  // `active` are empty but the endMark
  uint32_t next[kPerLane];
  auto fetch = [&](int c) {
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      next[q] = __ldg(row + clampi(top - (c * kChunk + kPerLane * lane + q), 0, S - 1));
  };
  if (c * kChunk < count) fetch(c);
  for (; c * kChunk < count; ++c) {
    uint32_t sym[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) sym[q] = next[q];
    if ((c + 1) * kChunk < active) fetch(c + 1);
    const int e0 = c * kChunk + kPerLane * lane;
    uint64_t acc = 0;
    int width = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int e = e0 + q;
      const uint32_t cd = e < active ? code[sym[q]] : (e == end_mark ? 1u | 1u << 16 : 0u);
      acc |= static_cast<uint64_t>(cd & 0xFFFFu) << width;
      width += static_cast<int>(cd >> 16);
    }
    place(acc, width);
  }
  // the last partial word, the words past it zeroed, the size
  if (lane == 0 && (pos & 31) && (pos >> 5) < W) orow[pos >> 5] = carry;
  for (int i = ((pos + 31) >> 5) + lane; i < W; i += 32) orow[i] = 0;
  if (lane == 0) sizes[4 * b + k] = (pos + 7) >> 3;
}

}  // namespace

extern "C" int huf_encode_launch(const void* src, int S, const void* n,
                                 const void* val, const void* nbt, int nsym,
                                 void* words, int W, void* sizes, int B,
                                 int max_block, void* cuda_stream) {
  if (B < 0 || S < 1 || nsym < 1 || W < 1 || max_block < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  huf_encode_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(src), S, static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(val), static_cast<const int32_t*>(nbt), nsym,
      static_cast<uint32_t*>(words), W, static_cast<int32_t*>(sizes), max_block);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for B blocks: {blocks a CTA, threads, shared bytes, CTAs
// an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor), CTAs, SMs}.
extern "C" int huf_encode_config(int B, int* cfg) {
  int resident = 0, dev = 0, sms = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, huf_encode_kernel,
                                                                 kThreads, 0);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cfg[0] = 1;
  cfg[1] = kThreads;
  cfg[2] = static_cast<int>(sizeof(uint32_t) * (kSyms + (kThreads / 32) * kBufs * kBuf));
  cfg[3] = resident;
  cfg[4] = std::max(B, 1);
  cfg[5] = sms;
  return static_cast<int>(rc);
}
