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
// stream's length in bytes.  Positions and symbols clamp into the row and
// the tables, as the JAX gathers do.
//
// The design.  One thread a stream (four a block), writing its fields
// forward through a 64-bit bit container (compat_bits.cuh: BitSink): the
// emission order is the stream order, so no prefix sum or scatter is
// needed.  The wrapper zero-fills the rows, so the words past a stream's
// size are 0 as the JAX pack gives them.  The code tables (256 values and
// nbBits a block, 2 KiB) are read through the read-only path.
//
// What bounds it on the H100: there is no loop-carried state but the bit
// cursor (huf_kernels.py:3-6), so the function is bound by its bytes: the
// source read once and the streams written once, 64 MiB in and about 50 MiB
// out at 32 KiB blocks of Proba80 (about 0.035 ms at 3.35 TB/s).  This
// first design walks each stream serially, seg steps of byte loads and
// table reads on one thread, with 8192 threads on the card at 2048 blocks:
// it is bound by that walk, far from the bytes.  The later redesign splits
// a stream over a warp (codes and their widths, a warp prefix sum of the
// widths, then each thread places its bits).
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"

namespace {

using compat::BitSink;
using compat::clampi;

constexpr int kThreads = 32;

__global__ void huf_encode_kernel(const uint8_t* __restrict__ src, int S,
                                  const int32_t* __restrict__ n,
                                  const int32_t* __restrict__ val,
                                  const int32_t* __restrict__ nbt, int nsym,
                                  uint32_t* __restrict__ words, int W,
                                  int32_t* __restrict__ sizes, int B,
                                  int max_block) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= 4 * B) return;
  const int b = g >> 2, k = g & 3;
  const uint8_t* row = src + static_cast<size_t>(b) * S;
  const int32_t* vt = val + static_cast<size_t>(b) * nsym;
  const int32_t* bt = nbt + static_cast<size_t>(b) * nsym;
  const int nn = n[b];
  const int seg = (nn + 3) >> 2;           // floor division, as JAX's //
  const int start = k * seg;
  const int seg_len = max(k < 3 ? seg : nn - 3 * seg, 0);
  const int fields = (max_block + 3) / 4 + 1;
  const int active = min(seg_len, fields);
  BitSink out(words + static_cast<size_t>(g) * W, W);
  const int top = start + seg_len - 1;
  for (int e = 0; e < active; ++e) {
    const int s = clampi(__ldg(row + clampi(top - e, 0, S - 1)), 0, nsym - 1);
    out.put(static_cast<uint32_t>(__ldg(vt + s)), __ldg(bt + s));
  }
  if (seg_len < fields) out.put(1u, 1);    // the endMark
  out.finish();
  sizes[g] = out.bytes();
}

}  // namespace

extern "C" int huf_encode_launch(const void* src, int S, const void* n,
                                 const void* val, const void* nbt, int nsym,
                                 void* words, int W, void* sizes, int B,
                                 int max_block, void* cuda_stream) {
  if (B < 0 || S < 1 || nsym < 1 || W < 1 || max_block < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  huf_encode_kernel<<<(4 * B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(src), S, static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(val), static_cast<const int32_t*>(nbt), nsym,
      static_cast<uint32_t*>(words), W, static_cast<int32_t*>(sizes), B, max_block);
  return static_cast<int>(cudaGetLastError());
}
