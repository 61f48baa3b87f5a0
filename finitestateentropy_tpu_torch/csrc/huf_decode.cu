// 4-stream Huff0 decode for Hopper (sm_90a), single- (x1) and double-symbol
// (x2) tables, a batch of streams a launch.
//
// Replaces finitestateentropy_tpu/ops/huf_kernels.py:huf_decode_4x1_batch
// (mode x1) and huf_decode_4x2_batch (mode x2), each a fori_loop of one
// lookup a step vectorized over the 4*B streams.  The outputs equal the
// plain versions ops/huf_kernels.py:huf_decode_4x1_batch_plain /
// huf_decode_4x2_batch_plain bit for bit.
//
// The function.  Stream r is csize bytes of its zero-padded row, read
// backward from the endMark (the last byte's highest set bit).  A lookup
// takes the dtLog bits below the bit cursor, zero-filled at the bottom when
// fewer remain (lookBitsFast), as a table index:
//   x1: the entry gives one byte and its nbBits; the cursor drops by nbBits;
//       n_out lookups;
//   x2: the entry (pack_dtable_x2: seq_lo | seq_hi << 8 | nbBits << 16 |
//       (length-1) << 22) gives one or two bytes; at the last position a
//       length-2 entry writes only its first byte and the cursor stops at 0
//       (HUF_decodeLastSymbolX2); lookups until n_out bytes are written.
// err is the cursor not at 0 at the end (x2: or the bytes written not
// n_out), or a missing endMark, where n_out > 0.  At most max_seg lookups
// run.  Table indices clamp into the table and stream reads into the row
// (compat_bits.cuh), so a corrupt stream gives the plain version's bytes.
//
// The design.  One thread a stream: the chain is serial by nature (the
// next index is known only once the entry's nbBits is).  The tables are
// read through the read-only path, one row a stream as the JAX layout has
// them (each block's table repeated for its four streams); the output
// bytes are stored one (or two) at a time, and the wrapper zero-fills the
// rows.
//
// What bounds it on the H100: the chain of seg dependent steps a stream
// (8192 at 32 KiB blocks), each a stream read, then a table lookup whose
// index depends on it.  2048 blocks give 8192 threads, about 62 an SM, and
// their tables (2^tableLog entries each, repeated per stream) overflow L1,
// so most lookups go to L2.  The later redesign stages one table a block in
// shared memory (the four streams share it) and keeps a register bit
// window, leaving one shared lookup a step.
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"

namespace {

using compat::clampi;
using compat::read_bits;

constexpr int kThreads = 32;

template <bool kX2>
__global__ void huf_decode_kernel(const uint8_t* __restrict__ streams, int S,
                                  const int32_t* __restrict__ csize,
                                  const int32_t* __restrict__ n_out,
                                  const int32_t* __restrict__ tlog,
                                  const void* __restrict__ tbl0,
                                  const void* __restrict__ tbl1, int T,
                                  uint8_t* __restrict__ out, int max_seg,
                                  bool* __restrict__ err, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint8_t* row = streams + static_cast<size_t>(r) * S;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const int wmax = S / 4 - 1;
  bool bad;
  int bitpos = compat::initial_bitpos(row, S, csize[r], &bad);
  const int dt_log = tlog[r];
  const int nout = n_out[r];
  uint8_t* orow = out + static_cast<size_t>(r) * max_seg;
  const size_t base = static_cast<size_t>(r) * T;

  auto index = [&]() {             // lookBitsFast, zero-filled at the bottom
    const int avail = min(dt_log, max(bitpos, 0));
    const int raw = static_cast<int>(read_bits(words, wmax, bitpos - avail, avail));
    return clampi(raw << (dt_log - avail), 0, T - 1);
  };

  bool fail;
  if constexpr (!kX2) {
    const uint8_t* bytes = static_cast<const uint8_t*>(tbl0) + base;
    const uint8_t* nbs = static_cast<const uint8_t*>(tbl1) + base;
    const int steps = min(nout, max_seg);
    for (int i = 0; i < steps; ++i) {
      const int v = index();
      orow[i] = __ldg(bytes + v);
      bitpos -= __ldg(nbs + v);
    }
    fail = bitpos != 0;
  } else {
    const int32_t* tbl = static_cast<const int32_t*>(tbl0) + base;
    int p = 0;
    for (int i = 0; i < max_seg && p < nout; ++i) {
      const int e = __ldg(tbl + index());
      const int nb = (e >> 16) & 0x3F;
      const bool two = ((e >> 22) & 1) == 1;
      const bool is_last = two && p == nout - 1;
      // the JAX buffer has max_seg + 1 bytes (a 2-byte write's slack) and
      // drops writes past it; the slack byte is cut off
      if (p < max_seg) orow[p] = static_cast<uint8_t>(e & 0xFF);
      if (two && !is_last && p + 1 < max_seg) orow[p + 1] = static_cast<uint8_t>((e >> 8) & 0xFF);
      bitpos = is_last ? max(bitpos - nb, 0) : bitpos - nb;
      p += (two && !is_last) ? 2 : 1;
    }
    fail = bitpos != 0 || p != nout;
  }
  err[r] = nout > 0 && (fail || bad);
}

}  // namespace

extern "C" int huf_decode_launch(const void* streams, int S, const void* csize,
                                 const void* n_out, const void* tlog,
                                 const void* tbl0, const void* tbl1, int T, int x2,
                                 void* out, int max_seg, void* err, int R,
                                 void* cuda_stream) {
  if (R < 0 || S < 4 || S % 4 || T < 1 || max_seg < 0 ||
      reinterpret_cast<uintptr_t>(streams) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const dim3 grid((R + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* st = static_cast<const uint8_t*>(streams);
  if (x2)
    huf_decode_kernel<true><<<grid, kThreads, 0, s>>>(
        st, S, static_cast<const int32_t*>(csize), static_cast<const int32_t*>(n_out),
        static_cast<const int32_t*>(tlog), tbl0, tbl1, T, static_cast<uint8_t*>(out),
        max_seg, static_cast<bool*>(err), R);
  else
    huf_decode_kernel<false><<<grid, kThreads, 0, s>>>(
        st, S, static_cast<const int32_t*>(csize), static_cast<const int32_t*>(n_out),
        static_cast<const int32_t*>(tlog), tbl0, tbl1, T, static_cast<uint8_t*>(out),
        max_seg, static_cast<bool*>(err), R);
  return static_cast<int>(cudaGetLastError());
}
