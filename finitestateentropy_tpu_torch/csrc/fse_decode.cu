// FSE (tANS) block decode for Hopper (sm_90a), a batch of blocks a launch.
//
// Replaces finitestateentropy_tpu/ops/fse_kernels.py:fse_decode_batch, a
// lax.scan of two symbols a step batched over blocks.  The output equals
// the plain version ops/fse_kernels.py:fse_decode_batch_plain bit for bit.
//
// The function.  Block b's stream is csize bytes of the zero-padded row; the
// endMark's position (the last byte's highest set bit) is bitpos0.  state1
// and state2 are the tableLog-bit fields just below it.  Step t gives symbols
// 2t (state1) and 2t+1 (state2): each state's packed entry newState << 16 |
// nbBits << 8 | symbol names the symbol, and the state moves to newState +
// the nbBits field read just below the bit cursor.  A symbol past n_out
// freezes its state and reads as 0.  The bit cursor after symbol n_out - 3
// must be exactly 0 (the last two symbols are the encoder's free initial
// states, whose reads run past bit 0 and are clamped there); err is that
// check failing where n_out > 2, or a missing endMark.  Reads clamp the
// offset at 0 and the word index at the row's last word (compat_bits.cuh),
// so a corrupt stream reads inside its row and gives the plain version's
// bytes.
//
// The design.  One thread a block walks the steps up to n_out; the two
// states' table lookups of a step are independent and overlap.  The packed
// table (the wrapper packs it, as the JAX decode packs it before its scan) is
// read through the read-only path: a block's live part is 2^tableLog words
// (8 KiB at tableLog 11), and sixteen threads a CTA keep an SM's tables near
// its L1.  The stream words are read where the cursor points, two u32 loads
// and a funnel shift a field.  Each step stores its two bytes as one u16;
// the wrapper zero-fills the rows, so the bytes past n_out are 0.
//
// What bounds it on the H100: the chain of n_out/2 steps a block, each a
// table lookup, then the field read at a cursor that depends on it (two
// dependent loads a step).  2048 blocks of 32 KiB are 2048 threads, about
// 16 an SM, so neither the issue rate nor memory is near busy.  A register
// bit window refilled a word at a time would take the stream read off the
// chain; a block split over threads needs the bit offsets of its fields
// first, which the FSE wire does not carry.
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"

namespace {

using compat::clampi;
using compat::read_bits;

constexpr int kThreads = 16;

__global__ void fse_decode_kernel(const uint8_t* __restrict__ streams, int S,
                                  const int32_t* __restrict__ csize,
                                  const int32_t* __restrict__ n_out,
                                  const int32_t* __restrict__ tlog,
                                  const uint32_t* __restrict__ packed, int T,
                                  uint8_t* __restrict__ out, int max_out,
                                  bool* __restrict__ err, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = streams + static_cast<size_t>(b) * S;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const int wmax = S / 4 - 1;
  const uint32_t* pk = packed + static_cast<size_t>(b) * T;
  bool bad;
  const int bitpos0 = compat::initial_bitpos(row, S, csize[b], &bad);

  const int tl = tlog[b];
  int bitpos = bitpos0 - tl;
  int s1 = static_cast<int>(read_bits(words, wmax, bitpos, tl));
  bitpos -= tl;
  int s2 = static_cast<int>(read_bits(words, wmax, bitpos, tl));

  const int nout = n_out[b];
  const int steps = min(max_out / 2, nout > 0 ? (nout + 1) / 2 : 0);
  uint16_t* orow = reinterpret_cast<uint16_t*>(out + static_cast<size_t>(b) * max_out);
  int bp_check = -1;
  for (int t = 0; t < steps; ++t) {
    const int i0 = 2 * t;
    const bool a0 = i0 < nout, a1 = i0 + 1 < nout;
    const uint32_t e1 = __ldg(pk + clampi(s1, 0, T - 1));   // even index: state1
    const uint32_t e2 = __ldg(pk + clampi(s2, 0, T - 1));
    const int nb0 = (e1 >> 8) & 0xFF, nb1 = (e2 >> 8) & 0xFF;
    const int bp0 = bitpos - nb0;
    const int bp1 = bp0 - nb1;
    const int ns1 = static_cast<int>(e1 >> 16) + static_cast<int>(read_bits(words, wmax, bp0, nb0));
    const int ns2 = static_cast<int>(e2 >> 16) + static_cast<int>(read_bits(words, wmax, bp1, nb1));
    if (a0) s1 = ns1;
    if (a1) s2 = ns2;
    if (i0 == nout - 3) bp_check = bp0;
    if (i0 + 1 == nout - 3) bp_check = bp1;
    bitpos = a1 ? bp1 : (a0 ? bp0 : bitpos);
    orow[t] = static_cast<uint16_t>((a0 ? (e1 & 0xFF) : 0u) | ((a1 ? (e2 & 0xFF) : 0u) << 8));
  }
  err[b] = (bp_check != 0 && nout > 2) || bad;
}

}  // namespace

extern "C" int fse_decode_launch(const void* streams, int S, const void* csize,
                                 const void* n_out, const void* tlog,
                                 const void* packed, int T, void* out, int max_out,
                                 void* err, int B, void* cuda_stream) {
  if (B < 0 || S < 4 || S % 4 || T < 1 || max_out < 0 || max_out % 2 ||
      reinterpret_cast<uintptr_t>(streams) % 4 || reinterpret_cast<uintptr_t>(out) % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  fse_decode_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(streams), S, static_cast<const int32_t*>(csize),
      static_cast<const int32_t*>(n_out), static_cast<const int32_t*>(tlog),
      static_cast<const uint32_t*>(packed), T, static_cast<uint8_t*>(out), max_out,
      static_cast<bool*>(err), B);
  return static_cast<int>(cudaGetLastError());
}
