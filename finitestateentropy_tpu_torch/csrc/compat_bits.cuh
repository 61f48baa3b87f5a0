// Bit I/O of the compat codecs' kernels (fse_encode.cu, fse_decode.cu,
// huf_encode.cu, huf_decode.cu): the device side of ops/bitio.py.
//
// Streams are little-endian u32 words, LSB first.  A read takes a field of
// nb bits at an absolute bit offset exactly as the JAX package's
// read_bits / _read_bits_batch do (ops/bitio.py:38-59,
// ops/fse_kernels.py:34-54): the offset clamped at 0, both word indices at
// the stream's last word, the two words funnel-shifted, the mask taken as
// a u32 shift (nb >= 32, or negative, gives all ones).  So a corrupt stream
// reads in bounds and gives the plain version's garbage, bit for bit.  A
// write appends fields to a 64-bit container and stores each full u32 word
// forward, the order pack_fields' prefix sum places them in; words past
// the row's capacity are dropped, as pack_fields drops them.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace compat {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ uint32_t mask32(int nb) {
  return static_cast<unsigned>(nb) >= 32u ? 0xFFFFFFFFu : (1u << nb) - 1u;
}

// Field of nb bits at bit offset bitpos of words[0..wmax].
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ words,
                                              int wmax, int bitpos, int nb) {
  const int bp = max(bitpos, 0);
  const int word = bp >> 5;
  const uint32_t w0 = __ldg(words + min(word, wmax));
  const uint32_t w1 = __ldg(words + min(word + 1, wmax));
  return __funnelshift_r(w0, w1, bp & 31) & mask32(nb);
}

// BIT_initDStream's start (bitstream.h:282-284), as ops/bitio.py's
// initial_bitpos: the endMark's bit offset from the highest set bit of the
// stream's last byte (byte index clamped into the row); bad when that byte
// is 0; bitpos 0 for an empty stream.
__device__ __forceinline__ int initial_bitpos(const uint8_t* __restrict__ row,
                                              int S, int csize, bool* bad) {
  const uint32_t last = row[clampi(max(csize - 1, 0), 0, S - 1)];
  *bad = last == 0;
  const int hb = 31 - __clz(max(last, 1u));
  return csize > 0 ? (csize - 1) * 8 + hb : 0;
}

// Forward LSB-first writer of (value, nb) fields into one row of u32 words.
struct BitSink {
  uint32_t* row;
  int cap;          // words the row holds
  int wi;           // next word to store
  int nacc;         // bits held in acc, < 32 between puts
  uint64_t acc;
  long long total;  // bits emitted, stored or dropped

  __device__ __forceinline__ BitSink(uint32_t* r, int c)
      : row(r), cap(c), wi(0), nacc(0), acc(0), total(0) {}

  // nb in [0, 32]: the codec's fields are at most tableLog + 1 bits
  __device__ __forceinline__ void put(uint32_t v, int nb) {
    acc |= static_cast<uint64_t>(v & mask32(nb)) << nacc;
    nacc += nb;
    total += nb;
    if (nacc >= 32) {
      if (wi < cap) row[wi] = static_cast<uint32_t>(acc);
      ++wi;
      acc >>= 32;
      nacc -= 32;
    }
  }

  __device__ __forceinline__ void finish() {
    if (nacc > 0 && wi < cap) row[wi] = static_cast<uint32_t>(acc);
  }

  __device__ __forceinline__ int bytes() const {
    return static_cast<int>((total + 7) >> 3);
  }
};

}  // namespace compat
