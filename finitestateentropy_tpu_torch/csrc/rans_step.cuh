// One TurboRANS decode step's table lookup and state advance, shared by the
// rows-wire kernel (rans_decode.cu) and the flat-rank kernel
// (rans_decode_flat.cu).  The modes follow the entry layouts of
// finitestateentropy_tpu/turbo/rans_kernels.py:_sym_advance (:122-174); x is
// the u32 coder state, M = 2^tlog, slot = x & (M-1), e = tbl[slot]:
//   byte (SPC 4):  e = (c << 20) | (f << 8) | sym
//   u16  (SPC 2):  e = (c << 21) | (f << 10) | sym        (symbols <= 1023)
//                  x = f * (x >> tlog) + slot - c;  value = sym
//   u16x (SPC 2):  e = (f << 13) | j,  j = slot - c;  tbl[aux + slot] = sym
//                  x = f * (x >> tlog) + j;  value = sym  (tableLog 12-13)
//   pair (SPC 2),  e = (id << 2*tlog) | (f << tlog) | j;  tbl[aux + id] = LUT
//   quad (SPC 1):  x = f * (x >> tlog) + j;  value = LUT[id]
// The u16x symbol and the pair / quad LUT value are read off the x chain.
// An id past the 256-entry LUT (only a corrupt table holds one) reads 0, as
// the TPU kernel's chunk select gives it.
#pragma once

#include <cstdint>

namespace rans_step {

enum Mode : int { kByte = 0, kPair = 1, kQuad = 2, kU16 = 3, kU16x = 4 };

constexpr uint32_t kRansL = 1u << 16;
constexpr int kLut = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// steps per output word: a word holds 4 bytes, 2 u16 values or 1 quad value
template <int MODE>
__host__ __device__ constexpr int spc() {
  return MODE == kByte ? 4 : MODE == kQuad ? 1 : 2;
}

// The table words a mode needs at tlog (main table, plus the LUT or the
// symbol plane); the launchers refuse smaller tables.
inline int table_words_needed(int mode, int tlog) {
  const int main = (1 << tlog) < 128 ? 128 : (1 << tlog);
  if (mode == kU16x) return 2 * main;
  if (mode == kPair || mode == kQuad) return main + kLut;
  return main;
}

// aux: u16x the symbol plane's first word, pair / quad the LUT's.
inline int aux_of(int mode, int table_words) {
  if (mode == kU16x) return table_words / 2;
  if (mode == kPair || mode == kQuad) return table_words - kLut;
  return 0;
}

// Advances x by one step and returns the step's output value.
template <int MODE>
__device__ __forceinline__ uint32_t advance(const uint32_t* tbl, int aux,
                                            uint32_t& x, int tlog,
                                            uint32_t mask) {
  const uint32_t slot = x & mask;
  const uint32_t e = tbl[slot];
  if constexpr (MODE == kByte) {
    x = ((e >> 8) & 0xFFFu) * (x >> tlog) + slot - (e >> 20);
    return e & 0xFFu;
  } else if constexpr (MODE == kU16) {
    x = ((e >> 10) & 0x7FFu) * (x >> tlog) + slot - (e >> 21);
    return e & 0x3FFu;
  } else if constexpr (MODE == kU16x) {
    x = (e >> 13) * (x >> tlog) + (e & 0x1FFFu);
    return tbl[aux + slot];
  } else {
    const uint32_t id = e >> (2 * tlog);
    x = ((e >> tlog) & mask) * (x >> tlog) + (e & mask);
    return id < static_cast<uint32_t>(kLut) ? tbl[aux + id] : 0u;
  }
}

}  // namespace rans_step
