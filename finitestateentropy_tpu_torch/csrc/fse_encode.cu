// FSE (tANS) block encode for Hopper (sm_90a), a batch of blocks a launch.
//
// Replaces finitestateentropy_tpu/ops/fse_kernels.py:fse_encode_batch, a
// lax.scan over the symbol index batched over blocks, whose fields are then
// packed by a scatter-add (ops/bitio.py:pack_fields).  The output equals the
// plain version ops/fse_kernels.py:fse_encode_batch_plain bit for bit.
//
// The function.  Block b holds n symbols; the two coder states start from
// FSE_initCState2 of the last two symbols (the even index seeds state1),
// then for j = n-3 down to 0 the state of j's parity (state2 on odd j)
// emits its low nb bits, nb = (state + deltaNbBits[s]) >> 16, and moves to
// stateTable[(state >> nb) + deltaFindState[s]].  The stream is those
// fields in that order, then state2 and state1 (tableLog bits each) and a
// 1-bit endMark; csize is its length in bytes.  Table indices clamp into
// the tables, as the JAX gathers do; a field's value is the state's low 16
// bits (the JAX step stacks nb << 16 | value in one i32).
//
// The design.  One thread a block.  The emission order already is the
// stream order, so the thread writes the fields forward through a 64-bit
// bit container (compat_bits.cuh: BitSink) and no scatter or prefix sum is
// needed; the wrapper zero-fills the rows, so the words past csize are 0 as
// the JAX pack gives them.  Each iteration takes two consecutive symbols,
// which belong to the two states: their table lookups are independent, so
// the two chains overlap.  The tables are read through the read-only path
// (__ldg): a block's live state table is 2^tableLog i32 (8 KiB at tableLog
// 11) and its symbol transforms 2 KiB, and sixteen threads a CTA keep an
// SM's working set near its L1.
//
// What bounds it on the H100: the two state chains of n/2 dependent steps
// a block (a table lookup, two shifts and two adds a step).  2048 blocks
// (64 MiB in 32 KiB blocks) are 2048 threads, about 16 an SM: the card's
// issue rate and memory are far from busy, and the time is the chain of
// n/2 lookups.  The later redesign splits a block over threads
// (count-then-place: chains emit (value, nb) pairs, a scan fixes the bit
// offsets, a pass packs them).
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"

namespace {

using compat::BitSink;
using compat::clampi;

constexpr int kThreads = 16;

__global__ void fse_encode_kernel(const uint8_t* __restrict__ src, int S,
                                  const int32_t* __restrict__ n,
                                  const int32_t* __restrict__ tlog,
                                  const int32_t* __restrict__ state_table, int T,
                                  const int32_t* __restrict__ dfs,
                                  const int32_t* __restrict__ dnb, int nsym,
                                  uint32_t* __restrict__ words, int W,
                                  int32_t* __restrict__ csize, int B,
                                  int max_syms) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = src + static_cast<size_t>(b) * S;
  const int32_t* st = state_table + static_cast<size_t>(b) * T;
  const int32_t* fs = dfs + static_cast<size_t>(b) * nsym;
  const int32_t* fb = dnb + static_cast<size_t>(b) * nsym;
  auto sym_at = [&](int j) { return clampi(static_cast<int>(__ldg(row + clampi(j, 0, S - 1))),
                                           0, nsym - 1); };
  auto next = [&](int state, int s, int nb) {
    return __ldg(st + clampi((state >> nb) + __ldg(fs + s), 0, T - 1));
  };
  auto init_state = [&](int s) {          // FSE_initCState2 (lib/fse.h:500-512)
    const int d = __ldg(fb + s);
    const int nb = (d + (1 << 15)) >> 16;
    return next((nb << 16) - d, s, nb);
  };

  const int nn = n[b];
  const int j_last = nn - 1;
  const int s_last = init_state(sym_at(j_last));
  const int s_prev = init_state(sym_at(nn - 2));
  const bool last_even = (j_last & 1) == 0;
  int c1 = last_even ? s_last : s_prev;
  int c2 = last_even ? s_prev : s_last;

  // the scan's fields: e < 2*steps; the flushes sit at m, m+1, m+2 of its
  // 2*steps + 3 columns and are dropped past them
  const int width = 2 * ((max_syms + 1) / 2);
  const int m = max(nn - 2, 0);
  const int fields = min(m, width);
  BitSink out(words + static_cast<size_t>(b) * W, W);
  auto emit = [&](int state, int nb) {
    const int f = (nb << 16) | state;     // as the JAX step stacks them
    out.put(static_cast<uint32_t>(f & 0xFFFF), f >> 16);
  };

  int e = 0;
  for (; e + 1 < fields; e += 2) {        // j and j-1: one symbol a state
    const int ja = nn - 3 - e;
    const int sa = sym_at(ja), sb = sym_at(ja - 1);
    const bool odd = (ja & 1) == 1;
    const int xa = odd ? c2 : c1, xb = odd ? c1 : c2;
    const int nba = (xa + __ldg(fb + sa)) >> 16;
    const int nbb = (xb + __ldg(fb + sb)) >> 16;
    const int ya = next(xa, sa, nba), yb = next(xb, sb, nbb);
    if (odd) { c2 = ya; c1 = yb; } else { c1 = ya; c2 = yb; }
    emit(xa, nba);
    emit(xb, nbb);
  }
  if (e < fields) {
    const int j = nn - 3 - e;
    const int s = sym_at(j);
    const bool odd = (j & 1) == 1;
    const int x = odd ? c2 : c1;
    const int nb = (x + __ldg(fb + s)) >> 16;
    const int y = next(x, s, nb);
    if (odd) c2 = y; else c1 = y;
    emit(x, nb);
  }
  const int tl = tlog[b];
  if (m < width + 3) out.put(static_cast<uint32_t>(c2), tl);
  if (m + 1 < width + 3) out.put(static_cast<uint32_t>(c1), tl);
  if (m + 2 < width + 3) out.put(1u, 1);
  out.finish();
  csize[b] = out.bytes();
}

}  // namespace

extern "C" int fse_encode_launch(const void* src, int S, const void* n,
                                 const void* tlog, const void* state_table, int T,
                                 const void* dfs, const void* dnb, int nsym,
                                 void* words, int W, void* csize, int B,
                                 int max_syms, void* cuda_stream) {
  if (B < 0 || S < 1 || T < 1 || nsym < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  fse_encode_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(src), S, static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(tlog), static_cast<const int32_t*>(state_table), T,
      static_cast<const int32_t*>(dfs), static_cast<const int32_t*>(dnb), nsym,
      static_cast<uint32_t*>(words), W, static_cast<int32_t*>(csize), B, max_syms);
  return static_cast<int>(cudaGetLastError());
}
