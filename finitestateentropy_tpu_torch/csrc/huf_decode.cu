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
// Mode x1, the design.  The codec repeats each block's table for its four
// streams, so a CTA stages one table a block into shared memory, as u16
// entries (nbBits + 1) | byte << 8 (8 KiB at tableLog 12), and runs the
// chains of up to 16 blocks, a lane a stream, 16 streams a warp (the
// streams of a CTA are consecutive rows): 2048 blocks of 32 KiB are one
// wave (128 CTAs, one an SM, four chain warps each).  Each warp stages one
// block: it copies the first row's live entries (2^dtLog) with 16-byte
// loads and checks that the other three rows hold the same entries and
// dtLog.  A block whose rows differ, whose dtLog lies outside [0, 12] or
// above log2(T), or with an nbBits above 16 (never one build_dtables_x1
// gives) runs the first design's loop over the global tables, as does a
// stream whose cursor starts past its row (csize > S, a corrupt one).  The stream
// is read through a 64-bit register window (Window below): from one lookup
// to the next a step is the entry's load, a subtract, a funnel shift and a
// mask (the window's refill runs beside it); no global load sits between a
// lookup and the next index.  Below bit 0 the window shifts in zeros, which
// is the lookup's zero fill, so no step clamps.  Sixteen steps store their
// bytes as one 16-byte word; the staging warps zero the bytes past each
// stream's steps, so the kernel writes every output byte.
//
// Mode x2, the design: x1's shape.  A CTA stages one table a block as three
// byte planes (12 KiB at tableLog 12): nbBits | (length-1) << 7, seq_lo,
// seq_hi, so the index chain loads one byte (the step is x1's: a load, a
// subtract, a funnel shift and a mask) and the two bytes' loads and the
// byte cursor's update stay off it.  Up to 16 blocks a CTA, a lane a
// stream, 16 lanes a chain warp; the same window, read from a ring of 128
// words a stream refilled every 32 steps, so 2048 blocks fit one wave
// (231,488 B of shared memory a CTA).  The shared form also needs every
// live entry's nbBits at most 12 (pack_dtable_x2 gives at most dtLog); a
// block outside it, or a stream whose cursor starts past its row, runs the
// first design's loop (x2_global).  A step can only be the last (the rule
// above) at byte n_out - 1, so batches of 32 steps run with no check while
// 64 more bytes stay below min(n_out, max_seg); a tail loop applies the
// rule and the caps.  A step writes its two bytes into a 32-byte staging
// ring in shared memory and moves the byte cursor by its length; every 8
// steps a whole 16-byte unit goes out in one store.  The chain lane zeroes
// its row past the bytes written, so this mode too writes every output
// byte.  (Measured on an H100 80GB HBM3 at 700 W and not kept: the two
// bytes as one u16 plane, 4% faster at 2048 blocks and 25% slower at 256;
// u32 entries, 16 KiB a block, so two waves; the bytes gathered in
// registers, 8 at a time, with no shared store: slower at both.  PERF.md
// §6.)
//
// What bounds it on the H100: the chain of dependent lookups a stream
// (x1: seg, 8192 at 32 KiB blocks; x2: the lookups that run, about 4096 on
// Proba80, where nearly every entry holds two bytes), each a table lookup
// whose index depends on the previous entry's nbBits.  All streams are
// resident at once, so the time is one stream's chain: a shared load and
// three dependent operations a step (H100 80GB HBM3 at 700 W, x1: about
// 30 ns with the refills and the ring beside it; x2 about 44 ns with its
// bytes' loads and stores), against 15 ns for a dependent shared load.
// Mode x2 also reads its tables first: four rows a block (64 KiB at
// tableLog 12), 128 MiB for 2048 blocks, 40 us at 3.35 TB/s.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"
#include "stage.cuh"

namespace {

using compat::clampi;
using compat::read_bits;

constexpr int kMaxBlocks = 16;         // x1: Huff0 blocks a CTA
constexpr int kChainLanes = 16;        // x1: the lanes of a chain warp, a stream each
constexpr int kWarps = kMaxBlocks;     // x1: a warp stages each block's table
constexpr int kMaxLog = 12;            // the largest live table, 2^12 entries
constexpr int kSlot = 1 << kMaxLog;    // entries of a block's shared table
constexpr int kMaxNb = 16;             // the most bits a step of the shared form consumes
constexpr int kFill = kMaxNb + 1;      // a step refills the window below this lookup offset
constexpr int kUnroll = 16;            // steps of one 16-byte store
constexpr int kBatch = 64;             // steps a ring request
constexpr int kDrop = kBatch * kMaxNb / 32;   // the most words a batch consumes
constexpr int kUnits = kDrop / 4;      // 16-byte units a request fetches at most
constexpr int kInFlight = 2;           // requests whose copies may be in flight
constexpr int kAhead = (kInFlight + 1) * kDrop + 16;   // words fetched ahead of the window
constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
constexpr int kRing = pow2_at_least(kAhead + 2 * kDrop + 8);   // a chain's ring of words
static_assert(kChainLanes % 4 == 0 && kChainLanes <= 32 && 4 * kMaxBlocks <= kChainLanes * kWarps,
              "a lane a stream, a warp a block");
static_assert(kBatch % kUnroll == 0 && kDrop % 4 == 0 && kAhead + 2 * kDrop + 8 <= kRing,
              "a request's units cover a batch's steps; ring slots");
static_assert(kFill == kMaxNb + 1 && 32 + kMaxLog <= 64, "the window's reach");

constexpr int kX2Blocks = 16;          // x2: Huff0 blocks a CTA
constexpr int kX2Lanes = 16;           // x2: the lanes of a chain warp, a stream each
constexpr int kX2MaxNb = 12;           // x2: the most bits a step of the shared form consumes
constexpr int kX2Fill = 16;            // x2: a step refills the window below this lookup offset
constexpr int kX2Batch = 32;           // x2: steps a ring request
constexpr int kX2Flush = 8;            // x2: steps between 16-byte output stores
constexpr int kX2Drop = (kX2Batch * kX2MaxNb + 127) / 128 * 4;   // whole units a batch consumes
constexpr int kX2Units = kX2Drop / 4;
constexpr int kX2Ahead = (kInFlight + 1) * kX2Drop + 16;
constexpr int kX2Ring = pow2_at_least(kX2Ahead + 2 * kX2Drop + 8);
constexpr int kStage = 32;             // x2: a stream's staged output bytes, two 16-byte units
// x2: a block's shared table: three byte planes nbBits | (length-1) << 7,
// seq_lo, seq_hi
constexpr int kTable2 = 3 * kSlot;
static_assert(kX2Lanes % 4 == 0 && kX2Lanes >= 4 && kX2Lanes <= 32,
              "x2: a lane a stream, a warp a block");
// a flush group starts with at most 15 bytes staged and adds at most 2 a
// step (the second of a one-byte step's two is overwritten by the next)
static_assert(kX2Batch % kX2Flush == 0 && 15 + 2 * kX2Flush <= kStage - 1 && kStage == 32,
              "x2: a flush group's bytes fit the staging ring beside a partial unit");
// the offset o in [0, 31]: a step refills when o < 16 and then moves down
// at most kX2MaxNb, so o' = (o & 15) + 16 - nbBits lies in [4, 31]
static_assert(kX2Fill == 16 && kX2MaxNb <= kX2Fill && 32 + kMaxLog <= 64,
              "x2: the lookup offset stays in [0, 31]");

// The window's sizes for each mode: fill, the offset bias (x holds the
// lookup offset less bias), the ring's words and reach.
struct GeomX1 {
  static constexpr int fill = kFill, bias = 1, off_mask = 0xFF;
  static constexpr int ring = kRing, ahead = kAhead, units = kUnits;
};
struct GeomX2 {
  static constexpr int fill = kX2Fill, bias = 0, off_mask = 31;
  static constexpr int ring = kX2Ring, ahead = kX2Ahead, units = kX2Units;
};

// The first design's x1 loop: the tables and the stream in global memory.
__device__ bool x1_global(const uint32_t* __restrict__ words, int wmax, int bitpos,
                          int dt_log, const uint8_t* __restrict__ bytes,
                          const uint8_t* __restrict__ nbs, int T, int steps,
                          uint8_t* __restrict__ orow) {
  for (int i = 0; i < steps; ++i) {
    const int avail = min(dt_log, max(bitpos, 0));
    const int raw = static_cast<int>(read_bits(words, wmax, bitpos - avail, avail));
    const int v = clampi(raw << (dt_log - avail), 0, T - 1);
    orow[i] = __ldg(bytes + v);
    bitpos -= __ldg(nbs + v);
  }
  return bitpos != 0;
}

// The first design's x2 loop: the packed table and the stream in global
// memory; returns the cursor after the lookups and sets *bytes to the bytes
// written (the byte cursor).
__device__ int x2_global(const uint32_t* __restrict__ words, int wmax, int bitpos, int dt_log,
                         const int32_t* __restrict__ tbl, int T, int nout, int max_seg,
                         uint8_t* __restrict__ orow, int* bytes) {
  auto index = [&]() {             // lookBitsFast, zero-filled at the bottom
    const int avail = min(dt_log, max(bitpos, 0));
    const int raw = static_cast<int>(read_bits(words, wmax, bitpos - avail, avail));
    return clampi(raw << (dt_log - avail), 0, T - 1);
  };
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
  *bytes = p;
  return bitpos;
}

// a block's shared table: kSlot u16 entries (nbBits + 1) | byte << 8
constexpr int kTable = 2 * kSlot;

size_t smem_bytes(int per_cta) {
  return static_cast<size_t>(per_cta) * (kTable + 4 * 4 * kRing + sizeof(int));
}

// x2: a block's table (kTable2), each stream's ring and staging bytes, the flag
size_t smem_bytes_x2(int per_cta) {
  return static_cast<size_t>(per_cta) * (kTable2 + 4 * (4 * kX2Ring + kStage) + sizeof(int));
}

// The stream's bits [base, base + 64) in two registers, base a multiple of
// 16 that goes below 0: the words below the row read as 0, the words past
// its end as its last word (read_bits' clamp), so every lookup is one funnel
// shift and a mask.  The next lookup's offset o = cursor - dtLog - base
// stays in [1, 32] (x1; x2: [0, 31]): a step whose offset is under G::fill
// shifts 16 bits in under the window beside its lookup (the cursor then
// moves down at most kMaxNb bits, x2 kX2MaxNb, from at least G::fill + 16
// above the new base).  x1: x holds o - 1 in its low 8 bits: a table entry
// is (nbBits + 1) | byte << 8, so x is the refilled offset less the entry,
// and the 32-bit funnel shift reads o - 1 from x's low 5 bits; the chain
// from one lookup to the next is the entry's load, a subtract, a funnel
// shift and a mask, and the index comes out doubled (the bit under it
// masked off), a u16 entry's byte offset.  x2: x holds o in its low 5 bits,
// and (o & 15) + 16 is the offset after the refill whether or not the step
// refills, so x' = ((x & 15) | 16) - entry, the entry nbBits |
// (length-1) << 7 (the bits of x above 4 are not read).  The 16
// bits come from `below`, the word under the window: its high half, then
// its low half, after which `below` is loaded a word down, a step before
// its next use at the earliest.
//
// `below` comes from a ring in shared memory: every kBatch
// steps request() fetches whole 16-byte units of the row with cp.async
// until the ring reaches kAhead words under the window (at most kUnits
// units, as kBatch steps consume at most kDrop words), and waits for the
// copies of the requests before the last kInFlight: those hold every word
// the next batch reads (kAhead is (kInFlight + 1) batches' words and more),
// while a wait for the last request's copies would hold each batch for a
// global load's latency.  A row need not start a unit: word i sits in slot
// (i + lead) % kRing, lead the row's word offset in its unit; the words
// under the row's first unit boundary go to their slots by 4-byte copies
// with the last unit.  The cursor starts inside the row.  (G holds each
// mode's kFill, kRing, kAhead and kUnits.)
template <class G>
struct Window {
  const uint32_t* words;
  int wmax;
  uint32_t* ring;
  uint32_t lo, hi;     // the stream's bits [base, base + 32), [base + 32, base + 64)
  uint32_t below;      // word jw(): the 16 bits under the window are one of its halves
  int hp;              // base / 16
  int x;               // o - G::bias in the low bits
  int slot;            // word jw()'s slot in the ring
  int lead;            // the row's first word's place in a 16-byte unit
  int low;             // the lowest word fetched into the ring (low + lead: a unit's start)
  int low_min;         // the lowest unit start inside the row
  bool head;           // the words under low_min are fetched

  __device__ __forceinline__ uint32_t word(int i) const {
    return i < 0 ? 0u : __ldg(words + min(i, wmax));
  }

  // the word holding bits [base - 16, base)
  __device__ __forceinline__ int jw() const { return (hp - 1) >> 1; }

  __device__ __forceinline__ void init(const uint32_t* w, int wm, uint32_t* r, int cursor,
                                       int dt) {
    words = w;
    wmax = wm;
    ring = r;
    const int base = (cursor - dt - G::fill) & ~15;
    hp = base >> 4;
    x = cursor - dt - base - G::bias;
    const int k = base >> 5, s = base & 31;
    lo = __funnelshift_r(word(k), word(k + 1), s);
    hi = __funnelshift_r(word(k + 1), word(k + 2), s);
    lead = static_cast<int>(reinterpret_cast<uintptr_t>(words) >> 2) & 3;
    low_min = (4 - lead) & 3;
    const int j = jw();
    slot = (j + lead) & (G::ring - 1);
    low = max(((j + 1 - G::ahead + lead) & ~3) - lead, low_min);
    for (int i = j; i >= low; --i)
      stage::cp_async4(ring + ((i + lead) & (G::ring - 1)), words + i);
    head = low == low_min;
    if (head)
      for (int i = 0; i < low_min; ++i)
        stage::cp_async4(ring + ((i + lead) & (G::ring - 1)), words + min(i, wmax));
    stage::cp_async_commit();
    stage::cp_async_wait_all();
    fetch_below();
  }

  // `below` anew where `take` holds (the slot a word down), as a predicated
  // load: a branch a step would cost more than the loads it saves
  __device__ __forceinline__ void fetch_below(bool take = true) {
    const bool inside = hp >= 1;                 // jw() >= 0, else the zeros under the row
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ring + slot));
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q ld.shared.u32 %0, [%1];\n\t}\n"
        : "+r"(below)
        : "r"(a), "r"(static_cast<int>(take && inside)));
    below = take && !inside ? 0u : below;
  }

  // the ring down to kAhead words under the window: kUnits 16-byte units at
  // most; the copies of the last kInFlight requests may be in flight
  __device__ __forceinline__ void request() {
    const int want = jw() - G::ahead;
    // a loop, not kUnits predicated copies: a batch of a skewed stream
    // moves the window a few words, so most requests fetch one unit or none
    for (int u = 0; u < G::units && low > want && low >= 4; ++u) {
      low -= 4;
      stage::cp_async16(ring + ((low + lead) & (G::ring - 1)), words + low);
    }
    if (!head && low == low_min) {
      for (int i = 0; i < low_min; ++i)
        stage::cp_async4(ring + ((i + lead) & (G::ring - 1)), words + min(i, wmax));
      head = true;
    }
    stage::cp_async_commit();
    stage::cp_async_wait<kInFlight>();
  }

  // 16 bits in under the window where `fill` holds: the base a half-word down
  __device__ __forceinline__ void shift_in(bool fill) {
    const bool high = (hp & 1) == 0;            // bits [base - 16, base): below's high half
    const uint32_t lo2 = __byte_perm(below, lo, high ? 0x5432 : 0x5410);
    hi = fill ? __byte_perm(lo, hi, 0x5432) : hi;
    lo = fill ? lo2 : lo;
    hp -= fill;
    const bool take = fill && !high;
    slot = take ? (slot - 1) & (G::ring - 1) : slot;
    fetch_below(take);
  }

  // x1: one lookup in the block's table at smem + tbase: the byte of the
  // dtLog bits under the cursor; the cursor down by its nbBits
  __device__ __forceinline__ uint32_t step(const uint8_t* __restrict__ smem, uint32_t tbase,
                                           uint32_t mask2) {
    const uint32_t e =
        *reinterpret_cast<const uint16_t*>(smem + ((__funnelshift_r(lo, hi, x) & mask2) | tbase));
    const int o1 = x & 0xFF;
    const bool fill = o1 < kFill - 1;
    x = o1 + (fill ? 17 : 1) - static_cast<int>(e);
    shift_in(fill);
    return e >> 8;
  }

  // x2: one lookup in the block's table at smem + tbase, its entry's byte
  // offset in *at; returns nbBits | (length-1) << 7; the cursor down by
  // nbBits
  __device__ __forceinline__ uint32_t step2(const uint8_t* __restrict__ smem, uint32_t tbase,
                                            uint32_t mask, uint32_t* at) {
    *at = (__funnelshift_r(lo, hi, x) & mask) | tbase;
    const uint32_t e = smem[*at];
    const bool fill = (x & kX2Fill) == 0;
    x = ((x & (kX2Fill - 1)) | kX2Fill) - static_cast<int>(e);
    shift_in(fill);
    return e;
  }

  __device__ __forceinline__ int cursor(int dt) const {
    return 16 * hp + (x & G::off_mask) + G::bias + dt;
  }
};

// The steps of one stream: whole batches of kBatch steps, a ring request
// each, their bytes 16 a 16-byte store where the rows allow (wide), then
// the rest; returns the cursor after them.  (A request in the rest's loop
// made ptxas spill: 10% slower.)
__device__ int x1_window(Window<GeomX1>& w, const uint8_t* __restrict__ smem, uint32_t tbase,
                         int dt, int steps, uint8_t* __restrict__ orow, bool wide) {
  const uint32_t mask2 = ((1u << dt) - 1u) << 1;
  int i = 0;
  if (wide) {
    uint4* o128 = reinterpret_cast<uint4*>(orow);
    for (; i + kBatch <= steps; i += kBatch) {
      w.request();
#pragma unroll
      for (int h = 0; h < kBatch; h += kUnroll) {
        uint32_t q[kUnroll / 4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t byte = w.step(smem, tbase, mask2);
          q[u / 4] = u & 3 ? q[u / 4] | byte << (8 * (u & 3)) : byte;
        }
        o128[(i + h) / kUnroll] = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
  } else {
    for (; i + kBatch <= steps; i += kBatch) {
      w.request();
      for (int u = 0; u < kBatch; ++u)
        orow[i + u] = static_cast<uint8_t>(w.step(smem, tbase, mask2));
    }
  }
  for (; i < steps; ++i)
    orow[i] = static_cast<uint8_t>(w.step(smem, tbase, mask2));
  return w.cursor(dt);
}

__global__ void __launch_bounds__(32 * kWarps)
huf_decode_kernel_x1(const uint8_t* __restrict__ streams, int S,
                     const int32_t* __restrict__ csize,
                     const int32_t* __restrict__ n_out,
                     const int32_t* __restrict__ tlog,
                     const uint8_t* __restrict__ tbl_byte,
                     const uint8_t* __restrict__ tbl_nb, int T,
                     uint8_t* __restrict__ out, int max_seg,
                     bool* __restrict__ err, int R, int per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* rings = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(per_cta) * kTable);
  int* fast = reinterpret_cast<int*>(rings + 4 * per_cta * kRing);
  const int r0 = blockIdx.x * per_cta * 4;           // the CTA's first row
  const int nrows = min(4 * per_cta, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // 16-byte output stores: rows that start 16-byte units
  const bool wide = max_seg % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto steps_of = [&](int r) { return max(min(n_out[r], max_seg), 0); };

  // 1. warp p: block p's table in shared memory if its rows agree (fast[p]),
  // and its rows' bytes past their steps zeroed
  const int p = warp;
  if (4 * p < nrows) {
    const int rb = r0 + 4 * p, nr = min(4, nrows - 4 * p);
    const int dt = tlog[rb];
    bool ok = dt >= 0 && dt <= kMaxLog && (1 << dt) <= T;
    for (int j = 1; j < nr; ++j) ok &= tlog[rb + j] == dt;
    const int L = ok ? 1 << dt : 0;
    const uint8_t* b0 = tbl_byte + static_cast<size_t>(rb) * T;
    const uint8_t* n0 = tbl_nb + static_cast<size_t>(rb) * T;
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(p) * kTable);
    // rows 1-3 (row 0 again where the block has fewer), compared whole
    const size_t o1 = static_cast<size_t>(min(1, nr - 1)) * T;
    const size_t o2 = static_cast<size_t>(min(2, nr - 1)) * T;
    const size_t o3 = static_cast<size_t>(min(3, nr - 1)) * T;
    if (L >= 16 && T % 16 == 0 && reinterpret_cast<uintptr_t>(tbl_byte) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(tbl_nb) % 16 == 0) {
      // 16-byte loads, the eight of a lane's entries in flight at once
      // (written out: a loop unrolled by the compiler mixed up the vectors
      // of its remainder)
      auto same = [](uint4 a, uint4 b) {
        return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
      };
      for (int i = 16 * lane; i < L; i += 16 * 32) {
        const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b0 + i));
        const uint4 nv = __ldg(reinterpret_cast<const uint4*>(n0 + i));
        const uint4 b1 = __ldg(reinterpret_cast<const uint4*>(b0 + o1 + i));
        const uint4 n1 = __ldg(reinterpret_cast<const uint4*>(n0 + o1 + i));
        const uint4 b2 = __ldg(reinterpret_cast<const uint4*>(b0 + o2 + i));
        const uint4 n2 = __ldg(reinterpret_cast<const uint4*>(n0 + o2 + i));
        const uint4 b3 = __ldg(reinterpret_cast<const uint4*>(b0 + o3 + i));
        const uint4 n3 = __ldg(reinterpret_cast<const uint4*>(n0 + o3 + i));
        ok &= same(b1, bv) && same(n1, nv) && same(b2, bv) && same(n2, nv) &&
              same(b3, bv) && same(n3, nv);
        ok &= (__vcmpgtu4(nv.x, 0x10101010u) | __vcmpgtu4(nv.y, 0x10101010u) |
               __vcmpgtu4(nv.z, 0x10101010u) | __vcmpgtu4(nv.w, 0x10101010u)) == 0;
        // u16 entries (nb + 1) | byte << 8, two a word (nb <= 16: no carry)
        const uint4 e1 = make_uint4(nv.x + 0x01010101u, nv.y + 0x01010101u,
                                    nv.z + 0x01010101u, nv.w + 0x01010101u);
        uint4* d = reinterpret_cast<uint4*>(dst + i / 2);
        d[0] = make_uint4(__byte_perm(e1.x, bv.x, 0x5140), __byte_perm(e1.x, bv.x, 0x7362),
                          __byte_perm(e1.y, bv.y, 0x5140), __byte_perm(e1.y, bv.y, 0x7362));
        d[1] = make_uint4(__byte_perm(e1.z, bv.z, 0x5140), __byte_perm(e1.z, bv.z, 0x7362),
                          __byte_perm(e1.w, bv.w, 0x5140), __byte_perm(e1.w, bv.w, 0x7362));
      }
    } else {
      for (int i = lane; i < L; i += 32) {
        const uint8_t bv = b0[i], nv = n0[i];
        ok &= b0[o1 + i] == bv && n0[o1 + i] == nv && b0[o2 + i] == bv &&
              n0[o2 + i] == nv && b0[o3 + i] == bv && n0[o3 + i] == nv && nv <= kMaxNb;
        reinterpret_cast<uint16_t*>(dst)[i] = static_cast<uint16_t>((nv + 1) | bv << 8);
      }
    }
    ok = __all_sync(0xFFFFFFFFu, ok);
    if (lane == 0) fast[p] = ok;
    for (int j = 0; j < nr; ++j) {
      uint8_t* orow = out + static_cast<size_t>(rb + j) * max_seg;
      const int z0 = steps_of(rb + j);
      const int z1 = wide ? min((z0 + 15) & ~15, max_seg) : max_seg;
      for (int i = z0 + lane; i < z1; i += 32) orow[i] = 0;
      for (int i = z1 + 16 * lane; i < max_seg; i += 16 * 32)
        *reinterpret_cast<uint4*>(orow + i) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  const int sid = warp * kChainLanes + lane;         // the CTA's stream
  if (lane >= kChainLanes || sid >= nrows) return;

  // 2. the chains: stream k of block p is the CTA's stream 4p + k, lane
  // (4p + k) % kChainLanes of warp (4p + k) / kChainLanes
  const int r = r0 + sid, pb = sid >> 2;
  const uint8_t* row = streams + static_cast<size_t>(r) * S;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const int wmax = S / 4 - 1;
  bool bad;
  const int bitpos = compat::initial_bitpos(row, S, csize[r], &bad);
  const int nout = n_out[r], steps = steps_of(r);
  const int dt = tlog[r];
  uint8_t* orow = out + static_cast<size_t>(r) * max_seg;
  bool fail;
  if (!fast[pb] || bitpos >= 32 * (wmax + 1)) {     // the cursor past the row: corrupt
    fail = x1_global(words, wmax, bitpos, dt, tbl_byte + static_cast<size_t>(r) * T,
                     tbl_nb + static_cast<size_t>(r) * T, T, steps, orow);
  } else {
    Window<GeomX1> w;
    w.init(words, wmax, rings + sid * kRing, bitpos, dt);
    fail = x1_window(w, smem, pb * kTable, dt, steps, orow, wide) != 0;
    stage::cp_async_wait_all();         // no copy may land after the CTA is gone
  }
  err[r] = nout > 0 && (fail || bad);
}

// x2: the two bytes (seq_lo, seq_hi) of the entry at smem + at
__device__ __forceinline__ void x2_bytes(const uint8_t* __restrict__ smem, uint32_t at,
                                         uint32_t* b0, uint32_t* b1) {
  *b0 = smem[at + kSlot];
  *b1 = smem[at + 2 * kSlot];
}

// x2: entry i of a block's shared table, from its packed entry e and nl =
// nbBits | (length-1) << 7
__device__ __forceinline__ void x2_put(uint8_t* __restrict__ dst, int i, uint32_t nl, uint32_t e) {
  dst[i] = static_cast<uint8_t>(nl);
  dst[kSlot + i] = static_cast<uint8_t>(e);
  dst[2 * kSlot + i] = static_cast<uint8_t>(e >> 8);
}

// byte k of each of v's four words, in one word
__device__ __forceinline__ uint32_t gather_byte(uint4 v, int k) {
  const unsigned sel = static_cast<unsigned>(k | (k + 4) << 4);
  return __byte_perm(__byte_perm(v.x, v.y, sel), __byte_perm(v.z, v.w, sel), 0x5410);
}

// The steps of one x2 stream (see the header): whole batches of kX2Batch
// steps, a ring request each, while no step can be the last or write past
// min(n_out, max_seg) (each step's two bytes into the staging ring, a whole
// unit out every kX2Flush steps); then the staged bytes not yet out; then
// a step at a time with the last-symbol rule and the caps.  Returns the
// cursor after the lookups and sets *bytes to the bytes written.
__device__ int x2_window(Window<GeomX2>& w, const uint8_t* __restrict__ smem, uint32_t tbase,
                         int dt, int nout, int max_seg, uint8_t* __restrict__ staged,
                         uint8_t* __restrict__ orow, bool wide, int* bytes) {
  const uint32_t mask = (1u << dt) - 1u;
  const int lim = min(nout, max_seg);
  int p = 0, f = 0, i = 0;          // bytes written, 16-byte units out, lookups
  for (; p + 2 * kX2Batch <= lim; i += kX2Batch) {
    w.request();
#pragma unroll
    for (int h = 0; h < kX2Batch; h += kX2Flush) {
#pragma unroll
      for (int u = 0; u < kX2Flush; ++u) {
        uint32_t at, b0, b1;
        const uint32_t e = w.step2(smem, tbase, mask, &at);
        x2_bytes(smem, at, &b0, &b1);
        // both bytes; a one-byte step's second is the next step's first
        staged[p & (kStage - 1)] = static_cast<uint8_t>(b0);
        staged[(p + 1) & (kStage - 1)] = static_cast<uint8_t>(b1);
        p += 1 + ((e >> 7) & 1);
      }
      if ((p >> 4) > f) {           // unit f is whole (at most one a group)
        const uint8_t* unit = staged + 16 * (f & 1);
        if (wide) {
          reinterpret_cast<uint4*>(orow)[f] = *reinterpret_cast<const uint4*>(unit);
        } else {
          for (int k = 0; k < 16; ++k) orow[16 * f + k] = unit[k];
        }
        ++f;
      }
    }
  }
  for (int q = 16 * f; q < p; ++q) orow[q] = staged[q & (kStage - 1)];
  bool last = false;
  while (i < max_seg && p < nout) {
    w.request();
    for (int u = 0; u < kX2Batch && i < max_seg && p < nout; ++u, ++i) {
      uint32_t at, b0, b1;
      const uint32_t e = w.step2(smem, tbase, mask, &at);
      x2_bytes(smem, at, &b0, &b1);
      const bool two = (e >> 7) & 1;
      last = two && p == nout - 1;   // HUF_decodeLastSymbolX2: one byte, the cursor at 0
      // the plain version's buffer drops bytes at max_seg and past it
      if (p < max_seg) orow[p] = static_cast<uint8_t>(b0);
      if (two && !last && p + 1 < max_seg) orow[p + 1] = static_cast<uint8_t>(b1);
      p += two && !last ? 2 : 1;
    }
  }
  *bytes = p;
  const int c = w.cursor(dt);
  return last ? max(c, 0) : c;
}

__global__ void __launch_bounds__(32 * kX2Blocks)
huf_decode_kernel_x2(const uint8_t* __restrict__ streams, int S,
                     const int32_t* __restrict__ csize,
                     const int32_t* __restrict__ n_out,
                     const int32_t* __restrict__ tlog,
                     const int32_t* __restrict__ tbl0, int T,
                     uint8_t* __restrict__ out, int max_seg,
                     bool* __restrict__ err, int R, int per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* rings = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(per_cta) * kTable2);
  uint8_t* stages = reinterpret_cast<uint8_t*>(rings + 4 * per_cta * kX2Ring);
  int* fast = reinterpret_cast<int*>(stages + 4 * per_cta * kStage);
  const int r0 = blockIdx.x * per_cta * 4;           // the CTA's first row
  const int nrows = min(4 * per_cta, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // 16-byte output stores: rows that start 16-byte units
  const bool wide = max_seg % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;

  // 1. warp b: block b's table in shared memory if its rows agree, its
  // dtLog fits and its live entries' nbBits are at most kX2MaxNb (fast[b])
  const int b = warp;
  if (4 * b < nrows) {
    const int rb = r0 + 4 * b, nr = min(4, nrows - 4 * b);
    const int dt = tlog[rb];
    bool ok = dt >= 0 && dt <= kMaxLog && (1 << dt) <= T;
    for (int j = 1; j < nr; ++j) ok &= tlog[rb + j] == dt;
    const int L = ok ? 1 << dt : 0;
    const int32_t* t0 = tbl0 + static_cast<size_t>(rb) * T;
    // rows 1-3 (row 0 again where the block has fewer), compared whole
    const size_t o1 = static_cast<size_t>(min(1, nr - 1)) * T;
    const size_t o2 = static_cast<size_t>(min(2, nr - 1)) * T;
    const size_t o3 = static_cast<size_t>(min(3, nr - 1)) * T;
    uint8_t* dst = smem + static_cast<size_t>(b) * kTable2;
    if (L >= 4 && T % 4 == 0 && reinterpret_cast<uintptr_t>(tbl0) % 16 == 0) {
      auto same = [](uint4 a, uint4 c) {
        return a.x == c.x && a.y == c.y && a.z == c.z && a.w == c.w;
      };
      for (int i = 4 * lane; i < L; i += 4 * 32) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(t0 + i));
        const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(t0 + o1 + i));
        const uint4 v2 = __ldg(reinterpret_cast<const uint4*>(t0 + o2 + i));
        const uint4 v3 = __ldg(reinterpret_cast<const uint4*>(t0 + o3 + i));
        ok &= same(v1, v) && same(v2, v) && same(v3, v);
        const uint32_t b2 = gather_byte(v, 2);          // nbBits | (length-1) << 6
        const uint32_t nb = b2 & 0x3F3F3F3Fu;
        ok &= __vcmpgtu4(nb, kX2MaxNb * 0x01010101u) == 0;
        const uint32_t nl = nb | (b2 & 0x40404040u) << 1;
        *reinterpret_cast<uint32_t*>(dst + i) = nl;
        *reinterpret_cast<uint32_t*>(dst + kSlot + i) = gather_byte(v, 0);
        *reinterpret_cast<uint32_t*>(dst + 2 * kSlot + i) = gather_byte(v, 1);
      }
    } else {
      for (int i = lane; i < L; i += 32) {
        const uint32_t e = static_cast<uint32_t>(t0[i]);
        const uint32_t nb = (e >> 16) & 0x3F;
        ok &= static_cast<uint32_t>(t0[o1 + i]) == e && static_cast<uint32_t>(t0[o2 + i]) == e &&
              static_cast<uint32_t>(t0[o3 + i]) == e && nb <= kX2MaxNb;
        x2_put(dst, i, nb | ((e >> 22) & 1) << 7, e);
      }
    }
    ok = __all_sync(0xFFFFFFFFu, ok);
    if (lane == 0) fast[b] = ok;
  }
  __syncthreads();
  const int sid = warp * kX2Lanes + lane;            // the CTA's stream
  if (lane >= kX2Lanes || sid >= nrows) return;

  // 2. the chains: stream k of block b is the CTA's stream 4b + k
  const int r = r0 + sid, pb = sid >> 2;
  const uint8_t* row = streams + static_cast<size_t>(r) * S;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const int wmax = S / 4 - 1;
  bool bad;
  const int bitpos = compat::initial_bitpos(row, S, csize[r], &bad);
  const int nout = n_out[r], dt = tlog[r];
  uint8_t* orow = out + static_cast<size_t>(r) * max_seg;
  int cursor, bytes;
  const bool on_global = !fast[pb] || bitpos >= 32 * (wmax + 1);   // past the row: corrupt
  if (on_global) {
    cursor = x2_global(words, wmax, bitpos, dt, tbl0 + static_cast<size_t>(r) * T, T, nout,
                       max_seg, orow, &bytes);
  } else {
    Window<GeomX2> w;
    w.init(words, wmax, rings + sid * kX2Ring, bitpos, dt);
    cursor = x2_window(w, smem, pb * kTable2, dt, nout, max_seg, stages + sid * kStage, orow,
                       wide, &bytes);
    stage::cp_async_wait_all();         // no copy may land after the CTA is gone
  }
  // zeros past the bytes written
  int z = min(bytes, max_seg);
  for (; z < max_seg && (z & 15) != 0; ++z) orow[z] = 0;
  if (wide)
    for (; z + 16 <= max_seg; z += 16) *reinterpret_cast<uint4*>(orow + z) = make_uint4(0, 0, 0, 0);
  for (; z < max_seg; ++z) orow[z] = 0;
  err[r] = nout > 0 && (cursor != 0 || bytes != nout || bad);
}

// Huff0 blocks (four rows each) a CTA: spread the batch over every SM
int per_cta_for(int R, int max_blocks = kMaxBlocks) {
  const int blocks = (R + 3) / 4;
  return std::max(1, std::min(max_blocks, (blocks + stage::sm_count() - 1) / stage::sm_count()));
}

int ctas_for(int R, int per_cta) { return (R + 4 * per_cta - 1) / (4 * per_cta); }

// The launch shape of kernel for R streams at per_cta blocks a CTA into cfg
// (see huf_decode_config).
template <class K>
int config_of(K kernel, int threads, size_t smem, int R, int per_cta, int* cfg) {
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  int resident = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem);
  cfg[0] = per_cta;
  cfg[1] = threads;
  cfg[2] = static_cast<int>(smem);
  cfg[3] = resident;
  cfg[4] = ctas_for(std::max(R, 1), per_cta);
  cfg[5] = stage::sm_count();
  return static_cast<int>(rc);
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
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* st = static_cast<const uint8_t*>(streams);
  if (x2) {
    const int per_cta = per_cta_for(R, kX2Blocks);
    const size_t smem = smem_bytes_x2(per_cta);
    cudaError_t rc = cudaFuncSetAttribute(huf_decode_kernel_x2,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    huf_decode_kernel_x2<<<ctas_for(R, per_cta), 32 * kX2Blocks, smem, s>>>(
        st, S, static_cast<const int32_t*>(csize), static_cast<const int32_t*>(n_out),
        static_cast<const int32_t*>(tlog), static_cast<const int32_t*>(tbl0), T,
        static_cast<uint8_t*>(out), max_seg, static_cast<bool*>(err), R, per_cta);
    return static_cast<int>(cudaGetLastError());
  }
  const int per_cta = per_cta_for(R);
  const size_t smem = smem_bytes(per_cta);
  cudaError_t rc = cudaFuncSetAttribute(huf_decode_kernel_x1,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  huf_decode_kernel_x1<<<ctas_for(R, per_cta), 32 * kWarps, smem, s>>>(
      st, S, static_cast<const int32_t*>(csize), static_cast<const int32_t*>(n_out),
      static_cast<const int32_t*>(tlog), static_cast<const uint8_t*>(tbl0),
      static_cast<const uint8_t*>(tbl1), T, static_cast<uint8_t*>(out), max_seg,
      static_cast<bool*>(err), R, per_cta);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for R streams, x1 (huf_decode_config) or x2
// (huf_decode_x2_config): {blocks a CTA, threads, dynamic shared bytes,
// CTAs an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// CTAs, SMs}.
extern "C" int huf_decode_config(int R, int* cfg) {
  const int per_cta = per_cta_for(std::max(R, 1));
  return config_of(huf_decode_kernel_x1, 32 * kWarps, smem_bytes(per_cta), R, per_cta, cfg);
}

extern "C" int huf_decode_x2_config(int R, int* cfg) {
  const int per_cta = per_cta_for(std::max(R, 1), kX2Blocks);
  return config_of(huf_decode_kernel_x2, 32 * kX2Blocks, smem_bytes_x2(per_cta), R, per_cta,
                   cfg);
}
