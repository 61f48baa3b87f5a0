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
// The design.  The two states share the bit cursor, so a block is one
// chain and one thread walks it.  A CTA holds up to 4 blocks (2048 blocks
// of 32 KiB: 512 CTAs, 4 an SM by shared memory, so one wave on the 132
// SMs).  A warp a block first copies the block's live table (2^tableLog
// of the packed entries) into shared memory in a compact form, 3 bytes an
// entry (newState | nbBits << 12 as u16, the symbol as u8: 12 KiB a block
// at tableLog 12), and zero-fills the output bytes past the block's steps;
// then lane p of warp 0 decodes block p, so the chains of a CTA issue as
// one instruction stream.  The stream is read through a 64-bit register
// window (Window below): no load sits between one step's table lookup and
// the next, and a step is two shared lookups, two shifts of the window,
// two masks and adds.  Reads at a negative offset take bit 0, as read_bits
// does: the window stops at word 0, and the last steps clamp their read
// offsets (every clean block's last two symbols read there).  Eight steps
// store their 16 symbols as one 16-byte word.  A table the compact form
// cannot hold, or one whose states can leave its live part (never one
// build_dtables gives), is decoded from the packed table in global memory
// with read_bits, as the first design did.
//
// What bounds it on the H100: the chain of n_out/2 steps a block (a table
// lookup, then the field read at a cursor that depends on it).  All blocks
// are resident at once, so the time is one block's chain: about 0.9 ms
// for 16384 steps, against 0.25 ms for 16384 dependent shared loads.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"
#include "stage.cuh"

namespace {

using compat::clampi;
using compat::read_bits;

constexpr int kMaxBlocks = 4;          // FSE blocks a CTA: lanes of warp 0
constexpr int kThreads = 128;          // a warp copies a block's table; warp 0 decodes
constexpr int kMaxLog = 12;            // the largest live table, 2^12 entries
constexpr int kSlot = 1 << kMaxLog;    // entries of a block's shared table
constexpr int kReach = 30;             // most bits a step reads (nbBits <= 15)
constexpr int kRing = 64;              // a chain's ring of stream words
constexpr int kAhead = 40;             // words fetched ahead of the window
constexpr int kUnroll = 8;             // steps of one 16-byte store
static_assert(kUnroll == 8 && kAhead < kRing, "a uint4 of symbols; ring slots");

size_t smem_bytes(int per_cta) {
  return static_cast<size_t>(per_cta) * (3 * kSlot + 4 * kRing + sizeof(int));
}

// The first design's loop: the packed table and the stream in global memory.
__device__ void decode_global(const uint32_t* __restrict__ pk, int T,
                              const uint32_t* __restrict__ words, int wmax,
                              int bitpos, int s1, int s2, int nout, int steps,
                              uint8_t* __restrict__ orow, int* bp_check) {
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
    if (i0 == nout - 3) *bp_check = bp0;
    if (i0 + 1 == nout - 3) *bp_check = bp1;
    bitpos = a1 ? bp1 : (a0 ? bp0 : bitpos);
    orow[i0] = a0 ? static_cast<uint8_t>(e1) : 0;
    orow[i0 + 1] = a1 ? static_cast<uint8_t>(e2) : 0;
  }
}

// The chain over the block's shared table.  The window holds the bits
// [base, base + 64) of the row (words base/32 and base/32 + 1, the index
// clamped at the last word); rel = cursor - base stays in [kReach, 64)
// while base > 0, so a step's two reads lie inside it.  A refill shifts in
// `below`, the word under the window, which each step reads a step ahead,
// and is selects, not a branch, so neither a load nor another lane's refill
// holds a step.  On the main loop's steps `below` comes from a ring in
// shared memory: every 8 steps (at most 8 words) request() fetches whole
// 16-byte units of memory with cp.async until the ring reaches kAhead
// words under the window, and waits for the copies of three iterations
// before, long landed.  (A copy a step, even predicated off, cost 13 ns a
// step.)  A row need not start a unit: word i sits in slot (i + lead) %
// kRing, lead the row's word offset in its unit, so a unit fills whole
// slots.  The other steps read `below` from global memory.
struct Window {
  const uint32_t* words;
  int wmax;
  uint32_t* ring;      // word i in slot i % kRing
  uint64_t win;
  uint32_t below;      // word base/32 - 1
  int base, rel;
  int lead;            // the row's first word's place in a 16-byte unit
  int low;             // the lowest word fetched into the ring (low + lead: a unit's start)

  __device__ __forceinline__ Window(const uint32_t* w, int wm, uint32_t* r, int cursor)
      : words(w), wmax(wm), ring(r) {
    base = cursor - kReach >= 32 ? (cursor - kReach) & ~31 : 0;
    const int k = base >> 5;
    win = __ldg(words + clampi(k, 0, wmax)) |
          static_cast<uint64_t>(__ldg(words + clampi(k + 1, 0, wmax))) << 32;
    lead = static_cast<int>(reinterpret_cast<uintptr_t>(words) >> 2) & 3;
    low = ((k - kAhead + lead) & ~3) - lead;
    for (int i = k - 1; i >= low; --i)
      stage::cp_async4(ring + ((i + lead) & (kRing - 1)), words + clampi(i, 0, wmax));
    stage::cp_async_commit();
    stage::cp_async_wait_all();
    below = ring[(k - 1 + lead) & (kRing - 1)];
    rel = cursor - base;
  }

  // the ring down to kAhead words under the window: two 16-byte units at
  // most, of words inside the row (so the words under the row's first unit
  // boundary never come from the ring); the copies of the two iterations
  // before may still be in flight
  __device__ __forceinline__ void request() {
    const int want = (base >> 5) - kAhead;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool p = low > want && low >= 4;
      stage::cp_async16_if(p, ring + ((low - 4 + lead) & (kRing - 1)), words + max(low - 4, 0));
      low = p ? low - 4 : low;
    }
    stage::cp_async_commit();
    stage::cp_async_wait<2>();
  }

  // nb bits at relative offset r (r + nb <= 64); with kClamp, an offset
  // below bit 0 of the row reads at bit 0
  template <bool kClamp>
  __device__ __forceinline__ uint32_t read(int r, int nb) const {
    const int sh = kClamp ? max(r, -base) : r;
    return static_cast<uint32_t>(win >> sh) & ((1u << nb) - 1u);
  }

  // the cursor moves to base + r
  template <bool kFromRing>
  __device__ __forceinline__ void advance(int r) {
    const bool fill = r < kReach && base > 0;
    win = fill ? win << 32 | below : win;
    base = fill ? base - 32 : base;
    rel = fill ? r + 32 : r;
    const int j = (base >> 5) - 1;
    below = kFromRing ? ring[(j + lead) & (kRing - 1)] : __ldg(words + clampi(j, 0, wmax));
  }
};

template <bool kClamp, bool kFromRing>
__device__ __forceinline__ uint32_t step(const uint16_t* __restrict__ t16,
                                         const uint8_t* __restrict__ t8,
                                         Window& w, int& s1, int& s2, int t,
                                         int t_check, bool check_odd, int* bp_check) {
  const uint32_t e1 = t16[s1], e2 = t16[s2];
  const uint32_t pair = t8[s1] | static_cast<uint32_t>(t8[s2]) << 8;
  const int nb0 = e1 >> 12, nb1 = e2 >> 12;
  const int r0 = w.rel - nb0, r1 = r0 - nb1;
  s1 = static_cast<int>((e1 & 0xFFF) + w.read<kClamp>(r0, nb0));
  s2 = static_cast<int>((e2 & 0xFFF) + w.read<kClamp>(r1, nb1));
  if (t == t_check) *bp_check = w.base + (check_odd ? r1 : r0);
  w.advance<kFromRing>(r1);
  return pair;
}

__global__ void __launch_bounds__(kThreads)
fse_decode_kernel(const uint8_t* __restrict__ streams, int S,
                  const int32_t* __restrict__ csize,
                  const int32_t* __restrict__ n_out,
                  const int32_t* __restrict__ tlog,
                  const uint32_t* __restrict__ packed, int T,
                  uint8_t* __restrict__ out, int max_out,
                  bool* __restrict__ err, int B, int per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* t16 = reinterpret_cast<uint16_t*>(smem);
  uint8_t* t8 = smem + static_cast<size_t>(per_cta) * kSlot * 2;
  uint32_t* rings = reinterpret_cast<uint32_t*>(t8 + static_cast<size_t>(per_cta) * kSlot);
  int* fast = reinterpret_cast<int*>(rings + per_cta * kRing);
  const int b0 = blockIdx.x * per_cta;
  const int nblk = min(per_cta, B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto steps_of = [&](int nout) {
    return min(max_out / 2, nout > 0 ? (nout + 1) / 2 : 0);
  };

  // the live tables in the compact form, and the output bytes past the
  // steps zeroed; fast[p]: every state block p's chain can reach is inside
  // its shared table
  for (int p = warp; p < nblk; p += kThreads / 32) {
    const int b = b0 + p;
    const int tl = tlog[b];
    const int L = tl >= 0 && tl <= kMaxLog ? 1 << tl : 0;
    bool ok = L > 0 && L <= T;
    const uint32_t* pk = packed + static_cast<size_t>(b) * T;
    uint16_t* d16 = t16 + p * kSlot;
    uint8_t* d8 = t8 + p * kSlot;
    auto put = [&](int i, uint32_t e) {
      const uint32_t ns = e >> 16, nb = (e >> 8) & 0xFF;
      ok &= nb <= 15 && ns + (1u << (nb & 15)) <= static_cast<uint32_t>(L);
      d16[i] = static_cast<uint16_t>((ns & 0xFFF) | nb << 12);
      d8[i] = static_cast<uint8_t>(e);
    };
    if (ok && L >= 4 && reinterpret_cast<uintptr_t>(pk) % 16 == 0) {
      // 16-byte loads, four a lane in flight (written out: a loop unrolled
      // by the compiler mixed up the vectors of its remainder)
      for (int i0 = 4 * lane; i0 < L; i0 += 512) {
        uint4 ev[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (i0 + 128 * r < L) ev[r] = __ldg(reinterpret_cast<const uint4*>(pk + i0 + 128 * r));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 128 * r;
          if (i < L) {
            put(i, ev[r].x);
            put(i + 1, ev[r].y);
            put(i + 2, ev[r].z);
            put(i + 3, ev[r].w);
          }
        }
      }
    } else if (ok) {
      for (int i = lane; i < L; i += 32) put(i, __ldg(pk + i));
    }
    ok = __all_sync(0xFFFFFFFFu, ok);
    if (lane == 0) fast[p] = ok;
    uint8_t* orow = out + static_cast<size_t>(b) * max_out;
    for (int i = 2 * steps_of(n_out[b]) + lane; i < max_out; i += 32) orow[i] = 0;
  }
  __syncthreads();
  if (warp != 0 || lane >= nblk) return;

  const int b = b0 + lane;
  const uint8_t* row = streams + static_cast<size_t>(b) * S;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const int wmax = S / 4 - 1;
  bool bad;
  const int bitpos0 = compat::initial_bitpos(row, S, csize[b], &bad);
  const int tl = tlog[b];
  int cursor = bitpos0 - tl;
  int s1 = static_cast<int>(read_bits(words, wmax, cursor, tl));
  cursor -= tl;
  int s2 = static_cast<int>(read_bits(words, wmax, cursor, tl));

  const int nout = n_out[b];
  const int steps = steps_of(nout);
  uint8_t* orow = out + static_cast<size_t>(b) * max_out;
  int bp_check = -1;
  if (!fast[lane]) {
    decode_global(packed + static_cast<size_t>(b) * T, T, words, wmax, cursor, s1, s2,
                  nout, steps, orow, &bp_check);
  } else {
    const uint16_t* d16 = t16 + lane * kSlot;
    const uint8_t* d8 = t8 + lane * kSlot;
    const int full = min(steps, nout / 2);         // steps where both states move
    const int t_check = (nout - 3) >> 1;           // the step of symbol n_out - 3
    const bool check_odd = (nout - 3) & 1;
    Window w(words, wmax, rings + lane * kRing, cursor);
    int t = 0;
    // kUnroll steps a 16-byte store while their reads stay at or above
    // bit 0 (no offset needs its clamp) and their words come from the
    // ring: the cursor starts inside the row, and the words under the
    // window stay above the row's eighth word
    if (max_out % (2 * kUnroll) == 0 && cursor < 32 * (wmax + 1)) {
      uint4* o128 = reinterpret_cast<uint4*>(orow);
      for (; t + kUnroll <= full && w.base + w.rel >= kUnroll * kReach + 256; t += kUnroll) {
        w.request();
        uint32_t q[kUnroll / 2];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t pair = step<false, true>(d16, d8, w, s1, s2, t + u, t_check,
                                                  check_odd, &bp_check);
          q[u / 2] = u & 1 ? q[u / 2] | pair << 16 : pair;
        }
        o128[t / kUnroll] = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
    uint16_t* o16 = reinterpret_cast<uint16_t*>(orow);
    for (; t < full; ++t)
      o16[t] = static_cast<uint16_t>(step<true, false>(d16, d8, w, s1, s2, t, t_check,
                                                       check_odd, &bp_check));
    if (t < steps) {        // n_out odd: symbol 2t is the last, state2 stays
      const uint32_t e1 = d16[s1];
      const int r0 = w.rel - static_cast<int>(e1 >> 12);
      if (t == t_check) bp_check = w.base + r0;
      o16[t] = d8[s1];
    }
    stage::cp_async_wait_all();     // no copy may land after the CTA is gone
  }
  err[b] = (bp_check != 0 && nout > 2) || bad;
}

// blocks a CTA: spread the batch over every SM, at most 16 to a CTA
int per_cta_for(int B) {
  return std::max(1, std::min(kMaxBlocks, (B + stage::sm_count() - 1) / stage::sm_count()));
}

}  // namespace

extern "C" int fse_decode_launch(const void* streams, int S, const void* csize,
                                 const void* n_out, const void* tlog,
                                 const void* packed, int T, void* out, int max_out,
                                 void* err, int B, void* cuda_stream) {
  if (B < 0 || S < 4 || S % 4 || T < 1 || max_out < 0 || max_out % 2 ||
      reinterpret_cast<uintptr_t>(streams) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int per_cta = per_cta_for(B);
  const size_t smem = smem_bytes(per_cta);
  cudaError_t rc = cudaFuncSetAttribute(fse_decode_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fse_decode_kernel<<<(B + per_cta - 1) / per_cta, kThreads, smem,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(streams), S, static_cast<const int32_t*>(csize),
      static_cast<const int32_t*>(n_out), static_cast<const int32_t*>(tlog),
      static_cast<const uint32_t*>(packed), T, static_cast<uint8_t*>(out), max_out,
      static_cast<bool*>(err), B, per_cta);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for B blocks: {blocks a CTA, threads, dynamic shared
// bytes, CTAs an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// CTAs, SMs}.
extern "C" int fse_decode_config(int B, int* cfg) {
  const int per_cta = per_cta_for(std::max(B, 1));
  const size_t smem = smem_bytes(per_cta);
  cudaError_t rc = cudaFuncSetAttribute(fse_decode_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  int resident = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fse_decode_kernel,
                                                       kThreads, smem);
  cfg[0] = per_cta;
  cfg[1] = kThreads;
  cfg[2] = static_cast<int>(smem);
  cfg[3] = resident;
  cfg[4] = (std::max(B, 1) + per_cta - 1) / per_cta;
  cfg[5] = stage::sm_count();
  return static_cast<int>(rc);
}
