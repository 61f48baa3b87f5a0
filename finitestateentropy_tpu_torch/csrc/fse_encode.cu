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
// 1-bit endMark; csize is its length in bytes, words past the row's W are
// dropped but counted.  Table indices clamp into the tables, as the JAX
// gathers do; a field's value is the state's low 16 bits (the JAX step
// stacks nb << 16 | value in one i32).  Fields are 0 to 32 bits wide, as
// pack_fields takes them.
//
// The design: staged state chains, then count-then-place, the shape of the
// JAX package's pack_fields.  A CTA holds up to 8 blocks (2048 blocks of
// 32 KiB: 256 CTAs, 2 an SM by shared memory, so one wave on the 132 SMs).
// Its warps copy each block's symbol transforms (256 x {deltaNbBits,
// deltaFindState}) and its live state table (2^tableLog entries as u16,
// 8 KiB at tableLog 12) into shared memory.  Lanes 2p and 2p+1 of warp 0
// run block p's two state chains (state1 the even j, state2 the odd j;
// they are independent), over the fields in chunks of 128, so the chains
// of a CTA issue as one instruction stream.  The other eight warps stage
// chunk k+1 (the source bytes read coalesced into registers, every load of
// the chunk in flight at once, then each symbol's transforms looked up
// into a shared row) while the chains run chunk k, and place chunk k-1's
// fields: a warp scan of their widths gives the bit offsets from the
// block's running total, each field is ORed into a shared word buffer, the
// full words are stored coalesced and the last partial word carries into
// the next chunk.  (Placing a chunk after its chains, between two
// barriers, measured 16% slower.)  A chain step is then one shared load of
// the staged transforms (off the chain), an add, two shifts, an add and
// one shared load of the next state.  No clamp sits on the chain: the
// kernel checks that every state of the block's table lies in
// [2^tableLog, 2^(tableLog+1)) and that every symbol's transforms map that
// range into the live table, so no index leaves it.  A block that fails
// the check (never one build_ctables gives) makes the CTA's chains read
// the clamped i32 table from global memory instead.  The eight warps also
// zero the words past the payload, a slice of each row an iteration,
// ahead of the placement.  After the last chunk they append the flushes
// and the endMark, by the rules m < width + 3 etc., store the last partial
// word and write csize.
//
// What bounds it on the H100: each state's chain of n/2 dependent steps
// (two shifts, two adds and a table lookup a step).  All blocks are
// resident at once, so the time is one chain's: about 0.8 ms for 16384
// steps (the chains alone, with no staging or placement beside them, 0.54
// ms), against 0.25 ms for 16384 dependent shared loads.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "compat_bits.cuh"
#include "stage.cuh"

namespace {

using compat::clampi;
using compat::mask32;

constexpr int kMaxBlocks = 8;              // FSE blocks a CTA (two chain lanes each)
constexpr int kHelpers = 8;                // warps that stage, place and zero
constexpr int kThreads = 32 * (1 + kHelpers);
constexpr int kChunk = 128;                // fields a block and chunk
constexpr int kMaxLog = 12;
constexpr int kSlot = 1 << kMaxLog;        // a block's shared state table (u16)
constexpr int kSyms = 256;                 // byte symbols: transforms held
constexpr int kStage = kChunk + 1;         // int2 row of staged transforms
constexpr int kField = kChunk + 4;         // u32 row of fields (16-byte rows)
constexpr int kWords = kChunk + 2;         // a helper warp's words (<= 32 bits a field)
constexpr int kPerLane = kChunk / 32;      // fields a lane places
// staged symbols a helper thread fetches a chunk
constexpr int kFetch = (kMaxBlocks * kChunk + 32 * kHelpers - 1) / (32 * kHelpers);
static_assert(kChunk % 32 == 0, "a chunk is whole lanes' fields");

struct Meta {          // per block, in shared memory
  int n, fields, pos;  // symbols, chain fields, bits placed so far
  uint32_t carry;      // the partial word after pos
  int x[2];            // the states after the chain (state1, state2)
  int ok;              // the block's chains stay inside its shared table
};

size_t smem_bytes(int per_cta) {
  return static_cast<size_t>(per_cta) *
             (2 * kSlot + 8 * kSyms + 2 * 8 * kStage + 2 * 4 * kField + sizeof(Meta)) +
         4 * kHelpers * kWords;
}

// every state x in [L, 2L) moves to an index inside [0, L) under the
// symbol's transforms, with nb in [0, 31]: nb takes at most two values over
// the range (L <= 4096), and the index is non-decreasing within each
__device__ bool symbol_stays(int dnb, int dfs, int L) {
  const int x0 = L, x1 = 2 * L - 1;
  const int nb0 = (x0 + dnb) >> 16, nb1 = (x1 + dnb) >> 16;
  if (nb0 < 0 || nb1 > 31) return false;
  auto idx = [&](int x) { return (x >> ((x + dnb) >> 16)) + dfs; };
  int lo = idx(x0), hi = idx(x1);
  if (nb1 != nb0) {
    const int xt = ((nb0 + 1) << 16) - dnb;   // the first x of the second width
    lo = min(lo, idx(xt));
    hi = max(hi, idx(xt - 1));
  }
  return lo >= 0 && hi < L;
}

// One chunk of one state's chain: the fields q0, q0 + 2, ... (cnt of them).
template <bool kShared>
__device__ __forceinline__ int chain(int x, const int2* __restrict__ stg,
                                     uint32_t* __restrict__ fld,
                                     const uint16_t* __restrict__ st,
                                     const int32_t* __restrict__ gst, int T, int q0,
                                     int cnt) {
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const int q = q0 + 2 * i;
    const int2 d = stg[q];
    const int nb = (x + d.x) >> 16;
    const int idx = (x >> nb) + d.y;
    fld[q] = static_cast<uint32_t>(nb) << 16 | static_cast<uint32_t>(x);
    x = kShared ? st[idx] : __ldg(gst + clampi(idx, 0, T - 1));
  }
  return x;
}

// Places N fields a lane, in lane order, after the block's `pos` bits:
// their widths' warp scan gives the offsets, each field is ORed into the
// warp's word buffer (word 0 holds the carried partial word), the full
// words (with `last`, the partial one too) go to the row.
template <int N>
__device__ void place(uint32_t* __restrict__ wb, Meta& m, const uint32_t (&val)[N],
                      const int (&nb)[N], int lane, uint32_t* __restrict__ row, int W,
                      bool last) {
  if (lane == 0) wb[0] = m.carry;
  __syncwarp();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) sum += nb[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  const int start = m.pos & 31;
  int off = start + incl - sum;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (nb[i] > 0) {
      const int w = off >> 5, sh = off & 31;
      atomicOr(wb + w, val[i] << sh);
      if (sh + nb[i] > 32) atomicOr(wb + w + 1, val[i] >> (32 - sh));
    }
    off += nb[i];
  }
  __syncwarp();
  const int end = start + total;
  const int nstore = last ? (end + 31) >> 5 : end >> 5;
  const int g0 = m.pos >> 5;
  for (int i = lane; i < nstore; i += 32)
    if (g0 + i < W) row[g0 + i] = wb[i];
  const uint32_t carry = wb[end >> 5];
  __syncwarp();
  for (int i = lane; i <= end >> 5; i += 32) wb[i] = 0;
  __syncwarp();
  if (lane == 0) {
    m.carry = carry;
    m.pos += total;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
fse_encode_kernel(const uint8_t* __restrict__ src, int S,
                  const int32_t* __restrict__ n,
                  const int32_t* __restrict__ tlog,
                  const int32_t* __restrict__ state_table, int T,
                  const int32_t* __restrict__ dfs,
                  const int32_t* __restrict__ dnb, int nsym,
                  uint32_t* __restrict__ words, int W,
                  int32_t* __restrict__ csize, int B, int max_syms, int per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = per_cta;
  uint16_t* st = reinterpret_cast<uint16_t*>(smem);                 // [P][kSlot]
  int2* tr = reinterpret_cast<int2*>(st + P * kSlot);                // [P][kSyms]
  int2* stage = tr + P * kSyms;                                      // [2][P][kStage]
  uint32_t* fld = reinterpret_cast<uint32_t*>(stage + 2 * P * kStage);  // [2][P][kField]
  uint32_t* wbuf = fld + 2 * P * kField;                             // [kHelpers][kWords]
  Meta* meta = reinterpret_cast<Meta*>(wbuf + kHelpers * kWords);    // [P]
  __shared__ int n_chunks;

  const int b0 = blockIdx.x * P;
  const int nblk = min(P, B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = 2 * ((max_syms + 1) / 2);
  if (threadIdx.x == 0) n_chunks = 0;
  for (int i = threadIdx.x; i < kHelpers * kWords; i += kThreads) wbuf[i] = 0;
  __syncthreads();

  // 1. each block's tables into shared memory; its initial states (exact,
  // from global memory) and whether its chains stay inside the live table
  for (int p = warp; p < nblk; p += kThreads / 32) {
    const int b = b0 + p;
    const int tl = tlog[b];
    const int L = tl >= 1 && tl <= kMaxLog ? 1 << tl : 0;
    bool ok = L > 0 && L <= T;
    const int32_t* gst = state_table + static_cast<size_t>(b) * T;
    const int32_t* fs = dfs + static_cast<size_t>(b) * nsym;
    const int32_t* fb = dnb + static_cast<size_t>(b) * nsym;
    uint16_t* sst = st + p * kSlot;
    if (ok) {
      auto put = [&](int i, int v) {
        ok &= v >= L && v < 2 * L;
        sst[i] = static_cast<uint16_t>(v);
      };
      if (L >= 4 && reinterpret_cast<uintptr_t>(gst) % 16 == 0) {
        // 16-byte loads, four a lane in flight (written out: a loop
        // unrolled by the compiler mixed up the vectors of its remainder)
        for (int i0 = 4 * lane; i0 < L; i0 += 512) {
          int4 v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (i0 + 128 * r < L) v[r] = __ldg(reinterpret_cast<const int4*>(gst + i0 + 128 * r));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + 128 * r;
            if (i < L) {
              put(i, v[r].x);
              put(i + 1, v[r].y);
              put(i + 2, v[r].z);
              put(i + 3, v[r].w);
            }
          }
        }
      } else {
        for (int i = lane; i < L; i += 32) put(i, __ldg(gst + i));
      }
    }
    for (int s = lane; s < kSyms; s += 32) {
      const int sc = min(s, nsym - 1);
      const int2 d = make_int2(__ldg(fb + sc), __ldg(fs + sc));
      tr[p * kSyms + s] = d;
      if (ok) ok &= symbol_stays(d.x, d.y, L);
    }
    if (lane == 0) {
      const uint8_t* row = src + static_cast<size_t>(b) * S;
      auto init_state = [&](int j) {        // FSE_initCState2 (lib/fse.h:500-512)
        const int s = clampi(__ldg(row + clampi(j, 0, S - 1)), 0, nsym - 1);
        const int d = __ldg(fb + s);
        const int nb = (d + (1 << 15)) >> 16;
        return __ldg(gst + clampi((((nb << 16) - d) >> nb) + __ldg(fs + s), 0, T - 1));
      };
      const int nn = n[b];
      const int s_last = init_state(nn - 1), s_prev = init_state(nn - 2);
      const bool last_even = ((nn - 1) & 1) == 0;
      Meta& m = meta[p];
      m.n = nn;
      m.fields = min(max(nn - 2, 0), width);
      m.pos = 0;
      m.carry = 0;
      m.x[0] = last_even ? s_last : s_prev;
      m.x[1] = last_even ? s_prev : s_last;
      ok = ok && m.x[0] >= L && m.x[0] < 2 * L && m.x[1] >= L && m.x[1] < 2 * L;
      atomicMax(&n_chunks, (m.fields + kChunk - 1) / kChunk);
    }
    ok = __all_sync(0xFFFFFFFFu, ok);
    if (lane == 0) meta[p].ok = ok;
  }
  __syncthreads();

  const int K = n_chunks;
  bool shared_tables = true;
  for (int p = 0; p < nblk; ++p) shared_tables &= meta[p].ok != 0;
  // the helpers' thread index, and the slice of each row zeroed an iteration
  const int hid = threadIdx.x - 32;
  const int zslice = max(kChunk, (W + K) / (K + 1));

  // staging of chunk k, [p][q] rows: the source bytes are fetched into
  // registers (all loads in flight at once), then their transforms stored.
  // Indices are clamped into the CTA's blocks even where a guard fails:
  // the compiler may load ahead of the guard.
  uint8_t sym[kFetch];
  auto fetch_chunk = [&](int k) {
#pragma unroll
    for (int r = 0; r < kFetch; ++r) {
      const int i = hid + r * 32 * kHelpers, p = min(i / kChunk, nblk - 1);
      const int e = k * kChunk + i % kChunk;
      if (i / kChunk < nblk && e < meta[p].fields)
        sym[r] = src[static_cast<size_t>(b0 + p) * S + clampi(meta[p].n - 3 - e, 0, S - 1)];
    }
  };
  auto stage_chunk = [&](int k) {
    int2* out = stage + (k & 1) * P * kStage;
#pragma unroll
    for (int r = 0; r < kFetch; ++r) {
      const int i = hid + r * 32 * kHelpers, p = min(i / kChunk, nblk - 1), q = i % kChunk;
      if (i / kChunk < nblk && k * kChunk + q < meta[p].fields)
        out[p * kStage + q] = tr[p * kSyms + min(static_cast<int>(sym[r]), nsym - 1)];
    }
  };
  // placement: chunk k's fields of the helper warp's blocks
  auto place_chunk = [&](int k) {
    const int h = warp - 1;
    const uint32_t* in = fld + (k & 1) * P * kField;
    for (int p = h; p < nblk; p += kHelpers) {
      Meta& m = meta[p];
      const int e0 = k * kChunk + kPerLane * lane;
      if (k * kChunk >= m.fields) continue;
      uint32_t f[kPerLane], val[kPerLane];
      int nb[kPerLane];
      const uint32_t* mine = in + p * kField + kPerLane * lane;
      if constexpr (kPerLane % 4 == 0) {         // 16-byte loads
#pragma unroll
        for (int i = 0; i < kPerLane; i += 4) {
          const uint4 f4 = *reinterpret_cast<const uint4*>(mine + i);
          f[i] = f4.x, f[i + 1] = f4.y, f[i + 2] = f4.z, f[i + 3] = f4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) f[i] = mine[i];
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const uint32_t fi = e0 + i < m.fields ? f[i] : 0u;
        nb[i] = static_cast<int>(fi) >> 16;
        val[i] = fi & 0xFFFFu & mask32(nb[i]);
      }
      place(wbuf + h * kWords, m, val, nb, lane, words + static_cast<size_t>(b0 + p) * W,
            W, false);
    }
  };

  int x = 0;                                  // this chain lane's state
  const int p_mine = min(lane >> 1, nblk - 1), which = lane & 1;
  const bool chain_lane = warp == 0 && lane >> 1 < nblk;
  int q0 = 0;
  if (chain_lane) {
    x = meta[p_mine].x[which];
    // state1 emits the fields of even j = n-3-e: e of n-1's parity
    q0 = (meta[p_mine].n - 1 + which) & 1;
  }
  if (warp > 0 && K > 0) {
    fetch_chunk(0);
    stage_chunk(0);
  }
  __syncthreads();

  // 2. chains of chunk k | staging of chunk k+1, zeroing, placement of k-1
  for (int k = 0; k <= K; ++k) {
    if (warp == 0) {
      if (chain_lane && k < K) {
        const Meta& m = meta[p_mine];
        const int lim = min(kChunk, m.fields - k * kChunk);
        const int cnt = lim > q0 ? (lim - q0 + 1) >> 1 : 0;
        const int2* stg = stage + (k & 1) * P * kStage + p_mine * kStage;
        uint32_t* fl = fld + (k & 1) * P * kField + p_mine * kField;
        const int32_t* gst = state_table + static_cast<size_t>(b0 + p_mine) * T;
        x = shared_tables ? chain<true>(x, stg, fl, st + p_mine * kSlot, gst, T, q0, cnt)
                          : chain<false>(x, stg, fl, st + p_mine * kSlot, gst, T, q0, cnt);
      }
    } else {
      if (k + 1 < K) fetch_chunk(k + 1);
      // words [k*zslice, (k+1)*zslice) of each row: the placement of
      // iteration k stores only words below k*kChunk <= k*zslice
      const int z1 = min((k + 1) * zslice, W);
      for (int p = 0; p < nblk; ++p)
        for (int wd = k * zslice + hid; wd < z1; wd += 32 * kHelpers)
          words[static_cast<size_t>(b0 + p) * W + wd] = 0;
      if (k > 0) place_chunk(k - 1);
      if (k + 1 < K) stage_chunk(k + 1);
    }
    __syncthreads();
  }

  // 3. the flushes: state2, state1 (tableLog bits), the endMark; then csize
  if (chain_lane) meta[p_mine].x[which] = x;
  __syncthreads();
  if (warp == 0) return;
  const int h = warp - 1;
  for (int p = h; p < nblk; p += kHelpers) {
    Meta& m = meta[p];
    const int b = b0 + p;
    const int mm = max(m.n - 2, 0), tl = tlog[b];
    uint32_t val[1] = {0};
    int nb[1] = {0};
    if (lane < 3 && mm + lane < width + 3) {
      const uint32_t v = lane == 0 ? m.x[1] : lane == 1 ? m.x[0] : 1u;
      nb[0] = lane < 2 ? tl : 1;
      val[0] = v & mask32(nb[0]);
    }
    place(wbuf + h * kWords, m, val, nb, lane, words + static_cast<size_t>(b) * W, W, true);
    if (lane == 0) csize[b] = (m.pos + 7) >> 3;
  }
}

// blocks a CTA: spread the batch over every SM, at most 16 to a CTA
int per_cta_for(int B) {
  return std::max(1, std::min(kMaxBlocks, (B + stage::sm_count() - 1) / stage::sm_count()));
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
  const int per_cta = per_cta_for(B);
  const size_t smem = smem_bytes(per_cta);
  cudaError_t rc = cudaFuncSetAttribute(fse_encode_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fse_encode_kernel<<<(B + per_cta - 1) / per_cta, kThreads, smem,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(src), S, static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(tlog), static_cast<const int32_t*>(state_table), T,
      static_cast<const int32_t*>(dfs), static_cast<const int32_t*>(dnb), nsym,
      static_cast<uint32_t*>(words), W, static_cast<int32_t*>(csize), B, max_syms,
      per_cta);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for B blocks: {blocks a CTA, threads, dynamic shared
// bytes, CTAs an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// CTAs, SMs}.
extern "C" int fse_encode_config(int B, int* cfg) {
  const int per_cta = per_cta_for(std::max(B, 1));
  const size_t smem = smem_bytes(per_cta);
  cudaError_t rc = cudaFuncSetAttribute(fse_encode_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  int resident = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fse_encode_kernel,
                                                       kThreads, smem);
  cfg[0] = per_cta;
  cfg[1] = kThreads;
  cfg[2] = static_cast<int>(smem);
  cfg[3] = resident;
  cfg[4] = (std::max(B, 1) + per_cta - 1) / per_cta;
  cfg[5] = stage::sm_count();
  return static_cast<int>(rc);
}
