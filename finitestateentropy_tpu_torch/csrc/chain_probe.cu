// Latency of the dependent steps a TurboRANS lane's chain is made of.
//
// Not a codec kernel: a microbenchmark that chip_smoke.py runs on one block
// to turn the per-step chain of the codec kernels into a bound (T dependent
// steps per group, each at least as long as the dependent operations
// below).  Every thread runs `steps` dependent steps of one kind:
//   mode 0: a shared-memory load whose address is the last load's value
//           (the decoder's table lookup);
//   mode 1: the same through global memory, on a buffer small enough to
//           stay in L1 (the decoder's stream read at its best);
//   mode 2: the same with __ldcg, which skips L1: an L2 hit;
//   mode 3: a block barrier with a shared-memory exchange between warps,
//           double-buffered by step parity (the flat-rank and v0 decodes'
//           per-step exchange of row counts: 256 threads hold a group in
//           their design, 1024 did before);
//   mode 4: the encoder's state recurrence (rans_encode.cu): compare with
//           the renorm threshold, conditional shift, __umulhi by the magic
//           reciprocal, multiply-subtract, two corrections, shift-add;
//   mode 5: a multiply-add, then a warp ballot and its popcount added back
//           (the rows decode's state update and rank, rans_decode.cu).
// The value chain is written to `out`, so no step can be optimised away.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSmem = 1024;

__global__ void chain_probe(int mode, const int32_t* __restrict__ chain,
                            int chain_len, int steps, int32_t* __restrict__ out) {
  __shared__ int32_t s[kSmem];
  __shared__ int32_t cnt[2][32];
  const int k = threadIdx.x;
  const int w = k >> 5;
  const int nw = blockDim.x >> 5;
  // an odd stride makes a permutation of the 1024 words: no bank conflicts
  for (int i = k; i < kSmem; i += blockDim.x) s[i] = (i * 97 + 13) & (kSmem - 1);
  __syncthreads();

  int32_t v = k % chain_len;
  if (mode == 0) {
    v = k & (kSmem - 1);
    for (int t = 0; t < steps; ++t) v = s[v];
  } else if (mode == 1) {
    for (int t = 0; t < steps; ++t) v = chain[v];
  } else if (mode == 2) {
    for (int t = 0; t < steps; ++t) v = __ldcg(chain + v);
  } else if (mode == 3) {
    for (int t = 0; t < steps; ++t) {
      if ((k & 31) == 0) cnt[t & 1][w] = v;
      __syncthreads();
      v = cnt[t & 1][(w + 1) % nw] + 1;
    }
  } else if (mode == 4) {
    // a symbol of frequency f (from the thread index, so nothing folds) at
    // tableLog 11, cumul 5; x stays in [2^16, 2^32)
    const uint32_t f = 97u + static_cast<uint32_t>(k & 63);
    const uint32_t m = 0xFFFFFFFFu / f;
    const int tlog = 11;
    uint32_t x = 1u << 16 | static_cast<uint32_t>(k);
    for (int t = 0; t < steps; ++t) {
      if (x >= (f << (32 - tlog))) x >>= 16;
      uint32_t q = __umulhi(x, m);
      uint32_t r = x - q * f;
      if (r >= f) { ++q; r -= f; }
      if (r >= f) { ++q; r -= f; }
      x = (q << tlog) + 5u + r;
    }
    v = static_cast<int32_t>(x);
  } else {
    uint32_t x = static_cast<uint32_t>(k);
    for (int t = 0; t < steps; ++t) {
      x = x * 2654435761u + 12345u;
      x += __popc(__ballot_sync(0xFFFFFFFFu, x & 0x10000u));
    }
    v = static_cast<int32_t>(x);
  }
  out[k] = v;
}

}  // namespace

// chain: [chain_len] i32, each entry the index of the next; out: [threads]
// i32.  One block of `threads` threads.  Returns the launch's cudaError_t.
extern "C" int chain_probe_launch(int mode, const void* chain, int chain_len,
                                  int steps, int threads, void* out,
                                  void* cuda_stream) {
  if (threads % 32 || threads > 1024 || mode < 0 || mode > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  chain_probe<<<1, threads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      mode, static_cast<const int32_t*>(chain), chain_len, steps,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
