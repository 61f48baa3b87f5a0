// Latency of the dependent steps a TurboRANS lane's chain is made of.
//
// Not a codec kernel: a microbenchmark that chip_smoke.py runs on one block
// to turn the per-step chain of rans_encode.cu and rans_decode.cu into a
// bound (T dependent steps per group, each at least as long as the
// dependent operations below).  Every thread runs `steps` dependent steps
// of one kind:
//   mode 0: a shared-memory load whose address is the last load's value
//           (the decoder's table lookup);
//   mode 1: the same through global memory, on a buffer small enough to
//           stay in L1 (the decoder's stream read at its best);
//   mode 2: the same with __ldcg, which skips L1: an L2 hit;
//   mode 3: a block barrier with a shared-memory exchange between warps,
//           double-buffered by step parity as both kernels do (their
//           per-step rank scan).
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
  } else {
    for (int t = 0; t < steps; ++t) {
      if ((k & 31) == 0) cnt[t & 1][w] = v;
      __syncthreads();
      v = cnt[t & 1][(w + 1) % nw] + 1;
    }
  }
  out[k] = v;
}

}  // namespace

// chain: [chain_len] i32, each entry the index of the next; out: [threads]
// i32.  One block of `threads` threads.  Returns the launch's cudaError_t.
extern "C" int chain_probe_launch(int mode, const void* chain, int chain_len,
                                  int steps, int threads, void* out,
                                  void* cuda_stream) {
  if (threads % 32 || threads > 1024 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  chain_probe<<<1, threads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      mode, static_cast<const int32_t*>(chain), chain_len, steps,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
