// Threefry-2x32 counter-mode bits for Hopper (sm_90a): the hash behind
// jax.random, for a batch of keys in one launch.
//
// For each key r of a batch (keys: (R, 2) int64 holding uint32 words, as
// jax.random.key_data gives them) the kernel writes M 32-bit words of
// out (R, M), int32, each as its sort word: the word with its top bit
// flipped (word - 2^31), whose signed order is the words' unsigned order,
// so the torch side sorts them as they are.  Three layouts:
//
//   TF_ORIGINAL   jax's original layout (jax_threefry_partitionable off,
//                 the default of jax < 0.5): the counts iota(M), padded
//                 with one 0 when M is odd, are cut in two halves; pair i
//                 hashes (i, h + i), h = ceil(M / 2), and writes its first
//                 word to out[i] and its second to out[h + i] (dropped
//                 past M).  random_bits and split (M = 2 num) alike.
//   TF_XOR        random_bits with jax_threefry_partitionable on (jax
//                 0.9.0's default): word k hashes the 64-bit counter k
//                 as (k >> 32, k & 0xffffffff) and is the XOR of the two
//                 words it gets.
//   TF_PAIRS      split with jax_threefry_partitionable on: counter k
//                 (k < M / 2) writes both words, out[2k] and out[2k + 1].
//
// No TPU kernel is replaced: the reference draws these bits through XLA's
// threefry2x32 op (jax._src.prng).  It is a kernel because the plain
// twin (repro_torch.kernels.threefry.threefry_bits_plain) runs ~7 torch
// ops per round for 20 rounds, well over 100 launches per call, and one
// shuffle round of the anneal draws twice per instance batch.
//
// What bounds it on the card: bytes.  A counter costs 20 rounds of an
// add, a rotate and a xor plus 6 key injections (~70 integer operations)
// and writes 4 bytes per word; at the H100's integer rate that is below
// the store time for every size the port draws.  A thread owns one
// counter (one pair in TF_ORIGINAL), consecutive threads consecutive
// counters, so the stores of a warp are contiguous; the key words are
// read once per thread from L1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TF_ORIGINAL = 0;
constexpr int TF_XOR = 1;
constexpr int TF_PAIRS = 2;
constexpr int TF_THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ int sort_word(uint32_t x) {
  return (int)(x ^ 0x80000000u);
}

#define TF_ROUND(r)        \
  x0 += x1;                \
  x1 = rotl(x1, r) ^ x0;

// jax._src.prng._threefry2x32_lowering, unrolled: 5 groups of 4 rounds,
// a key injection after each.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

// Grid: (ceil(items / TF_THREADS), R); items are pairs (TF_ORIGINAL),
// words (TF_XOR) or counters (TF_PAIRS).
__global__ void __launch_bounds__(TF_THREADS)
threefry_bits_kernel(const long long* __restrict__ keys,
                     int* __restrict__ out, long long M,
                     long long items, int mode) {
  const long long i = (long long)blockIdx.x * TF_THREADS + threadIdx.x;
  if (i >= items) return;
  const long long r = blockIdx.y;
  const uint32_t k0 = (uint32_t)keys[2 * r];
  const uint32_t k1 = (uint32_t)keys[2 * r + 1];
  int* row = out + r * M;
  if (mode == TF_ORIGINAL) {
    const long long h = items;                 // ceil(M / 2)
    uint32_t x0 = (uint32_t)i;
    uint32_t x1 = (h + i < M) ? (uint32_t)(h + i) : 0u;
    threefry2x32(k0, k1, x0, x1);
    row[i] = sort_word(x0);
    if (h + i < M) row[h + i] = sort_word(x1);
  } else {
    uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
    uint32_t x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    if (mode == TF_XOR) {
      row[i] = sort_word(x0 ^ x1);
    } else {
      row[2 * i] = sort_word(x0);
      row[2 * i + 1] = sort_word(x1);
    }
  }
}

}  // namespace

#define TF_EXPORT extern "C" __attribute__((visibility("default")))

// keys (R, 2) int64 and out (R, M) int32, contiguous; mode as above (TF_PAIRS
// needs an even M).  Returns the launch's cudaError_t.
TF_EXPORT int tf_bits(const void* keys, void* out, int R, long long M,
                      int mode, void* stream) {
  if (R <= 0 || M <= 0) return 0;
  long long items = mode == TF_ORIGINAL ? (M + 1) / 2
                    : mode == TF_PAIRS  ? M / 2
                                        : M;
  if (items <= 0) return 0;
  dim3 grid((unsigned)((items + TF_THREADS - 1) / TF_THREADS), (unsigned)R);
  threefry_bits_kernel<<<grid, TF_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (int*)out, M, items, mode);
  return (int)cudaGetLastError();
}

TF_EXPORT const char* tf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
