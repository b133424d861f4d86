// Threefry-2x32 counter-mode bits for Hopper (sm_90a): the hash behind
// jax.random, for a batch of keys in one launch.
//
// For each key r of a batch (keys: (R, 2) int64 holding uint32 words, as
// jax.random.key_data gives them) threefry_bits_kernel writes M 32-bit
// words of out (R, M), int32, each as its sort word: the word with its
// top bit flipped (word - 2^31), whose signed order is the words'
// unsigned order, so the torch side sorts them as they are.  Four
// layouts:
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
//   TF_FOLD       fold_in and the bare hash (M = 2): each key hashes the
//                 one counter (ctr >> 32, ctr & 0xffffffff) given by the
//                 caller and writes both words; fold_in(key, data) is
//                 ctr = data mod 2^32, in either jax layout.
//
// threefry_given_kernel is jax._src.prng.threefry_2x32(key, count) of a
// count of M words held on the device (cnt, int64 words): TF_ORIGINAL's
// pairing with the caller's words in place of iota(M), pair i hashing
// (cnt[i], cnt[h + i]), the second word 0 past M.
//
// threefry_round_kernel fuses one shuffle round of the anneal into one
// launch: for keys (R, 2) it writes the kept keys of split(keys) (when
// the source is split first) and the sort words of every round of
// permutation(sub, N), whose key chain it recomputes per block (a few
// hashes), in either layout.
//
// No TPU kernel is replaced: the reference draws these bits through XLA's
// threefry2x32 op (jax._src.prng).  They are kernels because the plain
// twin (repro_torch.kernels.threefry.threefry_bits_plain) runs ~7 torch
// ops per round for 20 rounds, well over 100 launches per call, and one
// shuffle round of the anneal drew five times before the fused round.
//
// What bounds them on the card: in TF_XOR and the fused round, the
// integer work.  Each word there is one full 20-round hash: 20 x (add,
// rotate, xor) plus the key injections, 69 integer instructions against
// 4 bytes stored, 47 of them (the rotations, the xors and the IADD3s) on
// the INT32 pipe, whose 132 SMs x 64 lanes retire ~16.7e12 per second
// against 3.35e12 bytes; the other adds issue to the FMA pipe beside it.
// The hash takes ~2.4x the stores' time (kernels/bounds.py,
// threefry_bound_ms, counts the hash from the SASS).
// TF_ORIGINAL and TF_PAIRS hash once per two words and are nearer the
// stores.  At the anneal's sizes (8 x 4096 words) the launch itself is
// the floor.  A thread owns consecutive counters (one, or four in the
// fused round, stored as one 16-byte vector where the row's alignment
// allows), consecutive threads consecutive counters, so the stores of a
// warp are contiguous; the key words are read once per thread from L1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TF_ORIGINAL = 0;
constexpr int TF_XOR = 1;
constexpr int TF_PAIRS = 2;
constexpr int TF_FOLD = 3;
constexpr int TF_THREADS = 256;
constexpr int TR_VEC = 4;   // counters per thread of the fused round

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
// words (TF_XOR) or counters (TF_PAIRS, TF_FOLD: from ctr on).
__global__ void __launch_bounds__(TF_THREADS)
threefry_bits_kernel(const long long* __restrict__ keys,
                     int* __restrict__ out, long long M,
                     long long items, int mode, unsigned long long ctr) {
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
    const unsigned long long c =
        (unsigned long long)i + (mode == TF_FOLD ? ctr : 0ull);
    uint32_t x0 = (uint32_t)(c >> 32);
    uint32_t x1 = (uint32_t)c;
    threefry2x32(k0, k1, x0, x1);
    if (mode == TF_XOR) {
      row[i] = sort_word(x0 ^ x1);
    } else {
      row[2 * i] = sort_word(x0);
      row[2 * i + 1] = sort_word(x1);
    }
  }
}

// Grid: (ceil(h / TF_THREADS), R), h = ceil(M / 2) pairs per key.
__global__ void __launch_bounds__(TF_THREADS)
threefry_given_kernel(const long long* __restrict__ keys,
                      const long long* __restrict__ cnt,
                      int* __restrict__ out, long long M, long long h) {
  const long long i = (long long)blockIdx.x * TF_THREADS + threadIdx.x;
  if (i >= h) return;
  const long long r = blockIdx.y;
  const uint32_t k0 = (uint32_t)keys[2 * r];
  const uint32_t k1 = (uint32_t)keys[2 * r + 1];
  const bool second = h + i < M;
  uint32_t x0 = (uint32_t)cnt[i];
  uint32_t x1 = second ? (uint32_t)cnt[h + i] : 0u;
  threefry2x32(k0, k1, x0, x1);
  int* row = out + r * M;
  row[i] = sort_word(x0);
  if (second) row[h + i] = sort_word(x1);
}

// One key of split(key): `second` picks the second.  Partitionable
// (_threefry_split_foldlike): key j is the hash of counter (0, j).
// Original (_threefry_split_original, 4 words, h = 2): pairs (0, 2) and
// (1, 3) hash to (a0, a1) and (b0, b1); key 0 is (a0, b0), key 1 (a1, b1).
__device__ __forceinline__ void split_key(uint32_t& k0, uint32_t& k1,
                                          bool partitionable, bool second) {
  if (partitionable) {
    uint32_t x0 = 0u, x1 = second ? 1u : 0u;
    threefry2x32(k0, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  } else {
    uint32_t a0 = 0u, a1 = 2u, b0 = 1u, b1 = 3u;
    threefry2x32(k0, k1, a0, a1);
    threefry2x32(k0, k1, b0, b1);
    k0 = second ? a1 : a0;
    k1 = second ? b1 : b0;
  }
}

// Four sort words to row[at .. at + 3], those below `end`: one 16-byte
// store when `vec` (the row and `at` 16-byte aligned) and all four fit.
__device__ __forceinline__ void store4(int* row, long long at, long long end,
                                       const int (&w)[TR_VEC], bool vec) {
  if (vec && at + TR_VEC <= end) {
    *reinterpret_cast<int4*>(row + at) = make_int4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int u = 0; u < TR_VEC; ++u)
      if (at + u < end) row[at + u] = w[u];
  }
}

// One shuffle round: block (x, r, t) holds round t of key r.  Its thread
// 0 walks the key chain of ThreefryShuffleSource.next_round and
// permutation: key r, split first when `kept` is given (its first key
// written to kept[r] by block (0, r, 0), its second the chain's start
// s_0), then s_{j + 1} = split(s_j)[0] and round t's key
// split(s_t)[1].  Every thread then hashes TR_VEC consecutive counters
// of that key into out[t, r, :] (n words): partitionable, word k the XOR
// of counter k's hash; original, pair i hashing (i, h + i), h =
// ceil(n / 2), into words i and h + i.
__global__ void __launch_bounds__(TF_THREADS)
threefry_round_kernel(const long long* __restrict__ keys,
                      long long* __restrict__ kept, int* __restrict__ out,
                      int R, long long n, int rounds, int partitionable) {
  __shared__ uint32_t key_t[2];
  const int r = blockIdx.y, t = blockIdx.z;
  const bool part = partitionable != 0;
  if (threadIdx.x == 0) {
    uint32_t k0 = (uint32_t)keys[2 * r], k1 = (uint32_t)keys[2 * r + 1];
    if (kept != nullptr) {
      if (blockIdx.x == 0 && t == 0) {
        uint32_t a0 = k0, a1 = k1;
        split_key(a0, a1, part, false);
        kept[2 * r] = a0;
        kept[2 * r + 1] = a1;
      }
      split_key(k0, k1, part, true);
    }
    for (int j = 0; j < t; ++j) split_key(k0, k1, part, false);
    split_key(k0, k1, part, true);
    key_t[0] = k0;
    key_t[1] = k1;
  }
  __syncthreads();
  if (t >= rounds) return;    // no round: the kept keys only
  const uint32_t s0 = key_t[0], s1 = key_t[1];
  int* const row = out + ((long long)t * R + r) * n;
  const long long g =
      ((long long)blockIdx.x * TF_THREADS + threadIdx.x) * TR_VEC;
  const bool vec = n % 4 == 0;
  if (part) {
    if (g >= n) return;
    int w[TR_VEC];
#pragma unroll
    for (int u = 0; u < TR_VEC; ++u) {
      const unsigned long long k = (unsigned long long)(g + u);
      uint32_t x0 = (uint32_t)(k >> 32), x1 = (uint32_t)k;
      threefry2x32(s0, s1, x0, x1);
      w[u] = sort_word(x0 ^ x1);
    }
    store4(row, g, n, w, vec);
  } else {
    const long long h = (n + 1) / 2;
    if (g >= h) return;
    int a[TR_VEC], b[TR_VEC];
#pragma unroll
    for (int u = 0; u < TR_VEC; ++u) {
      const long long i = g + u;
      uint32_t x0 = (uint32_t)i;
      uint32_t x1 = (h + i < n) ? (uint32_t)(h + i) : 0u;
      threefry2x32(s0, s1, x0, x1);
      a[u] = sort_word(x0);
      b[u] = sort_word(x1);
    }
    store4(row, g, h, a, vec);
    // the second half starts at h: 16-byte aligned only when 4 divides h
    store4(row, h + g, n, b, vec && h % 4 == 0);
  }
}

__global__ void noop_kernel() {}

}  // namespace

#define TF_EXPORT extern "C" __attribute__((visibility("default")))

// keys (R, 2) int64 and out (R, M) int32, contiguous; mode as above
// (TF_PAIRS and TF_FOLD need an even M; ctr is TF_FOLD's first counter).
// Returns the launch's cudaError_t.
TF_EXPORT int tf_bits(const void* keys, void* out, int R, long long M,
                      int mode, long long ctr, void* stream) {
  if (R <= 0 || M <= 0) return 0;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  long long items = mode == TF_ORIGINAL ? (M + 1) / 2
                    : mode == TF_XOR    ? M
                                        : M / 2;
  if (items <= 0) return 0;
  dim3 grid((unsigned)((items + TF_THREADS - 1) / TF_THREADS), (unsigned)R);
  threefry_bits_kernel<<<grid, TF_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (int*)out, M, items, mode,
      (unsigned long long)ctr);
  return (int)cudaGetLastError();
}

// keys (R, 2) int64 and cnt (M,) int64 words of the count in, out (R, M)
// int32, contiguous: threefry_2x32(key r, count) into row r.
TF_EXPORT int tf_given(const void* keys, const void* cnt, void* out, int R,
                       long long M, void* stream) {
  if (R <= 0 || M <= 0) return 0;
  if (R > 65535) return (int)cudaErrorInvalidValue;
  const long long h = (M + 1) / 2;
  dim3 grid((unsigned)((h + TF_THREADS - 1) / TF_THREADS), (unsigned)R);
  threefry_given_kernel<<<grid, TF_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const long long*)cnt, (int*)out, M, h);
  return (int)cudaGetLastError();
}

// keys (R, 2) int64 in; kept (R, 2) int64 out, or nullptr when the keys
// are not split first (permutation's own chain); out (rounds, R, n) int32
// sort words, contiguous.  partitionable selects the layout.
TF_EXPORT int tf_round(const void* keys, void* kept, void* out, int R,
                       long long n, int rounds, int partitionable,
                       void* stream) {
  if (R <= 0) return 0;
  if (R > 65535 || rounds > 65535 || rounds < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const long long items = partitionable ? n : (n + 1) / 2;
  const long long per_block = (long long)TF_THREADS * TR_VEC;
  const long long bx = items > 0 ? (items + per_block - 1) / per_block : 1;
  dim3 grid((unsigned)bx, (unsigned)R, (unsigned)(rounds > 0 ? rounds : 1));
  threefry_round_kernel<<<grid, TF_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (long long*)kept, (int*)out, R, n, rounds,
      partitionable);
  return (int)cudaGetLastError();
}

// An empty kernel, one warp: the launch floor the fused round is held to
// (timed in a CUDA graph of back-to-back launches).
TF_EXPORT int tf_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

TF_EXPORT const char* tf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
