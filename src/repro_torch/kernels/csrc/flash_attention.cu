// Flash-attention forward for Hopper (sm_90a), float32, with causal,
// q_offset and ragged-length masks and grouped-query heads (GQA).
//
// Operands are folded and unpadded: q (BH, tq, dh), k and v (BHkv, tk, dh),
// with BH = B * H query planes and BHkv = B * Hkv key/value planes, both
// ordered (batch, head).  Query plane p reads key/value plane p / rep,
// rep = H / Hkv: with p = b H + h that is b Hkv + h / rep, the head's own
// kv head, read in place, so repeated K and V are never materialised.
//
//   s_ij = (q_i . k_j) * scale, scored where
//          i < tq && j < tk && (!causal || j <= i + q_offset)
//   fa_stats  m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i)      (10a)
//   fa_apply  o_i = sum_j exp(s_ij - m_i) / max(l_i, 1e-30) v_j  (10b)
//
// They replace the Pallas TPU kernels of src/repro/kernels/
// flash_attention.py: _stats_kernel (:42) and _apply_kernel (:62), driven
// by flash_attention_fwd_pallas (:80).  On the TPU the key axis was a
// sequential grid axis carrying m and l (or the o block) from one step to
// the next; here a thread block owns one 64-row query tile of one plane
// and loops over the key tiles itself, so no block needs another's data
// and no atomics are used.  The TPU's padding of T to the tile and of dh
// to 128 lanes is not carried over: ragged rows, keys and dh are masked
// in-kernel.
//
// Masked pairs score the finite NEG_INF = -1e30 and get P = 0 explicitly,
// so a tile with no scored pair adds exactly 0.  In the causal case the
// key loop of a tile ends at its last row's diagonal: the key tiles wholly
// above it would add 0, and tile 0 always holds a scored column of every
// real row when q_offset >= 0, so the skip changes no number.  A row with
// no scored key at all (causal with i + q_offset < 0, only possible for a
// negative q_offset) is the uniform average over the tk keys, as the
// oracle's softmax of a row of equal -1e30 scores is; such a tile loops
// over every key.
//
// What bounds them on the card: at prefill (tq = tk = 4096, dh = 128)
// operations, 2 dh flops of q.k per pair (and 2 dh more of P v in
// fa_apply) against O(T dh) bytes; at decode (tq = 1) bytes, every key
// and value row read for one query.  The products run as float32 FMAs on
// the CUDA cores (no tensor cores, no TF32): q, k and v tiles are staged
// in shared memory 64 wide along dh (rows padded by one word against bank
// conflicts), and each thread keeps 16 scores and 16 accumulators in
// registers.  Block = (64-row query tile, [64-wide dh tile of o,] plane);
// fa_apply recomputes the scores in each dh tile's block.  Making the
// products run on wgmma with TMA-fed pipelines is later work.
//
// Each exported function launches on the given stream and returns
// cudaGetLastError() as an int.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (no --use_fast_math: the parity needs expf, not __expf).

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;   // threads per block
constexpr int TR = 64;    // query rows per tile
constexpr int TC = 64;    // keys per tile
constexpr int DT = 64;    // dh per staged chunk, and the o tile width
constexpr unsigned FULL = 0xffffffffu;
static_assert(TC == DT, "the P tile reuses the q chunk's buffer");

struct Geom {
  int tq, tk, dh, causal, q_offset;
  float scale;
};

// Sum (max) over the 4 adjacent lanes that share a row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
  return v;
}

// A row with no scored key: causal and wholly before the first key.
__device__ __forceinline__ bool empty_row(int i, const Geom& g) {
  return g.causal && i + g.q_offset < 0;
}

// Whether (row i, key j) is scored; an empty row scores every real key.
__device__ __forceinline__ bool pair_ok(int i, int j, const Geom& g) {
  if (i >= g.tq || j >= g.tk) return false;
  return !g.causal || j <= i + g.q_offset || empty_row(i, g);
}

// The end of the key loop of the row tile at r0.
__device__ __forceinline__ int key_end(int r0, const Geom& g) {
  if (!g.causal || empty_row(r0, g)) return g.tk;
  return min(g.tk, min(r0 + TR, g.tq) + g.q_offset);
}

// Stage rows [r0, r0 + 64) x columns [c0, c0 + DT) of a (rows, dh) plane
// into a tile, zero outside the plane.
__device__ __forceinline__ void stage(float (*dst)[DT + 1],
                                      const float* __restrict__ src, int r0,
                                      int c0, int rows, int dh) {
  for (int idx = threadIdx.x; idx < 64 * DT; idx += NT) {
    const int r = idx / DT, c = idx % DT;
    dst[r][c] = (r0 + r < rows && c0 + c < dh)
                    ? src[(size_t)(r0 + r) * dh + c0 + c]
                    : 0.f;
  }
}

// The scores of row r against keys j0 + c4 + 4k (k < 16), masked: q.k over
// dh in DT-wide chunks staged into qs and ks, then scaled.  Starts with a
// barrier, so the caller may reuse both buffers until its next call.
__device__ __forceinline__ void tile_scores(
    float s[16], float (*qs)[DT + 1], float (*ks)[DT + 1],
    const float* __restrict__ qp, const float* __restrict__ kp, int r0,
    int j0, int r, int c4, const Geom& g) {
#pragma unroll
  for (int k = 0; k < 16; ++k) s[k] = 0.f;
  for (int c0 = 0; c0 < g.dh; c0 += DT) {
    __syncthreads();
    stage(qs, qp, r0, c0, g.tq, g.dh);
    stage(ks, kp, j0, c0, g.tk, g.dh);
    __syncthreads();
    const int dn = min(DT, g.dh - c0);
    for (int c = 0; c < dn; ++c) {
      const float qv = qs[r][c];
#pragma unroll
      for (int k = 0; k < 16; ++k) s[k] = fmaf(qv, ks[c4 + 4 * k][c], s[k]);
    }
  }
  const int i = r0 + r;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = j0 + c4 + 4 * k;
    s[k] = !pair_ok(i, j, g) ? NEG_INF : (empty_row(i, g) ? 0.f
                                                          : s[k] * g.scale);
  }
}

// ---------------------------------------------------------------------------
// Kernel 10a: row statistics.  Block = (query tile, plane); thread t owns
// row t/4 and, in each key tile, keys t%4 + 4k.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
fa_stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
                float* __restrict__ m_out, float* __restrict__ l_out,
                int rep, Geom g) {
  __shared__ float qs[TR][DT + 1];
  __shared__ float ks[TC][DT + 1];

  const int plane = blockIdx.y, r0 = blockIdx.x * TR;
  const int r = threadIdx.x / 4, c4 = threadIdx.x % 4, i = r0 + r;
  const float* qp = q + (size_t)plane * g.tq * g.dh;
  const float* kp = k + (size_t)(plane / rep) * g.tk * g.dh;

  // The four lanes of a row hold the same m and l (quad reductions).
  float m = NEG_INF, l = 0.f;
  const int end = key_end(r0, g);
  for (int j0 = 0; j0 < end; j0 += TC) {
    float s[16];
    tile_scores(s, qs, ks, qp, kp, r0, j0, r, c4, g);
    float mx = NEG_INF;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) mx = fmaxf(mx, s[kk]);
    const float m_new = fmaxf(m, quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      sum += pair_ok(i, j0 + c4 + 4 * kk, g) ? expf(s[kk] - m_new) : 0.f;
    l = l * expf(m - m_new) + quad_sum(sum);
    m = m_new;
  }
  if (c4 == 0 && i < g.tq) {
    m_out[(size_t)plane * g.tq + i] = m;
    l_out[(size_t)plane * g.tq + i] = l;
  }
}

// ---------------------------------------------------------------------------
// Kernel 10b: o = P v with P from the saved m and l, no rescaling.  Block =
// (query tile, dh tile of o, plane); thread t owns row t/4, and o columns
// c0 + t%4 + 4k.  The q chunk's buffer then holds the P tile, the k
// chunk's the v tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
fa_apply_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ m,
                const float* __restrict__ l, float* __restrict__ o, int rep,
                Geom g) {
  __shared__ float buf_a[TR][DT + 1];   // q chunk, then P
  __shared__ float buf_b[TC][DT + 1];   // k chunk, then the v tile

  const int plane = blockIdx.z, r0 = blockIdx.x * TR, c0 = blockIdx.y * DT;
  const int r = threadIdx.x / 4, c4 = threadIdx.x % 4, i = r0 + r;
  const float* qp = q + (size_t)plane * g.tq * g.dh;
  const float* kp = k + (size_t)(plane / rep) * g.tk * g.dh;
  const float* vp = v + (size_t)(plane / rep) * g.tk * g.dh;
  const bool row_ok = i < g.tq;
  const float mr = row_ok ? m[(size_t)plane * g.tq + i] : 0.f;
  const float lr = row_ok ? fmaxf(l[(size_t)plane * g.tq + i], 1e-30f) : 1.f;

  float acc[16];
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) acc[kk] = 0.f;

  const int end = key_end(r0, g);
  for (int j0 = 0; j0 < end; j0 += TC) {
    float s[16];
    tile_scores(s, buf_a, buf_b, qp, kp, r0, j0, r, c4, g);
    __syncthreads();   // every thread has read the q and k chunks
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int j = c4 + 4 * kk;
      buf_a[r][j] = pair_ok(i, j0 + j, g) ? expf(s[kk] - mr) / lr : 0.f;
    }
    stage(buf_b, vp, j0, c0, g.tk, g.dh);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TC; ++j) {
      const float p = buf_a[r][j];
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        acc[kk] = fmaf(p, buf_b[j][c4 + 4 * kk], acc[kk]);
    }
  }

  if (row_ok) {
    float* orow = o + (size_t)plane * g.tq * g.dh + (size_t)i * g.dh;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int c = c0 + c4 + 4 * kk;
      if (c < g.dh) orow[c] = acc[kk];
    }
  }
}

}  // namespace

#define FA_EXPORT extern "C" __attribute__((visibility("default")))

FA_EXPORT int fa_stats_f32(const void* q, const void* k, void* m, void* l,
                           int bh, int rep, int tq, int tk, int dh,
                           float scale, int causal, int q_offset,
                           void* stream) {
  const Geom g{tq, tk, dh, causal, q_offset, scale};
  dim3 grid((tq + TR - 1) / TR, bh);
  fa_stats_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (float*)m, (float*)l, rep, g);
  return (int)cudaGetLastError();
}

FA_EXPORT int fa_apply_f32(const void* q, const void* k, const void* v,
                           const void* m, const void* l, void* o, int bh,
                           int rep, int tq, int tk, int dh, float scale,
                           int causal, int q_offset, void* stream) {
  const Geom g{tq, tk, dh, causal, q_offset, scale};
  dim3 grid((tq + TR - 1) / TR, (dh + DT - 1) / DT, bh);
  fa_apply_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)m,
      (const float*)l, (float*)o, rep, g);
  return (int)cudaGetLastError();
}

FA_EXPORT const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
