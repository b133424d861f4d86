// SoftSort-apply kernels for Hopper (sm_90a): forward and backward, over
// every (row, column) pair (the dense tier) or over a band in rank space
// (the banded tier).
//
// For each instance b of a batch, with sorted keys ws (rows) and keys w
// (columns), all float32, and a payload x (N, d) in the compute type T
// (float or __nv_bfloat16):
//
//   s_ij = -|ws_i - w_j| * (1 / tau)        (rounded through T)
//   P_ij = exp(s_ij - m_i) / l_i            (row softmax)
//
//   ss_fwd_fused      y = P x, with the row stats m, l       (kernel 1)
//   ss_colsum         colsum_j = sum_i P_ij                  (kernel 2)
//   ss_bwd_dws_delta  D_i, dws_i                             (kernel 3)
//   ss_bwd_dx         dx = P^T dy, dw_cols, dtau_cols        (kernel 4)
//
// The banded tier (kernels 5-8: ss_fwd_band, ss_colsum_band,
// ss_bwd_band_dws_delta, ss_bwd_band_dcol) runs the same four sweeps with
// both axes the sorted keys ws and the payload in rank order, over the
// pairs with |i - j| <= K only: P~ is exactly 0 off the band.  Each
// kernel template takes BAND; with BAND a tile of rows (or columns)
// [t0, t0 + 64) loops over the other axis only across
// [max(0, t0 - K), min(n, t0 + 64 + K)) and masks the pairs outside the
// band, so the work is O(N K) instead of O(N^2).  The dense instantiation
// (BAND = false) is the code of the dense tier, unchanged.
//
// They replace the Pallas TPU kernels of src/repro/kernels/softsort_apply.py:
// _fwd_fused_kernel (:150), _colsum_kernel (:182), _bwd_dws_delta_kernel
// (:280), _bwd_dx_kernel (:324), and their banded forms _fwd_band_kernel
// (:517), _colsum_band_kernel (:567), _bwd_band_dws_delta_kernel (:657)
// and _bwd_band_dcol_kernel (:706).  On the TPU each carried its running
// sums across a sequential grid axis; here a thread block owns a tile of
// rows (kernels 1, 3, 5, 7) or of columns (kernels 2, 4, 6, 8) of one
// instance and loops over the other axis itself, so blocks need nothing
// from one another: no atomics, and every result is the same whatever the
// order blocks run in and whatever the batch size.  The TPU's transposed
// banded layout (scores column-major, payload d-on-sublanes) and its
// clipped edge blocks are TPU artifacts and are not carried over: the
// payload stays row-major (N, d), and a block loops over its exact span.
//
// What bounds them on the card: operations.  Per (row, column) pair
// kernels 1, 3 and 4 do 2d to 4d flops of payload products beside an
// exp and a few flops of score, while they read only O(N d) bytes: at
// N = 4096, d = 50 that is thousands of flops per byte (and with the band,
// O(K d) per byte).  The products run as float32 FMAs on the CUDA cores
// (no tensor cores, so no TF32 rounding: the float32 results hold the JAX
// reference to ~1e-6), and the design keeps those FMA loops fed from
// shared memory: key and payload tiles are staged in shared memory (rows
// padded by one word against bank conflicts), each thread keeps 8-16
// accumulators in registers, and the score tile is computed once per
// block and reused by every payload column.  The payload tile is 64 wide
// whatever d is, so at small d most of its lanes are padding.  Making the
// products run on wgmma with TMA-fed pipelines is later work.
//
// Masking follows the TPU kernels: columns >= n (and, banded, pairs off
// the band) score NEG_INF = -1e30 (finite, so exp underflows to exactly 0
// with no inf arithmetic) and get P = 0 explicitly, so a fully masked
// tile adds nothing; rows >= n are left out of every column reduction,
// and l is floored at 1e-30.
//
// Each exported function launches on the given stream and returns
// cudaGetLastError() as an int.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsoftsort_apply.so softsort_apply.cu
// (no --use_fast_math: the parity needs expf, not __expf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;   // threads per block
constexpr int TR = 64;    // row tile
constexpr int TC = 64;    // column tile
constexpr int DT = 64;    // payload-width tile
constexpr int TR4 = 32;   // row tile of the column sweep (kernel 4)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// A float32 value rounded through the compute type (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ float score(float wr, float wc, float inv_tau) {
  return rnd<T>(-fabsf(wr - wc) * inv_tau);
}

__device__ __forceinline__ float sgnf(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// Whether the pair (row i, column j) is scored: dense, the column is real
// (rows >= n are masked where they meet a column reduction); banded, both
// are real and within K ranks of each other.
template <bool BAND>
__device__ __forceinline__ bool pair_ok(int i, int j, int n, int K) {
  if constexpr (BAND) {
    return i < n && j < n && abs(i - j) <= K;
  } else {
    return j < n;
  }
}

// The span [lo, hi) of the other axis that a tile [t0, t0 + len) meets.
template <bool BAND>
__device__ __forceinline__ int span_lo(int t0, int K) {
  if constexpr (BAND) {
    return max(0, t0 - K);
  } else {
    return 0;
  }
}

template <bool BAND>
__device__ __forceinline__ int span_hi(int t0, int len, int n, int K) {
  if constexpr (BAND) {
    return min(n, t0 + len + K);
  } else {
    return n;
  }
}

// Sum over the 4 adjacent lanes that share a row (or a column).
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

// Stage rows [r0, r0 + R) x payload columns [c0, c0 + DT) of a (n, d)
// matrix into a float tile, zero outside the matrix.
template <typename T, int R>
__device__ __forceinline__ void stage(float (*dst)[DT + 1], const T* src,
                                      int r0, int c0, int n, int d) {
  for (int idx = threadIdx.x; idx < R * DT; idx += NT) {
    const int r = idx / DT, c = idx % DT;
    dst[r][c] = (r0 + r < n && c0 + c < d)
                    ? to_f(src[(size_t)(r0 + r) * d + c0 + c])
                    : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Kernels 1 and 5: fused online-softmax forward.  Block = (row tile,
// payload tile, instance); thread t owns row t/4 and payload columns
// t%4 + 4k.  Every payload tile block recomputes the row stats (cheap next
// to the products); the one with blockIdx.y == 0 writes m and l.
// ---------------------------------------------------------------------------
template <typename T, bool BAND>
__global__ void __launch_bounds__(NT)
fwd_fused_kernel(const float* __restrict__ ws, const float* __restrict__ w,
                 const T* __restrict__ x, const float* __restrict__ tau,
                 T* __restrict__ y, float* __restrict__ m_out,
                 float* __restrict__ l_out, int n, int d, int K) {
  __shared__ float ws_s[TR], w_s[TC], m_s[TR], l_s[TR], corr_s[TR];
  __shared__ float p_s[TR][TC + 1];
  __shared__ float x_s[TC][DT + 1];

  const int b = blockIdx.z, r0 = blockIdx.x * TR, c0 = blockIdx.y * DT;
  const int tid = threadIdx.x, r = tid / 4, q = tid % 4, i = r0 + r;
  ws += (size_t)b * n;
  w += (size_t)b * n;
  x += (size_t)b * n * d;
  const float inv_tau = 1.0f / tau[0];
  const int j_lo = span_lo<BAND>(r0, K), j_hi = span_hi<BAND>(r0, TR, n, K);

  if (tid < TR) {
    ws_s[tid] = r0 + tid < n ? ws[r0 + tid] : 0.f;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;

  for (int j0 = j_lo; j0 < j_hi; j0 += TC) {
    __syncthreads();
    if (tid < TC) w_s[tid] = j0 + tid < n ? w[j0 + tid] : 0.f;
    stage<T, TC>(x_s, x, j0, c0, n, d);
    __syncthreads();

    // Scores, tile max and the un-normalized probabilities of row r.
    {
      const float wr = ws_s[r];
      float s[16], mx = NEG_INF;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = q + 4 * k;
        s[k] = pair_ok<BAND>(i, j0 + j, n, K) ? score<T>(wr, w_s[j], inv_tau)
                                              : NEG_INF;
        mx = fmaxf(mx, s[k]);
      }
      mx = quad_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        // The explicit mask keeps a fully masked tile exact: there m_new
        // is still NEG_INF and exp(s - m_new) would be exp(0) = 1.
        const float p = pair_ok<BAND>(i, j0 + q + 4 * k, n, K)
                            ? expf(s[k] - m_new) : 0.f;
        sum += p;
        p_s[r][q + 4 * k] = rnd<T>(p);
      }
      sum = quad_sum(sum);
      __syncwarp();   // every lane has read m_s[r] before lane q == 0 writes
      if (q == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P_tile @ x_tile for row r, columns q + 4k.
    {
      float t[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) t[k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < TC; ++j) {
        const float p = p_s[r][j];
#pragma unroll
        for (int k = 0; k < 16; ++k) t[k] = fmaf(p, x_s[j][q + 4 * k], t[k]);
      }
      const float corr = corr_s[r];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = acc[k] * corr + t[k];
    }
  }

  __syncthreads();
  if (i < n) {
    const float l = fmaxf(l_s[r], 1e-30f);
    T* yr = y + (size_t)b * n * d + (size_t)i * d;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = c0 + q + 4 * k;
      if (c < d) yr[c] = from_f<T>(acc[k] / l);
    }
    if (blockIdx.y == 0 && q == 0) {
      m_out[(size_t)b * n + i] = m_s[r];
      l_out[(size_t)b * n + i] = l_s[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels 2 and 6: column sums.  Block = (64 columns, instance), 256
// threads as 64 columns x 4 row groups; rows are staged 256 at a time.
// ---------------------------------------------------------------------------
template <typename T, bool BAND>
__global__ void __launch_bounds__(NT)
colsum_kernel(const float* __restrict__ ws, const float* __restrict__ w,
              const float* __restrict__ tau, const float* __restrict__ m,
              const float* __restrict__ l, float* __restrict__ c_out, int n,
              int K) {
  __shared__ float ws_s[NT], m_s[NT], l_s[NT];
  __shared__ float part_s[4][TC];

  const int b = blockIdx.y, jt = blockIdx.x * TC;
  const int j = jt + threadIdx.x % TC, g = threadIdx.x / TC;
  ws += (size_t)b * n;
  w += (size_t)b * n;
  m += (size_t)b * n;
  l += (size_t)b * n;
  const float inv_tau = 1.0f / tau[0];
  const float wj = j < n ? w[j] : 0.f;
  const int i_lo = span_lo<BAND>(jt, K), i_hi = span_hi<BAND>(jt, TC, n, K);

  float acc = 0.f;
  for (int i0 = i_lo; i0 < i_hi; i0 += NT) {
    __syncthreads();
    const int i = i0 + threadIdx.x;
    ws_s[threadIdx.x] = i < n ? ws[i] : 0.f;
    m_s[threadIdx.x] = i < n ? m[i] : 0.f;
    l_s[threadIdx.x] = i < n ? fmaxf(l[i], 1e-30f) : 1.f;
    __syncthreads();
    const int cnt = min(NT, i_hi - i0);
    float part = 0.f;
    for (int ii = g; ii < cnt; ii += 4) {
      if constexpr (BAND) {
        if (!pair_ok<true>(i0 + ii, j, n, K)) continue;
      }
      part += expf(score<T>(ws_s[ii], wj, inv_tau) - m_s[ii]) / l_s[ii];
    }
    acc += part;
  }
  part_s[g][threadIdx.x % TC] = acc;
  __syncthreads();
  if (g == 0 && j < n) {
    const int jj = threadIdx.x;
    c_out[(size_t)b * n + j] =
        (part_s[0][jj] + part_s[1][jj]) + (part_s[2][jj] + part_s[3][jj]);
  }
}

// ---------------------------------------------------------------------------
// Kernels 3 and 7: fused delta + dws row sweep.  Block = (row tile,
// instance); thread t owns row t/4 and, in each column tile, columns
// t%4 + 4k.
//   D_i   = dy_i . y_i + sum_j P_ij dc_j
//   A_i   = sum_j P_ij dP_ij sgn_ij,  S_i = sum_j P_ij sgn_ij
//   dws_i = -(A_i - D_i S_i) / tau,   dP_ij = dy_i . x_j + dc_j
// Banded, dws is the row part of the key gradient and the delta trick
// holds for the truncated P~ with the saved banded y.
// ---------------------------------------------------------------------------
template <typename T, bool BAND>
__global__ void __launch_bounds__(NT)
bwd_dws_delta_kernel(const float* __restrict__ ws,
                     const float* __restrict__ w, const T* __restrict__ x,
                     const float* __restrict__ tau,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const T* __restrict__ dy, const T* __restrict__ y,
                     const T* __restrict__ dc, float* __restrict__ D_out,
                     float* __restrict__ dws_out, int n, int d, int K) {
  __shared__ float ws_s[TR], m_s[TR], l_s[TR], w_s[TC], dc_s[TC];
  __shared__ float dy_s[TR][DT + 1];
  __shared__ float x_s[TC][DT + 1];

  const int b = blockIdx.y, r0 = blockIdx.x * TR;
  const int tid = threadIdx.x, r = tid / 4, q = tid % 4, i = r0 + r;
  ws += (size_t)b * n;
  w += (size_t)b * n;
  m += (size_t)b * n;
  l += (size_t)b * n;
  dc += (size_t)b * n;
  x += (size_t)b * n * d;
  dy += (size_t)b * n * d;
  y += (size_t)b * n * d;
  const float inv_tau = 1.0f / tau[0];
  const int nd = (d + DT - 1) / DT;
  const bool dy_resident = nd == 1;   // dy tile staged once for d <= DT
  const int j_lo = span_lo<BAND>(r0, K), j_hi = span_hi<BAND>(r0, TR, n, K);

  if (tid < TR) {
    const bool ok = r0 + tid < n;
    ws_s[tid] = ok ? ws[r0 + tid] : 0.f;
    m_s[tid] = ok ? m[r0 + tid] : 0.f;
    l_s[tid] = ok ? fmaxf(l[r0 + tid], 1e-30f) : 1.f;
  }
  // D_i starts at dy_i . y_i (the delta trick: y was saved).
  float dyy = 0.f;
  if (i < n) {
    const T* dyr = dy + (size_t)i * d;
    const T* yr = y + (size_t)i * d;
    for (int c = q; c < d; c += 4) dyy += to_f(dyr[c]) * to_f(yr[c]);
  }
  dyy = quad_sum(dyy);
  if (dy_resident) stage<T, TR>(dy_s, dy, r0, 0, n, d);

  float d_acc = 0.f, a_acc = 0.f, s_acc = 0.f;
  for (int j0 = j_lo; j0 < j_hi; j0 += TC) {
    float dp[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) dp[k] = 0.f;
    for (int cc = 0; cc < nd; ++cc) {
      __syncthreads();
      if (cc == 0 && tid < TC) {
        const bool ok = j0 + tid < n;
        w_s[tid] = ok ? w[j0 + tid] : 0.f;
        dc_s[tid] = ok ? to_f(dc[j0 + tid]) : 0.f;
      }
      if (!dy_resident) stage<T, TR>(dy_s, dy, r0, cc * DT, n, d);
      stage<T, TC>(x_s, x, j0, cc * DT, n, d);
      __syncthreads();
      const int dn = min(DT, d - cc * DT);
      for (int c = 0; c < dn; ++c) {
        const float g = dy_s[r][c];
#pragma unroll
        for (int k = 0; k < 16; ++k) dp[k] = fmaf(g, x_s[q + 4 * k][c], dp[k]);
      }
    }
    const float wr = ws_s[r], mr = m_s[r], lr = l_s[r];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int j = q + 4 * k;
      if (pair_ok<BAND>(i, j0 + j, n, K)) {
        const float p = expf(score<T>(wr, w_s[j], inv_tau) - mr) / lr;
        const float sg = sgnf(wr - w_s[j]);
        d_acc += rnd<T>(p) * dc_s[j];
        a_acc += p * (dp[k] + dc_s[j]) * sg;
        s_acc += p * sg;
      }
    }
  }
  d_acc = quad_sum(d_acc);
  a_acc = quad_sum(a_acc);
  s_acc = quad_sum(s_acc);
  if (q == 0 && i < n) {
    const float D = dyy + d_acc;
    D_out[(size_t)b * n + i] = D;
    dws_out[(size_t)b * n + i] = -(a_acc - D * s_acc) * inv_tau;
  }
}

// ---------------------------------------------------------------------------
// Kernels 4 and 8: column sweep.  Block = (column tile, payload tile,
// instance); thread t owns column t/4: in the score phase rows t%4 + 4k of
// each row tile, in the payload phase dx columns t%4 + 4k.
//   ds_ij = P_ij (dP_ij - D_i)
//   dx_j = sum_i P_ij dy_i,  dw_cols_j = sum_i ds_ij sgn_ij / tau,
//   dtau_cols_j = sum_i ds_ij (-s_ij) / tau
// dP needs the full payload width, so each block sums it over every
// payload tile, taking its own tile last so that dy_s then holds it.
// Banded, dx and dw_cols are the rank-order dxs and dws_col.
// ---------------------------------------------------------------------------
template <typename T, bool BAND>
__global__ void __launch_bounds__(NT)
bwd_dx_kernel(const float* __restrict__ ws, const float* __restrict__ w,
              const T* __restrict__ x, const float* __restrict__ tau,
              const float* __restrict__ m, const float* __restrict__ l,
              const T* __restrict__ dy, const T* __restrict__ dc,
              const float* __restrict__ Dv, T* __restrict__ dx,
              float* __restrict__ dwc_out, float* __restrict__ dtc_out,
              int n, int d, int K) {
  __shared__ float ws_s[TR4], m_s[TR4], l_s[TR4], D_s[TR4];
  __shared__ float w_s[TC], dc_s[TC];
  __shared__ float dy_s[TR4][DT + 1];
  __shared__ float x_s[TC][DT + 1];
  __shared__ float p_s[TR4][TC + 1];

  const int b = blockIdx.z, j0 = blockIdx.x * TC, own = blockIdx.y;
  const int tid = threadIdx.x, jl = tid / 4, q = tid % 4, j = j0 + jl;
  ws += (size_t)b * n;
  w += (size_t)b * n;
  m += (size_t)b * n;
  l += (size_t)b * n;
  dc += (size_t)b * n;
  Dv += (size_t)b * n;
  x += (size_t)b * n * d;
  dy += (size_t)b * n * d;
  const float inv_tau = 1.0f / tau[0];
  const int nd = (d + DT - 1) / DT;
  const bool x_resident = nd == 1;   // x tile staged once for d <= DT
  const int i_lo = span_lo<BAND>(j0, K), i_hi = span_hi<BAND>(j0, TC, n, K);

  if (tid < TC) {
    const bool ok = j0 + tid < n;
    w_s[tid] = ok ? w[j0 + tid] : 0.f;
    dc_s[tid] = ok ? to_f(dc[j0 + tid]) : 0.f;
  }
  if (x_resident) stage<T, TC>(x_s, x, j0, 0, n, d);

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;
  float dwc = 0.f, dtc = 0.f;

  for (int i0 = i_lo; i0 < i_hi; i0 += TR4) {
    float dp[TR4 / 4];
#pragma unroll
    for (int k = 0; k < TR4 / 4; ++k) dp[k] = 0.f;
    for (int t = 1; t <= nd; ++t) {
      const int cc = (own + t) % nd;   // own tile comes last
      __syncthreads();
      if (t == 1 && tid < TR4) {
        const bool ok = i0 + tid < n;
        ws_s[tid] = ok ? ws[i0 + tid] : 0.f;
        m_s[tid] = ok ? m[i0 + tid] : 0.f;
        l_s[tid] = ok ? fmaxf(l[i0 + tid], 1e-30f) : 1.f;
        D_s[tid] = ok ? Dv[i0 + tid] : 0.f;
      }
      stage<T, TR4>(dy_s, dy, i0, cc * DT, n, d);
      if (!x_resident) stage<T, TC>(x_s, x, j0, cc * DT, n, d);
      __syncthreads();
      const int dn = min(DT, d - cc * DT);
      for (int c = 0; c < dn; ++c) {
        const float xv = x_s[jl][c];
#pragma unroll
        for (int k = 0; k < TR4 / 4; ++k)
          dp[k] = fmaf(dy_s[q + 4 * k][c], xv, dp[k]);
      }
    }
    // Probabilities, ds and the column reductions for column jl.
    {
      const float wc = w_s[jl], dcj = dc_s[jl];
      float pw = 0.f, pt = 0.f;
#pragma unroll
      for (int k = 0; k < TR4 / 4; ++k) {
        const int i = q + 4 * k;
        bool ok = i0 + i < n;
        if constexpr (BAND) ok = pair_ok<true>(i0 + i, j, n, K);
        float p = 0.f;
        if (ok) {
          const float s = score<T>(ws_s[i], wc, inv_tau);
          p = expf(s - m_s[i]) / l_s[i];
          const float ds = p * (dp[k] + dcj - D_s[i]);
          pw += ds * sgnf(ws_s[i] - wc);
          pt += ds * (-s);
        }
        p_s[i][jl] = rnd<T>(p);
      }
      dwc += pw;
      dtc += pt;
    }
    __syncthreads();
    // dx_j += P_tile^T dy_tile for column jl, payload columns q + 4k.
    {
      float t[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) t[k] = 0.f;
      for (int i = 0; i < TR4; ++i) {
        const float p = p_s[i][jl];
#pragma unroll
        for (int k = 0; k < 16; ++k) t[k] = fmaf(p, dy_s[i][q + 4 * k], t[k]);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] += t[k];
    }
  }

  if (j < n) {
    T* dxr = dx + (size_t)b * n * d + (size_t)j * d;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = own * DT + q + 4 * k;
      if (c < d) dxr[c] = from_f<T>(acc[k]);
    }
  }
  dwc = quad_sum(dwc);
  dtc = quad_sum(dtc);
  if (own == 0 && q == 0 && j < n) {
    dwc_out[(size_t)b * n + j] = dwc * inv_tau;
    dtc_out[(size_t)b * n + j] = dtc * inv_tau;
  }
}

inline int n_dtiles(int d) { return d > 0 ? (d + DT - 1) / DT : 1; }

template <typename T, bool BAND>
int launch_fwd_fused(const void* ws, const void* w, const void* x,
                     const void* tau, void* y, void* m, void* l, int B, int n,
                     int d, int K, void* stream) {
  dim3 grid((n + TR - 1) / TR, n_dtiles(d), B);
  fwd_fused_kernel<T, BAND><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (const float*)w, (const T*)x, (const float*)tau,
      (T*)y, (float*)m, (float*)l, n, d, K);
  return (int)cudaGetLastError();
}

template <typename T, bool BAND>
int launch_colsum(const void* ws, const void* w, const void* tau,
                  const void* m, const void* l, void* c, int B, int n, int K,
                  void* stream) {
  dim3 grid((n + TC - 1) / TC, B);
  colsum_kernel<T, BAND><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (const float*)w, (const float*)tau, (const float*)m,
      (const float*)l, (float*)c, n, K);
  return (int)cudaGetLastError();
}

template <typename T, bool BAND>
int launch_bwd_dws_delta(const void* ws, const void* w, const void* x,
                         const void* tau, const void* m, const void* l,
                         const void* dy, const void* y, const void* dc,
                         void* D, void* dws, int B, int n, int d, int K,
                         void* stream) {
  dim3 grid((n + TR - 1) / TR, B);
  bwd_dws_delta_kernel<T, BAND><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (const float*)w, (const T*)x, (const float*)tau,
      (const float*)m, (const float*)l, (const T*)dy, (const T*)y,
      (const T*)dc, (float*)D, (float*)dws, n, d, K);
  return (int)cudaGetLastError();
}

template <typename T, bool BAND>
int launch_bwd_dx(const void* ws, const void* w, const void* x,
                  const void* tau, const void* m, const void* l,
                  const void* dy, const void* dc, const void* D, void* dx,
                  void* dwc, void* dtc, int B, int n, int d, int K,
                  void* stream) {
  dim3 grid((n + TC - 1) / TC, n_dtiles(d), B);
  bwd_dx_kernel<T, BAND><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (const float*)w, (const T*)x, (const float*)tau,
      (const float*)m, (const float*)l, (const T*)dy, (const T*)dc,
      (const float*)D, (T*)dx, (float*)dwc, (float*)dtc, n, d, K);
  return (int)cudaGetLastError();
}

}  // namespace

#define SS_EXPORT extern "C" __attribute__((visibility("default")))

// Dense (kernels 1-4): rows ws, columns w.  Banded (kernels 5-8): both
// axes ws, the payload in rank order, half-width K.
#define SS_INSTANTIATE(SUFFIX, T)                                             \
  SS_EXPORT int ss_fwd_fused_##SUFFIX(const void* ws, const void* w,         \
                                      const void* x, const void* tau,        \
                                      void* y, void* m, void* l, int B,      \
                                      int n, int d, void* stream) {          \
    return launch_fwd_fused<T, false>(ws, w, x, tau, y, m, l, B, n, d, 0,    \
                                      stream);                               \
  }                                                                          \
  SS_EXPORT int ss_colsum_##SUFFIX(const void* ws, const void* w,            \
                                   const void* tau, const void* m,           \
                                   const void* l, void* c, int B, int n,     \
                                   void* stream) {                           \
    return launch_colsum<T, false>(ws, w, tau, m, l, c, B, n, 0, stream);    \
  }                                                                          \
  SS_EXPORT int ss_bwd_dws_delta_##SUFFIX(                                   \
      const void* ws, const void* w, const void* x, const void* tau,         \
      const void* m, const void* l, const void* dy, const void* y,           \
      const void* dc, void* D, void* dws, int B, int n, int d,               \
      void* stream) {                                                        \
    return launch_bwd_dws_delta<T, false>(ws, w, x, tau, m, l, dy, y, dc, D, \
                                          dws, B, n, d, 0, stream);          \
  }                                                                          \
  SS_EXPORT int ss_bwd_dx_##SUFFIX(                                          \
      const void* ws, const void* w, const void* x, const void* tau,         \
      const void* m, const void* l, const void* dy, const void* dc,          \
      const void* D, void* dx, void* dwc, void* dtc, int B, int n, int d,    \
      void* stream) {                                                        \
    return launch_bwd_dx<T, false>(ws, w, x, tau, m, l, dy, dc, D, dx, dwc,  \
                                   dtc, B, n, d, 0, stream);                 \
  }                                                                          \
  SS_EXPORT int ss_fwd_band_##SUFFIX(const void* ws, const void* x,          \
                                     const void* tau, void* y, void* m,      \
                                     void* l, int B, int n, int d, int K,    \
                                     void* stream) {                         \
    return launch_fwd_fused<T, true>(ws, ws, x, tau, y, m, l, B, n, d, K,    \
                                     stream);                                \
  }                                                                          \
  SS_EXPORT int ss_colsum_band_##SUFFIX(const void* ws, const void* tau,     \
                                        const void* m, const void* l,        \
                                        void* c, int B, int n, int K,        \
                                        void* stream) {                      \
    return launch_colsum<T, true>(ws, ws, tau, m, l, c, B, n, K, stream);    \
  }                                                                          \
  SS_EXPORT int ss_bwd_band_dws_delta_##SUFFIX(                              \
      const void* ws, const void* x, const void* tau, const void* m,         \
      const void* l, const void* dy, const void* y, const void* dc, void* D, \
      void* dws, int B, int n, int d, int K, void* stream) {                 \
    return launch_bwd_dws_delta<T, true>(ws, ws, x, tau, m, l, dy, y, dc, D, \
                                         dws, B, n, d, K, stream);           \
  }                                                                          \
  SS_EXPORT int ss_bwd_band_dcol_##SUFFIX(                                   \
      const void* ws, const void* x, const void* tau, const void* m,         \
      const void* l, const void* dy, const void* dc, const void* D,          \
      void* dx, void* dwc, void* dtc, int B, int n, int d, int K,            \
      void* stream) {                                                        \
    return launch_bwd_dx<T, true>(ws, ws, x, tau, m, l, dy, dc, D, dx, dwc,  \
                                  dtc, B, n, d, K, stream);                  \
  }

SS_INSTANTIATE(f32, float)
SS_INSTANTIATE(bf16, __nv_bfloat16)

SS_EXPORT const char* ss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
