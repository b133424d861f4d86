// SoftSort-apply kernels for Hopper (sm_90a): forward and backward, over
// every (row, column) pair (the dense tier) or over a band in rank space
// (the banded tier).
//
// For each instance b of a batch, with sorted keys ws (rows) and keys w
// (columns), all float32, a payload x (N, d) in the compute type T
// (float or __nv_bfloat16) and the instance's own temperature tau[b]
// (tau is a (B,) float32 array; a block owns one instance and reads one
// element of it):
//
//   s_ij = -|ws_i - w_j| * (1 / tau[b])     (rounded through T)
//   P_ij = exp(s_ij - m_i) / l_i            (row softmax)
//
//   ss_fwd_fused      y = P x, with the row stats m, l       (kernel 1)
//   ss_colsum         colsum_j = sum_i P_ij                  (kernel 2)
//   ss_bwd_dws_delta  D_i, dws_i                             (kernel 3)
//   ss_bwd_dx         dx = P^T dy, dw_cols, dtau_cols        (kernel 4)
//
// The v1 split forward (kernels 9a and 9b: ss_v1_stats, ss_v1_apply,
// float32 only) is the baseline the kernel bench holds kernels 1 and 2
// against: one pass for m and l, one for y = P x that reads them back,
// then ss_colsum as its third pass.  9b is kernel 1's body with m and l
// given (the template flag GIVEN_ML); 9a is a row kernel of its own.
//
// The banded tier (kernels 5-8: ss_fwd_band, ss_colsum_band,
// ss_bwd_band_dws_delta, ss_bwd_band_dcol) runs the same four sweeps with
// both axes the sorted keys ws and the payload in rank order, over the
// pairs with |i - j| <= K only: P~ is exactly 0 off the band.  A tile of
// rows (or columns) [t0, t0 + len) loops over the other axis only across
// [max(0, t0 - K), min(n, t0 + len + K)) and masks the pairs outside the
// band, so the work is O(N K) instead of O(N^2).
//
// The dense kernels 1-4 are the bodies of kernels 5-8 with K = n and a
// column-key pointer wc = w (the banded calls pass wc = ws): every pair
// is then in the band, each span is all N rows or columns, and every tile
// that lies inside the matrix is interior.
//
// They replace the Pallas TPU kernels of src/repro/kernels/softsort_apply.py:
// _fwd_fused_kernel (:150), _colsum_kernel (:182), _bwd_dws_delta_kernel
// (:280), _bwd_dx_kernel (:324), and their banded forms _fwd_band_kernel
// (:517), _colsum_band_kernel (:567), _bwd_band_dws_delta_kernel (:657)
// and _bwd_band_dcol_kernel (:706), and the v1 _stats_kernel (:843) and
// _apply_kernel (:862).  On the TPU each carried its running
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
// kernels 1, 3, 4 and 9b do 2d to 4d flops of payload products beside an
// exp and a few flops of score, while they read only O(N d) bytes: at
// N = 4096, d = 50 that is thousands of flops per byte (and with the band,
// O(K d) per byte).  The products run as float32 FMAs on the CUDA cores
// (no tensor cores, so no TF32 rounding: the float32 results hold the JAX
// reference to ~1e-6).  Kernel 9a has no payload: a score, a max, an
// expf and an add per pair against O(N) bytes of keys.
//
// The banded kernels 5-8, designed for the Self-Organizing-Gaussians
// shape (N = 65536, d = 14, K = 4096), and the dense kernels 1-4, which
// run their bodies (at the main dense shape N = 4096, d = 50: DT = 64,
// 64 row or column tiles x B blocks):
// - The payload tile DT of kernels 1, 3, 4, 5, 7 and 8 is a template
//   parameter, 16, 32 or 64: the smallest that holds d, or tiles of 64
//   above that (the wrapper's band_payload_tile picks it).  Only the real
//   columns are read, 16 bytes at a time when d * sizeof(T) and the base
//   allow, else one element at a time; the tile's other columns are zero.
// - Register micro-tiles read as float4.  In both payload products a
//   thread owns 4 x 4 outputs (4 rows x 4 payload columns of y, or 4
//   columns x 4 payload columns of dx), and P is stored so that its four
//   values are one 16-byte load: each step is 2 LDS.128 for 16 FMAs, all
//   lanes of a warp on one P row (broadcast, no bank conflict).  The
//   dP = dy x^T of kernels 7 and 8 gives each thread an RA x CA block of
//   pairs on interleaved rows and columns, read in float4 steps along d
//   from tiles whose rows are padded by 4 words (odd 16-byte stride, so
//   8 neighbouring rows hit 8 bank groups); kernel 8's P tile rows are
//   padded by 16 words so that the two rows a warp writes fall in
//   different banks.  Kernel 6 gives each thread CA columns x RA rows, a
//   row's key, m and 1 / l one float4 reused across its columns.
// - Each (row tile, column tile) pair is classified once: wholly inside
//   the band and the matrix (interior, no per-pair test), or an edge
//   tile, whose pairs are tested and masked.
// - Kernel 5 knows its row maximum.  Rows and columns are the same
//   sorted keys, the diagonal pair is always in the band, and for
//   0 < 1 / tau < inf its score -|ws_i - ws_i| / tau = -0 is the largest
//   any pair can have, so m_i = -0.0f (what the twin's max gives) and one
//   sweep sums p = exp(s) with no rescale and no per-tile reduction.
//   Kernel 1 does not know it: its contract does not tie ws to w.  Its
//   caller sets exact_max, and a first sweep of scores only (no exp, no
//   payload: ~4 instructions per pair against ~85 of the main sweep)
//   takes the exact row maximum; the second sweep uses it, again with no
//   rescale.  The rounding through T is monotone, so this maximum is
//   bitwise the running maximum of the twin and of the Pallas kernel.
//   Kernel 5 takes the same first sweep for any tau outside
//   0 < 1 / tau < inf (no caller passes one): the branch is on the
//   launch flag and the block's own tau[b], uniform across the block.
// - Kernels 6-8 and 9b read the saved m and multiply by a per-row 1 / l:
//   no division per pair.  Kernel 8 steps 64 rows at a time over a tile of
//   64 columns (129 steps at the SOG shape), kernel 6 the same, kernel 7
//   64 columns at a time over a tile of 64 rows.  The next step's tiles
//   and keys are loaded into registers while the current step computes,
//   then stored into the other half of a double buffer (one or two
//   barriers per step).  For d > 64 kernels 7 and 8 sum dP over the
//   payload tiles before a step scores; kernel 7 does so in an
//   instantiation of its own (MT), whose staging registers made the
//   d <= 64 kernel spill.
// - Occupancy: __launch_bounds__ asks for 2-8 blocks per SM (MIN_BLOCKS),
//   so that more warps hide the latency of expf and of the shared loads;
//   on the card this was faster than the register counts the compiler
//   picks on its own (255 at DT = 16 in kernel 8), small spills included.
// - Kernels 5, 7 and 8 use dynamic shared memory (up to 92 KB, the limit
//   set once per instantiation).  All four write each output from one
//   block in a fixed order: the row or column sums over the threads that
//   share a row or column are added in shared memory in thread order, not
//   with atomics.
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
#include "smem_limit.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
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

// Whether the pair (row i, column j) is scored: both are real and within
// K ranks of each other (the dense calls pass K = n).
__device__ __forceinline__ bool pair_ok(int i, int j, int n, int K) {
  return i < n && j < n && abs(i - j) <= K;
}

// ---------------------------------------------------------------------------
// Kernels 5-8 (see the header): payload tiles of DT = 16, 32 or 64
// columns, register micro-tiles, interior tiles unmasked.
// ---------------------------------------------------------------------------

// Load 16 bytes of T (4 floats or 8 bfloat16) as floats.
__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// One thread's share of an R x DT tile of a row-major (n, d) matrix of T,
// held in registers as floats between a load and a store: rows
// [r0, r0 + R), columns [c0, c0 + dn) with dn <= DT; the rest of the tile
// is zero.  With vec (d a multiple of 16 bytes and the base 16-byte
// aligned) a thread moves 16-byte chunks, else single elements; only the
// real columns are read.
template <typename T, int R, int DT, int NTH>
struct TileRegs {
  static constexpr int E = R * DT / NTH;      // floats per thread
  static constexpr int V = 16 / sizeof(T);    // elements per chunk
  static_assert(E % V == 0, "a thread's share must be whole chunks");
  float v[E];

  __device__ __forceinline__ void load(const T* src, int r0, int n, int d,
                                       int c0, int dn, bool vec) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < E / V; ++k) {
        const int idx = threadIdx.x + k * NTH;
        const int r = idx / (DT / V), c = idx % (DT / V) * V;
        if (r0 + r < n && c < dn) {
          load16(src + (size_t)(r0 + r) * d + c0 + c, v + k * V);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[k * V + e] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int idx = threadIdx.x + k * NTH;
        const int r = idx / DT, c = idx % DT;
        v[k] = (r0 + r < n && c < dn)
                   ? to_f(src[(size_t)(r0 + r) * d + c0 + c]) : 0.f;
      }
    }
  }

  // Into dst (row stride ld floats, a multiple of 4), the same layout.
  __device__ __forceinline__ void store(float* dst, int ld, bool vec) const {
    if (vec) {
#pragma unroll
      for (int k = 0; k < E / V; ++k) {
        const int idx = threadIdx.x + k * NTH;
        const int r = idx / (DT / V), c = idx % (DT / V) * V;
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(dst + r * ld + c + e) = make_float4(
              v[k * V + e], v[k * V + e + 1], v[k * V + e + 2],
              v[k * V + e + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int idx = threadIdx.x + k * NTH;
        dst[idx / DT * ld + idx % DT] = v[k];
      }
    }
  }
};

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Whether every pair of rows [i0, i0 + R) x columns [j0, j0 + C) is real
// and within K ranks: such a tile needs no per-pair test.
__device__ __forceinline__ bool interior(int i0, int R, int j0, int C, int n,
                                         int K) {
  return i0 + R <= n && j0 + C <= n && j0 + C - 1 - i0 <= K &&
         i0 + R - 1 - j0 <= K;
}

template <bool V> using Edge = std::integral_constant<bool, V>;

// ---------------------------------------------------------------------------
// Kernel 5: banded forward, and kernel 1 as the band K = n with column
// keys wc = w.  Block = (TR-row tile, DT-wide payload tile, instance),
// NT = TR / 4 x DT / 4 threads; column tiles of BTC keys.
//   Score phase: thread t scores rows 4 sr + u (u < 4) of the tile
//   against columns sc + SCOLS k, sr = t % NRG, and stores P^T: the four
//   rows of a column are one float4 of p_s[column][row].
//   Product phase: thread t owns rows 4 pr + u and payload columns
//   4 pc + v, pc = t % NCG: per column j one float4 of P and one of x.
// Every payload-tile block recomputes the scores; blockIdx.y == 0 writes
// m and l.
// Kernel 9b, the v1 apply, is this body under GIVEN_ML (K = n, wc = w,
// float32): m and l are inputs.  mr comes from m, there is no first sweep
// and no sum of l, nothing is written but y, and each row of y is
// acc * (1 / max(l, 1e-30)).  A template flag, so that kernels 1 and 5
// compile as they do without it.
// ---------------------------------------------------------------------------
constexpr int BTC = 64;   // kernels 5, 7 and 9b: keys per column step

template <int DT>
struct FwdBand {
  static constexpr int TR = DT <= 16 ? 128 : 64;   // rows per block
  static constexpr int NRG = TR / 4;               // 4-row groups
  static constexpr int NCG = DT / 4;               // 4-column payload groups
  static constexpr int NT = NRG * NCG;             // 128, 128, 256
  static constexpr int SCOLS = NT / NRG;           // columns scored at once
  static constexpr int SK = BTC / SCOLS;           // per thread per tile
  static constexpr int FLOATS = BTC * TR + 2 * BTC * DT + 2 * BTC;
  // Blocks per SM the registers must allow (<= 128 registers at DT = 16
  // and 64, 170 at 32): more warps to hide the exp and load latencies.
  static constexpr int MIN_BLOCKS = DT == 64 ? 2 : (DT == 32 ? 3 : 4);
};

// m_io and l_io are written, or under GIVEN_ML read.
template <typename T, int DT, bool GIVEN_ML>
__global__ void __launch_bounds__(FwdBand<DT>::NT, FwdBand<DT>::MIN_BLOCKS)
fwd_band_kernel(const float* __restrict__ ws, const float* __restrict__ wc,
                const T* __restrict__ x, const float* __restrict__ tau,
                T* __restrict__ y, float* __restrict__ m_io,
                float* __restrict__ l_io, int n, int d, int K, int exact_max,
                int vec) {
  using C = FwdBand<DT>;
  constexpr int TR = C::TR, NT = C::NT, NRG = C::NRG, NCG = C::NCG;
  constexpr int SCOLS = C::SCOLS, SK = C::SK;
  extern __shared__ float4 smem4[];
  float* const p_s = reinterpret_cast<float*>(smem4);   // [BTC][TR]
  float* const x_s = p_s + BTC * TR;                    // [2][BTC][DT]
  float* const w_s = x_s + 2 * BTC * DT;                // [2][BTC]

  const int b = blockIdx.z, r0 = blockIdx.x * TR, c0 = blockIdx.y * DT;
  const int tid = threadIdx.x;
  const int sr = tid % NRG, sc = tid / NRG;   // score phase
  const int pc = tid % NCG, pr = tid / NCG;   // product phase
  ws += (size_t)b * n;
  wc += (size_t)b * n;
  x += (size_t)b * n * d;
  const int j_lo = max(0, r0 - K), j_hi = min(n, r0 + TR + K);
  const int dn = min(DT, d - c0);

  float wr[4], mr[4], lsum[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = r0 + 4 * sr + u;
    wr[u] = i < n ? ws[i] : 0.f;
    if constexpr (GIVEN_ML)
      mr[u] = i < n ? m_io[(size_t)b * n + i] : 0.f;
    else
      mr[u] = -0.0f;   // the diagonal's score: the row maximum for tau > 0
    lsum[u] = 0.f;
  }
  // Read after the row keys (here and in kernel 9a): so placed, ptxas
  // gives every instantiation the registers it had with one shared tau.
  const float inv_tau = 1.0f / tau[b];

  // The dense call (exact_max: its row keys are not tied to its column
  // keys) and any other tau: a first sweep of scores only, no exp and no
  // payload, for the exact row maximum.  Where every real pair is scored
  // (K >= n - 1) no pair is tested; rows >= n are masked below.
  if (!GIVEN_ML &&
      (exact_max || !(inv_tau > 0.f && inv_tau <= 3.4028235e38f))) {
    float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
    auto sweep = [&](auto edge) {
#pragma unroll 4
      for (int j = j_lo + sc; j < j_hi; j += SCOLS) {
        const float wj = wc[j];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if constexpr (decltype(edge)::value)
            if (!pair_ok(r0 + 4 * sr + u, j, n, K)) continue;
          mx[u] = fmaxf(mx[u], score<T>(wr[u], wj, inv_tau));
        }
      }
    };
    if (K >= n - 1)
      sweep(Edge<false>{});
    else
      sweep(Edge<true>{});
#pragma unroll
    for (int u = 0; u < 4; ++u) p_s[sc * TR + 4 * sr + u] = mx[u];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = p_s[4 * sr + u];
      for (int k = 1; k < SCOLS; ++k) v = fmaxf(v, p_s[k * TR + 4 * sr + u]);
      mr[u] = v;
    }
    __syncthreads();
  }

  TileRegs<T, BTC, DT, NT> xr;
  float wk = 0.f;
  auto fetch = [&](int j0) {
    xr.load(x, j0, n, d, c0, dn, vec);
    if (tid < BTC) wk = j0 + tid < n ? wc[j0 + tid] : 0.f;
  };
  auto put = [&](int buf) {
    xr.store(x_s + buf * BTC * DT, DT, vec);
    if (tid < BTC) w_s[buf * BTC + tid] = wk;
  };
  fetch(j_lo);
  put(0);
  __syncthreads();

  // P^T of one column tile into p_s, summing l; edge tiles test each pair.
  auto score_tile = [&](auto edge, int j0, const float* wcs) {
#pragma unroll 4
    for (int k = 0; k < SK; ++k) {
      const int jl = sc + SCOLS * k;
      const float wj = wcs[jl];
      float p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float s = score<T>(wr[u], wj, inv_tau);
        bool ok = true;
        if constexpr (decltype(edge)::value)
          ok = pair_ok(r0 + 4 * sr + u, j0 + jl, n, K);
        // Explicitly 0 when masked (the finite NEG_INF convention).
        const float e = ok ? expf(s - mr[u]) : 0.f;
        if constexpr (!GIVEN_ML) lsum[u] += e;
        p[u] = rnd<T>(e);
      }
      *reinterpret_cast<float4*>(p_s + jl * TR + 4 * sr) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  int cur = 0;
  for (int j0 = j_lo; j0 < j_hi; j0 += BTC, cur ^= 1) {
    const bool more = j0 + BTC < j_hi;
    if (more) fetch(j0 + BTC);
    if (interior(r0, TR, j0, BTC, n, K))
      score_tile(Edge<false>{}, j0, w_s + cur * BTC);
    else
      score_tile(Edge<true>{}, j0, w_s + cur * BTC);
    if (more) put(cur ^ 1);
    __syncthreads();

    const float* const xs = x_s + cur * BTC * DT;
#pragma unroll 4
    for (int j = 0; j < BTC; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_s + j * TR + 4 * pr);
      const float4 x4 = *reinterpret_cast<const float4*>(xs + j * DT + 4 * pc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = comp(p4, u);
        acc[u][0] = fmaf(p, x4.x, acc[u][0]);
        acc[u][1] = fmaf(p, x4.y, acc[u][1]);
        acc[u][2] = fmaf(p, x4.z, acc[u][2]);
        acc[u][3] = fmaf(p, x4.w, acc[u][3]);
      }
    }
    __syncthreads();   // before the next tile's P and x overwrite these
  }

  T* const yb = y + (size_t)b * n * d;
  if constexpr (GIVEN_ML) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = r0 + 4 * pr + u;
      if (i >= n) continue;
      const float rl = 1.0f / fmaxf(l_io[(size_t)b * n + i], 1e-30f);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + 4 * pc + v;
        if (c < d) yb[(size_t)i * d + c] = from_f<T>(acc[u][v] * rl);
      }
    }
    return;
  }

  // l of each row: the SCOLS partial sums, added in a fixed order.
#pragma unroll
  for (int u = 0; u < 4; ++u) p_s[sc * TR + 4 * sr + u] = lsum[u];
  __syncthreads();
  auto row_l = [&](int r) {
    float v = p_s[r];
    for (int k = 1; k < SCOLS; ++k) v += p_s[k * TR + r];
    return v;
  };

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = r0 + 4 * pr + u;
    if (i >= n) continue;
    const float l = fmaxf(row_l(4 * pr + u), 1e-30f);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + 4 * pc + v;
      if (c < d) yb[(size_t)i * d + c] = from_f<T>(acc[u][v] / l);
    }
  }
  if (blockIdx.y == 0 && sc == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = r0 + 4 * sr + u;
      if (i < n) {
        m_io[(size_t)b * n + i] = mr[u];
        l_io[(size_t)b * n + i] = row_l(4 * sr + u);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 8: banded column sweep, and kernel 4 as the band K = n with
// column keys wc = w.  Block = (TC-column tile, DT-wide payload tile
// `own`, instance); steps of BTRS rows over the tile's span.
//   ds_ij = P_ij (dP_ij - D_i),  dP_ij = dy_i . x_j + dc_j
//   dxs_j = sum_i P_ij dy_i,  dws_col_j = sum_i ds_ij sgn_ij / tau,
//   dtau_cols_j = sum_i ds_ij (-s_ij) / tau
//   dP and score phase: thread t owns rows ra + NRA u (u < RA) and columns
//   ca + NCA v (v < CA), ca = t % NCA; dP in float4 steps along d.
//   Product phase: thread t owns columns 4 cb + u and payload columns
//   4 pg + v, pg = t % NPG, over rows [h BTRS / RS, (h + 1) BTRS / RS) of
//   each step, h = t / (NPG TC / 4): per row one float4 of P and one of
//   dy.  At DT = 16 the RS = 2 halves of the block split the rows, and
//   their sums are added once at the end.
// A step is one stage per payload tile (one for d <= 64), its own tile
// last, so that the dy buffer of the last stage holds the own tile.
// ---------------------------------------------------------------------------
constexpr int BTRS = 64;   // kernel 8: rows per step

template <int DT>
struct DcolBand {
  static constexpr int TC = 64;                    // columns per block
  static constexpr int NPG = DT / 4;
  static constexpr int NT = DT == 64 ? 256 : 128;
  static constexpr int RS = NT / (TC / 4 * NPG);   // 2, 1, 1 row splits
  static constexpr int NCA = 16;
  static constexpr int NRA = NT / NCA;
  static constexpr int RA = BTRS / NRA;            // 8, 8, 4
  static constexpr int CA = TC / NCA;              // 4
  static constexpr int LD = DT + 4;                // dy and x tile rows
  static constexpr int PLD = TC + 16;              // P tile rows
  static constexpr int MIN_BLOCKS = DT == 64 ? 2 : 3;   // per SM
  static constexpr int floats(int nd) {
    return BTRS * PLD + 2 * BTRS * LD + 2 * 4 * BTRS +
           (nd > 1 ? 2 : 1) * TC * LD;
  }
};

template <typename T, int DT>
__global__ void __launch_bounds__(DcolBand<DT>::NT, DcolBand<DT>::MIN_BLOCKS)
bwd_band_dcol_kernel(const float* __restrict__ ws,
                     const float* __restrict__ wc, const T* __restrict__ x,
                     const float* __restrict__ tau,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const T* __restrict__ dy, const T* __restrict__ dc,
                     const float* __restrict__ Dv, T* __restrict__ dx,
                     float* __restrict__ dwc_out, float* __restrict__ dtc_out,
                     int n, int d, int K, int vec) {
  using C = DcolBand<DT>;
  constexpr int TC = C::TC, NT = C::NT, NPG = C::NPG, NCA = C::NCA;
  constexpr int NRA = C::NRA, RA = C::RA, CA = C::CA, LD = C::LD;
  constexpr int PLD = C::PLD, RS = C::RS, RH = BTRS / RS;
  const int b = blockIdx.z, j0 = blockIdx.x * TC, own = blockIdx.y;
  const int nd = DT == 64 ? gridDim.y : 1;   // d > 64 only at DT = 64
  extern __shared__ float4 smem4[];
  float* const p_s = reinterpret_cast<float*>(smem4);   // [BTRS][PLD]
  float* const dy_s = p_s + BTRS * PLD;                 // [2][BTRS][LD]
  float* const st_s = dy_s + 2 * BTRS * LD;             // [2][4][BTRS]
  float* const x_s = st_s + 2 * 4 * BTRS;               // [1 or 2][TC][LD]

  const int tid = threadIdx.x;
  const int ca = tid % NCA, ra = tid / NCA;   // dP and score phase
  const int pg = tid % NPG, cb = tid / NPG % (TC / 4);   // product phase
  const int h0 = tid / (NPG * TC / 4) * RH;
  ws += (size_t)b * n;
  wc += (size_t)b * n;
  m += (size_t)b * n;
  l += (size_t)b * n;
  dc += (size_t)b * n;
  Dv += (size_t)b * n;
  x += (size_t)b * n * d;
  dy += (size_t)b * n * d;
  const float inv_tau = 1.0f / tau[b];
  const int i_lo = max(0, j0 - K), i_hi = min(n, j0 + TC + K);
  const int nstage = (i_hi - i_lo + BTRS - 1) / BTRS * nd;

  float wj[CA], dcj[CA], pw[CA], pt[CA];
#pragma unroll
  for (int v = 0; v < CA; ++v) {
    const int j = j0 + ca + NCA * v;
    wj[v] = j < n ? wc[j] : 0.f;
    dcj[v] = j < n ? to_f(dc[j]) : 0.f;
    pw[v] = pt[v] = 0.f;
  }

  // Stage q: step q / nd, payload tile (own + 1 + q % nd) % nd.  dy (and,
  // for nd > 1, x) go to buffer q & 1; a step's row keys and stats, fetched
  // with its first stage, to buffer (q / nd) & 1.
  TileRegs<T, BTRS, DT, NT> dyr;
  TileRegs<T, TC, DT, NT> xr;
  float st[4] = {0.f, 0.f, 1.f, 0.f};
  auto tile_c0 = [&](int q) { return (own + 1 + q % nd) % nd * DT; };
  auto fetch = [&](int q) {
    const int i0 = i_lo + q / nd * BTRS, c0 = tile_c0(q);
    dyr.load(dy, i0, n, d, c0, min(DT, d - c0), vec);
    if (nd > 1) xr.load(x, j0, n, d, c0, min(DT, d - c0), vec);
    if (q % nd == 0 && tid < BTRS) {
      const int i = i0 + tid;
      const bool ok = i < n;
      st[0] = ok ? ws[i] : 0.f;
      st[1] = ok ? m[i] : 0.f;
      st[2] = ok ? 1.0f / fmaxf(l[i], 1e-30f) : 1.f;
      st[3] = ok ? Dv[i] : 0.f;
    }
  };
  auto put = [&](int q) {
    dyr.store(dy_s + (q & 1) * BTRS * LD, LD, vec);
    if (nd > 1) xr.store(x_s + (q & 1) * TC * LD, LD, vec);
    if (q % nd == 0 && tid < BTRS) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        st_s[((q / nd & 1) * 4 + f) * BTRS + tid] = st[f];
    }
  };
  if (nd == 1) {   // x stays resident
    xr.load(x, j0, n, d, 0, min(DT, d), vec);
    xr.store(x_s, LD, vec);
  }
  fetch(0);
  put(0);
  __syncthreads();

  // P, ds and the column sums of one step; edge tiles test each pair.
  float dp[RA][CA];
  auto score_step = [&](auto edge, int i0, const float* sts) {
#pragma unroll
    for (int u = 0; u < RA; ++u) {
      const int rl = ra + NRA * u;
      const float wsi = sts[rl], mi = sts[BTRS + rl];
      const float rli = sts[2 * BTRS + rl], Di = sts[3 * BTRS + rl];
#pragma unroll
      for (int v = 0; v < CA; ++v) {
        const float s = score<T>(wsi, wj[v], inv_tau);
        bool ok = true;
        if constexpr (decltype(edge)::value)
          ok = pair_ok(i0 + rl, j0 + ca + NCA * v, n, K);
        float p = 0.f;
        if (ok) {
          p = expf(s - mi) * rli;
          const float ds = p * (dp[u][v] + dcj[v] - Di);
          pw[v] += ds * sgnf(wsi - wj[v]);
          pt[v] += ds * (-s);
        }
        p_s[rl * PLD + ca + NCA * v] = rnd<T>(p);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int q = 0; q < nstage; ++q) {
    const bool more = q + 1 < nstage, last = q % nd == nd - 1;
    if (more) fetch(q + 1);
    if (q % nd == 0) {
#pragma unroll
      for (int u = 0; u < RA; ++u)
#pragma unroll
        for (int v = 0; v < CA; ++v) dp[u][v] = 0.f;
    }
    // dP += dy_tile x_tile^T.
    const float* const dys = dy_s + (q & 1) * BTRS * LD;
    const float* const xs = x_s + (nd > 1 ? (q & 1) : 0) * TC * LD;
#pragma unroll 2
    for (int c = 0; c < DT; c += 4) {
      float4 a[RA];
#pragma unroll
      for (int u = 0; u < RA; ++u)
        a[u] = *reinterpret_cast<const float4*>(dys + (ra + NRA * u) * LD + c);
#pragma unroll
      for (int v = 0; v < CA; ++v) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + (ca + NCA * v) * LD + c);
#pragma unroll
        for (int u = 0; u < RA; ++u) {
          float t = dp[u][v];
          t = fmaf(a[u].x, xv.x, t);
          t = fmaf(a[u].y, xv.y, t);
          t = fmaf(a[u].z, xv.z, t);
          t = fmaf(a[u].w, xv.w, t);
          dp[u][v] = t;
        }
      }
    }
    if (!last) {
      if (more) put(q + 1);
      __syncthreads();
      continue;
    }

    const int i0 = i_lo + q / nd * BTRS;
    const float* const sts = st_s + (q / nd & 1) * 4 * BTRS;
    if (interior(i0, BTRS, j0, TC, n, K))
      score_step(Edge<false>{}, i0, sts);
    else
      score_step(Edge<true>{}, i0, sts);
    if (more) put(q + 1);
    __syncthreads();

    // dx += P^T dy over this thread's rows of the step, own payload tile.
#pragma unroll 4
    for (int i = h0; i < h0 + RH; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_s + i * PLD + 4 * cb);
      const float4 g4 = *reinterpret_cast<const float4*>(dys + i * LD + 4 * pg);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = comp(p4, u);
        acc[u][0] = fmaf(p, g4.x, acc[u][0]);
        acc[u][1] = fmaf(p, g4.y, acc[u][1]);
        acc[u][2] = fmaf(p, g4.z, acc[u][2]);
        acc[u][3] = fmaf(p, g4.w, acc[u][3]);
      }
    }
    __syncthreads();   // before the next step's P and dy overwrite these
  }

  // The row splits' dx sums and the NRA partials of each column sum,
  // added in a fixed order.
  float* const red = p_s;                   // [2][NRA][TC]
  float* const red_dx = red + 2 * NRA * TC;  // [RS - 1][NT / RS][16]
  if (RS > 1 && h0 > 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red_dx[((h0 / RH - 1) * (NT / RS) + tid % (NT / RS)) * 16 + 4 * u +
               v] = acc[u][v];
  }
#pragma unroll
  for (int v = 0; v < CA; ++v) {
    red[ra * TC + ca + NCA * v] = pw[v];
    red[(NRA + ra) * TC + ca + NCA * v] = pt[v];
  }
  __syncthreads();

  T* const dxb = dx + (size_t)b * n * d;
  if (h0 == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 4 * cb + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float a = acc[u][v];
        for (int h = 1; h < RS; ++h)
          a += red_dx[((h - 1) * (NT / RS) + tid) * 16 + 4 * u + v];
        const int c = own * DT + 4 * pg + v;
        if (j < n && c < d) dxb[(size_t)j * d + c] = from_f<T>(a);
      }
    }
  }

  if (own != 0) return;
  for (int jl = tid; jl < TC; jl += NT) {
    const int j = j0 + jl;
    if (j >= n) continue;
    float a = 0.f, t = 0.f;
    for (int r = 0; r < NRA; ++r) {
      a += red[r * TC + jl];
      t += red[(NRA + r) * TC + jl];
    }
    dwc_out[(size_t)b * n + j] = a * inv_tau;
    dtc_out[(size_t)b * n + j] = t * inv_tau;
  }
}

// ---------------------------------------------------------------------------
// Kernel 6: banded column sums, and kernel 2 as the band K = n with
// column keys wc = w.  Replaces _colsum_band_kernel
// (src/repro/kernels/softsort_apply.py:567) and _colsum_kernel (:182).
// Block = (TC-column tile, instance); steps of BTR rows over the tile's
// span.
//   c_j = sum_i exp(s_ij - m_i) / l_i  over |i - j| <= K
// What bounds it on the card: operations.  A pair is a score, an expf and
// a multiply-add (~12 f32 instructions, one of them on the MUFU) against
// O(N) bytes of keys and row stats.  The design keeps every pair at that:
// thread t owns columns ca + NCA v (v < CA), their keys in registers, and
// rows ra + NRA u (u < RA) of each step; a row's key, m and 1 / l are one
// float4, staged once per step and reused across the thread's CA columns
// (no division per pair); interior steps test no pair.  The next step's
// row stats are loaded into registers while the current one computes,
// then stored into the other half of a double buffer: one barrier per
// step.  The NRA partial sums of a column are added in shared memory in
// thread order.
// ---------------------------------------------------------------------------
struct ColsumBand {
  static constexpr int TC = 64;            // columns per block
  static constexpr int BTR = 64;           // rows per step
  static constexpr int NT = 128;
  static constexpr int NCA = 16;
  static constexpr int NRA = NT / NCA;     // 8
  static constexpr int CA = TC / NCA;      // 4
  static constexpr int RA = BTR / NRA;     // 8
  static constexpr int MIN_BLOCKS = 8;     // per SM
};

template <typename T>
__global__ void __launch_bounds__(ColsumBand::NT, ColsumBand::MIN_BLOCKS)
colsum_band_kernel(const float* __restrict__ ws,
                   const float* __restrict__ wc,
                   const float* __restrict__ tau,
                   const float* __restrict__ m, const float* __restrict__ l,
                   float* __restrict__ c_out, int n, int K) {
  using C = ColsumBand;
  constexpr int TC = C::TC, BTR = C::BTR, NCA = C::NCA, NRA = C::NRA;
  constexpr int CA = C::CA, RA = C::RA;
  __shared__ float4 st_s[2][BTR];      // row key, m, 1 / l
  __shared__ float red_s[NRA][TC];

  const int b = blockIdx.y, j0 = blockIdx.x * TC;
  const int tid = threadIdx.x, ca = tid % NCA, ra = tid / NCA;
  ws += (size_t)b * n;
  wc += (size_t)b * n;
  m += (size_t)b * n;
  l += (size_t)b * n;
  const float inv_tau = 1.0f / tau[b];
  const int i_lo = max(0, j0 - K), i_hi = min(n, j0 + TC + K);
  const int nstep = (i_hi - i_lo + BTR - 1) / BTR;

  float wj[CA], acc[CA];
#pragma unroll
  for (int v = 0; v < CA; ++v) {
    const int j = j0 + ca + NCA * v;
    wj[v] = j < n ? wc[j] : 0.f;
    acc[v] = 0.f;
  }

  float4 st = make_float4(0.f, 0.f, 1.f, 0.f);
  auto fetch = [&](int q) {
    const int i = i_lo + q * BTR + tid;
    if (tid < BTR && i < n)
      st = make_float4(ws[i], m[i], 1.0f / fmaxf(l[i], 1e-30f), 0.f);
    else
      st = make_float4(0.f, 0.f, 1.f, 0.f);
  };
  auto put = [&](int q) {
    if (tid < BTR) st_s[q & 1][tid] = st;
  };
  fetch(0);
  put(0);
  __syncthreads();

  auto step = [&](auto edge, int i0, const float4* sts) {
#pragma unroll
    for (int u = 0; u < RA; ++u) {
      const int r = ra + NRA * u;
      const float4 sr = sts[r];
#pragma unroll
      for (int v = 0; v < CA; ++v) {
        const float s = score<T>(sr.x, wj[v], inv_tau);
        bool ok = true;
        if constexpr (decltype(edge)::value)
          ok = pair_ok(i0 + r, j0 + ca + NCA * v, n, K);
        // Explicitly 0 when masked (the finite NEG_INF convention).
        const float e = ok ? expf(s - sr.y) : 0.f;
        acc[v] = fmaf(e, sr.z, acc[v]);
      }
    }
  };

  for (int q = 0; q < nstep; ++q) {
    const bool more = q + 1 < nstep;
    if (more) fetch(q + 1);
    const int i0 = i_lo + q * BTR;
    if (interior(i0, BTR, j0, TC, n, K))
      step(Edge<false>{}, i0, st_s[q & 1]);
    else
      step(Edge<true>{}, i0, st_s[q & 1]);
    if (more) put(q + 1);
    __syncthreads();
  }

#pragma unroll
  for (int v = 0; v < CA; ++v) red_s[ra][ca + NCA * v] = acc[v];
  __syncthreads();
  if (tid < TC && j0 + tid < n) {
    float c = red_s[0][tid];
#pragma unroll
    for (int r = 1; r < NRA; ++r) c += red_s[r][tid];
    c_out[(size_t)b * n + j0 + tid] = c;
  }
}

// ---------------------------------------------------------------------------
// Kernel 7: banded row sweep, the delta and the row part of the key
// gradient, and kernel 3 as the band K = n with column keys wc = w.
// Replaces _bwd_band_dws_delta_kernel
// (src/repro/kernels/softsort_apply.py:657) and _bwd_dws_delta_kernel
// (:280).  Block = (TR-row tile, instance); steps of BTC columns over the
// tile's span, one stage per payload tile (one for d <= 64).
//   D_i   = dy_i . y_i + sum_j rnd(P_ij) dc_j
//   A_i   = sum_j P_ij dP_ij sgn_ij,  S_i = sum_j P_ij sgn_ij
//   dws_i = -(A_i - D_i S_i) / tau,    dP_ij = dc_j + dy_i . x_j
// What bounds it on the card: operations.  A pair is d FMAs of dy . x, a
// score, an expf and the three sums (~35 f32 instructions at d = 14)
// against O(N d) bytes.  The design is kernel 8's dP and score phase with
// rows and columns exchanged: thread t owns rows ra + NRA u (u < RA) and
// columns ca + NCA v (v < CA), ca = t % NCA.  dP is read in float4 steps
// along d, only as far as the tile's real columns reach: CA x values are
// held while RA dy rows stream past, RA + CA LDS.128 per 4 RA CA FMAs.
// For d <= 64 the dy tile of the block's rows stays resident; above, each
// step sums dP over the payload tiles before it scores.  The thread's row
// keys, m and 1 / l stay in registers (no division per pair), and
// interior tiles test no pair.  Column keys, dc and x of the next stage
// are loaded into registers while the current one computes, then stored
// into the other half of a double buffer: one barrier per stage.  The NCA
// partial sums of a row are added in shared memory in thread order.
// ---------------------------------------------------------------------------
template <int DT>
struct DwsBand {
  static constexpr int TR = 64;                    // rows per block
  static constexpr int NT = DT == 64 ? 256 : 128;
  static constexpr int NCA = 16;
  static constexpr int NRA = NT / NCA;             // 8, 8, 16
  static constexpr int RA = TR / NRA;              // 8, 8, 4
  static constexpr int CA = BTC / NCA;             // 4
  static constexpr int LD = DT + 4;                // dy and x tile rows
  static constexpr int RLD = NCA + 1;              // row-sum rows
  static constexpr int MIN_BLOCKS = DT == 64 ? 2 : 3;   // per SM
  static_assert(3 * TR * RLD <= (TR + 2 * BTC) * LD,
                "the row sums fit over the dy and x tiles");
  static constexpr int floats(int nd) {
    return (nd > 1 ? 2 : 1) * TR * LD + 2 * BTC * LD + 4 * BTC + TR;
  }
};

// MT: the payload spans more than one tile (d > 64, at DT = 64 only).  A
// separate instantiation keeps the other kernel free of the per-stage dy
// registers: at DT = 64 they made it spill.
template <typename T, int DT, bool MT>
__global__ void __launch_bounds__(DwsBand<DT>::NT, DwsBand<DT>::MIN_BLOCKS)
bwd_band_dws_delta_kernel(const float* __restrict__ ws,
                          const float* __restrict__ wc,
                          const T* __restrict__ x,
                          const float* __restrict__ tau,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const T* __restrict__ dy, const T* __restrict__ y,
                          const T* __restrict__ dc,
                          float* __restrict__ D_out,
                          float* __restrict__ dws_out, int n, int d, int K,
                          int vec) {
  using C = DwsBand<DT>;
  constexpr int TR = C::TR, NT = C::NT, NCA = C::NCA, NRA = C::NRA;
  constexpr int RA = C::RA, CA = C::CA, LD = C::LD, RLD = C::RLD;
  const int b = blockIdx.y, r0 = blockIdx.x * TR;
  const int nd = MT ? (d + DT - 1) / DT : 1;
  extern __shared__ float4 smem4[];
  float* const dy_s = reinterpret_cast<float*>(smem4);   // [1 or 2][TR][LD]
  float* const x_s = dy_s + (nd > 1 ? 2 : 1) * TR * LD;  // [2][BTC][LD]
  float* const cs_s = x_s + 2 * BTC * LD;                // [2][key, dc][BTC]
  float* const dyy_s = cs_s + 4 * BTC;                   // [TR]

  const int tid = threadIdx.x, ca = tid % NCA, ra = tid / NCA;
  ws += (size_t)b * n;
  wc += (size_t)b * n;
  m += (size_t)b * n;
  l += (size_t)b * n;
  dc += (size_t)b * n;
  x += (size_t)b * n * d;
  dy += (size_t)b * n * d;
  y += (size_t)b * n * d;
  const float inv_tau = 1.0f / tau[b];
  const int j_lo = max(0, r0 - K), j_hi = min(n, r0 + TR + K);
  const int nstage = (j_hi - j_lo + BTC - 1) / BTC * nd;

  float wr[RA], mr[RA], rl[RA], dacc[RA], aacc[RA], sacc[RA];
#pragma unroll
  for (int u = 0; u < RA; ++u) {
    const int i = r0 + ra + NRA * u;
    const bool ok = i < n;
    wr[u] = ok ? ws[i] : 0.f;
    mr[u] = ok ? m[i] : 0.f;
    rl[u] = ok ? 1.0f / fmaxf(l[i], 1e-30f) : 1.f;
    dacc[u] = aacc[u] = sacc[u] = 0.f;
  }

  // D_i starts at dy_i . y_i (the delta trick: y was saved); G threads
  // per row, added in a fixed order.
  {
    constexpr int G = NT / TR;
    const int r = tid / G, h = tid % G, i = r0 + r;
    float t = 0.f;
    if (i < n) {
      const T* const dyr = dy + (size_t)i * d;
      const T* const yr = y + (size_t)i * d;
      for (int c = h; c < d; c += G) t = fmaf(to_f(dyr[c]), to_f(yr[c]), t);
    }
#pragma unroll
    for (int o = 1; o < G; o *= 2) t += __shfl_xor_sync(FULL, t, o);
    if (h == 0) dyy_s[r] = t;
  }

  // Stage q: column step q / nd, payload tile q % nd.  x (and, for
  // nd > 1, dy) go to buffer q & 1; a step's column keys and dc, fetched
  // with its first stage, to buffer (q / nd) & 1.
  TileRegs<T, TR, DT, NT> dyr;
  TileRegs<T, BTC, DT, NT> xr;
  float ck = 0.f, cdc = 0.f;
  auto fetch = [&](int q) {
    const int j0 = j_lo + q / nd * BTC, c0 = q % nd * DT;
    xr.load(x, j0, n, d, c0, min(DT, d - c0), vec);
    if (nd > 1) dyr.load(dy, r0, n, d, c0, min(DT, d - c0), vec);
    if (q % nd == 0 && tid < BTC) {
      const int j = j0 + tid;
      ck = j < n ? wc[j] : 0.f;
      cdc = j < n ? to_f(dc[j]) : 0.f;
    }
  };
  auto put = [&](int q) {
    xr.store(x_s + (q & 1) * BTC * LD, LD, vec);
    if (nd > 1) dyr.store(dy_s + (q & 1) * TR * LD, LD, vec);
    if (q % nd == 0 && tid < BTC) {
      float* const cs = cs_s + (q / nd & 1) * 2 * BTC;
      cs[tid] = ck;
      cs[BTC + tid] = cdc;
    }
  };
  if (nd == 1) {   // dy stays resident
    dyr.load(dy, r0, n, d, 0, min(DT, d), vec);
    dyr.store(dy_s, LD, vec);
  }
  fetch(0);
  put(0);
  __syncthreads();

  // P and the three row sums of one step; edge tiles test each pair.
  float dp[RA][CA];
  auto score_step = [&](auto edge, int j0, const float* cs) {
    float wj[CA], dcv[CA];
#pragma unroll
    for (int v = 0; v < CA; ++v) {
      wj[v] = cs[ca + NCA * v];
      dcv[v] = cs[BTC + ca + NCA * v];
    }
#pragma unroll
    for (int u = 0; u < RA; ++u) {
#pragma unroll
      for (int v = 0; v < CA; ++v) {
        const float s = score<T>(wr[u], wj[v], inv_tau);
        bool ok = true;
        if constexpr (decltype(edge)::value)
          ok = pair_ok(r0 + ra + NRA * u, j0 + ca + NCA * v, n, K);
        // Explicitly 0 when masked (the finite NEG_INF convention).
        const float p = ok ? expf(s - mr[u]) * rl[u] : 0.f;
        // p sgn(ws_i - wc_j): p >= 0 takes the sign, tied keys give 0.
        const float df = wr[u] - wj[v];
        const float ps = df != 0.f ? copysignf(p, df) : 0.f;
        dacc[u] = fmaf(rnd<T>(p), dcv[v], dacc[u]);
        aacc[u] = fmaf(ps, dp[u][v], aacc[u]);
        sacc[u] += ps;
      }
    }
  };

  for (int q = 0; q < nstage; ++q) {
    const bool more = q + 1 < nstage, last = q % nd == nd - 1;
    if (more) fetch(q + 1);
    if (q % nd == 0) {   // dP_ij starts at dc_j
      const float* const dcs = cs_s + (q / nd & 1) * 2 * BTC + BTC;
#pragma unroll
      for (int u = 0; u < RA; ++u)
#pragma unroll
        for (int v = 0; v < CA; ++v) dp[u][v] = dcs[ca + NCA * v];
    }
    // dP += dy_tile x_tile^T over the real columns, rounded up to 4 (the
    // tiles are zero beyond d).
    const float* const dys = dy_s + (nd > 1 ? (q & 1) : 0) * TR * LD;
    const float* const xs = x_s + (q & 1) * BTC * LD;
    const int cn = min(DT, (d - q % nd * DT + 3) & ~3);
#pragma unroll
    for (int c = 0; c < DT; c += 4) {
      if (c >= cn) break;
      float4 xv[CA];
#pragma unroll
      for (int v = 0; v < CA; ++v)
        xv[v] = *reinterpret_cast<const float4*>(xs + (ca + NCA * v) * LD + c);
#pragma unroll
      for (int u = 0; u < RA; ++u) {
        const float4 a =
            *reinterpret_cast<const float4*>(dys + (ra + NRA * u) * LD + c);
#pragma unroll
        for (int v = 0; v < CA; ++v) {
          float t = dp[u][v];
          t = fmaf(a.x, xv[v].x, t);
          t = fmaf(a.y, xv[v].y, t);
          t = fmaf(a.z, xv[v].z, t);
          t = fmaf(a.w, xv[v].w, t);
          dp[u][v] = t;
        }
      }
    }
    if (last) {
      const int j0 = j_lo + q / nd * BTC;
      const float* const cs = cs_s + (q / nd & 1) * 2 * BTC;
      if (interior(r0, TR, j0, BTC, n, K))
        score_step(Edge<false>{}, j0, cs);
      else
        score_step(Edge<true>{}, j0, cs);
    }
    if (more) put(q + 1);
    __syncthreads();   // before the next stage's tiles overwrite these
  }

  // The NCA partials of each row, added in thread order.
  float* const red = dy_s;   // [D, A, S][TR][RLD], over the dy and x tiles
#pragma unroll
  for (int u = 0; u < RA; ++u) {
    const int r = ra + NRA * u;
    red[(0 * TR + r) * RLD + ca] = dacc[u];
    red[(1 * TR + r) * RLD + ca] = aacc[u];
    red[(2 * TR + r) * RLD + ca] = sacc[u];
  }
  __syncthreads();
  if (tid < TR && r0 + tid < n) {
    float sd = 0.f, sa = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < NCA; ++c) {
      sd += red[(0 * TR + tid) * RLD + c];
      sa += red[(1 * TR + tid) * RLD + c];
      ss += red[(2 * TR + tid) * RLD + c];
    }
    const float D = dyy_s[tid] + sd;
    D_out[(size_t)b * n + r0 + tid] = D;
    dws_out[(size_t)b * n + r0 + tid] = -(sa - D * ss) * inv_tau;
  }
}

// ---------------------------------------------------------------------------
// Kernel 9a: the v1 stats pass, float32 only, as the TPU kernel is.
// Replaces _stats_kernel (src/repro/kernels/softsort_apply.py:843).
//   m_i = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
// Kernel 9b (the apply pass, y = exp(s - m) x / max(l, 1e-30), replacing
// _apply_kernel, :862) is kernel 1's body under GIVEN_ML, and ss_colsum
// is the third pass: the v1 design the kernel bench measures keeps three
// launches, scores computed in each, and m and l in device memory between
// them.
// What bounds 9a on the card: operations.  A pair is a score and a max,
// then a score, an expf and an add (~16 f32 instructions, one on the
// MUFU) against O(N) bytes of keys.  The design is kernel 1's first
// sweep, twice, with no payload: block = (TR-row tile, instance), thread
// t holds the keys of rows 4 sr + u (u < 4), sr = t % NRG, in registers
// and walks columns sc, sc + SCOLS, ... read through the read-only cache
// (the SCOLS columns of a step are adjacent; a warp reads at most two).
// Sweep 1 takes the exact row maximum with fmaxf: the rounding is
// monotone, so it is bitwise the running maximum of the twin and of the
// Pallas kernel.  Sweep 2 sums exp(s - m) with no rescale.  The SCOLS
// partials of a row meet in shared memory and are added in lane order:
// no shuffles, no atomics, and no barrier inside a sweep.
// ---------------------------------------------------------------------------
// Kernel 9a's tile: 32 rows x 256 threads, so 32 column lanes.  On an
// H100 at (B, N) = (8, 4096) eight tiles (32-128 rows, 128-1024 threads)
// ran within 16% of one another, those with 32 lanes the fastest
// (PERF.md, section 6); 32 rows keep more blocks busy at small N.
constexpr int V1_TR = 32;    // kernel 9a: rows per block
constexpr int V1_NT = 256;   // kernel 9a: threads per block

__global__ void __launch_bounds__(V1_NT)
v1_stats_kernel(const float* __restrict__ ws, const float* __restrict__ w,
                const float* __restrict__ tau, float* __restrict__ m_out,
                float* __restrict__ l_out, int n) {
  constexpr int TR = V1_TR, NT = V1_NT;
  constexpr int NRG = TR / 4;        // 4-row groups
  constexpr int SCOLS = NT / NRG;    // column lanes
  static_assert(NT % NRG == 0 && TR <= NT, "a thread per row reduces");
  __shared__ float4 red_s[SCOLS][NRG];   // a lane's partials, 4 rows each
  __shared__ float4 m_s[NRG];            // the row maxima

  const int b = blockIdx.y, r0 = blockIdx.x * TR;
  const int tid = threadIdx.x, sr = tid % NRG, sc = tid / NRG;
  ws += (size_t)b * n;
  w += (size_t)b * n;

  float wr[4], acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = r0 + 4 * sr + u;
    wr[u] = i < n ? ws[i] : 0.f;   // rows >= n are computed, not written
    acc[u] = NEG_INF;
  }
  const float inv_tau = 1.0f / tau[b];   // after the row keys, as kernel 1

  // The partials of row tid (< TR), reduced over the lanes in order.
  auto reduce = [&](auto op) {
    red_s[sc][sr] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    float v = 0.f;
    if (tid < TR) {
      v = reinterpret_cast<const float*>(red_s[0])[tid];
      for (int k = 1; k < SCOLS; ++k)
        v = op(v, reinterpret_cast<const float*>(red_s[k])[tid]);
    }
    return v;
  };

#pragma unroll 4
  for (int j = sc; j < n; j += SCOLS) {
    const float wj = __ldg(w + j);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc[u] = fmaxf(acc[u], score<float>(wr[u], wj, inv_tau));
  }
  const float m = reduce([](float a, float c) { return fmaxf(a, c); });
  if (tid < TR) reinterpret_cast<float*>(m_s)[tid] = m;
  __syncthreads();   // m_s written; red_s read

  const float4 m4 = m_s[sr];
  const float mr[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = 0.f;
#pragma unroll 4
  for (int j = sc; j < n; j += SCOLS) {
    const float wj = __ldg(w + j);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc[u] += expf(score<float>(wr[u], wj, inv_tau) - mr[u]);
  }
  const float l = reduce([](float a, float c) { return a + c; });
  if (tid < TR && r0 + tid < n) {
    m_out[(size_t)b * n + r0 + tid] = m;
    l_out[(size_t)b * n + r0 + tid] = l;
  }
}

// 16-byte staging: d a whole number of 16-byte chunks, bases aligned.
template <typename T>
int vec_ok(int d, const void* a, const void* b) {
  return d % (16 / (int)sizeof(T)) == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

template <typename T, int DT, bool GIVEN_ML>
int launch_fwd_band(const void* ws, const void* wc, const void* x,
                    const void* tau, void* y, void* m, void* l, int B, int n,
                    int d, int K, int exact_max, cudaStream_t stream) {
  using C = FwdBand<DT>;
  constexpr int bytes = C::FLOATS * (int)sizeof(float);
  static bool limit_set[MAX_DEVICES] = {};   // per instantiation
  if (const int e = raise_smem_limit(limit_set,
                                     fwd_band_kernel<T, DT, GIVEN_ML>, bytes))
    return e;
  dim3 grid((n + C::TR - 1) / C::TR, d > DT ? (d + DT - 1) / DT : 1, B);
  fwd_band_kernel<T, DT, GIVEN_ML><<<grid, C::NT, bytes, stream>>>(
      (const float*)ws, (const float*)wc, (const T*)x, (const float*)tau,
      (T*)y, (float*)m, (float*)l, n, d, K, exact_max, vec_ok<T>(d, x, x));
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch_band_dcol(const void* ws, const void* wc, const void* x,
                     const void* tau, const void* m, const void* l,
                     const void* dy,
                     const void* dc, const void* D, void* dx, void* dwc,
                     void* dtc, int B, int n, int d, int K,
                     cudaStream_t stream) {
  using C = DcolBand<DT>;
  const int nd = d > DT ? (d + DT - 1) / DT : 1;
  const int bytes = C::floats(nd) * (int)sizeof(float);
  static bool limit_set[MAX_DEVICES] = {};   // the larger of two sizes
  if (const int e = raise_smem_limit(limit_set, bwd_band_dcol_kernel<T, DT>,
                                     C::floats(2) * (int)sizeof(float)))
    return e;
  dim3 grid((n + C::TC - 1) / C::TC, nd, B);
  bwd_band_dcol_kernel<T, DT><<<grid, C::NT, bytes, stream>>>(
      (const float*)ws, (const float*)wc, (const T*)x, (const float*)tau,
      (const float*)m,
      (const float*)l, (const T*)dy, (const T*)dc, (const float*)D, (T*)dx,
      (float*)dwc, (float*)dtc, n, d, K, vec_ok<T>(d, x, dy));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_colsum_band(const void* ws, const void* wc, const void* tau,
                       const void* m, const void* l, void* c, int B, int n,
                       int K, void* stream) {
  using C = ColsumBand;
  dim3 grid((n + C::TC - 1) / C::TC, B);
  colsum_band_kernel<T><<<grid, C::NT, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (const float*)wc, (const float*)tau,
      (const float*)m, (const float*)l, (float*)c, n, K);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch_band_dws(const void* ws, const void* wc, const void* x,
                    const void* tau, const void* m, const void* l,
                    const void* dy, const void* y, const void* dc, void* D,
                    void* dws, int B, int n, int d, int K,
                    cudaStream_t stream) {
  using C = DwsBand<DT>;
  const int nd = DT == 64 && d > DT ? (d + DT - 1) / DT : 1;
  const int bytes = C::floats(nd) * (int)sizeof(float);
  static bool limit_set[MAX_DEVICES] = {};   // each instantiation's size
  if (const int e = raise_smem_limit(limit_set,
                                     bwd_band_dws_delta_kernel<T, DT, false>,
                                     C::floats(1) * (int)sizeof(float)))
    return e;
  if constexpr (DT == 64) {
    static bool limit_set_mt[MAX_DEVICES] = {};
    if (const int e = raise_smem_limit(
            limit_set_mt, bwd_band_dws_delta_kernel<T, DT, true>,
            C::floats(2) * (int)sizeof(float)))
      return e;
  }
  dim3 grid((n + C::TR - 1) / C::TR, B);
  auto kernel = bwd_band_dws_delta_kernel<T, DT, false>;
  if constexpr (DT == 64)
    if (nd > 1) kernel = bwd_band_dws_delta_kernel<T, DT, true>;
  kernel<<<grid, C::NT, bytes, stream>>>(
      (const float*)ws, (const float*)wc, (const T*)x, (const float*)tau,
      (const float*)m, (const float*)l, (const T*)dy, (const T*)y,
      (const T*)dc, (float*)D, (float*)dws, n, d, K, vec_ok<T>(d, x, dy));
  return (int)cudaGetLastError();
}

// Kernels 5, 7 and 8 (and 1, 3 and 4 through their bodies) at the
// payload tile dt the caller chose (the wrapper's band_payload_tile): 16,
// 32 or 64, and 64 if it does not hold d, as kernels 7 and 8 loop over
// payload tiles only at DT = 64.
inline bool dt_ok(int dt, int d) {
  return dt == 64 || ((dt == 16 || dt == 32) && d <= dt);
}

template <typename T, bool GIVEN_ML = false>
int launch_fwd_band_dt(const void* ws, const void* wc, const void* x,
                       const void* tau, void* y, void* m, void* l, int B,
                       int n, int d, int K, int dt, int exact_max,
                       void* stream) {
  if (!dt_ok(dt, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dt == 16)
    return launch_fwd_band<T, 16, GIVEN_ML>(ws, wc, x, tau, y, m, l, B, n, d,
                                            K, exact_max, st);
  if (dt == 32)
    return launch_fwd_band<T, 32, GIVEN_ML>(ws, wc, x, tau, y, m, l, B, n, d,
                                            K, exact_max, st);
  return launch_fwd_band<T, 64, GIVEN_ML>(ws, wc, x, tau, y, m, l, B, n, d,
                                          K, exact_max, st);
}

template <typename T>
int launch_band_dcol_dt(const void* ws, const void* wc, const void* x,
                        const void* tau, const void* m, const void* l,
                        const void* dy, const void* dc, const void* D,
                        void* dx, void* dwc, void* dtc, int B, int n, int d,
                        int K, int dt, void* stream) {
  if (!dt_ok(dt, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dt == 16)
    return launch_band_dcol<T, 16>(ws, wc, x, tau, m, l, dy, dc, D, dx, dwc,
                                   dtc, B, n, d, K, st);
  if (dt == 32)
    return launch_band_dcol<T, 32>(ws, wc, x, tau, m, l, dy, dc, D, dx, dwc,
                                   dtc, B, n, d, K, st);
  return launch_band_dcol<T, 64>(ws, wc, x, tau, m, l, dy, dc, D, dx, dwc,
                                 dtc, B, n, d, K, st);
}

template <typename T>
int launch_band_dws_dt(const void* ws, const void* wc, const void* x,
                       const void* tau, const void* m, const void* l,
                       const void* dy, const void* y, const void* dc, void* D,
                       void* dws, int B, int n, int d, int K, int dt,
                       void* stream) {
  if (!dt_ok(dt, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dt == 16)
    return launch_band_dws<T, 16>(ws, wc, x, tau, m, l, dy, y, dc, D, dws, B,
                                  n, d, K, st);
  if (dt == 32)
    return launch_band_dws<T, 32>(ws, wc, x, tau, m, l, dy, y, dc, D, dws, B,
                                  n, d, K, st);
  return launch_band_dws<T, 64>(ws, wc, x, tau, m, l, dy, y, dc, D, dws, B,
                                n, d, K, st);
}

int launch_v1_stats(const void* ws, const void* w, const void* tau, void* m,
                    void* l, int B, int n, void* stream) {
  dim3 grid((n + V1_TR - 1) / V1_TR, B);
  v1_stats_kernel<<<grid, V1_NT, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (const float*)w, (const float*)tau, (float*)m,
      (float*)l, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define SS_EXPORT extern "C" __attribute__((visibility("default")))

// Dense (kernels 1-4): rows ws, columns w.  Banded (kernels 5-8): both
// axes ws, the payload in rank order, half-width K.  Kernels 1-4 run the
// bodies of 5-8 with column keys w; their caller passes K = n and kernel 1
// the flag exact_max (its row maximum is not known beforehand).  Kernels
// 1, 3, 4, 5, 7 and 8 take their payload tile dt (16, 32 or 64, see
// dt_ok).
#define SS_INSTANTIATE(SUFFIX, T)                                            \
  SS_EXPORT int ss_fwd_fused_##SUFFIX(                                       \
      const void* ws, const void* w, const void* x, const void* tau,         \
      void* y, void* m, void* l, int B, int n, int d, int K, int dt,         \
      int exact_max, void* stream) {                                         \
    return launch_fwd_band_dt<T>(ws, w, x, tau, y, m, l, B, n, d, K, dt,     \
                                 exact_max, stream);                         \
  }                                                                          \
  SS_EXPORT int ss_colsum_##SUFFIX(const void* ws, const void* w,            \
                                   const void* tau, const void* m,           \
                                   const void* l, void* c, int B, int n,     \
                                   int K, void* stream) {                    \
    return launch_colsum_band<T>(ws, w, tau, m, l, c, B, n, K, stream);      \
  }                                                                          \
  SS_EXPORT int ss_bwd_dws_delta_##SUFFIX(                                   \
      const void* ws, const void* w, const void* x, const void* tau,         \
      const void* m, const void* l, const void* dy, const void* y,           \
      const void* dc, void* D, void* dws, int B, int n, int d, int K,        \
      int dt, void* stream) {                                                \
    return launch_band_dws_dt<T>(ws, w, x, tau, m, l, dy, y, dc, D, dws, B,  \
                                 n, d, K, dt, stream);                       \
  }                                                                          \
  SS_EXPORT int ss_bwd_dx_##SUFFIX(                                          \
      const void* ws, const void* w, const void* x, const void* tau,         \
      const void* m, const void* l, const void* dy, const void* dc,          \
      const void* D, void* dx, void* dwc, void* dtc, int B, int n, int d,    \
      int K, int dt, void* stream) {                                         \
    return launch_band_dcol_dt<T>(ws, w, x, tau, m, l, dy, dc, D, dx, dwc,   \
                                  dtc, B, n, d, K, dt, stream);              \
  }                                                                          \
  SS_EXPORT int ss_fwd_band_##SUFFIX(const void* ws, const void* x,          \
                                     const void* tau, void* y, void* m,      \
                                     void* l, int B, int n, int d, int K,    \
                                     int dt, void* stream) {                 \
    return launch_fwd_band_dt<T>(ws, ws, x, tau, y, m, l, B, n, d, K, dt, 0, \
                                 stream);                                    \
  }                                                                          \
  SS_EXPORT int ss_colsum_band_##SUFFIX(const void* ws, const void* tau,     \
                                        const void* m, const void* l,        \
                                        void* c, int B, int n, int K,        \
                                        void* stream) {                      \
    return launch_colsum_band<T>(ws, ws, tau, m, l, c, B, n, K, stream);     \
  }                                                                          \
  SS_EXPORT int ss_bwd_band_dws_delta_##SUFFIX(                              \
      const void* ws, const void* x, const void* tau, const void* m,         \
      const void* l, const void* dy, const void* y, const void* dc, void* D, \
      void* dws, int B, int n, int d, int K, int dt, void* stream) {         \
    return launch_band_dws_dt<T>(ws, ws, x, tau, m, l, dy, y, dc, D, dws, B, \
                                 n, d, K, dt, stream);                       \
  }                                                                          \
  SS_EXPORT int ss_bwd_band_dcol_##SUFFIX(                                   \
      const void* ws, const void* x, const void* tau, const void* m,         \
      const void* l, const void* dy, const void* dc, const void* D,          \
      void* dx, void* dwc, void* dtc, int B, int n, int d, int K, int dt,    \
      void* stream) {                                                        \
    return launch_band_dcol_dt<T>(ws, ws, x, tau, m, l, dy, dc, D, dx, dwc,  \
                                  dtc, B, n, d, K, dt, stream);              \
  }

SS_INSTANTIATE(f32, float)
SS_INSTANTIATE(bf16, __nv_bfloat16)

// The v1 split forward (kernels 9a, 9b), float32 only; its third pass is
// ss_colsum_f32.  9b runs kernel 1's body with m and l given: its caller
// passes K = n and the payload tile dt, as ss_fwd_fused's does.
SS_EXPORT int ss_v1_stats_f32(const void* ws, const void* w, const void* tau,
                              void* m, void* l, int B, int n, void* stream) {
  return launch_v1_stats(ws, w, tau, m, l, B, n, stream);
}

SS_EXPORT int ss_v1_apply_f32(const void* ws, const void* w, const void* x,
                              const void* tau, const void* m, const void* l,
                              void* y, int B, int n, int d, int K, int dt,
                              void* stream) {
  return launch_fwd_band_dt<float, true>(ws, w, x, tau, y,
                                         const_cast<void*>(m),
                                         const_cast<void*>(l), B, n, d, K, dt,
                                         0, stream);
}

SS_EXPORT const char* ss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
