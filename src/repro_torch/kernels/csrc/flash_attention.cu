// Flash-attention forward for Hopper (sm_90a), float32, with causal,
// q_offset and ragged-length masks and grouped-query heads (GQA): one
// pass over the keys with an online softmax, plus a split-K combine.
//
// Operands are read where they lie, through strides: q is (B, H, Tq, Dh)
// and k, v are (B, Hkv, Tk, Dh), each with any batch, head and row stride
// and a unit stride along Dh, so the model layout (B, T, heads, Dh) is read
// as it is, with no copy.  Query head h of batch b reads kv head h / rep,
// rep = H / Hkv.  With s_ij = (q_i . k_j) * scale, scored where
// j < tk && (!causal || j <= i + q_offset):
//
//   fa_fwd      m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i),
//               o_i = sum_j exp(s_ij - m_i) / max(l_i, 1e-30) v_j
//   fa_combine  (o, m, l) from the partials of the key splits of fa_fwd
//
// With 2 to 8 key splits (MAX_CLUSTER) fa_fwd merges them itself: the
// splits of one row tile are one thread block cluster, and after the key
// loop each block hands its partial to the others through distributed
// shared memory (fa_fwd_kernel's MERGE epilogue, below).  fa_combine
// stays for more splits, and for partials merged across ranks.
//
// They replace the Pallas TPU kernels of src/repro/kernels/
// flash_attention.py: _stats_kernel (:42), which gave m and l, and
// _apply_kernel (:62), which gave o from them, both driven by
// flash_attention_fwd_pallas (:80).  The TPU ran them as two passes
// because its grid is sequential; here one block owns one query-row tile
// of one kv plane and loops over its key tiles with a running m, l and an
// o accumulator rescaled by exp(m_old - m_new), so q.k and P.v run once
// per pair (4 Dh + 6 flops) and m and l never leave the chip mid-way.
//
// GQA packing: the rep query heads of kv plane g are one (rep * tq, Dh)
// block of packed rows; packed row p is query head g * rep + p / tq at
// position p % tq, and that position sets its causal mask.  A block's
// rows come from all the heads that share its K and V tiles, so K and V
// are read once per kv plane, not once per query head.
//
// What bounds it on the card, and what the design does about it:
// - At prefill (tq = tk = 4096, Dh = 128) operations: 512 FMA-flops of
//   products per causal pair against O(T Dh) bytes.  The products run as
//   float32 FMAs on the CUDA cores (no tensor cores, no TF32: the port
//   holds the oracle to 2e-5), fed from shared memory through register
//   micro-tiles: a thread owns 4 x 4 scores (8 LDS.128 for 64 FMAs) and
//   a 4 x 8 block of the 64 x Dh output (12 LDS.128 for 128 FMAs).  Rows
//   are padded by 4 words, so the 16-byte reads of 8 neighbouring keys
//   fall in 8 different bank groups.  K and V tiles arrive by 16-byte
//   cp.async into two stages, tile j + 1 loading while tile j computes;
//   q stays resident.  The key loop of a tile ends at its last row's
//   diagonal, and the heaviest row tiles launch first, so the triangle's
//   tail is filled with light tiles.
// - At decode (tq = 1) bytes: every key and value row is read for a few
//   query rows.  A 16-row tile holds the rep packed rows, and the keys are
//   split into ranges, one block each, so that some 2 blocks per SM
//   stream K and V; the splits' partials (o, m, l) are merged, weighting
//   each by exp(m_s - m): in the forward's cluster epilogue for up to 8
//   splits (no second launch, no partials in device memory), else by
//   fa_combine.  A split of one key tile has no next
//   tile to prefetch, so it keeps one K/V stage (81 KB, two blocks per
//   SM), and the warps whose 16-row share is all padding skip the
//   products.
//
// Masked pairs score the finite NEG_INF = -1e30 and get P = 0 explicitly,
// so a tile (or a split) with no scored pair adds exactly 0, and a split
// carries m = NEG_INF, l = 0, o = 0 into the combine.  A row with no
// scored key at all (causal with i + q_offset < 0, only for a negative
// q_offset) scores every key 0: the oracle's mean of the value rows.
//
// Each exported function launches on the given stream and returns
// cudaGetLastError() as an int (or the error of setting the kernel's
// shared-memory limit).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (no --use_fast_math: the parity needs expf, not __expf).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include "smem_limit.cuh"

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;        // threads per block
constexpr int KT = 64;         // keys per tile
constexpr int TPR = 16;        // threads sharing a row group
constexpr int PLD = KT + 16;   // row stride of the P tile, in floats
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 8; // the portable cluster size: splits merged in
                               // the forward's epilogue

struct Geom {
  long long sqb, sqh, sqt;   // q strides: batch, head, row (elements)
  long long skb, skh, skt;   // k strides
  long long svb, svh, svt;   // v strides
  int hq, hkv, rep, tq, tk, dh, causal, q_offset;
  int bhkv, row_tiles, tiles_per_split, vec16;
  float scale;
};

// Sum (max) over the 16 lanes of a half-warp, which share a row group.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Asynchronous copies global -> shared; a copy with valid == false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying NROWS rows into dst (row stride LD floats), columns
// [0, dh rounded up to 4); row(i) is the address of row i, or nullptr for
// a row outside the operand (zero-filled), as are columns >= dh.  `any` is
// a valid address for the zero-filling copies.  With vec16 (dh, the
// strides and the base all multiples of 4 floats) the copies are 16 bytes.
template <int NROWS, int LD, class RowPtr>
__device__ __forceinline__ void stage(float* dst, RowPtr row, int dh,
                                      int vec16, const float* any) {
  const int dh4 = (dh + 3) & ~3;
  if (vec16) {
    const int per_row = dh4 / 4;
    for (int idx = threadIdx.x; idx < NROWS * per_row; idx += NT) {
      const int r = idx / per_row, c = (idx - r * per_row) * 4;
      const float* src = row(r);
      cp_async16(dst + r * LD + c, src ? src + c : any, src != nullptr);
    }
  } else {
    for (int idx = threadIdx.x; idx < NROWS * dh4; idx += NT) {
      const int r = idx / dh4, c = idx - r * dh4;
      const float* src = row(r);
      const bool ok = src != nullptr && c < dh;
      cp_async4(dst + r * LD + c, ok ? src + c : any, ok);
    }
  }
}

template <int ROWS, int DHP, int STAGES>
constexpr int smem_floats() {
  return ROWS * (DHP + 4) + 2 * STAGES * KT * (DHP + 4) + ROWS * PLD;
}

// The row tile of launch rank `rank`, heaviest first: with tiles inside
// one head (tq a multiple of ROWS) the last positions of every head come
// first, else the tiles in reverse order.
template <int ROWS>
__device__ __forceinline__ int tile_of_rank(int rank, const Geom& g) {
  if (g.tq % ROWS == 0) {
    const int per_head = g.tq / ROWS;
    return (rank % g.rep) * per_head + per_head - 1 - rank / g.rep;
  }
  return g.row_tiles - 1 - rank;
}

// The reductions of fa_combine_kernel over S <= MAX_CLUSTER splits,
// operation for operation, so that the cluster epilogue and the
// two-launch path agree bitwise.  There lane s < S of warp 0 holds split
// s's term and every other lane the identity (NEG_INF for the max, 0 for
// the sum, terms that are >= NEG_INF and >= 0); block_reduce's butterfly
// (xor 16, 8, 4, 2, 1) leaves lane 0 with the tree below, and the other
// warps add identities only.  Terms past S are the identity here too.
__device__ __forceinline__ float tree_max8(const float (&x)[MAX_CLUSTER]) {
  return fmaxf(fmaxf(fmaxf(x[0], x[4]), fmaxf(x[2], x[6])),
               fmaxf(fmaxf(x[1], x[5]), fmaxf(x[3], x[7])));
}

__device__ __forceinline__ float tree_sum8(const float (&x)[MAX_CLUSTER]) {
  return ((x[0] + x[4]) + (x[2] + x[6])) + ((x[1] + x[5]) + (x[3] + x[7]));
}

// The splits' o of one element group, row i and columns c..c+VW-1 of the
// peers' po (row stride LD), through distributed shared memory; 0 past
// the cluster's ns splits.
template <int VW, int LD>
__device__ __forceinline__ void load_split_o(const cg::cluster_group& cluster,
                                             float* po, int i, int c, int ns,
                                             float (&os)[MAX_CLUSTER][VW]) {
#pragma unroll
  for (int s = 0; s < MAX_CLUSTER; ++s) {
#pragma unroll
    for (int u = 0; u < VW; ++u) os[s][u] = 0.f;
    if (s >= ns) continue;
    const float* const src = cluster.map_shared_rank(po, s) + i * LD + c;
    if constexpr (VW == 4) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      os[s][0] = x.x, os[s][1] = x.y, os[s][2] = x.z, os[s][3] = x.w;
    } else {
      os[s][0] = *src;
    }
  }
}

// The merge of a cluster's partials (po, pm, pl in every block's shared
// memory) into the tile's nrow rows of o, m_out and l_out, by one block
// of the cluster.  Thread i < nrow computes row i's weights exp(m_s - m)
// and denominator once, into rw and rden of this block; then the block
// merges an equal share of the nrow x dh elements, VW columns at a time,
// each the splits' o weighted and summed in fa_combine_kernel's order
// (four accumulators over groups of four splits, the rest into the
// first) over the row's rden.  Rank 0 writes m and l.
template <int VW, int LD>
__device__ __forceinline__ void cluster_merge(
    const cg::cluster_group& cluster, float* po, float* pm, float* pl,
    float* rw, float* rden, float* o, float* m_out, float* l_out, int nrow,
    int dh) {
  const int tid = (int)threadIdx.x;
  const int ns = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per_row = dh / VW;
  const int total = nrow * per_row;
  const int share = (total + ns - 1) / ns;
  const int e_end = min(total, (rank + 1) * share);
  const int grouped = ns & ~3;   // splits summed in groups of four
  int e = rank * share + tid;
  float os[MAX_CLUSTER][VW];
  if (tid < nrow) {
    float ms[MAX_CLUSTER], ls[MAX_CLUSTER], terms[MAX_CLUSTER];
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s) {
      ms[s] = s < ns ? cluster.map_shared_rank(pm, s)[tid] : NEG_INF;
      ls[s] = s < ns ? cluster.map_shared_rank(pl, s)[tid] : 0.f;
    }
    const float m = tree_max8(ms);
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s) {
      const float w = s < ns ? expf(ms[s] - m) : 0.f;
      rw[tid * MAX_CLUSTER + s] = w;
      // the combine's l += l_s * w_s from 0: the product rounded alone
      terms[s] = s < ns ? __fmul_rn(ls[s], w) : 0.f;
    }
    const float l = tree_sum8(terms);
    rden[tid] = fmaxf(l, 1e-30f);
    if (rank == 0) {
      m_out[tid] = m;
      l_out[tid] = l;
    }
  }
  __syncthreads();
  if (e < e_end)
    load_split_o<VW, LD>(cluster, po, e / per_row, e % per_row * VW, ns, os);
  while (e < e_end) {
    const int i = e / per_row, c = e % per_row * VW;
    const float* const w = rw + i * MAX_CLUSTER;
#pragma unroll
    for (int u = 0; u < VW; ++u) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s) {
        if (s < grouped)
          a[s & 3] = fmaf(os[s][u], w[s], a[s & 3]);
        else if (s < ns)
          a[0] = fmaf(os[s][u], w[s], a[0]);
      }
      o[i * dh + c + u] = ((a[0] + a[1]) + (a[2] + a[3])) / rden[i];
    }
    e += NT;
    if (e < e_end)
      load_split_o<VW, LD>(cluster, po, e / per_row, e % per_row * VW, ns,
                           os);
  }
}

// ---------------------------------------------------------------------------
// fa_fwd: block = (row tile x kv plane, key split).  Thread t owns the rows
// t / 16 + 16 rr (rr < ROWS / 16) of the tile; in a score tile the keys
// t % 16 + 16 kk (kk < 4), in the output the columns 64 gg + 4 (t % 16) +
// cc (gg < DHP / 64, cc < 4).  With one split the block writes o, m and l;
// with several, the split's partial: o unnormalised, m and l, into the
// (split, row) planes of the same buffers.  STAGES = 2 double-buffers the
// K and V tiles; a split of one tile takes STAGES = 1, half the shared
// memory, so that two blocks share an SM.  A warp whose rows are all
// padding (a decode tile holds rep real rows of 16) stages tiles but
// skips the products.
//
// MERGE: the launch's splits are one cluster per row tile (cluster dims
// (1, S, 1), S = gridDim.y <= MAX_CLUSTER), and the block writes no
// partial to device memory.  After the key loop it leaves its partial in
// its own shared memory, over the K/V stage (o unnormalised, ROWS x LD,
// then m and l).  After a cluster barrier every block computes each real
// row's weights exp(m_s - m) and denominator once, from the splits' m and
// l (read through distributed shared memory, cluster.map_shared_rank),
// and then merges an equal share of the tile's (row, column) elements,
// reading only the splits' o (cluster_merge); the arithmetic and its order
// are fa_combine_kernel's (tree_max8, tree_sum8, its four accumulators),
// so the result is the two-launch path's, bit for bit.  A second barrier
// keeps every block's shared memory alive until its peers have read it.
// ---------------------------------------------------------------------------
template <int ROWS, int DHP, int STAGES, bool MERGE>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ l_out, Geom g) {
  constexpr int RPT = ROWS / TPR;   // rows per thread
  constexpr int NG = DHP / 64;      // 4-column groups per thread in P v
  constexpr int LD = DHP + 4;       // row stride of q, k and v tiles
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);
  float* const k_s = q_s + ROWS * LD;
  float* const v_s = k_s + STAGES * KT * LD;
  float* const p_s = v_s + STAGES * KT * LD;

  const int tid = threadIdx.x, tr = tid / TPR, tc = tid % TPR;
  const int plane = blockIdx.x % g.bhkv;
  const int p0 = tile_of_rank<ROWS>(blockIdx.x / g.bhkv, g) * ROWS;
  const int rows = g.rep * g.tq;

  // The positions the tile's real rows span, and the end of its keys.
  const int p_end = min(p0 + ROWS, rows);
  const int h_first = p0 / g.tq, h_last = (p_end - 1) / g.tq;
  const int pos_lo = h_first == h_last ? p0 - h_first * g.tq : 0;
  const int pos_hi = h_first == h_last ? p_end - 1 - h_last * g.tq
                                       : g.tq - 1;
  const bool any_empty = g.causal && pos_lo + g.q_offset < 0;
  const int key_end = (!g.causal || any_empty)
                          ? g.tk
                          : min(g.tk, pos_hi + g.q_offset + 1);
  const int t_lo = blockIdx.y * g.tiles_per_split;
  const int t_hi = min(t_lo + g.tiles_per_split, (key_end + KT - 1) / KT);
  // The lowest row of warp w is 2 w (rr = 0): is any of its rows real?
  const bool live = p0 + 2 * (tid / 32) < p_end;

  // Per owned row: whether it is real, whether it has no key, its limit.
  int lim[RPT];
  bool real[RPT], empty[RPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int p = p0 + tr + TPR * rr;
    const int pos = p % g.tq;
    real[rr] = p < rows;
    empty[rr] = g.causal && pos + g.q_offset < 0;
    lim[rr] = (g.causal && !empty[rr]) ? pos + g.q_offset : INT_MAX;
  }

  const int b_kv = plane / g.hkv, h_kv = plane - b_kv * g.hkv;
  const float* const kb = k + b_kv * g.skb + h_kv * g.skh;
  const float* const vb = v + b_kv * g.svb + h_kv * g.svh;
  auto stage_kv = [&](int tile, int st) {
    const int j0 = tile * KT;
    stage<KT, LD>(k_s + st * KT * LD, [&](int i) {
      const int j = j0 + i;
      return j < g.tk ? kb + j * g.skt : (const float*)nullptr;
    }, g.dh, g.vec16, k);
    stage<KT, LD>(v_s + st * KT * LD, [&](int i) {
      const int j = j0 + i;
      return j < g.tk ? vb + j * g.svt : (const float*)nullptr;
    }, g.dh, g.vec16, v);
  };

  float acc[RPT][NG * 4], m_r[RPT], l_r[RPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.f;
#pragma unroll
    for (int n = 0; n < NG * 4; ++n) acc[rr][n] = 0.f;
  }

  if (t_lo < t_hi) {
    stage<ROWS, LD>(q_s, [&](int i) {
      const int p = p0 + i;
      if (p >= rows) return (const float*)nullptr;
      const int head = p / g.tq, t = p - head * g.tq;
      const int qp = plane * g.rep + head;
      const int b = qp / g.hq, h = qp - b * g.hq;
      return q + b * g.sqb + h * g.sqh + t * g.sqt;
    }, g.dh, g.vec16, q);
    stage_kv(t_lo, 0);
    cp_commit();
  }
  const int dh4 = (g.dh + 3) & ~3;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int st = STAGES == 2 ? (tile - t_lo) & 1 : 0;
    if (STAGES == 2 && tile + 1 < t_hi) {
      stage_kv(tile + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      if (STAGES == 1 && tile > t_lo) {
        stage_kv(tile, 0);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncthreads();
    float corr[RPT];
    if (live) {
      // Scores of the owned rows x keys: 4-wide float4 steps along Dh.
      float s[RPT][4];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) s[rr][kk] = 0.f;
      const float* const ks = k_s + st * KT * LD;
#pragma unroll 4
      for (int c = 0; c < dh4; c += 4) {
        float4 qv[RPT], kv[4];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
          qv[rr] = *reinterpret_cast<const float4*>(
              q_s + (tr + TPR * rr) * LD + c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          kv[kk] = *reinterpret_cast<const float4*>(
              ks + (tc + TPR * kk) * LD + c);
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float a = s[rr][kk];
            a = fmaf(qv[rr].x, kv[kk].x, a);
            a = fmaf(qv[rr].y, kv[kk].y, a);
            a = fmaf(qv[rr].z, kv[kk].z, a);
            a = fmaf(qv[rr].w, kv[kk].w, a);
            s[rr][kk] = a;
          }
      }

      // Mask, online max and denominator, and P into shared memory.
      const int j0 = tile * KT;
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        bool ok[4];
        float mx = NEG_INF;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = j0 + tc + TPR * kk;
          ok[kk] = real[rr] && j < g.tk && j <= lim[rr];
          s[rr][kk] = !ok[kk] ? NEG_INF
                              : (empty[rr] ? 0.f : s[rr][kk] * g.scale);
          mx = fmaxf(mx, s[rr][kk]);
        }
        const float m_new = fmaxf(m_r[rr], group_max(mx));
        float sum = 0.f;
        float* const prow = p_s + (tr + TPR * rr) * PLD;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // Explicitly 0 when masked: in a row with no scored key yet m_new
          // is NEG_INF and exp(s - m_new) would be 1.
          const float p = ok[kk] ? expf(s[rr][kk] - m_new) : 0.f;
          sum += p;
          prow[tc + TPR * kk] = p;
        }
        corr[rr] = expf(m_r[rr] - m_new);
        l_r[rr] = l_r[rr] * corr[rr] + group_sum(sum);
        m_r[rr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P v over the tile's keys.
    if (live) {
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int n = 0; n < NG * 4; ++n) acc[rr][n] *= corr[rr];
      const float* const vs = v_s + st * KT * LD;
#pragma unroll 2
      for (int j = 0; j < KT; j += 4) {
        float pr[RPT][4];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          const float4 t4 = *reinterpret_cast<const float4*>(
              p_s + (tr + TPR * rr) * PLD + j);
          pr[rr][0] = t4.x;
          pr[rr][1] = t4.y;
          pr[rr][2] = t4.z;
          pr[rr][3] = t4.w;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int gg = 0; gg < NG; ++gg) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vs + (j + jj) * LD + 64 * gg + 4 * tc);
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) {
              const float p = pr[rr][jj];
              acc[rr][4 * gg] = fmaf(p, vv.x, acc[rr][4 * gg]);
              acc[rr][4 * gg + 1] = fmaf(p, vv.y, acc[rr][4 * gg + 1]);
              acc[rr][4 * gg + 2] = fmaf(p, vv.z, acc[rr][4 * gg + 2]);
              acc[rr][4 * gg + 3] = fmaf(p, vv.w, acc[rr][4 * gg + 3]);
            }
          }
      }
    }
    __syncthreads();   // before the next tile's copies and P overwrite
  }

  if constexpr (MERGE) {
    float* const po = k_s;
    float* const pm = po + ROWS * LD;
    float* const pl = pm + ROWS;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int i = tr + TPR * rr;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
        *reinterpret_cast<float4*>(po + i * LD + 64 * gg + 4 * tc) =
            make_float4(acc[rr][4 * gg], acc[rr][4 * gg + 1],
                        acc[rr][4 * gg + 2], acc[rr][4 * gg + 3]);
      if (tc == 0) {
        pm[i] = m_r[rr];
        pl[i] = l_r[rr];
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const long long row0 = (long long)plane * rows + p0;
    // The row weights go to this block's q tile: the key loop is done
    // with it.
    float* const rw = q_s;                          // ROWS x MAX_CLUSTER
    float* const rden = rw + ROWS * MAX_CLUSTER;    // ROWS
    if (g.dh % 4 == 0)
      cluster_merge<4, LD>(cluster, po, pm, pl, rw, rden, o + row0 * g.dh,
                           m_out + row0, l_out + row0, p_end - p0, g.dh);
    else
      cluster_merge<1, LD>(cluster, po, pm, pl, rw, rden, o + row0 * g.dh,
                           m_out + row0, l_out + row0, p_end - p0, g.dh);
    cluster.sync();
  } else {
    // Output rows: split s, query plane plane * rep + p / tq, position
    // p % tq -> row s * (bhkv * rows) + plane * rows + p of (o, m, l).
    const bool final_out = gridDim.y == 1;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int p = p0 + tr + TPR * rr;
      if (!real[rr]) continue;
      const long long row =
          ((long long)blockIdx.y * g.bhkv + plane) * rows + p;
      const float den = final_out ? fmaxf(l_r[rr], 1e-30f) : 1.f;
      float* const orow = o + row * g.dh;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = 64 * gg + 4 * tc + cc;
          if (c < g.dh) orow[c] = acc[rr][4 * gg + cc] / den;
        }
      if (tc == 0) {
        m_out[row] = m_r[rr];
        l_out[row] = l_r[rr];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fa_combine: one block per output row merges the splits' partials:
//   m = max_s m_s, w_s = exp(m_s - m), l = sum_s w_s l_s,
//   o = sum_s w_s o_s / max(l, 1e-30).
// The weights of up to CW splits at a time sit in shared memory; thread c
// sums column c over them with four independent accumulators, the loop
// unrolled so that 16 loads of the splits' o rows are in flight at once.
// A split with no scored key of the row (m_s = NEG_INF, l_s = 0, o_s = 0)
// adds exactly 0.
// ---------------------------------------------------------------------------
constexpr int CT = 128;    // threads per combine block
constexpr int CW = 1024;   // splits whose weights are held at a time

__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(FULL, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();   // red is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < CT / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

__global__ void __launch_bounds__(CT)
fa_combine_kernel(const float* __restrict__ o_part,
                  const float* __restrict__ m_part,
                  const float* __restrict__ l_part, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  long long nrows, int dh, int splits) {
  __shared__ float w_s[CW];
  __shared__ float red[CT / 32];
  const long long row = blockIdx.x;
  float m = NEG_INF;
  for (int s = threadIdx.x; s < splits; s += CT)
    m = fmaxf(m, m_part[s * nrows + row]);
  m = block_reduce(m, true, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < splits; s += CT)
    l += l_part[s * nrows + row] * expf(m_part[s * nrows + row] - m);
  l = block_reduce(l, false, red);
  const float den = fmaxf(l, 1e-30f);

  for (int c0 = 0; c0 < dh; c0 += CT) {
    const int c = c0 + threadIdx.x;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += CW) {
      const int ns = min(CW, splits - s0);
      __syncthreads();   // the previous weights are read
      for (int s = threadIdx.x; s < ns; s += CT)
        w_s[s] = expf(m_part[(s0 + s) * nrows + row] - m);
      __syncthreads();
      if (c < dh) {
        const float* op = o_part + (s0 * nrows + row) * dh + c;
        const long long step = nrows * dh;
        int s = 0;
#pragma unroll 4
        for (; s + 4 <= ns; s += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a[u] = fmaf(op[(s + u) * step], w_s[s + u], a[u]);
        }
        for (; s < ns; ++s) a[0] = fmaf(op[s * step], w_s[s], a[0]);
      }
    }
    if (c < dh) o[row * dh + c] = ((a[0] + a[1]) + (a[2] + a[3])) / den;
  }
  if (threadIdx.x == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <int ROWS, int DHP, int STAGES, bool MERGE>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* m, float* l, const Geom& g, int splits,
               cudaStream_t stream) {
  constexpr int bytes = smem_floats<ROWS, DHP, STAGES>() * (int)sizeof(float);
  static bool limit_set[MAX_DEVICES] = {};
  auto* const kern = fa_fwd_kernel<ROWS, DHP, STAGES, MERGE>;
  if (const int e = raise_smem_limit(limit_set, kern, bytes)) return e;
  const dim3 grid(g.row_tiles * g.bhkv, splits);
  if constexpr (MERGE) {
    // One cluster per row tile: the tile's S splits, grid y = S.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = splits;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, q, k, v, o, m, l, g);
    if (e != cudaSuccess) return (int)e;
  } else {
    kern<<<grid, NT, bytes, stream>>>(q, k, v, o, m, l, g);
  }
  return (int)cudaGetLastError();
}

template <int ROWS, int DHP>
int launch_fwd_staged(const float* q, const float* k, const float* v,
                      float* o, float* m, float* l, const Geom& g, int splits,
                      int merge, cudaStream_t stream) {
  if (merge)
    return g.tiles_per_split == 1
               ? launch_fwd<ROWS, DHP, 1, true>(q, k, v, o, m, l, g, splits,
                                                stream)
               : launch_fwd<ROWS, DHP, 2, true>(q, k, v, o, m, l, g, splits,
                                                stream);
  return g.tiles_per_split == 1
             ? launch_fwd<ROWS, DHP, 1, false>(q, k, v, o, m, l, g, splits,
                                               stream)
             : launch_fwd<ROWS, DHP, 2, false>(q, k, v, o, m, l, g, splits,
                                               stream);
}

// cudaOccupancyMaxActiveClusters of the merging variant: how many
// clusters of `splits` blocks fit on the device at once.
template <int ROWS, int DHP, int STAGES>
int max_clusters(int splits, int* count) {
  constexpr int bytes = smem_floats<ROWS, DHP, STAGES>() * (int)sizeof(float);
  static bool limit_set[MAX_DEVICES] = {};
  auto* const kern = fa_fwd_kernel<ROWS, DHP, STAGES, true>;
  if (const int e = raise_smem_limit(limit_set, kern, bytes)) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, kern, &cfg);
}

}  // namespace

#define FA_EXPORT extern "C" __attribute__((visibility("default")))

// q (B, H, tq, dh), k and v (B, Hkv, tk, dh) through their strides (in
// elements, unit along dh); o (splits, B H tq, dh), m and l (splits,
// B H tq), contiguous.  rows_tile is 16 or 64, dh at most 128; splits key
// splits of tiles_per_split 64-key tiles each.  merge (2 <= splits <=
// MAX_CLUSTER): the splits merge in the cluster epilogue, and o, m and l
// are the merged (B H tq, dh), (B H tq), (B H tq).
FA_EXPORT int fa_fwd_f32(const void* q, const void* k, const void* v,
                         void* o, void* m, void* l, int batch, int hq,
                         int hkv, int tq, int tk, int dh, long long sqb,
                         long long sqh, long long sqt, long long skb,
                         long long skh, long long skt, long long svb,
                         long long svh, long long svt, float scale,
                         int causal, int q_offset, int splits,
                         int tiles_per_split, int rows_tile, int vec16,
                         int merge, void* stream) {
  if (dh < 1 || dh > 128 || (rows_tile != 16 && rows_tile != 64) ||
      hkv < 1 || hq % hkv != 0 ||
      (merge && (splits < 2 || splits > MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  Geom g{sqb, sqh, sqt, skb, skh, skt, svb, svh, svt,
         hq, hkv, hq / hkv, tq, tk, dh, causal, q_offset,
         batch * hkv, 0, tiles_per_split, vec16, scale};
  g.row_tiles = (g.rep * tq + rows_tile - 1) / rows_tile;
  const auto* qf = (const float*)q;
  const auto* kf = (const float*)k;
  const auto* vf = (const float*)v;
  auto* of = (float*)o;
  auto* mf = (float*)m;
  auto* lf = (float*)l;
  const auto st = (cudaStream_t)stream;
  if (rows_tile == 16)
    return dh <= 64
               ? launch_fwd_staged<16, 64>(qf, kf, vf, of, mf, lf, g, splits,
                                           merge, st)
               : launch_fwd_staged<16, 128>(qf, kf, vf, of, mf, lf, g,
                                            splits, merge, st);
  return dh <= 64
             ? launch_fwd_staged<64, 64>(qf, kf, vf, of, mf, lf, g, splits,
                                         merge, st)
             : launch_fwd_staged<64, 128>(qf, kf, vf, of, mf, lf, g, splits,
                                          merge, st);
}

// The most clusters of `splits` blocks of the merging forward that are
// resident at once, at rows_tile 16 or 64, dh <= 64 or 128 and stages 1
// or 2 (cudaOccupancyMaxActiveClusters), into *count.
FA_EXPORT int fa_max_active_clusters(int rows_tile, int dh, int stages,
                                     int splits, void* count) {
  int* const n = (int*)count;
  if ((rows_tile != 16 && rows_tile != 64) || (stages != 1 && stages != 2) ||
      dh < 1 || dh > 128 || splits < 1 || splits > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (rows_tile == 16) {
    if (dh <= 64)
      return stages == 1 ? max_clusters<16, 64, 1>(splits, n)
                         : max_clusters<16, 64, 2>(splits, n);
    return stages == 1 ? max_clusters<16, 128, 1>(splits, n)
                       : max_clusters<16, 128, 2>(splits, n);
  }
  if (dh <= 64)
    return stages == 1 ? max_clusters<64, 64, 1>(splits, n)
                       : max_clusters<64, 64, 2>(splits, n);
  return stages == 1 ? max_clusters<64, 128, 1>(splits, n)
                     : max_clusters<64, 128, 2>(splits, n);
}

// o_part (splits, nrows, dh), m_part and l_part (splits, nrows) -> o
// (nrows, dh), m and l (nrows), all contiguous.
FA_EXPORT int fa_combine_f32(const void* o_part, const void* m_part,
                             const void* l_part, void* o, void* m, void* l,
                             long long nrows, int dh, int splits,
                             void* stream) {
  fa_combine_kernel<<<(unsigned)nrows, CT, 0, (cudaStream_t)stream>>>(
      (const float*)o_part, (const float*)m_part, (const float*)l_part,
      (float*)o, (float*)m, (float*)l, nrows, dh, splits);
  return (int)cudaGetLastError();
}

FA_EXPORT const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
